"""PNG codec, encode half: host row filters + deflate, and the chunk walk.

The counterpart of the encode half of ``lilliput_tpu/codecs/png.py``:
``PngEncoder`` and ``encode_png_pixels`` filter rows on the host (adaptive
min-SAD like libpng, ``lp_png_filter`` of ``csrc/host/png_filter.cpp``) and
deflate with the PngCompression option (opencv.hpp:34), through libdeflate
where the host library has it and Python's zlib otherwise, the JAX
package's decision (``_fast_zlib``), so the two packages write the same
bytes on one machine. ``iter_chunks``, ``png_content_length`` and
``is_apng`` are the host chunk walk the API uses to sniff a PNG (the
reference's pure-Go walker, opencv.go:458-627). The decoder is not ported
yet (ROADMAP queue 1, item 6.1).
"""

from __future__ import annotations

import ctypes
import os
import struct
import zlib
from typing import Dict, Optional

import numpy as np

from .. import binding
from ..errors import DecodingFailedError
from ..framebuffer import PNG_BILEVEL, PNG_COMPRESSION, PNG_STRATEGY, Framebuffer
from ..interfaces import Decoder, Encoder, check_encode_options

_PNG_ENCODE_KEYS = frozenset({PNG_COMPRESSION, PNG_STRATEGY, PNG_BILEVEL})

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


# --- fast zlib streams (libdeflate, the reference's zlib-ng analog) --------
#
# Python zlib is the always-correct route; LILLIPUT_LIBDEFLATE=0 forces it.
# The decision is taken once per process, as in the JAX package.

_FAST_ZLIB: Optional[bool] = None


def _fast_zlib(lib) -> bool:
    global _FAST_ZLIB
    if _FAST_ZLIB is None:
        try:
            _FAST_ZLIB = (os.environ.get("LILLIPUT_LIBDEFLATE", "1") != "0"
                          and bool(lib.lp_zlib_fast_available()))
        except AttributeError:
            _FAST_ZLIB = False
    return _FAST_ZLIB


def _deflate(data: bytes, level: int, lib=None) -> bytes:
    """Compress to a zlib-format stream (libdeflate fast path; zlib keeps
    level-0 stored streams and the no-libdeflate build alike)."""
    lib = lib if lib is not None else binding.load()
    if _fast_zlib(lib) and len(data) > 0 and level > 0:
        src = np.frombuffer(data, np.uint8)
        cap = int(lib.lp_zlib_compress_bound(src.size))
        if cap > 0:
            out = np.empty(cap, np.uint8)
            n = int(lib.lp_zlib_compress(_u8ptr(src), src.size,
                                         _u8ptr(out), cap, level))
            if n > 0:
                return out[:n].tobytes()
    return zlib.compress(data, level)


def _deflate_strategy(data: bytes, level: int, strategy: Optional[int],
                      lib=None) -> bytes:
    """_deflate with an optional zlib strategy (IMWRITE_PNG_STRATEGY).
    libdeflate has no strategy knob, so a non-default strategy routes
    through Python zlib."""
    if strategy is None or int(strategy) == zlib.Z_DEFAULT_STRATEGY:
        return _deflate(data, level, lib)
    co = zlib.compressobj(min(max(int(level), 0), 9), zlib.DEFLATED, 15, 8,
                          int(strategy))
    return co.compress(data) + co.flush()


# ---------------------------------------------------------------------------
# chunk walking (host)
# ---------------------------------------------------------------------------

def iter_chunks(buf: bytes):
    """Yield (type, data_offset, length, chunk_end) for each chunk."""
    pos = len(PNG_MAGIC)
    n = len(buf)
    while pos + 8 <= n:
        length = int.from_bytes(buf[pos:pos + 4], "big")
        ctype = buf[pos + 4:pos + 8]
        data_off = pos + 8
        end = data_off + length + 4  # + CRC
        if end > n:
            return
        yield ctype, data_off, length, end
        pos = end
        if ctype == b"IEND":
            return


def png_content_length(buf: bytes) -> int:
    """Bytes up to and including IEND (+CRC); trailing data beyond is
    truncated (acropalypse parity, opencv.go:560-610)."""
    last = len(buf)
    for ctype, _off, _ln, end in iter_chunks(buf):
        if ctype == b"IEND":
            return end
    return last


def is_apng(buf: bytes) -> bool:
    """acTL chunk before IDAT marks an APNG (opencv.go:609-627 behavior)."""
    for ctype, _off, _ln, _end in iter_chunks(buf):
        if ctype == b"acTL":
            return True
        if ctype == b"IDAT":
            return False
    return False


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

class PngEncoder(Encoder):
    def __init__(self, decoded_by: Optional[Decoder] = None,
                 icc_override: Optional[bytes] = None):
        self._lib = binding.load()
        self._icc = icc_override
        if self._icc is None and decoded_by is not None:
            try:
                self._icc = decoded_by.icc() or None
            except Exception:
                self._icc = None

    def encode(self, fb: Optional[Framebuffer], opts: Dict[int, int]) -> Optional[bytes]:
        if fb is None:
            raise DecodingFailedError("PNG encoder cannot flush without a frame")
        opts = opts or {}
        check_encode_options(opts, _PNG_ENCODE_KEYS, "png")
        level = int(opts.get(PNG_COMPRESSION, 6))
        return encode_png_pixels(fb.to_numpy(), level, self._icc,
                                 strategy=opts.get(PNG_STRATEGY),
                                 bilevel=bool(opts.get(PNG_BILEVEL, 0)))


def _pack_bilevel(gray: np.ndarray) -> np.ndarray:
    """(H, W) u8 -> 1-bit-packed scanlines with a 0 (None) filter byte per
    row: any nonzero pixel -> bit 1, MSB-first within each byte."""
    h, w = gray.shape
    bits = (gray != 0).astype(np.uint8)
    packed = np.packbits(bits, axis=1)  # MSB-first, zero-padded rows
    return np.concatenate(
        [np.zeros((h, 1), np.uint8), packed], axis=1).reshape(-1)


def encode_png_pixels(arr: np.ndarray, level: int = 6,
                      icc: Optional[bytes] = None,
                      strategy: Optional[int] = None,
                      bilevel: bool = False) -> bytes:
    """Encode (H, W, 1|3|4) BGR(A)/gray u8 host pixels to PNG (C++ row
    filter + deflate). The body of PngEncoder.encode, shared with the
    serving pipeline's .png output.

    strategy: zlib strategy 0..4 (IMWRITE_PNG_STRATEGY passthrough).
    bilevel: 1-bit grayscale output (IMWRITE_PNG_BILEVEL); colour input is
    converted with the BGR luma weights first, then thresholded nonzero."""
    lib = binding.load()
    level = min(max(int(level), 0), 9)
    h, w, c = arr.shape
    if bilevel:
        if c == 1:
            gray = arr[:, :, 0]
        else:  # BT.601 luma of BGR, the cv2 color->gray convention
            gray = (arr[:, :, 0] * 0.114 + arr[:, :, 1] * 0.587
                    + arr[:, :, 2] * 0.299 + 0.5).astype(np.uint8)
        filtered = _pack_bilevel(gray)
        comp = _deflate_strategy(filtered.tobytes(), level, strategy, lib)
        return _assemble_png(w, h, 1, 0, comp, icc, lib)
    if c == 3:
        # contiguous RGB by per-channel assignment (the strided copy of a
        # reversed-channel view is far slower)
        rgb = np.empty((h, w, 3), np.uint8)
        rgb[..., 0] = arr[..., 2]
        rgb[..., 1] = arr[..., 1]
        rgb[..., 2] = arr[..., 0]
        color_type = 2
    elif c == 4:
        rgb = np.empty((h, w, 4), np.uint8)
        rgb[..., 0] = arr[..., 2]
        rgb[..., 1] = arr[..., 1]
        rgb[..., 2] = arr[..., 0]
        rgb[..., 3] = arr[..., 3]
        color_type = 6
    else:
        rgb = np.ascontiguousarray(arr[:, :, 0:1])
        color_type = 0
    ch = rgb.shape[2]
    raw = rgb.reshape(h, w * ch)
    stride = w * ch
    filtered = np.empty(h * (stride + 1), np.uint8)
    lib.lp_png_filter(_u8ptr(raw), _u8ptr(filtered), h, stride, ch)
    comp = _deflate_strategy(filtered.tobytes(), level, strategy, lib)
    return _assemble_png(w, h, 8, color_type, comp, icc, lib)


def _png_chunk(ctype: bytes, data: bytes) -> bytes:
    body = ctype + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def _assemble_png(w: int, h: int, bit_depth: int, color_type: int,
                  comp: bytes, icc: Optional[bytes], lib) -> bytes:
    """The container (magic/IHDR/iCCP/IDAT/IEND) around a deflated
    stream, shared by the bilevel and normal encode branches."""
    ihdr = struct.pack(">IIBBBBB", w, h, bit_depth, color_type, 0, 0, 0)
    out = [PNG_MAGIC, _png_chunk(b"IHDR", ihdr)]
    if icc:
        out.append(_png_chunk(
            b"iCCP", b"ICC Profile\x00\x00" + _deflate(icc, 9, lib)))
    out.append(_png_chunk(b"IDAT", comp))
    out.append(_png_chunk(b"IEND", b""))
    return b"".join(out)
