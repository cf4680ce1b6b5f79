"""PNG codec: host chunk walk, inflate and unfilter; pixels on the device.

The counterpart of ``lilliput_tpu/codecs/png.py``. ``PngDecoder`` walks
the chunks on the host (the reference's pure-Go walker, opencv.go:458-627:
``iter_chunks``, ``png_content_length``, ``is_apng``), inflates the IDAT
stream (``lp_zlib_decompress`` through libdeflate where the host library
has it, else Python's zlib, ``_fast_zlib``'s decision) and undoes the row
filters (``lp_png_unfilter`` of ``csrc/host/png_filter.cpp``, a serial
recurrence); Adam7, sub-byte unpacking, 16 -> 8 bits and the tRNS colour
key stay on the host as in the JAX package; the palette LUT, the gray
scale and the RGB -> BGR swizzles run on the decoder's device, and every
frame lands there. APNG frames come out one per ``decode_to`` with their
offsets, delay and dispose/blend, which ``ImageOps`` composites.

``PngEncoder`` and ``encode_png_pixels`` filter rows on the host (adaptive
min-SAD like libpng, ``lp_png_filter``) and deflate with the
PngCompression option (opencv.hpp:34), through libdeflate or Python's
zlib as above, so the two packages write the same bytes on one machine.

Inside a worker's timed call (``utils.worker_clock``: a serving front's
per-image decode or encode), each stage counts its thread-CPU time on
that call's clock, which hands the counts to the batch's span: the
decode's ``png_inflate_cpu_ns``, ``png_unfilter_cpu_ns`` and
``png_pixels_cpu_ns`` (everything after the unfilter to the end of the
call: unpacking, 16 -> 8 bits, the colour conversion and the caller's
copy into its batch), the encode's ``png_filter_cpu_ns`` (the channel
order and the row filter) and ``png_deflate_cpu_ns``; the routes as
images, ``png_inflate_fast``/``png_inflate_zlib`` and
``png_deflate_fast``/``png_deflate_zlib`` (libdeflate or Python's zlib);
and ``png_raw_bytes``, the inflated bytes. Outside one, nothing is read
or recorded.
"""

from __future__ import annotations

import ctypes
import os
import struct
import time
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

import torch

from .. import binding
from ..errors import (DecodingFailedError, InvalidImageError,
                      SkipNotSupportedError)
from ..framebuffer import (PNG_BILEVEL, PNG_COMPRESSION, PNG_STRATEGY,
                           BlendMethod, DisposeMethod, Framebuffer,
                           ImageHeader, ImageOrientation)
from ..interfaces import Decoder, Encoder, check_encode_options
from ..utils import resolve_device, worker_clock
from ._raster import bgr_from_rgb, lut_gather, take_channels, to_device

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


def _deflate_fast(data: bytes, level: int, lib) -> Optional[bytes]:
    """libdeflate's zlib-format stream of data, or None where Python's
    zlib writes it (no libdeflate, level-0 stored streams, no data)."""
    if _fast_zlib(lib) and len(data) > 0 and level > 0:
        src = np.frombuffer(data, np.uint8)
        cap = int(lib.lp_zlib_compress_bound(src.size))
        if cap > 0:
            out = np.empty(cap, np.uint8)
            n = int(lib.lp_zlib_compress(_u8ptr(src), src.size,
                                         _u8ptr(out), cap, level))
            if n > 0:
                return out[:n].tobytes()
    return None


def _deflate(data: bytes, level: int, lib=None) -> bytes:
    """Compress to a zlib-format stream (libdeflate fast path; zlib keeps
    level-0 stored streams and the no-libdeflate build alike)."""
    lib = lib if lib is not None else binding.load()
    out = _deflate_fast(data, level, lib)
    return zlib.compress(data, level) if out is None else out


def _deflate_strategy(data: bytes, level: int, strategy: Optional[int],
                      lib) -> Tuple[bytes, bool]:
    """_deflate with an optional zlib strategy (IMWRITE_PNG_STRATEGY),
    and whether libdeflate wrote it. libdeflate has no strategy knob, so
    a non-default strategy routes through Python zlib."""
    if strategy is None or int(strategy) == zlib.Z_DEFAULT_STRATEGY:
        out = _deflate_fast(data, level, lib)
        if out is not None:
            return out, True
        return zlib.compress(data, level), False
    co = zlib.compressobj(min(max(int(level), 0), 9), zlib.DEFLATED, 15, 8,
                          int(strategy))
    return co.compress(data) + co.flush(), False


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
# decoder
# ---------------------------------------------------------------------------

def _inflate_exact(idat: bytes, expected: int, lib) -> Optional[np.ndarray]:
    """Inflate through the host library when the decompressed size is
    known (always, for a well-formed PNG). None on any mismatch or
    corruption, so the caller falls back to Python zlib; an `expected`
    beyond DEFLATE's ~1032:1 bound of this stream also falls back, so a
    hostile IHDR commits no allocation here."""
    if not _fast_zlib(lib) or expected <= 0 or len(idat) == 0:
        return None
    if expected > len(idat) * 1032 + (1 << 16):
        return None
    src = np.frombuffer(idat, np.uint8)
    out = np.empty(expected, np.uint8)
    n = int(lib.lp_zlib_decompress(_u8ptr(src), src.size,
                                   _u8ptr(out), expected))
    if n < 0:
        return None
    return out[:n]


def _inflate_bounded(raw: bytes, expected: int, what: str) -> np.ndarray:
    """Python-zlib inflate capped at the geometry's raw size (a 1x1 IHDR
    with a 10 MB IDAT would otherwise inflate to ~10 GB before any size
    check); bytes past `expected` are never read."""
    try:
        d = zlib.decompressobj()
        out = d.decompress(raw, max(expected, 0))
        return np.frombuffer(out, np.uint8)
    except zlib.error as e:
        raise DecodingFailedError(f"{what}: {e}") from e


def _inflate_stream(raw: bytes, expected: int, lib,
                    what: str) -> np.ndarray:
    """The filtered stream of an image or APNG frame: _inflate_exact,
    else _inflate_bounded; counted on the worker's clock (see the module
    docstring)."""
    clock = worker_clock()
    t0 = time.thread_time_ns() if clock is not None else 0
    data = _inflate_exact(raw, expected, lib)
    fast = data is not None
    if not fast:
        data = _inflate_bounded(raw, expected, what)
    if clock is not None:
        clock.add(png_inflate_cpu_ns=time.thread_time_ns() - t0,
                  png_inflate_fast=int(fast), png_inflate_zlib=int(not fast),
                  png_raw_bytes=data.size)
    return data


def _expected_raw_size(width: int, height: int, ch: int, bit_depth: int,
                       interlace: int) -> int:
    """Exact filtered-stream size: a filter byte per row plus the packed
    samples, summed over the Adam7 passes when interlaced."""
    if interlace == 0:
        stride = (width * ch * bit_depth + 7) // 8
        return height * (stride + 1)
    total = 0
    for (x0, y0, dx, dy) in _ADAM7:
        pw = (width - x0 + dx - 1) // dx
        ph = (height - y0 + dy - 1) // dy
        if pw == 0 or ph == 0:
            continue
        stride = (pw * ch * bit_depth + 7) // 8
        total += ph * (stride + 1)
    return total


# Adam7 interlace passes: (x_start, y_start, x_step, y_step)
_ADAM7 = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)]

_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}

# spec-legal bit depths per color type (PNG spec 11.2.2)
_VALID_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
                 4: (8, 16), 6: (8, 16)}

_ICC_MAX_BYTES = 1 << 20

# OpenCV's CV_IO_MAX_IMAGE_PIXELS default, the ceiling the reference's
# imdecode applies before any allocation
_MAX_PIXELS = 1 << 30

_GRAY_SCALE = {1: 255, 2: 85, 4: 17, 8: 1, 16: 1}


class _PngInfo:
    width: int
    height: int
    bit_depth: int
    color_type: int
    interlace: int
    palette: Optional[np.ndarray]
    trns: Optional[bytes]
    icc: bytes


def _parse(buf: bytes) -> _PngInfo:
    if not buf.startswith(PNG_MAGIC):
        raise InvalidImageError("not a PNG")
    info = _PngInfo()
    info.palette = None
    info.trns = None
    info.icc = b""
    seen_ihdr = False
    for ctype, off, ln, _end in iter_chunks(buf):
        if ctype == b"IHDR":
            if ln < 13:
                raise InvalidImageError("bad IHDR")
            (info.width, info.height, info.bit_depth, info.color_type,
             _comp, _filt, info.interlace) = struct.unpack(
                 ">IIBBBBB", buf[off:off + 13])
            if info.bit_depth not in _VALID_DEPTHS.get(info.color_type, ()):
                raise InvalidImageError(
                    f"invalid PNG color type/bit depth "
                    f"{info.color_type}/{info.bit_depth}")
            if info.interlace not in (0, 1):
                raise InvalidImageError("invalid PNG interlace method")
            if (info.width == 0 or info.height == 0
                    or info.width * info.height > _MAX_PIXELS):
                raise InvalidImageError("PNG dimensions out of range")
            seen_ihdr = True
        elif ctype == b"PLTE":
            if ln % 3 != 0 or ln == 0:
                raise InvalidImageError("bad PLTE length")
            info.palette = np.frombuffer(buf[off:off + ln],
                                         np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            info.trns = buf[off:off + ln]
        elif ctype == b"iCCP":
            data = buf[off:off + ln]
            z = data.find(b"\x00")
            if z != -1 and z + 2 <= len(data):
                try:
                    # inflated size capped (the 1 MiB ICC cap); only a
                    # complete zlib stream is kept, a truncated profile is
                    # dropped
                    d = zlib.decompressobj()
                    icc = d.decompress(data[z + 2:], _ICC_MAX_BYTES + 1)
                    info.icc = (b"" if len(icc) > _ICC_MAX_BYTES or not d.eof
                                else icc)
                except zlib.error:
                    info.icc = b""
        elif ctype == b"IDAT":
            break
    if not seen_ihdr:
        raise InvalidImageError("PNG missing IHDR")
    return info


def _unfilter(lib, raw: np.ndarray, rows: int, stride: int,
              bpp: int) -> np.ndarray:
    clock = worker_clock()
    t0 = time.thread_time_ns() if clock is not None else 0
    out = np.empty(rows * stride, np.uint8)
    rc = lib.lp_png_unfilter(_u8ptr(raw), _u8ptr(out), rows, stride,
                             max(bpp, 1))
    if rc != 0:
        raise DecodingFailedError("bad PNG filter type")
    if clock is not None:
        clock.add(png_unfilter_cpu_ns=time.thread_time_ns() - t0)
    return out


def _pixels_from_here() -> None:
    """The pixels stage starts: counted on the worker's clock from here
    to the end of its call (the caller's copy into its batch too)."""
    clock = worker_clock()
    if clock is not None:
        clock.until_return("png_pixels_cpu_ns")


def _unpack_bits(row_bytes: np.ndarray, bit_depth: int, width: int,
                 channels: int, keep16: bool = False) -> np.ndarray:
    """(rows, stride) packed -> (rows, width*channels) samples. 16-bit
    samples reduce to the high byte (libpng's strip-16, which the
    reference inherits through OpenCV) unless keep16 (for the exact tRNS
    colour-key comparison)."""
    if bit_depth == 8:
        return row_bytes[:, :width * channels]
    if bit_depth == 16:
        pairs = row_bytes.reshape(row_bytes.shape[0], -1, 2)[
            :, :width * channels]
        if keep16:
            return (pairs[..., 0].astype(np.uint16) << 8) | pairs[..., 1]
        return pairs[..., 0]
    # 1/2/4-bit: big-endian bit packing
    rows = row_bytes.shape[0]
    bits = np.unpackbits(row_bytes, axis=1)
    n = width * channels
    groups = bits[:, :n * bit_depth].reshape(rows, n, bit_depth)
    vals = np.zeros((rows, n), np.uint8)
    for b in range(bit_depth):
        vals = ((vals.astype(np.uint16) << 1) | groups[:, :, b]).astype(
            np.uint8)
    return vals


class PngDecoder(Decoder):
    """A PNG or APNG: the header on construction, each frame on
    ``decode_to`` as an (H, W, C) u8 tensor on `device` ("cuda" unless the
    caller asks for the CPU): BGR, BGRA (alpha or tRNS) or gray."""

    def __init__(self, buf: bytes, device="cuda"):
        self.device = resolve_device(device)
        self._raw = buf
        self._info = _parse(buf)
        self._lib = binding.load()
        self._decoded = False
        self._apng = is_apng(buf)
        self._header: Optional[ImageHeader] = None

    def header(self) -> ImageHeader:
        if self._header is None:
            i = self._info
            if i.color_type in (4, 6) or i.trns is not None:
                channels = 4
            elif i.color_type == 0:
                channels = 1
            else:
                channels = 3
            num_frames = 1
            if self._apng:
                num_frames = max(len(self._apng_frames()), 1)
            self._header = ImageHeader(
                width=i.width, height=i.height, channels=channels,
                orientation=ImageOrientation.TOP_LEFT, num_frames=num_frames,
                content_length=png_content_length(self._raw))
        return self._header

    def description(self) -> str:
        return "PNG"

    def icc(self) -> bytes:
        return self._info.icc

    @property
    def is_apng(self) -> bool:
        return self._apng

    def loop_count(self) -> int:
        """acTL num_plays (0 = infinite)."""
        for ctype, off, ln, _ in iter_chunks(self._raw):
            if ctype == b"acTL" and ln >= 8:
                return int.from_bytes(self._raw[off + 4:off + 8], "big")
            if ctype == b"IDAT":
                break
        return 0

    # -- decode -------------------------------------------------------------

    def _inflate(self) -> np.ndarray:
        idat = b"".join(self._raw[off:off + ln]
                        for ctype, off, ln, _ in iter_chunks(self._raw)
                        if ctype == b"IDAT")
        i = self._info
        expected = _expected_raw_size(i.width, i.height,
                                      _CHANNELS[i.color_type], i.bit_depth,
                                      i.interlace)
        return _inflate_stream(idat, expected, self._lib,
                               "PNG inflate failed")

    def _reconstruct_samples(self, keep16: bool = False, data=None,
                             width=None, height=None,
                             interlace=None) -> np.ndarray:
        """Undo filtering and interlace on the host: (H, W*channels)
        samples (16-bit reduced to the high byte unless keep16)."""
        i = self._info
        ch = _CHANNELS[i.color_type]
        data = self._inflate() if data is None else data
        width = i.width if width is None else width
        height = i.height if height is None else height
        interlace = i.interlace if interlace is None else interlace
        bpp_bytes = max(1, ch * i.bit_depth // 8)
        dtype = np.uint16 if (keep16 and i.bit_depth == 16) else np.uint8
        if interlace == 0:
            stride = (width * ch * i.bit_depth + 7) // 8
            need = height * (stride + 1)
            if data.size < need:
                raise DecodingFailedError("truncated PNG data")
            rows = _unfilter(self._lib, data[:need], height, stride,
                             bpp_bytes)
            _pixels_from_here()
            return _unpack_bits(rows.reshape(height, stride), i.bit_depth,
                                width, ch, keep16)
        out = np.zeros((height, width * ch), dtype)
        pos = 0
        for (x0, y0, dx, dy) in _ADAM7:
            pw = (width - x0 + dx - 1) // dx
            ph = (height - y0 + dy - 1) // dy
            if pw == 0 or ph == 0:
                continue
            stride = (pw * ch * i.bit_depth + 7) // 8
            need = ph * (stride + 1)
            if data.size - pos < need:
                raise DecodingFailedError("truncated PNG data")
            sub = _unfilter(self._lib, data[pos:pos + need], ph, stride,
                            bpp_bytes)
            pos += need
            samples = _unpack_bits(sub.reshape(ph, stride), i.bit_depth, pw,
                                   ch, keep16)
            out.reshape(height, width, ch)[y0::dy, x0::dx, :] = (
                samples.reshape(ph, pw, ch))
        # Adam7: the passes' unpacking is not in the pixels stage
        _pixels_from_here()
        return out

    def _to_pixels(self, samples: np.ndarray, width: int,
                   height: int) -> torch.Tensor:
        """Colour-type conversion of host samples to BGR(A) or gray pixels
        on the device: the tRNS colour key on the host (exact 16-bit
        compare), the rest after one upload."""
        i = self._info
        samples = samples.reshape(height, width, _CHANNELS[i.color_type])
        alpha = None
        if i.trns is not None and i.color_type in (0, 2):
            nvals = 1 if i.color_type == 0 else 3
            if len(i.trns) < nvals * 2:
                # libpng errors on an undersized tRNS
                raise DecodingFailedError("bad tRNS length")
            key = np.frombuffer(i.trns[:nvals * 2], ">u2").astype(np.uint32)
            if i.bit_depth < 16:
                key = key & ((1 << i.bit_depth) - 1)
            transparent = np.all(samples.astype(np.uint32) == key, axis=-1)
            alpha = to_device(np.where(transparent, 0, 255).astype(np.uint8),
                              self.device)[..., None]
            if samples.dtype == np.uint16:
                samples = (samples >> 8).astype(np.uint8)
        if i.color_type == 3:
            if i.palette is None:
                raise DecodingFailedError("palette PNG missing PLTE")
            pal = i.palette
            if i.trns is not None:
                a = np.full(pal.shape[0], 255, np.uint8)
                # a tRNS longer than the palette (spec-illegal): the extra
                # entries have no pixel to apply to
                t = np.frombuffer(i.trns, np.uint8)[:pal.shape[0]]
                a[:t.size] = t
                lut = np.concatenate([pal[:, ::-1], a[:, None]], axis=1)
            else:
                lut = pal[:, ::-1]  # BGR
            return lut_gather(lut, to_device(samples[..., 0], self.device))
        px = to_device(samples, self.device)
        if i.color_type == 0:
            scale = _GRAY_SCALE[i.bit_depth]
            if scale != 1:
                px = px * scale
            if alpha is not None:
                px = torch.cat([px, px, px, alpha], dim=-1)
            return px
        if i.color_type == 4:
            return take_channels(px, [0, 0, 0, 1])
        px = bgr_from_rgb(px)
        return px if alpha is None else torch.cat([px, alpha], dim=-1)

    def decode_to(self, fb: Framebuffer) -> None:
        if self._apng and self._apng_frames():
            return self._decode_apng_frame(fb)
        if self._decoded:
            raise EOFError()
        i = self._info
        samples = self._reconstruct_samples(
            keep16=i.trns is not None and i.color_type in (0, 2))
        fb.array = self._to_pixels(samples, i.width, i.height)
        fb.duration = 0.0
        fb.x_offset = fb.y_offset = 0
        self._decoded = True

    # -- APNG -----------------------------------------------------------------
    # The reference only detects APNG (opencv.go:609-627) and decodes the
    # static image; the JAX package decodes every frame and hands it to
    # ImageOps with APNG's dispose/blend, and so does the port.

    def _apng_frames(self):
        if hasattr(self, "_frames"):
            return self._frames
        frames = []
        cur = None  # (fcTL fields, [data chunks])
        for ctype, off, ln, _end in iter_chunks(self._raw):
            if ctype == b"fcTL" and ln >= 26:
                if cur is not None:
                    frames.append(cur)
                f = struct.unpack(">IIIIIHHBB", self._raw[off:off + 26])
                # APNG spec: the frame rect lies inside the IHDR canvas
                if (f[1] == 0 or f[2] == 0
                        or f[3] + f[1] > self._info.width
                        or f[4] + f[2] > self._info.height):
                    raise InvalidImageError("APNG frame rect exceeds canvas")
                cur = ({"w": f[1], "h": f[2], "x": f[3], "y": f[4],
                        "delay_num": f[5], "delay_den": f[6],
                        "dispose": f[7], "blend": f[8]}, [])
            elif ctype == b"IDAT":
                if cur is not None:
                    cur[1].append(self._raw[off:off + ln])
            elif ctype == b"fdAT" and ln > 4:
                if cur is not None:
                    cur[1].append(self._raw[off + 4:off + ln])
        if cur is not None:
            frames.append(cur)
        self._frames = [f for f in frames if f[1]]
        self._frame_idx = 0
        return self._frames

    def _decode_apng_frame(self, fb: Framebuffer) -> None:
        frames = self._apng_frames()
        if self._frame_idx >= len(frames):
            raise EOFError()
        meta, chunks = frames[self._frame_idx]
        raw = b"".join(chunks)
        i = self._info
        expected = _expected_raw_size(meta["w"], meta["h"],
                                      _CHANNELS[i.color_type], i.bit_depth,
                                      i.interlace)
        data = _inflate_stream(raw, expected, self._lib,
                               "APNG frame inflate failed")
        # frames use the IHDR interlace method, Adam7 over the frame rect
        samples = self._reconstruct_samples(
            keep16=i.trns is not None and i.color_type in (0, 2),
            data=data, width=meta["w"], height=meta["h"],
            interlace=i.interlace)
        fb.array = self._to_pixels(samples, meta["w"], meta["h"])
        fb.duration = meta["delay_num"] / (meta["delay_den"] or 100)
        fb.x_offset, fb.y_offset = meta["x"], meta["y"]
        fb.dispose = DisposeMethod(min(meta["dispose"], 2))
        # APNG blend 0 = replace, 1 = over (the inverse of the enum values)
        fb.blend = (BlendMethod.USE_ALPHA_BLENDING if meta["blend"] == 1
                    else BlendMethod.NO_BLEND)
        self._frame_idx += 1

    def skip_frame(self) -> None:
        if self._apng and self._apng_frames():
            if self._frame_idx >= len(self._frames):
                raise EOFError()
            self._frame_idx += 1
            return
        raise SkipNotSupportedError()


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
    clock = worker_clock()
    t0 = time.thread_time_ns() if clock is not None else 0
    lib = binding.load()
    level = min(max(int(level), 0), 9)
    h, w, _ = arr.shape
    filtered, bit_depth, color_type = _filtered_rows(arr, bilevel, lib)
    t1 = time.thread_time_ns() if clock is not None else 0
    comp, fast = _deflate_strategy(filtered.tobytes(), level, strategy, lib)
    if clock is not None:
        clock.add(png_filter_cpu_ns=t1 - t0,
                  png_deflate_cpu_ns=time.thread_time_ns() - t1,
                  png_deflate_fast=int(fast), png_deflate_zlib=int(not fast))
    return _assemble_png(w, h, bit_depth, color_type, comp, icc, lib)


def _filtered_rows(arr: np.ndarray, bilevel: bool, lib):
    """encode_png_pixels' scanlines, each led by its filter byte, with
    their bit depth and PNG colour type."""
    h, w, c = arr.shape
    if bilevel:
        if c == 1:
            gray = arr[:, :, 0]
        else:  # BT.601 luma of BGR, the cv2 color->gray convention
            gray = (arr[:, :, 0] * 0.114 + arr[:, :, 1] * 0.587
                    + arr[:, :, 2] * 0.299 + 0.5).astype(np.uint8)
        return _pack_bilevel(gray), 1, 0
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
    return filtered, 8, color_type


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
