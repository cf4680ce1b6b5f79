"""BMP codec: host header and RLE walk, pixels on the device.

The counterpart of ``lilliput_tpu/codecs/bmp.py`` (the reference decodes
BMP through OpenCV's grfmt_bmp, lilliput.go:157, and encodes ``.bmp``
through OpenCV, lilliput.go:199). Decodes 1/4/8 bpp palettes (RLE4/RLE8
too), 16 bpp (555, 565 and BI_BITFIELDS), 24/32 bpp, bottom-up and
top-down rows. The header, palette and RLE walk are host work; the
palette gather, bit and nibble unpacking, the 16-bit field extraction and
the row flip run on the decoder's device. The 16-bit fields are shifted
in int64, whose values equal the JAX package's uint32 arithmetic (torch
has few unsigned ops).
"""

from __future__ import annotations

import struct
from typing import Dict, Optional

import numpy as np
import torch

from ..errors import DecodingFailedError, InvalidImageError
from ..framebuffer import Framebuffer, ImageHeader, ImageOrientation
from ..interfaces import Decoder, Encoder
from ..utils import resolve_device
from ._raster import lut_gather, to_device, unpack_bits


def is_bmp(buf: bytes) -> bool:
    return len(buf) > 2 and buf[:2] == b"BM"


class BmpDecoder(Decoder):
    def __init__(self, buf: bytes, device="cuda"):
        if not is_bmp(buf):
            raise InvalidImageError("not a BMP")
        self.device = resolve_device(device)
        self._buf = buf
        self._parse_header()
        self._decoded = False

    def _parse_header(self) -> None:
        buf = self._buf
        if len(buf) < 54:
            raise InvalidImageError("BMP header truncated")
        self._data_off = struct.unpack_from("<I", buf, 10)[0]
        hdr_size = struct.unpack_from("<I", buf, 14)[0]
        if hdr_size >= 40:
            (w, h) = struct.unpack_from("<ii", buf, 18)
            _planes, bpp = struct.unpack_from("<HH", buf, 26)
            compression = struct.unpack_from("<I", buf, 30)[0]
            clr_used = struct.unpack_from("<I", buf, 46)[0]
        elif hdr_size == 12:  # BITMAPCOREHEADER
            (w, h) = struct.unpack_from("<hh", buf, 18)
            _planes, bpp = struct.unpack_from("<HH", buf, 22)
            compression = 0
            clr_used = 0
        else:
            raise InvalidImageError(f"unsupported BMP header size {hdr_size}")
        self._top_down = h < 0
        self._w, self._h = int(w), abs(int(h))
        if (self._w <= 0 or self._h == 0 or self._w > 1 << 20
                or self._h > 1 << 20):
            raise InvalidImageError("invalid BMP dimensions")
        self._bpp = bpp
        self._compression = compression  # 0=RGB 1=RLE8 2=RLE4 3=BITFIELDS
        self._palette = None
        if bpp <= 8:
            n = clr_used or (1 << bpp)
            entry = 4 if hdr_size >= 40 else 3
            pal = np.frombuffer(buf, np.uint8, count=n * entry,
                                offset=14 + hdr_size).reshape(n, entry)
            self._palette = np.ascontiguousarray(pal[:, :3])  # BGR
        # bitfield masks (16/32 bpp BI_BITFIELDS): after a 40-byte header,
        # inside a V4/V5 header at the same offset
        self._masks = None
        if compression == 3:
            self._masks = struct.unpack_from("<III", buf, 54)
        self._gray = (self._palette is not None
                      and bool(np.all(self._palette[:, 0:1] == self._palette)))

    def header(self) -> ImageHeader:
        ch = (1 if (self._bpp == 8 and self._gray)
              else (4 if self._bpp == 32 else 3))
        return ImageHeader(width=self._w, height=self._h, channels=ch,
                           orientation=ImageOrientation.TOP_LEFT,
                           num_frames=1, content_length=len(self._buf))

    def description(self) -> str:
        return "BMP"

    def icc(self) -> bytes:
        return b""

    # -- host serial stage ----------------------------------------------------

    def _rows_raw(self) -> np.ndarray:
        """Indexed/packed rows as a (h, stride) byte matrix, zero-padded
        where the file is short."""
        w, h, bpp = self._w, self._h, self._bpp
        stride = ((w * bpp + 31) // 32) * 4
        data = np.frombuffer(
            self._buf, np.uint8,
            count=min(stride * h, len(self._buf) - self._data_off),
            offset=self._data_off)
        if data.size < stride * h:
            data = np.concatenate(
                [data, np.zeros(stride * h - data.size, np.uint8)])
        return data.reshape(h, stride)

    def _decode_rle(self) -> np.ndarray:
        """RLE8/RLE4 -> (h, w) palette indices (a serial byte stream)."""
        w, h = self._w, self._h
        out = np.zeros((h, w), np.uint8)
        buf = self._buf
        i = self._data_off
        x = y = 0
        rle4 = self._compression == 2
        n = len(buf)
        while i + 1 < n and y < h:
            cnt, val = buf[i], buf[i + 1]
            i += 2
            if cnt > 0:  # run
                m = min(cnt, w - x)
                if m > 0:
                    if rle4:
                        run = np.empty(m, np.uint8)
                        run[0::2] = val >> 4
                        run[1::2] = val & 0xF
                        out[y, x:x + m] = run
                    else:
                        out[y, x:x + m] = val
                x += cnt
            elif val == 0:    # end of line
                x, y = 0, y + 1
            elif val == 1:    # end of bitmap
                break
            elif val == 2:    # delta
                if i + 1 >= n:
                    break
                x += buf[i]
                y += buf[i + 1]
                i += 2
            else:             # absolute mode
                cnt2 = val
                if rle4:
                    nbytes = (cnt2 + 1) // 2
                    chunk = np.frombuffer(buf, np.uint8, count=nbytes,
                                          offset=i)
                    nib = np.empty(nbytes * 2, np.uint8)
                    nib[0::2] = chunk >> 4
                    nib[1::2] = chunk & 0xF
                    vals = nib[:cnt2]
                    i += nbytes + (nbytes & 1)  # pad to 16-bit boundary
                else:
                    vals = np.frombuffer(buf, np.uint8, count=cnt2, offset=i)
                    i += cnt2 + (cnt2 & 1)
                m = min(cnt2, w - x)
                if m > 0:
                    out[y, x:x + m] = vals[:m]
                x += cnt2
        return out  # RLE bitmaps are bottom-up; the flip runs on the device

    def decode_to(self, fb: Framebuffer) -> None:
        if self._decoded:
            raise EOFError()
        w, h, bpp = self._w, self._h, self._bpp
        rle = self._compression in (1, 2)
        if rle:
            px = self._expand_palette(to_device(self._decode_rle(),
                                                self.device))
        elif bpp in (1, 4, 8):
            rows = to_device(self._rows_raw(), self.device)
            if bpp == 8:
                idx = rows[:, :w]
            elif bpp == 4:
                idx = torch.stack([rows >> 4, rows & 0xF],
                                  dim=-1).reshape(h, -1)[:, :w]
            else:
                idx = unpack_bits(rows)[:, :w]
            px = self._expand_palette(idx)
        elif bpp == 16:
            v = to_device(self._rows_raw()[:, :w * 2], self.device)
            v = v.reshape(h, w, 2).to(torch.int64)
            val = v[..., 0] | (v[..., 1] << 8)
            rm, gm, bm = self._masks or (0x7C00, 0x03E0, 0x001F)
            px = torch.stack([_mask_extract(val, bm), _mask_extract(val, gm),
                              _mask_extract(val, rm)], dim=-1)
        elif bpp in (24, 32):
            # BMP rows are already BGR(A)
            c = bpp // 8
            px = to_device(self._rows_raw()[:, :w * c].reshape(h, w, c),
                           self.device)
        else:
            raise DecodingFailedError(f"unsupported BMP bpp {bpp}")
        if rle or not self._top_down:
            px = torch.flip(px, dims=(0,))
        fb.array = px
        fb.duration = 0.0
        fb.x_offset = fb.y_offset = 0
        self._decoded = True

    def _expand_palette(self, idx: torch.Tensor) -> torch.Tensor:
        pal = self._palette
        if pal is None:
            raise DecodingFailedError("palette BMP without palette")
        if self._gray:
            return lut_gather(pal[:, 0], idx)[..., None]
        return lut_gather(pal, idx)  # (N, 3) BGR


def _mask_extract(val: torch.Tensor, mask: int) -> torch.Tensor:
    """One bitfield channel of int64 pixel words scaled to 0..255 like
    OpenCV's 555/565 path: a plain left shift into the high bits (no
    replication or rounding); the u8 cast keeps the low byte as the JAX
    package's uint32 -> uint8 does."""
    if mask == 0:
        return torch.zeros(val.shape, dtype=torch.uint8, device=val.device)
    shift = (mask & -mask).bit_length() - 1
    width = int(mask >> shift).bit_length()
    v = (val >> shift) & ((1 << width) - 1)
    v = v >> (width - 8) if width >= 8 else v << (8 - width)
    return (v & 255).to(torch.uint8)


class BmpEncoder(Encoder):
    """Uncompressed BMP writer (8 bpp gray palette, 24 or 32 bpp), with
    cv2's channel conventions."""

    def __init__(self, decoded_by: Optional[Decoder] = None,
                 icc_override: Optional[bytes] = None):
        del decoded_by, icc_override

    def encode(self, fb: Optional[Framebuffer],
               opts: Dict[int, int]) -> Optional[bytes]:
        if fb is None:
            raise DecodingFailedError("BMP encoder cannot flush without a frame")
        arr = fb.to_numpy()
        h, w = arr.shape[:2]
        ch = 1 if arr.ndim == 2 or arr.shape[2] == 1 else arr.shape[2]
        if arr.ndim == 3 and arr.shape[2] == 1:
            arr = arr[:, :, 0]
        if ch == 1:
            bpp, pal = 8, np.arange(256, dtype=np.uint8)
            pal_bytes = np.stack([pal, pal, pal, np.zeros(256, np.uint8)],
                                 axis=1).tobytes()
        elif ch == 3:
            bpp, pal_bytes = 24, b""
        elif ch == 4:
            bpp, pal_bytes = 32, b""
        else:
            raise DecodingFailedError(f"unsupported channel count {ch}")
        stride = ((w * bpp // 8) + 3) & ~3
        rows = np.zeros((h, stride), np.uint8)
        flat = arr.reshape(h, -1)
        rows[:, :flat.shape[1]] = flat
        data = rows[::-1].tobytes()  # bottom-up
        if ch == 4:
            # BGRA needs BITMAPV5HEADER + BI_BITFIELDS for readers (OpenCV
            # included) to keep the alpha channel, the form cv2 writes
            v5 = struct.pack("<IiiHHIIiiII", 124, w, h, 1, 32, 3, len(data),
                             2835, 2835, 0, 0)
            v5 += struct.pack("<IIII", 0x00FF0000, 0x0000FF00,
                              0x000000FF, 0xFF000000)   # RGBA masks
            v5 += struct.pack("<I", 0x73524742)          # LCS_sRGB
            v5 += b"\x00" * 36 + b"\x00" * 12            # endpoints, gammas
            v5 += struct.pack("<IIII", 4, 0, 0, 0)       # LCS_GM_IMAGES
            off = 14 + 124
            return (b"BM" + struct.pack("<IHHI", off + len(data), 0, 0, off)
                    + v5 + data)
        off = 14 + 40 + len(pal_bytes)
        header = (b"BM" + struct.pack("<IHHI", off + len(data), 0, 0, off)
                  + struct.pack("<IiiHHIIiiII", 40, w, h, 1, bpp, 0,
                                len(data), 2835, 2835,
                                256 if ch == 1 else 0, 0))
        return header + pal_bytes + data
