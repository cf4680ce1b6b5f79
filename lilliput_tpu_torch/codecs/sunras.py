"""Sun Raster codec (.sr/.ras).

The counterpart of ``lilliput_tpu/codecs/sunras.py`` (the reference
decodes Sun Raster through OpenCV's grfmt_sunras, lilliput.go:157, and
encodes it by extension, lilliput.go:199), with the OpenCV 4.x reader's
semantics: a big-endian 32-byte header, rows padded to even bytes,
RT_OLD/RT_STANDARD/RT_BYTE_ENCODED/RT_FORMAT_RGB, an optional
RMT_EQUAL_RGB colormap (all R, then all G, then all B), 1-bit bitmaps
(1 = black). The RLE walk stays on the host; the colormap gather, the
1-bit unpack and the channel order run on the decoder's device.
"""

from __future__ import annotations

import struct
from typing import Dict, Optional

import numpy as np

from ..errors import DecodingFailedError, InvalidImageError
from ..framebuffer import Framebuffer, ImageHeader, ImageOrientation
from ..interfaces import Decoder, Encoder
from ..utils import resolve_device
from ._raster import StillDecoder, lut_gather, to_device, unpack_bits

_RAS_MAGIC = 0x59A66A95

RT_OLD = 0
RT_STANDARD = 1
RT_BYTE_ENCODED = 2
RT_FORMAT_RGB = 3

RMT_NONE = 0
RMT_EQUAL_RGB = 1

_MAX_DIM = 1 << 20


def is_sunras(buf: bytes) -> bool:
    return len(buf) >= 32 and buf[:4] == b"\x59\xa6\x6a\x95"


def _unrle(data: bytes, need: int) -> bytes:
    """Sun byte-RLE: 0x80, count, value emits count+1 copies; 0x80, 0 a
    literal 0x80; any other byte is a literal. Serial, on the host."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n and len(out) < need:
        b = data[i]
        if b == 0x80:
            if i + 1 >= n:
                break
            cnt = data[i + 1]
            if cnt == 0:
                out.append(0x80)
                i += 2
            else:
                if i + 2 >= n:
                    break
                out += bytes([data[i + 2]]) * (cnt + 1)
                i += 3
        else:
            out.append(b)
            i += 1
    if len(out) < need:
        raise DecodingFailedError("Sun Raster RLE data truncated")
    return bytes(out[:need])


class SunRasDecoder(StillDecoder):
    def __init__(self, buf: bytes, device="cuda"):
        if not is_sunras(buf):
            raise InvalidImageError("not a Sun Raster")
        self.device = resolve_device(device)
        (self._w, self._h, self._depth, self._length, self._type,
         maptype, maplen) = struct.unpack(">7I", buf[4:32])
        if not (0 < self._w <= _MAX_DIM and 0 < self._h <= _MAX_DIM):
            raise InvalidImageError("invalid Sun Raster dimensions")
        if self._depth not in (1, 8, 24, 32):
            raise InvalidImageError(
                f"unsupported Sun Raster depth {self._depth}")
        if self._type not in (RT_OLD, RT_STANDARD, RT_BYTE_ENCODED,
                              RT_FORMAT_RGB):
            raise InvalidImageError(
                f"unsupported Sun Raster type {self._type}")
        self._palette = None
        off = 32
        if maptype == RMT_EQUAL_RGB and maplen:
            if maplen % 3 or maplen > 768 or len(buf) < off + maplen:
                raise InvalidImageError("invalid Sun Raster colormap")
            n = maplen // 3
            raw = np.frombuffer(buf, np.uint8, count=maplen, offset=off)
            # all R, then all G, then all B in the file; BGR entries here
            self._palette = np.stack(
                [raw[2 * n:3 * n], raw[n:2 * n], raw[:n]], axis=1)
            off += maplen
        elif maptype not in (RMT_NONE, RMT_EQUAL_RGB):
            raise InvalidImageError(
                f"unsupported Sun Raster maptype {maptype}")
        self._data_off = off
        self._buf = buf
        self._decoded = False

    @property
    def _channels(self) -> int:
        if self._depth in (24, 32):
            return 3
        if self._palette is not None and not np.all(
                self._palette[:, 0:1] == self._palette):
            return 3
        return 1

    def header(self) -> ImageHeader:
        return ImageHeader(width=self._w, height=self._h,
                           channels=self._channels,
                           orientation=ImageOrientation.TOP_LEFT,
                           num_frames=1, content_length=len(self._buf))

    def description(self) -> str:
        return "RAS"

    def _rows(self) -> np.ndarray:
        """Raw row bytes (h, pitch) after un-RLE, on the host."""
        pitch = ((self._w * self._depth + 7) // 8 + 1) & ~1  # even bytes
        need = pitch * self._h
        payload = self._buf[self._data_off:]
        if self._type == RT_BYTE_ENCODED:
            flat = _unrle(payload, need)
        else:
            if len(payload) < need:
                raise DecodingFailedError("Sun Raster pixel data truncated")
            flat = payload[:need]
        return np.frombuffer(flat, np.uint8).reshape(self._h, pitch)

    def decode_to(self, fb: Framebuffer) -> None:
        if self._decoded:
            raise EOFError()
        rows = to_device(self._rows(), self.device)
        w = self._w
        if self._depth == 1:
            bits = unpack_bits(rows)[:, :w]
            if self._palette is not None and len(self._palette) >= 2:
                px = lut_gather(self._palette, bits)
                if self._channels == 1:
                    px = px[..., :1]
            else:
                # Sun convention: 1 = black on white
                px = ((1 - bits) * 255)[..., None]
        elif self._depth == 8:
            idx = rows[:, :w]
            if self._palette is not None:
                px = lut_gather(self._palette, idx)
                if self._channels == 1:
                    px = px[..., :1]
            else:
                px = idx[..., None]
        elif self._depth == 24:
            px = rows[:, :w * 3].reshape(self._h, w, 3)
            if self._type == RT_FORMAT_RGB:
                px = px.flip(-1)  # file RGB -> BGR
        else:  # 32: a pad byte, then the colour triple
            px = rows[:, :w * 4].reshape(self._h, w, 4)[..., 1:]
            if self._type == RT_FORMAT_RGB:
                px = px.flip(-1)
        fb.array = px.contiguous()
        fb.duration = 0.0
        fb.x_offset = fb.y_offset = 0
        self._decoded = True


class SunRasEncoder(Encoder):
    """RT_STANDARD writer: 24-bit BGR for colour, 8-bit with an identity
    gray colormap for gray."""

    def __init__(self, decoded_by: Optional[Decoder] = None,
                 icc_override: Optional[bytes] = None):
        del decoded_by, icc_override

    def encode(self, fb: Optional[Framebuffer],
               opts: Dict[int, int]) -> Optional[bytes]:
        if fb is None:
            raise DecodingFailedError(
                "Sun Raster encoder cannot flush without a frame")
        arr = fb.to_numpy()
        if arr.ndim == 3 and arr.shape[2] == 1:
            arr = arr[:, :, 0]
        h, w = arr.shape[:2]
        if arr.ndim == 2:
            depth, maplen = 8, 768
            mapdata = bytes(range(256)) * 3
            body = arr
        else:
            depth, maplen = 24, 0
            mapdata = b""
            body = np.ascontiguousarray(arr[:, :, :3])  # BGR, no alpha
        pitch = ((w * depth // 8) + 1) & ~1
        rows = body.reshape(h, -1)
        if rows.shape[1] < pitch:
            rows = np.pad(rows, ((0, 0), (0, pitch - rows.shape[1])))
        data = rows.tobytes()
        hdr = struct.pack(">8I", _RAS_MAGIC, w, h, depth, len(data),
                          RT_STANDARD, RMT_EQUAL_RGB if maplen else RMT_NONE,
                          maplen)
        return hdr + mapdata + data
