"""Radiance HDR codec (.hdr, RGBE).

The counterpart of ``lilliput_tpu/codecs/hdr.py`` (the reference decodes
.hdr through OpenCV's grfmt_hdr, lilliput.go:157, and encodes by
extension, lilliput.go:199), with OpenCV's conversions: decode RGBE ->
float (mantissa * 2^(e-136)) -> u8 as round(f*255) saturated; encode u8
-> f = v/255 -> RGBE with the shared exponent of the largest channel and
truncated mantissas (rgbe.cpp's float2rgbe). The header and the scanline
RLE walks stay on the host; the RGBE <-> u8 arithmetic runs on the
decoder's (or the frame's) device. Powers of two come from exact tables,
not exp2, and the exponent from floor(log2(v)), which gives the JAX
package's exponent for each of the 256 values a u8 maximum can take.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..errors import DecodingFailedError, InvalidImageError
from ..framebuffer import Framebuffer, ImageHeader, ImageOrientation
from ..interfaces import Decoder, Encoder
from ..utils import resolve_device
from ._raster import StillDecoder, to_device

_MAX_DIM = 1 << 20


def is_hdr(buf: bytes) -> bool:
    return buf.startswith(b"#?RADIANCE") or buf.startswith(b"#?RGBE")


def _decode_scanlines(buf: bytes, off: int, w: int, h: int) -> np.ndarray:
    """RGBE scanlines -> (h, w, 4) u8: new-style per-component RLE (the
    0x02 0x02 marker), old-style runs (1, 1, 1, count repeats the previous
    pixel) and flat data. A serial byte walk, on the host."""
    out = np.empty((h, w, 4), np.uint8)
    n = len(buf)
    y = 0
    while y < h:
        if off + 4 > n:
            raise DecodingFailedError("HDR pixel data truncated")
        p0, p1, p2, p3 = buf[off], buf[off + 1], buf[off + 2], buf[off + 3]
        if p0 == 2 and p1 == 2 and (p2 << 8 | p3) == w and w >= 8:
            # new style: each of the 4 components RLE'd across the line
            off += 4
            row = np.empty((4, w), np.uint8)
            for c in range(4):
                x = 0
                while x < w:
                    if off >= n:
                        raise DecodingFailedError("HDR RLE truncated")
                    cnt = buf[off]
                    off += 1
                    if cnt > 128:  # a run of cnt-128 copies of the next byte
                        cnt -= 128
                        if off >= n or x + cnt > w:
                            raise DecodingFailedError("HDR RLE overrun")
                        row[c, x:x + cnt] = buf[off]
                        off += 1
                    else:  # cnt literal bytes
                        if off + cnt > n or x + cnt > w:
                            raise DecodingFailedError("HDR RLE overrun")
                        row[c, x:x + cnt] = np.frombuffer(
                            buf, np.uint8, count=cnt, offset=off)
                        off += cnt
                    x += cnt
            out[y] = row.T
            y += 1
            continue
        # a flat scanline with no old-style run marker past its first
        # pixel is a straight (w, 4) view (what HdrEncoder writes)
        if off + 4 * w <= n:
            rv = np.frombuffer(buf, np.uint8, count=4 * w,
                               offset=off).reshape(w, 4)
            if not ((rv[1:, 0] == 1) & (rv[1:, 1] == 1)
                    & (rv[1:, 2] == 1)).any():
                out[y] = rv
                off += 4 * w
                y += 1
                continue
        # old-style RLE: walk the pixels
        x = 0
        shift = 0
        while y < h:
            if off + 4 > n:
                raise DecodingFailedError("HDR pixel data truncated")
            r, g, b, e = buf[off], buf[off + 1], buf[off + 2], buf[off + 3]
            off += 4
            if r == 1 and g == 1 and b == 1 and x > 0:
                cnt = e << shift
                if x + cnt > w:
                    raise DecodingFailedError("HDR old-RLE overrun")
                out[y, x:x + cnt] = out[y, x - 1]
                x += cnt
                shift += 8
            else:
                out[y, x] = (r, g, b, e)
                x += 1
                shift = 0
            if x == w:
                y += 1
                x = 0
                shift = 0
                break
    return out


#: 2^(e-136) for exponent byte e > 0, 0 for e = 0, exact in f32
_RGBE_SCALES = np.array([0.0] + [2.0 ** (e - 136) for e in range(1, 256)],
                        np.float32)
#: 2^k for k = 0..127, exact in f32
_POW2 = np.array([2.0 ** k for k in range(128)], np.float32)


def rgbe_to_u8_bgr(rgbe: torch.Tensor) -> torch.Tensor:
    """(..., 4) RGBE u8 -> (..., 3) BGR u8, OpenCV's chain (rgbe2float,
    then IMREAD_COLOR's *255 saturate)."""
    m = rgbe[..., :3].to(torch.float32)
    scale = to_device(_RGBE_SCALES, rgbe.device)[rgbe[..., 3].long()]
    u8 = torch.clamp(torch.round(m * scale[..., None] * 255.0), 0, 255)
    return u8.to(torch.uint8).flip(-1)  # RGB -> BGR


def u8_bgr_to_rgbe(px: torch.Tensor) -> torch.Tensor:
    """(..., 3) BGR u8 -> (..., 4) RGBE u8, OpenCV's float2rgbe: the
    shared exponent of the largest channel, mantissas truncated."""
    f = px.flip(-1).to(torch.float32) / 255.0  # BGR -> RGB, to float
    v = f.amax(dim=-1)
    # frexp: v = m * 2^e, m in [0.5, 1) -> e = floor(log2(v)) + 1
    e = torch.floor(torch.log2(torch.clamp(v, min=1e-38))).to(
        torch.int64) + 1
    # 2^(8-e) exactly from a table: e <= 1 for v <= 1, and a zero pixel
    # (clamped to 1e-38, e = -126) takes 2^127, which leaves its mantissas
    # 0 (it is written as 0 below, as in the JAX package)
    pow2 = to_device(_POW2, px.device)
    mant = (f * pow2[(8 - e).clamp(0, 127)][..., None]).to(torch.uint8)
    tiny = v < 1e-32
    return torch.cat(
        [torch.where(tiny[..., None], 0, mant),
         torch.where(tiny, 0, e + 128).to(torch.uint8)[..., None]], dim=-1)


class HdrDecoder(StillDecoder):
    def __init__(self, buf: bytes, device="cuda"):
        if not is_hdr(buf):
            raise InvalidImageError("not a Radiance HDR")
        self.device = resolve_device(device)
        self._buf = buf
        # header: text lines up to a blank line, then the resolution line
        end = buf.find(b"\n\n")
        if end < 0:
            raise InvalidImageError("HDR header truncated")
        res_end = buf.find(b"\n", end + 2)
        if res_end < 0:
            raise InvalidImageError("HDR resolution line truncated")
        parts = buf[end + 2:res_end].split()
        # the standard orientation only (what OpenCV supports): -Y h +X w
        if len(parts) != 4 or parts[0] != b"-Y" or parts[2] != b"+X":
            raise InvalidImageError("unsupported HDR pixel ordering")
        try:
            self._h, self._w = int(parts[1]), int(parts[3])
        except ValueError as e:
            raise InvalidImageError("bad HDR resolution") from e
        if not (0 < self._w <= _MAX_DIM and 0 < self._h <= _MAX_DIM):
            raise InvalidImageError("invalid HDR dimensions")
        self._data_off = res_end + 1
        self._decoded = False

    def header(self) -> ImageHeader:
        return ImageHeader(width=self._w, height=self._h, channels=3,
                           orientation=ImageOrientation.TOP_LEFT,
                           num_frames=1, content_length=len(self._buf))

    def description(self) -> str:
        return "HDR"

    def decode_to(self, fb: Framebuffer) -> None:
        if self._decoded:
            raise EOFError()
        rgbe = _decode_scanlines(self._buf, self._data_off, self._w, self._h)
        fb.array = rgbe_to_u8_bgr(to_device(rgbe, self.device))
        fb.duration = 0.0
        fb.x_offset = fb.y_offset = 0
        self._decoded = True


class HdrEncoder(Encoder):
    """Flat (non-RLE) RGBE writer, which every Radiance reader takes; gray
    frames are broadcast to RGB first, as imwrite converts them."""

    def __init__(self, decoded_by: Optional[Decoder] = None,
                 icc_override: Optional[bytes] = None):
        del decoded_by, icc_override

    def encode(self, fb: Optional[Framebuffer],
               opts: Dict[int, int]) -> Optional[bytes]:
        if fb is None:
            raise DecodingFailedError(
                "HDR encoder cannot flush without a frame")
        px = fb.array
        if px.dim() == 2:
            px = px[..., None]
        if px.shape[-1] == 1:
            px = px.expand(px.shape[:-1] + (3,))
        rgbe = u8_bgr_to_rgbe(px[..., :3]).cpu().numpy()
        h, w = rgbe.shape[:2]
        head = (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
                + b"-Y %d +X %d\n" % (h, w))
        return head + rgbe.tobytes()
