"""PFM codec (Portable FloatMap, PF/Pf).

The counterpart of ``lilliput_tpu/codecs/pfm.py`` (the reference decodes
.pfm through OpenCV's grfmt_pfm, lilliput.go:157, and encodes by
extension, lilliput.go:199), with OpenCV's conventions: floats are not
rescaled on either side (u8 output is saturate(round(f)), u8 input is
written as the float values 0..255), only the scale token's sign
(endianness) matters, scanlines are stored bottom-up. The header token
walk and the byte order stay on the host; the flip, the float -> u8
saturation and the RGB -> BGR order run on the decoder's device. A NaN
sample decodes to 0, as XLA converts it.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np
import torch

from ..errors import DecodingFailedError, InvalidImageError
from ..framebuffer import Framebuffer, ImageHeader, ImageOrientation
from ..interfaces import Decoder, Encoder
from ..utils import resolve_device
from ._raster import StillDecoder, to_device

_MAX_DIM = 1 << 20
_TOKEN = re.compile(rb"(?:\s|#[^\n]*\n)*([^\s#]+)")


def is_pfm(buf: bytes) -> bool:
    return (len(buf) >= 3 and buf[0] == 0x50  # 'P'
            and buf[1] in b"Ff" and buf[2] in b" \t\r\n")


class PfmDecoder(StillDecoder):
    def __init__(self, buf: bytes, device="cuda"):
        if not is_pfm(buf):
            raise InvalidImageError("not a PFM")
        self.device = resolve_device(device)
        self._buf = buf
        self._color = buf[1] == 0x46  # 'F' colour, 'f' gray
        pos = 2

        def tok():
            nonlocal pos
            m = _TOKEN.match(buf, pos)
            if not m:
                raise InvalidImageError("PFM header truncated")
            pos = m.end()
            return m.group(1)

        try:
            self._w = int(tok())
            self._h = int(tok())
            scale = float(tok())
        except ValueError as e:
            raise InvalidImageError("bad PFM header") from e
        if not (0 < self._w <= _MAX_DIM and 0 < self._h <= _MAX_DIM
                and scale != 0):
            raise InvalidImageError("invalid PFM header")
        self._little = scale < 0
        self._data_off = pos + 1  # exactly one whitespace byte after scale
        self._decoded = False

    def header(self) -> ImageHeader:
        return ImageHeader(width=self._w, height=self._h,
                           channels=3 if self._color else 1,
                           orientation=ImageOrientation.TOP_LEFT,
                           num_frames=1, content_length=len(self._buf))

    def description(self) -> str:
        return "PFM"

    def decode_to(self, fb: Framebuffer) -> None:
        if self._decoded:
            raise EOFError()
        c = 3 if self._color else 1
        n = self._w * self._h * c
        if len(self._buf) - self._data_off < n * 4:
            raise DecodingFailedError("PFM pixel data truncated")
        dt = np.dtype(np.float32).newbyteorder("<" if self._little else ">")
        f = np.frombuffer(self._buf, dt, count=n, offset=self._data_off)
        f = to_device(f.astype(np.float32).reshape(self._h, self._w, c),
                      self.device).flip(0)  # bottom-up storage
        # OpenCV's IMREAD_COLOR conversion: saturate, no 255 scaling
        px = torch.clamp(torch.round(f), 0, 255).nan_to_num(0.0)
        px = px.to(torch.uint8)
        fb.array = px.flip(-1) if self._color else px  # RGB -> BGR
        fb.duration = 0.0
        fb.x_offset = fb.y_offset = 0
        self._decoded = True


class PfmEncoder(Encoder):
    """Little-endian writer (scale -1), u8 values stored unscaled as
    floats, the bytes of cv::imencode(".pfm", u8_mat)."""

    def __init__(self, decoded_by: Optional[Decoder] = None,
                 icc_override: Optional[bytes] = None):
        del decoded_by, icc_override

    def encode(self, fb: Optional[Framebuffer],
               opts: Dict[int, int]) -> Optional[bytes]:
        if fb is None:
            raise DecodingFailedError(
                "PFM encoder cannot flush without a frame")
        arr = fb.to_numpy()
        if arr.ndim == 3 and arr.shape[2] == 1:
            arr = arr[:, :, 0]
        gray = arr.ndim == 2
        h, w = arr.shape[:2]
        body = arr if gray else arr[:, :, 2::-1]  # BGR(A) -> RGB
        body = body.astype("<f4")[::-1]  # bottom-up
        head = b"%s\n%d %d\n-1\n" % (b"Pf" if gray else b"PF", w, h)
        return head + np.ascontiguousarray(body).tobytes()
