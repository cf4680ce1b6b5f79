"""PNM (PBM/PGM/PPM, P1-P6) and PAM (P7) codecs.

The counterpart of ``lilliput_tpu/codecs/pnm.py`` (the reference decodes
the netpbm family through OpenCV's grfmt_pxm and grfmt_pam,
lilliput.go:157, and encodes by extension, lilliput.go:199), with OpenCV's
reader semantics: ASCII and binary, maxval up to 65535 (16-bit samples
big-endian, scaled to 8 bits by >> 8). The header and the ASCII token walk
stay on the host; the P4 bit unpack, the maxval rescales (in int32) and
the RGB -> BGR reversal run on the decoder's device.
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
from ._raster import StillDecoder, to_device, unpack_bits


def is_pnm(buf: bytes) -> bool:
    return (len(buf) >= 3 and buf[0] == 0x50  # 'P'
            and buf[1] in b"123456" and buf[2] in b" \t\r\n#")


def is_pam(buf: bytes) -> bool:
    return (len(buf) >= 3 and buf[0] == 0x50  # 'P'
            and buf[1] == 0x37 and buf[2] in b" \t\r\n#")


_TOKEN = re.compile(rb"(?:\s|#[^\n]*\n)*([^\s#]+)")


class PnmDecoder(StillDecoder):
    def __init__(self, buf: bytes, device="cuda"):
        if not is_pnm(buf):
            raise InvalidImageError("not a PNM")
        self.device = resolve_device(device)
        self._buf = buf
        self._kind = buf[1] - 0x30  # 1..6
        self._parse_header()
        self._decoded = False

    def _next_token(self) -> bytes:
        m = _TOKEN.match(self._buf, self._pos)
        if not m:
            raise InvalidImageError("PNM header truncated")
        self._pos = m.end()
        return m.group(1)

    def _int_token(self) -> int:
        t = self._next_token()
        try:
            return int(t)
        except ValueError:
            raise InvalidImageError("invalid PNM header token")

    def _parse_header(self) -> None:
        self._pos = 2
        self._w = self._int_token()
        self._h = self._int_token()
        self._maxval = 1 if self._kind in (1, 4) else self._int_token()
        if not (0 < self._w <= 1 << 20 and 0 < self._h <= 1 << 20
                and 0 < self._maxval <= 65535):
            raise InvalidImageError("invalid PNM header")
        # binary formats: exactly one whitespace byte after the header
        if self._kind >= 4:
            self._data_off = self._pos + 1
        self._color = self._kind in (3, 6)

    def header(self) -> ImageHeader:
        return ImageHeader(width=self._w, height=self._h,
                           channels=3 if self._color else 1,
                           orientation=ImageOrientation.TOP_LEFT,
                           num_frames=1, content_length=len(self._buf))

    def description(self) -> str:
        return {1: "PBM", 2: "PGM", 3: "PPM",
                4: "PBM", 5: "PGM", 6: "PPM"}[self._kind]

    def _samples(self) -> np.ndarray:
        """Raw samples, (h, w, c) uint16 ((h, stride, 1) packed bytes for
        P4), parsed on the host."""
        w, h = self._w, self._h
        c = 3 if self._color else 1
        k = self._kind
        if k in (1, 2, 3):               # ASCII
            body = re.sub(rb"#[^\n]*", b"", self._buf[self._pos:])
            if k == 1:
                # PBM ASCII reads single digits: the packed form '0110'
                # has no separators (cv2's reading)
                ba = np.frombuffer(body, np.uint8)
                digits = ba[(ba == 0x30) | (ba == 0x31)] - 0x30
                vals = digits[: h * w].astype(np.uint16)
            else:
                try:
                    vals = np.array(body.split()[: h * w * c], np.uint16)
                except (ValueError, OverflowError):
                    raise DecodingFailedError("PNM pixel data malformed")
            if vals.size < h * w * c:
                raise DecodingFailedError("PNM pixel data truncated")
            if k == 1:                    # PBM ASCII: 1 = black
                vals = 1 - vals
            return vals.reshape(h, w, c)
        if k == 4:                        # packed bits, rows byte-aligned
            stride = (w + 7) // 8
            need = stride * h
            if len(self._buf) - self._data_off < need:
                raise DecodingFailedError("PNM pixel data truncated")
            data = np.frombuffer(self._buf, np.uint8, count=need,
                                 offset=self._data_off)
            return data.reshape(h, stride)[..., None].astype(np.uint16)
        bytes_per = 2 if self._maxval > 255 else 1
        need = h * w * c * bytes_per
        if len(self._buf) - self._data_off < need:
            raise DecodingFailedError("PNM pixel data truncated")
        data = np.frombuffer(self._buf, np.uint8, count=need,
                             offset=self._data_off)
        if bytes_per == 2:                # big-endian 16-bit samples
            data = data.reshape(h, w, c, 2).astype(np.uint16)
            return (data[..., 0] << 8) | data[..., 1]
        return data.reshape(h, w, c).astype(np.uint16)

    def decode_to(self, fb: Framebuffer) -> None:
        if self._decoded:
            raise EOFError()
        raw = to_device(self._samples().astype(np.int32), self.device)
        if self._kind == 4:               # bit unpack: 1 = black
            bits = unpack_bits(raw[..., 0].to(torch.uint8))[:, :self._w]
            px = ((1 - bits) * 255)[..., None]
        elif self._maxval == 255:
            px = raw.to(torch.uint8)
        elif self._maxval > 255:          # OpenCV scales 16 bits down: >> 8
            px = (raw >> 8).to(torch.uint8)
        elif self._kind >= 4:
            # binary small-maxval samples come back raw: OpenCV's
            # grfmt_pxm rescales only in its ASCII reader
            px = torch.clamp(raw, 0, 255).to(torch.uint8)
        else:
            # ASCII small maxval scales with integer truncation,
            # v*255/maxval (cv2: maxval=100 value 50 -> 127)
            px = torch.clamp(torch.div(raw * 255, self._maxval,
                                       rounding_mode="floor"),
                             0, 255).to(torch.uint8)
        if self._color:
            px = px.flip(-1)              # RGB file order -> BGR
        fb.array = px
        fb.duration = 0.0
        fb.x_offset = fb.y_offset = 0
        self._decoded = True


#: PAM tuple types and their sample depths (netpbm pam(5))
_PAM_TUPLTYPES = {
    b"BLACKANDWHITE": 1,
    b"GRAYSCALE": 1,
    b"GRAYSCALE_ALPHA": 2,
    b"RGB": 3,
    b"RGB_ALPHA": 4,
}


class PamDecoder(StillDecoder):
    """PAM (P7), with OpenCV grfmt_pam's semantics: samples are a raw dump
    (no RGB <-> BGR swap on either side), 16-bit big-endian scaled by
    >> 8, small maxval returned raw, header fields in any order with '#'
    comments, TUPLTYPE optional where DEPTH alone decides it (1 gray,
    3 RGB)."""

    def __init__(self, buf: bytes, device="cuda"):
        if not is_pam(buf):
            raise InvalidImageError("not a PAM")
        self.device = resolve_device(device)
        self._buf = buf
        self._parse_header()
        self._decoded = False

    def _parse_header(self) -> None:
        pos = 2
        fields: Dict[bytes, bytes] = {}
        while True:
            nl = self._buf.find(b"\n", pos)
            if nl < 0 or nl - pos > 256:
                raise InvalidImageError("PAM header truncated")
            line = self._buf[pos:nl].strip()
            pos = nl + 1
            if not line or line.startswith(b"#"):
                continue
            if line == b"ENDHDR":
                break
            parts = line.split(None, 1)
            if len(parts) != 2:
                raise InvalidImageError("malformed PAM header line")
            fields[parts[0].upper()] = parts[1].strip()
        try:
            self._w = int(fields[b"WIDTH"])
            self._h = int(fields[b"HEIGHT"])
            self._depth = int(fields[b"DEPTH"])
            self._maxval = int(fields[b"MAXVAL"])
        except (KeyError, ValueError) as e:
            raise InvalidImageError("incomplete PAM header") from e
        tupl = fields.get(b"TUPLTYPE", b"").upper()
        if tupl:
            want = _PAM_TUPLTYPES.get(tupl)
            if want is None:
                raise InvalidImageError(f"unknown PAM TUPLTYPE {tupl!r}")
            if want != self._depth:
                raise InvalidImageError(
                    f"PAM DEPTH {self._depth} contradicts TUPLTYPE {tupl!r}")
        elif self._depth not in (1, 3):
            # cv2 refuses the same: depth 2 or 4 is ambiguous without one
            raise InvalidImageError(
                f"PAM DEPTH {self._depth} needs a TUPLTYPE header")
        if not (0 < self._w <= 1 << 20 and 0 < self._h <= 1 << 20
                and 0 < self._depth <= 4 and 0 < self._maxval <= 65535):
            raise InvalidImageError("invalid PAM header")
        self._data_off = pos

    def header(self) -> ImageHeader:
        return ImageHeader(width=self._w, height=self._h,
                           channels=self._depth,
                           orientation=ImageOrientation.TOP_LEFT,
                           num_frames=1, content_length=len(self._buf))

    def description(self) -> str:
        return "PAM"

    def decode_to(self, fb: Framebuffer) -> None:
        if self._decoded:
            raise EOFError()
        w, h, c = self._w, self._h, self._depth
        bytes_per = 2 if self._maxval > 255 else 1
        need = h * w * c * bytes_per
        if len(self._buf) - self._data_off < need:
            raise DecodingFailedError("PAM pixel data truncated")
        data = to_device(np.frombuffer(self._buf, np.uint8, count=need,
                                       offset=self._data_off), self.device)
        if bytes_per == 2:                # big-endian: the high byte
            fb.array = data.reshape(h, w, c, 2)[..., 0].contiguous()
        else:
            fb.array = data.reshape(h, w, c)
        fb.duration = 0.0
        fb.x_offset = fb.y_offset = 0
        self._decoded = True


class PamEncoder(Encoder):
    """PAM (P7) writer, the bytes of cv2.imencode('.pam', ...): no
    TUPLTYPE line, MAXVAL 255, the samples in their stored order."""

    def __init__(self, decoded_by: Optional[Decoder] = None,
                 icc_override: Optional[bytes] = None):
        del decoded_by, icc_override

    def encode(self, fb: Optional[Framebuffer],
               opts: Dict[int, int]) -> Optional[bytes]:
        if fb is None:
            raise DecodingFailedError("PAM encoder cannot flush without a frame")
        arr = fb.to_numpy()
        if arr.ndim == 2:
            arr = arr[:, :, None]
        h, w, c = arr.shape
        return (b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH %d\nMAXVAL 255\nENDHDR\n"
                % (w, h, c)) + np.ascontiguousarray(arr).tobytes()


class PnmEncoder(Encoder):
    """Binary P5 (gray) / P6 (colour) writer, OpenCV's default form, and
    P4 for .pbm. A channel count the extension does not take raises as
    OpenCV's grfmt_pxm writer does; ".pnm" takes either."""

    def __init__(self, decoded_by: Optional[Decoder] = None,
                 icc_override: Optional[bytes] = None,
                 subtype: str = ".pnm"):
        del decoded_by, icc_override
        self._subtype = subtype

    def encode(self, fb: Optional[Framebuffer],
               opts: Dict[int, int]) -> Optional[bytes]:
        if fb is None:
            raise DecodingFailedError("PNM encoder cannot flush without a frame")
        arr = fb.to_numpy()
        if arr.ndim == 3 and arr.shape[2] == 1:
            arr = arr[:, :, 0]
        gray = arr.ndim == 2
        if self._subtype in (".pgm", ".pbm") and not gray:
            raise DecodingFailedError(
                f"{self._subtype} expects a gray image (grfmt_pxm semantics)")
        if self._subtype == ".ppm" and gray:
            raise DecodingFailedError(
                ".ppm expects a color image (grfmt_pxm semantics)")
        h, w = arr.shape[:2]
        if self._subtype == ".pbm":
            # OpenCV's .pbm writer emits P4 packed 1-bit, bit 1 (black)
            # where the sample is 0
            bits = np.packbits((arr == 0).astype(np.uint8), axis=1)
            return b"P4\n%d %d\n" % (w, h) + bits.tobytes()
        if gray:
            return b"P5\n%d %d\n255\n" % (w, h) + arr.tobytes()
        rgb = np.ascontiguousarray(arr[:, :, 2::-1])  # BGR(A) -> RGB
        return b"P6\n%d %d\n255\n" % (w, h) + rgb.tobytes()
