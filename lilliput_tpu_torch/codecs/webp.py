"""WebP codec over libwebp, through the port's copy of the JAX package's
shim (``csrc/host/webp_shim.cpp``, built by ``binding.load_webp``).

The counterpart of ``lilliput_tpu/codecs/webp.py``, with its behaviour
(the reference's webp.cpp / webp.go): decode yields frame-sized buffers
with x/y offsets, dispose and blend (composited by ImageOps on the
frames' device), the WebP enum values mapping 1:1 onto DisposeMethod and
BlendMethod; the encoder buffers frames and chooses still or animation at
flush, reattaching the ICC profile and the animation parameters.

libwebp decodes on the host, and each frame is handed out as a tensor on
the decoder's device ("cuda" unless the caller passes device="cpu"), as
``GifDecoder`` does. Where libwebp's headers are absent every entry point
raises ``errors.HostLibraryMissingError``; there is no Python route.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np
import torch

from .. import binding
from ..errors import DecodingFailedError, InvalidImageError
from ..framebuffer import (WEBP_AUTOFILTER, WEBP_FILTER_STRENGTH,
                           WEBP_FILTER_TYPE, WEBP_METHOD, WEBP_PALETTE,
                           WEBP_PARTITIONS, WEBP_PREPROCESSING,
                           WEBP_QUALITY, WEBP_SEGMENTS, WEBP_THREAD_LEVEL,
                           BlendMethod, DisposeMethod, Framebuffer,
                           ImageHeader, ImageOrientation)
from ..interfaces import Decoder, Encoder, check_encode_options
from ..utils import resolve_device

_WEBP_ENCODE_KEYS = frozenset({
    WEBP_QUALITY, WEBP_METHOD, WEBP_FILTER_STRENGTH, WEBP_FILTER_TYPE,
    WEBP_AUTOFILTER, WEBP_PARTITIONS, WEBP_SEGMENTS, WEBP_PREPROCESSING,
    WEBP_THREAD_LEVEL, WEBP_PALETTE})

_i32p = ctypes.POINTER(ctypes.c_int32)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def _u8(a: np.ndarray):
    return a.ctypes.data_as(_u8p)


def _icc_array(icc: Optional[bytes]) -> np.ndarray:
    return np.frombuffer(icc, np.uint8) if icc else np.zeros(0, np.uint8)


class WebpDecoder(Decoder):
    def __init__(self, buf: bytes, device="cuda"):
        self.device = resolve_device(device)
        self._lib = binding.load_webp()
        self._buf = np.frombuffer(buf, np.uint8)
        info = np.zeros(8, np.int32)
        self._h = self._lib.lp_webp_open(_u8(self._buf), self._buf.size,
                                         info.ctypes.data_as(_i32p))
        if not self._h:
            raise InvalidImageError("not a valid WebP")
        (self._w, self._hgt, self._frames, self._loops, self._alpha,
         self._anim, self._bg, self._icc_len) = (int(v) for v in info)
        self._channels = 4 if self._alpha else 3
        self._closed = False

    def header(self) -> ImageHeader:
        return ImageHeader(width=self._w, height=self._hgt,
                           channels=self._channels,
                           orientation=ImageOrientation.TOP_LEFT,
                           num_frames=self._frames,
                           content_length=len(self._buf))

    def description(self) -> str:
        return "WEBP"

    def video_codec(self) -> str:
        return "VP8"

    def loop_count(self) -> int:
        return self._loops

    def duration(self) -> float:
        """Total animation duration in seconds (the sum of every frame's
        duration, 0 for still images; reference webp.go:73-77)."""
        return self._lib.lp_webp_total_duration(self._h) / 1000.0

    def background_color(self) -> int:
        return self._bg & 0xFFFFFFFF

    def icc(self) -> bytes:
        if self._icc_len <= 0:
            return b""
        out = np.zeros(self._icc_len, np.uint8)
        n = self._lib.lp_webp_icc(self._h, _u8(out), out.size)
        return out[:n].tobytes() if n > 0 else b""

    def next_frame(self, channels: int):
        """The next frame's (pixels, meta) on the host: (h, w, channels) u8
        BGR(A) and (x, y, w, h, duration_ms, dispose, blend,
        frame_has_alpha); None after the last frame."""
        meta = np.zeros(8, np.int32)
        st = self._lib.lp_webp_next_frame(self._h, meta.ctypes.data_as(_i32p))
        if st == 0:
            return None
        if st < 0:
            raise DecodingFailedError("webp frame parse failed")
        meta = tuple(int(v) for v in meta)
        w, h = meta[2], meta[3]
        px = np.empty((h, w, channels), np.uint8)
        if self._lib.lp_webp_frame_pixels(self._h, _u8(px), channels, w,
                                          h) != 0:
            raise DecodingFailedError("webp frame decode failed")
        return px, meta

    def decode_to(self, fb: Framebuffer) -> None:
        frame = self.next_frame(self._channels)
        if frame is None:
            raise EOFError()
        px, (x, y, _, _, dur_ms, dispose, blend, _) = frame
        fb.array = torch.from_numpy(px).to(self.device)
        fb.duration = dur_ms / 1000.0
        fb.x_offset, fb.y_offset = x, y
        fb.dispose = DisposeMethod(dispose)   # 0 none / 1 background (1:1)
        fb.blend = BlendMethod(blend)         # 0 alpha-blend / 1 no-blend

    def close(self) -> None:
        if not self._closed and self._h:
            self._lib.lp_webp_free(self._h)
            self._closed = True
            self._h = None


def _opts_array(opts: Dict[int, int]) -> np.ndarray:
    check_encode_options(opts, _WEBP_ENCODE_KEYS, "webp")
    flat = []
    for k, v in (opts or {}).items():
        flat += [int(k), int(v)]
    return np.asarray(flat, np.int32) if flat else np.zeros(0, np.int32)


def _opts_ptr(o: np.ndarray):
    return o.ctypes.data_as(_i32p) if o.size else None


def encode_webp_pixels(px: np.ndarray, opts: Optional[Dict[int, int]] = None,
                       icc: Optional[bytes] = None) -> bytes:
    """One-shot still-WebP encode of (H, W, 3|4) BGR(A) u8 pixels: the
    serving pipelines' pixel-emit encode (WebpEncoder's shim calls without
    a Framebuffer)."""
    lib = binding.load_webp()
    icc_arr = _icc_array(icc)
    h = lib.lp_webp_enc_new(_u8(icc_arr) if icc_arr.size else None,
                            icc_arr.size, ctypes.c_uint32(0), 0)
    if not h:
        raise DecodingFailedError("webp encoder init failed")
    try:
        o = _opts_array(opts or {})
        hgt, wdt, ch = px.shape
        px = np.ascontiguousarray(px)
        if lib.lp_webp_enc_add(h, _u8(px), wdt, hgt, ch, 0, _opts_ptr(o),
                               o.size):
            raise DecodingFailedError("webp frame add failed")
        out = np.empty(wdt * hgt * 4 + (1 << 20) + icc_arr.size, np.uint8)
        n = lib.lp_webp_enc_flush(h, _opts_ptr(o), o.size, _u8(out),
                                  out.size)
        if n < 0:
            raise DecodingFailedError(f"webp flush failed ({n})")
        return out[:n].tobytes()
    finally:
        lib.lp_webp_enc_free(h)


def encode_webp_yuv(y: np.ndarray, u: np.ndarray, v: np.ndarray,
                    opts: Optional[Dict[int, int]] = None,
                    icc: Optional[bytes] = None) -> bytes:
    """Still lossy WebP encode from the device's YUV420 planes (the yuv420
    emit: 1.5 B/px cross D2H instead of 4 B/px of BGRA, and libwebp skips
    its import conversion). Its bytes equal encode_webp_pixels' on the
    same pixels, because ops.color.webp_yuv420_from_packed equals
    libwebp's own import. Lossless (quality > 100) needs ARGB input: the
    shim rejects it here (-3), and callers route it to
    encode_webp_pixels."""
    lib = binding.load_webp()
    o = _opts_array(opts or {})
    h, w = y.shape
    y, u, v = (np.ascontiguousarray(p) for p in (y, u, v))
    icc_arr = _icc_array(icc)
    out = np.empty(w * h * 4 + (1 << 20) + icc_arr.size, np.uint8)
    n = lib.lp_webp_encode_yuv(
        _u8(y), _u8(u), _u8(v), None, w, h, _opts_ptr(o), o.size,
        _u8(icc_arr) if icc_arr.size else None, icc_arr.size,
        _u8(out), out.size)
    if n < 0:
        raise DecodingFailedError(f"webp yuv encode failed ({n})")
    return out[:n].tobytes()


class WebpEncoder(Encoder):
    def __init__(self, decoded_by: Optional[Decoder] = None,
                 icc_override: Optional[bytes] = None):
        self._lib = binding.load_webp()
        icc = icc_override
        bg, loops = 0, 0
        if decoded_by is not None:
            if icc is None:
                try:
                    icc = decoded_by.icc() or None
                except Exception:
                    icc = None
            try:
                bg = decoded_by.background_color()
                loops = decoded_by.loop_count()
            except Exception:
                pass
        icc_arr = _icc_array(icc)
        self._h = self._lib.lp_webp_enc_new(
            _u8(icc_arr) if icc_arr.size else None, icc_arr.size,
            ctypes.c_uint32(bg & 0xFFFFFFFF), loops)
        if not self._h:
            raise DecodingFailedError("webp encoder init failed")
        self._flushed = False
        self._raw_bytes = 0  # sum of added frames' raw BGRA bytes (flush cap)

    def encode(self, fb: Optional[Framebuffer],
               opts: Dict[int, int]) -> Optional[bytes]:
        if self._flushed:
            raise EOFError()
        o = _opts_array(opts)
        if fb is None:
            # the output is bounded by the raw frame bytes plus container
            # overhead; the 64 MiB floor keeps small animations on one
            # allocation size
            cap = max(64 << 20, self._raw_bytes + (1 << 20))
            out = np.empty(cap, np.uint8)
            n = self._lib.lp_webp_enc_flush(self._h, _opts_ptr(o), o.size,
                                            _u8(out), cap)
            if n < 0:
                raise DecodingFailedError(f"webp flush failed ({n})")
            self._flushed = True
            return out[:n].tobytes()
        px = np.ascontiguousarray(fb.to_numpy())
        self._raw_bytes += fb.width * fb.height * 4
        rc = self._lib.lp_webp_enc_add(
            self._h, _u8(px), fb.width, fb.height, fb.channels,
            int(round(fb.duration * 1000)), _opts_ptr(o), o.size)
        if rc != 0:
            raise DecodingFailedError("webp frame add failed")
        return None

    def close(self) -> None:
        if self._h:
            self._lib.lp_webp_enc_free(self._h)
            self._h = None
