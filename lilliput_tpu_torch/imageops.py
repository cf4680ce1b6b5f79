"""ImageOps: the Transform orchestrator.

The counterpart of ``lilliput_tpu/imageops.py``, a behavioral port of the
reference's ops.go (sizing rules :223-235, fit/resize :150-218, Transform
loop :283-375, animated dispose/blend :431-461). Each frame's orient,
blend, resize and dispose run as torch ops on the device of the decoder's
framebuffer; no global device setting is read.
"""

from __future__ import annotations

import dataclasses
import time as _time
from typing import Dict, Optional

from .errors import EncodeTimeoutError
from .framebuffer import (BlendMethod, DisposeMethod, Framebuffer,
                          ImageHeader)
from .interfaces import Decoder, Encoder


class ResizeMethod:
    """ImageOpsSizeMethod (ops.go:10-16)."""
    NO_RESIZE = 0
    FIT = 1
    RESIZE = 2


@dataclasses.dataclass
class ImageOptions:
    """Transform knobs (ops.go:20-59). Durations are seconds."""
    file_type: str = ".jpeg"
    width: int = 0
    height: int = 0
    resize_method: int = ResizeMethod.NO_RESIZE
    normalize_orientation: bool = True
    encode_options: Dict[int, int] = dataclasses.field(default_factory=dict)
    max_encode_frames: int = 0
    max_encode_duration: float = 0.0
    encode_timeout: float = 0.0
    disable_animated_output: bool = False
    force_sdr: bool = False


def calculate_expected_size(orig_w: int, orig_h: int, req_w: int, req_h: int):
    """Sizing quirks preserved exactly (ops.go:223-235)."""
    if req_w == req_h and req_w > min(orig_w, orig_h):
        m = min(orig_w, orig_h)
        return m, m
    if req_w > orig_w and req_h > orig_h and req_w != req_h:
        return orig_w, orig_h
    return req_w, req_h


class ImageOps:
    """Reusable transform pipeline (ops.go:62-115).

    max_size bounds accepted image dimensions (the reference preallocates
    max_size^2 x4 buffers; here it is a validation limit, since torch
    allocates each frame's tensors).
    """

    def __init__(self, max_size: int = 8192):
        self.max_size = max_size
        self._composite: Optional[Framebuffer] = None

    def clear(self) -> None:
        self._composite = None

    def close(self) -> None:
        self._composite = None

    # -- animated helpers (ops.go:120-138, 431-461) --------------------------

    def _setup_animated_buffers(self, canvas_w: int, canvas_h: int,
                                has_alpha: bool, device) -> None:
        if self._composite is None:
            fb = Framebuffer()
            if has_alpha:
                fb.create_4channel(canvas_w, canvas_h, device)
            else:
                fb.create_3channel(canvas_w, canvas_h, device)
            fb.clear_to_transparent(0, 0, canvas_w, canvas_h)
            self._composite = fb

    def _apply_blend_method(self, active: Framebuffer) -> None:
        x, y, w, h = active.x_offset, active.y_offset, active.width, active.height
        if active.blend == BlendMethod.USE_ALPHA_BLENDING:
            self._composite.copy_to_offset_with_alpha_blending(active, x, y, w, h)
        else:
            self._composite.copy_to_offset_no_blend(active, x, y, w, h)

    def _apply_dispose_method(self, active: Framebuffer) -> None:
        if active.dispose == DisposeMethod.DISPOSE_TO_BACKGROUND_COLOR:
            self._composite.clear_to_transparent(
                active.x_offset, active.y_offset, active.width, active.height)

    # -- per-frame transform (ops.go:150-218, 380-398) ------------------------

    def _fit_or_resize(self, active: Framebuffer, header: ImageHeader,
                       out_w: int, out_h: int, fit: bool) -> Framebuffer:
        if header.is_animated():
            self._setup_animated_buffers(header.width, header.height,
                                         header.has_alpha(), active.device)
            self._apply_blend_method(active)
            if fit:
                new_w, new_h = calculate_expected_size(header.width, header.height, out_w, out_h)
                out = self._composite.fit(new_w, new_h)
            else:
                out = self._composite.resize_to(out_w, out_h)
            self._apply_dispose_method(active)
            out.copy_properties_from(active)
            return out
        if fit:
            new_w, new_h = calculate_expected_size(header.width, header.height, out_w, out_h)
            return active.fit(new_w, new_h)
        return active.resize_to(out_w, out_h)

    def _transform_current_frame(self, active: Framebuffer, opt: ImageOptions,
                                 header: ImageHeader) -> Framebuffer:
        if opt.resize_method == ResizeMethod.NO_RESIZE and not header.is_animated():
            return active
        out_w, out_h = opt.width, opt.height
        if opt.resize_method == ResizeMethod.NO_RESIZE:
            out_w, out_h = header.width, header.height
        if out_w <= 0 or out_h <= 0:
            # reference surfaces this as a cv::resize error from the C++
            # side (opencv.go:284-299); fail with a clear message instead
            # of a ZeroDivisionError deep in the fit math
            raise ValueError(
                f"transform dimensions must be positive, got "
                f"{out_w}x{out_h} (method={opt.resize_method})")
        fit = opt.resize_method in (ResizeMethod.FIT, ResizeMethod.NO_RESIZE)
        return self._fit_or_resize(active, header, out_w, out_h, fit)

    # -- Transform (ops.go:283-375) -------------------------------------------

    @staticmethod
    def _skip_to_end(d: Decoder) -> None:
        while True:
            try:
                d.skip_frame()
            except EOFError:
                return

    def transform(self, d: Decoder, opt: ImageOptions) -> bytes:
        """Decode -> orient -> fit/resize (+animated compositing) -> encode."""
        from .api import new_encoder  # local import avoids cycle

        try:
            header = d.header()
            if header.width > self.max_size or header.height > self.max_size:
                from .errors import BufTooSmallError
                raise BufTooSmallError(
                    f"image {header.width}x{header.height} exceeds max size {self.max_size}")
            # the reference's ResizeTo fails with ErrBufTooSmall when the
            # REQUESTED dims exceed the preallocated max_size^2 frame
            # buffers (ops.go / opencv.go) — without this a hostile
            # width=65536 request would ask the device to materialize a
            # ~17 GB array instead of raising the typed error. NO_RESIZE
            # ignores the requested dims, like the reference.
            if (opt.resize_method != ResizeMethod.NO_RESIZE
                    and (opt.width > self.max_size
                         or opt.height > self.max_size)):
                from .errors import BufTooSmallError
                raise BufTooSmallError(
                    f"requested {opt.width}x{opt.height} exceeds max size "
                    f"{self.max_size}")

            icc_override = None
            if opt.force_sdr:
                icc = d.icc()
                if icc:
                    from .codecs.icc import is_hdr_icc_profile, SRGB_PROFILE
                    if is_hdr_icc_profile(icc):
                        icc_override = SRGB_PROFILE

            enc = new_encoder(opt.file_type, d, icc_override=icc_override)
            try:
                return self._transform_loop(d, enc, opt, header)
            finally:
                enc.close()
        finally:
            self._composite = None

    def _transform_loop(self, d: Decoder, enc: Encoder, opt: ImageOptions,
                        header: ImageHeader) -> bytes:
        from .utils import StageTimer, metrics
        frame_count = 0
        duration = 0.0
        deadline = _time.monotonic() + opt.encode_timeout

        while True:
            active = Framebuffer()
            empty_frame = False
            try:
                with StageTimer("decode"):
                    d.decode_to(active)
            except EOFError:
                empty_frame = True

            duration += active.duration
            if opt.max_encode_duration and duration > opt.max_encode_duration:
                self._skip_to_end(d)
                return self._require(enc.encode(None, opt.encode_options))

            if not empty_frame:
                with StageTimer("transform"):
                    active.orientation_transform(header.orientation)
                    out = self._transform_current_frame(active, opt, header)
                with StageTimer("encode"):
                    content = enc.encode(out, opt.encode_options)
                metrics.incr("frames_transformed")
            else:
                content = enc.encode(None, opt.encode_options)

            if content is not None:
                return content

            frame_count += 1
            if opt.disable_animated_output:
                return self._require(enc.encode(None, opt.encode_options))
            if opt.max_encode_frames and frame_count == opt.max_encode_frames:
                self._skip_to_end(d)
                return self._require(enc.encode(None, opt.encode_options))
            if _time.monotonic() > deadline:
                raise EncodeTimeoutError()

    @staticmethod
    def _require(content: Optional[bytes]) -> bytes:
        if content is None:
            from .errors import LilliputError
            raise LilliputError("encoder returned no content on flush")
        return content
