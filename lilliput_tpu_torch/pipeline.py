"""Batched JPEG Fit transcode — the port's serving path — the still and
mixed-geometry serving fronts, and the animated GIF, WebP and AVIF
serving paths.

The JPEG-in half of ``lilliput_tpu/pipeline.py``: a batch of
same-geometry JPEGs (4:2:0, 4:2:2, 4:4:0, 4:4:4 or grayscale, any EXIF
orientation) to Fit-cropped JPEGs or PNGs at the destination size, in
every mode the JAX pipeline has: AREA, LINEAR or CUBIC resize, chroma_mode
"rgb" or "direct", dct_scale 1, 2 or 4, and the LILLIPUT_FUSED_EXACT tier.
Five stages:

1. Huffman decode (``decode_entropy``): upright sources into the MCU
   window around the Fit crop, oriented ones whole. On one CUDA device at
   dct_scale 1 the host parses the markers and destuffs the scans
   (csrc/host/jpeg_scan.cpp) and the card decodes the symbols
   (``ops/entropy_kernels``, the huffman_decode kernels); elsewhere, and
   for a stream that route declines or flags, the host decodes
   (jpeg_huff.cpp); dct_scale 2/4 ships only the top-left kxk
   coefficients;
2. the decode kernel (``ops/decode_kernels``, CUDA): the colour layout's
   ``decode420``, ``decode422``, ``decode440`` or ``decode444`` to three
   raster u8 planes; for grayscale, ``dequant_idct_blocks`` (oriented
   sources) or a torch matmul (upright, as the JAX package's XLA einsum);
   chroma_mode="direct" runs no kernel: its planes stay YCbCr, decoded by
   matmuls (``dequant_idct_u8``, or ``dequant_idct_scaled`` at k/8 scale);
3. EXIF orientation (``ops/orient``) and resize (``ops/resize``): upright
   AREA 4:2:0 folds the crop into the banded matrices (the JAX block
   tail), the other upright AREA layouts crop the planes and resize from
   offset 0 (the JAX packed tail), upright grayscale folds the crop like
   4:2:0; LINEAR/CUBIC crop and run the streaming fixed-point kernels;
   oriented sources are oriented, cropped and resized (grayscale and
   LINEAR/CUBIC with the streaming resize, colour AREA with the matmul
   form); the direct mode resamples each chroma plane once at its own
   resolution (general-position AREA matrices); LILLIPUT_FUSED_EXACT
   switches the AREA tails to the byte-identical sequential-tap forms;
4. JPEG output: BGR->YCbCr, 2x2 chroma downsample, fDCT and quantization
   (``ops/jpeg_kernels``; the luma fDCT alone for grayscale; the fDCT of
   the three YCbCr planes in the direct mode). PNG and WebP output: the
   resized planes packed to little-endian B, G, R, 255 int32 pixels
   (``_pack_pixels``; the direct mode colour-converts at the output size
   first); opaque lossy .webp then converts them to libwebp's exact
   YUV420 planes on the device (the "yuv420" emit,
   ``ops/color.webp_yuv420_from_packed``), 1.5 B/px to the host;
5. host encode: Huffman (``encode_entropy``, csrc/host/jpeg_enc.cpp, with
   optimal tables under optimize_coding), PNG
   row filters and deflate (``encode_pixels``, codecs/png.py), or libwebp
   (``encode_yuv``, ``encode_pixels``; codecs/webp.py, built where
   libwebp's headers exist, raising HostLibraryMissingError elsewhere).

Stages 2-4 run on the pipeline's torch device, and the host threads run
the serial stages. ``transcode_pipelined`` overlaps them: the end of each
device step queues its outputs' copies into pinned host arrays and records
a CUDA event, and the host waits on that event alone, so it encodes batch
i-1 and decodes batch i+1 while step i runs. A JPEG stream jpeg_huff.cpp
declines (a truncated upload, arithmetic coding, ...) takes the JAX
package's libjpeg route (csrc/host/jpeg_shim.cpp), which raises
HostLibraryMissingError where libjpeg is absent; nothing falls back.

Every front that takes ``mesh=`` (a ``parallel.Mesh`` of torch devices
shaped (dp, sp)) runs its device work per mesh slot, each on its own
device and CUDA stream: the JPEG and still fronts through
``parallel/serving.py``'s ShardedJpegPipeline and ShardedStillPipeline,
the animated batches over dp slices of the animation axis
(``_dp_put``). ``_fetch`` copies each slot's outputs into its rows of one
pinned host array.

Non-JPEG stills (``StillTranscodePipeline``): host decode of each source
to pixels (decoders on the CPU, threaded) into one pinned batch, one H2D
copy, then orientation, the Fit crop, the resize and the JPEG colour
encode (or the pixel pack) as torch ops on the device
(``_fused_still_fit_impl``, no kernel), then the host encode.
``MultiGeometryPipeline`` routes mixed traffic by signature to
per-signature JpegTranscodePipeline and StillTranscodePipeline instances
(an LRU), batches each group and restores the input order.

GIF (``transcode_gif``, ``transcode_gif_batch``,
``AnimatedTranscodePipeline``): host LZW decode and index scattering
(codecs/gif.py, gif_codec.cpp), then on the device the composite of every
frame (``ops.palette.composite_animation``), the Fit crop and exact AREA
resize and the whole-animation quantizer (``quantize_animation``), over a
leading animation axis for a batch of same-canvas animations, then the
host LZW encode (or, for .webp output, libwebp's animation encoder of the
resized frames); the bytes equal the streaming ImageOps transform's.
Animated WebP (``transcode_webp``, ``transcode_webp_batch``) is the same
shape: host libwebp frame decode, the alpha-blend/dispose composite
(``ops.palette.composite_animation_rgba``), crop and resize on the
device, the host animation encode. Animated AVIF (``transcode_avif``,
``transcode_avif_batch``): host dav1d decode of full-canvas frames
(codecs/avif.py over the ffmpeg shim, which raises
HostLibraryMissingError where ffmpeg is absent), one upload, crop and
resize on the device, one download, the host libaom or libwebp encode.

Video (``spritesheet``): the keyframe index and stateless raw keyframe
decodes through ffmpeg on a host thread pool into one pinned stack, then
``spritesheet_tiles`` on the device (one H2D, the AREA resize of every
keyframe, the batched thumbhash grids, one D2H), and the sheet assembled
on the host. The still fronts take a video's first frame
(codecs/video.py).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from . import binding
from .codecs import jpeg as J
from .errors import DecodingFailedError
from .ops import color as C
from .ops import entropy_kernels as E
from .ops import jpeg_kernels as K
from .ops import orient as O
from .ops import palette as P
from .ops import resize as R
from .utils import (ProfilerRange, StageClock, StageTimer, WorkerClock,
                    metrics, resolve_device)

_i16p = ctypes.POINTER(ctypes.c_int16)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_u16p = ctypes.POINTER(ctypes.c_uint16)


@dataclasses.dataclass(frozen=True)
class JpegGeometry:
    """Static shape key: one pipeline per geometry."""
    width: int
    height: int
    h2: bool          # chroma h subsampled
    v2: bool
    blocks: tuple     # ((bh, bw) per component)


def geometry_of(info) -> JpegGeometry:
    if info.num_components == 1:
        return JpegGeometry(
            width=info.width, height=info.height, h2=False, v2=False,
            blocks=((int(info.comp_blocks_h[0]),
                     int(info.comp_blocks_w[0])),))
    hy, vy = info.comp_h_samp[0], info.comp_v_samp[0]
    hc, vc = info.comp_h_samp[1], info.comp_v_samp[1]
    return JpegGeometry(
        width=info.width, height=info.height,
        h2=(hy // hc == 2), v2=(vy // vc == 2),
        blocks=tuple((int(info.comp_blocks_h[c]), int(info.comp_blocks_w[c]))
                     for c in range(3)))


def fit_rect(src_w: int, src_h: int, dst_w: int, dst_h: int):
    """Center-crop rect for Fit (opencv.go:316-353 math)."""
    aspect_in = src_w / src_h
    aspect_out = dst_w / dst_h
    if aspect_in > aspect_out:
        w = int(aspect_out * src_h + 0.5)
        h = src_h
    else:
        h = int(src_w / aspect_out + 0.5)
        w = src_w
    w, h = max(w, 1), max(h, 1)
    left = max(int((src_w - w) * 0.5), 0)
    top = max(int((src_h - h) * 0.5), 0)
    return left, top, w, h


def mcu_decode_window(src_w: int, src_h: int, dst_w: int, dst_h: int,
                      h2: bool, v2: bool, blocks, luma_rows: int):
    """MCU-aligned coefficient window covering the Fit crop plus one MCU
    margin (the chroma triangle filter's neighbor taps). Returns
    (x0, y0, rw, rh, luma_rowslice, luma_colslice, chroma_rowslice,
    chroma_colslice) in BLOCK units; decode_entropy slices on the HOST, so
    the H2D transfer and the device step carry only the window."""
    left, top, w, h = fit_rect(src_w, src_h, dst_w, dst_h)
    fx = 2 if h2 else 1
    fy = 2 if v2 else 1
    mx, my = 8 * fx, 8 * fy
    ybh, ybw = blocks[0]
    cbh, cbw = blocks[1]
    plane_w = min(ybw * 8, cbw * 8 * fx)
    plane_h = min(ybh * 8, cbh * 8 * fy)
    x0 = max((left // mx) * mx - mx, 0)
    y0 = max((top // my) * my - my, 0)
    x1 = min(((left + w + mx - 1) // mx + 1) * mx, plane_w)
    y1 = min(((top + h + my - 1) // my + 1) * my, plane_h)
    ybx0, ybx1 = x0 // 8, -(-x1 // 8)
    yby0, yby1 = y0 // 8, -(-y1 // 8)
    cbx0, cbx1 = x0 // (8 * fx), -(-x1 // (8 * fx))
    cby0, cby1 = y0 // (8 * fy), -(-y1 // (8 * fy))
    if fy == 2:
        yby1 = min(2 * cby1, luma_rows)
    return (x0, y0, x1 - x0, y1 - y0, slice(yby0, yby1), slice(ybx0, ybx1),
            slice(cby0, cby1), slice(cbx0, cbx1))


def _normalize_output_format(output_format: str,
                             allow_gif: bool = False) -> str:
    """The serving fronts' output-format check: ".jpg" is ".jpeg";
    allow_gif admits ".gif" (the mixed front's animated-only output)."""
    fmt = {".jpg": ".jpeg"}.get(output_format, output_format)
    allowed = (".jpeg", ".webp", ".png") + ((".gif",) if allow_gif else ())
    if fmt not in allowed:
        raise ValueError(f"output_format must be one of {allowed}")
    return fmt


def _oriented_fit(src_w: int, src_h: int, dst_w: int, dst_h: int,
                  orientation: int):
    """fit_rect of the upright (oriented) image: orientations 5-8 swap the
    source's width and height."""
    if O.swaps_dimensions(orientation):
        src_w, src_h = src_h, src_w
    return fit_rect(src_w, src_h, dst_w, dst_h)


_ALPHA_FF = -16777216  # 0xFF000000 as int32: the alpha byte of a pixel


def _pack_pixels(bpl, gpl, rpl) -> torch.Tensor:
    """Three (..., H, W) channel planes (u8 values, any numeric storage;
    rounded half to even and clipped) -> packed BGRA int32, whose
    little-endian bytes are B, G, R, 255: the serving pixel output (the
    JAX package's _pack_pixels)."""
    def u8(x):
        return torch.clamp(torch.round(x.to(torch.float32)), 0.0,
                           255.0).to(torch.int32)
    return u8(bpl) | (u8(gpl) << 8) | (u8(rpl) << 16) | _ALPHA_FF


def _pack_pixels_a(bpl, gpl, rpl, apl) -> torch.Tensor:
    """_pack_pixels with a real alpha plane (still sources with
    transparency keep it through .png output): the same round and clip;
    alpha << 24 wraps into the int32 sign bit, as in the JAX package."""
    def u8(x):
        return torch.clamp(torch.round(x.to(torch.float32)), 0.0,
                           255.0).to(torch.int32)
    return u8(bpl) | (u8(gpl) << 8) | (u8(rpl) << 16) | (u8(apl) << 24)


def _fused_emit(emit: str) -> str:
    """The fused tails' emit for a serving emit: "yuv420" is a pass over
    the packed pixels (_emit_post), so the tails emit "pixels" for it."""
    return "pixels" if emit == "yuv420" else emit


def _emit_post(out, emit: str):
    """The device steps' epilogue (the JAX package's emit_post): the yuv420
    emit converts the tail's packed BGRA pixels to libwebp's exact YUV420
    planes, (y, u, v); any other emit keeps the tail's tuple."""
    if emit == "yuv420":
        return C.webp_yuv420_from_packed(out[0])
    return out


def _encode_or_pack(out, enc_qt_y, enc_qt_c, emit: str):
    """The colour tails' last stage on the resized (b, g, r) planes:
    4:2:0 encode coefficients (emit="coefs"), or the packed pixels as a
    1-tuple (emit="pixels")."""
    if emit == "pixels":
        return (_pack_pixels(*out),)
    return K.encode_from_bgr_planes(out[0], out[1], out[2], enc_qt_y,
                                    enc_qt_c, subsample=True)


class _Stages(NamedTuple):
    """A JPEG device step as its three stages, each a function of the
    previous stage's output: decode() -> planes, resize(planes) -> the
    resized planes, encode(resized) -> the step's outputs. run() chains
    them, and is the step itself, each stage a profiler range
    (lilliput.device.decode, .resize, .encode) while a torch.profiler
    session records; utils.measure_device_stages times each on the
    previous one's output."""
    decode: Callable[[], object]
    resize: Callable[[object], object]
    encode: Callable[[object], tuple]

    def run(self) -> tuple:
        with ProfilerRange("device.decode"):
            planes = self.decode()
        with ProfilerRange("device.resize"):
            resized = self.resize(planes)
        with ProfilerRange("device.encode"):
            return self.encode(resized)


def _jpeg_fit_stages(yc, cb, cr, qt_y, qt_c, enc_qt_y, enc_qt_c,
                     src_w: int, src_h: int, dst_w: int, dst_h: int,
                     window, h2: bool, v2: bool, orientation: int = 1,
                     method: str = R.AREA, plain: bool = False,
                     emit: str = "coefs") -> _Stages:
    """chroma_mode="rgb" (lilliput_tpu/pipeline.py:247-318) as _Stages.

    Upright AREA (window = the host's decode window): the decode kernel
    writes raster u8 planes. 4:2:0 takes the block tail (:259-281): each
    plane's resize folds the Fit crop into its AREA matrices. 4:2:2, 4:4:0
    and 4:4:4 take the packed tail (:282-301): the planes are cropped to
    the Fit rect and resized from offset 0. Upright LINEAR/CUBIC (:302-303,
    :313-314): the layout's decode kernel writes the window's planes, which
    are cropped and resized by the streaming kernels. Other orientations
    (:304-318): the whole frame is decoded, oriented, cropped to the Fit
    rect of the upright size and resized (AREA: resize_area_mxu, or the
    exact forms under LILLIPUT_FUSED_EXACT; else the streaming kernels).
    Either way the resized planes are re-encoded at 4:2:0 (emit="coefs")
    or packed to BGRA pixels (emit="pixels", a 1-tuple); the JAX
    function's interleaved (..., H, W, 3) resize is per channel, so each
    plane gives its channel's values. plain=True decodes with the plain
    PyTorch versions of the kernels (for comparisons on the card). The
    decode stage is the decode kernel; the orientation and the crop
    belong to the resize stage."""
    def encode(out):
        return _encode_or_pack(out, enc_qt_y, enc_qt_c, emit)

    if orientation != 1:
        left, top, w, h = _oriented_fit(src_w, src_h, dst_w, dst_h,
                                        orientation)

        def resize(planes):
            crops = [O.orient_planes(p, orientation)[..., top:top + h,
                                                     left:left + w]
                     for p in planes]
            return [_resize_cropped(p, dst_w, dst_h, method) for p in crops]
        return _Stages(lambda: K.decode_ycc_420(
            yc, cb, cr, qt_y, qt_c, src_h, src_w, h2, v2, plain=plain),
            resize, encode)
    left, top, w, h = fit_rect(src_w, src_h, dst_w, dst_h)
    x0, y0, rw, rh = window
    if method != R.AREA:
        def resize(planes):
            return [_resize_cropped(p[..., top - y0:top - y0 + h,
                                      left - x0:left - x0 + w], dst_w,
                                    dst_h, method) for p in planes]
        return _Stages(lambda: K.decode_ycc_420(
            yc, cb, cr, qt_y, qt_c, rh, rw, h2, v2, plain=plain),
            resize, encode)
    if h2 and v2:
        crop = (left - x0, top - y0)

        def decode():
            return K.decode_ycc_u8_plane_blocks(yc, cb, cr, qt_y, qt_c,
                                                True, True, plain=plain)
    else:
        crop = (0, 0)

        def decode():
            planes = K.decode_ycc_planes(yc, cb, cr, qt_y, qt_c, rh, rw, h2,
                                         v2, plain=plain)
            if planes is None:
                raise DecodingFailedError(
                    f"coefficient shapes {tuple(yc.shape)}/"
                    f"{tuple(cb.shape)} do not fit chroma sampling "
                    f"h2={h2} v2={v2}")
            return [p[..., top - y0:top - y0 + h, left - x0:left - x0 + w]
                    for p in planes]

    def resize(planes):
        return [torch.clamp(torch.round(R.resize_area_plane_embedded(
            p, crop[0], w, dst_w, crop[1], h, dst_h)), 0, 255)
            for p in planes]
    return _Stages(decode, resize, encode)


def _resize_cropped(plane, dst_w: int, dst_h: int, method: str):
    """A cropped (..., h, w) u8 plane resized to f32 values: AREA through
    the fused tail's resize_area_mxu_or_exact (the JAX
    resize_area_mxu_or_exact), other methods through the streaming
    kernels, as (..., h, w, 1) images."""
    if method == R.AREA:
        return R.resize_area_mxu_or_exact_planes(plane, dst_w, dst_h).to(
            torch.float32)
    return R.resize(plane[..., None], dst_w, dst_h, method)[..., 0].to(
        torch.float32)


def _scaled_plane(coefs, qt, k: int):
    """dequant_idct_scaled's k/8-scale plane rounded and clipped to u8."""
    return torch.clamp(torch.round(K.dequant_idct_scaled(coefs, qt, k)),
                       0, 255).to(torch.uint8)


def _resize_scaled(plane, dst_w: int, dst_h: int, scale_w: float,
                   off_w: float, scale_h: float, off_h: float):
    """A (..., H, W) plane through area_axis_matrix_scaled's matrices
    (device-resident, built once per geometry), rounded and clipped."""
    dev = str(plane.device)
    return torch.clamp(torch.round(R.resize_area_plane_mat(
        plane,
        R.scaled_banded(plane.shape[-1], dst_w, scale_w, off_w, dev),
        R.scaled_banded(plane.shape[-2], dst_h, scale_h, off_h, dev))),
        0, 255)


def _jpeg_fit_ycc_stages(yc, cb, cr, qt_y, qt_c, enc_qt_y, enc_qt_c,
                         src_w: int, src_h: int, dst_w: int, dst_h: int,
                         window, dct_scale: int = 1,
                         emit: str = "coefs") -> _Stages:
    """chroma_mode="direct" (lilliput_tpu/pipeline.py:321-419, JPEG out)
    as _Stages: the planes never leave YCbCr. Luma is cropped and resized
    straight to the output grid; each chroma plane is resampled ONCE at its
    native half resolution to the output's 4:2:0 grid (general-position
    AREA matrices absorb the half-pixel crop offset); no YCbCr<->BGR,
    triangle upsample or 2x2 re-downsample. Needs 4:2:0, an upright source
    and even output dims (the constructor's gate). dct_scale 2 or 4
    decodes every plane at 1/2 or 1/4 scale from the top-left kxk
    coefficients (k = 8 // dct_scale), which the host may have cut to
    those lanes. No decode kernel runs: the IDCTs (the decode stage) are
    torch matmuls, as the JAX package's XLA dots (dequant_idct_u8,
    dequant_idct_scaled). emit="pixels" upsamples the resampled chroma to
    the output grid (the decode's triangle filter) and colour-converts
    there, to packed BGRA (a 1-tuple), with the JAX function's fused
    multiply-adds written out (jpeg_kernels.centered_ycc_to_bgr)."""
    left, top, w, h = fit_rect(src_w, src_h, dst_w, dst_h)
    x0, y0 = window[:2]
    tx, ty = left - x0, top - y0
    s = dct_scale

    def decode():
        if s == 1:
            return (K.dequant_idct_u8(yc, qt_y), K.dequant_idct_u8(cb, qt_c),
                    K.dequant_idct_u8(cr, qt_c))
        return (_scaled_plane(yc, qt_y, 8 // s),
                _scaled_plane(cb, qt_c, 8 // s),
                _scaled_plane(cr, qt_c, 8 // s))

    def resize(planes):
        y, cbp, crp = planes
        if s == 1:
            lin = dst_w > w or dst_h > h
            dev = str(y.device)
            yr = torch.clamp(torch.round(R.resize_area_plane_mat(
                y, R._embedded_banded(y.shape[-1], tx, w, dst_w, lin, dev),
                R._embedded_banded(y.shape[-2], ty, h, dst_h, lin, dev))),
                0, 255)
        else:
            yr = _resize_scaled(y, dst_w, dst_h, w / s / dst_w, tx / s,
                                h / s / dst_h, ty / s)
        return (yr,) + tuple(
            _resize_scaled(p, dst_w // 2, dst_h // 2, w / s / dst_w,
                           tx / (2 * s), h / s / dst_h, ty / (2 * s))
            for p in (cbp, crp))

    def encode(resized):
        yr, cbr, crr = resized
        if emit == "pixels":
            cbu = K.upsample_chroma(cbr, 2, 2, dst_h, dst_w) - 128.0
            cru = K.upsample_chroma(crr, 2, 2, dst_h, dst_w) - 128.0
            return (_pack_pixels(*K.centered_ycc_to_bgr(yr, cbu, cru)),)
        ph = (dst_h + 15) // 16 * 16
        pw = (dst_w + 15) // 16 * 16
        return (K.fdct_quant(K._pad_to(yr, ph, pw), enc_qt_y),
                K.fdct_quant(K._pad_to(cbr, ph // 2, pw // 2), enc_qt_c),
                K.fdct_quant(K._pad_to(crr, ph // 2, pw // 2), enc_qt_c))
    return _Stages(decode, resize, encode)


def _jpeg_fit_gray_stages(yc, qt_y, enc_qt_y, src_w: int, src_h: int,
                          dst_w: int, dst_h: int, window,
                          orientation: int = 1, method: str = R.AREA,
                          dct_scale: int = 1, plain: bool = False,
                          emit: str = "coefs") -> _Stages:
    """1-component JPEG in and out (the JAX function,
    lilliput_tpu/pipeline.py:422-478) as _Stages.

    Upright (window = the host's decode window): AREA at dct_scale 1 runs
    the IDCT with its u8 rounding as a torch matmul (dequant_idct_u8, as
    the JAX package's XLA einsum) and folds the Fit crop into the AREA
    matrices; LINEAR/CUBIC crop that u8 plane and run the streaming
    kernels; dct_scale 2/4 decodes at k/8 scale (dequant_idct_scaled) and
    resizes with area_axis_matrix_scaled's matrices. Other orientations:
    decode_gray decodes the whole frame through the dequant_idct_blocks
    kernel, then the plane is oriented, cropped to the Fit rect of the
    upright size and resized with the streaming resize of `method`.
    emit="pixels" returns the resized plane as gray BGRA pixels (a
    1-tuple). plain=True decodes with the kernel's plain PyTorch
    version."""
    s = dct_scale

    def encode(yr):
        return _gray_out(yr, enc_qt_y, dst_w, dst_h, emit)

    if orientation != 1:
        left, top, w, h = _oriented_fit(src_w, src_h, dst_w, dst_h,
                                        orientation)

        def resize(gray):
            cropped = O.orient_planes(gray, orientation)[
                ..., top:top + h, left:left + w, None]
            return R.resize(cropped, dst_w, dst_h, method)[..., 0].to(
                torch.float32)
        return _Stages(lambda: K.decode_gray(yc, qt_y, src_h, src_w, plain),
                       resize, encode)
    left, top, w, h = fit_rect(src_w, src_h, dst_w, dst_h)
    x0, y0 = window[:2] if window is not None else (0, 0)
    tx, ty = left - x0, top - y0
    if s != 1:
        return _Stages(
            lambda: _scaled_plane(yc, qt_y, 8 // s),
            lambda y: _resize_scaled(y, dst_w, dst_h, w / s / dst_w, tx / s,
                                     h / s / dst_h, ty / s), encode)
    if method != R.AREA:
        def resize(y8):
            return _resize_cropped(y8[..., ty:ty + h, tx:tx + w], dst_w,
                                   dst_h, method)
    else:
        def resize(y8):
            return torch.clamp(torch.round(R.resize_area_plane_embedded(
                y8, tx, w, dst_w, ty, h, dst_h)), 0, 255)
    return _Stages(lambda: K.dequant_idct_u8(yc, qt_y), resize, encode)


def _gray_out(yr, enc_qt_y, dst_w: int, dst_h: int, emit: str):
    """The grayscale tails' last stage on the resized (..., dst_h, dst_w)
    plane: 1-component encode coefficients (yq,), or gray BGRA pixels (a
    1-tuple) for emit="pixels"."""
    if emit == "pixels":
        return (_pack_pixels(yr, yr, yr),)
    ph = (dst_h + 7) // 8 * 8
    pw = (dst_w + 7) // 8 * 8
    return (K.fdct_quant(K._pad_to(yr, ph, pw), enc_qt_y),)


def _fused_still_fit_impl(px, enc_qt_y, enc_qt_c, src_w: int, src_h: int,
                          dst_w: int, dst_h: int, method: str = R.AREA,
                          orientation: int = 1, emit: str = "coefs"):
    """(B, H, W, C) u8 BGR(A) or gray still pixels -> quantized JPEG encode
    coefficients (emit="coefs": (yq, cbq, crq), or (yq,) for C=1) or packed
    BGRA int32 pixels at the destination size (emit="pixels", a 1-tuple):
    the JAX function (lilliput_tpu/pipeline.py:481-531), torch ops as it is
    XLA, with no kernel.

    EXIF orientation, the Fit crop of the upright size, then AREA through
    resize_area_mxu_or_exact (LILLIPUT_FUSED_EXACT switches it to the exact
    forms) or the streaming LINEAR/CUBIC kernels. C=1 encodes a
    1-component JPEG of the rounded plane; C=3 and C=4 encode at 4:2:0
    (alpha dropped); pixels keep a C=4 source's alpha."""
    if orientation != 1:
        px = O.orient(px, orientation)
    left, top, w, h = _oriented_fit(src_w, src_h, dst_w, dst_h, orientation)
    cropped = px[..., top:top + h, left:left + w, :]
    if method == R.AREA:
        resized = R.resize_area_mxu_or_exact(cropped, dst_w, dst_h)
    else:
        resized = R.resize(cropped, dst_w, dst_h, method)
    return _still_out(resized, enc_qt_y, enc_qt_c, dst_w, dst_h, emit)


def _still_out(resized, enc_qt_y, enc_qt_c, dst_w: int, dst_h: int,
               emit: str):
    """The still tail's last stage on the resized (B, dst_h, dst_w, C)
    pixels: packed pixels (emit="pixels", alpha kept for C=4), or JPEG
    encode coefficients (1-component for C=1, else 4:2:0)."""
    c = resized.shape[-1]
    chans = resized.unbind(-1)
    if emit == "pixels":
        if c == 1:
            return (_pack_pixels(chans[0], chans[0], chans[0]),)
        if c == 4:
            return (_pack_pixels_a(*chans),)
        return (_pack_pixels(*chans),)
    if c == 1:
        # 1-channel sources encode as grayscale JPEG, like the reference's
        # OpenCV encoder over a 1-channel mat
        return _gray_out(torch.clamp(torch.round(
            chans[0].to(torch.float32)), 0, 255), enc_qt_y, dst_w, dst_h,
            emit)
    return K.encode_from_bgr(resized, enc_qt_y, enc_qt_c, subsample=True)


class _Fetch(NamedTuple):
    """A device step's outputs on their way to the host: the host arrays
    (pinned on CUDA, filled once every one of `events` has completed, one
    per stream that copies; none on the CPU, where they are ready), and,
    where the batch's scans were decoded on the card, (status, bufs): the
    per-image status word copied under the same events (non-zero: the
    host decodes that stream again) and the batch's streams."""
    arrays: List[np.ndarray]
    events: tuple
    check: Optional[tuple] = None


class _SlotOutputs(NamedTuple):
    """A sharded device step's outputs, left where each mesh slot made
    them: per dp slot its output tensors, the count of its leading rows
    that are real requests (the rest pad the batch to a multiple of dp),
    and the (device, stream) its outputs were made on (stream None on the
    CPU)."""
    parts: List[tuple]
    rows: List[int]
    slots: List[tuple]

    def gather(self) -> tuple:
        """The real rows of every output in dp order, on the first slot's
        device, for use on its current stream (each slot's rows copied
        after its stream's work, the current stream waiting for the
        first slot's)."""
        from .parallel.mesh import join_slots, slot_context, to_slot
        first = self.slots[0]
        with slot_context(*first):
            out = tuple(torch.cat([
                to_slot(part[k][:r], slot, first)
                for part, r, slot in zip(self.parts, self.rows, self.slots)])
                for k in range(len(self.parts[0])))
        join_slots([first])
        if first[1] is not None:
            for t in out:
                t.record_stream(torch.cuda.current_stream(first[0]))
        return out


class _ServingPipelineBase:
    """Host-encode/orchestration stages of the serving pipelines.

    Subclasses provide `_host_decode` and `device_step` plus the attributes
    the stages read: device, dst_w/dst_h, ncomp, quality,
    enc_qt_y_np/enc_qt_c_np, output_format, encode_options, _lib, and
    `_pool` (a dict, the store of `_pooled`)."""

    @property
    def _emit(self) -> str:
        """Device-step output, from output_format: 'coefs' for JPEG output,
        'yuv420' for opaque lossy WebP output (the device converts with
        libwebp's exact import arithmetic and ships 1.5 B/px of planes to
        the host instead of 4 B/px of packed BGRA, with the same .webp
        bytes: ops.color.webp_yuv420_from_packed), else 'pixels' (packed
        BGRA int32)."""
        if self.output_format == ".jpeg":
            return "coefs"
        if self.output_format == ".webp" and self._webp_yuv_ok():
            return "yuv420"
        return "pixels"

    def _webp_yuv_ok(self) -> bool:
        """The yuv420 emit serves OPAQUE lossy WebP: alpha-keeping sources
        stay BGRA (libwebp's alpha-weighted chroma sums are another
        arithmetic), and lossless (quality > 100) needs ARGB input."""
        from .framebuffer import WEBP_QUALITY
        if self._pixel_channels(".webp") != 3:
            return False
        return int(self.encode_options.get(WEBP_QUALITY,
                                           int(self.quality))) <= 100

    def _pixel_channels(self, fmt: str) -> int:
        """Channel count the host still-encoders write for pixel outputs:
        JPEG sources decode to opaque BGR; gray sources stay 1-channel in
        PNG (libwebp takes 3 or 4 channels only)."""
        if fmt == ".webp":
            return 3
        return 1 if self.ncomp == 1 else 3

    def _host_decode(self, bufs: Sequence[bytes],
                     errors: Optional[Dict[int, Exception]] = None):
        raise NotImplementedError

    def device_step(self, *args, plain: bool = False):
        raise NotImplementedError

    # -- host buffers ---------------------------------------------------------

    def _alloc(self, shape, zeros: bool = False, pin: bool = True,
               dtype=torch.int16) -> np.ndarray:
        """Host batch array; page-locked on CUDA (unless pin is False, for
        arrays that never leave the host) so the H2D copy of a batch is
        asynchronous and overlaps the next batch's host decode."""
        make = torch.zeros if zeros else torch.empty
        return make(shape, dtype=dtype,
                    pin_memory=pin and self.device.type == "cuda").numpy()

    def _pooled(self, key, alloc):
        """Rotating 2-slot pool of pinned host arrays: decode_entropy's
        destination arrays and tables (decode_pixels' pixel batch), and
        _fetch's output arrays.

        Steady-state serving reuses the previous-but-one batch's arrays
        (fresh arrays pay first-touch page faults, and pinned ones a
        cudaHostAlloc). Two slots cover transcode_pipelined, whose batch-i
        H2D transfer may still be in flight while batch i+1 decodes; slot
        i is reused only at batch i+2, after iteration i+1 fetched batch
        i's OUTPUTS (which orders after its input transfer). Callers of
        pool=True must serialize decode_entropy (decode_pixels) calls per
        pipeline. The output arrays follow the same rule (see _fetch)."""
        slots = self._pool.get(key)
        if slots is None:
            # up to four keys per batch size on the host route (arrays,
            # lanes, tables, outputs), six on the device entropy route
            # (tables, outputs, scans, Huffman tables, segment table,
            # status); ragged tail batches: stay bounded
            if len(self._pool) >= 8:
                self._pool.pop(next(iter(self._pool)))
            self._pool[key] = slots = [[], 0]
        arrs, idx = slots
        if len(arrs) < 2:
            arrs.append(alloc())
            return arrs[-1]
        out = arrs[idx]
        slots[1] = 1 - idx
        return out

    def _pooled_grow(self, key, n: int, alloc):
        """_pooled for a 1-D array of at least n elements: alloc(size)
        makes one, and a slot whose array is too small gets one a quarter
        larger than asked for."""
        a = self._pooled(key, lambda: alloc(n))
        if a.shape[0] < n:
            arrs = self._pool[key][0]
            j = next(j for j, x in enumerate(arrs) if x is a)
            arrs[j] = a = alloc(n + n // 4)
        return a

    def _to_device(self, a, device=None) -> torch.Tensor:
        """One host array to `device` (the pipeline's by default),
        non-blocking (the pooled arrays are pinned on CUDA); a tensor
        already there passes through unchanged."""
        dev = self.device if device is None else device
        if isinstance(a, torch.Tensor):
            return a.to(dev, non_blocking=True)  # itself where it lies
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            dev, non_blocking=True)

    # -- host encode stage ----------------------------------------------------

    def encode_entropy(self, yq: np.ndarray, cbq: Optional[np.ndarray] = None,
                       crq: Optional[np.ndarray] = None,
                       workers: Optional[int] = None,
                       iccs: Optional[Sequence[bytes]] = None) -> List[bytes]:
        """Huffman-encode device-quantized coefficients (host, threaded).

        Color pipelines take (yq, cbq, crq); grayscale just (yq,). The
        encoder releases the GIL (ctypes), so encode scales across host
        cores; each worker thread owns its output buffer. iccs: per-image ICC
        profiles to embed, so colour profiles survive the transcode. The
        workers' summed wall and CPU time go to the caller's open span
        (utils.WorkerClock)."""
        w, h = self.dst_w, self.dst_h
        yb = ((h + 7) // 8, (w + 7) // 8)
        cbb = ((h + 15) // 16, (w + 15) // 16)
        gray = self.ncomp == 1
        b = yq.shape[0]
        outs: List[Optional[bytes]] = [None] * b
        hs = vs = [1] if gray else [2, 1, 1]
        opt = 1 if self.optimize_coding else 0
        cap = w * h * 4 + (1 << 20)
        if iccs is not None:
            cap += max((len(p or b"") for p in iccs), default=0) + (1 << 12)

        tls = threading.local()

        def one(i: int):
            out_buf = getattr(tls, "buf", None)
            if out_buf is None:
                out_buf = tls.buf = np.empty(cap, np.uint8)
            comps = [np.ascontiguousarray(yq[i][:yb[0], :yb[1]])]
            if not gray:
                comps += [np.ascontiguousarray(a[i][:cbb[0], :cbb[1]])
                          for a in (cbq, crq)]
            # as lilliput_tpu/pipeline.py asks libjpeg: baseline scan,
            # optimal tables with optimize_coding
            outs[i] = J.encode_coefs(
                w, h, comps, hs, vs, self.enc_qt_y_np, self.enc_qt_c_np,
                optimize=opt, icc=(iccs[i] if iccs is not None else b"")
                or b"", out=out_buf)

        _timed_tmap(one, b, workers)
        return outs  # type: ignore[return-value]

    def _webp_options(self) -> dict:
        from .framebuffer import WEBP_QUALITY
        o = dict(self.encode_options)
        o.setdefault(WEBP_QUALITY, int(self.quality))
        return o

    def encode_pixels(self, packed: np.ndarray,
                      iccs: Optional[Sequence[bytes]] = None,
                      workers: Optional[int] = None) -> List[bytes]:
        """Host still-encode stage for .png and .webp output.

        packed: (B, dst_h, dst_w) int32 BGRA from device_step (little-
        endian byte 0 = B). Threaded like encode_entropy (libwebp, zlib and
        the row filter release the GIL); _pixel_channels decides how many
        of the bytes are written. PNG_COMPRESSION of encode_options sets
        the PNG level (6 by default); .webp takes encode_options with
        WEBP_QUALITY defaulting to the pipeline's quality."""
        from .codecs.png import encode_png_pixels
        from .codecs.webp import encode_webp_pixels
        from .framebuffer import PNG_COMPRESSION
        b = packed.shape[0]
        bgra = np.ascontiguousarray(packed).view(np.uint8).reshape(
            b, self.dst_h, self.dst_w, 4)
        outs: List[Optional[bytes]] = [None] * b
        fmt = self.output_format
        ch = self._pixel_channels(fmt)
        level = int(self.encode_options.get(PNG_COMPRESSION, 6))
        webp_opts = self._webp_options()

        def one(i: int):
            icc = (iccs[i] if iccs is not None else b"") or None
            px = np.ascontiguousarray(bgra[i][:, :, :ch])
            if fmt == ".webp":
                outs[i] = encode_webp_pixels(px, webp_opts, icc)
            else:
                outs[i] = encode_png_pixels(px, level, icc)

        _timed_tmap(one, b, workers)
        return outs  # type: ignore[return-value]

    def encode_yuv(self, y: np.ndarray, u: np.ndarray, v: np.ndarray,
                   iccs: Optional[Sequence[bytes]] = None,
                   workers: Optional[int] = None) -> List[bytes]:
        """Host still-encode stage of the yuv420 emit: libwebp encodes
        straight from the device's planes (the same bytes as the BGRA
        route, see _emit). Threaded like encode_pixels."""
        from .codecs.webp import encode_webp_yuv
        b = y.shape[0]
        outs: List[Optional[bytes]] = [None] * b
        opts = self._webp_options()

        def one(i: int):
            icc = (iccs[i] if iccs is not None else b"") or None
            outs[i] = encode_webp_yuv(y[i], u[i], v[i], opts, icc)

        _timed_tmap(one, b, workers)
        return outs  # type: ignore[return-value]

    def _encode_outputs(self, arrs: Sequence[np.ndarray],
                        iccs: Optional[Sequence[bytes]]) -> List[bytes]:
        """Dispatch the host encode stage by output format."""
        if self.output_format == ".jpeg":
            return self.encode_entropy(*arrs, iccs=iccs)
        if self.output_format == ".webp" and len(arrs) == 3:
            return self.encode_yuv(*arrs, iccs=iccs)  # yuv420 emit
        return self.encode_pixels(arrs[0], iccs=iccs)

    # -- end to end -----------------------------------------------------------

    @staticmethod
    def _resolve_errors(out: List[bytes], errors: Dict[int, Exception],
                        return_exceptions: bool) -> List[bytes]:
        """Apply the serving-front failure contract: failed items are
        counted in Metrics, then either attached to their own slots
        (return_exceptions=True) or the first one re-raises after healthy
        items finished — one corrupt buffer never fails its co-batched
        requests' work."""
        if not errors:
            return out
        metrics.incr("serving.poison_isolated", len(errors))
        if not return_exceptions:
            raise errors[min(errors)]
        for i, e in errors.items():
            out[i] = e  # type: ignore[assignment]
        return out

    def _fetch(self, dev, check: Optional[tuple] = None) -> _Fetch:
        """Queue the copies of a device step's outputs to the host.

        On CUDA: non-blocking copies into pinned host arrays from a 2-slot
        pool keyed by shape and dtype (_pooled), then an event recorded
        after them on the stream. Slot i is rewritten by batch i+2's copy,
        which transcode_pipelined queues only after batch i's outputs were
        encoded. On the CPU the outputs already are host memory.

        check: the device entropy route's (status, bufs) of the batch
        (_entropy_check); its status tensor is copied with the outputs,
        before the event.

        A sharded step's _SlotOutputs: each slot's real rows are copied on
        its own stream into its rows of one pooled pinned array per output,
        and each slot's stream records its own event."""
        if isinstance(dev, _SlotOutputs):
            return self._fetch_slots(dev)
        if self.device.type != "cuda":
            return _Fetch([t.numpy() for t in dev], (), check and (
                check[0].numpy(), check[1]))
        key = ("out",) + tuple((tuple(t.shape), t.dtype) for t in dev)
        host = self._pooled(key, lambda: tuple(
            torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in dev))
        for h, t in zip(host, dev):
            h.copy_(t, non_blocking=True)
        if check is not None:
            status, bufs = check
            sh = self._pooled(("status", len(bufs)), lambda: torch.empty(
                status.shape, dtype=status.dtype, pin_memory=True))
            sh.copy_(status, non_blocking=True)
            check = (sh.numpy(), bufs)
        event = torch.cuda.Event()
        event.record()
        return _Fetch([h.numpy() for h in host], (event,), check)

    def _fetch_slots(self, dev: _SlotOutputs) -> _Fetch:
        from .parallel.mesh import slot_context
        n = sum(dev.rows)
        first = dev.parts[0]
        if self.device.type != "cuda":
            return _Fetch([torch.cat([p[k][:r] for p, r in zip(
                dev.parts, dev.rows)]).numpy() for k in range(len(first))],
                ())
        key = ("out", n) + tuple((tuple(t.shape[1:]), t.dtype)
                                 for t in first)
        host = self._pooled(key, lambda: tuple(
            torch.empty((n,) + tuple(t.shape[1:]), dtype=t.dtype,
                        pin_memory=True) for t in first))
        events, a = [], 0
        for part, r, slot in zip(dev.parts, dev.rows, dev.slots):
            if r:
                with slot_context(*slot):
                    for h, t in zip(host, part):
                        h[a:a + r].copy_(t[:r], non_blocking=True)
                    events.append(torch.cuda.Event())
                    events[-1].record()
            a += r
        return _Fetch([h.numpy() for h in host], tuple(events))

    @staticmethod
    def _to_host(fetch: _Fetch) -> List[np.ndarray]:
        """The fetched outputs as host arrays: waits on the fetch's events
        alone, never on a stream (so work queued after them runs on)."""
        for event in fetch.events:
            event.synchronize()
        return fetch.arrays

    def _decode(self, bufs: Sequence[bytes], batch: int,
                errors: Dict[int, Exception]):
        """_host_decode as the batch's "decode" span (reservoir
        entropy_decode), which counts the images and the decode workers'
        time (failures are counted by _resolve_errors), and the decode's
        check for _fetch (_entropy_check)."""
        with _batch_span("decode", batch, "entropy_decode") as span:
            args, iccs = self._host_decode(bufs, errors)
            span.add(images=len(bufs))
        return args, iccs, self._entropy_check()

    def _entropy_check(self) -> Optional[tuple]:
        """(status, bufs) of the last _host_decode where the card decoded
        its scans, else None (taken once)."""
        return None

    def _redo_flagged(self, fetch: _Fetch, out: List[bytes],
                      errors: Dict[int, Exception]) -> None:
        """Each stream the card flagged (fetch.check), transcoded again
        alone by the host route: its slot gets today's bytes, or today's
        error in errors (counter serving.device_entropy_redo)."""
        if fetch.check is None:
            return
        status, bufs = fetch.check
        flagged = np.flatnonzero(status)
        if not len(flagged):
            return
        metrics.incr("serving.device_entropy_redo", len(flagged))
        for i in flagged:
            errs: Dict[int, Exception] = {}
            args, iccs = self._host_decode([bufs[i]], errs, host=True)
            if errs:
                errors[int(i)] = errs[0]
                continue
            arrs = self._to_host(self._fetch(self.device_step(*args)))
            out[i] = self._encode_outputs(arrs, iccs)[0]

    def _encode(self, arrs: Sequence[np.ndarray], iccs,
                batch: int) -> List[bytes]:
        """_encode_outputs as the batch's "encode" span, which counts the
        images and the encode workers' time."""
        with _batch_span("encode", batch) as span:
            out = self._encode_outputs(arrs, iccs)
            span.add(images=len(out))
        return out

    def transcode(self, bufs: Sequence[bytes],
                  return_exceptions: bool = False,
                  stage_times: Optional[Dict[str, List[float]]] = None
                  ) -> List[bytes]:
        """Transcode a batch. Per-item decode failures are ISOLATED: a
        corrupt buffer cannot fail its healthy co-batched requests (its
        lane is zero-filled through the device step and its output
        discarded). With return_exceptions=True the failing items' slots
        hold the exception objects; with the default False the first
        failure re-raises after healthy items finish.

        The batch is a "batch" span with the children "decode",
        "dispatch" (device_step and the queued output copies),
        "wait_outputs" and "encode" (utils.StageTimer; the reservoirs
        entropy_decode, dispatch, wait_outputs and encode, and device for
        dispatch and wait together).

        stage_times, when a dict, gets the ms of "host_decode",
        "device_step" (CUDA events on a CUDA device, waited for) and
        "encode" appended under their names (see utils.StageClock)."""
        errors: Dict[int, Exception] = {}
        clock = StageClock(stage_times, self.device)
        b = metrics.new_batch()
        with StageTimer("batch", batch=b):
            with clock("host_decode"):
                args, iccs, check = self._decode(bufs, b, errors)
            with _batch_span("dispatch", b) as dispatch:
                with clock("device_step", device=True):
                    dev = self.device_step(*args)
                fetch = self._fetch(dev, check)
            with _batch_span("wait_outputs", b) as wait:
                arrs = self._to_host(fetch)
            metrics.observe("device", dispatch.seconds + wait.seconds)
            with clock("encode"):
                out = self._encode(arrs, iccs, b)
                self._redo_flagged(fetch, out, errors)
        metrics.incr("images_transcoded", len(bufs) - len(errors))
        return self._resolve_errors(out, errors, return_exceptions)

    def transcode_pipelined(self, batches: Sequence[Sequence[bytes]],
                            return_exceptions: bool = False
                            ) -> List[List[bytes]]:
        """Double-buffered: batch i's device step and its output copies are
        queued (CUDA runs them asynchronously), then the host encodes batch
        i-1, waiting only on batch i-1's event, and decodes batch i+1 while
        step i runs. Failure isolation matches transcode(): per-item within
        each batch. Each batch is a "batch" span from its decode to its
        encode, with transcode()'s children."""
        results = []
        pending = None  # (batch span, fetch, ICC profiles, per-item errors)

        def finish(span, fetch, iccs, errors):
            with _batch_span("wait_outputs", span.batch):
                arrs = self._to_host(fetch)
            out = self._encode(arrs, iccs, span.batch)
            self._redo_flagged(fetch, out, errors)
            span.stop()
            metrics.incr("images_transcoded", len(out) - len(errors))
            results.append(self._resolve_errors(out, errors,
                                                return_exceptions))
        for bufs in batches:
            span = StageTimer("batch", batch=metrics.new_batch()).start()
            errors: Dict[int, Exception] = {}
            args, iccs, check = self._decode(bufs, span.batch, errors)
            with _batch_span("dispatch", span.batch):
                fetch = self._fetch(self.device_step(*args), check)
            if pending is not None:
                finish(*pending)
            pending = (span, fetch, iccs, errors)
        if pending is not None:
            finish(*pending)
        return results


def _batch_span(name: str, batch: int,
                stage: Optional[str] = None) -> StageTimer:
    """A span of a served batch, under its "batch" span."""
    return StageTimer(name, batch=batch, parent="batch", stage=stage)


class JpegTranscodePipeline(_ServingPipelineBase):
    """Batched JPEG Fit transcoder for a fixed source geometry: 4:2:0,
    4:2:2, 4:4:0, 4:4:4 or grayscale, at one EXIF orientation.

    Usage:
        pipe = JpegTranscodePipeline(sample_jpeg_bytes, 256, 256, quality=85)
        outs = pipe.transcode(list_of_jpeg_bytes)   # same geometry as sample

    Modes, as in the JAX package: method AREA (default), "linear" or
    "cubic"; chroma_mode "rgb" (default) or "direct" (YCbCr-domain: 4:2:0,
    upright, AREA, even output dims; grayscale falls back to "rgb");
    dct_scale 2 or 4 with "direct" (a reduced decode from the top-left kxk
    coefficients, which the host alone ships). output_format ".jpeg" (the
    device re-encodes to quantized coefficients, the host Huffman-codes
    them), ".png" (the device emits packed BGRA pixels at the
    destination size, the host filters and deflates them; encode_options
    may set PNG_COMPRESSION) or ".webp" (lossy: the device emits libwebp's
    YUV420 planes, the host encodes them; lossless, WEBP_QUALITY > 100:
    BGRA pixels; the host encode raises HostLibraryMissingError where
    libwebp is absent, the construction and the device step need none).
    optimize_coding=True codes JPEG output with optimal Huffman tables (the
    port's jpeg_enc.cpp, libjpeg's bytes).

    device: the torch device of the dense stages, "cuda" by default; the
    CPU runs only when asked for (device="cpu"), with the decode kernels'
    plain versions. Grayscale sources give 1-component JPEGs. Source ICC
    profiles are carried into every output.

    On one CUDA device with dct_scale 1 the serving fronts decode the
    baseline scans on the card (decode_entropy's device route, the
    huffman_decode kernels); other streams, and every other pipeline, take
    the host route."""

    #: the serving fronts may take decode_entropy's device route
    _device_entropy = True

    def __init__(self, sample: bytes, dst_w: int, dst_h: int,
                 quality: int = 85, method: str = R.AREA,
                 optimize_coding: bool = False, chroma_mode: str = "rgb",
                 dct_scale: int = 1, output_format: str = ".jpeg",
                 encode_options: Optional[dict] = None,
                 device="cuda"):
        if chroma_mode not in ("rgb", "direct"):
            raise ValueError("chroma_mode must be 'rgb' or 'direct'")
        if dct_scale not in (1, 2, 4):
            raise ValueError("dct_scale must be 1, 2 or 4")
        fmt = _normalize_output_format(output_format)
        if dct_scale != 1 and chroma_mode != "direct":
            raise ValueError("dct_scale needs chroma_mode='direct'")
        if dct_scale != 1 and method != R.AREA:
            # the reduced decode's fractional crop geometry has only an
            # AREA-matrix form (grayscale's coercion below must not slip
            # past it)
            raise ValueError("dct_scale>1 requires method=AREA")
        self.device = resolve_device(device)
        self.encode_options = dict(encode_options or {})
        self._lib = binding.load()
        self._pool: dict = {}
        self._decode_pools: dict = {}
        self.dst_w, self.dst_h = dst_w, dst_h
        self.method = method
        self.optimize_coding = optimize_coding
        self.output_format = fmt
        self.chroma_mode = chroma_mode
        self.dct_scale = dct_scale
        info = J.read_info(sample)
        if info.num_components not in (1, 3):
            raise DecodingFailedError(
                "pipeline expects color or grayscale JPEGs")
        if info.num_components == 3:
            if not J.supported_subsampling(info):
                raise DecodingFailedError("unsupported chroma subsampling")
            if info.jpeg_color_space != J.JCS_YCBCR:
                raise DecodingFailedError(
                    "non-YCbCr 3-component JPEG (JCS_RGB): use the "
                    "streaming ImageOps path for this source")
            if info.comp_quant_tbl[2] != info.comp_quant_tbl[1]:
                raise DecodingFailedError(
                    "distinct Cb/Cr quant tables: use the streaming "
                    "ImageOps path for this source")
        self.ncomp = int(info.num_components)
        if self.ncomp == 1 and chroma_mode == "direct":
            # grayscale has no chroma: the luma-only path is its one mode
            self.chroma_mode = chroma_mode = "rgb"
        self.geom = geometry_of(info)
        g = self.geom
        self.orientation = int(J.exif_orientation(sample))
        if dct_scale != 1 and self.orientation != 1:
            # the truncated kxk coefficients cannot rebuild the full-size
            # pixels the orientation path decodes
            raise DecodingFailedError(
                "dct_scale>1 requires upright (orientation 1) sources")
        if self.chroma_mode == "direct" and not self._direct_ok():
            raise DecodingFailedError(
                "chroma_mode='direct' needs 4:2:0, upright orientation, "
                "AREA method, and even output dims")
        # host-side decode window of upright sources: coefficients outside
        # the MCU-aligned crop window never leave the host. Vertically
        # subsampled layouts take whole MCU rows of luma (the zero pad row
        # is the decoder's). Other orientations ship the whole frame.
        ybh = g.blocks[0][0]
        if self.orientation == 1:
            color = self.ncomp == 3
            self._window = mcu_decode_window(
                g.width, g.height, dst_w, dst_h, g.h2, g.v2,
                g.blocks if color else (g.blocks[0], g.blocks[0]),
                ybh + (ybh % 2) if color and g.v2 else ybh)
        else:
            self._window = None
        #: (x0, y0, rw, rh) of the window's plane origin and size; None
        #: when decode_entropy returns whole frames
        self.window_static = self._window[:4] if self._window else None
        #: the frame as the device entropy route decodes it: the sample's
        #: sampling factors (a stream with others takes the host route)
        #: and each component's store window
        self._samp = tuple((int(info.comp_h_samp[c]), int(info.comp_v_samp[c]))
                           for c in range(self.ncomp))
        self._scan_geom = E.scan_geometry(
            g.width, g.height, self._samp,
            [(0, 0) + s for s in self._lane_shapes()] if self._window is None
            else self._window_rows())
        self._check: Optional[tuple] = None
        self.quality = quality
        eql, eqc = J.scaled_qtables(quality)
        self.enc_qt_y_np, self.enc_qt_c_np = eql, eqc
        self.enc_qt_y = torch.from_numpy(eql.astype(np.float32)).to(self.device)
        self.enc_qt_c = torch.from_numpy(eqc.astype(np.float32)).to(self.device)

    @staticmethod
    def direct_eligible(geom, orientation: int, dst_w: int, dst_h: int,
                        method: str) -> bool:
        """chroma_mode='direct' preconditions: 4:2:0, upright, even output
        dims, AREA."""
        return (geom.h2 and geom.v2 and orientation == 1
                and dst_w % 2 == 0 and dst_h % 2 == 0
                and method == R.AREA)

    def _direct_ok(self) -> bool:
        return self.direct_eligible(self.geom, self.orientation,
                                    self.dst_w, self.dst_h, self.method)

    # -- host entropy stages --------------------------------------------------

    def _validate_header(self, buf: bytes) -> J._JpegInfo:
        """Header-only parse + geometry/orientation gate. Every buffer is
        validated BEFORE the coefficient decode: the decoder writes by the
        image's own block counts, so an unchecked larger image would
        overrun the batch arrays."""
        info = J.read_info(buf)
        if info.num_components != self.ncomp:
            raise DecodingFailedError(
                f"component-count mismatch: pipeline built for "
                f"{self.ncomp}-component JPEGs, got {info.num_components}")
        if geometry_of(info) != self.geom:
            raise DecodingFailedError(
                f"geometry mismatch: pipeline built for {self.geom}, "
                f"got {geometry_of(info)}")
        if self.ncomp == 3:
            if info.comp_quant_tbl[2] != info.comp_quant_tbl[1]:
                raise DecodingFailedError(
                    "distinct Cb/Cr quant tables: use the streaming "
                    "ImageOps path for this source")
            if info.jpeg_color_space != J.JCS_YCBCR:
                raise DecodingFailedError(
                    "non-YCbCr 3-component JPEG (JCS_RGB): use the "
                    "streaming ImageOps path for this source")
            if not J.supported_subsampling(info):
                raise DecodingFailedError(
                    "unsupported chroma subsampling: use the streaming "
                    "ImageOps path for this source")
        o = int(J.exif_orientation(buf))
        if o != self.orientation:
            raise DecodingFailedError(
                f"EXIF orientation mismatch: pipeline expects "
                f"{self.orientation}, got {o}")
        return info

    def _decode_workers(self, n: int):
        """The decode stage's n worker threads, kept across batches (a
        ThreadPoolExecutor per pipeline and size; its threads exit with
        the pipeline): starting 8 threads a batch costs more than the
        device route's host work on the card's host."""
        if n <= 1:
            return None
        ex = self._decode_pools.get(n)
        if ex is None:
            from concurrent.futures import ThreadPoolExecutor
            ex = self._decode_pools[n] = ThreadPoolExecutor(
                n, thread_name_prefix="lilliput-decode")
        return ex

    def _lane_shapes(self) -> List[tuple]:
        """(rows, cols) of blocks of each component's lane in the arrays
        decode_entropy returns at dct_scale 1: the MCU window of upright
        sources, whole frames otherwise (vertically subsampled colour
        luma rounded up to whole MCU rows)."""
        g = self.geom
        if self._window is not None:
            _, _, _, _, yr, ycs, crr, ccs = self._window
            c = (crr.stop - crr.start, ccs.stop - ccs.start)
            return [(yr.stop - yr.start, ycs.stop - ycs.start)] + \
                [c] * (self.ncomp - 1)
        ybh, ybw = g.blocks[0]
        ypad = ybh % 2 if (self.ncomp == 3 and g.v2) else 0
        return [(ybh + ypad, ybw)] + list(g.blocks[1:self.ncomp])

    def _window_rows(self) -> List[tuple]:
        """Each component's window as {y0, x0, h, w} block rows (the win
        argument of lp_jpeg_decode_coefs_win and jpeg_scan.cpp)."""
        _, _, _, _, yr, ycs, crr, ccs = self._window
        return ([(yr.start, ycs.start, yr.stop - yr.start,
                  ycs.stop - ycs.start)] +
                [(crr.start, ccs.start, crr.stop - crr.start,
                  ccs.stop - ccs.start)] * (self.ncomp - 1))

    def _host_lane(self, arr: np.ndarray, info, lane: Sequence[np.ndarray],
                   qtables: np.ndarray, intra: int, win_p, scratch) -> None:
        """The host route of one stream into its lane (one (h, w, 64)
        int16 array per component): jpeg_huff.cpp, or, where it declines,
        libjpeg (into full-geometry scratch() in window mode, the window
        copied out)."""
        rc = -10
        if J.use_fast_huff():
            ptrs = (_i16p * len(lane))(*[a.ctypes.data_as(_i16p)
                                         for a in lane])
            rc = self._lib.lp_jpeg_decode_coefs_win(
                arr.ctypes.data_as(_u8p), arr.size, ptrs,
                qtables.ctypes.data_as(_u16p), intra, win_p)
        if rc != 0:
            win = self._window
            comps = list(lane) if win is None else scratch()
            J.libjpeg_decode_coefs(arr, comps, qtables, info, intra)
            if win is not None:
                _, _, _, _, yr, ycs, crr, ccs = win
                lane[0][...] = comps[0][yr, ycs]
                for a, c in zip(lane[1:], comps[1:]):
                    a[...] = c[crr, ccs]

    def decode_entropy(self, bufs: Sequence[bytes],
                       workers: Optional[int] = None, pool: bool = False,
                       errors: Optional[Dict[int, Exception]] = None,
                       device=None):
        """Huffman-decode a batch: upright sources into the MCU window
        around the Fit crop, other orientations whole.

        Returns (ys, cbs, crs, qt_y, qt_c) with qt_* of shape (B, 64), f32
        (pinned on CUDA, as the coefficients, so their upload cannot order
        the host behind the stream): each image is dequantized with its OWN
        tables on device. Grayscale pipelines return (ys, qt_y). pool=True
        reuses the previous-but-one batch's destination arrays (see
        _pooled); direct callers that hold returned arrays across calls
        must keep pool=False.

        Whole frames of vertically subsampled colour layouts carry luma
        rounded up to whole MCU rows: the pad row is zeros, nothing writes
        it, and pooled reuse keeps it zero.

        dct_scale 2 or 4 returns only the k*k lanes the scaled IDCT reads
        (jpeg_kernels.scaled_coef_indices(8 // dct_scale), the top-left kxk
        of each block), copied into pinned arrays of their own pool
        (pool=True) for the H2D; the full arrays the decoder writes stay
        on the host, unpinned.

        errors: when a dict, per-item failures are ISOLATED: a corrupt
        buffer's exception lands in errors[i] and its lane is zero-filled
        (coefficients AND qtables, so pooled reuse cannot leak a previous
        request's data) instead of failing the whole batch. errors=None
        raises on the first bad buffer.

        The decoder is jpeg_huff.cpp (bit-identical to libjpeg for the
        streams it accepts), straight into the window. A stream it declines
        (truncated scans, arithmetic coding, non-interleaved baseline scans,
        ...), and every stream under LILLIPUT_JPEG_HUFF=libjpeg, takes the
        JAX package's libjpeg route (csrc/host/jpeg_shim.cpp): the
        restart-marker slicer when intra > 1 and the stream has a DRI and
        is not progressive, then the serial decode, into full-geometry
        per-thread scratch in window mode, the window copied out. Where
        libjpeg is absent that route raises HostLibraryMissingError
        (binding.load_jpeg), in the item's slot under errors=.

        device: None (the default) decodes on the host as above and
        returns host arrays. A device (dct_scale 1 only) takes the device
        route, _decode_entropy_device: the same five (two) arrays as
        tensors on that device, of the same shapes and dtypes (on the CPU
        through the kernels' plain version, which only tests ask for)."""
        g = self.geom
        b = len(bufs)
        gray = self.ncomp == 1
        win = self._window
        shapes = self._lane_shapes()
        win_p = None
        if win is not None:
            # per-component block windows {y0, x0, h, w} for
            # lp_jpeg_decode_coefs_win, which decodes straight into them
            win_c = np.zeros((4, 4), np.int32)
            win_c[:self.ncomp] = self._window_rows()
            win_p = win_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        n_workers = workers if workers is not None else min(8, os.cpu_count() or 1)
        # small batches underfill the pool: split each image's scan at its
        # restart markers across the idle threads (byte-identical output)
        intra = max(1, n_workers // max(b, 1)) if b < n_workers else 1
        tls = threading.local()

        def scratch():
            # the libjpeg route's full-geometry arrays in window mode, one
            # set per thread; luma zeros for the MCU pad row nothing writes
            s = getattr(tls, "s", None)
            if s is None:
                ybh, ybw = g.blocks[0]
                ypad = ybh % 2 if (not gray and g.v2) else 0
                s = (np.zeros((ybh + ypad, ybw, 64), np.int16),) + tuple(
                    np.empty(bl + (64,), np.int16) for bl in g.blocks[1:])
                tls.s = s
            return s

        def _alloc_tables():
            return tuple(self._alloc((b, 64), dtype=torch.float32)
                         for _ in range(1 if gray else 2))
        tables = (self._pooled((b, "qt"), _alloc_tables) if pool
                  else _alloc_tables())
        qty, qtc = tables if not gray else (tables[0], None)
        if device is not None:
            return self._decode_entropy_device(
                bufs, resolve_device(device), n_workers, intra, win_p,
                scratch, tables, pool, errors)

        pin = self.dct_scale == 1  # truncated lanes are shipped instead

        def _alloc_arrays():
            # whole frames: zeros for the luma pad row nothing writes
            return tuple(self._alloc((b,) + sh + (64,),
                                     zeros=win is None and c == 0, pin=pin)
                         for c, sh in enumerate(shapes))

        arrs = (self._pooled((b, "win" if win else "full"), _alloc_arrays)
                if pool else _alloc_arrays())
        k = 8 // self.dct_scale
        if k < 8:
            # the k*k lanes the scaled IDCT reads, copied out per image by
            # the decode threads into pinned arrays of their own pool: the
            # 2-slot ordering argument of _pooled holds for them as for the
            # full arrays, and a failed item's lane is zeroed in both
            def _alloc_lanes():
                return tuple(self._alloc(a.shape[:-1] + (k * k,))
                             for a in arrs)
            outs = (self._pooled((b, "lanes"), _alloc_lanes) if pool
                    else _alloc_lanes())
        else:
            outs = arrs

        def one(i: int):
            info = self._validate_header(bufs[i])
            qtables = np.zeros((4, 64), np.uint16)
            self._host_lane(np.frombuffer(bufs[i], np.uint8), info,
                            [a[i] for a in arrs], qtables, intra, win_p,
                            scratch)
            qty[i] = qtables[info.comp_quant_tbl[0]]
            if not gray:
                qtc[i] = qtables[info.comp_quant_tbl[1]]
            if outs is not arrs:
                for a, o in zip(arrs, outs):
                    o[i].reshape(o.shape[1:-1] + (k, k))[...] = a[i].reshape(
                        a.shape[1:-1] + (8, 8))[..., :k, :k]

        if errors is not None:
            decode_one = one

            def one(i: int):
                try:
                    decode_one(i)
                except Exception as e:  # noqa: BLE001 — isolate per item
                    errors[i] = e
                    for a in arrs + outs:  # benign all-zero lane; also
                        a[i] = 0           # wipes pooled previous data
                    qty[i] = 0
                    if not gray:
                        qtc[i] = 0

        _timed_tmap(one, b, n_workers, self._decode_workers(n_workers))
        if gray:
            return outs[0], qty
        return (*outs, qty, qtc)

    def _decode_entropy_device(self, bufs, dev, n_workers, intra, win_p,
                               scratch, tables, pool, errors):
        """decode_entropy's device route. On the decode workers each
        stream's markers are parsed and its scan destuffed
        (csrc/host/jpeg_scan.cpp) into the batch's pinned scan buffer,
        with its Huffman and quantization tables; a stream jpeg_scan.cpp
        declines, or with other sampling factors than the sample's, is
        decoded by the host route (_host_lane) into pinned lane arrays.
        Then one ordinary pinned copy each of the scans, the Huffman
        tables, the segment table and the quantization tables, the
        zero-filled destination arrays, the huffman_decode kernels, and
        the copies of the host-decoded lanes into theirs. The per-image
        status word goes to _entropy_check, for _fetch to copy back with
        the step's outputs. The decode span counts device_entropy (lanes
        the card decodes) and host_entropy (lanes the host route
        decoded)."""
        if self.dct_scale != 1:
            raise ValueError("the device entropy route needs dct_scale 1")
        geom = self._scan_geom
        b = len(bufs)
        gray = self.ncomp == 1
        qty, qtc = tables if not gray else (tables[0], None)
        caps = [E.scan_capacity(len(buf), geom.nmcu) for buf in bufs]
        offsets = np.zeros(b + 1, np.int64)
        np.cumsum(caps, out=offsets[1:])

        def pinned(dtype):
            return lambda n: self._alloc((n,), pin=True, dtype=dtype)
        scan = (self._pooled_grow((b, "scan"), int(offsets[-1]),
                                  pinned(torch.uint8)) if pool
                else pinned(torch.uint8)(int(offsets[-1])))
        hshape = (b, 2 * self.ncomp, E.TABLE_BYTES)
        huff = (self._pooled((b, "huff"), lambda: self._alloc(
            hshape, dtype=torch.uint8)) if pool
            else self._alloc(hshape, dtype=torch.uint8))
        shapes = self._lane_shapes()
        samp = np.array(self._samp, np.int32).ravel()
        streams: List[Optional[tuple]] = [None] * b
        used = np.zeros(b, np.int64)
        host_lanes: Dict[int, tuple] = {}
        tls = threading.local()

        def one(i: int):
            info = self._validate_header(bufs[i])
            arr = np.frombuffer(bufs[i], np.uint8)
            qtables = np.zeros((4, 64), np.uint16)
            row = None
            if J.use_fast_huff():
                segs = getattr(tls, "segs", None)
                if segs is None:
                    segs = tls.segs = np.empty((geom.nmcu, 2), np.int32)
                row = E.prepare_stream(
                    self._lib, arr, scan[offsets[i]:offsets[i + 1]], segs,
                    huff[i], qtables, win_p)
                if row is not None and not np.array_equal(
                        row[4:4 + samp.size], samp):
                    row = None
            if row is not None:
                streams[i] = (segs[:row[1]].copy(), int(row[2]))
                used[i] = row[0]
            else:
                lane = tuple(torch.zeros(
                    sh + (64,), dtype=torch.int16,
                    pin_memory=dev.type == "cuda") for sh in shapes)
                self._host_lane(arr, info, [t.numpy() for t in lane],
                                qtables, intra, win_p, scratch)
                host_lanes[i] = lane
            qty[i] = qtables[info.comp_quant_tbl[0]]
            if not gray:
                qtc[i] = qtables[info.comp_quant_tbl[1]]

        if errors is not None:
            decode_one = one

            def one(i: int):
                try:
                    decode_one(i)
                except Exception as e:  # noqa: BLE001 — isolate per item
                    errors[i] = e
                    streams[i] = None
                    host_lanes.pop(i, None)
                    qty[i] = 0
                    if not gray:
                        qtc[i] = 0

        _timed_tmap(one, b, n_workers, self._decode_workers(n_workers))
        table = E.segment_table(geom, offsets[:-1], streams)
        seg_n = table.seg.size
        meta_n = seg_n + table.sub_start.size + b
        meta = (self._pooled_grow((b, "segs"), meta_n, pinned(torch.int32))
                if pool else pinned(torch.int32)(meta_n))
        meta[:seg_n] = table.seg.ravel()
        meta[seg_n:seg_n + table.sub_start.size] = table.sub_start
        meta[meta_n - b:meta_n] = table.img_ri
        end = int(max((offsets[i] + used[i] for i in range(b)
                       if streams[i] is not None), default=0))
        to = functools.partial(self._to_device, device=dev)
        scan_d = to(scan[:max(end, 4)])
        huff_d = to(huff)
        meta_d = to(meta[:meta_n])
        qt_d = [to(t) for t in tables]
        outs = [torch.zeros((b,) + sh + (64,), dtype=torch.int16, device=dev)
                for sh in shapes]
        status = torch.zeros(b, dtype=torch.int32, device=dev)
        E.huffman_decode(scan_d, table, meta_d[:seg_n].view(-1, 8),
                         meta_d[seg_n:meta_n - b], meta_d[meta_n - b:],
                         huff_d, geom, outs, status)
        for i, lane in host_lanes.items():
            for o, t in zip(outs, lane):
                o[i].copy_(t, non_blocking=True)
        n_dev = sum(st is not None for st in streams)
        metrics.add_counts(device_entropy=n_dev, host_entropy=len(host_lanes))
        self._check = (status, list(bufs))
        return (*outs, *qt_d)

    def _entropy_device(self) -> Optional[torch.device]:
        """The device of the serving fronts' entropy decode: this
        pipeline's, where it is one CUDA device and dct_scale is 1 (the
        k*k lanes of 2 and 4 are cut on the host), else None (the host
        route: the CPU, the mesh fronts)."""
        if (self._device_entropy and self.device.type == "cuda"
                and self.dct_scale == 1):
            return self.device
        return None

    def _entropy_check(self) -> Optional[tuple]:
        check, self._check = self._check, None
        return check

    # -- device stage ----------------------------------------------------------

    def device_step(self, ys, cbs=None, crs=None, qty=None, qtc=None,
                    plain: bool = False):
        """One batch through the dense stages; returns a tuple of device
        tensors, asynchronously on CUDA: for JPEG output the quantized
        coefficients, int16, (yq, cbq, crq) or (yq,) for grayscale; for PNG
        and lossless WebP output (packed,), the (B, dst_h, dst_w) BGRA int32
        pixels; for lossy WebP the u8 planes (y, u, v) of them. Takes
        decode_entropy's output: colour pipelines (ys, cbs, crs, qty,
        qtc), grayscale (ys, qty); the tables may be any numeric dtype
        (fold_qtables converts them on the device); arrays already on the
        device (the device entropy route's) are used as they are.
        plain=True runs the plain PyTorch versions of the decode kernels
        instead of the kernels (the direct mode runs none)."""
        host = (ys, cbs) if self.ncomp == 1 else (ys, cbs, crs, qty, qtc)
        return self._dense_step([self._to_device(a) for a in host],
                                (self.enc_qt_y, self.enc_qt_c), plain)

    def _dense_step(self, dev, enc, plain: bool = False):
        """device_step's dense stages on tensors already on one device:
        dev is (ys, qty) for grayscale, else (ys, cbs, crs, qty, qtc), and
        enc the (luma, chroma) encode tables on the same device."""
        return self.device_stages(dev, enc, plain).run()

    def device_stages(self, dev, enc, plain: bool = False) -> _Stages:
        """_dense_step as its decode, resize and encode stages (_Stages),
        on the tensors _dense_step takes; the encode stage ends with the
        emit (the yuv420 planes of lossy WebP output)."""
        g = self.geom
        emit = self._emit
        fused = _fused_emit(emit)
        if self.ncomp == 1:
            stages = _jpeg_fit_gray_stages(
                dev[0], dev[1], enc[0], src_w=g.width, src_h=g.height,
                dst_w=self.dst_w, dst_h=self.dst_h,
                window=self.window_static, orientation=self.orientation,
                method=self.method, dct_scale=self.dct_scale, plain=plain,
                emit=fused)
        elif self.chroma_mode == "direct":
            stages = _jpeg_fit_ycc_stages(
                *dev, *enc, src_w=g.width, src_h=g.height, dst_w=self.dst_w,
                dst_h=self.dst_h, window=self.window_static,
                dct_scale=self.dct_scale, emit=fused)
        else:
            stages = _jpeg_fit_stages(
                *dev, *enc, src_w=g.width, src_h=g.height, dst_w=self.dst_w,
                dst_h=self.dst_h, window=self.window_static, h2=g.h2,
                v2=g.v2, orientation=self.orientation, method=self.method,
                plain=plain, emit=fused)
        return stages._replace(
            encode=lambda x: _emit_post(stages.encode(x), emit))

    # -- end to end --------------------------------------------------------------

    def _host_decode(self, bufs: Sequence[bytes],
                     errors: Optional[Dict[int, Exception]] = None,
                     host: bool = False):
        """Host stage: entropy decode + ICC collection (a cheap APP2
        header walk per source, so colour profiles survive the
        transcode). The decode takes the device route where
        _entropy_device gives a device, unless host (the redo of a
        flagged stream: the host route, unpooled)."""
        if host:
            coefs = self.decode_entropy(bufs, errors=errors)
        else:
            coefs = self.decode_entropy(bufs, pool=True, errors=errors,
                                        device=self._entropy_device())
        iccs = [b"" if errors is not None and i in errors
                else J.read_icc(buf) for i, buf in enumerate(bufs)]
        return coefs, iccs


def _synthetic_still(fmt: str, w: int, h: int, channels: int = 3) -> bytes:
    """Zero-pixel sample of a still format and geometry: the warm() input
    of the pixel-domain pipelines, as codecs.jpeg.synthetic_jpeg is of the
    JPEG ones. The channel count is part of the serving signature (the PNG
    colour type, the WebP alpha flag), so it is written faithfully."""
    arr = np.zeros((h, w, channels), np.uint8)
    if fmt == "png":
        from .codecs.png import encode_png_pixels
        return encode_png_pixels(arr, 1)
    if fmt == "webp":
        from .codecs.webp import encode_webp_pixels
        from .framebuffer import WEBP_QUALITY
        # quality > 100 is lossless, which keeps a 4th channel's alpha
        # flag in the container deterministically
        return encode_webp_pixels(arr, {WEBP_QUALITY: 101})
    raise ValueError(f"unsupported warm still format {fmt!r}")


class StillTranscodePipeline(_ServingPipelineBase):
    """Batched Fit transcoder for same-signature NON-JPEG still sources
    (PNG, BMP, PNM, PAM, Sun Raster, HDR, PFM, GIF, WebP, JPEG 2000, AVIF,
    a video's first frame: anything the port's new_decoder reads but
    JPEG). A JPEG 2000 source's
    CPU decoder runs its Tier-2 and Tier-1 on the host and its wavelet and
    colour transforms as torch ops on the host CPU; an HDR AVIF's tone
    map runs there too.

    JPEG sources go through JpegTranscodePipeline, in the coefficient
    domain. Every other still format decodes to pixels on the HOST, with
    decoders on device="cpu" on a thread pool (the entropy codecs release
    the GIL; their per-image conversions stay on the host, so the batch
    crosses to the device once, the counterpart of the JAX package's
    _host_cpu_device), into one pinned (B, H, W, C) u8 array. One device
    step then orients, crops, resizes and encodes the batch
    (_fused_still_fit_impl, torch ops: no kernel), and the host
    Huffman-codes, PNG-encodes or WebP-encodes each output. The PNG
    codec's stage times and zlib routes land on the batch's decode and
    encode spans (codecs/png.py).

    Gray (1-channel) sources give 1-component JPEGs and gray PNGs (3
    channels in WebP); 4-channel sources keep alpha in .png and .webp
    output (JPEG output drops it), and take the BGRA pixel emit for .webp,
    where opaque sources take the yuv420 emit. Animated sources transcode
    their first frame, what the reference's Transform emits for animated
    input with still output. optimize_coding=True codes JPEG output with
    optimal Huffman tables.

    Usage:
        pipe = StillTranscodePipeline(sample_png, 256, 256, quality=85)
        outs = pipe.transcode(list_of_pngs)   # same signature as sample

    device: the torch device of the device step, "cuda" by default (it
    raises without a card); device="cpu" runs it on the CPU."""

    def __init__(self, sample: bytes, dst_w: int, dst_h: int,
                 quality: int = 85, method: str = R.AREA,
                 optimize_coding: bool = False,
                 output_format: str = ".jpeg",
                 encode_options: Optional[dict] = None, device="cuda"):
        from . import api as A
        if A.is_jpeg(sample):
            raise DecodingFailedError(
                "JPEG sources: use JpegTranscodePipeline (the "
                "coefficient-domain path) or MultiGeometryPipeline")
        fmt = _normalize_output_format(output_format)
        self.device = resolve_device(device)
        self._lib = binding.load()
        self._pool: dict = {}
        self.dst_w, self.dst_h = dst_w, dst_h
        self.method = method
        self.quality = quality
        self.optimize_coding = optimize_coding
        self.output_format = fmt
        self.encode_options = dict(encode_options or {})
        d = A.new_decoder(sample, device="cpu")
        self.kind = type(d).__name__
        hdr = d.header()
        self.src_w, self.src_h = int(hdr.width), int(hdr.height)
        self.orientation = int(hdr.orientation)
        arr = self._decode_array(d)
        if arr.shape[:2] != (self.src_h, self.src_w):
            raise DecodingFailedError(
                f"decoder output {arr.shape[1]}x{arr.shape[0]} does not "
                f"match header geometry {self.src_w}x{self.src_h}: use "
                "the streaming ImageOps path for this source")
        self.channels = int(arr.shape[-1])
        self.ncomp = 1 if self.channels == 1 else 3
        eql, eqc = J.scaled_qtables(quality)
        self.enc_qt_y_np, self.enc_qt_c_np = eql, eqc
        self.enc_qt_y = torch.from_numpy(eql.astype(np.float32)).to(self.device)
        self.enc_qt_c = torch.from_numpy(eqc.astype(np.float32)).to(self.device)

    # -- host decode stage ----------------------------------------------------

    @staticmethod
    def _decode_array(d) -> np.ndarray:
        """The first frame of a CPU decoder as (H, W, C) u8 numpy."""
        from .framebuffer import Framebuffer
        fb = Framebuffer()
        d.decode_to(fb)
        return fb.to_numpy()

    def _decode_one(self, buf: bytes):
        """Decode and validate one source: every buffer is checked against
        the pipeline's signature (format, geometry, orientation, decoded
        shape) before it lands in the batch array."""
        from . import api as A
        d = A.new_decoder(buf, device="cpu")
        if type(d).__name__ != self.kind:
            raise DecodingFailedError(
                f"format mismatch: pipeline built for {self.kind} "
                f"sources, got {type(d).__name__}")
        hdr = d.header()
        if (int(hdr.width), int(hdr.height)) != (self.src_w, self.src_h):
            raise DecodingFailedError(
                f"geometry mismatch: pipeline built for "
                f"{self.src_w}x{self.src_h}, got {hdr.width}x{hdr.height}")
        if int(hdr.orientation) != self.orientation:
            raise DecodingFailedError(
                f"EXIF orientation mismatch: pipeline expects "
                f"{self.orientation}, got {int(hdr.orientation)}")
        arr = self._decode_array(d)
        if arr.shape != (self.src_h, self.src_w, self.channels):
            raise DecodingFailedError(
                f"decoded shape mismatch: pipeline built for "
                f"{(self.src_h, self.src_w, self.channels)}, got "
                f"{arr.shape} (same-size sources must share the channel "
                "layout)")
        return arr, (d.icc() or b"")

    def decode_pixels(self, bufs: Sequence[bytes],
                      workers: Optional[int] = None, pool: bool = False,
                      errors: Optional[Dict[int, Exception]] = None):
        """Decode a batch into one (B, H, W, C) u8 array (pinned on CUDA)
        and the per-image ICC profiles, on `workers` threads (8 at most by
        default). pool=True takes the array from the 2-slot pool (see
        _pooled). errors: when a dict, per-item failures are ISOLATED: the
        exception lands in errors[i] and the lane is zero-filled; None
        raises on the first bad buffer."""
        b = len(bufs)

        def alloc():
            return self._alloc((b, self.src_h, self.src_w, self.channels),
                               dtype=torch.uint8)
        batch = self._pooled((b, "px"), alloc) if pool else alloc()
        iccs: List[bytes] = [b""] * b

        def one(i: int):
            batch[i], iccs[i] = self._decode_one(bufs[i])

        if errors is not None:
            decode_one = one

            def one(i: int):
                try:
                    decode_one(i)
                except Exception as e:  # noqa: BLE001 -- isolate per item
                    errors[i] = e
                    batch[i] = 0   # benign black lane; wipes pooled data
                    iccs[i] = b""

        _timed_tmap(one, b, workers)
        return batch, iccs

    def _host_decode(self, bufs: Sequence[bytes],
                     errors: Optional[Dict[int, Exception]] = None):
        batch, iccs = self.decode_pixels(bufs, pool=True, errors=errors)
        return (batch,), iccs

    def _pixel_channels(self, fmt: str) -> int:
        """Alpha survives .png and .webp output, gray .png output (libwebp
        takes 3 or 4 channels only)."""
        if self.channels == 1 and fmt != ".png":
            return 3
        return self.channels

    # -- device stage ---------------------------------------------------------

    def device_step(self, px):
        """One H2D copy of the pixel batch (non-blocking) and the fused
        still tail on the pipeline's device (no kernel), then the yuv420
        emit's conversion where it applies; returns a tuple of device
        tensors, as JpegTranscodePipeline.device_step."""
        return self._dense_step(self._to_device(px),
                                (self.enc_qt_y, self.enc_qt_c))

    def _dense_step(self, px, enc):
        """device_step's tail on a pixel batch already on its device, with
        the (luma, chroma) encode tables there."""
        emit = self._emit
        return _emit_post(_fused_still_fit_impl(
            px, enc[0], enc[1],
            src_w=self.src_w, src_h=self.src_h, dst_w=self.dst_w,
            dst_h=self.dst_h, method=self.method,
            orientation=self.orientation, emit=_fused_emit(emit)), emit)


# ---------------------------------------------------------------------------
# animated GIF and WebP: transcode_gif(_batch), transcode_webp(_batch) and
# AnimatedTranscodePipeline
# ---------------------------------------------------------------------------


def _anim_crop_resize(frames: torch.Tensor, crop, dst_w: int, dst_h: int):
    """Fit crop + exact AREA resize of (..., N, H, W, 4) animation frames."""
    if crop is not None:
        left, top, w, h = crop
        frames = frames[..., top:top + h, left:left + w, :]
    return R.resize(frames, dst_w, dst_h, R.AREA)


#: quantize_animation's per-frame inputs in a plan, in argument order
_PLAN_KEYS = ("palettes", "counts", "trans", "clear", "use_prev")


def transcode_gif(buf: bytes, dst_w: int, dst_h: int, fit: bool = False,
                  file_type: str = ".gif", device="cuda") -> bytes:
    """Whole-animation transcode of one GIF: transcode_gif_batch of the
    one animation (one lane, so no pad lanes): host LZW decode, the
    composite of every frame on `device` (frame axis padded to a bucket),
    one crop + AREA resize, the whole-animation quantizer, then the host
    LZW encode. Its bytes equal the streaming ImageOps.transform's, which
    visits the device once per frame."""
    return transcode_gif_batch([buf], dst_w, dst_h, fit=fit,
                               file_type=file_type, device=device)[0]


def _gif_quantize_plan(enc, metas, nb: int) -> dict:
    """Host-side per-frame quantization plans (the encoder's sequential
    trans/cache state) stacked to the padded frame count nb, as
    quantize_animation inputs, plus the (trans, use_local) pairs the
    emitter needs."""
    palettes = np.zeros((nb, 256, 3), np.int32)
    counts = np.ones((nb,), np.int32)  # inert pad rows: 1 entry, no trans
    trans_arr = np.full((nb,), -1, np.int32)
    clear_arr = np.zeros((nb,), bool)
    use_prev_arr = np.zeros((nb,), bool)
    plans = []
    for i, m in enumerate(metas):
        trans, use_local, clear, use_prev = enc._plan_frame(m)
        palettes[i, :m.pal_count] = m.palette[:m.pal_count]
        counts[i] = max(m.pal_count, 1)
        trans_arr[i] = trans
        clear_arr[i] = clear
        use_prev_arr[i] = use_prev
        plans.append((trans, use_local))
    return dict(palettes=palettes, counts=counts, trans=trans_arr,
                clear=clear_arr, use_prev=use_prev_arr, plans=plans)


def _gif_group_plans(prepped, members, nb: int, bb: int):
    """A group's per-animation encoders and (trans, use_local) plans, and
    quantize_animation's inputs stacked over bb lanes (the lanes past the
    members inert: 1-entry palettes, no transparency)."""
    from .codecs.gif import GifEncoder
    encs, plans, stacked = [], [], {k: [] for k in _PLAN_KEYS}
    for i in members:
        dec, _, metas = prepped[i]
        enc = GifEncoder(dec)
        plan = _gif_quantize_plan(enc, metas, nb)
        encs.append(enc)
        plans.append(plan["plans"])
        for k in _PLAN_KEYS:
            stacked[k].append(plan[k])
    inert = _gif_quantize_plan(None, [], nb)
    return encs, plans, {k: np.stack(v + [inert[k]] * (bb - len(members)))
                         for k, v in stacked.items()}


def _host_frame(px: np.ndarray, duration_ms: float):
    """A host frame as a CPU Framebuffer for the host encoders."""
    from .framebuffer import Framebuffer
    fb = Framebuffer(torch.from_numpy(np.ascontiguousarray(px)))
    fb.duration = duration_ms / 1000.0
    return fb


def _gif_emit_webp(dec, metas, host_frames: np.ndarray) -> bytes:
    """GIF -> WebP: one libwebp animation encoder fed the composited and
    resized host frames with GIF's disposal mapped onto WebP's, every
    frame NO_BLEND (the JAX package's _gif_emit_webp)."""
    from .codecs.webp import WebpEncoder
    from .framebuffer import BlendMethod, DisposeMethod
    enc = WebpEncoder(dec)
    try:
        for i, m in enumerate(metas):
            fb = _host_frame(host_frames[i], m.delay_cs * 10)
            fb.blend = BlendMethod.NO_BLEND
            fb.dispose = (DisposeMethod.DISPOSE_TO_BACKGROUND_COLOR
                          if m.disposal == 2 else DisposeMethod.NO_DISPOSE)
            enc.encode(fb, {})
        return enc.encode(None, {})
    finally:
        enc.close()


def _gif_emit_frames(enc, metas, plans, idx_np: np.ndarray,
                     dst_w: int, dst_h: int) -> bytes:
    for i, m in enumerate(metas):
        trans, use_local = plans[i]
        enc._emit_frame(m, np.ascontiguousarray(idx_np[i]), dst_w, dst_h,
                        trans, use_local)
    return enc.encode(None, {})


def _tmap(fn, items, n_workers: int) -> list:
    """Thread-pooled map (the host codecs release the GIL)."""
    if n_workers > 1 and len(items) > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(n_workers) as ex:
            return list(ex.map(fn, items))
    return [fn(x) for x in items]


def _timed_tmap(fn, n: int, workers: Optional[int],
                executor=None) -> list:
    """_tmap of fn over range(n) on `workers` threads (8 at most by
    default), the workers' summed wall and CPU time, and the counts
    their calls added (the PNG codec's stages), handed to the caller's
    open span (utils.WorkerClock; the threads the map ran on as its
    workers). executor: a ThreadPoolExecutor of that many threads
    to map on, kept by the caller across calls, instead of a new one."""
    n_workers = workers if workers is not None else min(8, os.cpu_count() or 1)
    clock = WorkerClock()
    if executor is not None and n_workers > 1 and n > 1:
        out = list(executor.map(clock.timed(fn), range(n)))
    else:
        out = _tmap(clock.timed(fn), range(n), n_workers)
    metrics.add_counts(**clock.counts(
        min(n_workers, n) if n_workers > 1 and n > 1 else 1))
    return out


def _anim_batch_groups(prepped, sig_fn) -> Dict[tuple, List[int]]:
    """Group prepped animations by device signature, preserving first-seen
    order: signature -> member indices."""
    groups: Dict[tuple, List[int]] = {}
    for i, item in enumerate(prepped):
        groups.setdefault(sig_fn(item), []).append(i)
    return groups


def _stack_group(prepped, members, names, pad_to: int) -> dict:
    """Stack each named per-animation input over a leading animation axis,
    padding the animation count to pad_to with zeroed (inert) lanes."""
    from .utils import metrics
    metrics.incr("serving.anim_groups")
    metrics.incr("serving.anim_lanes", len(members))
    metrics.incr("serving.anim_pad_lanes", pad_to - len(members))
    stack = {}
    for name in names:
        arrs = [prepped[i][1][name] for i in members]
        arrs.extend([np.zeros_like(arrs[0])] * (pad_to - len(members)))
        stack[name] = np.stack(arrs)
    return stack


#: cross-animation batch lane cap: a group's device footprint grows with
#: its animation count (the composited frames alone are ~30 MB per
#: animation at a 480x480 canvas x bucket 32), so larger groups split
#: into chunks of at most this many animations
_MAX_ANIM_LANES = 32

_GIF_INPUTS = ("idxs", "drawn", "luts", "counts", "trans", "pdisp",
               "prects", "bg_bgra")


def _anim_bucket(n_members: int, mesh) -> int:
    """Animation-count bucket (ops.palette.frame_bucket), rounded up to a
    multiple of the mesh's dp size so the animation axis splits evenly."""
    bb = P.frame_bucket(n_members)
    if mesh is not None:
        dp = mesh.shape["dp"]
        bb = -(-bb // dp) * dp
    return bb


def _chunk_members(members, mesh=None) -> List[List[int]]:
    """A group's members in chunks of at most _MAX_ANIM_LANES, the cap a
    multiple of the mesh's dp size (dp at least) so sharded chunks keep
    even lanes."""
    cap = _MAX_ANIM_LANES
    if mesh is not None:
        dp = mesh.shape["dp"]
        cap = max(dp, cap // dp * dp)
    return [members[i:i + cap] for i in range(0, len(members), cap)]


def _front_device(device, mesh):
    """(device, mesh) of a front: without a mesh the device ("cuda" when
    None); with one, the mesh's first device, and a ValueError when
    device names another."""
    if mesh is None:
        return resolve_device("cuda" if device is None else device), None
    from .parallel.mesh import check_mesh
    return check_mesh(mesh).front_device(device), mesh


def _anim_slots(mesh, dev) -> List[tuple]:
    """The (device, stream) of each dp slice of an animation batch: each
    dp group's first mesh slot, or without a mesh the one device on its
    current stream (stream None)."""
    if mesh is None:
        return [(dev, None)]
    return [mesh.slot(i, 0) for i in range(mesh.shape["dp"])]


def _on_slots(slots, fn, per_slot) -> list:
    """fn(*args) for each slot's args, issued on the slot's device and
    stream in slot order; then the first device's current stream waits for
    every slot's (so a stage clock's events there time them all)."""
    from .parallel.mesh import join_slots, slot_context
    out = []
    for slot, args in zip(slots, per_slot):
        with slot_context(*slot):
            out.append(fn(*args))
    join_slots(slots)
    return out


def _dp_put(arrs, slots) -> List[list]:
    """Stacked animation inputs (leading axis: the animation, a multiple
    of the slot count long) as contiguous slices of that axis, one per
    slot, each copied to its slot's device: animations never split, so
    the bytes equal the one-device batch's."""
    n = len(slots)
    return _on_slots(slots, lambda i, d: [
        torch.from_numpy(np.ascontiguousarray(
            a[i * len(a) // n:(i + 1) * len(a) // n])).to(d)
        for a in arrs], [(i, s[0]) for i, s in enumerate(slots)])


def _lanes_to_host(slots, parts, n: int) -> np.ndarray:
    """The first n animation lanes of per-slot device tensors (each slot
    holding an equal share of the lanes) as one host array."""
    lanes = parts[0].shape[0]
    return np.concatenate(_on_slots(slots, lambda t, k: t[:k].cpu().numpy(), [
        (t, min(max(n - i * lanes, 0), lanes))
        for i, t in enumerate(parts)]))


def transcode_gif_batch(bufs: Sequence[bytes], dst_w: int, dst_h: int,
                        fit: bool = False, file_type: str = ".gif",
                        workers: Optional[int] = None, mesh=None,
                        device=None,
                        stage_times: Optional[Dict[str, List[float]]] = None
                        ) -> List[bytes]:
    """Whole-animation transcode of MANY GIFs with shared device work, for
    avatar-resize serving (many small animations); transcode_gif is its
    one-animation call.

    Animations are grouped by (canvas, frame bucket); each group (in
    chunks of at most _MAX_ANIM_LANES) pads its animation count to
    ops.palette.frame_bucket and runs one composite + resize (+ quantize
    for .gif output) over a (B, N, H, W, ...) stack on `device` ("cuda"
    by default). Each animation's bytes equal its own call's: the batched
    ops apply the same exact ops per animation, and the host encode is per
    animation. Host LZW decode, the host encode (LZW, or libwebp for
    .webp) and the input assembly run on a thread pool (the C++ codecs
    release the GIL).

    mesh: a parallel.Mesh; each group's animation count then pads to a
    multiple of its dp size and each dp slot runs a contiguous slice of
    the animations on its group's first device and stream (_dp_put), the
    same bytes; device, if given, must be the mesh's first device.

    stage_times, when a dict, gets the ms of each stage appended under
    its name: "lzw_decode" (host LZW and scatter, once per call), then
    per group "stack", "h2d", "composite", "resize", then for .gif
    "plan", "quantize", "d2h" and "lzw_encode", for .webp "d2h" and
    "webp_encode" (see utils.StageClock)."""
    from .codecs.gif import GifDecoder

    if file_type not in (".gif", ".webp"):
        raise DecodingFailedError(
            f"GIF batch transcode encodes to .gif/.webp, not {file_type}")
    dev, mesh = _front_device(device, mesh)
    slots = _anim_slots(mesh, dev)
    n_workers = workers if workers is not None else min(4, os.cpu_count() or 1)

    def prep(buf: bytes):
        dec = GifDecoder(buf, device=dev)
        inp, metas = dec.animation_inputs(pad_frames=-1)
        if not metas:
            raise DecodingFailedError("gif has no frames")
        return dec, inp, metas

    clock = StageClock(stage_times, dev)
    with clock("lzw_decode"):
        prepped = _tmap(prep, bufs, n_workers)
    groups = _anim_batch_groups(
        prepped, lambda it: (it[0]._w, it[0]._hgt, it[1]["idxs"].shape[0]))

    out: List[Optional[bytes]] = [None] * len(bufs)
    for (cw, ch, nb), members in [(k, c) for k, g in groups.items()
                                  for c in _chunk_members(g, mesh)]:
        bb = _anim_bucket(len(members), mesh)  # animation-count bucket
        with clock("stack"):
            stack = _stack_group(prepped, members, _GIF_INPUTS, bb)
        with clock("h2d", device=True):
            inputs = _dp_put([stack[k] for k in _GIF_INPUTS], slots)
        with clock("composite", device=True):
            comp = _on_slots(slots, P.composite_animation, inputs)
        crop = fit_rect(cw, ch, dst_w, dst_h) if fit else None
        with clock("resize", device=True):
            resized = _on_slots(slots, lambda c: _anim_crop_resize(
                c, crop, dst_w, dst_h), [(c,) for c in comp])
        del inputs, comp  # the quantizer's transient gets their memory
        if file_type == ".webp":
            with clock("d2h"):
                host_px = _lanes_to_host(slots, resized, len(members))

            def emit_webp(k: int) -> bytes:
                dec, _, metas = prepped[members[k]]
                return _gif_emit_webp(dec, metas, host_px[k])

            with clock("webp_encode"):
                results = _tmap(emit_webp, range(len(members)), n_workers)
            for k, i in enumerate(members):
                out[i] = results[k]
            continue
        with clock("plan"):
            encs, plans_list, stacked = _gif_group_plans(prepped, members,
                                                         nb, bb)
        with clock("quantize", device=True):
            plans = _dp_put([stacked[k] for k in _PLAN_KEYS], slots)
            idxs = _on_slots(slots, P.quantize_animation, [
                (r, *p) for r, p in zip(resized, plans)])
        with clock("d2h"):
            idx_np = _lanes_to_host(slots, idxs, len(members))

        def emit_gif(k: int) -> bytes:
            _, _, metas = prepped[members[k]]
            return _gif_emit_frames(encs[k], metas, plans_list[k],
                                    idx_np[k], dst_w, dst_h)

        with clock("lzw_encode"):
            results = _tmap(emit_gif, range(len(members)), n_workers)
        for k, i in enumerate(members):
            out[i] = results[k]
    return out  # type: ignore[return-value]


def _rect_mask(x: int, y: int, w: int, h: int, cw: int, ch: int):
    """(ch, cw) bool mask of a frame rect clipped to the canvas: a negative
    offset shrinks the extent by the clipped-off margin (GifDecoder's
    _clip_rect), so the mask and the copied slice agree. Returns (mask,
    (x2, y2, w2, h2)) with w2 or h2 <= 0 for a rect off the canvas."""
    x2, y2 = max(x, 0), max(y, 0)
    w2 = min(w - (x2 - x), cw - x2)
    h2 = min(h - (y2 - y), ch - y2)
    m = np.zeros((ch, cw), bool)
    if w2 > 0 and h2 > 0:
        m[y2:y2 + h2, x2:x2 + w2] = True
    return m, (x2, y2, w2, h2)


def _webp_anim_inputs(buf: bytes):
    """Host assembly for the WebP composite: decode every frame's BGRA
    pixels, scatter each to canvas shape with its drawn mask and the
    previous frame's rect and disposal, pad the frame axis to
    ops.palette.frame_bucket (inert frames draw nothing). Returns
    (decoder, inputs for composite_animation_rgba, durations_ms): the unit
    transcode_webp_batch stacks over a leading animation axis. The decoder
    hands out no frame tensor here (next_frame reads on the host), so it
    is a CPU one."""
    from .codecs.webp import WebpDecoder
    dec = WebpDecoder(buf, device="cpu")
    cw, ch = dec._w, dec._hgt
    frames, drawn, blends, pdisp, prects, durations = [], [], [], [], [], []
    prev_rect = None
    prev_disposal = 0
    while True:
        frame = dec.next_frame(4)
        if frame is None:
            break
        px, (x, y, w, h, dur_ms, dispose, blend, _) = frame
        full = np.zeros((ch, cw, 4), np.uint8)
        dm, (x2, y2, w2, h2) = _rect_mask(x, y, w, h, cw, ch)
        if w2 > 0 and h2 > 0:
            full[y2:y2 + h2, x2:x2 + w2] = px[y2 - y:y2 - y + h2,
                                              x2 - x:x2 - x + w2]
        pm = (np.zeros((ch, cw), bool) if prev_rect is None
              else _rect_mask(*prev_rect, cw, ch)[0])
        frames.append(full)
        drawn.append(dm)
        blends.append(blend)
        pdisp.append(prev_disposal)
        prects.append(pm)
        durations.append(dur_ms)
        prev_rect = (x, y, w, h)
        prev_disposal = dispose
    if not frames:
        raise DecodingFailedError("webp has no frames")
    for _ in range(len(frames), P.frame_bucket(len(frames))):
        frames.append(np.zeros((ch, cw, 4), np.uint8))
        drawn.append(np.zeros((ch, cw), bool))
        blends.append(1)
        pdisp.append(0)
        prects.append(np.zeros((ch, cw), bool))
    inputs = dict(frames=np.stack(frames), drawn=np.stack(drawn),
                  blends=np.array(blends, np.int32),
                  pdisp=np.array(pdisp, np.int32), prects=np.stack(prects))
    return dec, inputs, durations


def _anim_emit(dec, host_frames: np.ndarray, durations_s, encode_options,
               file_type: str) -> bytes:
    """The host animation encode (new_encoder(file_type, dec)) of one
    animation's resized frames, the encoder closed after its flush or
    failure (a WebP encoder holds native memory until then)."""
    from .api import new_encoder
    from .framebuffer import Framebuffer
    with new_encoder(file_type, dec) as enc:
        for px, dur in zip(host_frames, durations_s):
            fb = Framebuffer(torch.from_numpy(np.ascontiguousarray(px)))
            fb.duration = dur
            enc.encode(fb, encode_options or {})
        return enc.encode(None, encode_options or {})


def _anim_transcode_batch(bufs, prep, group_key, input_keys, to_pixels,
                          emit, dst_w: int, dst_h: int, fit: bool,
                          workers: Optional[int], device, mesh, stage_times,
                          decode_stage: str, encode_stage: str
                          ) -> List[bytes]:
    """The cross-animation loop of transcode_webp_batch and
    transcode_avif_batch: prep(buf) -> (decoder, {name: array}, durations)
    on a thread pool; animations grouped by group_key(prepped item), in
    chunks of at most _MAX_ANIM_LANES, the animation count padded to a
    bucket (a multiple of the mesh's dp size); per group one stack of
    input_keys (the first is the (N, H, W, ...) frame stack, whose H and W
    are the canvas), one H2D (per dp slot with a mesh), the device stages
    to_pixels(crop) -> [(stage name, fn)], each fn taking the previous
    stage's outputs (first the inputs) and the last returning the resized
    (B, N, dst_h, dst_w, C) frames, one D2H, and emit(decoder, frames,
    durations) -> bytes per animation on the thread pool. stage_times gets
    decode_stage once, then per group "stack", "h2d", the stages' names,
    "d2h" and encode_stage."""
    dev, mesh = _front_device(device, mesh)
    slots = _anim_slots(mesh, dev)
    n_workers = workers if workers is not None else min(4, os.cpu_count() or 1)
    clock = StageClock(stage_times, dev)
    with clock(decode_stage):
        prepped = _tmap(prep, bufs, n_workers)
    groups = _anim_batch_groups(prepped, group_key)

    out: List[Optional[bytes]] = [None] * len(bufs)
    for members in [c for g in groups.values()
                    for c in _chunk_members(g, mesh)]:
        bb = _anim_bucket(len(members), mesh)  # animation-count bucket
        with clock("stack"):
            stack = _stack_group(prepped, members, input_keys, bb)
        with clock("h2d", device=True):
            cur = _dp_put([stack[k] for k in input_keys], slots)
        ch, cw = stack[input_keys[0]].shape[2:4]
        crop = fit_rect(cw, ch, dst_w, dst_h) if fit else None
        for name, fn in to_pixels(crop):
            with clock(name, device=True):
                cur = [(x,) for x in _on_slots(slots, fn, cur)]
        with clock("d2h"):
            host_px = _lanes_to_host(slots, [x[0] for x in cur],
                                     len(members))
        del cur

        def emit_one(k: int) -> bytes:
            dec, _, durs = prepped[members[k]]
            return emit(dec, host_px[k], durs)

        with clock(encode_stage):
            results = _tmap(emit_one, range(len(members)), n_workers)
        for k, i in enumerate(members):
            out[i] = results[k]
    return out  # type: ignore[return-value]


_WEBP_INPUTS = ("frames", "drawn", "blends", "pdisp", "prects")


def _webp_batch_to_pixels(frames, drawn, blends, pdisp, prects, crop,
                          dst_w: int, dst_h: int) -> torch.Tensor:
    """composite_animation_rgba + Fit crop + exact AREA resize of a batch
    of WebP-class animations (leading axis = animation)."""
    comp = P.composite_animation_rgba(frames, drawn, blends, pdisp, prects)
    return _anim_crop_resize(comp, crop, dst_w, dst_h)


def transcode_webp(buf: bytes, dst_w: int, dst_h: int, fit: bool = False,
                   encode_options=None, device="cuda") -> bytes:
    """Whole-animation transcode of one WebP: transcode_webp_batch of the
    one animation. Host libwebp frame decode, the alpha-blend and dispose
    composite of every frame on `device`, one crop + AREA resize, the host
    animation encode; its bytes equal the streaming ImageOps.transform's."""
    return transcode_webp_batch([buf], dst_w, dst_h, fit=fit,
                                encode_options=encode_options,
                                device=device)[0]


def transcode_webp_batch(bufs: Sequence[bytes], dst_w: int, dst_h: int,
                         fit: bool = False, encode_options=None,
                         workers: Optional[int] = None, mesh=None,
                         device=None,
                         stage_times: Optional[Dict[str, List[float]]] = None
                         ) -> List[bytes]:
    """Cross-animation WebP transcode (transcode_gif_batch's counterpart
    for WebP sources): animations grouped by (canvas, frame bucket), in
    chunks of at most _MAX_ANIM_LANES, the animation count padded to a
    bucket, one composite + crop + resize and one D2H per group, each
    animation's bytes equal to its own transcode_webp's. Host libwebp
    decode and encode on a thread pool. mesh: as transcode_gif_batch's.

    stage_times, when a dict, gets the ms of "webp_decode" (host decode
    and scatter, once per call), then per group "stack", "h2d",
    "composite", "resize", "d2h" and "webp_encode"."""
    def to_pixels(crop):
        return [("composite", P.composite_animation_rgba),
                ("resize", lambda comp: _anim_crop_resize(
                    comp, crop, dst_w, dst_h))]

    def emit(dec, host_frames, durations_ms):
        return _anim_emit(dec, host_frames, [d / 1000.0 for d in durations_ms],
                          encode_options, ".webp")

    return _anim_transcode_batch(
        bufs, _webp_anim_inputs,
        lambda it: (it[0]._w, it[0]._hgt, it[1]["frames"].shape[0]),
        _WEBP_INPUTS, to_pixels, emit, dst_w, dst_h, fit, workers, device,
        mesh, stage_times, "webp_decode", "webp_encode")


def _avif_anim_inputs(buf: bytes):
    """Host assembly for AVIF: decode every frame (avis frames are full
    canvas, nothing to composite) on a CPU decoder, as the JAX package
    pins this decode to its host CPU device, and pad the frame axis to
    ops.palette.frame_bucket. Returns (decoder, {"frames": (N, H, W, C)
    u8}, durations_s)."""
    from .codecs.avif import AvifDecoder
    from .framebuffer import Framebuffer
    dec = AvifDecoder(buf, device="cpu")
    frames, durations = [], []
    while True:
        fb = Framebuffer()
        try:
            dec.decode_to(fb)
        except EOFError:
            break
        frames.append(fb.to_numpy())
        durations.append(fb.duration)
    if not frames:
        raise DecodingFailedError("avif has no frames")
    for _ in range(len(frames), P.frame_bucket(len(frames))):
        frames.append(np.zeros_like(frames[0]))
    return dec, dict(frames=np.stack(frames)), durations


def transcode_avif(buf: bytes, dst_w: int, dst_h: int, fit: bool = False,
                   encode_options=None, file_type: str = ".avif",
                   device="cuda") -> bytes:
    """Whole-animation transcode of one AVIF: transcode_avif_batch of the
    one animation. Host AV1 frame decode (dav1d; an HDR source's tone map
    on the host CPU), one upload, one crop + AREA resize of every frame on
    `device`, one download, then the AVIF (libaom) or WebP encoder."""
    return transcode_avif_batch([buf], dst_w, dst_h, fit=fit,
                                encode_options=encode_options,
                                file_type=file_type, device=device)[0]


def transcode_avif_batch(bufs: Sequence[bytes], dst_w: int, dst_h: int,
                         fit: bool = False, encode_options=None,
                         file_type: str = ".avif",
                         workers: Optional[int] = None, mesh=None,
                         device=None,
                         stage_times: Optional[Dict[str, List[float]]] = None
                         ) -> List[bytes]:
    """Cross-animation AVIF transcode: animations grouped by their frame
    stack's signature (frame bucket, canvas, channels, dtype: RGB and
    RGBA never share a group), in chunks of at most _MAX_ANIM_LANES, the
    animation count padded to a bucket, one H2D, one crop + AREA resize
    and one D2H per group; each animation's bytes equal its own
    transcode_avif's. Host decode and encode on a thread pool. mesh: as
    transcode_gif_batch's.

    stage_times, when a dict, gets the ms of "avif_decode" (host decode,
    once per call), then per group "stack", "h2d", "resize", "d2h" and
    "encode"."""
    def to_pixels(crop):
        return [("resize", lambda frames: _anim_crop_resize(
            frames, crop, dst_w, dst_h))]

    def emit(dec, host_frames, durations_s):
        return _anim_emit(dec, host_frames, durations_s, encode_options,
                          file_type)

    return _anim_transcode_batch(
        bufs, _avif_anim_inputs,
        lambda it: (it[1]["frames"].shape, str(it[1]["frames"].dtype)),
        ("frames",), to_pixels, emit, dst_w, dst_h, fit, workers, device,
        mesh, stage_times, "avif_decode", "encode")


def spritesheet_tiles(frames: np.ndarray, tile_w: int, tile_h: int,
                      with_thumbhashes: bool = False, device="cuda",
                      stage_times: Optional[Dict[str, List[float]]] = None):
    """The device half of spritesheet: (N, H, W, 4) u8 BGRA keyframes on
    the host (pinned for an asynchronous copy) -> ((N, tile_h, tile_w, 4)
    u8 tiles on the host, their thumbhashes or None). One H2D, the AREA
    resize of every frame (_anim_crop_resize, no crop), the batched
    thumbhash grids (codecs/thumbhash.thumbhash_batch, whose grids come
    back in a copy of their own) and one D2H of the tiles. stage_times,
    when a dict, gets the ms of "h2d", "resize", "thumbhash" (with
    thumbhashes) and "d2h" (CUDA events on a card)."""
    dev = resolve_device(device)
    clock = StageClock(stage_times, dev)
    with clock("h2d", device=True):
        batch = torch.from_numpy(frames).to(dev, non_blocking=True)
    with clock("resize", device=True):
        tiles = _anim_crop_resize(batch, None, tile_w, tile_h)
    hashes = None
    if with_thumbhashes:
        from .codecs.thumbhash import thumbhash_batch
        with clock("thumbhash", device=True):
            hashes = thumbhash_batch(tiles, device=dev)
    with clock("d2h", device=True):
        host = tiles.cpu().numpy()
    return host, hashes


def spritesheet(video: bytes, tile_w: int, tile_h: int,
                max_tiles: int = 64, workers: Optional[int] = None,
                with_thumbhashes: bool = False, device="cuda"):
    """Keyframe spritesheet (lilliput_tpu/pipeline.py:1969-2015): the
    keyframe index, then stateless raw keyframe decodes (ffmpeg, on a
    thread pool of min(8, cpu_count) threads: avcodec.cpp:770-873's
    contract) straight into one pinned (N, H, W, 4) stack, then
    spritesheet_tiles on `device` ("cuda" unless the caller passes
    device="cpu"), and the sheet assembled on the host, tiles in row-major
    order on a grid of ceil(sqrt(N)) columns.

    Each keyframe's packet is video[offset:offset + size] as the index
    gives it, as in the JAX package. Where ffmpeg's headers are absent
    the index read raises HostLibraryMissingError.

    Returns (sheet (rows * tile_h, cols * tile_w, 4) BGRA np.ndarray,
    [timestamps_us], [thumbhash bytes] or None)."""
    from .codecs.video import VideoDecoder, decode_raw_keyframe
    dev = resolve_device(device)
    with VideoDecoder(video, device="cpu") as dec:
        kf = dec.keyframes()[:max_tiles]
        if not kf:
            raise DecodingFailedError("no keyframes in video")
        cid, extradata = dec.codec_params()
        hdr = dec.header()
    fw, fh = hdr.width, hdr.height
    frames = torch.empty((len(kf), fh, fw, 4), dtype=torch.uint8,
                         pin_memory=dev.type == "cuda").numpy()

    def one(i: int):
        _, off, size = kf[i]
        decode_raw_keyframe(cid, extradata, video[off:off + size], fw, fh,
                            out=frames[i])

    n_workers = workers if workers is not None else min(8, os.cpu_count()
                                                        or 1)
    _tmap(one, range(len(kf)), n_workers)
    tiles, hashes = spritesheet_tiles(frames, tile_w, tile_h,
                                      with_thumbhashes, dev)
    n = len(tiles)
    cols = int(np.ceil(np.sqrt(n)))
    rows = (n + cols - 1) // cols
    sheet = np.zeros((rows * tile_h, cols * tile_w, 4), np.uint8)
    for i in range(n):
        r, c = divmod(i, cols)
        sheet[r * tile_h:(r + 1) * tile_h,
              c * tile_w:(c + 1) * tile_w] = tiles[i]
    return sheet, [e[0] for e in kf], hashes


class AnimatedTranscodePipeline:
    """Serving front for ANIMATED sources whose output keeps the animation,
    what the reference's Transform does for animated input with .gif or
    .webp output (ops.go:302-374 loops every frame through the encoder).

    GIF sources (.gif or .webp output) ride the cross-animation batch
    (transcode_gif_batch) and WebP sources (.webp output)
    transcode_webp_batch: same-signature animations share one device
    composite and resize (and quantize for .gif), byte-identical to
    per-animation transcode_gif / transcode_webp and to the streaming
    ImageOps path. A failed group falls back to per-item transcode, so a
    malformed animation fails only its own slot.

    AVIF sources ride transcode_avif_batch (.webp and .avif output).

    output_format: ".gif" (GIF sources; the GIF encoder reuses the source
    palette), ".webp" (GIF, WebP and AVIF sources) or ".avif" (AVIF
    sources), as in the JAX package. The .webp host encode raises
    HostLibraryMissingError where libwebp is absent, and the AVIF decode
    and .avif encode where ffmpeg is.

    mesh: a parallel.Mesh; the cross-animation batches then split each
    group's animations over its dp slots (transcode_gif_batch), the same
    bytes, while the per-animation fallbacks stay on the one device.
    device: "cuda" by default, or the mesh's first device (another device
    with a mesh raises ValueError).
    """

    _FORMATS = (".gif", ".webp", ".avif")

    def __init__(self, dst_w: int, dst_h: int, output_format: str = ".webp",
                 fit: bool = True, workers: Optional[int] = None,
                 encode_options: Optional[dict] = None, mesh=None,
                 device=None):
        if output_format not in self._FORMATS:
            raise ValueError(
                f"animated output_format must be one of {self._FORMATS}")
        self.dst_w, self.dst_h = dst_w, dst_h
        self.output_format = output_format
        self.fit = fit
        self.workers = workers
        self.encode_options = dict(encode_options or {})
        self.device, self.mesh = _front_device(device, mesh)

    def transcode_one(self, buf: bytes) -> bytes:
        from . import api as A
        fmt = self.output_format
        if A.is_gif(buf):
            if fmt not in (".gif", ".webp"):
                raise DecodingFailedError(
                    f"GIF sources encode to .gif/.webp, not {fmt}")
            return transcode_gif(buf, self.dst_w, self.dst_h, fit=self.fit,
                                 file_type=fmt, device=self.device)
        if A.is_webp(buf):
            if fmt != ".webp":
                raise DecodingFailedError(
                    ".gif output requires a GIF source (the GIF encoder "
                    "reuses the source palette)" if fmt == ".gif" else
                    f"WebP sources encode to .webp, not {fmt}")
            return transcode_webp(buf, self.dst_w, self.dst_h, fit=self.fit,
                                  encode_options=self.encode_options,
                                  device=self.device)
        if A.is_avif(buf):
            if fmt not in (".webp", ".avif"):
                raise DecodingFailedError(
                    ".gif output requires a GIF source (the GIF encoder "
                    "reuses the source palette)")
            return transcode_avif(buf, self.dst_w, self.dst_h, fit=self.fit,
                                  encode_options=self.encode_options,
                                  file_type=fmt, device=self.device)
        raise DecodingFailedError(
            "animated transcode supports GIF/WebP/AVIF sources")

    def transcode(self, bufs: Sequence[bytes],
                  return_exceptions: bool = False,
                  stage_times: Optional[Dict[str, List[float]]] = None
                  ) -> List[bytes]:
        """Transcode a mixed batch. Per-item failures are isolated: a
        malformed animation grouped into a cross-animation batch cannot
        fail its healthy co-batched requests, since a failed group falls
        back to per-item transcode, where errors attach to their own
        index. With return_exceptions=True the failing items' slots hold
        the exception objects; with the default False the first failure
        re-raises after the healthy items finish. stage_times goes to
        transcode_gif_batch, transcode_webp_batch and transcode_avif_batch
        (the per-item path is not timed)."""
        from . import api as A
        out: List[Optional[bytes]] = [None] * len(bufs)
        errors: Dict[int, Exception] = {}
        rest = list(range(len(bufs)))

        def run_batch(sniff, batch_fn, **kw):
            nonlocal rest
            members = [i for i in rest if sniff(bufs[i])]
            if len(members) <= 1:
                return
            try:
                res = batch_fn([bufs[i] for i in members], self.dst_w,
                               self.dst_h, fit=self.fit,
                               workers=self.workers, mesh=self.mesh,
                               device=self.device, stage_times=stage_times,
                               **kw)
            except Exception:
                # one hostile member poisoned the group: the per-item
                # path below isolates the failure to its own index
                return
            for i, r in zip(members, res):
                out[i] = r
            rest = [i for i in rest if out[i] is None]

        if self.output_format in (".gif", ".webp"):
            run_batch(A.is_gif, transcode_gif_batch,
                      file_type=self.output_format)
        if self.output_format == ".webp":
            run_batch(A.is_webp, transcode_webp_batch,
                      encode_options=self.encode_options)
        if self.output_format in (".webp", ".avif"):
            run_batch(A.is_avif, transcode_avif_batch,
                      encode_options=self.encode_options,
                      file_type=self.output_format)
        n_workers = (self.workers if self.workers is not None
                     else min(4, os.cpu_count() or 1))

        def one(i):
            try:
                return self.transcode_one(bufs[i])
            except Exception as e:  # noqa: BLE001 -- isolate per item
                errors[i] = e
                return None

        for i, r in zip(rest, _tmap(one, rest, n_workers)):
            out[i] = r
        return _ServingPipelineBase._resolve_errors(out, errors,
                                                    return_exceptions)


# ---------------------------------------------------------------------------
# the mixed-geometry, mixed-format serving front
# ---------------------------------------------------------------------------


class MultiGeometryPipeline:
    """Serving front for mixed-geometry still batches (SURVEY.md hard part
    #3), JPEG and non-JPEG sources alike.

    Requests are grouped by their exact signature: JPEGs by coefficient
    geometry (dims + subsampling) and EXIF orientation, read by the port's
    header parser; other still formats by (decoder, dims, channels,
    orientation). Each group runs as one batch through a per-signature
    JpegTranscodePipeline (coefficient domain: the layout's decode kernel)
    or StillTranscodePipeline (pixel domain: host decode, one device
    step), and the input order is restored. The pipelines sit in an LRU of
    max_geometries. The JAX package caches a compiled XLA program per
    signature; eager torch compiles nothing, so here a "compile"
    (serving.geometry_compiles) is a pipeline built, and each pipeline
    keeps its own resize tables (ops/resize caches them per geometry).
    Animated GIF, WebP and AVIF sources with .gif (GIF only) or .webp
    output go to AnimatedTranscodePipeline; still WebP and AVIF sources to
    a StillTranscodePipeline. Where libwebp is absent, each WebP source
    and each .webp output fails in its own slot with
    HostLibraryMissingError, as each AVIF source does where ffmpeg is.

    Video sources (their first frame, decoded through ffmpeg where its
    headers exist) group as stills of their own decoder, as in the JAX
    package; where ffmpeg is absent each fails in its own slot with
    HostLibraryMissingError.

    device: "cuda" by default (it raises without a card), passed to every
    pipeline built; device="cpu" runs the fronts on the CPU.

    mesh: a parallel.Mesh; every route then runs over it: JPEG groups
    build ShardedJpegPipeline, other stills ShardedStillPipeline (dp
    byte-identical, sp within one of the one-device front), the animated
    batches split their animations over dp. device, if given with a mesh,
    must be the mesh's first device (ValueError otherwise)."""

    def __init__(self, dst_w: int, dst_h: int, quality: int = 85,
                 method: str = R.AREA, max_geometries: int = 64,
                 chroma_mode: str = "rgb", dct_scale: int = 1,
                 output_format: str = ".jpeg",
                 encode_options: Optional[dict] = None, mesh=None,
                 device=None):
        self.device, self.mesh = _front_device(device, mesh)
        self.dst_w, self.dst_h = dst_w, dst_h
        self.quality = quality
        self.method = method
        self.max_geometries = max_geometries
        self.chroma_mode = chroma_mode
        self.dct_scale = dct_scale
        # fail at construction, not on the first request; ".gif" is the
        # animated-only output (GIF sources, reference giflib.go parity)
        self.output_format = _normalize_output_format(output_format,
                                                      allow_gif=True)
        self.encode_options = dict(encode_options or {})
        self._anim_pipe: Optional[AnimatedTranscodePipeline] = None
        # signature key -> serving pipeline, in LRU order; JPEG keys are
        # (JpegGeometry, orientation), still keys ("still", kind, w, h,
        # channels, orientation)
        self._pipes: "OrderedDict[tuple, _ServingPipelineBase]" = \
            OrderedDict()

    def _animated_route(self, buf: bytes):
        """Animated source + animation-capable output -> the animated
        serving pipeline (the reference's Transform keeps the animation
        for .gif and .webp output); still outputs take the first frame.
        Returns (pipeline or None for the still routes, decoder or None):
        a CPU decoder built for the animation probe is handed back so the
        still route reads its header instead of parsing again."""
        from . import api as A
        if self.output_format == ".gif":
            # GIF output: GIF sources only (single-frame ones too: the GIF
            # encoder reuses the source palette)
            if not A.is_gif(buf):
                raise DecodingFailedError(
                    ".gif output requires a GIF source (the GIF encoder "
                    "reuses the source palette, giflib.go parity)")
        elif self.output_format != ".webp":
            return None, None
        elif not (A.is_gif(buf) or A.is_webp(buf) or A.is_avif(buf)):
            return None, None
        else:
            d = A.new_decoder(buf, device="cpu")
            if not d.header().is_animated():
                return None, d
        if self._anim_pipe is None:
            self._anim_pipe = AnimatedTranscodePipeline(
                self.dst_w, self.dst_h, output_format=self.output_format,
                fit=True, encode_options=self.encode_options,
                mesh=self.mesh, device=self.device)
        return self._anim_pipe, None

    def _pipe_for(self, buf: bytes):
        from . import api as A
        from .utils import metrics
        anim, d0 = self._animated_route(buf)
        if anim is not None:
            return anim
        kw = dict(quality=self.quality, method=self.method,
                  output_format=self.output_format,
                  encode_options=self.encode_options, device=self.device)
        jpeg_cls, still_cls = JpegTranscodePipeline, StillTranscodePipeline
        if self.mesh is not None:
            from .parallel import serving
            jpeg_cls = serving.ShardedJpegPipeline
            still_cls = serving.ShardedStillPipeline
            kw["mesh"] = self.mesh
        if A.is_jpeg(buf):
            geom = geometry_of(J.read_info(buf))
            orientation = int(J.exif_orientation(buf))
            key = (geom, orientation)

            def build():
                mode = ("direct" if self.chroma_mode == "direct"
                        and JpegTranscodePipeline.direct_eligible(
                            geom, orientation, self.dst_w, self.dst_h,
                            self.method) else "rgb")
                return jpeg_cls(
                    buf, self.dst_w, self.dst_h, chroma_mode=mode,
                    dct_scale=self.dct_scale if mode == "direct" else 1,
                    **kw)
        else:
            # pixel-domain pipelines keyed by (format, dims, channels,
            # orientation); a JPEG key is a 2-tuple, so the key spaces
            # never collide
            d = d0 if d0 is not None else A.new_decoder(buf, device="cpu")
            hdr = d.header()
            key = ("still", type(d).__name__, int(hdr.width),
                   int(hdr.height), int(hdr.channels), int(hdr.orientation))

            def build():
                return still_cls(buf, self.dst_w, self.dst_h, **kw)
        pipe = self._pipes.get(key)
        if pipe is None:
            metrics.incr("serving.geometry_compiles")
            # build BEFORE evicting: a refused source (exotic subsampling,
            # distinct chroma tables) must not cost a hot signature its
            # pipeline
            pipe = build()
            if len(self._pipes) >= self.max_geometries:
                self._pipes.popitem(last=False)
                metrics.incr("serving.geometry_evictions")
        else:
            self._pipes.pop(key)
            metrics.incr("serving.geometry_hits")
        self._pipes[key] = pipe  # the most recently used position
        return pipe

    def stats(self) -> dict:
        """The LRU's size and the process-global build/hit/eviction
        counters (utils.metrics)."""
        from .utils import metrics
        snap = metrics.snapshot()["counters"]
        return {
            "geometries_cached": len(self._pipes),
            "max_geometries": self.max_geometries,
            "compiles": int(snap.get("serving.geometry_compiles", 0)),
            "hits": int(snap.get("serving.geometry_hits", 0)),
            "evictions": int(snap.get("serving.geometry_evictions", 0)),
        }

    def warm(self, specs, anim_lane_buckets=None) -> dict:
        """Build (and run once) the pipelines of an expected signature set
        before traffic arrives. Each spec is a sample image (bytes), a
        JPEG geometry tuple (width, height[, subsampling[, gray]]) warmed
        through codecs.jpeg.synthetic_jpeg, or a still tuple ("png" or
        "webp", width, height[, channels]) warmed through a zero-pixel
        PNG or lossless WebP.
        Animated specs run every lane bucket of the cross-animation batch
        ({1} and _anim_bucket of 2..32 lanes, dp multiples with a mesh) unless
        anim_lane_buckets names some. Raises ValueError when the specs
        outnumber max_geometries (the LRU would evict earlier ones).
        Returns {"warmed": n, "compiled_new": n_new, "seconds": s}."""
        specs = list(specs)
        if len(specs) > self.max_geometries:
            raise ValueError(
                f"warm set of {len(specs)} geometries exceeds "
                f"max_geometries={self.max_geometries}: earlier entries "
                "would be LRU-evicted during warming; raise "
                "max_geometries to cover the expected set")
        if anim_lane_buckets is None:
            anim_lane_buckets = sorted(
                {1} | {_anim_bucket(k, self.mesh)
                       for k in range(2, _MAX_ANIM_LANES + 1)})
        t0 = time.time()
        before = len(self._pipes)
        for spec in specs:
            if isinstance(spec, (bytes, bytearray)):
                buf = bytes(spec)
            elif isinstance(spec[0], str):
                buf = _synthetic_still(*spec)
            else:
                buf = J.synthetic_jpeg(*spec)
            pipe = self._pipe_for(buf)
            if isinstance(pipe, AnimatedTranscodePipeline):
                for b in anim_lane_buckets:
                    pipe.transcode([buf] * b)
            else:
                pipe.transcode([buf])
        return {"warmed": len(specs),
                "compiled_new": len(self._pipes) - before,
                "seconds": round(time.time() - t0, 3)}

    def transcode(self, bufs: Sequence[bytes],
                  return_exceptions: bool = False,
                  stage_times: Optional[Dict[tuple, Dict[str, List[float]]]]
                  = None) -> List[bytes]:
        """Group by signature, batch each group, restore the input order.

        Per-item failures are isolated end to end: a buffer that fails
        routing (unrecognized or unported format, unsupported layout,
        header parse failure: anything _pipe_for raises) or fails inside
        its group (every group runs with return_exceptions=True) affects
        only its own slot. With return_exceptions=True the failing slots
        hold the exceptions; with the default False the first failure
        re-raises after every healthy item finished.

        stage_times, when a dict, maps each group's request indices (a
        tuple, in input order) to the stage times its pipeline's
        transcode recorded (stage_times= of the pipelines)."""
        from .utils import metrics
        groups: Dict[int, tuple] = {}
        errors: Dict[int, Exception] = {}
        routing_failures = 0
        for i, buf in enumerate(bufs):
            try:
                pipe = self._pipe_for(buf)
            except Exception as e:  # noqa: BLE001 -- isolate per item
                errors[i] = e
                routing_failures += 1
                continue
            groups.setdefault(id(pipe), (pipe, []))[1].append(i)
        out: List[Optional[bytes]] = [None] * len(bufs)
        for pipe, idxs in groups.values():
            times = (None if stage_times is None
                     else stage_times.setdefault(tuple(idxs), {}))
            results = pipe.transcode([bufs[i] for i in idxs],
                                     return_exceptions=True,
                                     stage_times=times)
            for i, r in zip(idxs, results):
                if isinstance(r, Exception):
                    errors[i] = r
                else:
                    out[i] = r
        if routing_failures:
            # the groups count their own failures
            metrics.incr("serving.poison_isolated", routing_failures)
        if errors and not return_exceptions:
            raise errors[min(errors)]
        for i, e in errors.items():
            out[i] = e  # type: ignore[assignment]
        return out  # type: ignore[return-value]
