"""OpenCV-compatible resize of the JPEG Fit slice (torch).

The port of ``lilliput_tpu/ops/resize.py``'s serving half:

* the streaming ``resize(img, dst_w, dst_h, method)`` of (..., H, W, C)
  images with cv::resize's semantics: INTER_AREA bit-exact (the
  integer-factor path, the fractional decimation path with gathers and
  sequential taps, each product rounded to f32 as cv::resize rounds it,
  and the upscale's Q11 fixed-point bilinear with area coordinates);
  INTER_LINEAR bit-exact (Q11 fixed point for u8); INTER_CUBIC bit-exact
  to OpenCV's portable fixed-point kernel for u8 (``_cubic_u8``); float
  inputs through the f32 separable forms;
* the matmul form (the colour tails): the per-axis AREA matrices
  (decimation taps when downscaling, cv::resize's area-rule bilinear when
  any axis upscales), the Fit crop folded into them
  (``area_matrix_embedded``), the general-position matrices of the direct
  and scaled modes (``area_axis_matrix_scaled``), and the banded
  contraction that reads only each 64-output-row group's source window;
  ``resize_area_mxu`` and its planes form;
* the ``LILLIPUT_FUSED_EXACT`` tier: with the variable set, the fused
  tails (``resize_area_plane_embedded``, ``resize_area_mxu_or_exact_planes``)
  take the sequential-tap forms, byte-identical to crop + streaming AREA.

The numpy tables are built by the same code as the JAX package's, so they
are equal bit for bit; the contractions are ``torch.matmul`` over the same
slabs, in f32. Tables and slabs live on the image's device and are built
once per geometry. Eager torch never fuses a separate multiply and add, so
the AREA taps keep cv::resize's product rounding without the JAX package's
guard against XLA's FMA contraction (``_rounded_product``); where the JAX
function has no guard (the f32 LINEAR and CUBIC forms), XLA:CPU fuses the
first product of each ``a*x + b*y`` and the port writes that fusion out
(``_fma``).

Accuracy of the matmul form: within ±1 u8 of the bit-exact streaming
resize (the reference's own tier for this form — matmul partial sums
reassociate cv::resize's sequential taps).
"""

from __future__ import annotations

import functools
import os
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from . import resize_tables as T
from ._matmul import matmul

AREA = "area"
LINEAR = "linear"
CUBIC = "cubic"


def _index(idx: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(idx, np.int64)).to(device)


def _table(a: np.ndarray, device) -> torch.Tensor:
    """A per-output weight table on `device`, dtype kept (f32, or the Q11
    tables' int32: an int64 weight would promote the fixed-point sums)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _along(w: torch.Tensor, axis: int) -> torch.Tensor:
    """Per-output table `w` shaped to broadcast along `axis` (-2: W, -3: H)
    of a (..., H, W, C) image."""
    return w.reshape((-1,) + (1,) * (-axis - 1))


def _fma(x: torch.Tensor, w: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 x*w + c rounded ONCE, as XLA:CPU fuses the first product of an
    ``a*x + b*y`` (the f32 product is exact in f64; see
    jpeg_kernels._fma)."""
    return (x.double() * w.double() + c.double()).float()


@functools.lru_cache(maxsize=512)
def _linear_taps(src: int, dst: int, area_mode: bool, clamp: bool,
                 q11: bool, device: str):
    """Bilinear tables on `device`, uploaded once per geometry: (left
    index, right index, left weight, right weight). The indices are
    clipped to the source (the y rule keeps its true fractions and clips
    at the gather; the clamped x rule's indices are in range already);
    q11 picks the 8U fixed-point weights, else f32."""
    tables = T.linear_tables if q11 else T.linear_tables_f32
    s, a0, a1 = tables(src, dst, area_mode, clamp)
    d = torch.device(device)
    return (_index(np.clip(s, 0, src - 1), d),
            _index(np.clip(s + 1, 0, src - 1), d), _table(a0, d),
            _table(a1, d))


@functools.lru_cache(maxsize=512)
def _cubic_taps(src: int, dst: int, q11: bool, device: str):
    """The 4 bicubic taps on `device` as [(indices, weights)], f32 or the
    8U path's Q11 int32 weights, uploaded once per geometry."""
    idx, w = (T.cubic_tables_q11 if q11 else T.cubic_tables)(src, dst)
    d = torch.device(device)
    return [(_index(idx[:, k], d), _table(w[:, k], d)) for k in range(4)]


# ---------------------------------------------------------------------------
# streaming INTER_LINEAR / INTER_CUBIC / INTER_AREA (bit-exact to cv::resize)
# ---------------------------------------------------------------------------

def _linear_pass(img: torch.Tensor, taps, axis: int, fused: bool):
    i0, i1, a0, a1 = taps
    g0 = torch.index_select(img, axis, i0)
    p1 = torch.index_select(img, axis, i1) * _along(a1, axis)
    if fused:
        return _fma(g0, _along(a0, axis), p1)
    return g0 * _along(a0, axis) + p1


def _linear_u8(img: torch.Tensor, dst_w: int, dst_h: int,
               area_mode: bool) -> torch.Tensor:
    """cv::resize's fixed-point Q11 bilinear (8U), the INTER_AREA upscale
    when area_mode: x edge coefficients clamped, y fractions kept with the
    row indices clipped at the gather (resize_tables._linear_coords)."""
    src_h, src_w = img.shape[-3], img.shape[-2]
    dev = str(img.device)
    h = _linear_pass(img.to(torch.int32), _linear_taps(
        src_w, dst_w, area_mode, True, True, dev), -2, False)
    i0, i1, b0, b1 = _linear_taps(src_h, dst_h, area_mode, False, True, dev)
    s0, s1 = torch.index_select(h, -3, i0), torch.index_select(h, -3, i1)
    b0, b1 = _along(b0, -3), _along(b1, -3)
    # VResizeLinear 8U: uchar((((b0*(S0>>4))>>16) + ((b1*(S1>>4))>>16) + 2) >> 2)
    out = (((b0 * (s0 >> 4)) >> 16) + ((b1 * (s1 >> 4)) >> 16) + 2) >> 2
    return torch.clamp(out, 0, 255).to(torch.uint8)


def _linear_f32(img: torch.Tensor, dst_w: int, dst_h: int,
                area_mode: bool) -> torch.Tensor:
    """The float bilinear: cv's unquantized f32 coefficients, each pass
    ``fma(g0, a0, g1*a1)`` as XLA:CPU compiles the JAX function."""
    src_h, src_w = img.shape[-3], img.shape[-2]
    dev = str(img.device)
    h = _linear_pass(img.to(torch.float32), _linear_taps(
        src_w, dst_w, area_mode, True, False, dev), -2, True)
    return _linear_pass(h, _linear_taps(src_h, dst_h, area_mode, False,
                                        False, dev), -3, True)


def _cubic(img: torch.Tensor, dst_w: int, dst_h: int) -> torch.Tensor:
    """The float32 separable bicubic: per pass (t0 + t1) + (t2 + t3) of the
    4 weighted taps, with the first product of each pair fused as XLA:CPU
    compiles the JAX function."""
    src_h, src_w = img.shape[-3], img.shape[-2]
    dev = str(img.device)

    def pass_(arr, taps, axis):
        g = [(torch.index_select(arr, axis, i), _along(w, axis))
             for i, w in taps]
        return (_fma(*g[0], g[1][0] * g[1][1])
                + _fma(*g[2], g[3][0] * g[3][1]))

    h = pass_(img.to(torch.float32), _cubic_taps(src_w, dst_w, False, dev),
              -2)
    return pass_(h, _cubic_taps(src_h, dst_h, False, dev), -3)


def _cubic_u8(img: torch.Tensor, dst_w: int, dst_h: int) -> torch.Tensor:
    """OpenCV's PORTABLE scalar fixed-point 8U cubic (the JAX package's
    _cubic_u8 says why this kernel is the target): Q11 coefficients in both
    passes, int32 accumulation with two's-complement wrap (every operand
    stays int32), and FixedPtCast<int,uchar,22>: (acc + (1<<21)) >> 22,
    saturated."""
    src_h, src_w = img.shape[-3], img.shape[-2]
    dev = str(img.device)

    def pass_(arr, taps, axis):
        acc = None
        for i, w in taps:
            p = torch.index_select(arr, axis, i) * _along(w, axis)
            acc = p if acc is None else acc + p
        return acc

    h = pass_(img.to(torch.int32), _cubic_taps(src_w, dst_w, True, dev), -2)
    acc = pass_(h, _cubic_taps(src_h, dst_h, True, dev), -3)
    out = (acc + (1 << 21)) >> 22
    return torch.clamp(out, 0, 255).to(torch.uint8)


def _area_fast_sum(img: torch.Tensor, dst_w: int, dst_h: int, dtype):
    src_h, src_w = img.shape[-3], img.shape[-2]
    fx, fy = src_w // dst_w, src_h // dst_h
    lead = tuple(img.shape[:-3])
    v = img.reshape(lead + (dst_h, fy, dst_w, fx, img.shape[-1]))
    return v.to(dtype).sum(dim=(-2, -4), dtype=dtype), fx, fy


def _area_fast_u8(img: torch.Tensor, dst_w: int, dst_h: int) -> torch.Tensor:
    total, fx, fy = _area_fast_sum(img, dst_w, dst_h, torch.int32)
    if fx == 2 and fy == 2:
        out = (total + 2) >> 2  # ResizeAreaFastVec 2x2 specialization
        return torch.clamp(out, 0, 255).to(torch.uint8)
    scale = float(np.float32(1.0 / (fx * fy)))
    out = torch.round(total.to(torch.float32) * scale)
    return torch.clamp(out, 0, 255).to(torch.uint8)


def _area_fast_f32(img: torch.Tensor, dst_w: int, dst_h: int) -> torch.Tensor:
    total, fx, fy = _area_fast_sum(img, dst_w, dst_h, torch.float32)
    return total * float(np.float32(1.0 / (fx * fy)))


@functools.lru_cache(maxsize=256)
def _area_taps(src: int, dst: int, device: str):
    """area_tables(src, dst) resident on `device`, one (indices, weights)
    pair per tap, uploaded once per geometry: a fresh upload from pageable
    memory would make the host wait for the device's queue at every tap."""
    idx, w = T.area_tables(src, dst)
    d = torch.device(device)
    return [(_index(idx[:, k], d), _table(w[:, k], d))
            for k in range(idx.shape[1])]


def _area_general(img: torch.Tensor, dst_w: int, dst_h: int,
                  round_u8: bool) -> torch.Tensor:
    """Fractional INTER_AREA decimation: gathers and sequential taps in
    cv::resize's f32 order, each product rounded before its add (the
    multiply and the add are separate torch ops: never addcmul or a
    compiled fusion, which would contract them into one FMA)."""
    src_h, src_w = img.shape[-3], img.shape[-2]
    s = img.to(torch.float32)
    dev = str(s.device)
    h = torch.zeros(s.shape[:-2] + (dst_w, s.shape[-1]), dtype=torch.float32,
                    device=s.device)
    for idx, w in _area_taps(src_w, dst_w, dev):
        h = h + torch.index_select(s, -2, idx) * w[:, None]
    out = torch.zeros(h.shape[:-3] + (dst_h,) + h.shape[-2:],
                      dtype=torch.float32, device=s.device)
    for idx, w in _area_taps(src_h, dst_h, dev):
        out = out + torch.index_select(h, -3, idx) * w[:, None, None]
    if round_u8:
        return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
    return out


def _area(img: torch.Tensor, dst_w: int, dst_h: int) -> torch.Tensor:
    src_h, src_w = img.shape[-3], img.shape[-2]
    is_u8 = img.dtype == torch.uint8
    if src_w >= dst_w and src_h >= dst_h:
        if T.area_is_fast(src_w, src_h, dst_w, dst_h):
            return (_area_fast_u8 if is_u8 else _area_fast_f32)(
                img, dst_w, dst_h)
        return _area_general(img, dst_w, dst_h, is_u8)
    # cv::resize: INTER_AREA with any upscaling axis falls back to bilinear
    # with the area-specific coordinate rule.
    return (_linear_u8 if is_u8 else _linear_f32)(img, dst_w, dst_h,
                                                  area_mode=True)


def resize(img: torch.Tensor, dst_w: int, dst_h: int,
           method: str = AREA) -> torch.Tensor:
    """Resize (..., H, W, C) to (..., dst_h, dst_w, C) with OpenCV
    semantics: AREA, LINEAR or CUBIC; u8 images through the fixed-point
    kernels, other dtypes through the f32 forms."""
    src_h, src_w = img.shape[-3], img.shape[-2]
    if (src_w, src_h) == (dst_w, dst_h):
        return img
    is_u8 = img.dtype == torch.uint8
    if method == AREA:
        return _area(img, dst_w, dst_h)
    if method == LINEAR:
        return (_linear_u8 if is_u8 else _linear_f32)(img, dst_w, dst_h,
                                                      area_mode=False)
    if method == CUBIC:
        return (_cubic_u8 if is_u8 else _cubic)(img, dst_w, dst_h)
    raise ValueError(f"unknown resize method {method!r}")


# ---------------------------------------------------------------------------
# matmul-form INTER_AREA (the fused serving tails)
# ---------------------------------------------------------------------------


def _area_axis_matrix(src: int, dst: int,
                      force_linear: bool = False) -> np.ndarray:
    """(dst, src) f32 resampling matrix for one axis with INTER_AREA taps
    (decimation taps when downscaling, area-rule bilinear when upscaling).

    force_linear: cv::resize switches the WHOLE resize to bilinear when
    ANY axis upscales — callers building a mixed up/down geometry must
    pass True for the downscaling axis too."""
    m = np.zeros((dst, src), np.float32)
    if src >= dst and not force_linear:
        idx, w = T.area_tables(src, dst)
        for d in range(dst):
            for k in range(idx.shape[1]):
                m[d, idx[d, k]] += w[d, k]
    else:
        sx, a0, a1 = T.linear_tables_f32(src, dst, area_mode=True, clamp=True)
        sxr = np.minimum(sx + 1, src - 1)
        for d in range(dst):
            m[d, sx[d]] += a0[d]
            m[d, sxr[d]] += a1[d]
    return m


_BAND_GROUP = 64  # output rows per banded-contraction slab


def _banded_groups(mat: np.ndarray, group: int = _BAND_GROUP):
    """Split a banded (dst, src) axis matrix into per-output-group slabs
    covering only each group's nonzero source window. Returns
    [(src_lo, src_hi, slab)] in output order; None when banding would not
    shrink the contraction (e.g. near-dense matrices)."""
    dst, src = mat.shape
    groups = []
    total = 0
    for g0 in range(0, dst, group):
        rows = mat[g0:min(g0 + group, dst)]
        nz = np.nonzero(rows.any(axis=0))[0]
        lo, hi = int(nz[0]), int(nz[-1]) + 1
        groups.append((lo, hi, np.ascontiguousarray(rows[:, lo:hi])))
        total += (hi - lo) * rows.shape[0]
    if total >= 0.75 * dst * src:
        return None
    return groups


#: a (dst, src) axis matrix on a device: banded slabs [(lo, hi, slab)], or
#: the dense matrix when banding does not pay
Banded = Union[List[Tuple[int, int, torch.Tensor]], torch.Tensor]


def to_banded(mat: np.ndarray, device) -> Banded:
    groups = _banded_groups(mat)
    if groups is None:
        return torch.from_numpy(mat).to(device)
    return [(lo, hi, torch.from_numpy(slab).to(device))
            for lo, hi, slab in groups]


def _banded_plane_contract(s: torch.Tensor, mat: Banded,
                           axis: int) -> torch.Tensor:
    """Banded contraction of `axis` (-2=h, -1=w) of a (..., h, w) f32 plane:
    "...hw,Ww->...hW" (axis -1) or "...hw,Hh->...Hw" (axis -2), each
    64-output-row group reading only its source window."""

    def one(x, m):
        return (matmul(x, m.transpose(0, 1)) if axis == -1
                else matmul(m, x))

    if isinstance(mat, torch.Tensor):
        return one(s, mat)
    return torch.cat([one(s.narrow(axis, lo, hi - lo), slab)
                      for lo, hi, slab in mat], dim=axis)


def resize_area_plane_mat(plane: torch.Tensor, mat_w: Banded,
                          mat_h: Banded) -> torch.Tensor:
    """Contract a (..., H, W) plane holding EXACT u8 values (u8 or f32
    storage) with per-axis AREA matrices on the plane's device (to_banded):
    the W axis first, then H. Returns f32; the caller rounds and clips."""
    out = _banded_plane_contract(plane.to(torch.float32), mat_w, axis=-1)
    return _banded_plane_contract(out, mat_h, axis=-2)


def area_matrix_embedded(window: int, off: int, length: int, dst: int,
                         force_linear: bool = False) -> np.ndarray:
    """(dst, window) AREA axis matrix with the crop [off, off+length) folded
    in: crop-then-resize collapses into ONE contraction (columns outside the
    crop get weight 0). Pass force_linear=True for BOTH axes when the OTHER
    axis upscales (cv's joint mode switch)."""
    m = np.zeros((dst, window), np.float32)
    m[:, off:off + length] = _area_axis_matrix(length, dst, force_linear)
    return m


@functools.lru_cache(maxsize=256)
def _embedded_banded(window: int, off: int, length: int, dst: int,
                     force_linear: bool, device: str) -> Banded:
    """Device-resident slabs of area_matrix_embedded, built once per
    geometry and device."""
    return to_banded(area_matrix_embedded(window, off, length, dst,
                                          force_linear), torch.device(device))


def area_axis_matrix_scaled(src: int, dst: int, scale: float,
                            offset: float) -> np.ndarray:
    """(dst, src) INTER_AREA matrix for a dst grid whose sample d covers the
    source interval [offset + d*scale, offset + (d+1)*scale): the general-
    position form of the YCbCr-direct mode, where a chroma plane (or a
    dct_scale-reduced luma plane) is resampled at its own resolution with
    a possibly fractional crop offset."""
    m = np.zeros((dst, src), np.float64)
    inv = 1.0 / scale
    for d in range(dst):
        a = offset + d * scale
        b = a + scale
        for k in range(max(int(np.floor(a)), 0),
                       min(int(np.ceil(b)), src)):
            ov = min(b, k + 1.0) - max(a, float(k))
            if ov > 0:
                m[d, k] = ov * inv
    return m.astype(np.float32)


@functools.lru_cache(maxsize=256)
def scaled_banded(src: int, dst: int, scale: float, offset: float,
                  device: str) -> Banded:
    """Device-resident slabs of area_axis_matrix_scaled, built once per
    geometry and device (the Python loops and the upload would otherwise
    run at every step)."""
    return to_banded(area_axis_matrix_scaled(src, dst, scale, offset),
                     torch.device(device))


def _resize_area_plane_matrices(plane: torch.Tensor, off_x: int, w: int,
                                dst_w: int, off_y: int, h: int,
                                dst_h: int) -> torch.Tensor:
    """The embedded-matrix contraction of the crop (±1 tier vs
    streaming)."""
    lin = dst_w > w or dst_h > h           # cv: any upscale -> all bilinear
    dev = str(plane.device)
    return resize_area_plane_mat(
        plane,
        _embedded_banded(plane.shape[-1], off_x, w, dst_w, lin, dev),
        _embedded_banded(plane.shape[-2], off_y, h, dst_h, lin, dev))


def resize_area_plane_embedded(plane: torch.Tensor, off_x: int, w: int,
                               dst_w: int, off_y: int, h: int,
                               dst_h: int) -> torch.Tensor:
    """The fused tails' plane resize of the crop [off_y:off_y+h,
    off_x:off_x+w): the exact forms when LILLIPUT_FUSED_EXACT is set
    (byte-identical to streaming: downscales by sequential taps, upscaling
    geometries by the integer bilinear), else the crop folded into the
    AREA matrices (±1 tier vs streaming). Returns f32; the caller rounds
    and clips."""
    if _fused_exact_enabled():
        if w < dst_w or h < dst_h:
            return resize_linear_window_exact_u8(plane, off_x, w, dst_w,
                                                 off_y, h, dst_h)
        out = resize_area_window_exact(plane, off_x, w, dst_w, off_y, h,
                                       dst_h)
        if out is not None:
            return out
    return _resize_area_plane_matrices(plane, off_x, w, dst_w, off_y, h,
                                       dst_h)


def resize_area_mxu_planes(plane: torch.Tensor, dst_w: int,
                           dst_h: int) -> torch.Tensor:
    """resize_area_mxu of (..., H, W) planes: the integer-factor streaming
    path when both axes shrink by whole factors, else the two banded AREA
    contractions (the uncropped embedded matrices); u8 planes come back
    rounded and clipped to u8, float planes as f32."""
    src_h, src_w = plane.shape[-2], plane.shape[-1]
    if (src_w, src_h) == (dst_w, dst_h):
        return plane
    if (src_w >= dst_w and src_h >= dst_h
            and T.area_is_fast(src_w, src_h, dst_w, dst_h)):
        fast = _area_fast_u8 if plane.dtype == torch.uint8 else _area_fast_f32
        return fast(plane[..., None], dst_w, dst_h)[..., 0]
    out = _resize_area_plane_matrices(plane, 0, src_w, dst_w, 0, src_h,
                                      dst_h)
    if plane.dtype == torch.uint8:
        return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
    return out


def resize_area_mxu(img: torch.Tensor, dst_w: int, dst_h: int) -> torch.Tensor:
    """INTER_AREA resize of (..., H, W, C) as matrix contractions (no
    gathers), within ±1 u8 of the streaming ``resize``: each channel
    through resize_area_mxu_planes."""
    return resize_area_mxu_planes(img.movedim(-1, 0), dst_w,
                                  dst_h).movedim(0, -1)


def resize_area_mxu_or_exact_planes(plane: torch.Tensor, dst_w: int,
                                    dst_h: int) -> torch.Tensor:
    """The JAX ``resize_area_mxu_or_exact`` of (..., H, W) planes (the
    oriented colour tail): with LILLIPUT_FUSED_EXACT set, the exact forms'
    f32 values (integer bilinear when an axis upscales, else sequential
    taps; NOT rounded, as the JAX function returns them), else
    resize_area_mxu_planes. The exact forms are per channel, so a plane
    gives the values of its channel in the interleaved form."""
    if _fused_exact_enabled():
        img = plane[..., None]
        if plane.shape[-1] < dst_w or plane.shape[-2] < dst_h:
            return resize_linear_exact_u8(img, dst_w, dst_h)[..., 0]
        out = resize_area_exact(img, dst_w, dst_h)
        if out is not None:
            return out[..., 0]
    return resize_area_mxu_planes(plane, dst_w, dst_h)


def resize_area_mxu_or_exact(img: torch.Tensor, dst_w: int,
                             dst_h: int) -> torch.Tensor:
    """The JAX ``resize_area_mxu_or_exact`` of (..., H, W, C) images (the
    still tail): each channel through resize_area_mxu_or_exact_planes."""
    return resize_area_mxu_or_exact_planes(img.movedim(-1, 0), dst_w,
                                           dst_h).movedim(0, -1)


# ---------------------------------------------------------------------------
# LILLIPUT_FUSED_EXACT: the byte-identical forms of the fused tails
# ---------------------------------------------------------------------------


def _fused_exact_enabled() -> bool:
    """LILLIPUT_FUSED_EXACT (any value but 0/false/off) switches the fused
    serving tails from the embedded-matrix AREA contraction (±1 u8 vs
    streaming) to the exact forms below, byte-identical to crop +
    streaming resize(AREA). Read at every call: eager torch has no trace
    to bake it into."""
    return os.environ.get("LILLIPUT_FUSED_EXACT", "0") not in (
        "0", "false", "off")


def resize_area_exact(img: torch.Tensor, dst_w: int,
                      dst_h: int) -> Optional[torch.Tensor]:
    """INTER_AREA downscale of (..., H, W, C), byte-identical to the
    streaming ``resize(img, ..., AREA)``, as f32 whose clip(round(.)) is
    the streaming u8: the streaming path's own plain gathers and sequential
    taps. (The JAX package turns these gathers into 0/1 selection dots, a
    TPU gather workaround the port does not keep.) Integer factors give the
    block totals times 1/(fx*fy), or the 2x2 specialization's final
    integer floor((tot + 2) / 4). None when an axis upscales, or when the
    block totals could pass 2^24 (fx*fy*255 >= 2^24), where the JAX form
    stops being exact and declines to the ±1 matrix form."""
    src_h, src_w = img.shape[-3], img.shape[-2]
    if src_w < dst_w or src_h < dst_h:
        return None
    if T.area_is_fast(src_w, src_h, dst_w, dst_h):
        fx, fy = src_w // dst_w, src_h // dst_h
        if fx * fy * 255 >= 1 << 24:
            return None
        tot, _, _ = _area_fast_sum(img, dst_w, dst_h, torch.float32)
        if fx == 2 and fy == 2:
            return torch.floor((tot + 2.0) * 0.25)
        return tot * float(np.float32(1.0 / (fx * fy)))
    return _area_general(img, dst_w, dst_h, round_u8=False)


def resize_linear_exact_u8(img: torch.Tensor, dst_w: int,
                           dst_h: int) -> torch.Tensor:
    """INTER_AREA of (..., H, W, C) u8-valued images when an axis upscales
    (cv::resize then runs the fixed-point bilinear with area coordinates),
    byte-identical to the streaming ``resize(img, ..., AREA)``: the Q11
    integer kernel by plain gathers (the JAX package's selection dots are
    a TPU workaround). Returns the integers as f32."""
    return _linear_u8(img, dst_w, dst_h, area_mode=True).to(torch.float32)


def resize_area_window_exact(plane: torch.Tensor, off_x: int, w: int,
                             dst_w: int, off_y: int, h: int,
                             dst_h: int) -> Optional[torch.Tensor]:
    """resize_area_exact of the crop [off_y:off_y+h, off_x:off_x+w) of a
    (..., H, W) plane: (..., dst_h, dst_w) f32, or None (an upscaling axis,
    or the 2^24 decline)."""
    crop = plane.narrow(-1, off_x, w).narrow(-2, off_y, h)
    out = resize_area_exact(crop[..., None], dst_w, dst_h)
    return None if out is None else out[..., 0]


def resize_linear_window_exact_u8(plane: torch.Tensor, off_x: int, w: int,
                                  dst_w: int, off_y: int, h: int,
                                  dst_h: int) -> torch.Tensor:
    """resize_linear_exact_u8 of the crop [off_y:off_y+h, off_x:off_x+w)
    of a (..., H, W) u8-valued plane: integer-valued f32 in [0, 255]."""
    crop = plane.narrow(-1, off_x, w).narrow(-2, off_y, h)
    return resize_linear_exact_u8(crop[..., None], dst_w, dst_h)[..., 0]
