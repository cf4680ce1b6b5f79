"""OpenCV-compatible INTER_AREA resize of the JPEG Fit slice (torch).

The subset of ``lilliput_tpu/ops/resize.py`` the slice runs:

* the streaming ``resize(img, dst_w, dst_h, AREA)`` of (..., H, W, C)
  images, bit-exact to cv::resize (the grayscale oriented tail): the
  integer-factor path, the fractional decimation path with gathers and
  sequential taps, each product rounded to f32 as cv::resize rounds it,
  and the upscale's Q11 fixed-point bilinear with area coordinates;
* the matmul form (the colour tails): the per-axis AREA matrices
  (decimation taps when downscaling, cv::resize's area-rule bilinear when
  any axis upscales), the Fit crop folded into them
  (``area_matrix_embedded``), and the banded contraction that reads only
  each 64-output-row group's source window; ``resize_area_mxu`` and its
  planes form, the default branch of the JAX ``resize_area_mxu_or_exact``.

The numpy tables are built by the same code as the JAX package's, so they
are equal bit for bit; the contractions are ``torch.matmul`` over the same
slabs, in f32. Slabs live on the plane's device and are built once per
geometry. Eager torch never fuses a separate multiply and add, so the
streaming path keeps cv::resize's product rounding without the JAX
package's guard against XLA's FMA contraction (``_rounded_product``).

Accuracy of the matmul form: within ±1 u8 of the bit-exact streaming
resize (the reference's own tier for this form — matmul partial sums
reassociate cv::resize's sequential taps). LINEAR and CUBIC as methods and
the ``LILLIPUT_FUSED_EXACT`` forms are not ported yet (ROADMAP queue 1).
"""

from __future__ import annotations

import functools
from typing import List, Tuple, Union

import numpy as np
import torch

from . import resize_tables as T
from ._matmul import matmul

AREA = "area"
LINEAR = "linear"
CUBIC = "cubic"


def _index(idx: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(idx, np.int64)).to(device)


def _take_w(img: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    return torch.index_select(img, -2, _index(idx, img.device))


def _take_h(img: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    return torch.index_select(img, -3, _index(idx, img.device))


def _col(a: np.ndarray, device, ndim: int) -> torch.Tensor:
    """Per-output table `a` on `device`, shaped to broadcast along the axis
    ndim-from-the-end of a (..., H, W, C) image (ndim 2: W, ndim 3: H)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device).reshape(
        (-1,) + (1,) * (ndim - 1))


# ---------------------------------------------------------------------------
# streaming INTER_AREA (bit-exact to cv::resize)
# ---------------------------------------------------------------------------

def _linear_u8(img: torch.Tensor, dst_w: int, dst_h: int,
               area_mode: bool) -> torch.Tensor:
    """cv::resize's fixed-point Q11 bilinear (8U), the INTER_AREA upscale
    when area_mode: x edge coefficients clamped, y fractions kept with the
    row indices clipped at the gather (resize_tables._linear_coords)."""
    src_h, src_w = img.shape[-3], img.shape[-2]
    sx, ax0, ax1 = T.linear_tables(src_w, dst_w, area_mode, clamp=True)
    sy, ay0, ay1 = T.linear_tables(src_h, dst_h, area_mode, clamp=False)
    sx_r = np.minimum(sx + 1, src_w - 1)
    sy0 = np.clip(sy, 0, src_h - 1)
    sy1 = np.clip(sy + 1, 0, src_h - 1)
    dev = img.device
    s = img.to(torch.int32)
    h = (_take_w(s, sx) * _col(ax0, dev, 2)
         + _take_w(s, sx_r) * _col(ax1, dev, 2))
    s0, s1 = _take_h(h, sy0), _take_h(h, sy1)
    b0, b1 = _col(ay0, dev, 3), _col(ay1, dev, 3)
    # VResizeLinear 8U: uchar((((b0*(S0>>4))>>16) + ((b1*(S1>>4))>>16) + 2) >> 2)
    out = (((b0 * (s0 >> 4)) >> 16) + ((b1 * (s1 >> 4)) >> 16) + 2) >> 2
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


@functools.lru_cache(maxsize=64)
def _area_taps(src: int, dst: int, device: str):
    """area_tables(src, dst) resident on `device`, one (indices, weights)
    pair per tap, uploaded once per geometry: a fresh upload from pageable
    memory would make the host wait for the device's queue at every tap."""
    idx, w = T.area_tables(src, dst)
    d = torch.device(device)
    return [(_index(idx[:, k], d), torch.from_numpy(w[:, k].copy()).to(d))
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
    if is_u8:
        return _linear_u8(img, dst_w, dst_h, area_mode=True)
    raise NotImplementedError(
        "float INTER_AREA upscale (resize._linear_f32) is not ported to "
        "lilliput_tpu_torch yet (ROADMAP queue 1, item 4.6)")


def resize(img: torch.Tensor, dst_w: int, dst_h: int,
           method: str = AREA) -> torch.Tensor:
    """Resize (..., H, W, C) to (..., dst_h, dst_w, C) with OpenCV
    semantics. INTER_AREA only: LINEAR and CUBIC raise NotImplementedError
    (ROADMAP queue 1, item 4.6)."""
    src_h, src_w = img.shape[-3], img.shape[-2]
    if (src_w, src_h) == (dst_w, dst_h):
        return img
    if method == AREA:
        return _area(img, dst_w, dst_h)
    if method in (LINEAR, CUBIC):
        raise NotImplementedError(
            f"resize method {method!r} is not ported to lilliput_tpu_torch "
            "yet (ROADMAP queue 1, item 4.6)")
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


@functools.lru_cache(maxsize=64)
def _embedded_banded(window: int, off: int, length: int, dst: int,
                     force_linear: bool, device: str) -> Banded:
    """Device-resident slabs of area_matrix_embedded, built once per
    geometry and device."""
    return to_banded(area_matrix_embedded(window, off, length, dst,
                                          force_linear), torch.device(device))


def resize_area_plane_embedded(plane: torch.Tensor, off_x: int, w: int,
                               dst_w: int, off_y: int, h: int,
                               dst_h: int) -> torch.Tensor:
    """The fused tail's plane resize with the crop [off_y:off_y+h,
    off_x:off_x+w) folded into the AREA matrices (±1 tier vs streaming).
    The JAX package's LILLIPUT_FUSED_EXACT form is not ported yet."""
    lin = dst_w > w or dst_h > h           # cv: any upscale -> all bilinear
    dev = str(plane.device)
    return resize_area_plane_mat(
        plane,
        _embedded_banded(plane.shape[-1], off_x, w, dst_w, lin, dev),
        _embedded_banded(plane.shape[-2], off_y, h, dst_h, lin, dev))


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
    out = resize_area_plane_embedded(plane, 0, src_w, dst_w, 0, src_h, dst_h)
    if plane.dtype == torch.uint8:
        return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
    return out


def resize_area_mxu(img: torch.Tensor, dst_w: int, dst_h: int) -> torch.Tensor:
    """INTER_AREA resize of (..., H, W, C) as matrix contractions (no
    gathers), within ±1 u8 of the streaming ``resize``: each channel
    through resize_area_mxu_planes. The JAX ``resize_area_mxu_or_exact``
    calls this unless LILLIPUT_FUSED_EXACT is set, which the port does not
    read yet (ROADMAP queue 1, item 4.8)."""
    return resize_area_mxu_planes(img.movedim(-1, 0), dst_w,
                                  dst_h).movedim(0, -1)
