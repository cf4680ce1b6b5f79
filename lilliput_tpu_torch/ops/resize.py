"""Matmul-form INTER_AREA resize of the fused serving tail (torch).

The subset of ``lilliput_tpu/ops/resize.py`` the JPEG Fit slice runs: the
per-axis AREA matrices (decimation taps when downscaling, cv::resize's
area-rule bilinear when any axis upscales), the Fit crop folded into them
(``area_matrix_embedded``), and the banded contraction that reads only each
64-output-row group's source window. The numpy tables are built by the same
code as the JAX package's, so they are equal bit for bit; the contractions
are ``torch.matmul`` over the same slabs, in f32. Slabs live on the
plane's device and are built once per geometry.

Accuracy: within ±1 u8 of the bit-exact streaming resize (the reference's
own tier for this form — matmul partial sums reassociate cv::resize's
sequential taps). The streaming and exact forms are not ported yet
(ROADMAP queue 1).
"""

from __future__ import annotations

import functools
from typing import List, Tuple, Union

import numpy as np
import torch

from . import resize_tables as T
from ._matmul import matmul

AREA = "area"


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

