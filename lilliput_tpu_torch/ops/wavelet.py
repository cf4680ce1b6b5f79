"""JPEG 2000 wavelet and multi-component transforms (ISO/IEC 15444-1
Annexes F/G), both directions, as torch ops on the input's device.

The counterpart of ``lilliput_tpu/ops/wavelet.py``, which runs them in
host numpy. Here every function takes tensors and runs where they live
(the decoder's or framebuffer's device), with any number of leading
batch axes, so the tile-components of one geometry are synthesized or
analysed in one call. The 5/3 transform is int64 integer lifting, the
9/7 transform float64 lifting; both equal the numpy forms bit for bit:

* each float64 step is written as the numpy source reads it,
  ``x[t] = x[t] + coef * (x[m] + x[p])``: one add, one multiply, one
  add, each its own op (no ``alpha=``, ``addcmul``, ``lerp`` or other
  fused form, which a compiler may contract into an FMA);
* a division by a constant divides by a 0-dim tensor on the device
  (``_div``): PyTorch's CUDA ``div`` by a host scalar multiplies by the
  reciprocal, which is not numpy's quotient;
* ``torch.round`` for ``np.rint`` (both round half to even), integer
  ``>>`` for the floor shifts, ``rounding_mode="trunc"`` for C's
  truncation.

Lifting works on the even and odd samples of an axis as two tensors
(their symmetric-extension neighbours are gathered with cached index
tensors, ``_lift_index``) and interleaves once per level. The phase of
each sample is its ABSOLUTE index's parity (F.3.2), so a transform
depends on a rect's sizes and origin parities only: rects equal up to
such a translation share one call.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

# CDF 9/7 lifting constants (Table F.4)
ALPHA = -1.586134342059924
BETA = -0.052980118572961
GAMMA = 0.882911075530934
DELTA = 0.443506852043971
KK = 1.230174104914001


def _sym_ext_idx(i: np.ndarray, n: int) -> np.ndarray:
    """Symmetric (whole-point) extension indices for a length-n signal."""
    if n == 1:
        return np.zeros_like(i)
    period = 2 * (n - 1)
    j = np.abs(i) % period
    return np.where(j >= n, period - j, j)


@functools.lru_cache(maxsize=512)
def _lift_index(p: int, n: int, device: torch.device):
    """Neighbour indices of a length-n axis whose first sample has
    absolute parity p (n >= 2): for each even-phase sample, the indices
    of its left and right neighbours among the odd-phase samples, and
    for each odd-phase sample its neighbours among the even-phase ones,
    after symmetric extension (_sym_ext_idx)."""
    rel = np.arange(n)
    even = rel[(rel + p) % 2 == 0]
    odd = rel[(rel + p) % 2 == 1]

    def idx(pos, first):
        return torch.from_numpy(
            (_sym_ext_idx(pos, n) - first) // 2).to(device)
    return (idx(even - 1, 1 - p), idx(even + 1, 1 - p),
            idx(odd - 1, p), idx(odd + 1, p))


def _div(a: torch.Tensor, d: float) -> torch.Tensor:
    """a / d rounded as numpy rounds it (see the module docstring)."""
    return torch.div(a, torch.full((), d, dtype=a.dtype, device=a.device))


def _split(x: torch.Tensor, axis: int, p: int):
    """(even-phase, odd-phase) samples of `axis` (views)."""
    lead = (slice(None),) * (x.dim() + axis)
    return x[lead + (slice(p, None, 2),)], x[lead + (slice(1 - p, None, 2),)]


def _pair_sum(t: torch.Tensor, axis: int, im, ip) -> torch.Tensor:
    return t.index_select(axis, im) + t.index_select(axis, ip)


def _synth_1d(lo, hi, axis: int, p: int, n: int, reversible: bool):
    """1D synthesis (F.3.8.2 / F.4.8.2) of an axis of n samples with
    origin parity p, from its even-phase (lo) and odd-phase (hi)
    samples; returns the new (lo, hi)."""
    if n == 0:
        return lo, hi
    if n == 1:
        if p == 0:
            return lo, hi
        # a lone odd-phase sample: OpenJPEG halves it, with C truncation
        # toward zero in the reversible path
        if reversible:
            return lo, torch.div(hi, 2, rounding_mode="trunc")
        return lo, hi * 0.5
    em, ep, om, op = _lift_index(p, n, lo.device)
    if reversible:
        # X(2n) = Y(2n) - floor((Y(2n-1) + Y(2n+1) + 2) / 4)
        lo = lo - ((_pair_sum(hi, axis, em, ep) + 2) >> 2)
        # X(2n+1) = Y(2n+1) + floor((X(2n) + X(2n+2)) / 2)
        hi = hi + (_pair_sum(lo, axis, om, op) >> 1)
        return lo, hi
    lo = lo * KK
    hi = hi * (1.0 / KK)
    # STEP3/4/5/6 of F.4.8.2.1 (synthesis reverses analysis order)
    lo = lo + (-DELTA) * _pair_sum(hi, axis, em, ep)
    hi = hi + (-GAMMA) * _pair_sum(lo, axis, om, op)
    lo = lo + (-BETA) * _pair_sum(hi, axis, em, ep)
    hi = hi + (-ALPHA) * _pair_sum(lo, axis, om, op)
    return lo, hi


def _analyse_1d(lo, hi, axis: int, p: int, n: int, reversible: bool):
    """1D analysis, the exact inverse of _synth_1d; returns the new
    (lo, hi) = (lowpass, highpass) samples."""
    if n == 0:
        return lo, hi
    if n == 1:
        if p == 0:
            return lo, hi
        # inverse of X = trunc(Y / 2) for the lone odd-phase sample
        return lo, hi * (2 if reversible else 2.0)
    em, ep, om, op = _lift_index(p, n, lo.device)
    if reversible:
        # Y(2n+1) = X(2n+1) - floor((X(2n) + X(2n+2)) / 2)
        hi = hi - (_pair_sum(lo, axis, om, op) >> 1)
        # Y(2n) = X(2n) + floor((Y(2n-1) + Y(2n+1) + 2) / 4)
        lo = lo + ((_pair_sum(hi, axis, em, ep) + 2) >> 2)
        return lo, hi
    hi = hi + ALPHA * _pair_sum(lo, axis, om, op)
    lo = lo + BETA * _pair_sum(hi, axis, em, ep)
    hi = hi + GAMMA * _pair_sum(lo, axis, om, op)
    lo = lo + DELTA * _pair_sum(hi, axis, em, ep)
    return lo * (1.0 / KK), hi * KK


def _dtype(reversible: bool) -> torch.dtype:
    return torch.int64 if reversible else torch.float64


def inverse_dwt_level(ll, hl, lh, hh, ll_rect, out_rect,
                      reversible: bool) -> torch.Tensor:
    """One 2D_SR level: (LL of res r-1, HL, LH, HH of level) -> LL of
    res r, each (..., rows, cols) with the same leading axes. out_rect
    is (x0, y0, x1, y1) in resolution coordinates; the parity of its
    origin sets the lifting phase (F.3.2). ll_rect is unused, as in the
    JAX package. HOR_SR then VER_SR (F.3.5-F.3.7)."""
    del ll_rect
    x0, y0, x1, y1 = out_rect
    w, h = x1 - x0, y1 - y0
    px, py = x0 & 1, y0 & 1
    dt = _dtype(reversible)
    lead = ll.shape[:-2]
    if w <= 0 or h <= 0:
        return torch.zeros(lead + (max(h, 0), max(w, 0)), dtype=dt,
                           device=ll.device)
    ll, hl, lh, hh = (t.to(dt) for t in (ll, hl, lh, hh))
    ney = ll.shape[-2]
    nex = ll.shape[-1]
    # rows ordered [even-phase; odd-phase] through both passes
    lo, hi = _synth_1d(torch.cat([ll, lh], -2), torch.cat([hl, hh], -2),
                       -1, px, w, reversible)
    cols = torch.cat([lo, hi], -1)
    lo, hi = _synth_1d(cols[..., :ney, :], cols[..., ney:, :], -2, py, h,
                       reversible)
    out = torch.empty(lead + (h, w), dtype=dt, device=ll.device)
    out[..., py::2, px::2] = lo[..., :nex]
    out[..., py::2, 1 - px::2] = lo[..., nex:]
    out[..., 1 - py::2, px::2] = hi[..., :nex]
    out[..., 1 - py::2, 1 - px::2] = hi[..., nex:]
    return out


def forward_dwt_level(x, out_rect, reversible: bool):
    """One 2D analysis level: LL of resolution r, (..., rows, cols) over
    out_rect = (x0, y0, x1, y1) in that resolution's coordinates -> (LL,
    HL, LH, HH) of the next decomposition, the exact inverse of
    inverse_dwt_level (vertical, then horizontal)."""
    x0, y0, x1, y1 = out_rect
    w, h = x1 - x0, y1 - y0
    px, py = x0 & 1, y0 & 1
    x = x.to(_dtype(reversible))
    lo, hi = _analyse_1d(*_split(x, -2, py), -2, py, h, reversible)
    ney = lo.shape[-2]
    rows = torch.cat([lo, hi], -2)
    lo, hi = _analyse_1d(*_split(rows, -1, px), -1, px, w, reversible)
    return (lo[..., :ney, :], hi[..., :ney, :], lo[..., ney:, :],
            hi[..., ney:, :])


def forward_rct(r, g, b):
    """Forward reversible colour transform (G.2), int64; the exact
    inverse of inverse_rct."""
    r, g, b = (t.to(torch.int64) for t in (r, g, b))
    y = (r + 2 * g + b) >> 2
    return y, b - g, r - g


def forward_ict(r, g, b):
    """Forward irreversible colour transform (G.3), float64."""
    r, g, b = (t.to(torch.float64) for t in (r, g, b))
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = _div(b - y, 1.772)
    cr = _div(r - y, 1.402)
    return y, cb, cr


def inverse_rct(y, u, v):
    """Inverse reversible colour transform (G.2), int64."""
    y, u, v = (t.to(torch.int64) for t in (y, u, v))
    g = y - ((u + v) >> 2)
    return v + g, g, u + g


def inverse_ict(y, cb, cr) -> Tuple[torch.Tensor, ...]:
    """Inverse irreversible colour transform (G.3): BT.601 in float64,
    rounded half to even to int64."""
    y, cb, cr = (t.to(torch.float64) for t in (y, cb, cr))
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    return tuple(torch.round(t).to(torch.int64) for t in (r, g, b))
