"""Host-side (numpy) coefficient tables for OpenCV-compatible resize.

A copy of ``lilliput_tpu/ops/resize_tables.py`` (numpy only), so the port
builds the same tables without importing the JAX package.

These tables replicate the coefficient generation of OpenCV's ``cv::resize``
(the resize the reference wraps at opencv.cpp:190-202 and uses for every
``Fit``/``ResizeTo`` at opencv.go:284-364) so the device kernels in
``resize.py`` can be bit-exact:

* INTER_LINEAR (8U): fixed-point Q11 coefficients (``INTER_RESIZE_COEF_BITS=11``),
  computed in float32 and rounded half-to-even exactly like
  ``saturate_cast<short>(cbuf*2048)``.
* INTER_AREA upscale: same linear kernel but with OpenCV's area-specific
  source-coordinate rule ``fx = (dx+1) - (sx+1)*inv_scale``.
* INTER_AREA fractional downscale: the decimation tables of ``resizeArea_``
  (float32 weights, per-output variable tap count, padded to a static K).
* INTER_CUBIC: float32 Catmull-Rom-style coefficients with A=-0.75
  (``interpolateCubic``), kept in float32 — matches OpenCV 5.x bit-exactly.

Tables are computed once per (src,dst) pair on the host in numpy and become
compile-time constants of the jitted device functions.
"""

from __future__ import annotations

import functools

import numpy as np

INTER_RESIZE_COEF_BITS = 11
INTER_RESIZE_COEF_SCALE = 1 << INTER_RESIZE_COEF_BITS  # 2048
CUBIC_A = np.float32(-0.75)


def _rint32(x: np.ndarray) -> np.ndarray:
    """cvRound: round half to even (matches SSE cvtss2si)."""
    return np.rint(x).astype(np.int32)


@functools.lru_cache(maxsize=4096)
def _linear_coords(src: int, dst: int, area_mode: bool, clamp: bool):
    """Per-output (sx int32, f float32) source coordinates, cv::resize exact.

    cv::resize narrows the source coordinate to float32 BEFORE cvFloor and
    computes scale as 1/(dst/src) — both matter for bit-exactness on large
    images (float32 spacing near x=1900 is ~1.2e-4, enough to move a Q11
    coefficient by 1).

    clamp=True replicates the x-axis (column) edge rule: fx forced to 0 with
    sx pinned at the border. clamp=False replicates the y-axis (row) rule:
    sx may be -1 or src-1 with its true fraction kept; the caller clips the
    gather indices (resizeGeneric_ clips rows, but the coefficient loop only
    clamps columns).
    """
    if src == 1:
        return np.zeros(dst, np.int32), np.zeros(dst, np.float32)
    inv_scale = np.float64(dst) / np.float64(src)
    scale = np.float64(1.0) / inv_scale
    dxs = np.arange(dst, dtype=np.float64)
    if area_mode:
        s = np.floor(dxs * scale).astype(np.int64)
        fd = ((dxs + 1) - (s + 1) * inv_scale).astype(np.float32)
        f = np.where(fd <= 0, np.float32(0),
                     (fd - np.floor(fd)).astype(np.float32))
    else:
        fxx = ((dxs + 0.5) * scale - 0.5).astype(np.float32)
        s = np.floor(fxx).astype(np.int64)
        f = fxx - s.astype(np.float32)
    if clamp:
        lo = s < 0
        s = np.where(lo, 0, s)
        f = np.where(lo, np.float32(0), f)
        hi = s >= src - 1
        s = np.where(hi, src - 1, s)
        f = np.where(hi, np.float32(0), f)
    return s.astype(np.int32), f.astype(np.float32)


@functools.lru_cache(maxsize=4096)
def linear_tables(src: int, dst: int, area_mode: bool = False,
                  clamp: bool = True):
    """Per-output (sx, a0, a1) for fixed-point bilinear.

    a0/a1 are Q11 int32 (saturate_cast<short>(cbuf*2048) rounding); sx is the
    left tap. With clamp=False (y-axis rule) sx may be -1 or src-1 and the
    caller must clip both gather indices to [0, src-1].
    """
    sx, f = _linear_coords(src, dst, area_mode, clamp)
    if src == 1:
        return sx, np.full(dst, INTER_RESIZE_COEF_SCALE, np.int32), np.zeros(dst, np.int32)
    a0 = _rint32((np.float32(1.0) - f) * np.float32(INTER_RESIZE_COEF_SCALE))
    a1 = _rint32(f * np.float32(INTER_RESIZE_COEF_SCALE))
    return sx, a0, a1


@functools.lru_cache(maxsize=4096)
def linear_tables_f32(src: int, dst: int, area_mode: bool = False,
                      clamp: bool = True):
    """Float32 (sx, a0, a1) for the float pixel-type bilinear path (cv uses
    the unquantized float coefficients there, not the Q11 ones)."""
    sx, f = _linear_coords(src, dst, area_mode, clamp)
    if src == 1:
        return sx, np.ones(dst, np.float32), np.zeros(dst, np.float32)
    return sx, (np.float32(1.0) - f).astype(np.float32), f


@functools.lru_cache(maxsize=4096)
def cubic_tables(src: int, dst: int):
    """Per-output 4-tap (idx[dst,4] int32, w[dst,4] float32) bicubic tables."""
    one = np.float32(1)
    A = CUBIC_A
    scale = np.float64(src) / dst
    idx = np.empty((dst, 4), np.int32)
    w = np.empty((dst, 4), np.float32)
    for dx in range(dst):
        fd = np.float64((dx + 0.5) * scale - 0.5)
        s = int(np.floor(fd))
        x = np.float32(fd - s)
        c0 = ((A * (x + one) - np.float32(5) * A) * (x + one) + np.float32(8) * A) * (x + one) - np.float32(4) * A
        c1 = ((A + np.float32(2)) * x - (A + np.float32(3))) * x * x + one
        c2 = ((A + np.float32(2)) * (one - x) - (A + np.float32(3))) * (one - x) * (one - x) + one
        c3 = one - c0 - c1 - c2
        for k, c in enumerate((c0, c1, c2, c3)):
            idx[dx, k] = min(max(s - 1 + k, 0), src - 1)
            w[dx, k] = c
    return idx, w


@functools.lru_cache(maxsize=4096)
def cubic_tables_q11(src: int, dst: int):
    """Per-output 4-tap (idx[dst,4] int32, q[dst,4] int32) fixed-point Q11
    bicubic tables — OpenCV's 8U path: the source coordinate is narrowed to
    float32 BEFORE cvFloor (same rule as _linear_coords), the float32
    coefficients are quantized with ``saturate_cast<short>(cbuf*2048)``
    (cvRound = half-to-even). These feed the portable scalar fixed-point
    kernel in resize._cubic_u8."""
    one = np.float32(1)
    A = CUBIC_A
    scale = np.float64(src) / dst
    idx = np.empty((dst, 4), np.int32)
    q = np.empty((dst, 4), np.int32)
    for dx in range(dst):
        fx = np.float32((dx + 0.5) * scale - 0.5)
        s = int(np.floor(fx))
        x = np.float32(fx - np.float32(s))
        c0 = ((A * (x + one) - np.float32(5) * A) * (x + one) + np.float32(8) * A) * (x + one) - np.float32(4) * A
        c1 = ((A + np.float32(2)) * x - (A + np.float32(3))) * x * x + one
        c2 = ((A + np.float32(2)) * (one - x) - (A + np.float32(3))) * (one - x) * (one - x) + one
        c3 = one - c0 - c1 - c2
        for k, c in enumerate((c0, c1, c2, c3)):
            idx[dx, k] = min(max(s - 1 + k, 0), src - 1)
            q[dx, k] = _rint32(c * np.float32(INTER_RESIZE_COEF_SCALE))
    return idx, q


@functools.lru_cache(maxsize=4096)
def area_tables(src: int, dst: int):
    """Decimation tables for fractional INTER_AREA downscale.

    Returns (idx[dst,K] int32, w[dst,K] float32) padded with zero weights.
    Weight values and tap ORDER match OpenCV's xi table generation, so a
    sequential float32 accumulation over k reproduces cv::resize bit-exactly.
    """
    scale = np.float64(src) / dst
    rows = []
    for dx in range(dst):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cellw = min(scale, src - fsx1)
        sx1 = int(np.ceil(fsx1))
        sx2 = min(int(np.floor(fsx2)), src - 1)
        taps = []
        if sx1 - fsx1 > 1e-3:
            taps.append((sx1 - 1, np.float32((sx1 - fsx1) / cellw)))
        for sx in range(sx1, sx2):
            taps.append((sx, np.float32(1.0 / cellw)))
        if fsx2 - sx2 > 1e-3:
            taps.append((sx2, np.float32(min(min(fsx2 - sx2, 1.0), cellw) / cellw)))
        rows.append(taps)
    K = max(len(t) for t in rows)
    idx = np.zeros((dst, K), np.int32)
    w = np.zeros((dst, K), np.float32)
    for dx, taps in enumerate(rows):
        for k, (sx, a) in enumerate(taps):
            idx[dx, k] = sx
            w[dx, k] = a
    return idx, w


def area_is_fast(src_w: int, src_h: int, dst_w: int, dst_h: int) -> bool:
    """True when both scale factors are exact integers (ResizeAreaFast path)."""
    if dst_w == 0 or dst_h == 0:
        return False
    return src_w % dst_w == 0 and src_h % dst_h == 0 and src_w >= dst_w and src_h >= dst_h
