"""libyuv/libavif-exact YUV -> BGR(A) conversion of the AVIF SDR decode:
the counterpart of ``lilliput_tpu/codecs/yuv_rgb.py``, the 8-bit kernel
and the depth-general (10/12-bit) ruleset of ``planes_to_bgr_u8``.

The reference decodes AVIF through libavif, whose 8-bit YUV->RGB rides
libyuv's 6-bit fixed-point kernels; PIL's libavif plugin does the same,
so matching libyuv exactly makes the decode of dav1d's planes
bit-identical to both. Every rule was pinned empirically against
PIL/libavif in the JAX package; the per-pixel kernel is

    y32 = (y * 0x0101 * YG) >> 16
    B   = clamp((y32 + UB*u - UB*128 + YGB) >> 6)
    G   = clamp((y32 - UG*u - VG*v + (UG+VG)*128 + YGB) >> 6)
    R   = clamp((y32 + VR*v - VR*128 + YGB) >> 6)

with YG/YGB = 16320/32 (full range) or 18997/-1160 (limited), and
UV coefficients round(c*64) of the matrix coefficients (UB clamped at
128, libyuv's SIMD range constraint). Chroma upsampling
(AVIF_CHROMA_UPSAMPLING_AUTOMATIC = bilinear) is libyuv's single-pass
kernel: (9*self + 3*horiz + 3*vert + diag + 8) >> 4 with edge
replication, except the odd-width last column, which libyuv leaves
horizontally unfiltered ((3*self + vert + 2) >> 2); odd-height last rows
are vertically filtered against the replicated row. 4:2:2 filters
horizontally only; 4:4:4 and monochrome need no resampling.

Host numpy and the C++ row kernel (``csrc/host/yuv_bgr.cpp``, a copy of
the JAX package's, in the port's host library): a per-image decode stage
whose frame the decoder then hands to its device, as the PNG unfilter
is. The numpy body of ``yuv_to_bgr_u8`` is the plain reference the tests
hold the C++ against (``LILLIPUT_YUV_RGB=py`` forces it).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# (UB, UG, VG, VR) = round(64 * matrix-coefficient), UB clamped at 128.
# Derived from Kr/Kb exactly as libyuv documents its constants; the 601
# sets were additionally solved uniquely from PIL output (tests).
_COEFS = {
    # matrix-family key: (limited, full)
    "601": ((128, 25, 52, 102), (113, 22, 46, 90)),
    "709": ((128, 14, 34, 115), (119, 12, 30, 101)),
    "2020": ((128, 12, 42, 107), (120, 11, 37, 94)),
}

# AVCOL_SPC_* / CICP matrix-coefficient -> family. Unspecified (2) maps
# to 601 (libavif's fallback). 0 = identity (GBR), handled separately.
_MATRIX_FAMILY = {
    1: "709",
    2: "601", 4: "601", 5: "601", 6: "601", 7: "601",
    9: "2020", 10: "2020",
}


def supported_matrix(matrix: int) -> bool:
    return matrix == 0 or matrix in _MATRIX_FAMILY


# --- libavif built-in float path (matrices with no libyuv kernel) --------
#
# YCgCo (8) and chromaticity-derived NCL (12) ride libavif's float
# converter. Empirically pinned (tests/test_avif.py): unorm tables at
# NATIVE depth, chroma bilinear-upsampled in float unorm space with the
# 2D 9331 kernel evaluated left-to-right ((9c+3h+3v+d)*(1/16); 4:2:2
# duplicates rows through the same kernel), YCgCo via t=Y-Cg, generic
# matrices via kr/kb, out = (uint8)(clip01(c)*255+0.5), alpha
# round-scaled. For matrix 12 libavif first maps primaries {1,2}->709,
# {5,6}->601, {9}->2020 onto the FIXED-POINT kernels; all other
# primaries derive kr/kb from the CIE coordinates (XYZ -> kr=kb=0,
# reserved/unknown -> BT.709 coordinates).

_M12_FAMILY_MATRIX = {1: 1, 2: 1, 5: 5, 6: 5, 9: 9}

# CICP colour primaries -> (xR,yR, xG,yG, xB,yB, xW,yW)
_PRIM_COORDS = {
    1: (0.64, 0.33, 0.30, 0.60, 0.15, 0.06, 0.3127, 0.3290),
    4: (0.67, 0.33, 0.21, 0.71, 0.14, 0.08, 0.310, 0.316),
    5: (0.64, 0.33, 0.29, 0.60, 0.15, 0.06, 0.3127, 0.3290),
    6: (0.630, 0.340, 0.310, 0.595, 0.155, 0.070, 0.3127, 0.3290),
    7: (0.630, 0.340, 0.310, 0.595, 0.155, 0.070, 0.3127, 0.3290),
    8: (0.681, 0.319, 0.243, 0.692, 0.145, 0.049, 0.310, 0.316),
    9: (0.708, 0.292, 0.170, 0.797, 0.131, 0.046, 0.3127, 0.3290),
    11: (0.680, 0.320, 0.265, 0.690, 0.150, 0.060, 0.314, 0.351),
    12: (0.680, 0.320, 0.265, 0.690, 0.150, 0.060, 0.3127, 0.3290),
    22: (0.630, 0.340, 0.295, 0.605, 0.155, 0.077, 0.3127, 0.3290),
}


def _derived_kr_kb(primaries: int) -> Tuple[float, float]:
    """kr/kb from CIE chromaticities (libavif's derivation; pinned
    bit-exact through the float model for primaries 4,7,8,10,11,12,22
    and the reserved->709 fallback)."""
    if primaries == 10:              # CIE XYZ: degenerate -> kr=kb=0
        return 0.0, 0.0
    xR, yR, xG, yG, xB, yB, xW, yW = _PRIM_COORDS.get(
        primaries, _PRIM_COORDS[1])
    M = np.array([[xR / yR, xG / yG, xB / yB],
                  [1.0, 1.0, 1.0],
                  [(1 - xR - yR) / yR, (1 - xG - yG) / yG,
                   (1 - xB - yB) / yB]])
    S = np.linalg.solve(M, np.array([xW / yW, 1.0, (1 - xW - yW) / yW]))
    s = S.sum()
    return float(S[0] / s), float(S[2] / s)


def _upsample_float(cf: np.ndarray, h: int, w: int) -> np.ndarray:
    """Float bilinear in unorm space, libavif built-in: the 2D 9331
    kernel summed left-to-right; 4:2:2 rides the same kernel with
    duplicated rows (vert/diag collapse onto self/horiz)."""
    f = np.float32
    if cf.shape[0] >= h:             # 4:2:2 — horizontal only
        L = np.concatenate([cf[:, :1], cf[:, :-1]], 1)
        R = np.concatenate([cf[:, 1:], cf[:, -1:]], 1)
        out = np.empty((cf.shape[0], 2 * cf.shape[1]), f)
        out[:, 0::2] = (f(9) * cf + f(3) * L + f(3) * cf + L) * f(1 / 16)
        out[:, 1::2] = (f(9) * cf + f(3) * R + f(3) * cf + R) * f(1 / 16)
        return out[:h, :w]
    p = np.pad(cf, 1, mode="edge")
    c0 = p[1:-1, 1:-1]
    L, R = p[1:-1, :-2], p[1:-1, 2:]
    T, B = p[:-2, 1:-1], p[2:, 1:-1]
    TL, TR = p[:-2, :-2], p[:-2, 2:]
    BL, BR = p[2:, :-2], p[2:, 2:]
    out = np.empty((2 * cf.shape[0], 2 * cf.shape[1]), f)
    out[0::2, 0::2] = (f(9) * c0 + f(3) * L + f(3) * T + TL) * f(1 / 16)
    out[0::2, 1::2] = (f(9) * c0 + f(3) * R + f(3) * T + TR) * f(1 / 16)
    out[1::2, 0::2] = (f(9) * c0 + f(3) * L + f(3) * B + BL) * f(1 / 16)
    out[1::2, 1::2] = (f(9) * c0 + f(3) * R + f(3) * B + BR) * f(1 / 16)
    return out[:h, :w]


def _builtin_float_bgr(y: np.ndarray, u: np.ndarray, v: np.ndarray,
                       depth: int, matrix: int, full_range: bool,
                       h: int, w: int, kr: float, kb: float,
                       alpha: Optional[np.ndarray]) -> np.ndarray:
    f = np.float32
    if full_range:
        by, ry = 0.0, float((1 << depth) - 1)
        ruv = float((1 << depth) - 1)
    else:
        by, ry = float(16 << (depth - 8)), float(219 << (depth - 8))
        ruv = float(224 << (depth - 8))
    half = float(1 << (depth - 1))
    Y = (y[:h, :w].astype(f) - f(by)) / f(ry)
    Cb = (u.astype(f) - f(half)) / f(ruv)
    Cr = (v.astype(f) - f(half)) / f(ruv)
    if Cb.shape != (h, w):
        Cb, Cr = _upsample_float(Cb, h, w), _upsample_float(Cr, h, w)
    else:
        Cb, Cr = Cb[:h, :w], Cr[:h, :w]
    if matrix == 8:                   # YCgCo: Cb=Cg, Cr=Co
        t = Y - Cb
        G = Y + Cb
        R = t + Cr
        B = t - Cr
    else:
        krf, kbf = f(kr), f(kb)
        kg = f(1) - krf - kbf
        R = Y + (f(2) * (f(1) - krf)) * Cr
        B = Y + (f(2) * (f(1) - kbf)) * Cb
        G = Y - (f(2) * ((krf * (f(1) - krf) * Cr)
                         + (kbf * (f(1) - kbf) * Cb))) / kg
    out = np.empty((h, w, 3 + (alpha is not None)), np.uint8)
    for i, C in enumerate((B, G, R)):
        out[..., i] = (np.clip(C, f(0), f(1)) * f(255)
                       + f(0.5)).astype(np.uint8)
    if alpha is not None:
        out[..., 3] = _round_scale_u8(alpha[:h, :w], depth)
    return out


def _yuv_to_bgr_native(y, u, v, matrix, full_range, h, w, alpha):
    """The C++ row kernel (lp_yuv_to_bgr of the host library); None where
    it declines the geometry (a nonzero return), as in the JAX package."""
    import ctypes as c

    from .. import binding
    lib = binding.load()
    u8p = c.POINTER(c.c_uint8)

    def p(a):
        return a.ctypes.data_as(u8p) if a is not None else None

    y = np.ascontiguousarray(y)
    if matrix == 0 and u is not None:
        sub = 4
        u = np.ascontiguousarray(u)
        v = np.ascontiguousarray(v)
        cs, cw, ch = u.shape[1], u.shape[1], u.shape[0]
        ub = ug = vg = vr = yg = ygb = 0
    elif u is None or v is None:
        sub = 3
        cs = cw = ch = 0
        ub, ug, vg, vr, yg, ygb = _constants(matrix, full_range)
    else:
        u = np.ascontiguousarray(u)
        v = np.ascontiguousarray(v)
        ch, cw = u.shape
        cs = cw
        # AV1 has only 4:2:0/4:2:2/4:4:4: vertical-only subsampling means
        # a width-1 4:2:0 image (cw == w == 1), which must take the 4:2:0
        # kernel: as 4:4:4 the C kernel would read chroma rows past the
        # plane
        if ch < h:
            sub = 2
        elif cw < w:
            sub = 1
        else:
            sub = 0
        ub, ug, vg, vr, yg, ygb = _constants(matrix, full_range)
    out_ch = 4 if alpha is not None else 3
    if alpha is not None:
        alpha = np.ascontiguousarray(alpha)
    out = np.empty((h, w, out_ch), np.uint8)
    rc = lib.lp_yuv_to_bgr(
        p(y), y.shape[1], p(u), p(v), cs, cw, ch, sub, w, h,
        ub, ug, vg, vr, yg, ygb, p(alpha),
        alpha.shape[1] if alpha is not None else 0, p(out), out_ch)
    return out if rc == 0 else None


def _constants(matrix: int, full_range: bool):
    fam = _MATRIX_FAMILY.get(matrix, "601")
    ub, ug, vg, vr = _COEFS[fam][1 if full_range else 0]
    # Limited-range Y scale is family-dependent: libyuv's 2020 constants
    # carry YG=19003 where 601/709 use 18997 (pinned by constraint
    # search against PIL on synthesized m9-limited fixtures — unique
    # (YG, UB, YGB) solution; tests/test_avif.py).
    yg, ygb = ((16320, 32) if full_range else
               ((19003 if fam == "2020" else 18997), -1160))
    return ub, ug, vg, vr, yg, ygb


def _mono_rational_u8(y: np.ndarray, depth: int, full_range: bool) \
        -> np.ndarray:
    """libavif built-in gray conversion: round((y-bias)*255/range),
    half-up, clipped — exact at every depth/range (pinned exhaustively
    against PIL over all 2^depth values)."""
    if full_range:
        bias, rng = 0, (1 << depth) - 1
    else:
        bias, rng = 16 << (depth - 8), 219 << (depth - 8)
    vals = np.arange(1 << depth, dtype=np.int64)
    lut = np.clip(((vals - bias) * 510 + rng) // (2 * rng),
                  0, 255).astype(np.uint8)
    return lut[np.minimum(y, (1 << depth) - 1)]


def _round_scale_u8(p: np.ndarray, depth: int) -> np.ndarray:
    """Full-range unorm rescale round(p*255/maxv) (half-up) — libavif's
    built-in alpha/identity channel conversion for depth>8."""
    return _mono_rational_u8(p, depth, True)


def _kernel_bgr_u8(y16: np.ndarray, uu: np.ndarray, vv: np.ndarray,
                   matrix: int, full_range: bool,
                   alpha8) -> np.ndarray:
    """The libyuv fixed-point pixel kernel on a 16-bit-scaled luma and
    8-bit-scale chroma (the 8-bit path's y*0x0101 IS this scaling)."""
    ub, ug, vg, vr, yg, ygb = _constants(matrix, full_range)
    y32 = (y16 * yg) >> 16
    h, w = y16.shape
    out = np.empty((h, w, 3 + (alpha8 is not None)), np.uint8)
    np.clip((y32 + ub * uu + (ygb - ub * 128)) >> 6, 0, 255,
            out=out[..., 0], casting="unsafe")                      # B
    np.clip((y32 - ug * uu - vg * vv + ((ug + vg) * 128 + ygb)) >> 6,
            0, 255, out=out[..., 1], casting="unsafe")              # G
    np.clip((y32 + vr * vv + (ygb - vr * 128)) >> 6, 0, 255,
            out=out[..., 2], casting="unsafe")                      # R
    if alpha8 is not None:
        out[..., 3] = alpha8
    return out


def planes_to_bgr_u8(y: np.ndarray, u: Optional[np.ndarray],
                     v: Optional[np.ndarray], depth: int, matrix: int,
                     full_range: bool, h: int, w: int,
                     alpha: Optional[np.ndarray] = None,
                     alpha_depth: Optional[int] = None,
                     primaries: int = 1):
    """Depth-general SDR plane conversion, bit-identical to PIL/libavif
    1.3 (libyuv 1909). Returns (h, w, 3|4) BGR(A) u8, or None when the
    combination isn't covered (caller falls back to PIL).

    The reference converts through libavif's reformat machinery
    (avif.cpp:255-601); its >8-bit rules were pinned
    empirically in the JAX package (tests/test_avif.py's high-depth
    sweep):

    - YUV without alpha (any depth): planes truncated >>(d-8), then the
      8-bit libyuv kernel (libavif converts depth first, then uses the
      8-bit RGB24 fast path).
    - YUV with alpha, depth 10: libyuv's 10-bit alpha kernels — chroma
      bilinear-upsampled AT 10 BITS (same 9331 + edge rules) then >>2,
      luma bit-replicated to 16 bits (y<<6|y>>4), alpha truncated >>2.
    - YUV with alpha, depth 12, 4:2:0: libyuv I012 path — NEAREST
      chroma upsample then >>4, luma y<<4|y>>8, alpha round-scaled
      (no 12-bit alpha kernel exists; libavif fills alpha itself).
    - YUV with alpha, depth 12, 4:2:2/4:4:4: no 12-bit kernel at all —
      everything truncated to 8 bits, then the 8-bit alpha path.
    - Monochrome: color = round((y-bias)*255/range) half-up without
      alpha, truncation + the 8-bit kernel with alpha; a present alpha
      plane is always round-scaled.
    - Identity (GBR): every channel round-scaled.
    """
    if depth not in (8, 10, 12):
        return None
    if alpha is not None and alpha_depth not in (None, depth):
        return None                       # mixed-depth alpha: decline
    builtin_gray = False                  # mono via built-in float path
    if matrix == 8:
        if not full_range:
            return None                   # PIL/libavif reject this too
        if u is not None:
            return _builtin_float_bgr(y, u, v, depth, matrix,
                                      full_range, h, w, 0.0, 0.0, alpha)
        builtin_gray = True
    elif matrix == 12:
        fam = _M12_FAMILY_MATRIX.get(primaries)
        if fam is not None:
            matrix = fam                  # fixed-point kernel family
        elif u is not None:
            kr, kb = _derived_kr_kb(primaries)
            return _builtin_float_bgr(y, u, v, depth, matrix,
                                      full_range, h, w, kr, kb, alpha)
        else:
            builtin_gray = True
    elif not supported_matrix(matrix):
        return None
    if builtin_gray:
        # mono with no kernel family: rational gray + round-scaled alpha
        out = _mono_rational_u8(y[:h, :w], depth,
                                full_range)[..., None].repeat(
            3 + (alpha is not None), -1)
        if alpha is not None:
            out[..., 3] = _round_scale_u8(alpha[:h, :w], depth)
        return out
    if depth == 8:
        return yuv_to_bgr_u8(y, u, v, matrix, full_range, h, w,
                             alpha=alpha)
    sh = depth - 8
    if matrix == 0 and u is not None:
        out = np.empty((h, w, 3 + (alpha is not None)), np.uint8)
        out[..., 0] = _round_scale_u8(u[:h, :w], depth)          # B
        out[..., 1] = _round_scale_u8(y[:h, :w], depth)          # G
        out[..., 2] = _round_scale_u8(v[:h, :w], depth)          # R
        if alpha is not None:
            out[..., 3] = _round_scale_u8(alpha[:h, :w], depth)
        return out
    if u is None or v is None:            # monochrome
        if alpha is None:
            return _mono_rational_u8(y[:h, :w], depth,
                                     full_range)[..., None].repeat(3, -1)
        return yuv_to_bgr_u8((y >> sh).astype(np.uint8), None, None,
                             matrix, full_range, h, w,
                             alpha=_round_scale_u8(alpha[:h, :w], depth))
    if alpha is None or (depth == 12 and u.shape[0] >= h):
        # truncate-to-8 path (incl. 12-bit 4:2:2/4:4:4 with alpha)
        a8 = (alpha >> sh).astype(np.uint8) if alpha is not None else None
        return yuv_to_bgr_u8((y >> sh).astype(np.uint8),
                             (u >> sh).astype(np.uint8),
                             (v >> sh).astype(np.uint8),
                             matrix, full_range, h, w, alpha=a8)
    mx = (1 << depth) - 1
    yl = np.minimum(y[:h, :w].astype(np.int64), mx)
    y16 = (yl << (16 - depth)) | (yl >> (2 * depth - 16))
    ch, cw = u.shape
    if depth == 10:
        if ch < h:
            uu, vv = _upsample2x2(u, h, w) >> 2, _upsample2x2(v, h, w) >> 2
        elif cw < w:
            uu, vv = _upsample2x1(u, h, w) >> 2, _upsample2x1(v, h, w) >> 2
        else:
            uu = np.minimum(u[:h, :w].astype(np.int64), mx) >> 2
            vv = np.minimum(v[:h, :w].astype(np.int64), mx) >> 2
        a8 = np.minimum(alpha[:h, :w].astype(np.int64),
                        mx).astype(np.uint16) >> 2
        return _kernel_bgr_u8(y16, uu, vv, matrix, full_range,
                              a8.astype(np.uint8))
    # depth 12, 4:2:0 with alpha: nearest upsample, alpha round-scaled
    uu = u.astype(np.int64).repeat(2, 0).repeat(2, 1)[:h, :w] >> 4
    vv = v.astype(np.int64).repeat(2, 0).repeat(2, 1)[:h, :w] >> 4
    return _kernel_bgr_u8(y16, uu, vv, matrix, full_range,
                          _round_scale_u8(alpha[:h, :w], depth))


def _upsample2x2(c: np.ndarray, h: int, w: int) -> np.ndarray:
    """4:2:0 chroma -> (h, w) int32, libyuv bilinear (see module doc)."""
    a = c.astype(np.int32)
    p = np.pad(a, 1, mode="edge")
    c0 = p[1:-1, 1:-1]
    L, R = p[1:-1, :-2], p[1:-1, 2:]
    T, B = p[:-2, 1:-1], p[2:, 1:-1]
    TL, TR = p[:-2, :-2], p[:-2, 2:]
    BL, BR = p[2:, :-2], p[2:, 2:]
    out = np.empty((2 * a.shape[0], 2 * a.shape[1]), np.int32)
    out[0::2, 0::2] = (9 * c0 + 3 * L + 3 * T + TL + 8) >> 4
    out[0::2, 1::2] = (9 * c0 + 3 * R + 3 * T + TR + 8) >> 4
    out[1::2, 0::2] = (9 * c0 + 3 * L + 3 * B + BL + 8) >> 4
    out[1::2, 1::2] = (9 * c0 + 3 * R + 3 * B + BR + 8) >> 4
    out = out[:h, :w]
    if w % 2 == 1 and w == 2 * a.shape[1] - 1:
        # odd-width last column: horizontally unfiltered (measured)
        tb = np.empty((2 * a.shape[0],), np.int32)
        tb[0::2] = (3 * c0[:, -1] + T[:, -1] + 2) >> 2
        tb[1::2] = (3 * c0[:, -1] + B[:, -1] + 2) >> 2
        out[:, -1] = tb[:h]
    return out


def _upsample2x1(c: np.ndarray, h: int, w: int) -> np.ndarray:
    """4:2:2 chroma -> (h, w) int32, horizontal-only libyuv bilinear."""
    a = c.astype(np.int32)
    L = np.concatenate([a[:, :1], a[:, :-1]], 1)
    R = np.concatenate([a[:, 1:], a[:, -1:]], 1)
    out = np.empty((a.shape[0], 2 * a.shape[1]), np.int32)
    out[:, 0::2] = (3 * a + L + 2) >> 2
    out[:, 1::2] = (3 * a + R + 2) >> 2
    out = out[:h, :w]
    if w % 2 == 1 and w == 2 * a.shape[1] - 1:
        out[:, -1] = a[:h, -1]   # odd-width last column: unfiltered
    return out


def yuv_to_bgr_u8(y: np.ndarray, u: Optional[np.ndarray],
                  v: Optional[np.ndarray], matrix: int, full_range: bool,
                  h: int, w: int,
                  alpha: Optional[np.ndarray] = None) -> np.ndarray:
    """8-bit planes -> (h, w, 3|4) BGR(A) u8, bit-identical to libyuv's
    conversion of the same planes (and therefore to PIL/libavif).

    y: (>=h, >=w) u8 (dav1d may pad to even dims; the window is
    top-left). u/v: subsampled or full chroma, or None (monochrome).
    alpha: optional (>=h, >=w) u8 plane copied into channel 3.

    Dispatches to the C++ row kernel (csrc/host/yuv_bgr.cpp, ~15x the
    numpy form at 1080p); the body below is the bit-identical Python
    reference, forced with LILLIPUT_YUV_RGB=py and held against the C++
    in tests.
    """
    import os
    if u is None and v is None and alpha is None:
        # Monochrome without alpha rides libavif's built-in gray path,
        # not the libyuv kernel: out = round((y-bias)*255/range),
        # half-up (pinned exhaustively over every y at depths 8/10/12,
        # both ranges — the fixed-point kernel is off by one on ~4% of
        # limited-range values).
        return _mono_rational_u8(y[:h, :w], 8, full_range)[..., None].repeat(
            3, axis=-1)
    if os.environ.get("LILLIPUT_YUV_RGB", "native") != "py":
        out = _yuv_to_bgr_native(y, u, v, matrix, full_range, h, w, alpha)
        if out is not None:
            return out
    yv = y[:h, :w].astype(np.int32)
    if matrix == 0 and u is not None:
        # identity (GBR): planes are G, B, R verbatim
        out = np.empty((h, w, 3 + (alpha is not None)), np.uint8)
        out[..., 0] = u[:h, :w]          # B
        out[..., 1] = y[:h, :w]          # G
        out[..., 2] = v[:h, :w]          # R
        if alpha is not None:
            out[..., 3] = alpha[:h, :w]
        return out
    ub, ug, vg, vr, yg, ygb = _constants(matrix, full_range)
    y32 = (yv * (0x0101 * yg)) >> 16
    if u is None or v is None:
        uu = vv = np.full((h, w), 128, np.int32)
    else:
        ch, cw = u.shape
        if ch < h:                     # 4:2:0 (incl. width-1: cw == w)
            uu = _upsample2x2(u, h, w)
            vv = _upsample2x2(v, h, w)
        elif cw < w:                   # 4:2:2 (full-height chroma)
            uu = _upsample2x1(u, h, w)
            vv = _upsample2x1(v, h, w)
        else:                          # 4:4:4
            uu = u[:h, :w].astype(np.int32)
            vv = v[:h, :w].astype(np.int32)
    out = np.empty((h, w, 3 + (alpha is not None)), np.uint8)
    np.clip((y32 + ub * uu + (ygb - ub * 128)) >> 6, 0, 255,
            out=out[..., 0], casting="unsafe")                      # B
    np.clip((y32 - ug * uu - vg * vv + ((ug + vg) * 128 + ygb)) >> 6,
            0, 255, out=out[..., 1], casting="unsafe")              # G
    np.clip((y32 + vr * vv + (ygb - vr * 128)) >> 6, 0, 255,
            out=out[..., 2], casting="unsafe")                      # R
    if alpha is not None:
        out[..., 3] = alpha[:h, :w]
    return out
