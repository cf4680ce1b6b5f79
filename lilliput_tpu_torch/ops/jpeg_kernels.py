"""JPEG dense transforms of the serving slice (torch).

The subset of ``lilliput_tpu/ops/jpeg_kernels.py`` the JPEG Fit slice runs:

Decode: coefs -> dequant -> IDCT -> +128 -> fancy (triangle) chroma upsample
        -> YCbCr->BGR -> u8.   (one CUDA kernel per chroma layout on the
        card, decode_kernels; grayscale: dequant_idct, whose IDCT is the
        dequant_idct_blocks CUDA kernel, or dequant_idct_u8's matmul; the
        direct mode's planes: dequant_idct_u8, or dequant_idct_scaled's
        k/8-scale matmul for dct_scale 2 and 4)
Encode: BGR -> YCbCr -> pad to MCU -> 2x2 box chroma downsample -> -128 ->
        fDCT -> quantize(round) -> int16 coefs.

The IDCT and fDCT are (N,64)x(64,64) f32 matmuls with the quantization
folded into the matrix, as in the JAX package; the constant tables come
from the same numpy code and are equal bit for bit. The split decode
(``dequant_idct``, ``upsample_chroma``, ``ycbcr_to_bgr``) is the plain
version of the decode kernels, and ``decode_ycc_420``'s fallback.

Elementwise arithmetic follows the JAX package as XLA compiles it on the
CPU (its test platform): every ``a*x + c`` there becomes ONE fused
multiply-add (for ``a*x + b*y`` the first product is fused, the second
rounded), and the 2x2 mean sums pairs along the row first. The port writes
those fusions out (``_fma``), so on the CPU it matches the JAX package bit
for bit (tests/test_torch_ops.py), and the CUDA kernel uses the same
fusions (``__fmaf_rn``), so it matches this plain version on the card.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ._matmul import matmul


@functools.lru_cache(maxsize=1)
def dct_matrix() -> np.ndarray:
    """Orthonormal 8x8 DCT-II matrix A: forward K = A @ P @ A.T."""
    a = np.zeros((8, 8), np.float32)
    for k in range(8):
        c = np.sqrt(1.0 / 8.0) if k == 0 else np.sqrt(2.0 / 8.0)
        for n in range(8):
            a[k, n] = c * np.cos((2 * n + 1) * k * np.pi / 16.0)
    return a


@functools.lru_cache(maxsize=1)
def idct_kron_matrix() -> np.ndarray:
    """(64, 64) W with W[xy, uv] = A[x,u]*A[y,v]: the full 2D IDCT as ONE
    matmul P_flat = K_flat @ W."""
    a = dct_matrix()
    return np.kron(a, a).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _idct_kron_on(device: str) -> torch.Tensor:
    return torch.from_numpy(idct_kron_matrix()).to(device)


def idct_kron(device) -> torch.Tensor:
    """idct_kron_matrix() resident on `device` (uploaded once per indexed
    device: "cuda" is the current card's entry)."""
    from ..utils import device_key
    return _idct_kron_on(device_key(device))


def fold_qtables(qt: torch.Tensor) -> torch.Tensor:
    """(B, 64) or (64,) quant tables -> (B, 64, 64) f32 W_q = diag(q)·W,
    the dequant-folded IDCT matrices (jpeg_kernels.py fold(), in f32;
    uint16 -> f32 is exact)."""
    q = qt.to(torch.float32).reshape(-1, 64)
    return idct_kron(q.device)[None] * q[:, :, None]


def _fma(a, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 a*x + c rounded ONCE (a fused multiply-add); `a` is a Python
    float (taken as f32) or an f32 tensor. The f32 product is exact in
    f64, so the f64 sum rounded to f32 is the fused result except when the
    sum lands within 2^-29 ulp of an f32 tie (vanishingly rare)."""
    a = a.double() if isinstance(a, torch.Tensor) else float(np.float32(a))
    return (x.double() * a + c.double()).float()


def _blocks_to_plane(p: torch.Tensor, lead, bh: int, bw: int) -> torch.Tensor:
    """(..., bh*bw, 64) block pixels -> (..., bh*8, bw*8) raster plane."""
    p = p.reshape(tuple(lead) + (bh, bw, 8, 8))
    return p.transpose(-3, -2).reshape(tuple(lead) + (bh * 8, bw * 8))


def idct_folded(coefs: torch.Tensor, wq: torch.Tensor,
                level_shift: bool = True) -> torch.Tensor:
    """(..., bh, bw, 64) int16 with dequant-folded matrices (B or 1, 64, 64)
    -> (..., bh*8, bw*8) f32 pixels, level-shifted: coefs·W_q + 128
    (without the + 128 when level_shift is False)."""
    lead = coefs.shape[:-3]
    bh, bw = coefs.shape[-3], coefs.shape[-2]
    b = int(np.prod(lead)) if lead else 1
    p = matmul(coefs.reshape(b, -1, 64).to(torch.float32), wq)
    if level_shift:
        p = p + 128.0
    return _blocks_to_plane(p, lead, bh, bw)


def _lead_batch(coefs: torch.Tensor, qtable: torch.Tensor):
    """(lead dims, image count) of a (..., bh, bw, 64) stack, with the JAX
    package's gate on a batched qtable (jpeg_kernels.py:200-203)."""
    lead = tuple(coefs.shape[:-3])
    if qtable.dim() > 1 and lead != tuple(qtable.shape[:-1]):
        raise ValueError(
            f"batched qtable leading dims {tuple(qtable.shape[:-1])} "
            f"must match coefficient leading dims {lead}")
    return lead, int(np.prod(lead)) if lead else 1


def dequant_idct(coefs: torch.Tensor, qtable: torch.Tensor,
                 plain: bool = False, out: str = "f32") -> torch.Tensor:
    """(..., bh, bw, 64) int16 + (64,) or (B, 64) -> (..., bh*8, bw*8) f32
    (out="u8": rounded half to even and clipped, as u8; out="centered":
    without the + 128 level shift).

    Dequantization folds into the IDCT matrix rows (W_q = diag(q) @ W). A
    2-D qtable carries per-image tables for a (B, bh, bw, 64) stack; each
    image's tables fold into its own matrix. The product runs in
    decode_kernels.dequant_idct_blocks, the CUDA kernel for CUDA tensors,
    as the JAX package dispatches to its Pallas kernel (:193, :207);
    plain=True (and any CPU tensor) takes its plain PyTorch version."""
    from . import decode_kernels as DK
    lead, b = _lead_batch(coefs, qtable)
    fn = DK.dequant_idct_blocks_reference if plain else DK.dequant_idct_blocks
    p = fn(coefs.reshape((b,) + tuple(coefs.shape[-3:])),
           fold_qtables(qtable), out)
    return p.reshape(lead + tuple(p.shape[1:]))


def dequant_idct_u8(coefs: torch.Tensor, qtable: torch.Tensor) -> torch.Tensor:
    """dequant_idct rounded half to even and clipped to u8 while the pixels
    are still blocks: (..., bh, bw, 64) int16 -> (..., bh*8, bw*8) u8. The
    JAX package computes this with an XLA einsum on every backend, outside
    any Pallas kernel, so it stays a torch matmul; it stores bf16 there, a
    TPU layout choice, where the port stores the same values as u8."""
    lead, b = _lead_batch(coefs, qtable)
    bh, bw = coefs.shape[-3], coefs.shape[-2]
    p = matmul(coefs.reshape(b, -1, 64).to(torch.float32),
               fold_qtables(qtable)) + 128.0
    p = torch.clamp(torch.round(p), 0.0, 255.0).to(torch.uint8)
    return _blocks_to_plane(p, lead, bh, bw)


@functools.lru_cache(maxsize=4)
def scaled_idct_kron_matrix(k: int) -> np.ndarray:
    """(64, k*k) matrix reconstructing a kxk pixel block from the top-left
    kxk DCT coefficients — libjpeg's M/8 scaled decode (jpeg_idct_4x4 etc.,
    OpenCV's IMREAD_REDUCED_*): a k-point inverse DCT of the truncated
    spectrum with the sqrt(k/8) energy rescale folded in."""
    bk = np.zeros((k, k), np.float64)
    for u in range(k):
        a = np.sqrt(1.0 / k) if u == 0 else np.sqrt(2.0 / k)
        for m in range(k):
            bk[m, u] = a * np.cos((2 * m + 1) * u * np.pi / (2 * k))
    w = np.zeros((64, k * k), np.float64)
    scale = k / 8.0  # sqrt(k/8) per axis
    for u in range(k):
        for v in range(k):
            for mx in range(k):
                for my in range(k):
                    w[u * 8 + v, mx * k + my] = bk[mx, u] * bk[my, v] * scale
    return w.astype(np.float32)


@functools.lru_cache(maxsize=4)
def scaled_coef_indices(k: int) -> np.ndarray:
    """Natural-order indices of the top-left kxk DCT coefficients, the only
    rows scaled_idct_kron_matrix(k) reads. A coefficient batch cut to these
    k*k lanes on the host decodes bit-identically while shipping 64/(k*k)
    less data to the device (4x at dct_scale=2, 16x at dct_scale=4)."""
    return np.array([u * 8 + v for u in range(k) for v in range(k)], np.int64)


@functools.lru_cache(maxsize=32)
def _scaled_idct_on(k: int, device: str):
    """(the k*k rows of scaled_idct_kron_matrix(k) that
    scaled_coef_indices(k) names, those indices) on `device`, uploaded
    once."""
    idx = scaled_coef_indices(k)
    return (torch.from_numpy(np.ascontiguousarray(
        scaled_idct_kron_matrix(k)[idx])).to(device),
        torch.from_numpy(idx).to(device))


def _dot_by_residue(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w summed as XLA:CPU sums these narrow dots: four partial sums
    over the lanes of each residue mod 4, in lane order, then
    (s0 + s1) + (s2 + s3)."""
    t = [matmul(a[..., j::4], w[..., j::4, :]) for j in range(4)]
    return (t[0] + t[1]) + (t[2] + t[3])


def dequant_idct_scaled(coefs: torch.Tensor, qtable: torch.Tensor,
                        k: int) -> torch.Tensor:
    """(..., bh, bw, 64) int16 + (64,) or (B, 64) tables -> (..., bh*k,
    bw*k) f32 plane at k/8 scale, level-shifted (+128). The tables fold
    into the matrix rows, per image for a (B, 64) table.

    Also takes HOST-TRUNCATED coefficients (..., bh, bw, k*k) holding only
    the scaled_coef_indices(k) lanes (the table stays 64 wide). Only those
    lanes meet nonzero matrix rows, so both forms contract the k*k lanes
    and agree bit for bit, in the JAX package's sum order
    (_dot_by_residue). The JAX package computes this with an XLA dot on
    every backend, outside any Pallas kernel, so it stays torch matmuls."""
    nc = coefs.shape[-1]
    if nc != 64 and not (nc == k * k and k != 8):
        raise ValueError(
            f"coefficient lane dim must be 64 or {k * k}, got {nc}")
    w_base, idx = _scaled_idct_on(k, str(coefs.device))
    if nc == 64:
        coefs = coefs.index_select(-1, idx)
    q = qtable.to(torch.float32)[..., idx]
    lead = tuple(coefs.shape[:-3])
    bh, bw = coefs.shape[-3], coefs.shape[-2]
    if q.dim() == 1:
        p = _dot_by_residue(coefs.reshape(-1, k * k).to(torch.float32),
                            w_base * q[:, None])
    else:
        b = int(np.prod(lead)) if lead else 1
        p = _dot_by_residue(coefs.reshape(b, -1, k * k).to(torch.float32),
                            w_base[None] * q.reshape(b, -1)[:, :, None])
    p = (p + 128.0).reshape(lead + (bh, bw, k, k)).transpose(-3, -2)
    return p.reshape(lead + (bh * k, bw * k))


def decode_gray(y_coefs: torch.Tensor, qt_luma: torch.Tensor, out_h: int,
                out_w: int, plain: bool = False) -> torch.Tensor:
    """Grayscale decode: (..., bh, bw, 64) int16 -> (..., out_h, out_w) u8
    plane (the JAX function's (..., H, W, 1) without the channel axis).
    Rounds half to even and clips in dequant_idct's u8 epilogue: on the
    card the kernel does so as it stores, and no f32 plane is written."""
    return dequant_idct(y_coefs, qt_luma, plain, "u8")[..., :out_h, :out_w]


# ---------------------------------------------------------------------------
# chroma resampling
# ---------------------------------------------------------------------------

def _upsample2x_axis(x: torch.Tensor, axis: int, out_len: int) -> torch.Tensor:
    """Triangle-filter 2x upsample along axis (libjpeg 'fancy' upsampling):
    out[2i] = (3*x[i] + x[i-1]) / 4, out[2i+1] = (3*x[i] + x[i+1]) / 4,
    with edge replication; computed in f32 (no intermediate rounding)."""
    x = x.movedim(axis, -1)
    n = x.shape[-1]
    left = torch.cat([x[..., :1], x[..., :-1]], dim=-1)
    right = torch.cat([x[..., 1:], x[..., -1:]], dim=-1)
    even = _fma(3.0, x, left) * 0.25
    odd = _fma(3.0, x, right) * 0.25
    out = torch.stack([even, odd], dim=-1).reshape(x.shape[:-1] + (2 * n,))
    return out[..., :out_len].movedim(-1, axis)


def upsample_chroma(plane: torch.Tensor, h_factor: int, v_factor: int,
                    out_h: int, out_w: int) -> torch.Tensor:
    """Upsample a chroma plane by integer factors (1 or 2 per axis)."""
    if v_factor == 2:
        plane = _upsample2x_axis(plane, -2, out_h)
    if h_factor == 2:
        plane = _upsample2x_axis(plane, -1, out_w)
    plane = plane[..., :out_h, :out_w]
    # replicate-pad if the source plane (blocks*8) was smaller than target
    return _pad_to(plane, out_h, out_w)


def downsample_chroma_2x2(plane: torch.Tensor) -> torch.Tensor:
    """2x2 box average (libjpeg h2v2 downsample) on an even-sized plane.
    Summed in the order XLA's two-axis mean reduces on the CPU:
    (x[0,0] + x[0,1]) + (x[1,0] + x[1,1]), then / 4."""
    lead = plane.shape[:-2]
    h, w = plane.shape[-2], plane.shape[-1]
    v = plane.reshape(tuple(lead) + (h // 2, 2, w // 2, 2))
    return ((v[..., 0, :, 0] + v[..., 0, :, 1])
            + (v[..., 1, :, 0] + v[..., 1, :, 1])) / 4.0


# ---------------------------------------------------------------------------
# color conversion (BT.601 full-range, libjpeg constants)
# ---------------------------------------------------------------------------

def ycbcr_to_bgr(y: torch.Tensor, cb: torch.Tensor,
                 cr: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """f32 Y/Cb/Cr planes -> (b, g, r) u8 planes (round half to even,
    clip). The JAX function stacks them on a minor axis; the port keeps
    planes, the layout its consumers take."""
    return centered_ycc_to_bgr(y, cb - 128.0, cr - 128.0)


def _bgr_to_ycc(b, g, r):
    """f32 B/G/R planes -> Y, Cb, Cr planes, with XLA's CPU fusions."""
    y = _fma(0.114, b, _fma(0.299, r, 0.587 * g))
    cb = _fma(0.5, b, _fma(-0.168735892, r, -0.331264108 * g)) + 128.0
    cr = _fma(-0.081312411, b, _fma(0.5, r, -0.418687589 * g)) + 128.0
    return y, cb, cr


def bgr_to_ycbcr(img: torch.Tensor):
    """(..., H, W, 3+) BGR(A) -> (y, cb, cr) f32 planes."""
    f = img.to(torch.float32)
    return _bgr_to_ycc(f[..., 0], f[..., 1], f[..., 2])


def centered_ycc_to_bgr(y: torch.Tensor, cbc: torch.Tensor,
                        crc: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """ycbcr_to_bgr from chroma already centred on 0 (C - 128)."""
    r = _fma(1.402, crc, y)
    g = _fma(-0.714136286, crc, _fma(-0.344136286, cbc, y))
    b = _fma(1.772, cbc, y)
    return tuple(torch.clamp(torch.round(p), 0, 255).to(torch.uint8)
                 for p in (b, g, r))


# ---------------------------------------------------------------------------
# decode (device kernels) / encode
# ---------------------------------------------------------------------------

def _layout_ok(ysh, csh, crsh, h2: bool, v2: bool) -> bool:
    """The JAX package's shape gate (jpeg_kernels.py:438-458): the chroma
    block grid is the luma grid halved (rounding up) along each
    subsampled axis, and Cb matches Cr."""
    def half(n):
        return -(-n // 2)
    return (csh == crsh
            and csh == (half(ysh[0]) if v2 else ysh[0],
                        half(ysh[1]) if h2 else ysh[1]))


def decode_ycc_u8_plane_blocks(y_coefs, cb_coefs, cr_coefs, qt_luma,
                               qt_chroma, h2: bool, v2: bool,
                               plain: bool = False):
    """4:2:0 decode of (B, ybh, ybw, 64) luma + 2x (B, cbh, cbw, 64) chroma
    int16 coefficients with per-image (B, 64) tables to three u8 RASTER
    planes (b, g, r), each (B, 16·cbh, 16·cbw). Returns None when the
    shapes are not 4:2:0 (the same gate as the JAX function).

    The JAX function returns the planes in Mosaic's block-vector layout and
    relayouts them afterwards; the CUDA kernel indexes pixels directly and
    writes raster planes. plain=True computes the same planes with the
    plain PyTorch version (decode_kernels.decode_ycc_reference)."""
    if not (h2 and v2):
        return None
    return _decode_ycc(y_coefs, cb_coefs, cr_coefs, qt_luma, qt_chroma,
                       None, None, True, True, "planes", plain)


def _decode_ycc(y_coefs, cb_coefs, cr_coefs, qt_luma, qt_chroma,
                out_h: Optional[int], out_w: Optional[int], h2: bool,
                v2: bool, out: str, plain: bool):
    """The layout's kernel (or its plain version) behind the JAX shape
    gate, outputs cropped to (out_h, out_w) unless those are None."""
    if not _layout_ok(tuple(y_coefs.shape[-3:-1]),
                      tuple(cb_coefs.shape[-3:-1]),
                      tuple(cr_coefs.shape[-3:-1]), h2, v2):
        return None
    from . import decode_kernels as DK
    lead = tuple(y_coefs.shape[:-3])
    b = int(np.prod(lead)) if lead else 1
    args = [c.reshape((b,) + tuple(c.shape[-3:]))
            for c in (y_coefs, cb_coefs, cr_coefs)]
    args += [fold_qtables(qt_luma), fold_qtables(qt_chroma)]
    if plain:
        res = DK.decode_ycc_reference(*args, h2, v2, out=out)
    else:
        res = getattr(DK, DK.kernel_for(h2, v2))(*args, out=out)

    def crop(p):
        p = p[:, :out_h, :out_w]
        return p if lead == (b,) else p.reshape(lead + tuple(p.shape[1:]))
    return tuple(crop(p) for p in res) if out == "planes" else crop(res)


def decode_ycc_packed(y_coefs, cb_coefs, cr_coefs, qt_luma, qt_chroma,
                      out_h: int, out_w: int, h2: bool, v2: bool,
                      plain: bool = False):
    """Decode to PACKED BGRA int32 (lead + (out_h, out_w)), or None when
    the coefficient shapes do not fit the declared layout (4:2:0, 4:2:2,
    4:4:0 and 4:4:4 are all covered), as the JAX function does. Each
    layout runs its own kernel (decode_kernels); plain=True runs the plain
    PyTorch version instead."""
    return _decode_ycc(y_coefs, cb_coefs, cr_coefs, qt_luma, qt_chroma,
                       out_h, out_w, h2, v2, "packed", plain)


def decode_ycc_planes(y_coefs, cb_coefs, cr_coefs, qt_luma, qt_chroma,
                      out_h: int, out_w: int, h2: bool, v2: bool,
                      plain: bool = False):
    """decode_ycc_packed's planes form, the serving tail's input: (b, g, r)
    u8 raster planes, each lead + (out_h, out_w), or None off-spec. The
    values are those of packed_to_planes(decode_ycc_packed(...)); the
    kernel writes them as planes directly."""
    return _decode_ycc(y_coefs, cb_coefs, cr_coefs, qt_luma, qt_chroma,
                       out_h, out_w, h2, v2, "planes", plain)


def decode_ycc_420(y_coefs, cb_coefs, cr_coefs, qt_luma, qt_chroma,
                   out_h: int, out_w: int, h2: bool, v2: bool,
                   qt_chroma2=None, plain: bool = False):
    """Full colour decode from coefficients (4:4:4, 4:2:2, 4:2:0, 4:4:0) to
    (b, g, r) u8 planes, each lead + (out_h, out_w); the JAX function
    stacks the same values on a minor axis.

    As in the JAX function, the layout's decode kernel runs first
    (decode_ycc_planes); the split path (dequant_idct, upsample_chroma,
    ycbcr_to_bgr) runs when the shapes are off-spec for the layout or Cr
    has its own table (qt_chroma2), which the kernels do not carry.
    plain=True runs the plain versions of the kernels."""
    if qt_chroma2 is None:
        planes = decode_ycc_planes(y_coefs, cb_coefs, cr_coefs, qt_luma,
                                   qt_chroma, out_h, out_w, h2, v2, plain)
        if planes is not None:
            return planes
    y = dequant_idct(y_coefs, qt_luma, plain)[..., :out_h, :out_w]
    cb = dequant_idct(cb_coefs, qt_chroma, plain)
    cr = dequant_idct(cr_coefs,
                      qt_chroma if qt_chroma2 is None else qt_chroma2, plain)
    hf, vf = 1 + h2, 1 + v2
    return ycbcr_to_bgr(y, upsample_chroma(cb, hf, vf, out_h, out_w),
                        upsample_chroma(cr, hf, vf, out_h, out_w))


def _round_u8(x: torch.Tensor) -> torch.Tensor:
    """f32 -> u8: round half to even, clip to 0..255."""
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)


def decode_rgb(r_coefs, g_coefs, b_coefs, qt_r, qt_g, qt_b,
               out_h: int, out_w: int, h2: bool, v2: bool,
               plain: bool = False) -> torch.Tensor:
    """3-component JCS_RGB decode (libjpeg's null_convert: no colour
    matrix) to (..., out_h, out_w, 3) BGR u8. Each plane goes through
    dequant_idct's f32 epilogue, so on the card dequant_idct_blocks runs
    three times; G and B upsample like chroma when subsampled."""
    r = dequant_idct(r_coefs, qt_r, plain)[..., :out_h, :out_w]
    g = dequant_idct(g_coefs, qt_g, plain)
    b = dequant_idct(b_coefs, qt_b, plain)
    hf, vf = 1 + h2, 1 + v2
    g = upsample_chroma(g, hf, vf, out_h, out_w)
    b = upsample_chroma(b, hf, vf, out_h, out_w)
    return _round_u8(torch.stack([b, g, r], dim=-1))


def decode_cmyk(c0, c1, c2, c3, qt0, qt1, qt2, qt3, out_h: int, out_w: int,
                ycck: bool, inverted: bool,
                plain: bool = False) -> torch.Tensor:
    """4-component (CMYK / YCCK) decode to (..., out_h, out_w, 3) BGR u8
    (four launches of dequant_idct_blocks on the card).

    Adobe-marked files store inverted ink values, so R = C*K/255 on the
    decoded samples; YCCK first undoes the YCbCr transform on the CMY
    channels (libjpeg's ycck_cmyk_convert), with XLA's CPU fusions
    written out as in centered_ycc_to_bgr."""
    # YCCK chroma skips the level shift: the JAX package adds 128 in its
    # IDCT and subtracts it here, and XLA folds (x + 128) - 128 to x (as
    # for 4:4:4 chroma, decode_ycc_reference); the centered epilogue
    # leaves it out
    p = [dequant_idct(c, q, plain,
                      "centered" if ycck and i in (1, 2) else "f32")
         [..., :out_h, :out_w]
         for i, (c, q) in enumerate(((c0, qt0), (c1, qt1), (c2, qt2),
                                     (c3, qt3)))]
    if ycck:
        cbc, crc = p[1], p[2]
        vc = _fma(1.402, crc, p[0])
        vm = _fma(-0.714136286, crc, _fma(-0.344136286, cbc, p[0]))
        vy = _fma(1.772, cbc, p[0])
    else:
        vc, vm, vy = p[0], p[1], p[2]
    vk = p[3]
    if not inverted:  # no Adobe marker: samples are true ink coverage
        vc, vm, vy, vk = 255.0 - vc, 255.0 - vm, 255.0 - vy, 255.0 - vk
    inv255 = float(np.float32(1.0 / 255.0))
    vc, vm, vy, vk = (torch.clamp(v, 0.0, 255.0) for v in (vc, vm, vy, vk))
    out = torch.stack([vy * vk * inv255, vm * vk * inv255, vc * vk * inv255],
                      dim=-1)
    return _round_u8(out)


def packed_to_planes(packed: torch.Tensor):
    """Packed BGRA int32 -> (b, g, r) f32 planes (exact u8 values)."""
    return tuple(((packed >> s) & 255).to(torch.float32) for s in (0, 8, 16))


def _pad_to(plane: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Edge-replicate pad of the last two axes up to (h, w)."""
    ph, pw = h - plane.shape[-2], w - plane.shape[-1]
    if ph > 0:
        plane = torch.cat([plane, plane[..., -1:, :].expand(
            plane.shape[:-2] + (ph, plane.shape[-1]))], dim=-2)
    if pw > 0:
        plane = torch.cat([plane, plane[..., -1:].expand(
            plane.shape[:-1] + (pw,))], dim=-1)
    return plane


def fdct_quant(plane: torch.Tensor, qtable: torch.Tensor) -> torch.Tensor:
    """(..., H8, W8) f32 (0..255) -> (..., H8/8, W8/8, 64) int16 quantized.

    Forward transform + quantization divide fold into one (N,64)x(64,64)
    matmul (W_f = W^T with 1/q folded into the output columns); round half
    to even, clip to ±2047."""
    wf = (idct_kron(plane.device).transpose(0, 1)
          / qtable.to(torch.float32)[None, :])
    lead = plane.shape[:-2]
    h, w = plane.shape[-2], plane.shape[-1]
    bh, bw = h // 8, w // 8
    p = plane.reshape(tuple(lead) + (bh, 8, bw, 8)).transpose(-3, -2)
    k = matmul(p.reshape(-1, 64) - 128.0, wf)
    q = torch.clamp(torch.round(k), -2047, 2047).to(torch.int16)
    return q.reshape(tuple(lead) + (bh, bw, 64))


def _encode_ycc(y, cb, cr, qt_luma, qt_chroma, subsample: bool):
    h, w = y.shape[-2], y.shape[-1]
    mcu = 16 if subsample else 8
    ph = (h + mcu - 1) // mcu * mcu
    pw = (w + mcu - 1) // mcu * mcu
    y = _pad_to(y, ph, pw)
    cb = _pad_to(cb, ph, pw)
    cr = _pad_to(cr, ph, pw)
    if subsample:
        cb = downsample_chroma_2x2(cb)
        cr = downsample_chroma_2x2(cr)
    return (fdct_quant(y, qt_luma),
            fdct_quant(cb, qt_chroma),
            fdct_quant(cr, qt_chroma))


def encode_from_bgr_planes(bpl, gpl, rpl, qt_luma, qt_chroma,
                           subsample: bool = True):
    """Three (..., H, W) f32 planes holding exact u8 values -> (y, cb, cr)
    quantized int16 coefficient arrays, 4:2:0 when subsample else 4:4:4."""
    return _encode_ycc(*_bgr_to_ycc(bpl, gpl, rpl), qt_luma, qt_chroma,
                       subsample)


def encode_from_bgr(img, qt_luma, qt_chroma, subsample: bool = True):
    """(..., H, W, 3+) u8 BGR(A) -> (y, cb, cr) quantized int16 coefficient
    arrays, 4:2:0 when subsample else 4:4:4. Alpha is ignored."""
    return _encode_ycc(*bgr_to_ycbcr(img[..., :3]), qt_luma, qt_chroma,
                       subsample)


def encode_gray_from_u8(img, qt_luma):
    """(..., H, W, 1) u8 -> quantized luma coefficients (the MCU padding
    edge-replicated to multiples of 8)."""
    y = img[..., 0].to(torch.float32)
    h, w = y.shape[-2], y.shape[-1]
    return fdct_quant(_pad_to(y, (h + 7) // 8 * 8, (w + 7) // 8 * 8),
                      qt_luma)
