"""JPEG dense transforms of the serving slice (torch).

The subset of ``lilliput_tpu/ops/jpeg_kernels.py`` the JPEG Fit slice runs:

Decode: coefs -> dequant -> IDCT -> +128 -> fancy (triangle) chroma upsample
        -> YCbCr->BGR -> u8.   (one CUDA kernel on the card, decode_kernels)
Encode: BGR -> YCbCr -> pad to MCU -> 2x2 box chroma downsample -> -128 ->
        fDCT -> quantize(round) -> int16 coefs.

The IDCT and fDCT are (N,64)x(64,64) f32 matmuls with the quantization
folded into the matrix, as in the JAX package; the constant tables come
from the same numpy code and are equal bit for bit. The split decode
(``dequant_idct``, ``upsample_chroma``, ``ycbcr_to_bgr``) is the plain
version of the decode kernel.

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
from typing import Tuple

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


@functools.lru_cache(maxsize=8)
def _idct_kron_on(device: str) -> torch.Tensor:
    return torch.from_numpy(idct_kron_matrix()).to(device)


def idct_kron(device) -> torch.Tensor:
    """idct_kron_matrix() resident on `device` (uploaded once)."""
    return _idct_kron_on(str(torch.device(device)))


def fold_qtables(qt: torch.Tensor) -> torch.Tensor:
    """(B, 64) or (64,) quant tables -> (B, 64, 64) f32 W_q = diag(q)·W,
    the dequant-folded IDCT matrices (jpeg_kernels.py fold(), in f32;
    uint16 -> f32 is exact)."""
    q = qt.to(torch.float32).reshape(-1, 64)
    return idct_kron(q.device)[None] * q[:, :, None]


def _fma(a: float, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 a*x + c rounded ONCE (a fused multiply-add). The f32 product is
    exact in f64, so the f64 sum rounded to f32 is the fused result except
    when the sum lands within 2^-29 ulp of an f32 tie (vanishingly rare)."""
    return (x.double() * float(np.float32(a)) + c.double()).float()


def _blocks_to_plane(p: torch.Tensor, lead, bh: int, bw: int) -> torch.Tensor:
    """(..., bh*bw, 64) block pixels -> (..., bh*8, bw*8) raster plane."""
    p = p.reshape(tuple(lead) + (bh, bw, 8, 8))
    return p.transpose(-3, -2).reshape(tuple(lead) + (bh * 8, bw * 8))


def idct_folded(coefs: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """(..., bh, bw, 64) int16 with dequant-folded matrices (B or 1, 64, 64)
    -> (..., bh*8, bw*8) f32 pixels, level-shifted: coefs·W_q + 128."""
    lead = coefs.shape[:-3]
    bh, bw = coefs.shape[-3], coefs.shape[-2]
    b = int(np.prod(lead)) if lead else 1
    p = matmul(coefs.reshape(b, -1, 64).to(torch.float32), wq) + 128.0
    return _blocks_to_plane(p, lead, bh, bw)


def dequant_idct(coefs: torch.Tensor, qtable: torch.Tensor) -> torch.Tensor:
    """(..., bh, bw, 64) int16 + (64,) or (B, 64) -> (..., bh*8, bw*8) f32.

    Dequantization folds into the IDCT matrix rows (W_q = diag(q) @ W). A
    2-D qtable carries per-image tables for a (B, bh, bw, 64) stack; each
    image's tables fold into its own matrix (batched matmul)."""
    lead = coefs.shape[:-3]
    if qtable.dim() > 1 and tuple(lead) != tuple(qtable.shape[:-1]):
        raise ValueError(
            f"batched qtable leading dims {tuple(qtable.shape[:-1])} "
            f"must match coefficient leading dims {tuple(lead)}")
    return idct_folded(coefs, fold_qtables(qtable))


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
    cbc = cb - 128.0
    crc = cr - 128.0
    r = _fma(1.402, crc, y)
    g = _fma(-0.714136286, crc, _fma(-0.344136286, cbc, y))
    b = _fma(1.772, cbc, y)
    return tuple(torch.clamp(torch.round(p), 0, 255).to(torch.uint8)
                 for p in (b, g, r))


# ---------------------------------------------------------------------------
# decode (4:2:0 device path) / encode
# ---------------------------------------------------------------------------

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
    plain PyTorch version (decode_kernels.decode420_reference)."""
    if not (h2 and v2):
        return None
    ysh = tuple(y_coefs.shape[-3:-1])
    csh = tuple(cb_coefs.shape[-3:-1])
    if csh != tuple(cr_coefs.shape[-3:-1]):
        return None
    if csh != (-(-ysh[0] // 2), -(-ysh[1] // 2)):
        return None
    from . import decode_kernels as DK
    fn = DK.decode420_reference if plain else DK.decode420
    return fn(y_coefs, cb_coefs, cr_coefs, fold_qtables(qt_luma),
              fold_qtables(qt_chroma), out="planes")


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
    y = _fma(0.114, bpl, _fma(0.299, rpl, 0.587 * gpl))
    cb = _fma(0.5, bpl, _fma(-0.168735892, rpl, -0.331264108 * gpl)) + 128.0
    cr = _fma(-0.081312411, bpl, _fma(0.5, rpl, -0.418687589 * gpl)) + 128.0
    return _encode_ycc(y, cb, cr, qt_luma, qt_chroma, subsample)

