"""The 4:2:0 decode kernel: CUDA on the card, plain PyTorch beside it.

The counterpart of ``lilliput_tpu/ops/pallas_kernels.py`` for the JPEG Fit
slice. ``decode420`` replaces the Pallas 4:2:0 megakernel
(``pallas_kernels._decode420_call``, the ``pl.pallas_call`` at its line
437): per-image dequant + 8x8 IDCT of Y/Cb/Cr, libjpeg's "fancy" triangle
chroma upsample (vertical, then horizontal, edges replicated at the
window's chroma plane edge), YCbCr->BGR, round half to even, clip to u8.
It writes three raster u8 planes (the serving path) or packed BGRA int32.

* A CUDA tensor launches the kernel of ``csrc/decode420.cu`` (built with
  nvcc for sm_90a at first use, see ``_build.py``) or the call raises.
* A CPU tensor takes ``decode420_reference``, the plain PyTorch version
  (the JAX package's split decode), which the tests hold bit-identical to
  the JAX package on the CPU.

``launches`` counts kernel launches (plain-version calls do not count), so
a run can show the serving path went through the kernel.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from . import _build
from . import jpeg_kernels as K

launches = 0

_ALPHA_FF = -16777216  # 0xFF000000 as int32 (alpha byte of a packed pixel)
_SOURCES = (os.path.join(_build.CSRC_DIR, "decode420.cu"),)
_lock = threading.Lock()
_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build.build_cuda("libdecode420", _SOURCES))
            vp = ctypes.c_void_p
            lib.lpt_decode420.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp,
                                          ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_int, vp]
            lib.lpt_decode420.restype = ctypes.c_int
            lib.lpt_cuda_error_string.argtypes = [ctypes.c_int]
            lib.lpt_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def build() -> str:
    """Build (or find) the kernel library; returns its path."""
    _load()
    return _build.build_cuda("libdecode420", _SOURCES)


def _check(yc, cb, cr, wqy, wqc, out: str):
    if out not in ("planes", "packed"):
        raise ValueError("out must be 'planes' or 'packed'")
    for name, t, dt in (("yc", yc, torch.int16), ("cb", cb, torch.int16),
                        ("cr", cr, torch.int16), ("wqy", wqy, torch.float32),
                        ("wqc", wqc, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != yc.device:
            raise ValueError(f"{name} is on {t.device}, yc on {yc.device}")
    if cb.dim() != 4 or cb.shape[-1] != 64 or cr.shape != cb.shape:
        raise ValueError(f"chroma must be (B, cbh, cbw, 64) pairs, got "
                         f"{tuple(cb.shape)} and {tuple(cr.shape)}")
    b, cbh, cbw = cb.shape[:3]
    if (yc.dim() != 4 or yc.shape[0] != b or yc.shape[-1] != 64
            or not 2 * cbh - 1 <= yc.shape[1] <= 2 * cbh
            or not 2 * cbw - 1 <= yc.shape[2] <= 2 * cbw):
        raise ValueError(f"luma {tuple(yc.shape)} is not the 4:2:0 "
                         f"partner of chroma {tuple(cb.shape)}")
    for name, w in (("wqy", wqy), ("wqc", wqc)):
        if w.shape not in ((b, 64, 64), (1, 64, 64)):
            raise ValueError(f"{name} must be (B, 64, 64), got "
                             f"{tuple(w.shape)}")


def _pad_luma(yc: torch.Tensor, cbh: int, cbw: int) -> torch.Tensor:
    """Zero-pad luma to 2·cbh x 2·cbw blocks (pallas_kernels.py:401-402):
    zero coefficients decode to exact 128 and the caller crops them."""
    ph, pw = 2 * cbh - yc.shape[1], 2 * cbw - yc.shape[2]
    if ph or pw:
        yc = torch.nn.functional.pad(yc, (0, 0, 0, pw, 0, ph))
    return yc


def decode420(yc: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
              wqy: torch.Tensor, wqc: torch.Tensor, out: str = "planes"):
    """(B, ybh, ybw, 64) luma + 2x (B, cbh, cbw, 64) chroma int16 with
    per-image dequant-folded IDCT matrices (B, 64, 64) f32 ->
    out="planes": (b, g, r) u8 planes, each (B, 16·cbh, 16·cbw);
    out="packed": int32 (B, 16·cbh, 16·cbw), B | G<<8 | R<<16 | 0xFF<<24.
    Rows and columns past the true image are decoded too; callers crop."""
    _check(yc, cb, cr, wqy, wqc, out)
    if yc.device.type == "cpu":
        return decode420_reference(yc, cb, cr, wqy, wqc, out)
    if yc.device.type != "cuda":
        raise ValueError(f"decode420 runs on cuda or cpu, not {yc.device}")
    global launches
    lib = _load()
    b, cbh, cbw = cb.shape[:3]
    yc = _pad_luma(yc, cbh, cbw).contiguous()
    cb, cr = cb.contiguous(), cr.contiguous()
    wqy = wqy.expand(b, 64, 64).contiguous()
    wqc = wqc.expand(b, 64, 64).contiguous()
    shape = (b, 16 * cbh, 16 * cbw)
    if out == "planes":
        outs = tuple(torch.empty(shape, dtype=torch.uint8, device=yc.device)
                     for _ in range(3))
        ptrs = [o.data_ptr() for o in outs]
    else:
        outs = (torch.empty(shape, dtype=torch.int32, device=yc.device),)
        ptrs = [outs[0].data_ptr(), None, None]
    with torch.cuda.device(yc.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lpt_decode420(yc.data_ptr(), cb.data_ptr(), cr.data_ptr(),
                               wqy.data_ptr(), wqc.data_ptr(), *ptrs,
                               int(out == "packed"), b, cbh, cbw, stream)
    if rc != 0:
        raise RuntimeError("decode420 kernel launch failed: "
                           + lib.lpt_cuda_error_string(rc).decode())
    launches += 1
    return outs if out == "planes" else outs[0]


def decode420_reference(yc: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                        wqy: torch.Tensor, wqc: torch.Tensor,
                        out: str = "planes"):
    """Plain PyTorch version of decode420 (same arguments, same outputs):
    the JAX package's split decode — batched dequant+IDCT matmuls, the
    two-pass triangle upsample, then colour conversion — on any device."""
    _check(yc, cb, cr, wqy, wqc, out)
    cbh, cbw = cb.shape[1:3]
    oh, ow = 16 * cbh, 16 * cbw
    y = K.idct_folded(_pad_luma(yc, cbh, cbw), wqy)
    cbu = K.upsample_chroma(K.idct_folded(cb, wqc), 2, 2, oh, ow)
    cru = K.upsample_chroma(K.idct_folded(cr, wqc), 2, 2, oh, ow)
    bgr = K.ycbcr_to_bgr(y, cbu, cru)
    if out == "planes":
        return bgr
    bb, gg, rr = (p.to(torch.int32) for p in bgr)
    return bb | (gg << 8) | (rr << 16) | _ALPHA_FF
