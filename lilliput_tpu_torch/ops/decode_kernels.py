"""The JPEG decode kernels: CUDA on the card, plain PyTorch beside them.

The counterpart of ``lilliput_tpu/ops/pallas_kernels.py``. One kernel per
chroma layout, each replacing one Pallas megakernel, and the split path's
IDCT:

===================  =======================  ===============================
wrapper              CUDA source              TPU kernel (``pl.pallas_call``)
===================  =======================  ===============================
decode420            ``csrc/decode420.cu``    ``_decode420_call`` (:437)
decode422            ``csrc/decode422.cu``    ``decode422_packed`` (:563)
decode440            ``csrc/decode440.cu``    ``decode440_packed`` (:713)
decode444            ``csrc/decode444.cu``    ``decode444_packed`` (:792)
dequant_idct_blocks  ``csrc/idct_blocks.cu``  ``dequant_idct_blocks`` (:63)
===================  =======================  ===============================

Each decode kernel does per-image dequant + 8x8 IDCT of Y/Cb/Cr, libjpeg's
"fancy" triangle chroma upsample along the subsampled axes (edges
replicated at the window's chroma plane edge), YCbCr->BGR, round half to
even and a clip to u8. It writes three raster u8 planes (the serving path)
or packed BGRA int32 (what the TPU kernels compute). ``dequant_idct_blocks``
is the dequant + IDCT alone, to an f32 raster plane: the split decode's
first stage, which the grayscale path and the off-spec colour fallback run.
Its u8 epilogue rounds and clips as it stores, the grayscale decode's
plane.

* A CUDA tensor launches the kernel (built with nvcc for sm_90a at first
  use, see ``_build.py``) or the call raises.
* A CPU tensor takes the plain PyTorch version (``decode_ycc_reference``,
  the JAX package's split decode; ``dequant_idct_blocks_reference``), which
  the tests hold bit-identical to the JAX package on the CPU.

``launches[name]`` counts each kernel's launches (plain-version calls do
not count), so a run can show the serving path went through the kernel.
"""

from __future__ import annotations

import ctypes
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

import torch

from . import _build
from . import jpeg_kernels as K

#: wrapper name -> (library, h2, v2): the chroma layout each kernel decodes
_KERNELS = {
    "decode420": ("libdecode420", True, True),
    "decode422": ("libdecode422", True, False),
    "decode440": ("libdecode440", False, True),
    "decode444": ("libdecode444", False, False),
}
#: the split-path IDCT's library
_IDCT_LIB = "libidct_blocks"
#: library -> its CUDA source
_LIBS = {"libdecode420": "decode420.cu",
         "libdecode422": "decode422.cu",
         "libdecode440": "decode440.cu",
         "libdecode444": "decode444.cu",
         _IDCT_LIB: "idct_blocks.cu"}

launches: Dict[str, int] = dict.fromkeys(
    list(_KERNELS) + ["dequant_idct_blocks"], 0)

_ALPHA_FF = -16777216  # 0xFF000000 as int32 (alpha byte of a packed pixel)
_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def kernel_for(h2: bool, v2: bool) -> str:
    """Name of the kernel that decodes chroma sampled (h2, v2)."""
    return next(n for n, (_, h, v) in _KERNELS.items() if (h, v) == (h2, v2))


def _source(lib: str):
    return (os.path.join(_build.CSRC_DIR, _LIBS[lib]),)


def _load(name: str) -> ctypes.CDLL:
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(_build.build_cuda(name, _source(name)))
            vp = ctypes.c_void_p
            for k, (lib_name, _, _) in _KERNELS.items():
                if lib_name == name:
                    fn = getattr(lib, "lpt_" + k)
                    fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, vp]
                    fn.restype = ctypes.c_int
            if name == _IDCT_LIB:
                for fn in (lib.lpt_dequant_idct_blocks,
                           lib.lpt_dequant_idct_blocks_u8):
                    fn.argtypes = [vp, vp, vp, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int, vp]
                    fn.restype = ctypes.c_int
            lib.lpt_cuda_error_string.argtypes = [ctypes.c_int]
            lib.lpt_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    return _libs[name]


def build() -> Dict[str, str]:
    """Build (or find) every kernel library, one nvcc per source, all at
    once; returns {library: path}."""
    with ThreadPoolExecutor(len(_LIBS)) as ex:
        paths = dict(zip(_LIBS, ex.map(
            lambda n: _build.build_cuda(n, _source(n)), _LIBS)))
    for name in _LIBS:
        _load(name)
    return paths


def _check(yc, cb, cr, wqy, wqc, fx: int, fy: int, out: str):
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
            or not fy * cbh - fy + 1 <= yc.shape[1] <= fy * cbh
            or not fx * cbw - fx + 1 <= yc.shape[2] <= fx * cbw):
        raise ValueError(f"luma {tuple(yc.shape)} is not the {fx}x{fy} "
                         f"partner of chroma {tuple(cb.shape)}")
    for name, w in (("wqy", wqy), ("wqc", wqc)):
        if w.shape not in ((b, 64, 64), (1, 64, 64)):
            raise ValueError(f"{name} must be (B, 64, 64), got "
                             f"{tuple(w.shape)}")


def _pad_luma(yc: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Zero-pad luma to rows x cols blocks (pallas_kernels.py:401-402,
    :554-555, :686-687): zero coefficients decode to exact 128 and the
    caller crops them."""
    ph, pw = rows - yc.shape[1], cols - yc.shape[2]
    if ph or pw:
        yc = torch.nn.functional.pad(yc, (0, 0, 0, pw, 0, ph))
    return yc


def _launch(lib: ctypes.CDLL, name: str, device, *args,
            entry: str = "") -> None:
    """Call lpt_<name><entry> on the device's current stream, raise on a
    non-zero launch status, and count the launch under `name`."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, "lpt_" + name + entry)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + lib.lpt_cuda_error_string(rc).decode())
    launches[name] += 1


def _decode(name: str, yc, cb, cr, wqy, wqc, out: str):
    lib_name, h2, v2 = _KERNELS[name]
    fx, fy = 1 + h2, 1 + v2
    _check(yc, cb, cr, wqy, wqc, fx, fy, out)
    if yc.device.type == "cpu":
        return decode_ycc_reference(yc, cb, cr, wqy, wqc, h2, v2, out)
    if yc.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {yc.device}")
    lib = _load(lib_name)
    b, cbh, cbw = cb.shape[:3]
    yc = _pad_luma(yc, fy * cbh, fx * cbw).contiguous()
    cb, cr = cb.contiguous(), cr.contiguous()
    wqy = wqy.expand(b, 64, 64).contiguous()
    wqc = wqc.expand(b, 64, 64).contiguous()
    for t in (yc, cb, cr, wqy, wqc):
        if t.data_ptr() % 16:  # the kernel loads 16 bytes at a time
            raise ValueError(f"{name}: inputs must be 16-byte aligned")
    shape = (b, 8 * fy * cbh, 8 * fx * cbw)
    if out == "planes":
        outs = tuple(torch.empty(shape, dtype=torch.uint8, device=yc.device)
                     for _ in range(3))
        ptrs = [o.data_ptr() for o in outs]
    else:
        outs = (torch.empty(shape, dtype=torch.int32, device=yc.device),)
        ptrs = [outs[0].data_ptr(), None, None]
    _launch(lib, name, yc.device, yc.data_ptr(), cb.data_ptr(),
            cr.data_ptr(), wqy.data_ptr(), wqc.data_ptr(), *ptrs,
            int(out == "packed"), b, cbh, cbw)
    return outs if out == "planes" else outs[0]


def decode420(yc: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
              wqy: torch.Tensor, wqc: torch.Tensor, out: str = "planes"):
    """4:2:0: (B, ybh, ybw, 64) luma + 2x (B, cbh, cbw, 64) chroma int16
    with per-image dequant-folded IDCT matrices (B, 64, 64) f32 ->
    out="planes": (b, g, r) u8 planes, each (B, 16·cbh, 16·cbw);
    out="packed": int32 (B, 16·cbh, 16·cbw), B | G<<8 | R<<16 | 0xFF<<24.
    Rows and columns past the true image are decoded too; callers crop."""
    return _decode("decode420", yc, cb, cr, wqy, wqc, out)


def decode422(yc: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
              wqy: torch.Tensor, wqc: torch.Tensor, out: str = "planes"):
    """4:2:2 (chroma halved along columns only): (B, bh, ybw, 64) luma +
    2x (B, bh, cbw, 64) chroma -> planes or packed (B, 8·bh, 16·cbw), as
    decode420."""
    return _decode("decode422", yc, cb, cr, wqy, wqc, out)


def decode440(yc: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
              wqy: torch.Tensor, wqc: torch.Tensor, out: str = "planes"):
    """4:4:0 (chroma halved along rows only): (B, ybh, bw, 64) luma +
    2x (B, cbh, bw, 64) chroma -> planes or packed (B, 16·cbh, 8·bw), as
    decode420."""
    return _decode("decode440", yc, cb, cr, wqy, wqc, out)


def decode444(yc: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
              wqy: torch.Tensor, wqc: torch.Tensor, out: str = "planes"):
    """4:4:4: 3x (B, bh, bw, 64) -> planes or packed (B, 8·bh, 8·bw), as
    decode420."""
    return _decode("decode444", yc, cb, cr, wqy, wqc, out)


def decode_ycc_reference(yc: torch.Tensor, cb: torch.Tensor,
                         cr: torch.Tensor, wqy: torch.Tensor,
                         wqc: torch.Tensor, h2: bool, v2: bool,
                         out: str = "planes"):
    """Plain PyTorch version of the decode kernels (the kernel's arguments,
    the layout's (h2, v2), the kernel's outputs): the JAX package's split
    decode — batched dequant+IDCT matmuls, the triangle upsample along each
    subsampled axis, then colour conversion — on any device.

    4:4:4 chroma skips the level shift: the JAX package adds 128 to the
    IDCT sum and subtracts it again (pallas_kernels.py:754-757, and the
    split path), and XLA folds (x + 128) - 128 to x when it compiles
    either; keeping the round trip moves 18 of 2,384,640 u8 values of the
    4:4:4 fixture's window by 1 against the JAX package."""
    fx, fy = 1 + h2, 1 + v2
    _check(yc, cb, cr, wqy, wqc, fx, fy, out)
    cbh, cbw = cb.shape[1:3]
    oh, ow = 8 * fy * cbh, 8 * fx * cbw
    y = K.idct_folded(_pad_luma(yc, fy * cbh, fx * cbw), wqy)
    if h2 or v2:
        cbu = K.upsample_chroma(K.idct_folded(cb, wqc), fx, fy, oh, ow)
        cru = K.upsample_chroma(K.idct_folded(cr, wqc), fx, fy, oh, ow)
        bgr = K.ycbcr_to_bgr(y, cbu, cru)
    else:
        bgr = K.centered_ycc_to_bgr(
            y, K.idct_folded(cb, wqc, level_shift=False),
            K.idct_folded(cr, wqc, level_shift=False))
    if out == "planes":
        return bgr
    bb, gg, rr = (p.to(torch.int32) for p in bgr)
    return bb | (gg << 8) | (rr << 16) | _ALPHA_FF


def _check_idct(coefs: torch.Tensor, wq: torch.Tensor, out: str) -> None:
    if out not in ("f32", "u8"):
        raise ValueError("out must be 'f32' or 'u8'")
    if coefs.dtype != torch.int16:
        raise TypeError(f"coefs must be torch.int16, got {coefs.dtype}")
    if wq.dtype != torch.float32:
        raise TypeError(f"wq must be torch.float32, got {wq.dtype}")
    if wq.device != coefs.device:
        raise ValueError(f"wq is on {wq.device}, coefs on {coefs.device}")
    if coefs.dim() != 4 or coefs.shape[-1] != 64:
        raise ValueError(f"coefs must be (B, bh, bw, 64), got "
                         f"{tuple(coefs.shape)}")
    if wq.shape not in ((coefs.shape[0], 64, 64), (1, 64, 64)):
        raise ValueError(f"wq must be (B, 64, 64) or (1, 64, 64), got "
                         f"{tuple(wq.shape)}")


def dequant_idct_blocks(coefs: torch.Tensor, wq: torch.Tensor,
                        out: str = "f32") -> torch.Tensor:
    """(B, bh, bw, 64) int16 coefficients with dequant-folded IDCT matrices
    (B, 64, 64) f32, or one (1, 64, 64) shared by every image -> (B, 8·bh,
    8·bw) raster plane of coef·W_q + 128 per 8x8 block: out="f32"
    unrounded (what the TPU kernel computes); out="u8" rounded half to even
    and clipped to 0..255 (decode_gray's round, clamp and cast, done as the
    kernel stores)."""
    _check_idct(coefs, wq, out)
    if coefs.device.type == "cpu":
        return dequant_idct_blocks_reference(coefs, wq, out)
    if coefs.device.type != "cuda":
        raise ValueError(f"dequant_idct_blocks runs on cuda or cpu, not "
                         f"{coefs.device}")
    lib = _load(_IDCT_LIB)
    coefs, wq = coefs.contiguous(), wq.contiguous()
    for t in (coefs, wq):
        if t.data_ptr() % 16:  # the kernel loads 16 bytes at a time
            raise ValueError("dequant_idct_blocks: inputs must be 16-byte "
                             "aligned")
    b, bh, bw = coefs.shape[:3]
    res = torch.empty((b, 8 * bh, 8 * bw), device=coefs.device,
                      dtype=torch.uint8 if out == "u8" else torch.float32)
    _launch(lib, "dequant_idct_blocks", coefs.device, coefs.data_ptr(),
            wq.data_ptr(), res.data_ptr(), b, bh, bw, int(wq.shape[0] != 1),
            entry="_u8" if out == "u8" else "")
    return res


def dequant_idct_blocks_reference(coefs: torch.Tensor, wq: torch.Tensor,
                                  out: str = "f32") -> torch.Tensor:
    """Plain PyTorch version of dequant_idct_blocks (same arguments and
    result), on any device: one batched f32 matmul, + 128, relayout; for
    out="u8" then round and clip the fresh plane in place, and cast."""
    _check_idct(coefs, wq, out)
    p = K.idct_folded(coefs, wq)
    return p.round_().clamp_(0.0, 255.0).to(torch.uint8) if out == "u8" else p
