"""GPU smoke run of the port's main path (lilliput_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card; builds the host library (g++: Huffman decode and
encode, PNG row filters) and the kernels (nvcc, sm_90a; one nvcc per
source, all at once) from the sources in this checkout, then drives
fourteen serving paths, each JpegTranscodePipeline(fixture -> 256x256 Fit
JPEG at q85, or PNG, batch 128), fixtures under tests/assets/:

  420, 422, 440, 444  the chroma layouts, upright (bench_1080p{,_422,_440,
                      _444}.jpg), AREA, chroma_mode="rgb", each through its
                      decode kernel;
  gray                grayscale, upright (bench_1080p_gray.jpg): no kernel,
                      the IDCT is a torch matmul as the JAX package's XLA
                      einsum;
  gray_o6             grayscale, EXIF orientation 6 (bench_1080p_gray_o6.jpg),
                      the whole frame through dequant_idct_blocks' u8
                      epilogue;
  420_o6              4:2:0, EXIF orientation 6 (bench_1080p_o6.jpg), the
                      whole frame through decode420;
  420_direct          4:2:0, chroma_mode="direct": no kernel, the IDCTs are
                      torch matmuls (dequant_idct_u8);
  420_direct_s2       4:2:0, chroma_mode="direct", dct_scale=2: no kernel
                      (dequant_idct_scaled), 16 of 64 coefficient lanes
                      shipped;
  420_linear          4:2:0, method="linear": decode420, then the streaming
                      Q11 bilinear;
  444_cubic           4:4:4 (bench_1080p_444.jpg), method="cubic": decode444,
                      then the streaming fixed-point bicubic;
  420_exact           4:2:0 with LILLIPUT_FUSED_EXACT=1 (set for this path
                      only, restored after): decode420, then the exact
                      sequential-tap AREA tail;
  420_png             4:2:0, output_format=".png": decode420 and the block
                      tail, the planes packed to BGRA pixels, PNG on the
                      host;
  gray_o6_png         grayscale o6, output_format=".png": dequant_idct_blocks
                      (u8), gray pixels, 1-channel PNG;

then the single-image surface (the still phase), the overlap check of
transcode_pipelined and the still formats.

1. device and builds: card name and power limit, versions, build seconds;
2. the path's kernel against its plain PyTorch version on the card at the
   serving shape (the fixture's coefficients x128; both epilogues of a
   decode kernel) and, on the kernel's first path, at odd geometries with
   per-image tables (q30/85/95); every kernel also at its band and strip
   edges (EDGE_420, EDGE_422, EDGE_440, EDGE_444, EDGE_IDCT, batches 1 and
   3). dequant_idct_blocks' f32 epilogue is gated on the u8 values
   decode_gray makes of it, its f32 difference printed, and its u8
   epilogue must equal that rounded f32 output (0 differing values);
3. the main path: transcode_pipelined, with every launch count set to 0
   just before and read just after: the path's kernel must launch once per
   device step and no other kernel at all (none on the gray and direct
   paths), every
   output must be a 256x256 JPEG with the source's component count, and
   the device step must agree with the same step through the plain
   version and with the CPU step (2 images, a CPU pipeline built with the
   path's keywords and environment). 4:2:0 runs 3 batches, one
   holding a corrupt buffer that must fail only its own slot, and checks
   that the entropy round trip is lossless; the other paths run 2 batches.
   The .png paths' outputs must decode (the port's PngDecoder on the
   CPU) to 256x256 pixels with the source's channel count, and
   their packed pixels are held to the kernel gate instead;
4. times (CUDA events; host clock around work that ends in a sync): each
   kernel and its plain version (dequant_idct_blocks: the u8 epilogue the
   path runs, and the f32 epilogue beside torch.baddbmm, the one PyTorch
   call computing that function; the bound of each), each
   path's H2D, device step and end-to-end rate, the 4:2:0 stage
   breakdown (also on 420_exact, whose resize is the exact form), the
   direct mode's three IDCTs, and the device's busy share under
   torch.profiler; the H2D of 420_direct_s2's truncated lanes beside
   420's;
5. the still phase: for each fixture, new_decoder(device="cuda") ->
   ImageOps(8192).transform to .jpeg and to .png, Fit 256x256, and one
   decode_to, with every launch count 0 just before and read after: each
   decode launches its layout's kernel (dequant_idct_blocks for gray)
   exactly once. The decoded frame equals the plain decode (from a 2-image
   stack) and the CPU port's under the kernel gate, the .png pixels the
   CPU port's under the same gate, the .jpeg coefficients the CPU port's
   under the step gate. Prints ms per image for decode, transform and
   encode, and each kernel's batch-1 whole-frame time beside its plain
   version and bound;
6. the overlap check: one transcode_pipelined of 4 batches on 4:2:0, in
   which every _to_host of batch i-1 must return while step i's event is
   still pending (event.query() False); images/s and the busy share;
7. the still formats (still_inputs: the JCS_RGB and CMYK fixtures, YCCK,
   six kinds of PNG, BMP, PNM, PAM, Sun Raster, HDR and PFM at 1080p,
   packed from bench_1080p's pixels by tests/_torch_still_builders.py
   and the port's encoders): each decoded with
   device="cuda" with the launch counts 0 just before and read just after
   (dequant_idct_blocks exactly 3 times per JCS_RGB and 4 per CMYK/YCCK
   decode, no kernel for the others), equal to the CPU decode (0
   differing values) and, for the JPEGs, to the plain decode from a
   2-image stack under the kernel gate; ImageOps.transform to .jpeg, .png
   and .thumbhash, Fit 256x256, equal to the CPU port's bytes (.jpeg:
   coefficients under the step gate); thumbhash_batch of the RGBA PNG
   input's 100x100 tiles on the card: grids within THUMB_GRID_ATOL of the
   CPU's, hashes equal but where an AC sits on a rounding tie within the
   grids' difference; one
   in-process CLI run of the PNG input to .jpeg on the card, equal to
   -device cpu's bytes; ms per image
   of decode, transform and each encode, and dequant_idct_blocks' batch-1
   time on a CMYK plane beside torch.baddbmm's.

Prints one line per phase, then the kernels JSON line, the card line, and
as its last line {"ok": true, "device": {...}}. Any failure raises, so the
exit code is non-zero and the last line is not printed. Imports no JAX.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
ASSETS = os.path.join(ROOT, "tests", "assets")
_TPU = "lilliput_tpu/ops/pallas_kernels.py"
_CSRC = "lilliput_tpu_torch/csrc"
#: kernel -> (CUDA source, TPU kernel it replaces, (h2, v2) of a decode
#: kernel's chroma layout)
KERNELS = {
    "decode420": (f"{_CSRC}/decode420.cu", f"{_TPU}:390", (True, True)),
    "decode422": (f"{_CSRC}/decode422.cu", f"{_TPU}:544", (True, False)),
    "decode440": (f"{_CSRC}/decode440.cu", f"{_TPU}:670", (False, True)),
    "decode444": (f"{_CSRC}/decode444.cu", f"{_TPU}:771", (False, False)),
    "dequant_idct_blocks": (f"{_CSRC}/idct_blocks.cu", f"{_TPU}:45", None),
}
IDCT = "dequant_idct_blocks"


class Path(NamedTuple):
    fixture: str
    kernel: "str | None"   # launched once per device step; None: no kernel
    ncomp: int             # output components
    kw: dict = {}          # JpegTranscodePipeline keywords
    env: dict = {}         # environment set for this path only


PATHS = {
    "420": Path("bench_1080p.jpg", "decode420", 3),
    "422": Path("bench_1080p_422.jpg", "decode422", 3),
    "440": Path("bench_1080p_440.jpg", "decode440", 3),
    "444": Path("bench_1080p_444.jpg", "decode444", 3),
    "gray": Path("bench_1080p_gray.jpg", None, 1),
    "gray_o6": Path("bench_1080p_gray_o6.jpg", IDCT, 1),
    "420_o6": Path("bench_1080p_o6.jpg", "decode420", 3),
    "420_direct": Path("bench_1080p.jpg", None, 3,
                       {"chroma_mode": "direct"}),
    "420_direct_s2": Path("bench_1080p.jpg", None, 3,
                          {"chroma_mode": "direct", "dct_scale": 2}),
    "420_linear": Path("bench_1080p.jpg", "decode420", 3,
                       {"method": "linear"}),
    "444_cubic": Path("bench_1080p_444.jpg", "decode444", 3,
                      {"method": "cubic"}),
    "420_exact": Path("bench_1080p.jpg", "decode420", 3, {},
                      {"LILLIPUT_FUSED_EXACT": "1"}),
    "420_png": Path("bench_1080p.jpg", "decode420", 3,
                    {"output_format": ".png"}),
    "gray_o6_png": Path("bench_1080p_gray_o6.jpg", IDCT, 1,
                        {"output_format": ".png"}),
}
#: the still phase's fixtures: every layout, grayscale, and orientation 6
STILLS = ["bench_1080p.jpg", "bench_1080p_422.jpg", "bench_1080p_440.jpg",
          "bench_1080p_444.jpg", "bench_1080p_gray.jpg",
          "bench_1080p_gray_o6.jpg", "bench_1080p_o6.jpg"]
#: H100 SXM data-sheet peaks: HBM bytes/s and f32 non-tensor FLOP/s
HBM_BPS, F32_FLOPS = 3.35e12, 67e12
BATCH = 128
DST = 256
CASES = [(64, 48), (67, 61), (16, 16), (130, 17), (8, 8), (24, 129)]
#: decode420's, decode422's and decode440's band and strip edges (bands of
#: 17 MCU rows; strips of 10, 14 and 16 MCUs), and decode444's (steps of 4
#: and bands of 16 MCU rows, strips of 16 MCUs), as chroma block rows x
#: cols; on each kernel's first path only
EDGE_420 = [(ch, cw) for ch in (1, 16, 17, 18, 35)
            for cw in (1, 7, 8, 9, 10, 11, 17, 21)]
EDGE_422 = [(ch, cw) for ch in (1, 16, 17, 18, 35)
            for cw in (1, 13, 14, 15, 28, 29)]
EDGE_440 = [(ch, cw) for ch in (1, 16, 17, 18, 35)
            for cw in (1, 10, 15, 16, 17, 33)]
EDGE_444 = [(ch, cw) for ch in (1, 3, 4, 5, 15, 16, 17, 35)
            for cw in (1, 15, 16, 17, 33)]
#: dequant_idct_blocks' step (4 block rows), band (16 block rows) and strip
#: (16 block columns) edges, as block rows x cols
EDGE_IDCT = [(bh, bw) for bh in (1, 3, 4, 5, 15, 16, 17, 33)
             for bw in (1, 15, 16, 17, 33)]
KERNEL_MAX_DIFF, KERNEL_MAX_SHARE = 1, 1e-4
STEP_MAX_DIFF, STEP_MAX_SHARE = 1, 1e-3
DEVICE = "cuda"


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` launches (after one warm-up),
    measured with CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def diff_stats(got, ref):
    """(max |got - ref|, count of differing values, count of values) over
    u8 planes, unpacked BGRA bytes or int16 coefficients."""
    import torch
    if isinstance(got, torch.Tensor) and got.dtype == torch.int32:
        got = [(got >> s) & 255 for s in (0, 8, 16, 24)]
        ref = [(ref >> s) & 255 for s in (0, 8, 16, 24)]
    mx, nd, n = 0, 0, 0
    for g, r in zip(got, ref):
        d = (g.to(torch.int32) - r.to(torch.int32)).abs()
        mx = max(mx, int(d.max()))
        nd += int((d > 0).sum())
        n += d.numel()
    return mx, nd, n


def phase1():
    import torch
    print(f"phase 1: cuda available={torch.cuda.is_available()}", flush=True)
    check(torch.cuda.is_available(), "no CUDA device")
    print(f"phase 1: card {card_line()}; torch {torch.__version__} "
          f"cuda {torch.version.cuda} python {sys.version.split()[0]}",
          flush=True)
    from concurrent.futures import ThreadPoolExecutor
    from lilliput_tpu_torch import binding
    from lilliput_tpu_torch.ops import _build
    from lilliput_tpu_torch.ops import decode_kernels as DK
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:      # g++ beside the nvcc builds
        host = ex.submit(binding.load)
        libs = DK.build()
        host.result()
    t1 = time.perf_counter()
    for name, lib in libs.items():
        ptxas = [ln.strip() for ln in _build.build_log(lib).splitlines()
                 if "registers" in ln or "spill" in ln
                 or "Function properties" in ln]
        print(f"phase 1: {name} ptxas: {ptxas}", flush=True)
    deflate = ("linked" if binding.load().lp_zlib_fast_available()
               else "absent: PNG deflates with Python zlib")
    print(f"phase 1: host library and {len(libs)} kernel libraries built "
          f"in {t1 - t0:.1f}s; libdeflate {deflate}", flush=True)


def random_case(rng, h, w, h2, v2, batch=3):
    import torch
    from lilliput_tpu_torch.codecs.jpeg import scaled_qtables
    from lilliput_tpu_torch.ops import jpeg_kernels as K

    def bl(n, f):
        return (-(-n // f) + 7) // 8
    cshape = (batch, bl(h, 1 + v2), bl(w, 1 + h2), 64)
    yc = rng.integers(-300, 300, (batch, bl(h, 1), bl(w, 1), 64))
    cb = rng.integers(-200, 200, cshape)
    cr = rng.integers(-200, 200, cshape)
    qs = [scaled_qtables(q) for q in (30, 85, 95)][:batch]
    qy = np.stack([q[0] for q in qs]).astype(np.float32)
    qc = np.stack([q[1] for q in qs]).astype(np.float32)
    dev = [torch.from_numpy(a.astype(np.int16)).to(DEVICE)
           for a in (yc, cb, cr)]
    return (*dev, K.fold_qtables(torch.from_numpy(qy).to(DEVICE)),
            K.fold_qtables(torch.from_numpy(qc).to(DEVICE)))


def plain_decode(args, h2, v2, out):
    """The plain version of the decode kernels; one image's is taken from a
    stack of two copies of it, since at batch 1 cuBLAS runs a single GEMM
    whose sum order differs from its batched one."""
    from lilliput_tpu_torch.ops import decode_kernels as DK
    if args[0].shape[0] > 1:
        return DK.decode_ycc_reference(*args, h2, v2, out=out)
    import torch
    ref = DK.decode_ycc_reference(*(torch.cat([a, a]) for a in args), h2, v2,
                                  out=out)
    return ref[:1] if out == "packed" else tuple(p[:1] for p in ref)


def phase2(path, pipe, bufs, first: bool):
    """The path's kernel vs its plain version on the card. Returns (max
    diff, args at the serving shape), (None, None) without a kernel."""
    name = PATHS[path].kernel
    if name is None:
        print(f"phase 2: {path}: no kernel on this path (the IDCTs are "
              "torch matmuls, as the JAX package's XLA dots)", flush=True)
        return None, None
    if name == IDCT:
        return phase2_idct(path, pipe, bufs, first)
    import torch
    from lilliput_tpu_torch.ops import decode_kernels as DK
    from lilliput_tpu_torch.ops import jpeg_kernels as K
    h2, v2 = KERNELS[name][2]
    kernel = getattr(DK, name)
    ys, cbs, crs, qty, qtc = pipe.decode_entropy(bufs)
    serving = tuple(torch.from_numpy(a).to(DEVICE) for a in (ys, cbs, crs))
    serving += tuple(K.fold_qtables(torch.from_numpy(
        q.astype(np.float32)).to(DEVICE)) for q in (qty, qtc))
    rng = np.random.default_rng(1234)
    inputs = [(f"{path} fixture x{BATCH} {tuple(ys.shape[1:3])}", serving)]
    if first:
        inputs += [(f"random {h}x{w}", random_case(rng, h, w, h2, v2))
                   for h, w in CASES]
    edges = {"decode420": EDGE_420, "decode422": EDGE_422,
             "decode440": EDGE_440, "decode444": EDGE_444}.get(name, [])
    if first:
        inputs += [(f"edge chroma {ch}x{cw} x{1 + 2 * (i % 2)}", random_case(
            rng, 8 * (1 + v2) * ch - 1, 8 * (1 + h2) * cw - 3, h2, v2,
            batch=1 + 2 * (i % 2))) for i, (ch, cw) in enumerate(edges)]
    worst = 0
    for what, args in inputs:
        for out in ("planes", "packed"):
            got = kernel(*args, out=out)
            ref = plain_decode(args, h2, v2, out)
            mx, nd, n = diff_stats(got, ref)
            worst = max(worst, mx)
            print(f"phase 2: {name} {what} {out}: max_abs_diff={mx} "
                  f"differing={nd}/{n} ({nd / n:.3g})", flush=True)
            check(mx <= KERNEL_MAX_DIFF and nd <= KERNEL_MAX_SHARE * n,
                  f"{name} disagrees with its plain version on {what}")
    return worst, serving


def _u8(p):
    import torch
    return torch.clamp(torch.round(p), 0, 255).to(torch.uint8)


def plain_idct(coefs, wq):
    """dequant_idct_blocks' plain version (f32); one image's is taken from a
    stack of two copies of it, as in plain_decode."""
    import torch
    from lilliput_tpu_torch.ops import decode_kernels as DK
    if coefs.shape[0] > 1:
        return DK.dequant_idct_blocks_reference(coefs, wq)
    return DK.dequant_idct_blocks_reference(torch.cat([coefs, coefs]),
                                            torch.cat([wq, wq]))[:1]


def idct_inputs(rng):
    """dequant_idct_blocks' phase-2 inputs besides the serving shape: the
    CASES at batch 3 and the EDGE_IDCT grids at batches 1 and 3 in turn,
    coefficients in -400..399 with per-image q30/85/95 tables, as
    [(what, (coefs, wq))]."""
    import torch
    from lilliput_tpu_torch.codecs.jpeg import scaled_qtables
    from lilliput_tpu_torch.ops import jpeg_kernels as K
    qs = np.stack([scaled_qtables(q)[0] for q in (30, 85, 95)])
    wq = K.fold_qtables(torch.from_numpy(qs.astype(np.float32)).to(DEVICE))

    def case(bh, bw, batch=3):
        return torch.from_numpy(rng.integers(
            -400, 400, (batch, bh, bw, 64)).astype(np.int16)).to(DEVICE), \
            wq[:batch]
    return [(f"random {h}x{w}", case(-(-h // 8), -(-w // 8)))
            for h, w in CASES] + [
        (f"edge blocks {bh}x{bw} x{1 + 2 * (i % 2)}",
         case(bh, bw, 1 + 2 * (i % 2)))
        for i, (bh, bw) in enumerate(EDGE_IDCT)]


def phase2_idct(path, pipe, bufs, first: bool):
    """dequant_idct_blocks vs its plain version: the f32 epilogue's u8
    values (decode_gray's round half to even and clip) within KERNEL_MAX_*,
    its f32 difference printed; the u8 epilogue equal to the rounded f32
    output. Returns (max f32 difference, serving args)."""
    import torch
    from lilliput_tpu_torch.ops import decode_kernels as DK
    from lilliput_tpu_torch.ops import jpeg_kernels as K
    ys, qty = pipe.decode_entropy(bufs)
    serving = (torch.from_numpy(ys).to(DEVICE), K.fold_qtables(
        torch.from_numpy(qty.astype(np.float32)).to(DEVICE)))
    inputs = [(f"{path} fixture x{BATCH} {tuple(ys.shape[1:3])}", serving)]
    if first:
        inputs += idct_inputs(np.random.default_rng(4321))
    worst = 0.0
    for what, args in inputs:
        got = DK.dequant_idct_blocks(*args)
        got8 = DK.dequant_idct_blocks(*args, out="u8")
        ref = plain_idct(*args)
        f32 = float((got - ref).abs().max())
        worst = max(worst, f32)
        mx, nd, n = diff_stats([_u8(got)], [_u8(ref)])
        _, nd8, _ = diff_stats([got8], [_u8(got)])
        print(f"phase 2: {IDCT} {what}: f32 max_abs_diff={f32!r}; u8 "
              f"max_abs_diff={mx} differing={nd}/{n} ({nd / n:.3g}); u8 "
              f"epilogue vs rounded f32 differing={nd8}", flush=True)
        check(mx <= KERNEL_MAX_DIFF and nd <= KERNEL_MAX_SHARE * n,
              f"{IDCT} disagrees with its plain version on {what}")
        check(nd8 == 0, f"{IDCT}'s u8 epilogue differs from its rounded f32 "
              f"output on {what}")
        del got, got8, ref
    return worst, serving


def png_pixels(buf: bytes) -> np.ndarray:
    """A PNG's pixels, (H, W, C) u8, decoded by the port on the CPU."""
    from lilliput_tpu_torch import Framebuffer
    from lilliput_tpu_torch.codecs.png import PngDecoder
    fb = Framebuffer()
    PngDecoder(buf, device="cpu").decode_to(fb)
    return fb.to_numpy()


def jpeg_coefs(buf: bytes):
    """A JPEG's quantized coefficients per component (jpeg_huff.cpp)."""
    from lilliput_tpu_torch import binding
    from lilliput_tpu_torch.codecs import jpeg as J
    info = J.read_info(buf)
    comps = [np.zeros((info.comp_blocks_h[c], info.comp_blocks_w[c], 64),
                      np.int16) for c in range(info.num_components)]
    qt = np.zeros((4, 64), np.uint16)
    arr = np.frombuffer(buf, np.uint8)
    i16p = ctypes.POINTER(ctypes.c_int16)
    rc = binding.load().lp_jpeg_decode_coefs_fast(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), arr.size,
        (i16p * len(comps))(*[c.ctypes.data_as(i16p) for c in comps]),
        qt.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), 1)
    check(rc == 0, f"re-decode of a JPEG output failed ({rc})")
    return comps


def is_png_path(path) -> bool:
    return PATHS[path].kw.get("output_format") == ".png"


def check_outputs(path, res, skip=()):
    from lilliput_tpu_torch.codecs import jpeg as J
    ncomp = PATHS[path].ncomp
    for bi, outs in enumerate(res):
        for i, o in enumerate(outs):
            if (bi, i) in skip:
                continue
            check(isinstance(o, bytes), f"{path} batch {bi} item {i} "
                  f"failed: {o!r}")
            if is_png_path(path):
                shape = png_pixels(o).shape
            else:
                info = J.read_info(o)
                shape = (info.height, info.width, info.num_components)
            check(shape == (DST, DST, ncomp),
                  f"{path} output {bi}/{i} is not {DST}x{DST}x{ncomp}")


def run_main_path(path, pipe, batches):
    """transcode_pipelined with every launch count 0 just before and read
    just after; the path's kernel must launch once per device step and no
    other kernel at all. Returns (results, counts)."""
    from lilliput_tpu_torch.ops import decode_kernels as DK
    name = PATHS[path].kernel
    DK.reset_launches()
    res = pipe.transcode_pipelined(batches, return_exceptions=True)
    counts = dict(DK.launches)
    print(f"phase 3: {path} transcode_pipelined {len(batches)}x{BATCH}: "
          f"launches={counts}", flush=True)
    check(counts == {k: len(batches) * (k == name) for k in counts},
          f"{name or 'no kernel'} did not launch once per device step of "
          f"the {path} path (or another kernel launched)")
    return res, counts


def _check_step_diff(path, step, ref, what):
    """A step's coefficients within the step gate, or its packed pixels
    (.png paths) within the kernel gate."""
    import torch
    if is_png_path(path):
        got, exp = torch.from_numpy(step[0]), torch.from_numpy(ref[0])
        gate, unit = (KERNEL_MAX_DIFF, KERNEL_MAX_SHARE), "pixel bytes"
    else:
        got = [torch.from_numpy(a) for a in step]
        exp = [torch.from_numpy(a) for a in ref]
        gate, unit = (STEP_MAX_DIFF, STEP_MAX_SHARE), "coefficients"
    mx, nd, n = diff_stats(got, exp)
    print(f"phase 3: {path} device_step vs {what}: max_abs_diff={mx} "
          f"differing={nd}/{n} ({nd / n:.3g}) {unit}", flush=True)
    check(mx <= gate[0] and nd <= gate[1] * n,
          f"{path} device_step disagrees with the {what}")


def check_plain_step(path, pipe, batch):
    """device_step vs the same step through the plain version; returns the
    step's coefficients as numpy."""
    args = pipe.decode_entropy(batch)
    step = [t.cpu().numpy() for t in pipe.device_step(*args)]
    plain = [t.cpu().numpy() for t in pipe.device_step(*args, plain=True)]
    _check_step_diff(path, step, plain, "plain device_step")
    return step


def check_cpu_step(path, pipe, fixture):
    """device_step on the card vs the CPU pipeline's step, 2 images; the
    CPU pipeline has the path's keywords, and runs inside the path's
    environment."""
    from lilliput_tpu_torch import JpegTranscodePipeline
    cpu = JpegTranscodePipeline(fixture, DST, DST, quality=85, device="cpu",
                                **PATHS[path].kw)
    args = pipe.decode_entropy([fixture] * 2)
    step = [t.cpu().numpy() for t in pipe.device_step(*args)]
    host = [t.numpy() for t in cpu.device_step(*args)]
    _check_step_diff(path, step, host, "CPU device_step")


def phase3_420(pipe, fixture):
    from lilliput_tpu_torch import binding
    from lilliput_tpu_torch.errors import DecodingFailedError
    from lilliput_tpu_torch.utils import metrics

    corrupt = fixture[:len(fixture) // 2]      # scan cut off mid-stream
    batches = [[fixture] * BATCH for _ in range(3)]
    batches[1][5] = corrupt
    pipe.transcode([fixture] * 2)              # warm: pools, tables, cuBLAS
    metrics.reset()
    res, counts = run_main_path("420", pipe, batches)
    check(isinstance(res[1][5], DecodingFailedError),
          f"corrupt buffer gave {type(res[1][5]).__name__}")
    check_outputs("420", res, skip={(1, 5)})
    poisoned = metrics.snapshot()["counters"].get("serving.poison_isolated")
    check(poisoned == 1, f"serving.poison_isolated={poisoned}")
    check(res[1][4] == res[0][4], "a healthy slot next to the corrupt one "
          "changed")
    print(f"phase 3: 420 {sum(len(b) for b in res)} outputs are 256x256 "
          f"3-component JPEGs; corrupt slot isolated "
          f"(serving.poison_isolated={poisoned})", flush=True)

    # entropy round trip and device step vs its plain version
    step = check_plain_step("420", pipe, batches[0])
    enc = pipe.encode_entropy(*step)
    lib = binding.load()
    i16p = ctypes.POINTER(ctypes.c_int16)
    for i in (0, BATCH - 1):
        comps = [np.zeros((32, 32, 64), np.int16)] + [
            np.zeros((16, 16, 64), np.int16) for _ in range(2)]
        qt = np.zeros((4, 64), np.uint16)
        arr = np.frombuffer(enc[i], np.uint8)
        rc = lib.lp_jpeg_decode_coefs_fast(
            arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), arr.size,
            (i16p * 3)(*[c.ctypes.data_as(i16p) for c in comps]),
            qt.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), 1)
        check(rc == 0, f"re-decode of output {i} failed ({rc})")
        for c, s in zip(comps, step):
            check(np.array_equal(c, s[i][:c.shape[0], :c.shape[1]]),
                  f"entropy round trip of output {i} is lossy")
    print(f"phase 3: 420 entropy round trip of outputs 0 and {BATCH - 1}: "
          "coefficients equal", flush=True)
    check_cpu_step("420", pipe, fixture)
    return counts


def phase3(path, pipe, fixture):
    """Returns the launch counts of the main path's run."""
    if path == "420":
        return phase3_420(pipe, fixture)
    batches = [[fixture] * BATCH for _ in range(2)]
    pipe.transcode([fixture] * 2)              # warm: pools, tables, cuBLAS
    res, counts = run_main_path(path, pipe, batches)
    check_outputs(path, res)
    print(f"phase 3: {path} {sum(len(b) for b in res)} outputs are "
          f"{DST}x{DST} {PATHS[path].ncomp}-component "
          f"{'PNG' if is_png_path(path) else 'JPEG'}s", flush=True)
    check_plain_step(path, pipe, batches[0])
    check_cpu_step(path, pipe, fixture)
    return counts


def bound(inputs, outputs, blocks):
    """(ms, 'bytes' or 'operations'): the least time an H100 SXM takes for
    a kernel's work on these tensors at data-sheet peaks: every input read
    once and every output written once, against the IDCT's multiply-adds
    (2 * 64 * 64 FLOP per 8x8 block)."""
    nbytes = sum(t.numel() * t.element_size()
                 for t in tuple(inputs) + tuple(outputs))
    t_bytes, t_ops = nbytes / HBM_BPS, 2 * 64 * 64 * blocks / F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def busy_share(fn) -> float:
    """Device busy share of fn() under torch.profiler: the union of the
    device-side events' intervals over the host clock's window."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    check(bool(spans), "torch.profiler recorded no device events")
    busy, lo, hi = 0.0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo = busy + hi - lo, a
        hi = max(hi, b)
    return (busy + hi - lo) / wall_us


def kernel_times(name, serving):
    """The kernel and its plain version at the serving shape; for
    dequant_idct_blocks the u8 epilogue the path runs, and the f32 epilogue
    beside the PyTorch call computing that function."""
    import torch
    from lilliput_tpu_torch.ops import decode_kernels as DK
    kernel = getattr(DK, name)
    t = {}
    if name == IDCT:
        coefs, wq = serving
        ref = DK.dequant_idct_blocks_reference
        t["kernel_ms"] = cuda_ms(lambda: kernel(coefs, wq, out="u8"), 10)
        t["plain_ms"] = cuda_ms(lambda: ref(coefs, wq, out="u8"), 10)
        t["f32_ms"] = cuda_ms(lambda: kernel(coefs, wq), 10)
        check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
        b = coefs.shape[0]
        flat = coefs.reshape(b, -1, 64).to(torch.float32)
        base = torch.full_like(flat, 128.0)
        t["library_ms"] = cuda_ms(lambda: torch.baddbmm(base, flat, wq), 10)
        del flat, base
        t["bound_ms"], t["bound_by"] = bound(
            serving, [kernel(coefs, wq, out="u8")], coefs.numel() // 64)
        t["f32_bound_ms"], t["f32_bound_by"] = bound(
            serving, [kernel(coefs, wq)], coefs.numel() // 64)
    else:
        h2, v2 = KERNELS[name][2]
        t["kernel_ms"] = cuda_ms(lambda: kernel(*serving), 10)
        t["plain_ms"] = cuda_ms(
            lambda: DK.decode_ycc_reference(*serving, h2, v2), 10)
        t["library_ms"] = t["f32_ms"] = None
        t["bound_ms"], t["bound_by"] = bound(
            serving, kernel(*serving),
            sum(c.numel() // 64 for c in serving[:3]))
    return t


def phase4(path, pipe, bufs, serving, card):
    name = PATHS[path].kernel
    t = kernel_times(name, serving) if name else {}
    args = pipe.decode_entropy(bufs)
    coefs = args[:pipe.ncomp]
    t["h2d_ms"] = cuda_ms(lambda: [pipe._to_device(a) for a in coefs], 5)
    t["device_step_ms"] = cuda_ms(lambda: pipe.device_step(*args), 10)
    if path in ("420", "420_exact"):
        t.update(stage_breakdown_420(pipe, bufs, args, serving))
    if path == "420_direct":
        t["idct_ms"] = direct_idct_ms(pipe, args)
    t0 = time.perf_counter()
    pipe.transcode_pipelined([bufs] * 4)
    t["pipelined_ips"] = 4 * BATCH / (time.perf_counter() - t0)
    t["device_busy_share"] = busy_share(
        lambda: pipe.transcode_pipelined([bufs] * 2))
    for k, v in t.items():
        print(f"phase 4: {path} {k}={v!r} [{card}]", flush=True)
    return t


def direct_idct_ms(pipe, args):
    """The direct mode's three IDCTs with their u8 rounding
    (dequant_idct_u8 of Y, Cb and Cr, torch matmuls) on the step's
    inputs: the part of its device step that takes the decode kernel's
    place."""
    from lilliput_tpu_torch.ops import jpeg_kernels as K
    ys, cbs, crs = (pipe._to_device(a) for a in args[:3])
    qy, qc = (pipe._to_device(q.astype(np.float32)) for q in args[3:])
    return cuda_ms(lambda: [K.dequant_idct_u8(c, q) for c, q in
                            ((ys, qy), (cbs, qc), (crs, qc))], 10)


def stage_breakdown_420(pipe, bufs, args, serving):
    import torch
    from lilliput_tpu_torch.ops import decode_kernels as DK
    from lilliput_tpu_torch.ops import jpeg_kernels as K
    from lilliput_tpu_torch.ops import resize as R
    from lilliput_tpu_torch import pipeline as P
    t = {}
    g = pipe.geom
    left, top, w, h = P.fit_rect(g.width, g.height, DST, DST)
    x0, y0 = pipe.window_static[:2]
    planes = DK.decode420(*serving)

    def resize():
        return [torch.clamp(torch.round(R.resize_area_plane_embedded(
            p, left - x0, w, DST, top - y0, h, DST)), 0, 255)
            for p in planes]
    small = resize()
    t["resize_ms"] = cuda_ms(resize, 10)
    t["encode_ms"] = cuda_ms(lambda: K.encode_from_bgr_planes(
        *small, pipe.enc_qt_y, pipe.enc_qt_c), 10)
    out = pipe.device_step(*args)
    t["d2h_ms"] = cuda_ms(lambda: [o.cpu() for o in out], 5)
    t0 = time.perf_counter()
    for _ in range(3):
        pipe.decode_entropy(bufs, pool=True)
    t["host_decode_ips"] = 3 * BATCH / (time.perf_counter() - t0)
    coefs = [o.cpu().numpy() for o in out]
    t0 = time.perf_counter()
    for _ in range(3):
        pipe.encode_entropy(*coefs)
    t["host_encode_ips"] = 3 * BATCH / (time.perf_counter() - t0)
    return t


def still_kernel(info) -> str:
    """The kernel a JpegDecoder of this header launches: the layout's
    decode kernel, dequant_idct_blocks for grayscale."""
    from lilliput_tpu_torch.ops import decode_kernels as DK
    if info.num_components == 1:
        return IDCT
    return DK.kernel_for(info.comp_h_samp[0] // info.comp_h_samp[1] == 2,
                         info.comp_v_samp[0] // info.comp_v_samp[1] == 2)


def plain_still(dec):
    """The plain version of a JpegDecoder's frame, (H, W, C) u8, taken
    from a stack of two copies of its coefficients (see plain_decode)."""
    import torch
    from lilliput_tpu_torch.ops import jpeg_kernels as K
    info = dec._info
    h, w = info.height, info.width

    def two(c, get):
        t = get(c)
        return torch.stack([t, t])
    if info.num_components == 1:
        return K.decode_gray(two(0, dec._coef), two(0, dec._qtable), h, w,
                             plain=True)[0][..., None]
    planes = K.decode_ycc_420(
        *(two(c, dec._coef) for c in range(3)),
        *(two(c, dec._qtable) for c in range(2)), h, w,
        info.comp_h_samp[0] // info.comp_h_samp[1] == 2,
        info.comp_v_samp[0] // info.comp_v_samp[1] == 2, plain=True)
    return torch.stack([p[0] for p in planes], dim=-1)


def still_args(dec):
    """A JpegDecoder's coefficients and folded tables as its kernel's
    batch-1 arguments."""
    from lilliput_tpu_torch.ops import jpeg_kernels as K
    n = 1 if dec._info.num_components == 1 else 3
    return (tuple(dec._coef(c)[None] for c in range(n))
            + tuple(K.fold_qtables(dec._qtable(c)) for c in range(min(n, 2))))


def _gate(what, got, ref, limits, unit, phase=5):
    mx, nd, n = diff_stats(got, ref)
    print(f"phase {phase}: {what}: max_abs_diff={mx} differing={nd}/{n} "
          f"({nd / n:.3g}) {unit}", flush=True)
    check(mx <= limits[0] and nd <= limits[1] * n, f"{what} disagrees")


def still_times(fixture, reps: int = 5, fmts=(".jpeg", ".png")):
    """Host-clock ms per image of the single-image surface's stages on the
    card, each ended by a sync: decode (header, host Huffman or inflate
    and parse, H2D, the kernel), transform (orientation and Fit), encode
    to each of `fmts` (device stages, D2H, host entropy)."""
    import torch
    from lilliput_tpu_torch import Framebuffer, new_decoder, new_encoder
    t = {}
    t0 = time.perf_counter()
    for _ in range(reps):
        dec = new_decoder(fixture, device=DEVICE)
        fb = Framebuffer()
        dec.decode_to(fb)
        torch.cuda.synchronize()
    t["decode_ms"] = 1e3 * (time.perf_counter() - t0) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        x = Framebuffer(fb.array)
        x.orientation_transform(dec.header().orientation)
        out = x.fit(DST, DST)
        torch.cuda.synchronize()
    t["transform_ms"] = 1e3 * (time.perf_counter() - t0) / reps
    for fmt in fmts:
        enc = new_encoder(fmt, dec)
        t0 = time.perf_counter()
        for _ in range(reps):
            enc.encode(out, {})
        t[f"encode{fmt.replace('.', '_')}_ms"] = (
            1e3 * (time.perf_counter() - t0) / reps)
    return t


def phase5(card, kernels):
    """The single-image surface: new_decoder -> ImageOps.transform to
    .jpeg and .png (Fit 256x256) for each still, with the launch counts 0
    just before and read just after; then the comparisons and times.
    Adds the launches to `kernels` and each kernel's batch-1 whole-frame
    times (still_ms, still_plain_ms, still_bound_ms)."""
    import torch
    from lilliput_tpu_torch import (Framebuffer, ImageOps, ImageOptions,
                                    ResizeMethod, new_decoder)
    from lilliput_tpu_torch.ops import decode_kernels as DK

    def opts(fmt):
        return ImageOptions(file_type=fmt, width=DST, height=DST,
                            resize_method=ResizeMethod.FIT)
    timed = set()
    for still in STILLS:
        with open(os.path.join(ASSETS, still), "rb") as f:
            fixture = f.read()
        dec = new_decoder(fixture, device=DEVICE)
        kernel = still_kernel(dec._info)
        want = {k: int(k == kernel) for k in DK.launches}
        outs = {}
        DK.reset_launches()
        for fmt in (".jpeg", ".png", "decode_to"):
            before = dict(DK.launches)
            if fmt == "decode_to":
                fb = Framebuffer()
                dec.decode_to(fb)
            else:
                outs[fmt] = ImageOps(8192).transform(
                    new_decoder(fixture, device=DEVICE), opts(fmt))
            check({k: DK.launches[k] - before[k] for k in before} == want,
                  f"{still} {fmt}: {kernel} did not launch exactly once "
                  f"(or another kernel launched)")
        counts = dict(DK.launches)
        print(f"phase 5: {still} transform .jpeg, .png and decode_to: "
              f"launches={counts}", flush=True)
        kernels[kernel]["launches"] += counts[kernel]
        kernels[kernel]["still_launches"] = (
            kernels[kernel].get("still_launches", 0) + counts[kernel])

        gate = (KERNEL_MAX_DIFF, KERNEL_MAX_SHARE)
        cpu = Framebuffer()
        new_decoder(fixture, device="cpu").decode_to(cpu)
        _gate(f"{still} decode vs plain decode (2-image stack)", [fb.array],
              [plain_still(dec)], gate, "u8")
        _gate(f"{still} decode vs CPU decode", [fb.array],
              [cpu.array.to(DEVICE)], gate, "u8")
        cpu_outs = {fmt: ImageOps(8192).transform(
            new_decoder(fixture, device="cpu"), opts(fmt))
            for fmt in (".jpeg", ".png")}
        got, ref = png_pixels(outs[".png"]), png_pixels(cpu_outs[".png"])
        check(got.shape == ref.shape == (DST, DST, dec.header().channels),
              f"{still} .png is {got.shape}")
        _gate(f"{still} .png pixels vs CPU", [torch.from_numpy(got)],
              [torch.from_numpy(ref)], gate, "u8")
        _gate(f"{still} .jpeg coefficients vs CPU",
              [torch.from_numpy(c) for c in jpeg_coefs(outs[".jpeg"])],
              [torch.from_numpy(c) for c in jpeg_coefs(cpu_outs[".jpeg"])],
              (STEP_MAX_DIFF, STEP_MAX_SHARE), "coefficients")
        t = still_times(fixture)
        if kernel not in timed:
            timed.add(kernel)
            k = kernel_times(kernel, still_args(dec))
            kernels[kernel].update(still_ms=k["kernel_ms"],
                                   still_plain_ms=k["plain_ms"],
                                   still_bound_ms=k["bound_ms"])
            t.update({f"{kernel}_batch1_{n}": v for n, v in k.items()})
        for n, v in t.items():
            print(f"phase 5: {still} {n}={v!r} [{card}]", flush=True)
        del dec, fb, cpu
        torch.cuda.empty_cache()


def phase6(card):
    """The overlap check: in one transcode_pipelined of 4 batches on 4:2:0,
    every _to_host of batch i-1 must return while step i's event is still
    pending. Prints images/s and the busy share."""
    from lilliput_tpu_torch import JpegTranscodePipeline
    with open(os.path.join(ASSETS, PATHS["420"].fixture), "rb") as f:
        fixture = f.read()
    pipe = JpegTranscodePipeline(fixture, DST, DST, quality=85,
                                 device=DEVICE)
    bufs = [fixture] * BATCH
    pipe.transcode_pipelined([bufs] * 2)      # warm: both slots of each pool
    fetches, pending = [], []
    fetch0, to_host0 = pipe._fetch, pipe._to_host

    def fetch(dev):
        fetches.append(fetch0(dev))
        return fetches[-1]

    def to_host(f):
        arrs = to_host0(f)
        i = next(k for k, g in enumerate(fetches) if g is f)
        if i + 1 < len(fetches):
            pending.append(not fetches[i + 1].event.query())
        return arrs
    pipe._fetch, pipe._to_host = fetch, to_host
    t0 = time.perf_counter()
    res = pipe.transcode_pipelined([bufs] * 4)
    ips = 4 * BATCH / (time.perf_counter() - t0)
    del pipe._fetch, pipe._to_host
    check_outputs("420", res)
    print(f"phase 6: 420 transcode_pipelined 4x{BATCH}: step i still "
          f"pending when _to_host(i-1) returned: {pending}", flush=True)
    check(len(pending) == 3 and all(pending), "transcode_pipelined waited "
          "for step i before returning batch i-1's outputs")
    busy = busy_share(lambda: pipe.transcode_pipelined([bufs] * 4))
    print(f"phase 6: 420 pipelined_ips={ips!r} device_busy_share={busy!r} "
          f"[{card}]", flush=True)


#: the thumbhash grids' bound between the card and the CPU: twice the
#: worst-case error of either side's f32 sums (two products of 100-term
#: sums over a 100x100 plane of values within [-1, 1], scaled by 1/10^4:
#: 2 * 100 * 100 * 100 * 2^-24 / 10^4 each)
THUMB_GRID_ATOL = 2.4e-5
#: phase 7's JPEG inputs: committed fixture, the Adobe transform byte to
#: set (None: as committed), launches of dequant_idct_blocks per decode
STILL_JPEGS = {"jpeg_rgb": ("bench_1080p_rgb.jpg", None, 3),
               "jpeg_cmyk": ("bench_1080p_cmyk.jpg", None, 4),
               "jpeg_ycck": ("bench_1080p_cmyk.jpg", 2, 4)}


def still_inputs():
    """Phase 7's inputs at 1080p, name -> (bytes, launches of
    dequant_idct_blocks per decode): the JCS_RGB and CMYK fixtures, YCCK
    (the CMYK stream with the Adobe transform byte set to 2), PNG (RGB8,
    RGBA8, gray8, palette8 of a fixed 3-3-2 quantization, RGB16, Adam7;
    filter type 0), and BMP, PNM, PAM, Sun Raster, HDR and PFM from the
    port's encoders, with buffers packed by tests/_torch_still_builders.py
    for what they do not write (BMP 565 bitfields and RLE8, 16-bit PPM, a
    Sun Raster colormap). The
    pixels are bench_1080p.jpg's and bench_1080p_gray.jpg's, decoded by
    the port on the CPU."""
    from lilliput_tpu_torch import Framebuffer, new_decoder, new_encoder
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from _torch_still_builders import (bmp_bytes, bmp_rle8, bmp_rows,
                                       png_bytes, pnm16, sunras_bytes)
    out = {}
    for name, (fixture, transform, n) in STILL_JPEGS.items():
        with open(os.path.join(ASSETS, fixture), "rb") as f:
            buf = f.read()
        if transform is not None:
            b = bytearray(buf)
            b[buf.index(b"\xff\xee\x00\x0eAdobe") + 15] = transform
            buf = bytes(b)
        out[name] = (buf, n)

    def pixels(fixture):
        fb = Framebuffer()
        with open(os.path.join(ASSETS, fixture), "rb") as f:
            new_decoder(f.read(), device="cpu").decode_to(fb)
        return fb.to_numpy()
    bgr, gray = pixels("bench_1080p.jpg"), pixels("bench_1080p_gray.jpg")
    h, w = bgr.shape[:2]
    rgb = np.ascontiguousarray(bgr[..., ::-1])
    alpha = np.broadcast_to(
        (np.arange(w) * 255 // (w - 1)).astype(np.uint8)[None, :, None],
        (h, w, 1))
    i = np.arange(256)
    pal = np.stack([(i >> 5) * 255 // 7, ((i >> 2) & 7) * 255 // 7,
                    (i & 3) * 255 // 3], axis=1)          # RGB
    r, g, b = (rgb[..., k].astype(np.int64) for k in range(3))
    idx = ((r >> 5) << 5 | (g >> 5) << 2 | (b >> 6)).astype(np.uint8)
    word = (r >> 3) << 11 | (g >> 2) << 5 | (b >> 3)
    out.update({
        "png_rgb8": png_bytes(rgb, 2),
        "png_rgba8": png_bytes(np.concatenate([rgb, alpha], axis=-1), 6),
        "png_gray8": png_bytes(gray, 0),
        "png_palette8": png_bytes(idx[..., None], 3, palette=pal),
        "png_rgb16": png_bytes(rgb.astype(np.uint16) * 257, 2, 16),
        "png_adam7": png_bytes(rgb, 2, interlace=1),
        "bmp_565": bmp_bytes(w, h, 16, bmp_rows(np.stack(
            [word & 255, word >> 8], axis=-1).reshape(h, -1).astype(
                np.uint8)), compression=3, masks=(0xF800, 0x07E0, 0x001F)),
        "bmp_rle8": bmp_bytes(w, h, 8, bmp_rle8(idx), pal[:, ::-1],
                              compression=1),
        "ppm16": pnm16(rgb.astype(np.uint16) * 257),
        "ras_palette": sunras_bytes(w, h, 8, idx.tobytes(), 1, pal),
    })
    for name, ext, px in (("bmp_24", ".bmp", bgr),
                          ("bmp_32", ".bmp", np.concatenate([bgr, alpha],
                                                            axis=-1)),
                          ("ppm", ".ppm", bgr), ("pgm", ".pgm", gray),
                          ("pam", ".pam", bgr), ("ras_24", ".ras", bgr),
                          ("hdr", ".hdr", bgr), ("pfm", ".pfm", bgr)):
        out[name] = new_encoder(ext).encode(
            Framebuffer.from_array(px, device="cpu"), {})
    return {k: v if isinstance(v, tuple) else (v, 0) for k, v in out.items()}


PHASE7_FMTS = (".jpeg", ".png", ".thumbhash")


def _still_output(buf, device, fmt):
    """ImageOps.transform of `buf` on `device` to `fmt`, Fit 256x256."""
    from lilliput_tpu_torch import (ImageOps, ImageOptions, ResizeMethod,
                                    new_decoder)
    return ImageOps(8192).transform(
        new_decoder(buf, device=device), ImageOptions(
            file_type=fmt, width=DST, height=DST,
            resize_method=ResizeMethod.FIT))


def _plain_frame(dec):
    """A JpegDecoder's frame from the plain versions, taken from a stack
    of two copies of its coefficients and tables (queue 3 entry 7)."""
    import torch

    def two(get):
        return lambda c: torch.stack([get(c), get(c)])
    return dec.frame(two(dec._coef), two(dec._qtable), plain=True)[0]


def phase7(card, kernels):
    """The still formats: for each of still_inputs(), decode on the card
    and on the CPU (0 differing values), ImageOps.transform to .jpeg,
    .png and .thumbhash on both (.png and .thumbhash bytes equal, .jpeg
    coefficients under the step gate), with the launch counts 0 just
    before each decode and read just after: dequant_idct_blocks exactly
    3 (JCS_RGB) or 4 (CMYK, YCCK) times per decode, no kernel for the
    other formats; a JPEG's frame equals its plain version (2-image stack)
    under the kernel gate. Then thumbhash_batch of tiles on the card
    (phase7_thumbhash_batch), one CLI run of the PNG input to .jpeg on
    the card, whose bytes must equal -device cpu's, and the times."""
    import torch
    from lilliput_tpu_torch import Framebuffer, new_decoder
    from lilliput_tpu_torch.ops import decode_kernels as DK
    from lilliput_tpu_torch.ops import jpeg_kernels as K
    t0 = time.perf_counter()
    inputs = still_inputs()
    print(f"phase 7: {len(inputs)} inputs built in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    gate = (KERNEL_MAX_DIFF, KERNEL_MAX_SHARE)
    launched = 0
    for name, (buf, n) in inputs.items():
        want = {k: n if k == IDCT else 0 for k in DK.launches}
        dec = new_decoder(buf, device=DEVICE)
        fb = Framebuffer()
        DK.reset_launches()
        dec.decode_to(fb)
        got = dict(DK.launches)
        check(got == want, f"{name}: launches {got}, want {want}")
        cpu = Framebuffer()
        new_decoder(buf, device="cpu").decode_to(cpu)
        mx, nd, nv = diff_stats([fb.array], [cpu.array.to(DEVICE)])
        print(f"phase 7: {name} {fb.width}x{fb.height}x{fb.channels} "
              f"launches={got} decode vs CPU: max_abs_diff={mx} "
              f"differing={nd}/{nv}", flush=True)
        check(fb.array.shape == cpu.array.shape and nd == 0,
              f"{name}: the card's decode differs from the CPU's")
        if n:
            ref = _plain_frame(dec)
            _gate(f"{name} planes vs plain decode (2-image stack)",
                  [fb.array[..., c] for c in range(3)],
                  [ref[..., c] for c in range(3)], gate, "u8", 7)
        outs = {}
        for fmt in PHASE7_FMTS:
            before = dict(DK.launches)
            outs[fmt] = _still_output(buf, DEVICE, fmt)
            delta = {k: DK.launches[k] - before[k] for k in before}
            check(delta == want, f"{name} {fmt}: launches {delta}")
        launched += DK.launches[IDCT]
        ref = {fmt: _still_output(buf, "cpu", fmt) for fmt in PHASE7_FMTS}
        for fmt in (".png", ".thumbhash"):
            check(outs[fmt] == ref[fmt], f"{name} {fmt} bytes differ from "
                  f"the CPU port's")
        _gate(f"{name} .jpeg coefficients vs CPU",
              [torch.from_numpy(c) for c in jpeg_coefs(outs[".jpeg"])],
              [torch.from_numpy(c) for c in jpeg_coefs(ref[".jpeg"])],
              (STEP_MAX_DIFF, STEP_MAX_SHARE), "coefficients", 7)
        print(f"phase 7: {name} .png and .thumbhash bytes equal the CPU "
              f"port's; .jpeg bytes equal: {outs['.jpeg'] == ref['.jpeg']}",
              flush=True)
        t = still_times(buf, fmts=PHASE7_FMTS)
        if name == "jpeg_cmyk":
            k = kernel_times(IDCT, (dec._coef(0)[None],
                                    K.fold_qtables(dec._qtable(0))))
            kernels[IDCT].update(cmyk_batch1_f32_ms=k["f32_ms"],
                                 cmyk_batch1_library_ms=k["library_ms"],
                                 cmyk_batch1_f32_bound_ms=k["f32_bound_ms"])
            t.update({f"{IDCT}_cmyk_plane_batch1_{m}": v
                      for m, v in k.items()})
        for m, v in t.items():
            print(f"phase 7: {name} {m}={v!r} [{card}]", flush=True)
        del dec, fb, cpu
        torch.cuda.empty_cache()
    kernels[IDCT]["launches"] += launched
    kernels[IDCT]["still_formats_launches"] = launched
    phase7_thumbhash_batch(card, inputs["png_rgba8"][0])
    phase7_cli(inputs["png_rgb8"][0])


def phase7_thumbhash_batch(card, png: bytes, tile: int = 100):
    """thumbhash_batch of the RGBA PNG input cut into 100x100 BGRA tiles
    (its alpha ramp, then the same tiles opaque), as a spritesheet's, on
    the card against the CPU: the coefficient grids within
    THUMB_GRID_ATOL, and equal hashes for every tile whose hash the
    grids' measured difference cannot change (thumbhash.order_dependent:
    an AC zero in exact arithmetic sits on a rounding tie); ms per batch
    (mean of 5)."""
    from lilliput_tpu_torch import Framebuffer, new_decoder
    from lilliput_tpu_torch.codecs import thumbhash as TH
    fb = Framebuffer()
    new_decoder(png, device="cpu").decode_to(fb)
    px = fb.to_numpy()
    ty, tx = px.shape[0] // tile, px.shape[1] // tile
    tiles = px[:ty * tile, :tx * tile].reshape(
        ty, tile, tx, tile, 4).swapaxes(1, 2).reshape(-1, tile, tile, 4)
    opaque = tiles.copy()
    opaque[..., 3] = 255
    tiles = np.concatenate([tiles, opaque])
    grids, _ = TH.batch_grids(tiles, device=DEVICE)
    ref_grids, sums = TH.batch_grids(tiles, device="cpu")
    err = max(float(np.abs(g - r).max()) for g, r in zip(grids, ref_grids))
    got = TH.thumbhash_batch(tiles, device=DEVICE)
    ref = TH.thumbhash_batch(tiles, device="cpu")
    ties = [TH.order_dependent(TH.hash_fields(ref_grids, sums, i, tile,
                                              tile), err)
            for i in range(len(tiles))]
    nd = sum(a != b for a, b in zip(got, ref))
    bad = sum(a != b and not t for a, b, t in zip(got, ref, ties))
    t0 = time.perf_counter()
    for _ in range(5):
        TH.thumbhash_batch(tiles, device=DEVICE)
    ms = (time.perf_counter() - t0) / 5 * 1e3
    print(f"phase 7: thumbhash_batch of {len(tiles)} {tile}x{tile} tiles on "
          f"{DEVICE}: grids max_abs_diff={err!r} vs the CPU's; {nd} of "
          f"{len(got)} hashes differ, {bad} of them on a tile without a "
          f"tie ({sum(ties)} tiles with one); ms per batch={ms!r} [{card}]",
          flush=True)
    check(err <= THUMB_GRID_ATOL, "thumbhash_batch grids on the card are "
          "not within THUMB_GRID_ATOL of the CPU's")
    check(bad == 0, "thumbhash_batch on the card differs from the CPU's on "
          "a tile without a rounding tie")


def phase7_cli(png: bytes):
    """python -m lilliput_tpu_torch of the PNG input to a 256x256 .jpeg,
    in this process, on the card and with -device cpu: equal bytes."""
    import tempfile
    from lilliput_tpu_torch import cli
    outs = {}
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".phase7_") as d:
        src = os.path.join(d, "in.png")
        with open(src, "wb") as f:
            f.write(png)
        for dev in (DEVICE, "cpu"):
            dst = os.path.join(d, f"out_{dev}.jpg")
            rc = cli.main(["-input", src, "-output", dst, "-width",
                           str(DST), "-height", str(DST), "-device", dev])
            check(rc == 0, f"the CLI on {dev} exited {rc}")
            with open(dst, "rb") as f:
                outs[dev] = f.read()
    print(f"phase 7: CLI png -> jpeg on {DEVICE} and cpu: "
          f"{len(outs[DEVICE])} and {len(outs['cpu'])} bytes, equal: "
          f"{outs[DEVICE] == outs['cpu']}", flush=True)
    check(outs[DEVICE] == outs["cpu"], "the CLI's .jpeg on the card differs "
          "from -device cpu's")


@contextlib.contextmanager
def path_env(env):
    """The path's environment variables, restored afterwards."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def main() -> int:
    import torch
    phase1()
    from lilliput_tpu_torch import JpegTranscodePipeline
    card = card_line()
    kernels = {}
    h2d = {}
    for path, spec in PATHS.items():
        name = spec.kernel
        with open(os.path.join(ASSETS, spec.fixture), "rb") as f:
            fixture = f.read()
        with path_env(spec.env):
            if spec.env:
                print(f"phase 2: {path}: environment {spec.env}", flush=True)
            pipe = JpegTranscodePipeline(fixture, DST, DST, quality=85,
                                         device=DEVICE, **spec.kw)
            check(pipe.ncomp == spec.ncomp, f"{spec.fixture} has "
                  f"{pipe.ncomp} components, not {spec.ncomp}")
            if name and name != IDCT:
                check((pipe.geom.h2, pipe.geom.v2) == KERNELS[name][2],
                      f"{spec.fixture} is not the layout of {name}")
            bufs = [fixture] * BATCH
            worst, serving = phase2(path, pipe, bufs, name not in kernels)
            counts = phase3(path, pipe, fixture)
            t = phase4(path, pipe, bufs, serving, card)
        h2d[path] = t["h2d_ms"]
        if name in kernels:      # a later path of the same kernel
            kernels[name]["launches"] += counts[name]
            kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"],
                                               worst)
        elif name:
            source, replaces, _ = KERNELS[name]
            kernels[name] = {
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": counts[name],
                "max_abs_err": worst, "ms": t["kernel_ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "f32_ms": t["f32_ms"]}
        del serving, pipe
        torch.cuda.empty_cache()
    check(set(kernels) == set(KERNELS), f"kernels not driven: "
          f"{set(KERNELS) - set(kernels)}")
    phase5(card, kernels)
    phase6(card)
    phase7(card, kernels)
    print(f"phase 4: H2D 420_direct_s2 {h2d['420_direct_s2']!r} ms (16 of "
          f"64 lanes) vs 420 {h2d['420']!r} ms: ratio "
          f"{h2d['420_direct_s2'] / h2d['420']!r} [{card}]", flush=True)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
