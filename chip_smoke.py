"""GPU smoke run of the port's main path (lilliput_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card; builds the host entropy library (g++) and the 4:2:0
decode kernel (nvcc, sm_90a) from the sources in this checkout, then:

1. device and builds: card name and power limit, versions, build seconds;
2. the decode kernel against its plain PyTorch version on the card, both
   epilogues, at the serving shape (the fixture's window coefficients x128)
   and at odd 4:2:0 geometries with per-image tables (q30/85/95);
3. the main path: JpegTranscodePipeline(bench_1080p.jpg -> 256x256 Fit
   JPEG, q85, batch 128).transcode_pipelined over 3 batches, one holding a
   corrupt buffer: the kernel must launch once per device step, every
   output must be a 256x256 3-component JPEG, the corrupt buffer must fail
   only its own slot, the entropy round trip must be lossless, and the
   device step must agree with the same step through the plain version;
4. times (CUDA events; host clock around work that ends in a sync).

Prints one line per phase, then the kernels JSON line, the card line, and
as its last line {"ok": true, "device": {...}}. Any failure raises, so the
exit code is non-zero and the last line is not printed. Imports no JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "assets", "bench_1080p.jpg")
BATCH = 128
DST = 256
CASES = [(64, 48), (67, 61), (16, 16), (130, 17), (8, 8), (24, 129)]
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
    from lilliput_tpu_torch import binding
    from lilliput_tpu_torch.ops import _build
    from lilliput_tpu_torch.ops import decode_kernels as DK
    t0 = time.perf_counter()
    binding.load()
    t1 = time.perf_counter()
    lib = DK.build()
    t2 = time.perf_counter()
    ptxas = [ln.strip() for ln in _build.build_log(lib).splitlines()
             if "registers" in ln]
    print(f"phase 1: host library {t1 - t0:.1f}s, decode420 kernel "
          f"{t2 - t1:.1f}s; ptxas: {ptxas}", flush=True)


def random_case(rng, h, w, batch=3):
    import torch
    from lilliput_tpu_torch.codecs.jpeg import scaled_qtables
    from lilliput_tpu_torch.ops import jpeg_kernels as K

    def bl(n, f):
        return (-(-n // f) + 7) // 8
    yc = rng.integers(-300, 300, (batch, bl(h, 1), bl(w, 1), 64))
    cb = rng.integers(-200, 200, (batch, bl(h, 2), bl(w, 2), 64))
    cr = rng.integers(-200, 200, (batch, bl(h, 2), bl(w, 2), 64))
    qs = [scaled_qtables(q) for q in (30, 85, 95)][:batch]
    qy = np.stack([q[0] for q in qs]).astype(np.float32)
    qc = np.stack([q[1] for q in qs]).astype(np.float32)
    dev = [torch.from_numpy(a.astype(np.int16)).to(DEVICE)
           for a in (yc, cb, cr)]
    return (*dev, K.fold_qtables(torch.from_numpy(qy).to(DEVICE)),
            K.fold_qtables(torch.from_numpy(qc).to(DEVICE)))


def phase2(pipe, bufs):
    """Kernel vs plain version on the card. Returns (max diff, args at the
    serving shape)."""
    import torch
    from lilliput_tpu_torch.ops import decode_kernels as DK
    from lilliput_tpu_torch.ops import jpeg_kernels as K
    ys, cbs, crs, qty, qtc = pipe.decode_entropy(bufs)
    serving = tuple(torch.from_numpy(a).to(DEVICE) for a in (ys, cbs, crs))
    serving += tuple(K.fold_qtables(torch.from_numpy(
        q.astype(np.float32)).to(DEVICE)) for q in (qty, qtc))
    rng = np.random.default_rng(1234)
    inputs = [("fixture x%d" % BATCH, serving)] + [
        (f"random {h}x{w}", random_case(rng, h, w)) for h, w in CASES]
    worst = 0
    for name, args in inputs:
        for out in ("planes", "packed"):
            got = DK.decode420(*args, out=out)
            ref = DK.decode420_reference(*args, out=out)
            mx, nd, n = diff_stats(got, ref)
            worst = max(worst, mx)
            print(f"phase 2: {name} {out}: max_abs_diff={mx} differing="
                  f"{nd}/{n} ({nd / n:.3g})", flush=True)
            check(mx <= KERNEL_MAX_DIFF and nd <= KERNEL_MAX_SHARE * n,
                  f"decode420 disagrees with its plain version on {name}")
    return worst, serving


def phase3(pipe, fixture):
    import torch
    from lilliput_tpu_torch import binding
    from lilliput_tpu_torch.codecs import jpeg as J
    from lilliput_tpu_torch.errors import DecodingFailedError
    from lilliput_tpu_torch.ops import decode_kernels as DK
    from lilliput_tpu_torch.utils import metrics

    corrupt = fixture[:len(fixture) // 2]      # scan cut off mid-stream
    batches = [[fixture] * BATCH for _ in range(3)]
    batches[1][5] = corrupt
    pipe.transcode([fixture] * 2)              # warm: pools, tables, cuBLAS
    metrics.reset()
    DK.launches = 0
    res = pipe.transcode_pipelined(batches, return_exceptions=True)
    launches = DK.launches
    print(f"phase 3: transcode_pipelined {len(batches)}x{BATCH}: decode420 "
          f"launches={launches}", flush=True)
    check(launches == len(batches), "decode420 did not launch once per "
          "device step of the main path")
    for bi, outs in enumerate(res):
        for i, o in enumerate(outs):
            if bi == 1 and i == 5:
                check(isinstance(o, DecodingFailedError),
                      f"corrupt buffer gave {type(o).__name__}")
                continue
            check(isinstance(o, bytes), f"batch {bi} item {i} failed: {o!r}")
            info = J.read_info(o)
            check((info.width, info.height, info.num_components)
                  == (DST, DST, 3), f"output {bi}/{i} is not 256x256x3")
    poisoned = metrics.snapshot()["counters"].get("serving.poison_isolated")
    check(poisoned == 1, f"serving.poison_isolated={poisoned}")
    check(res[1][4] == res[0][4], "a healthy slot next to the corrupt one "
          "changed")
    print(f"phase 3: {sum(len(b) for b in res)} outputs are 256x256 "
          f"3-component JPEGs; corrupt slot isolated "
          f"(serving.poison_isolated={poisoned})", flush=True)

    # entropy round trip and device step vs its plain version
    args = pipe.decode_entropy(batches[0])
    step = [t.cpu().numpy() for t in pipe.device_step(*args)]
    plain = [t.cpu().numpy() for t in pipe.device_step(*args, plain=True)]
    mx, nd, n = diff_stats([torch.from_numpy(a) for a in step],
                           [torch.from_numpy(a) for a in plain])
    print(f"phase 3: device_step vs plain device_step: max_abs_diff={mx} "
          f"differing={nd}/{n} ({nd / n:.3g}) coefficients", flush=True)
    check(mx <= STEP_MAX_DIFF and nd <= STEP_MAX_SHARE * n,
          "device_step disagrees with its plain version")
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
    print(f"phase 3: entropy round trip of outputs 0 and {BATCH - 1}: "
          "coefficients equal", flush=True)
    return launches


def phase4(pipe, bufs, serving, card):
    import torch
    from lilliput_tpu_torch.ops import decode_kernels as DK
    from lilliput_tpu_torch.ops import jpeg_kernels as K
    from lilliput_tpu_torch.ops import resize as R
    from lilliput_tpu_torch import pipeline as P
    t = {}
    t["kernel_ms"] = cuda_ms(lambda: DK.decode420(*serving), 10)
    t["plain_ms"] = cuda_ms(lambda: DK.decode420_reference(*serving), 10)
    args = pipe.decode_entropy(bufs)
    t["device_step_ms"] = cuda_ms(lambda: pipe.device_step(*args), 10)

    # stage breakdown of one device step
    g = pipe.geom
    left, top, w, h = P.fit_rect(g.width, g.height, DST, DST)
    x0, y0 = pipe.window_static[:2]
    planes = DK.decode420(*serving)

    def resize():
        return [torch.clamp(torch.round(R.resize_area_plane_embedded(
            p, left - x0, w, DST, top - y0, h, DST)), 0, 255)
            for p in planes]
    small = resize()
    t["h2d_ms"] = cuda_ms(lambda: [pipe._to_device(a) for a in args[:3]], 5)
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
    t0 = time.perf_counter()
    pipe.transcode_pipelined([bufs] * 4)
    t["pipelined_ips"] = 4 * BATCH / (time.perf_counter() - t0)
    for k, v in t.items():
        print(f"phase 4: {k}={v!r} [{card}]", flush=True)
    return t


def main() -> int:
    import torch
    phase1()
    from lilliput_tpu_torch import JpegTranscodePipeline
    with open(FIXTURE, "rb") as f:
        fixture = f.read()
    pipe = JpegTranscodePipeline(fixture, DST, DST, quality=85,
                                 device=DEVICE)
    bufs = [fixture] * BATCH
    worst, serving = phase2(pipe, bufs)
    launches = phase3(pipe, fixture)
    card = card_line()
    t = phase4(pipe, bufs, serving, card)
    print(json.dumps({"kernels": [{
        "name": "decode420", "route": "cuda",
        "source": "lilliput_tpu_torch/csrc/decode420.cu",
        "replaces": "lilliput_tpu/ops/pallas_kernels.py:390",
        "launches": launches, "max_abs_err": worst,
        "ms": t["kernel_ms"], "plain_ms": t["plain_ms"]}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
