#!/usr/bin/env python3
"""4:2:0's chip_smoke.py phase-4 numbers from two checkouts of the port,
alternated on one card, to tell a change of the code from the host's
noise.

    python tools/torch_phase4_ab.py --roots PARENT CHANGE [--rounds 2]
                                    [--out FILE]

Runs PARENT, CHANGE, CHANGE, PARENT (`--rounds` times), each in a fresh
process that imports lilliput_tpu_torch from that root (and its built
kernels and host library from that root's _build/) and measures, on 128
copies of tests/assets/bench_1080p.jpg -> 256x256 Fit q85 on the card,
with the same code for both roots:

  h2d_ms           the coefficients' H2D (pipe._to_device of each plane),
                   CUDA events, mean of 5 after a warm call
  device_step_ms   device_step on the decoded batch, mean of 10
  host_decode_ips  decode_entropy(pool=True) of the batch, 3 calls, host
                   clock
  pipelined_ips    transcode_pipelined of 4 batches, host clock, each of
                   3 repeats

Prints one JSON line per run (with the root, the host's core count and
its load average at the start), then one line with each root's median
of every number. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

BATCH, DST = 128, 256


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` calls after one warm call,
    by CUDA events (chip_smoke.cuda_ms)."""
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


def measure(root: str) -> dict:
    """One run's numbers, lilliput_tpu_torch imported from root."""
    load = os.getloadavg()[0]
    sys.path.insert(0, root)
    import torch
    import lilliput_tpu_torch
    from lilliput_tpu_torch import JpegTranscodePipeline
    got = os.path.dirname(os.path.dirname(lilliput_tpu_torch.__file__))
    if os.path.realpath(got) != os.path.realpath(root):
        raise RuntimeError(f"imported the port from {got}, not {root}")
    with open(os.path.join(root, "tests", "assets", "bench_1080p.jpg"),
              "rb") as f:
        fixture = f.read()
    pipe = JpegTranscodePipeline(fixture, DST, DST, quality=85,
                                 device="cuda")
    bufs = [fixture] * BATCH
    args = pipe.decode_entropy(bufs)
    out = {"root": root, "cores": os.cpu_count(), "load_1min": load}
    out["h2d_ms"] = cuda_ms(
        lambda: [pipe._to_device(a) for a in args[:pipe.ncomp]], 5)
    out["device_step_ms"] = cuda_ms(lambda: pipe.device_step(*args), 10)
    t0 = time.perf_counter()
    for _ in range(3):
        pipe.decode_entropy(bufs, pool=True)
    out["host_decode_ips"] = 3 * BATCH / (time.perf_counter() - t0)
    pipe.transcode_pipelined([bufs])      # warm
    ips = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.transcode_pipelined([bufs] * 4)
        ips.append(4 * BATCH / (time.perf_counter() - t0))
    out["pipelined_ips"] = ips
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--roots", nargs=2, metavar=("PARENT", "CHANGE"))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out")
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.measure:
        print(json.dumps(measure(os.path.abspath(args.measure))))
        return 0
    if not args.roots:
        ap.error("--roots PARENT CHANGE is required")
    a, b = (os.path.abspath(r) for r in args.roots)
    rows = []
    for _ in range(args.rounds):
        for root in (a, b, b, a):
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--measure",
                 root], capture_output=True, text=True, cwd=root)
            if res.returncode:
                sys.stderr.write(res.stderr[-4000:])
                return res.returncode
            row = json.loads(res.stdout.strip().splitlines()[-1])
            rows.append(row)
            print(json.dumps(row), flush=True)
    summary = {}
    for root in (a, b):
        mine = [r for r in rows if r["root"] == root]
        summary[root] = {
            k: statistics.median(
                v for r in mine for v in (r[k] if isinstance(r[k], list)
                                          else [r[k]]))
            for k in ("h2d_ms", "device_step_ms", "host_decode_ips",
                      "pipelined_ips")}
    print(json.dumps({"median": summary}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"runs": rows, "median": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
