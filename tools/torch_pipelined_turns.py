"""transcode_pipelined of two checkouts of the port, in turns, on one card.

    python tools/torch_pipelined_turns.py OTHER_ROOT [--order ABBA]
        [--batches 4] [--repeats 3] [--path 420]

Runs each checkout's lilliput_tpu_torch in its own process, in the order
given (A = OTHER_ROOT, e.g. a parent commit unpacked with `git archive`
into the git-ignored tmp_chip/; B = this checkout): ABBA runs parent,
change, change, parent. Each run builds its checkout's libraries, warms a
JpegTranscodePipeline (tests/assets fixture of the path -> 256x256 Fit,
q85, batch 128) with two batches, then measures `--repeats` calls of
transcode_pipelined over `--batches` batches: images/s on the host clock,
the device busy share of one more call under torch.profiler
(chip_smoke.busy_share), and device_step by CUDA events. Prints one JSON
line per run and the card's name and power limit; exits non-zero if a run
fails. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    """This checkout's chip_smoke (busy_share, cuda_ms, PATHS), whichever
    checkout's package is imported."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_turns", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_one(root: str, path: str, batches: int, repeats: int) -> dict:
    """One checkout's measurement (in this process)."""
    sys.path.insert(0, root)
    S = _smoke()
    from lilliput_tpu_torch import JpegTranscodePipeline
    spec = S.PATHS[path]
    with open(os.path.join(root, "tests", "assets", spec.fixture), "rb") as f:
        fixture = f.read()
    pipe = JpegTranscodePipeline(fixture, S.DST, S.DST, quality=85,
                                 device="cuda", **spec.kw)
    bufs = [fixture] * S.BATCH
    pipe.transcode_pipelined([bufs] * 2)
    ips = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        pipe.transcode_pipelined([bufs] * batches)
        ips.append(batches * S.BATCH / (time.perf_counter() - t0))
    busy = S.busy_share(lambda: pipe.transcode_pipelined([bufs] * batches))
    args = pipe.decode_entropy(bufs)
    step = S.cuda_ms(lambda: pipe.device_step(*args), 10)
    import lilliput_tpu_torch
    return {"root": root, "package": lilliput_tpu_torch.__file__,
            "path": path, "pipelined_ips": ips, "device_busy_share": busy,
            "device_step_ms": step}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", nargs="?")
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--path", default="420")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.one:
        print(json.dumps(run_one(a.one, a.path, a.batches, a.repeats)))
        return 0
    roots = {"A": os.path.abspath(a.other), "B": HERE}
    for k, letter in enumerate(a.order):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one",
             roots[letter], "--path", a.path, "--batches", str(a.batches),
             "--repeats", str(a.repeats)], capture_output=True, text=True,
            cwd=roots[letter])
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            return proc.returncode
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res.update(turn=k, checkout=letter)
        print(json.dumps(res), flush=True)
    print(_smoke().card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
