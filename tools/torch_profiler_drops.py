"""How many device records a torch.profiler session keeps, by the way it
is opened, in a process that has been running for minutes.

    python tools/torch_profiler_drops.py [trace_dir]

Needs a CUDA card. The process keeps the card busy with f32 matmuls and
then idle, and at 120, 240 and 330 s of its life opens sessions around 32
small kernels (a fill, 30 adds, a negation) in five ways, twice each:

  bare        torch.profiler.profile around the kernels;
  warm        a synchronized one-element op first inside the window, then
              the kernels (what utils.profiling.device_trace does);
  warm_step   a schedule(warmup=1, active=1) with a step() before them;
  throwaway   an empty session first, then a bare one;
  warm_gap    warm, then 2 ms on the host before the kernels;
  burn_in     64 synchronized one-element kernels first inside the
              window, then the kernels, counted in a record_function
              window of their own (does a session drop only its first
              records, so that a burn-in absorbs the loss?).

Each line prints, per way, the kernel records in the exported Chrome
trace over the kernel launches the trace records on the host, and
whether the first kernel (the fill) is among them. The traces are
written under the directory given (a temporary one by default) and
removed.

    python tools/torch_profiler_drops.py --kept [trace_dir]

runs the other variant: ONE session opened before the first CUDA work of
the process and kept open for its whole life, the kernels at 120, 240
and 330 s each in a record_function window; on exit it prints, per
window, the kernel records over the launches inside it.
"""

import json
import os
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function, schedule

ACTIVITIES = [ProfilerActivity.CPU, ProfilerActivity.CUDA]


def work(x, n=30):
    x.fill_(1.0)
    for _ in range(n):
        x.add_(1.0)
    x.neg_()


def kept(p, path, window=None):
    """'kernels/launches first=...' of profile p, exported to path; of the
    launches inside the record_function `window` where one is named."""
    p.export_chrome_trace(path)
    with open(path) as f:
        ev = json.load(f)["traceEvents"]
    os.remove(path)
    return _count(ev, window)


def _count(ev, window=None):
    lo, hi = -float("inf"), float("inf")
    if window is not None:
        w = [e for e in ev if e.get("name") == window and "dur" in e
             and e.get("cat") == "user_annotation"]
        lo, hi = w[0]["ts"], w[0]["ts"] + w[0]["dur"]
    rt = {e["args"]["correlation"] for e in ev
          if e.get("cat") == "cuda_runtime" and "Launch" in e["name"]
          and lo <= e["ts"] <= hi}
    k = [e for e in ev if e.get("cat") == "kernel"
         and e["args"].get("correlation") in rt]
    names = [e["name"] for e in sorted(k, key=lambda e: e["ts"])]
    return f"{len(k)}/{len(rt)} first={'Fill' in names[0] if names else None}"


def warm_op():
    torch.ones(1, device="cuda").add_(1)
    torch.cuda.synchronize()


def bare(x, path):
    torch.cuda.synchronize()
    with profile(activities=ACTIVITIES) as p:
        work(x)
        torch.cuda.synchronize()
    return kept(p, path)


def warm(x, path, gap=0.0):
    torch.cuda.synchronize()
    with profile(activities=ACTIVITIES) as p:
        warm_op()
        if gap:
            time.sleep(gap)
        work(x)
        torch.cuda.synchronize()
    return kept(p, path)


def warm_step(x, path):
    torch.cuda.synchronize()
    with profile(activities=ACTIVITIES, schedule=schedule(
            wait=0, warmup=1, active=1, repeat=1)) as p:
        torch.cuda.synchronize()
        p.step()
        work(x)
        torch.cuda.synchronize()
        p.step()
    return kept(p, path)


def burn_in(x, path):
    torch.cuda.synchronize()
    with profile(activities=ACTIVITIES) as p:
        y = torch.zeros(1, device="cuda")
        for _ in range(64):
            y.add_(1)
        torch.cuda.synchronize()
        with record_function("work"):
            work(x)
            torch.cuda.synchronize()
    return kept(p, path, "work")


def throwaway(x, path):
    torch.cuda.synchronize()
    with profile(activities=ACTIVITIES):
        warm_op()
    return bare(x, path)


def main() -> int:
    args = sys.argv[1:]
    keep = args[:1] == ["--kept"]
    args = args[1:] if keep else args
    if keep:
        # opened before the process's first CUDA work
        session = profile(activities=ACTIVITIES)
        session.start()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    fn = (lambda out: run_kept(session, out)) if keep else run
    if args:
        os.makedirs(args[0], exist_ok=True)
        return fn(args[0])
    with tempfile.TemporaryDirectory() as out:
        return fn(out)


def _load(t0, at):
    """The card busy with f32 matmuls until 40 s before `at`, then idle
    until `at` (seconds since t0)."""
    a = torch.randn(8192, 8192, device="cuda")
    while time.time() - t0 < at - 40:
        for _ in range(20):
            a = (a @ a).clamp_(-1, 1)
        torch.cuda.synchronize()
    time.sleep(max(0.0, at - (time.time() - t0)))


def run_kept(session, out: str) -> int:
    x = torch.randn(4096, device="cuda")
    t0 = time.time()
    names = []
    for at in (120, 240, 330):
        _load(t0, at)
        for i in range(2):
            names.append(f"kept_{at}_{i}")
            with record_function(names[-1]):
                work(x)
                torch.cuda.synchronize()
    session.stop()
    path = os.path.join(out, "drops_kept.json")
    session.export_chrome_trace(path)
    with open(path) as f:
        ev = json.load(f)["traceEvents"]
    os.remove(path)
    print(" ".join(f"{n}={_count(ev, n)}" for n in names), flush=True)
    print(torch.cuda.get_device_name(0), flush=True)
    return 0


def run(out: str) -> int:
    ways = {"bare": bare, "warm": warm, "warm_step": warm_step,
            "throwaway": throwaway, "burn_in": burn_in,
            "warm_gap": lambda x, path: warm(x, path, gap=0.002)}
    x = torch.randn(4096, device="cuda")
    t0 = time.time()
    for at in (120, 240, 330):
        _load(t0, at)
        for i in range(2):
            row = [f"{name}={fn(x, os.path.join(out, f'drops_{name}.json'))}"
                   for name, fn in ways.items()]
            print(f"t={time.time() - t0:6.1f}s " + " ".join(row), flush=True)
    print(torch.cuda.get_device_name(0), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
