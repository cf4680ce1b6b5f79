"""Device trace of a run's window: torch.profiler, read as a Chrome trace.

The arithmetic is a copy of the program's utils/profiling.py
(``profile_complete``, ``trace_records``) and of chip_smoke.py's
``busy_share``, kept here so that the yardstick does not move with the
program: a session first runs BURN_IN one-element kernels, synchronized
(a session may drop its first device records), then the work inside the
WINDOW record_function; its records are counted against the kernel
launches and memcpy/memset calls inside the window, matched by
correlation id, and a session that lost any is not read. Busy time is
the union of the kernel, memcpy and memset records' intervals inside the
window.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

WINDOW = "portbench.window"
BURN_IN = 64
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Trace:
    """A window's device records, on the profiler's clock (us)."""
    start: float
    end: float
    kernels: List[Tuple[str, float, float]]   # (name, ts, dur)
    copies: List[Tuple[str, float, float]]
    spans: List[Tuple[str, float, float]]     # harness annotations
    busy: List[Tuple[float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e6

    def device_ops(self, top: int = 10) -> List[List]:
        """[name, seconds] of the device operations that took most time."""
        tot: Dict[str, float] = {}
        for name, _, dur in self.kernels + self.copies:
            tot[name[:160]] = tot.get(name[:160], 0.0) + dur / 1e6
        return [[k, v] for k, v in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """[what the host was doing, seconds]: the window's idle time,
        each gap named by the innermost harness span open at its middle,
        summed by name."""
        gaps, t = [], self.start
        for a, b in self.busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.end > t:
            gaps.append((t, self.end))
        tot: Dict[str, float] = {}
        for a, b in gaps:
            mid = (a + b) / 2
            open_ = [(e - s, n) for n, s, e in self.spans if s <= mid <= e]
            name = "idle in " + (min(open_)[1] if open_ else "no span")
            tot[name] = tot.get(name, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:top]]


def _union(intervals) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def read_events(events) -> Optional[Trace]:
    """The Trace of a session's Chrome-trace events, or None when the
    session kept fewer device records than the window's launches and
    copy calls, or has no window."""
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        return None
    start = min(e["ts"] for e in win)
    end = max(e["ts"] + e.get("dur", 0) for e in win)
    calls = [e for e in events if e.get("cat") == "cuda_runtime"
             and start <= e.get("ts", 0) <= end]
    launches = {e["args"]["correlation"] for e in calls
                if "LaunchKernel" in e.get("name", "")}
    copy_calls = {e["args"]["correlation"] for e in calls
                  if "Memcpy" in e.get("name", "")
                  or "Memset" in e.get("name", "")}
    dev = [e for e in events if e.get("cat") in _DEVICE_CATS]
    kcorr = {e.get("args", {}).get("correlation") for e in dev
             if e["cat"] == "kernel"}
    ccorr = {e.get("args", {}).get("correlation") for e in dev
             if e["cat"] != "kernel"}
    if not (launches <= kcorr and copy_calls <= ccorr):
        return None
    inside = [e for e in dev if e["ts"] >= start and e["ts"] <= end]
    kernels = [(e["name"], e["ts"], e.get("dur", 0)) for e in inside
               if e["cat"] == "kernel"]
    copies = [(e["name"], e["ts"], e.get("dur", 0)) for e in inside
              if e["cat"] != "kernel"]
    spans = [(e["name"], e["ts"], e["ts"] + e.get("dur", 0)) for e in events
             if e.get("cat") == "user_annotation" and e["name"] != WINDOW
             and e["name"].startswith("portbench.")]
    busy = _union((ts, min(ts + d, end)) for _, ts, d in kernels + copies)
    return Trace(start, end, kernels, copies, spans, busy)


def _burn_in() -> None:
    import torch
    x = torch.zeros(1, device="cuda")
    for _ in range(BURN_IN):
        x.add_(1)
    torch.cuda.synchronize()


def traced(fn: Callable[[], object], attempts: int = 2):
    """(fn's result, Trace) of the first of `attempts` profiler sessions
    that kept a device record of every launch and copy of its window;
    RuntimeError when none did."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _burn_in()
            with record_function(WINDOW):
                res = fn()
                torch.cuda.synchronize()
        fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        trace = read_events(events)
        del events, prof
        if trace is not None:
            return res, trace
    raise RuntimeError("every profiler session dropped device records")
