"""Lightweight metrics registry: counters, per-stage latency percentiles
and a log of spans.

Fills the observability gap SURVEY.md §5 notes in the reference (no metrics
registry): a serving deployment gets imgs/sec and p50/p99 per pipeline stage
(entropy-decode, H2D, device, D2H, entropy-encode) for free.

A span (StageTimer) is a named interval on the clock of torch.profiler's
Chrome trace, ``time.time_ns()`` (an exported event's ``ts`` is
``(ns - baseTimeNanoseconds) / 1e3``), with the batch it served, its
parent and a few counts. Every span feeds its stage's reservoir and the
registry's bounded span log (``Metrics.spans``), and, while a
torch.profiler session records, is also the profiler range
``lilliput.<name>``, so that it sits in the device trace beside the
kernels and copies it queued.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import itertools
import random
import threading
import time
from typing import Deque, Dict, List, NamedTuple, Optional

import torch

#: records the span log holds: about 12 windows of 51 s of a JPEG front
#: that serves ~550 batches a window, at five spans a batch (~12 MB full)
SPAN_LOG_CAP = 1 << 15


class _Reservoir:
    """Bounded uniform sample (Vitter's Algorithm R) for percentile queries.

    Every observation ever added has probability cap/count of being in the
    sample, so long-running percentiles reflect the whole stream rather than
    skewing toward recent values. The sample list is kept sorted; at capacity
    the incoming item (kept with probability cap/count) evicts a uniformly
    random resident — equivalent to replacing a uniform slot in the classic
    unsorted formulation. A per-reservoir seeded PRNG keeps snapshots
    reproducible in tests without touching global random state.
    """

    def __init__(self, cap: int = 4096, seed: int = 0x5EED):
        self.cap = cap
        self.samples: List[float] = []
        self.count = 0
        self.total = 0.0
        self._rng = random.Random(seed)

    def add(self, v: float) -> None:
        self.count += 1
        self.total += v
        if len(self.samples) < self.cap:
            bisect.insort(self.samples, v)
        elif self._rng.randrange(self.count) < self.cap:
            self.samples.pop(self._rng.randrange(self.cap))
            bisect.insort(self.samples, v)

    def percentile(self, p: float) -> float:
        if not self.samples:
            return 0.0
        k = min(int(len(self.samples) * p / 100.0), len(self.samples) - 1)
        return self.samples[k]


class SpanRecord(NamedTuple):
    """A closed span: its name, the batch it served (one identifier for
    every span of a serving front's batch, None elsewhere), the name of
    its parent span in that batch, its start and end in
    ``time.time_ns()`` (the profiler's Chrome-trace clock), and its
    counts."""
    name: str
    batch: Optional[int]
    parent: Optional[str]
    start_ns: int
    end_ns: int
    counts: Dict[str, float]


class SpanLog(NamedTuple):
    """The span log's records, oldest first, and how many records it
    dropped (the oldest go first once it holds its cap)."""
    records: List[SpanRecord]
    dropped: int


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._stages: Dict[str, _Reservoir] = {}
        self._spans: Deque[SpanRecord] = collections.deque(
            maxlen=SPAN_LOG_CAP)
        self._spans_dropped = 0
        self._batch_ids = itertools.count()
        self._open = threading.local()  # each thread's spans open in `with`

    def incr(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def observe(self, stage: str, seconds: float) -> None:
        with self._lock:
            self._observe(stage, seconds)

    def _observe(self, stage: str, seconds: float) -> None:
        # a reservoir is made once per stage: making one seeds a PRNG
        r = self._stages.get(stage)
        if r is None:
            r = self._stages[stage] = _Reservoir()
        r.add(seconds)

    def new_batch(self) -> int:
        """A fresh batch identifier for the spans of one served batch."""
        return next(self._batch_ids)

    def record(self, span: SpanRecord, stage: Optional[str],
               seconds: float) -> None:
        """Log a closed span; `seconds` feeds the stage's reservoir."""
        with self._lock:
            if stage is not None:
                self._observe(stage, seconds)
            if len(self._spans) == self._spans.maxlen:
                self._spans_dropped += 1
            self._spans.append(span)

    def add_counts(self, **counts: float) -> None:
        """Add counts to the innermost span this thread has open in a
        `with` block (none open: the counts are dropped). Stages called
        inside a caller's span hand it their counts this way."""
        stack = getattr(self._open, "stack", None)
        if stack:
            stack[-1].add(**counts)

    def _push(self, span: "StageTimer") -> None:
        stack = getattr(self._open, "stack", None)
        if stack is None:
            stack = self._open.stack = []
        stack.append(span)

    def _pop(self) -> None:
        self._open.stack.pop()

    def spans(self) -> SpanLog:
        with self._lock:
            return SpanLog(list(self._spans), self._spans_dropped)

    def snapshot(self) -> Dict:
        with self._lock:
            out = {"counters": dict(self._counters), "stages": {}}
            for name, r in self._stages.items():
                out["stages"][name] = {
                    "count": r.count,
                    "mean_ms": (r.total / r.count * 1000) if r.count else 0.0,
                    "p50_ms": r.percentile(50) * 1000,
                    "p99_ms": r.percentile(99) * 1000,
                }
            return out

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._stages.clear()
            self._spans.clear()
            self._spans_dropped = 0


metrics = Metrics()  # process-global default registry


def _open_range(name: str):
    """The profiler range ``lilliput.<name>``, entered, while a
    torch.profiler session records; else None (the check costs a fraction
    of a microsecond, an unguarded range over ten)."""
    if not torch._C._autograd._profiler_enabled():
        return None
    r = torch.autograd.profiler.record_function("lilliput." + name)
    r.__enter__()
    return r


class ProfilerRange:
    """``with ProfilerRange('device.decode'):`` marks the block as the
    profiler range ``lilliput.device.decode`` while a session records,
    and does nothing otherwise (no span, no reservoir)."""
    __slots__ = ("name", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = _open_range(self.name)
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


class StageTimer:
    """A span: ``with StageTimer('decode'): ...``, or start() and stop()
    for a span that outlives a block (a pipelined batch).

    It feeds the reservoir `stage` (its name by default) and the
    registry's span log, is the profiler range ``lilliput.<name>`` while a
    session records, and holds counts (add(), or the registry's
    add_counts() from code called inside its `with` block). batch and
    parent place it in a served batch (Metrics.new_batch)."""

    def __init__(self, name: str, registry: Metrics = metrics,
                 batch: Optional[int] = None, parent: Optional[str] = None,
                 stage: Optional[str] = None):
        self.name = name
        self.registry = registry
        self.batch = batch
        self.parent = parent
        self.stage = name if stage is None else stage
        self.counts: Dict[str, float] = {}

    def start(self) -> "StageTimer":
        # the clock is read before the range opens and after it closes,
        # where the profiler stamps the range's ends
        self.start_ns = time.time_ns()
        self._t0 = time.perf_counter_ns()
        self._range = _open_range(self.name)
        return self

    def stop(self) -> SpanRecord:
        ns = time.perf_counter_ns() - self._t0
        if self._range is not None:
            self._range.__exit__(None, None, None)
        # the duration on the monotonic clock: a step of the wall clock
        # inside the span moves its end with its start
        rec = SpanRecord(self.name, self.batch, self.parent, self.start_ns,
                         self.start_ns + ns, self.counts)
        self.seconds = ns / 1e9
        self.registry.record(rec, self.stage, self.seconds)
        return rec

    def add(self, **counts: float) -> None:
        for k, v in counts.items():
            self.counts[k] = self.counts.get(k, 0) + v

    def __enter__(self):
        self.registry._push(self)
        return self.start()

    def __exit__(self, *exc):
        self.registry._pop()
        self.stop()
        return False


_timed_calls = threading.local()  # .clock, .tail: this thread's timed call


class WorkerClock:
    """The summed wall and thread-CPU time of a stage's per-item calls,
    made on any of its worker threads: timed(fn) wraps the call, and
    counts(workers) gives ``workers``, ``worker_wall_ns`` and
    ``worker_cpu_ns`` for the caller's span. CPU
    time is the worker thread's own (``time.thread_time_ns``): time the
    kernel does not count as the thread's (blocked on a lock or on I/O;
    waiting for a core, where the kernel sees that wait) is not in it.
    Where the kernel counts CPU time in ticks (10 ms under gVisor), a
    call reads a whole number of ticks and only sums over many calls
    mean anything.

    Code running inside a timed call counts its own stages on the clock
    that times it (worker_clock()): add() sums counts, and
    until_return(name) counts the thread-CPU time from then to the end of
    the call under `name`. counts() hands them to the caller's span with
    the worker times."""

    def __init__(self):
        self._lock = threading.Lock()
        self.wall_ns = self.cpu_ns = 0
        self.stages: Dict[str, int] = {}

    def timed(self, fn):
        def call(*args):
            outer = (getattr(_timed_calls, "clock", None),
                     getattr(_timed_calls, "tail", None))
            _timed_calls.clock, _timed_calls.tail = self, None
            w0 = time.perf_counter_ns()
            c0 = time.thread_time_ns()
            try:
                return fn(*args)
            finally:
                c1 = time.thread_time_ns()
                w1 = time.perf_counter_ns()
                tail = _timed_calls.tail
                _timed_calls.clock, _timed_calls.tail = outer
                with self._lock:
                    self.wall_ns += w1 - w0
                    self.cpu_ns += c1 - c0
                    if tail is not None:
                        self._add(tail[0], c1 - tail[1])
        return call

    def _add(self, name: str, value: int) -> None:
        self.stages[name] = self.stages.get(name, 0) + value

    def add(self, **counts: int) -> None:
        """Add counts from inside a timed call, on any worker thread."""
        with self._lock:
            for k, v in counts.items():
                self._add(k, v)

    def until_return(self, name: str) -> None:
        """Count this thread's CPU time from now to the end of its timed
        call under `name` (the last such stage of a call counts)."""
        _timed_calls.tail = (name, time.thread_time_ns())

    def counts(self, workers: int) -> Dict[str, int]:
        return {"workers": workers, "worker_wall_ns": self.wall_ns,
                "worker_cpu_ns": self.cpu_ns, **self.stages}


def worker_clock() -> Optional[WorkerClock]:
    """The WorkerClock timing this thread's current call, else None: a
    stage that counts itself asks first, so that outside a timed call
    (a direct decoder or ImageOps call) it reads no clock and records
    nothing."""
    return getattr(_timed_calls, "clock", None)


class StageClock:
    """Per-call stage times: `with clock(name)` appends the block's ms to
    times[name]. Device stages (device=True) on a CUDA device are timed
    with CUDA events and waited for, host stages with the host clock.
    With times=None nothing is timed and nothing waits."""

    def __init__(self, times: Optional[Dict[str, List[float]]], dev):
        self.times = times
        self.cuda = dev.type == "cuda"

    @contextlib.contextmanager
    def __call__(self, name: str, device: bool = False):
        if self.times is None:
            yield
            return
        if device and self.cuda:
            import torch
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            yield
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            yield
            ms = 1e3 * (time.perf_counter() - t0)
        self.times.setdefault(name, []).append(ms)
