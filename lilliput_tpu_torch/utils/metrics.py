"""Lightweight metrics registry: counters + per-stage latency percentiles.

Fills the observability gap SURVEY.md §5 notes in the reference (no metrics
registry): a serving deployment gets imgs/sec and p50/p99 per pipeline stage
(entropy-decode, H2D, device, D2H, entropy-encode) for free.
"""

from __future__ import annotations

import bisect
import random
import threading
import time
from typing import Dict, List


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


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._stages: Dict[str, _Reservoir] = {}

    def incr(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def observe(self, stage: str, seconds: float) -> None:
        with self._lock:
            self._stages.setdefault(stage, _Reservoir()).add(seconds)

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


metrics = Metrics()  # process-global default registry


class StageTimer:
    """Context manager feeding a stage reservoir: with StageTimer('decode'): ..."""

    def __init__(self, stage: str, registry: Metrics = metrics):
        self.stage = stage
        self.registry = registry

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.registry.observe(self.stage, time.perf_counter() - self._t0)
        return False
