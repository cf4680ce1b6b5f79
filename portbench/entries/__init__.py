"""Entries: how a cell drives the program in its window.

A configuration names its entry, ``portbench/entries/<entry>.py``, whose
``Entry(config, traffic, inputs, device)`` builds the system under test
(and refuses a traffic key it does not read),
``warm()`` runs the cell's own shapes once, ``window(seconds)`` runs the
closed loop and returns a Window, ``instrument()`` (traced runs only)
wraps public calls in host spans, and ``close()`` frees the program's
state before the reference runs.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List


@dataclass
class Window:
    """What a window did: its host-clock seconds, the units (images or
    frames) completed, the requests attempted and failed, the batches or
    calls issued, every output by call and slot, and each slot's source."""
    seconds: float
    units: int
    attempted: int
    failed: int
    calls: int
    outputs: List[list]
    slot_source: List[int]


def span(name: str, fn: Callable, spans: Dict[str, List[float]]) -> Callable:
    """fn timed on the host clock into spans[name] (ms per call) and
    marked as the profiler range ``portbench.<name>``."""
    from torch.profiler import record_function

    def wrapped(*args, **kw):
        t0 = time.perf_counter()
        with record_function("portbench." + name):
            out = fn(*args, **kw)
        spans.setdefault(name, []).append(1e3 * (time.perf_counter() - t0))
        return out
    return wrapped


def refuse_unread(traffic: Dict, reads: tuple) -> None:
    """ValueError where the workload's traffic sets a key the entry does
    not read: a setting that changes nothing would pass unnoticed."""
    unread = sorted(set(traffic) - set(reads))
    if unread:
        raise ValueError(f"traffic keys this entry does not read: {unread}")
