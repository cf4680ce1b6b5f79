"""The program's span log, read for the host metrics of a JPEG serving
front.

The front (``transcode_pipelined``, ``transcode``) records each batch as
a ``batch`` span with the children ``decode`` (the host entropy decode:
counts ``images``, and its workers' ``workers``, ``worker_wall_ns`` and
``worker_cpu_ns``),
``dispatch`` (the device step's enqueue), ``wait_outputs`` (the wait on
the step's output copies) and ``encode`` (the host encode, with the same
worker counts), all under one batch identifier, in
``lilliput_tpu_torch.utils.metrics.spans()``. The window's batches are
the last ``ctx.window.calls`` batch spans: the warm-up runs before the
window, and no program work runs between the window and the readers.
"""

from __future__ import annotations

from typing import Dict, List, Optional

CHILDREN = ("decode", "dispatch", "wait_outputs", "encode")


def window_batches(ctx) -> Optional[List[Dict[str, object]]]:
    """For each of the window's batches, {span name: record} of its
    children; None where the program keeps no span log, or the log does
    not hold each of the window's batches whole (fewer batch spans than
    the window's calls, or one without all four children: records the
    bounded log dropped)."""
    from lilliput_tpu_torch.utils import metrics
    spans = getattr(metrics, "spans", None)
    if spans is None or not ctx.window.calls:
        return None
    records = spans().records
    tops = [r for r in records if r.name == "batch" and r.parent is None]
    if len(tops) < ctx.window.calls:
        return None
    ids = {r.batch for r in tops[-ctx.window.calls:]}
    out: Dict[int, Dict[str, object]] = {i: {} for i in ids}
    for r in records:
        if r.batch in ids and r.parent == "batch":
            out[r.batch][r.name] = r
    if any(set(b) != set(CHILDREN) for b in out.values()):
        return None
    return list(out.values())


def total(batches, span: str, count: str) -> float:
    """The sum of a count over the batches' `span` children."""
    return float(sum(b[span].counts.get(count, 0) for b in batches))


def mean_ms(batches, span: str) -> float:
    """The mean wall time of the batches' `span` children, in ms."""
    ns = [b[span].end_ns - b[span].start_ns for b in batches]
    return sum(ns) / len(ns) / 1e6
