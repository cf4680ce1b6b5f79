"""The serving fronts' spans (utils.StageTimer) on the CPU:

* transcode_pipelined over three batches and transcode() of one record,
  for each batch, one "batch" span and its "decode", "dispatch",
  "wait_outputs" and "encode" children under one batch identifier, in
  that order inside the batch span; decode and encode count the images
  and the workers' wall and CPU time (CPU no more than wall, plus one
  tick of the thread clock an image); a corrupt buffer is counted as
  failed (serving.poison_isolated); images_transcoded counts both
  fronts;
* the span log keeps its newest records and counts what it drops, and
  reset() clears it; a WorkerClock shared by more threads than cores
  loses no call's time;
* under a torch.profiler session the Chrome trace holds a lilliput.<name>
  range for each span, at the span's stamps less baseTimeNanoseconds
  (within 1 ms), and the device stages' ranges; with no session no range
  is opened."""

import json
import sys
import threading
import time

import cv2
import numpy as np
import pytest
import torch

from lilliput_tpu_torch import JpegTranscodePipeline
from lilliput_tpu_torch import utils as TU
from lilliput_tpu_torch.utils.metrics import SPAN_LOG_CAP

CHILDREN = ["decode", "dispatch", "wait_outputs", "encode"]


def _jpeg(seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    img = cv2.resize(rng.integers(0, 256, (6, 8, 3), np.uint8), (96, 64),
                     interpolation=cv2.INTER_CUBIC)
    return cv2.imencode(".jpg", img)[1].tobytes()


@pytest.fixture(scope="module")
def pipe():
    return JpegTranscodePipeline(_jpeg(0), 32, 32, device="cpu")


def _thread_tick_ns() -> int:
    """The thread clock's smallest step, as read here."""
    t, step = time.thread_time_ns(), None
    while step is None:
        u = time.thread_time_ns()
        if u != t:
            step = u - t
    return step


def _batches(records):
    """{batch id: [records]} of the fronts' batches, in log order."""
    out = {}
    for r in records:
        if r.batch is not None:
            out.setdefault(r.batch, []).append(r)
    return out


@pytest.mark.parametrize("front", ["pipelined", "transcode"])
def test_fronts_record_each_batch(pipe, front):
    bad = b"\xff\xd8 not a jpeg"
    batches = [[_jpeg(1), _jpeg(2), _jpeg(3)],
               [_jpeg(4), bad, _jpeg(5)],
               [_jpeg(6), _jpeg(7), _jpeg(8)]]
    TU.metrics.reset()
    if front == "pipelined":
        out = pipe.transcode_pipelined(batches, return_exceptions=True)
    else:
        batches = batches[1:2]
        out = [pipe.transcode(batches[0], return_exceptions=True)]
    assert isinstance(out[0][1], Exception) == (front == "transcode")
    log = TU.metrics.spans()
    assert log.dropped == 0
    by_batch = _batches(log.records)
    assert len(by_batch) == len(batches)
    tick = _thread_tick_ns()
    for bufs, recs in zip(batches, by_batch.values()):
        spans = {r.name: r for r in recs}
        assert sorted(r.name for r in recs) == sorted(CHILDREN + ["batch"])
        top = spans.pop("batch")
        assert top.parent is None
        assert [r.parent for r in spans.values()] == ["batch"] * 4
        kids = [spans[n] for n in CHILDREN]
        assert top.start_ns <= kids[0].start_ns
        for a, b in zip(kids, kids[1:]):
            assert a.end_ns <= b.start_ns
        assert kids[-1].end_ns <= top.end_ns
        for c in (spans["decode"].counts, spans["encode"].counts):
            assert c["images"] == 3 and c["workers"] >= 1
            assert 0 <= c["worker_cpu_ns"] <= c["worker_wall_ns"] + tick * 3
    counters = TU.metrics.snapshot()["counters"]
    assert counters["serving.poison_isolated"] == 1
    assert counters["images_transcoded"] == sum(len(b) for b in batches) - 1
    stages = TU.metrics.snapshot()["stages"]
    assert stages["entropy_decode"]["count"] == len(batches)
    assert ("device" in stages) == (front == "transcode")


def test_span_log_is_bounded():
    reg = TU.Metrics()
    cap = SPAN_LOG_CAP
    for i in range(cap + 6):
        with TU.StageTimer("s", registry=reg, batch=i) as s:
            s.add(n=i)
    log = reg.spans()
    assert len(log.records) == cap and log.dropped == 6
    assert [r.batch for r in log.records[:2]] == [6, 7]
    assert [r.counts["n"] for r in log.records[-2:]] == [cap + 4, cap + 5]
    assert reg.snapshot()["stages"]["s"]["count"] == cap + 6
    reg.reset()
    assert reg.spans() == TU.SpanLog([], 0)


def test_worker_clock_loses_no_call():
    clock = TU.WorkerClock()
    work = clock.timed(lambda: time.sleep(1e-4))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [work() for _ in range(
            200)]) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    # each call sleeps at least 0.1 ms: a lost update falls short
    assert clock.counts(16)["worker_wall_ns"] >= 16 * 200 * 100_000
    assert 0 <= clock.cpu_ns


@pytest.mark.parametrize("session", [True, False])
def test_spans_are_profiler_ranges(pipe, session, tmp_path, monkeypatch):
    opened = []
    real = torch.autograd.profiler.record_function

    def counting(name, *a):
        opened.append(name)
        return real(name, *a)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    batches = [[_jpeg(1), _jpeg(2)]] * 2
    TU.metrics.reset()
    if not session:
        pipe.transcode_pipelined(batches)
        assert opened == []
        return
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        pipe.transcode_pipelined(batches)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    base = trace["baseTimeNanoseconds"]
    ranges = {}
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation" and \
                e["name"].startswith("lilliput."):
            ranges.setdefault(e["name"], []).append(e)
    records = TU.metrics.spans().records
    assert {"lilliput." + r.name for r in records} == (
        {"lilliput." + n for n in CHILDREN + ["batch"]})
    for name in ("decode", "resize", "encode"):
        assert len(ranges["lilliput.device." + name]) == 2
    for name in CHILDREN + ["batch"]:
        spans = sorted((r for r in records if r.name == name),
                       key=lambda r: r.start_ns)
        got = sorted(ranges["lilliput." + name], key=lambda e: e["ts"])
        assert len(got) == len(spans) == 2
        for r, e in zip(spans, got):
            assert abs((r.start_ns - base) / 1e3 - e["ts"]) < 1e3
            assert abs((r.end_ns - base) / 1e3 - e["ts"] - e["dur"]) < 1e3
