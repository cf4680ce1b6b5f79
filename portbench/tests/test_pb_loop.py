"""The closed loop's accounting, on fake pipelines: every batch the
generator hands out is completed and counted, the window's seconds cover
the last batch's finish, failures are counted, and the harness's
stability count and sample see every call. A traffic key no entry reads
and a listed metric that reads nothing both stop the run."""

import time
from types import SimpleNamespace

import pytest

from portbench import harness
from portbench.entries import gif_batch, jpeg_pipelined, refuse_unread


class FakePipe:
    """As transcode_pipelined: consumes the batches one at a time,
    the last batch finishes after the generator stops."""

    def __init__(self, step_s: float, fail_at=None):
        self.step_s, self.fail_at, self.seen = step_s, fail_at, 0

    def transcode_pipelined(self, batches, return_exceptions=False):
        out = []
        for b in batches:
            time.sleep(self.step_s)
            self.seen += 1
            res = [bytes([i % 251 + 1]) for i in range(len(b))]
            if self.fail_at == self.seen:
                res[0] = ValueError("bad source")
            out.append(res)
        time.sleep(self.step_s)   # the last batch's encode
        return out


def jpeg_entry(pipe, batch=4, sources=2):
    e = jpeg_pipelined.Entry.__new__(jpeg_pipelined.Entry)
    e.slot_source = [i % sources for i in range(batch)]
    e.batch = [b"x"] * batch
    e.pipe = pipe
    return e


def test_jpeg_window_counts_every_batch_and_its_time():
    pipe = FakePipe(0.05)
    t0 = time.perf_counter()
    win = jpeg_entry(pipe).window(0.5)
    wall = time.perf_counter() - t0
    assert win.calls == pipe.seen == len(win.outputs)
    assert win.attempted == 4 * win.calls and win.units == win.attempted
    assert win.failed == 0
    assert 0.5 <= win.seconds <= wall
    assert win.seconds >= 0.05 * (win.calls + 1)


def test_jpeg_window_counts_failures():
    win = jpeg_entry(FakePipe(0.02, fail_at=2)).window(0.3)
    assert win.failed == 1
    assert win.units == win.attempted - 1


def test_gif_window_counts_frames():
    e = gif_batch.Entry.__new__(gif_batch.Entry)
    e.bufs = [b"a", b"b", b"c"]
    e.frames = [5, 7, 11]
    e.slot_source = [0, 1, 2]
    calls = []

    def once():
        calls.append(1)
        time.sleep(0.05)
        if len(calls) == 2:
            raise ValueError("a call that fails fails all its animations")
        return [b"A", b"B", b"C"]
    e._once = once
    win = e.window(0.4)
    assert win.calls == len(calls)
    assert win.attempted == 3 * len(calls)
    assert win.failed == 3
    assert win.units == 23 * (len(calls) - 1)


def test_stability_and_sample_cover_every_call():
    outs = [[b"a", b"b", b"a", b"b"] for _ in range(5)]
    outs[3][2] = b"z"
    win = SimpleNamespace(outputs=outs, slot_source=[0, 1, 0, 1])
    assert harness.unstable_outputs(win) == 1
    picked = harness.sampled_outputs(win, 2, 2, 2 ** 31 + 5)
    assert sorted(picked) == [0, 1]
    assert picked == harness.sampled_outputs(win, 2, 2, 2 ** 31 + 5)


def test_entries_refuse_traffic_they_do_not_read():
    refuse_unread({"batch": 8}, ("batch",))
    with pytest.raises(ValueError, match="clients"):
        refuse_unread({"batch": 8, "clients": 4}, ("batch",))
    with pytest.raises(ValueError, match="animations"):
        gif_batch.Entry({}, {"animations": 64}, {"bufs": [], "sources": []},
                        "cpu")


def test_a_listed_metric_that_reads_nothing_stops_the_run(tiny_root):
    # on the CPU a traced run has no device trace, so the cell's device
    # metrics find nothing to read
    with pytest.raises(harness.RunError, match="h2d_ms_per_batch"):
        harness.run("thumb256_jpeg.phone12mp_o6", 2 ** 31 + 9, 0.2, True,
                    time.perf_counter(), device="cpu", root=tiny_root)


def test_gif_device_ms_per_frame_reads_the_records():
    trace = SimpleNamespace(kernels=[("quantize", 0.0, 1000.0)],
                            copies=[("Memcpy HtoD", 0.0, 500.0)])
    ctx = SimpleNamespace(trace=trace, window=SimpleNamespace(units=3))
    read = harness.reader(harness.PKG, "gif_device_ms_per_frame").read
    assert read(ctx) == pytest.approx(0.5)
    assert read(SimpleNamespace(trace=None, window=ctx.window)) is None
