"""The readers of the program's span log (portbench/spans.py) on the tiny
JPEG cells, on the CPU: each gives a number after a window of the cell's
entry, shares within [0, 100] and times not below 0, read from the
window's batches alone; each gives None on an empty log, and on one
that lacks a window's batch or a batch's child (records dropped)."""

import importlib
from types import SimpleNamespace

import pytest

from conftest import PHOTO420
from portbench import harness, spans

READERS = {"host_decode_cpu_ms_per_image": (0, None),
           "host_decode_oncpu_share": (0, 100),
           "host_decode_pool_fill": (0, 100),
           "host_encode_cpu_ms_per_image": (0, None),
           "host_dispatch_ms_per_batch": (0, None),
           "host_wait_device_ms_per_batch": (0, None)}


@pytest.fixture(scope="module", params=[PHOTO420,
                                        "thumb256_jpeg.phone12mp_o6"])
def window_ctx(request, tiny_root):
    cell = harness.load_cell(request.param, tiny_root)
    maker = importlib.import_module(
        "portbench.inputs." + cell.workload["maker"])
    inputs = maker.make(cell.workload["inputs"], 2 ** 31 + 77, "cpu")
    entry_mod = importlib.import_module(
        "portbench.entries." + cell.config["entry"])
    entry = entry_mod.Entry(cell.config, cell.workload["traffic"], inputs,
                            "cpu")
    entry.warm()
    win = entry.window(0.3)
    return SimpleNamespace(window=win, pkg=tiny_root)


@pytest.mark.parametrize("name", list(READERS))
def test_reader_reads_the_window(window_ctx, name):
    lo, hi = READERS[name]
    value = harness.reader(harness.PKG, name).read(window_ctx)
    assert value is not None and value >= lo
    assert hi is None or value <= hi
    batches = spans.window_batches(window_ctx)
    assert len(batches) == window_ctx.window.calls
    assert all(sorted(b) == ["decode", "dispatch", "encode", "wait_outputs"]
               for b in batches)


def _log_batches(children):
    """Record one batch span a list of child names, as a front does."""
    from lilliput_tpu_torch.utils import StageTimer, metrics
    for names in children:
        b = metrics.new_batch()
        with StageTimer("batch", batch=b):
            for n in names:
                with StageTimer(n, batch=b, parent="batch") as s:
                    s.add(images=1, workers=1, worker_wall_ns=1,
                          worker_cpu_ns=1)


@pytest.mark.parametrize("log", [[], [spans.CHILDREN],
                                 [spans.CHILDREN, spans.CHILDREN[:3]]],
                         ids=["empty", "short", "partial"])
@pytest.mark.parametrize("name", list(READERS))
def test_reader_of_an_incomplete_log_reads_nothing(name, log):
    from lilliput_tpu_torch.utils import metrics
    metrics.reset()
    _log_batches(log)
    ctx = SimpleNamespace(window=SimpleNamespace(calls=2))
    assert harness.reader(harness.PKG, name).read(ctx) is None
    metrics.reset()
