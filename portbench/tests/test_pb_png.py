"""The screenshot256_png cell at a tiny size on the CPU, in a copy of the
benchmark cut here (160x96 sources, 3 of them, batches of 6, 64x64
thumbnails): the maker gives the same bytes for the same seed, and PNGs
that the reference's own decoder reads back to the kept pixels, with
every filter type in them; the harness runs the cell through the still
serving front with ``correct`` true; the control fails ``px_share`` in
bfloat16 and reads 0 in float64; each PNG reader gives a number after a
window of the cell's entry, and None where the span log lacks its
count."""

import importlib
import json
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from conftest import copy_benchmark
from portbench import control, harness
from portbench.inputs import png_screens
from portbench.reference.png_fit import decode_png

CELL = "screenshot256_png.qhd_rgba"
TINY = {"width": 160, "height": 96, "sources": 3}
SEED = 2 ** 31 + 2626
READERS = {"png_inflate_cpu_ms_per_image": (0, None),
           "png_unfilter_cpu_ms_per_image": (0, None),
           "png_pixels_cpu_ms_per_image": (0, None),
           "png_encode_cpu_ms_per_image": (0, None),
           "png_fast_zlib_share": (0, 100)}


def _edit(path, update):
    with open(path) as f:
        obj = json.load(f)
    update(obj)
    with open(path, "w") as f:
        json.dump(obj, f)


@pytest.fixture(scope="module")
def png_root(tmp_path_factory):
    root = copy_benchmark(str(tmp_path_factory.mktemp("png_checkout")))
    pb = os.path.join(root, "portbench")

    def cut(w):
        w["inputs"].update(TINY)
        w["traffic"]["batch"] = 6
        w["check"]["sample"] = 3
    _edit(os.path.join(pb, "workloads", CELL + ".json"), cut)
    _edit(os.path.join(pb, "configs", "screenshot256_png.json"),
          lambda c: c.update(dst_w=64, dst_h=64))
    return root


@pytest.fixture(scope="module")
def cell(png_root):
    return harness.load_cell(CELL, png_root)


def test_same_seed_same_bytes(cell):
    params = cell.workload["inputs"]
    a = png_screens.make(params, SEED, "cpu")
    b = png_screens.make(params, SEED, "cpu")
    c = png_screens.make(params, SEED + 1, "cpu")
    assert a["bufs"] == b["bufs"] and a["bufs"] != c["bufs"]
    assert len(set(a["bufs"])) == TINY["sources"]


def test_pngs_decode_to_the_kept_pixels_with_every_filter(cell):
    out = png_screens.make(cell.workload["inputs"], SEED, "cpu")
    filters = set()
    for buf, src in zip(out["bufs"], out["sources"]):
        got = decode_png(buf)
        assert (got["width"], got["height"], got["color_type"]) == (
            160, 96, 6)
        np.testing.assert_array_equal(got["pixels"], src["pixels"])
        filters |= set(got["filters"].tolist())
        alpha = src["pixels"][..., 3]
        assert alpha[0, 0] == 0 and alpha[48, 80] == 255
    assert filters == {0, 1, 2, 3, 4}


def test_harness_runs_the_cell_correct(png_root):
    out = harness.run(CELL, SEED, 0.5, False, time.perf_counter(),
                      device="cpu", root=png_root)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 12 and out["failed"] == 0
    assert list(out["checks"]) == ["failed", "unstable_outputs", "px_share"]
    assert set(out["metrics"]) == {"images_per_s", "setup_s"}


def test_control_fails_the_limit(cell):
    inputs = png_screens.make(cell.workload["inputs"], SEED, "cpu")
    limit = cell.workload["check"]["limits"]["px_share"]
    low = control.control_numbers(cell, inputs, SEED, "cpu", torch.bfloat16)
    assert low["px_share"] > limit, low
    exact = control.control_numbers(cell, inputs, SEED, "cpu", torch.float64)
    assert exact["px_share"] == 0, exact


@pytest.fixture(scope="module")
def window_ctx(cell):
    inputs = png_screens.make(cell.workload["inputs"], SEED, "cpu")
    entry_mod = importlib.import_module(
        "portbench.entries." + cell.config["entry"])
    entry = entry_mod.Entry(cell.config, cell.workload["traffic"], inputs,
                            "cpu")
    entry.warm()
    return SimpleNamespace(window=entry.window(0.3))


@pytest.mark.parametrize("name", list(READERS))
def test_reader_reads_the_window(window_ctx, name):
    lo, hi = READERS[name]
    value = harness.reader(harness.PKG, name).read(window_ctx)
    assert value is not None and value >= lo
    assert hi is None or value <= hi


@pytest.mark.parametrize("name", list(READERS))
def test_reader_without_its_count_reads_nothing(window_ctx, name,
                                                monkeypatch):
    from lilliput_tpu_torch.utils import metrics
    log = metrics.spans()
    bare = [r._replace(counts={k: v for k, v in r.counts.items()
                               if not k.startswith("png_")})
            for r in log.records]
    monkeypatch.setattr(metrics, "spans", lambda: log._replace(records=bare))
    assert harness.reader(harness.PKG, name).read(window_ctx) is None
