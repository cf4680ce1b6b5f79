"""The benchmark's own CPU tests (``python -m pytest portbench/tests``).

They run the harness at tiny sizes on the CPU, through the program's CPU
path, in a copy of the benchmark's files (``tiny_root``). Tests that need
a CUDA card carry the ``gpu`` marker and decide inside the ``card``
fixture whether one is there.
"""

import json
import os
import shutil
import sys

import pytest

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PKG)
if REPO not in sys.path:
    sys.path.insert(0, REPO)

#: each cell's inputs, traffic and sample at a size a test run holds
TINY = {
    "thumb256_jpeg.photo420": {
        "inputs": {"width": 640, "height": 360, "sources": 6},
        "traffic": {"batch": 6}, "sample": 6},
    "thumb256_jpeg.phone12mp_o6": {
        "inputs": {"width": 640, "height": 480, "sources": 3},
        "traffic": {"batch": 6}, "sample": 3},
}

#: the upright 1080p traffic, out of BENCHMARK.json while its rate
#: spreads too widely on the card's shared host, and run by the tests
PHOTO420 = "thumb256_jpeg.photo420"

#: a GIF cell that only the tests run, so that the GIF entry, maker,
#: reference and readers stay sound until a cell of sourced animated
#: traffic names them in BENCHMARK.json
GIF_CELL = "avatar128_gif.anim_test"
GIF_CONFIG = {
    "name": "avatar128_gif", "entry": "gif_batch", "reference": "gif_fit",
    "dst_w": 128, "dst_h": 128, "fit": "centre crop, INTER_AREA",
    "output": ".gif", "precision": "float32", "reduced": []}
GIF_WORKLOAD = {
    "maker": "gif_pans",
    "inputs": {"canvas": 160, "frame_counts": [5, 6, 9, 11],
               "photo_width": 320, "photo_height": 240, "photos": 4,
               "texture": 1.75, "rects": 6},
    "traffic": {},
    "check": {"sample": 4, "limits": {"index_share": 0.001}}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return "cuda"


def copy_benchmark(dst: str) -> str:
    """BENCHMARK.json and portbench/ (without builds, caches and tests)
    copied into dst, as a checkout holds them."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dst)
    shutil.copytree(PKG, os.path.join(dst, "portbench"),
                    ignore=shutil.ignore_patterns(
                        "_build", "_cache", "tests", "__pycache__"))
    return dst


def shrink(root: str) -> None:
    """Every cell of the copy at root cut to its TINY size."""
    for cell, t in TINY.items():
        path = os.path.join(root, "portbench", "workloads", cell + ".json")
        with open(path) as f:
            w = json.load(f)
        w["inputs"].update(t["inputs"])
        w["traffic"].update(t["traffic"])
        w["check"]["sample"] = t["sample"]
        with open(path, "w") as f:
            json.dump(w, f)


def add_test_cells(root: str) -> None:
    """The cells that BENCHMARK.json leaves out, added to the copy at
    root: photo420 (its workload file is there) and GIF_CELL with its
    configuration, as files and BENCHMARK.json entries."""
    pb = os.path.join(root, "portbench")
    for path, obj in ((os.path.join(pb, "configs", "avatar128_gif.json"),
                       GIF_CONFIG),
                      (os.path.join(pb, "workloads", GIF_CELL + ".json"),
                       GIF_WORKLOAD)):
        with open(path, "w") as f:
            json.dump(obj, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": PHOTO420, "config": "thumb256_jpeg",
                               "traffic": "photo420", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "images_per_s" in (m["name"], m.get("moves")):
            m["workloads"].append(PHOTO420)
    cells = [GIF_CELL]
    bench["configs"].append({"name": "avatar128_gif", "source": "test",
                             "file": "portbench/configs/avatar128_gif.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": GIF_CELL, "config": "avatar128_gif",
                               "traffic": "anim_test", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "frames_per_s", "unit": "frames/s",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock", "workloads": cells})
    for name in ("device_idle_share.gif", "gif_device_ms_per_frame"):
        bench["per_layer"].append({"name": name, "unit": "ms",
                                   "better": "lower",
                                   "source": "device_trace", "layer": "test",
                                   "moves": "frames_per_s",
                                   "workloads": cells})
    with open(path, "w") as f:
        json.dump(bench, f)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    root = copy_benchmark(str(tmp_path_factory.mktemp("checkout")))
    shrink(root)
    add_test_cells(root)
    return root


@pytest.fixture(autouse=True)
def _build_dir(tmp_path_factory, monkeypatch):
    """The frozen encoders build into a temporary directory, not into the
    repository."""
    from portbench import native
    d = str(tmp_path_factory.getbasetemp() / "portbench_build")
    monkeypatch.setattr(native, "BUILD_DIR", d)
