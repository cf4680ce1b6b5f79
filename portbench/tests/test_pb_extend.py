"""A cell, configuration, per-layer metric, input maker and roofline are
added as new files and BENCHMARK.json entries only: in a copy of the
benchmark, a dummy cell of a new configuration, fed by a new maker and
reporting a new per-layer metric that reads a new roofline, runs through
the unchanged harness, and no file that was there changes."""

import hashlib
import json
import os
import subprocess
import sys

from conftest import REPO, copy_benchmark, shrink

MAKER = '''
from portbench.inputs import jpeg_photos


def make(params, seed, device):
    return jpeg_photos.make(dict(params, rects=2), seed, device)
'''

METRIC = '''
import importlib.util
import os


def read(ctx):
    path = os.path.join(ctx.pkg, "roofline", "dummy_kernel.py")
    spec = importlib.util.spec_from_file_location("dummy_kernel", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.work(ctx.window.calls)
'''

ROOF = '''
def work(calls):
    return float(calls)
'''

RUN = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
sys.path.append(sys.argv[2])
from portbench import harness
assert harness.ROOT == sys.argv[1]
for trace in (False, True):
    out = harness.run("thumb96_jpeg.tiny", 2 ** 31 + 17, 0.5, trace,
                      time.perf_counter(), device="cpu")
    print(json.dumps(out))
"""


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if "__pycache__" not in d:
                with open(os.path.join(d, f), "rb") as fh:
                    out[os.path.join(d, f)] = hashlib.sha256(
                        fh.read()).hexdigest()
    return out


def _write(path, text):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)


def test_dummy_cell_from_new_files_only(tmp_path):
    root = copy_benchmark(str(tmp_path))
    shrink(root)
    pb = os.path.join(root, "portbench")
    before = _digests(root)
    with open(os.path.join(pb, "configs", "thumb256_jpeg.json")) as f:
        config = dict(json.load(f), name="thumb96_jpeg", dst_w=96, dst_h=96)
    _write(os.path.join(pb, "configs", "thumb96_jpeg.json"),
           json.dumps(config))
    _write(os.path.join(pb, "workloads", "thumb96_jpeg.tiny.json"),
           json.dumps({"maker": "two_rects",
                       "inputs": {"width": 320, "height": 240, "sources": 2,
                                  "qualities": [85], "orientation": 1,
                                  "texture": 1.0},
                       "traffic": {"batch": 2},
                       "check": {"sample": 2,
                                 "limits": {"coef_share": 0.001}}}))
    _write(os.path.join(pb, "inputs", "two_rects.py"), MAKER)
    _write(os.path.join(pb, "metrics", "dummy_calls.py"), METRIC)
    _write(os.path.join(pb, "roofline", "dummy_kernel.py"), ROOF)
    bench_path = os.path.join(root, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "thumb96_jpeg", "source": "test",
                             "file": "portbench/configs/thumb96_jpeg.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "thumb96_jpeg.tiny",
                               "config": "thumb96_jpeg", "traffic": "tiny",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "images_per_s" == m["name"]:
            m["workloads"].append("thumb96_jpeg.tiny")
    bench["per_layer"].append({"name": "dummy_calls", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "images_per_s",
                               "workloads": ["thumb96_jpeg.tiny"]})
    with open(bench_path, "w") as f:
        json.dump(bench, f)
    out = subprocess.run([sys.executable, "-c", RUN, root, REPO],
                         capture_output=True, text=True, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    e2e, traced = (json.loads(x) for x in out.stdout.splitlines()[-2:])
    assert e2e["correct"] and traced["correct"]
    assert set(e2e["metrics"]) == {"images_per_s", "setup_s"}
    assert traced["metrics"]["dummy_calls"]["value"] >= 1
    after = _digests(root)
    changed = [p for p in before if before[p] != after.get(p)]
    assert changed == [bench_path]
