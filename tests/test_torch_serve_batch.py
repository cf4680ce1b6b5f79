"""python -m lilliput_tpu_torch.serve_batch against examples/serve_batch.py
on the CPU: over one mixed set (4:2:0, 4:2:2 and gray JPEG, an RGBA PNG
and a 3-frame GIF, built here from a seed) the port with -device cpu
writes the files the JAX example writes, byte for byte, and prints its
lines (the timings aside), under -format jpeg, png and webp, -mode direct
-dct-scale 2, -sharded (a mesh of 8 CPU entries, as the JAX package's 8
forced host devices) and -warm; the default device raises without a
card."""

import importlib.util
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from lilliput_tpu.utils.metrics import metrics as jax_metrics
from lilliput_tpu_torch import serve_batch as TSB
from lilliput_tpu_torch.utils import metrics

from _torch_gif_builders import pan_gif
from _torch_parity import gray_jpeg, layout_jpeg
from _torch_still_builders import png_bytes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example():
    spec = importlib.util.spec_from_file_location(
        "jax_serve_batch", os.path.join(ROOT, "examples", "serve_batch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _smooth(w, h, c, seed):
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (6, 8, c), np.uint8)
    return np.asarray(Image.fromarray(small).resize(
        (w, h), Image.BICUBIC)).reshape(h, w, c)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_batch_in")
    files = {"a420.jpg": layout_jpeg(160, 120, 85, 1, "420"),
             "b422.jpg": layout_jpeg(160, 120, 85, 2, "422"),
             "c420.jpg": layout_jpeg(160, 120, 90, 3, "420"),
             "gray.jpg": gray_jpeg(160, 120, 85, 4),
             "rgba.png": png_bytes(_smooth(160, 120, 4, 5), 6),
             "pan.gif": pan_gif(_smooth(140, 110, 3, 6), 100, 80, 3,
                                start=6)}
    paths = []
    for name, buf in files.items():
        (d / name).write_bytes(buf)
        paths.append(str(d / name))
    return paths


def _lines(text: str):
    """The printed lines with their timings cut out."""
    return [re.sub(r"in [0-9.]+ (ms|s)", "in T", line)
            for line in text.splitlines()]


def _run(fn, argv, outdir, capsys, registry):
    """fn(argv) with its output directory: the printed lines (timings cut
    out) and the files written. registry: the package's process-wide
    metrics, reset first, since the stats line prints their counters."""
    registry.reset()
    capsys.readouterr()
    assert fn(argv + ["-outdir", str(outdir)]) == 0
    out = capsys.readouterr().out
    files = {name: (outdir / name).read_bytes()
             for name in sorted(os.listdir(outdir))}
    return _lines(out.replace(str(outdir), "OUT")), files


FLAGS = {
    "jpeg": [],
    "png": ["-format", "png"],
    "webp": ["-format", "webp"],
    "direct_s2": ["-mode", "direct", "-dct-scale", "2"],
    "sharded": ["-sharded"],
    "warm": ["-warm"],
}


@pytest.mark.parametrize("flags", list(FLAGS))
def test_files_and_lines_equal_the_jax_example(flags, inputs, tmp_path,
                                               capsys, monkeypatch):
    ex = _example()
    argv = inputs + ["-width", "64", "-height", "64"] + FLAGS[flags]

    def jax_main(a):
        monkeypatch.setattr(sys, "argv", ["serve_batch.py"] + a
                            + ["-device", "cpu"])
        return ex.main()
    want_lines, want = _run(jax_main, argv, tmp_path / "jax", capsys,
                            jax_metrics)
    got_lines, got = _run(TSB.main, argv + ["-device", "cpu"],
                          tmp_path / "port", capsys, metrics)
    assert sorted(got) == sorted(want) and len(got) == len(inputs)
    for name in want:
        assert got[name] == want[name], name
    assert got_lines == want_lines
    ext = FLAGS[flags][1] if flags in ("png", "webp") else "jpeg"
    assert all(name.endswith(".out." + ext) for name in got)
    if flags == "warm":
        assert got_lines[0].startswith("warmed 6 geometries (5 new)")
    if flags == "sharded":
        assert "sharded over 8 device(s)" in got_lines[-1]


def test_default_device_is_the_card(inputs, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSB.main(inputs[:1] + ["-outdir", str(tmp_path)])
    assert not list(tmp_path.iterdir())


def test_python_dash_m(inputs, tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "lilliput_tpu_torch.serve_batch", inputs[0],
         "-width", "32", "-height", "24", "-device", "cpu", "-outdir",
         str(tmp_path)], capture_output=True, text=True, cwd=ROOT,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].endswith("a420.out.jpeg (%d bytes)"
                             % (tmp_path / "a420.out.jpeg").stat().st_size)
    assert lines[1].startswith("1 image(s) in ") and "mode=rgb" in lines[1]
