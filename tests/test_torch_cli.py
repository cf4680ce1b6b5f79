"""The port's command line (python -m lilliput_tpu_torch, cli.py) on the
CPU against examples/main.py, the JAX package's: the same flags, the same
output lines (but the timing), and the same output bytes, on a PNG and a
CMYK JPEG synthesized from a seed."""

import io
import os
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from lilliput_tpu_torch import cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _picture(h, w, seed):
    small = np.random.default_rng(seed).integers(0, 256, (6, 6, 3), np.uint8)
    return Image.fromarray(small).resize((w, h), Image.BICUBIC)


def _inputs(tmp_path):
    png, cmyk = tmp_path / "in.png", tmp_path / "in_cmyk.jpg"
    _picture(61, 83, 1).save(png)
    bio = io.BytesIO()
    _picture(57, 71, 2).convert("CMYK").save(bio, "JPEG", quality=85)
    cmyk.write_bytes(bio.getvalue())
    return {"png": png, "cmyk": cmyk}


def _jax_cli(argv, capsys):
    """examples/main.py in this process: (exit code, stdout lines)."""
    old = sys.argv
    sys.argv = [os.path.join(ROOT, "examples", "main.py")] + argv
    code = 0
    try:
        runpy.run_path(sys.argv[0], run_name="__main__")
    except SystemExit as e:
        code = e.code or 0
    finally:
        sys.argv = old
    return code, capsys.readouterr().out.splitlines()


def _port_cli(argv, capsys):
    code = cli.main(argv)
    return code, capsys.readouterr().out.splitlines()


def _untimed(lines):
    """The output lines with the transform's milliseconds cut out."""
    return [ln.split(" in ")[0] + ln[ln.index(" ms ") + 3:]
            if ln.startswith("transformed in") else ln for ln in lines]


@pytest.mark.parametrize("extra", [[], ["-stretch"], ["-quality", "60"]],
                         ids=["fit", "stretch", "q60"])
@pytest.mark.parametrize("ext", [".jpg", ".png", ".thumbhash"])
@pytest.mark.parametrize("src", ["png", "cmyk"])
def test_cli_equal_examples_main(tmp_path, capsys, src, ext, extra):
    """examples/main.py's bytes and lines (but the timing). Its encode map
    sets key 2 (AVIF_SPEED, which is also JPEG_PROGRESSIVE), so .jpg is a
    progressive JPEG, which the port's own encoder writes too."""
    path = _inputs(tmp_path)[src]
    outs = {}
    for who, run in (("jax", _jax_cli), ("port", _port_cli)):
        out = tmp_path / f"out_{who}{ext}"
        argv = ["-input", str(path), "-output", str(out), "-width", "40",
                "-height", "32"] + extra
        if who == "port":
            argv += ["-device", "cpu"]
        code, lines = run(argv, capsys)
        assert code == 0
        outs[who] = (out.read_bytes(), _untimed(
            [ln.replace(str(out), "OUT") for ln in lines]))
    assert outs["port"][1][0] == ("file type: PNG" if src == "png"
                                  else "file type: JPEG")
    assert outs["port"] == outs["jax"]
    if ext == ".jpg":
        assert b"\xff\xc2" in outs["port"][0][:700]    # SOF2: progressive


def test_cli_metadata_only_and_stats(tmp_path, capsys):
    path = _inputs(tmp_path)["png"]
    code, lines = _port_cli(["-input", str(path), "-device", "cpu"], capsys)
    assert code == 0 and lines == ["file type: PNG",
                                   "83x61, 3ch, 1 frame(s), orientation 1"]
    out = tmp_path / "o.png"
    code, lines = _port_cli(["-input", str(path), "-output", str(out),
                             "-device", "cpu", "-stats"], capsys)
    assert code == 0
    assert '"stages"' in "\n".join(lines) and '"decode"' in "\n".join(lines)


def test_cli_errors(tmp_path, capsys):
    code = cli.main(["-input", str(tmp_path / "missing.png")])
    assert code == 1
    assert "failed to read input file" in capsys.readouterr().err
    bad = tmp_path / "bad.bin"
    bad.write_bytes(b"not an image at all")
    assert cli.main(["-input", str(bad), "-device", "cpu"]) == 1
    assert "error decoding image" in capsys.readouterr().err
    if not torch.cuda.is_available():
        # -device defaults to cuda, and a missing card is an error
        assert cli.main(["-input", str(_inputs(tmp_path)["png"])]) == 1
        assert "no CUDA device" in capsys.readouterr().err


def test_python_dash_m(tmp_path):
    path = _inputs(tmp_path)["cmyk"]
    out = subprocess.run(
        [sys.executable, "-m", "lilliput_tpu_torch", "-input", str(path),
         "-device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        timeout=120, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines() == [
        "file type: JPEG", "71x57, 3ch, 1 frame(s), orientation 1"]
