"""tools/torch_asan_smoke.py at its small inputs (--small: the built
streams, no 1080p fixture): the port's host library built with
AddressSanitizer runs every round trip with no report. Skips where g++
has no libasan.so."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import torch_asan_smoke as TAS  # noqa: E402


def test_asan_smoke_small():
    if not TAS.libasan():
        pytest.skip("g++ has no libasan.so here")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "torch_asan_smoke.py"),
         "--small"], capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "AddressSanitizer" not in proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[-1] == "asan smoke OK"
    assert [ln.split(":")[0] for ln in lines[:-1]] == [
        "jpeg", "png", "gif", "jp2_t1", "yuv_bgr"]
    assert "64 decoded back equal" in lines[0]

