"""decode420's roofline against a hand count."""

import importlib.util
import json
import os

import pytest

from conftest import PKG


def _roof():
    spec = importlib.util.spec_from_file_location(
        "roofline_decode420", os.path.join(PKG, "roofline", "decode420.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: photo420's batch: the decode window of a 1920x1080 source's Fit crop
#: (136 x 140 luma blocks, 68 x 70 chroma), int16, and f32 tables
PHOTO420 = (((128, 136, 140, 64), 2), ((128, 68, 70, 64), 2),
            ((128, 68, 70, 64), 2), ((128, 64), 4), ((128, 64), 4))


def test_decode420_work_by_hand():
    nbytes, flop = _roof().work(PHOTO420)
    coefs = 128 * (136 * 140 + 2 * 68 * 70) * 64 * 2      # 467,927,040
    tables = 2 * 128 * 64 * 4                              # 65,536
    planes = 3 * 128 * (16 * 68) * (16 * 70)               # 467,927,040
    assert nbytes == coefs + tables + planes == 935_919_616
    assert flop == 2048 * 128 * (136 * 140 + 2 * 68 * 70)


def test_decode420_bound_is_bytes_on_h100():
    with open(os.path.join(PKG, "peaks.json")) as f:
        peaks = json.load(f)["NVIDIA H100 80GB HBM3"]
    t, by = _roof().least_seconds(PHOTO420, peaks)
    assert by == "bytes"
    assert t == pytest.approx(935_919_616 / 3.35e12)
    # 2,048 FLOP a block at 67 TFLOP/s stays under the bytes' time
    assert 2048 * 128 * 28560 / 6.7e13 < t
