"""A run with the timed path broken underneath comes out not correct.

Each tiny cell runs through the harness on the CPU (the look for a card
skipped by device="cpu") with the program broken where it produces its
answers: every answer altered (each image's output coefficients or each
animation's quantized indices taken from its neighbour in the batch),
and half of the batch left out (those slots' answers never computed,
left zero). A sound run of the same cell is correct."""

import time

import pytest
import torch

from conftest import GIF_CELL, PHOTO420
from portbench import harness

SEED = 2 ** 31 + 4242


def _run(root, cell):
    return harness.run(cell, SEED, 0.5, False, time.perf_counter(),
                       device="cpu", root=root)


def _jpeg_fault(monkeypatch, fault):
    from lilliput_tpu_torch.pipeline import JpegTranscodePipeline
    step = JpegTranscodePipeline.device_step

    def broken(self, *args, **kw):
        outs = step(self, *args, **kw)
        if fault == "altered":
            return tuple(torch.roll(t, 1, 0) for t in outs)
        b = outs[0].shape[0]
        return tuple(torch.cat([t[:b // 2], torch.zeros_like(t[b // 2:])])
                     for t in outs)
    monkeypatch.setattr(JpegTranscodePipeline, "device_step", broken)


def _gif_fault(monkeypatch, fault):
    from lilliput_tpu_torch.ops import palette
    quantize, composite = palette.quantize_animation, \
        palette.composite_animation
    if fault == "altered":
        def broken(frames, *args):
            return torch.roll(quantize(frames, *args), 1, 0)
        monkeypatch.setattr(palette, "quantize_animation", broken)
    else:
        def broken(*args):
            out = composite(*args)
            out[out.shape[0] // 2:] = 0
            return out
        monkeypatch.setattr(palette, "composite_animation", broken)


CELLS = (PHOTO420, "thumb256_jpeg.phone12mp_o6", GIF_CELL)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny_root, cell):
    out = _run(tiny_root, cell)
    assert out["correct"], out["checks"]
    assert list(out["checks"])[-1] in ("coef_share", "index_share")


@pytest.mark.parametrize("fault", ["altered", "half_left_out"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_run_is_not_correct(tiny_root, cell, fault, monkeypatch):
    if cell.startswith("avatar"):
        _gif_fault(monkeypatch, fault)
    else:
        _jpeg_fault(monkeypatch, fault)
    out = _run(tiny_root, cell)
    assert not out["correct"], out["checks"]
