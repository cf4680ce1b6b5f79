"""The still serving front's PNG Fit against the benchmark's plain
reference, on the CPU.

Seeded small screenshots from portbench's maker (200x120 RGBA, and RGB)
go through StillTranscodePipeline(device="cpu").transcode_pipelined to
64x64 PNG at compression 7; portbench/reference/png_fit.check reads
each output with its own decoder and compares its channel values with
the float64 Fit of the kept source pixels: px_share within the
screenshot256_png cell's limit. An output with one channel value
changed counts exactly that value; one with a byte of its stream
changed fails the limit."""

import json
import os

import numpy as np
import pytest

from lilliput_tpu_torch.framebuffer import PNG_COMPRESSION
from lilliput_tpu_torch.pipeline import StillTranscodePipeline
from portbench.inputs import png_screens
from portbench.reference import png_fit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DST = 64
PARAMS = {"width": 200, "height": 120, "sources": 3, "photo_share": 0.25,
          "zlib_level": 6}


def _limit() -> float:
    path = os.path.join(REPO, "portbench", "workloads",
                        "screenshot256_png.qhd_rgba.json")
    with open(path) as f:
        return json.load(f)["check"]["limits"]["px_share"]


@pytest.fixture(scope="module", params=[4, 3], ids=["rgba", "rgb"])
def served(request):
    inputs = png_screens.make(dict(PARAMS, channels=request.param),
                              2 ** 31 + 26 + request.param, "cpu")
    bufs = inputs["bufs"]
    pipe = StillTranscodePipeline(bufs[0], DST, DST, output_format=".png",
                                  encode_options={PNG_COMPRESSION: 7},
                                  device="cpu")
    out = pipe.transcode_pipelined([bufs, bufs[::-1]])
    assert out[0] == out[1][::-1]
    return inputs["sources"], dict(enumerate(out[0]))


def _check(sources, outputs):
    return png_fit.check(sources, outputs, {"dst_w": DST, "dst_h": DST},
                         "cpu")["px_share"]


def test_front_matches_the_reference(served):
    sources, outputs = served
    assert _check(sources, outputs) <= _limit()


@pytest.mark.parametrize("fault", ["value", "stream_byte"])
def test_a_changed_output_is_seen(served, fault):
    sources, outputs = served
    buf = outputs[0]
    got = png_fit.decode_png(buf)
    if fault == "value":
        px = got["pixels"].copy()
        px[DST // 2, DST // 3, 1] ^= 0x10
        h, w, c = px.shape
        rows = np.concatenate([np.zeros((h, 1), np.uint8),
                               px.reshape(h, w * c)], 1)
        bad = png_screens.png_bytes(rows, w, h, c, 6)
    else:
        bad = bytearray(buf)
        bad[len(bad) // 2] ^= 0x01
        bad = bytes(bad)
    share = _check(sources, {0: bad})
    base = _check(sources, {0: buf})
    if fault == "value":
        assert share - base == pytest.approx(1 / got["pixels"].size)
    else:
        assert share == 1.0 > _limit()
