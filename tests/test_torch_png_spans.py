"""The PNG codec's stage counts on the still serving front, on the CPU.

Two batches of small RGBA PNGs through
StillTranscodePipeline.transcode_pipelined to PNG: each batch's decode
span counts png_inflate_cpu_ns, png_unfilter_cpu_ns and png_pixels_cpu_ns
(each above 0) and png_raw_bytes (each image's filtered stream), its
encode span png_filter_cpu_ns and png_deflate_cpu_ns; the routes count
every image once, by libdeflate where the host library has it and by
Python's zlib with the libdeflate route switched off (png._FAST_ZLIB);
under either route each output is the bytes an untimed encode of its
pixels gives, and the two routes' outputs hold the same pixels. A PNG
decoded and encoded through ImageOps inside an open span, or by a
direct decoder call, records nothing."""

import numpy as np
import pytest

from lilliput_tpu_torch import (ImageOps, ImageOptions, ResizeMethod, binding,
                                new_decoder)
from lilliput_tpu_torch import utils as TU
from lilliput_tpu_torch.codecs import png as TPNG
from lilliput_tpu_torch.framebuffer import PNG_COMPRESSION, Framebuffer
from lilliput_tpu_torch.pipeline import StillTranscodePipeline

H, W, DST = 48, 80, 32
STAGES = {"decode": ("png_inflate_cpu_ns", "png_unfilter_cpu_ns",
                     "png_pixels_cpu_ns"),
          "encode": ("png_filter_cpu_ns", "png_deflate_cpu_ns")}
ROUTES = {"decode": "png_inflate", "encode": "png_deflate"}


def _sources(n: int):
    rng = np.random.default_rng(2626)
    y, x = np.mgrid[:H, :W]
    out = []
    for k in range(n):
        px = ((x * (k + 2) + y * 3)[..., None] + np.arange(4) * 50
              + rng.integers(0, 6, (H, W, 4))) % 256
        out.append(TPNG.encode_png_pixels(px.astype(np.uint8), 6))
    return out


def _decoded(buf: bytes) -> np.ndarray:
    fb = Framebuffer()
    new_decoder(buf, device="cpu").decode_to(fb)
    return fb.to_numpy()


def _serve(fast: bool):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TPNG, "_FAST_ZLIB", fast)
        bufs = _sources(3)
        pipe = StillTranscodePipeline(bufs[0], DST, DST,
                                      output_format=".png",
                                      encode_options={PNG_COMPRESSION: 7},
                                      device="cpu")
        TU.metrics.reset()
        out = pipe.transcode_pipelined([bufs, bufs[:2]])
        # the untimed encode of each output's pixels, on the same route
        again = [TPNG.encode_png_pixels(_decoded(buf), 7)
                 for buf in sum(out, [])]
    spans = [r for r in TU.metrics.spans().records
             if r.name in STAGES and r.batch is not None]
    return out, spans, again


@pytest.fixture(scope="module")
def routes():
    """{route: (outputs, decode and encode spans, untimed re-encodes)}."""
    fast = bool(binding.load().lp_zlib_fast_available())
    return {"libdeflate": _serve(True) if fast else None,
            "zlib": _serve(False)}


@pytest.mark.parametrize("route", ["libdeflate", "zlib"])
def test_front_counts_png_stages_and_routes(routes, route):
    if routes[route] is None:
        pytest.skip("the host library is built without libdeflate")
    out, spans, again = routes[route]
    assert len(spans) == 4
    name, other = ("fast", "zlib") if route == "libdeflate" else \
        ("zlib", "fast")
    for span in spans:
        c = span.counts
        n = c["images"]
        for k in STAGES[span.name]:
            assert c[k] > 0, (span.name, k, c)
        assert c[f"{ROUTES[span.name]}_{name}"] == n
        assert c[f"{ROUTES[span.name]}_{other}"] == 0
        if span.name == "decode":
            assert c["png_raw_bytes"] == n * H * (W * 4 + 1)
    assert again == sum(out, [])
    if routes["libdeflate"] is not None:
        for a, b in zip(sum(routes["libdeflate"][0], []), sum(out, [])):
            np.testing.assert_array_equal(_decoded(a), _decoded(b))


def test_imageops_and_direct_calls_record_nothing():
    buf = _sources(1)[0]
    TU.metrics.reset()
    with TU.StageTimer("decode") as span:
        assert TU.worker_clock() is None
        ImageOps(256).transform(new_decoder(buf, device="cpu"), ImageOptions(
            file_type=".png", width=DST, height=DST,
            resize_method=ResizeMethod.FIT))
        _decoded(buf)
    assert not any(k.startswith("png_") for k in span.counts)
