""".webp through the port's serving fronts and surfaces on the CPU, against
the JAX package's bytes:

* JpegTranscodePipeline (4:2:0, 4:4:4, grayscale, orientation 6,
  chroma_mode="direct"), StillTranscodePipeline (RGB, RGBA, gray PNG and
  WebP sources), MultiGeometryPipeline (a shuffled mix with still and
  animated WebP and GIF sources), AnimatedTranscodePipeline and
  transcode_pipelined: equal bytes and the same emit (yuv420 for opaque
  lossy output, pixels for alpha sources and WEBP_QUALITY 101), the
  gates of tests/test_pipeline.py:573, :614-634 and :754; the yuv420 and
  pixel routes give the same bytes (the JAX package's LILLIPUT_WEBP_YUV
  escape hatch, which the port does not carry);
* transcode_webp and transcode_webp_batch (mixed canvases and frame
  counts, Fit and stretch, a broken buffer failing only its slot), GIF ->
  .webp, ImageOps of still and animated WebP to .webp, .png and .jpeg, and
  the CLI's .webp;
* where libwebp is missing (its header path pointed at a missing file):
  the pipelines build and run their device step, and the host encode,
  GIF -> .webp, transcode_webp, new_decoder and new_encoder raise
  HostLibraryMissingError; nothing falls back.

Destination sizes are ones where the JAX package's two CPU routes for
upright colour JPEG agree (ROADMAP queue 3 entry 3), as in
tests/test_torch_multigeometry.py."""

import os

import numpy as np
import pytest
import torch

import lilliput_tpu as L
from lilliput_tpu import pipeline as JP
from lilliput_tpu.framebuffer import WEBP_QUALITY
import lilliput_tpu_torch as T
from lilliput_tpu_torch import binding
from lilliput_tpu_torch import pipeline as TP
from lilliput_tpu_torch.errors import HostLibraryMissingError

from _torch_gif_builders import pan_gif
from _torch_parity import gray_jpeg, layout_jpeg, with_orientation
from _torch_still_builders import png_bytes
from _torch_webp_builders import mixed_anim, smooth, still_webp
from test_torch_cli import _jax_cli, _port_cli, _untimed

if not os.path.exists(binding.WEBP_HEADER):
    pytest.skip("libwebp's headers are absent", allow_module_level=True)

DST = (64, 48)

JPEG_SOURCES = {
    "420": lambda: layout_jpeg(160, 120, 85, 1, "420"),
    "444": lambda: layout_jpeg(160, 120, 85, 2, "444"),
    "gray": lambda: gray_jpeg(160, 120, 85, 3),
    "420_o6": lambda: with_orientation(layout_jpeg(160, 120, 85, 4), 6),
}


@pytest.mark.parametrize("opts,emit", [({}, "yuv420"),
                                       ({WEBP_QUALITY: 60}, "yuv420"),
                                       ({WEBP_QUALITY: 101}, "pixels")])
@pytest.mark.parametrize("src", list(JPEG_SOURCES) + ["420_direct"])
def test_jpeg_pipeline_webp_equals_jax(src, opts, emit):
    buf = JPEG_SOURCES[src.replace("_direct", "")]()
    kw = dict(quality=85, output_format=".webp", encode_options=opts)
    if src.endswith("_direct"):
        kw["chroma_mode"] = "direct"
    j = JP.JpegTranscodePipeline(buf, *DST, **kw)
    t = TP.JpegTranscodePipeline(buf, *DST, device="cpu", **kw)
    assert t._emit == j._emit == emit
    got = t.transcode([buf] * 2)
    assert got == j.transcode([buf] * 2)
    assert got[0][:4] == b"RIFF" and got[0][8:12] == b"WEBP"


def _png(c, seed=2, w=80, h=60):
    px = np.random.default_rng(seed).integers(0, 256, (h, w, c), np.uint8)
    return png_bytes(px, {1: 0, 3: 2, 4: 6}[c])


STILL_SOURCES = {
    "png_rgb": (lambda: _png(3), "yuv420"),
    "png_rgba": (lambda: _png(4), "pixels"),
    "png_gray": (lambda: _png(1), "yuv420"),
    "webp_rgb": (lambda: still_webp(smooth(80, 60, 3, 4)), "yuv420"),
    "webp_rgba": (lambda: still_webp(smooth(80, 60, 4, 5)), "pixels"),
}


@pytest.mark.parametrize("src", list(STILL_SOURCES))
def test_still_pipeline_webp_equals_jax(src):
    make, emit = STILL_SOURCES[src]
    buf = make()
    j = JP.StillTranscodePipeline(buf, 40, 30, quality=85,
                                  output_format=".webp")
    t = TP.StillTranscodePipeline(buf, 40, 30, quality=85,
                                  output_format=".webp", device="cpu")
    assert t._emit == j._emit == emit
    assert t.transcode([buf] * 2) == j.transcode([buf] * 2)


@pytest.mark.parametrize("src", ["jpeg", "png_rgb"])
def test_yuv420_and_pixel_routes_give_the_same_bytes(src, monkeypatch):
    """The yuv420 emit's bytes equal those of the BGRA pixel route on the
    same step (what the JAX package's LILLIPUT_WEBP_YUV=0 switched to)."""
    if src == "jpeg":
        buf = JPEG_SOURCES["420"]()
        pipe = TP.JpegTranscodePipeline(buf, *DST, quality=85,
                                        output_format=".webp", device="cpu")
    else:
        buf = STILL_SOURCES[src][0]()
        pipe = TP.StillTranscodePipeline(buf, 40, 30, quality=85,
                                         output_format=".webp", device="cpu")
    fast = pipe.transcode([buf] * 2)
    monkeypatch.setattr(type(pipe), "_emit", property(lambda s: "pixels"))
    assert pipe.transcode([buf] * 2) == fast


def test_transcode_pipelined_webp_equals_jax():
    bufs = [JPEG_SOURCES["420"](), layout_jpeg(160, 120, 70, 9, "420")]
    j = JP.JpegTranscodePipeline(bufs[0], *DST, quality=85,
                                 output_format=".webp")
    t = TP.JpegTranscodePipeline(bufs[0], *DST, quality=85,
                                 output_format=".webp", device="cpu")
    batches = [bufs, bufs[::-1], bufs[:1]]
    got = t.transcode_pipelined(batches)
    assert got == j.transcode_pipelined(batches)
    assert got == [t.transcode(b) for b in batches]


def _anims():
    """Mixed canvases and frame counts (frame buckets 4, 6, 12, 1)."""
    return [mixed_anim(48, 40, 4, 1), mixed_anim(48, 40, 3, 2),
            mixed_anim(33, 27, 9, 3, icc=bytes(range(64))),
            mixed_anim(48, 40, 6, 4), mixed_anim(48, 40, 1, 5)]


@pytest.mark.parametrize("fit", [True, False])
def test_transcode_webp_batch_equals_jax(fit):
    bufs = _anims()
    want = [JP.transcode_webp(b, 24, 20, fit=fit) for b in bufs]
    times = {}
    got = TP.transcode_webp_batch(bufs, 24, 20, fit=fit, device="cpu",
                                  stage_times=times)
    assert got == want
    assert got == JP.transcode_webp_batch(bufs, 24, 20, fit=fit)
    assert [TP.transcode_webp(b, 24, 20, fit=fit, device="cpu")
            for b in bufs] == want
    assert set(times) == {"webp_decode", "stack", "h2d", "composite",
                          "resize", "d2h", "webp_encode"}
    assert len(times["composite"]) == 4  # (48x40: 4, 6, 1 frames) + 33x27


def test_transcode_webp_options_equal_jax():
    buf = _anims()[0]
    opts = {WEBP_QUALITY: 101}
    assert TP.transcode_webp(buf, 24, 20, fit=True, encode_options=opts,
                             device="cpu") == JP.transcode_webp(
        buf, 24, 20, fit=True, encode_options=opts)


def test_animated_pipeline_webp_equals_jax():
    """GIF and WebP sources through AnimatedTranscodePipeline(".webp"):
    both batch paths, the JAX package's bytes; a broken WebP fails only
    its own slot (the group falls back per item), as there."""
    rgb = smooth(80, 60, 3, 7)
    anims = _anims()
    broken = anims[1][:len(anims[1]) // 2]
    bufs = [pan_gif(rgb, 40, 32, 4), anims[0], pan_gif(rgb, 40, 32, 6,
                                                       start=3),
            broken, anims[3], anims[2]]
    j = L.AnimatedTranscodePipeline(24, 20, output_format=".webp")
    t = T.AnimatedTranscodePipeline(24, 20, output_format=".webp",
                                    device="cpu")
    want = j.transcode(bufs, return_exceptions=True)
    got = t.transcode(bufs, return_exceptions=True)
    assert [type(g).__name__ for g in got] == [type(w).__name__
                                               for w in want]
    assert isinstance(got[3], Exception)
    assert [g for g in got if isinstance(g, bytes)] == [
        w for w in want if isinstance(w, bytes)]
    assert got[1] == t.transcode_one(bufs[1])


@pytest.mark.parametrize("fit", [True, False])
def test_gif_to_webp_equals_jax(fit):
    rgb = smooth(80, 60, 3, 8)
    gifs = [pan_gif(rgb, 40, 32, 4), pan_gif(rgb, 40, 32, 6, start=3),
            pan_gif(rgb, 30, 20, 3, start=5)]
    want = [JP.transcode_gif(g, 20, 16, fit=fit, file_type=".webp")
            for g in gifs]
    times = {}
    got = TP.transcode_gif_batch(gifs, 20, 16, fit=fit, file_type=".webp",
                                 device="cpu", stage_times=times)
    assert got == want
    assert TP.transcode_gif(gifs[2], 20, 16, fit=fit, file_type=".webp",
                            device="cpu") == want[2]
    assert {"d2h", "webp_encode"} <= set(times)
    assert "quantize" not in times


def test_multigeometry_webp_equals_jax():
    """A shuffled mix to .webp: JPEGs, PNGs, still WebPs (RGB, RGBA),
    animated WebPs and GIFs, in input order; one signature each still
    group, the animations on the animated front."""
    rgb = smooth(80, 60, 3, 9)
    items = [JPEG_SOURCES["420"](), JPEG_SOURCES["gray"](), _png(3), _png(4),
             still_webp(smooth(80, 60, 3, 4)),
             still_webp(smooth(80, 60, 4, 5)), mixed_anim(48, 40, 4, 1),
             mixed_anim(48, 40, 3, 2), pan_gif(rgb, 40, 32, 4)]
    bufs = [items[i] for i in np.random.default_rng(16).permutation(
        len(items))] + [items[0]]
    j = JP.MultiGeometryPipeline(*DST, quality=85, output_format=".webp")
    t = TP.MultiGeometryPipeline(*DST, quality=85, output_format=".webp",
                                 device="cpu")
    got = t.transcode(bufs)
    assert got == j.transcode(bufs)
    kinds = sorted(k[1] for k in t._pipes if k[0] == "still")
    assert kinds == ["PngDecoder", "PngDecoder", "WebpDecoder",
                     "WebpDecoder"]
    assert isinstance(t._anim_pipe, TP.AnimatedTranscodePipeline)


def test_multigeometry_routes_webp_sources_to_jpeg_output():
    """.jpeg output of still and animated WebP sources (the first frame):
    the JAX package's bytes."""
    bufs = [still_webp(smooth(80, 60, 3, 4)), still_webp(smooth(80, 60, 3, 6)),
            mixed_anim(48, 40, 3, 2)]
    j = JP.MultiGeometryPipeline(32, 32, quality=85)
    t = TP.MultiGeometryPipeline(32, 32, quality=85, device="cpu")
    want = j.transcode(bufs, return_exceptions=True)
    got = t.transcode(bufs, return_exceptions=True)
    assert [type(g).__name__ for g in got] == [type(w).__name__
                                               for w in want]
    assert [g for g in got if isinstance(g, bytes)] == [
        w for w in want if isinstance(w, bytes)]


def _opts(mod, fmt, fit=True):
    return mod.ImageOptions(
        file_type=fmt, width=24, height=20, encode_timeout=60.0,
        resize_method=mod.ResizeMethod.FIT if fit
        else mod.ResizeMethod.RESIZE, encode_options={WEBP_QUALITY: 80})


@pytest.mark.parametrize("fmt", [".webp", ".png", ".jpeg"])
@pytest.mark.parametrize("src", ["still_rgba", "still_lossy", "anim",
                                 "anim_stretch"])
def test_imageops_webp_equals_jax(src, fmt):
    buf = {"still_rgba": lambda: still_webp(smooth(50, 40, 4, 3)),
           "still_lossy": lambda: still_webp(smooth(50, 40, 3, 4),
                                             lossless=False),
           "anim": lambda: mixed_anim(48, 40, 5, 6),
           "anim_stretch": lambda: mixed_anim(33, 27, 4, 7)}[src]()
    fit = src != "anim_stretch"
    got = T.ImageOps(8192).transform(T.new_decoder(buf, device="cpu"),
                                     _opts(T, fmt, fit))
    want = L.ImageOps(8192).transform(L.new_decoder(buf), _opts(L, fmt, fit))
    assert got == want
    if src.startswith("anim") and fmt == ".webp":
        assert got == TP.transcode_webp(buf, 24, 20, fit=fit,
                                        encode_options={WEBP_QUALITY: 80},
                                        device="cpu")


@pytest.mark.parametrize("src,out", [("webp", ".webp"), ("webp", ".png"),
                                     ("anim", ".webp"), ("png", ".webp")])
def test_cli_webp_equals_examples_main(tmp_path, capsys, src, out):
    data = {"webp": lambda: still_webp(smooth(61, 45, 3, 1)),
            "anim": lambda: mixed_anim(48, 40, 4, 2),
            "png": lambda: _png(3, w=61, h=45)}[src]()
    inp = tmp_path / f"in.{'png' if src == 'png' else 'webp'}"
    inp.write_bytes(data)
    a, b = tmp_path / f"a{out}", tmp_path / f"b{out}"
    args = ["-input", str(inp), "-width", "24", "-height", "20"]
    code, lines = _port_cli(args + ["-output", str(a), "-device", "cpu"],
                            capsys)
    jcode, jlines = _jax_cli(args + ["-output", str(b)], capsys)
    assert code == jcode == 0
    assert _untimed(lines) == [ln.replace(str(b), str(a))
                               for ln in _untimed(jlines)]
    assert a.read_bytes() == b.read_bytes()


def test_missing_libwebp_raises_after_the_device_step(monkeypatch):
    """Where libwebp is absent the pipelines still build and run their
    device step (which needs none); every host WebP call raises
    HostLibraryMissingError, which nothing catches."""
    jpeg = JPEG_SOURCES["420"]()
    rgb = smooth(80, 60, 3, 7)
    gif = pan_gif(rgb, 40, 32, 4)
    anim = mixed_anim(48, 40, 3, 2)
    monkeypatch.setattr(binding, "WEBP_HEADER", "/nonexistent/encode.h")
    pipe = TP.JpegTranscodePipeline(jpeg, *DST, quality=85,
                                    output_format=".webp", device="cpu")
    args, _ = pipe._host_decode([jpeg])
    y, u, v = pipe.device_step(*args)
    assert y.shape == (1, 48, 64) and u.shape == v.shape == (1, 24, 32)
    still = TP.StillTranscodePipeline(_png(4), 40, 30, output_format=".webp",
                                      device="cpu")
    calls = [lambda: pipe.transcode([jpeg]),
             lambda: still.transcode([_png(4)]),
             lambda: TP.transcode_gif(gif, 20, 16, file_type=".webp",
                                      device="cpu"),
             lambda: TP.transcode_webp(anim, 20, 16, device="cpu"),
             lambda: T.new_decoder(anim, device="cpu"),
             lambda: T.new_encoder(".webp"),
             lambda: TP._synthetic_still("webp", 8, 8)]
    for call in calls:
        with pytest.raises(HostLibraryMissingError, match="libwebp"):
            call()
    res = T.AnimatedTranscodePipeline(20, 16, output_format=".webp",
                                      device="cpu").transcode(
        [gif, gif, anim], return_exceptions=True)
    assert all(isinstance(r, HostLibraryMissingError) for r in res)
    assert torch.equal(pipe.device_step(*args)[0], y)
