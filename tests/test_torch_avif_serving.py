"""AVIF through the port's serving fronts and surfaces on the CPU, against
the JAX package:

* transcode_avif and transcode_avif_batch (.avif output, and .webp where
  libwebp exists; Fit and stretch; a group of RGB and a group of RGBA
  animations, a still among them) give the JAX package's bytes; the batch
  equals per-animation transcode_avif (streaming) and ImageOps.transform
  of the same source, and stage_times names every stage;
* AnimatedTranscodePipeline batches AVIF sources for .avif and .webp
  output with the JAX package's bytes, and a corrupt AVIF fails only its
  own slot;
* AVIF sources in StillTranscodePipeline and MultiGeometryPipeline (a
  still's JPEG/PNG slots, an animation's .webp slot) equal the JAX
  fronts' bytes;
* the CLI reads and writes .avif with examples/main.py's lines and bytes.

These skip where ffmpeg's headers are absent."""

import os

import numpy as np
import pytest

import lilliput_tpu as L
import lilliput_tpu.pipeline as LP
from lilliput_tpu.codecs import avif_enc as JE
import lilliput_tpu_torch as T
import lilliput_tpu_torch.pipeline as TP
from lilliput_tpu_torch import binding
from lilliput_tpu_torch.framebuffer import AVIF_QUALITY, AVIF_SPEED

from test_torch_cli import _jax_cli, _port_cli, _untimed

if not os.path.exists(binding.AVFORMAT_HEADER):
    pytest.skip("ffmpeg's headers are absent", allow_module_level=True)

HAVE_WEBP = os.path.exists(binding.WEBP_HEADER)
OPTS = {AVIF_QUALITY: 50, AVIF_SPEED: 10}


def _smooth(h, w, c, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    px = np.stack([127 + 100 * np.sin(xx / (5 + k) + yy / (4 + k) + seed)
                   for k in range(c)], -1) + rng.normal(0, 5, (h, w, c))
    return np.clip(px, 0, 255).astype(np.uint8)


def _anim(h, w, c, n, seed, loops=0):
    """An animation the JAX encoder writes (R, G, B(, A) frames)."""
    frames = [_smooth(h, w, c, seed + i) for i in range(n)]
    durs = [30 + 10 * i for i in range(n)]
    return JE.encode(frames, durs, quality=70, speed=9, loop_count=loops)


SOURCES = {
    "rgb_a": _anim(36, 50, 3, 3, 1, loops=2),
    "rgb_b": _anim(36, 50, 3, 4, 7),           # same canvas and bucket
    "rgba_a": _anim(30, 40, 4, 4, 11),
    "rgba_b": _anim(30, 40, 4, 3, 17, loops=5),
    "still": JE.encode([_smooth(36, 50, 3, 23)], [1], quality=70, speed=9),
}
FORMATS = [".avif"] + ([".webp"] if HAVE_WEBP else [])


@pytest.mark.parametrize("fit", [True, False], ids=["fit", "stretch"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_batch_equals_jax_streaming_and_imageops(fmt, fit):
    bufs = list(SOURCES.values())
    times = {}
    got = TP.transcode_avif_batch(bufs, 24, 16, fit=fit, file_type=fmt,
                                  encode_options=OPTS, device="cpu",
                                  stage_times=times)
    want = LP.transcode_avif_batch(bufs, 24, 16, fit=fit, file_type=fmt,
                                   encode_options=OPTS)
    assert got == want
    assert sorted(times) == ["avif_decode", "d2h", "encode", "h2d",
                             "resize", "stack"]
    assert len(times["h2d"]) == 3          # the RGB, RGBA and still groups
    for buf, out in zip(bufs, got):
        assert TP.transcode_avif(buf, 24, 16, fit=fit, file_type=fmt,
                                 encode_options=OPTS, device="cpu") == out
        dec = T.new_decoder(buf, device="cpu")
        method = T.ResizeMethod.FIT if fit else T.ResizeMethod.RESIZE
        streamed = T.ImageOps(8192).transform(dec, T.ImageOptions(
            file_type=fmt, width=24, height=16, resize_method=method,
            encode_options=OPTS, encode_timeout=60.0))
        assert streamed == out
        back = T.new_decoder(out, device="cpu")
        assert back.header().num_frames == dec.header().num_frames
        assert (back.header().width, back.header().height) == (24, 16)


@pytest.mark.skipif(not HAVE_WEBP, reason="libwebp's headers are absent")
def test_webp_output_frees_every_encoder(monkeypatch):
    """Each AVIF -> WebP animation's libwebp encoder (a WebPAnimEncoder
    and a copy of its first frame) is freed: one lp_webp_enc_free per
    lp_webp_enc_new, one pair per animation, after a failed flush too."""
    lib = binding.load_webp()
    calls = {}

    def count(name, result=None):
        fn = getattr(lib, name)

        def counted(*args):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args) if result is None else result
        monkeypatch.setattr(lib, name, counted)

    count("lp_webp_enc_new")
    count("lp_webp_enc_free")
    bufs = list(SOURCES.values())
    TP.transcode_avif_batch(bufs, 24, 16, file_type=".webp",
                            encode_options=OPTS, workers=1, device="cpu")
    assert calls == {"lp_webp_enc_new": 5, "lp_webp_enc_free": 5}
    count("lp_webp_enc_flush", result=-1)
    with pytest.raises(T.DecodingFailedError, match="webp flush failed"):
        TP.transcode_avif(SOURCES["rgb_a"], 24, 16, file_type=".webp",
                          encode_options=OPTS, device="cpu")
    assert calls["lp_webp_enc_new"] == calls["lp_webp_enc_free"] == 6


def test_animated_pipeline_equals_jax_and_isolates_a_corrupt_slot():
    bufs = [SOURCES["rgba_a"], SOURCES["rgb_a"], SOURCES["rgba_b"],
            SOURCES["rgb_a"][:300], SOURCES["rgb_b"]]
    for fmt in FORMATS:
        got = T.AnimatedTranscodePipeline(
            20, 20, output_format=fmt, encode_options=OPTS,
            device="cpu").transcode(bufs, return_exceptions=True)
        want = L.AnimatedTranscodePipeline(
            20, 20, output_format=fmt, encode_options=OPTS).transcode(
            bufs, return_exceptions=True)
        for i, (g, w) in enumerate(zip(got, want)):
            if i == 3:
                assert isinstance(g, Exception)
                assert type(g).__name__ == type(w).__name__
            else:
                assert g == w and isinstance(g, bytes)
    with pytest.raises(T.DecodingFailedError):
        T.AnimatedTranscodePipeline(20, 20, output_format=".gif",
                                    device="cpu").transcode_one(
            SOURCES["rgb_a"])


@pytest.mark.parametrize("fmt", [".jpeg", ".png"] + (
    [".webp"] if HAVE_WEBP else []))
def test_still_fronts_take_avif_slots(fmt):
    """A still AVIF batch through StillTranscodePipeline, and a mix of
    AVIF, JPEG and PNG through MultiGeometryPipeline (an animated AVIF's
    slot rides the animated front for .webp, its first frame otherwise),
    equal the JAX fronts' bytes."""
    still = SOURCES["still"]
    got = T.StillTranscodePipeline(still, 24, 24, output_format=fmt,
                                   device="cpu").transcode([still, still])
    want = L.StillTranscodePipeline(still, 24, 24,
                                    output_format=fmt).transcode(
        [still, still])
    assert got == want
    jpeg = open(os.path.join(os.path.dirname(__file__), "assets",
                             "bench_1080p.jpg"), "rb").read()
    mix = [still, SOURCES["rgba_a"], jpeg, still]
    got = T.MultiGeometryPipeline(24, 24, output_format=fmt,
                                  device="cpu").transcode(
        mix, return_exceptions=True)
    want = L.MultiGeometryPipeline(24, 24, output_format=fmt).transcode(
        mix, return_exceptions=True)
    for g, w in zip(got, want):
        assert isinstance(g, bytes) and g == w


@pytest.mark.parametrize("src,ext", [("rgba_b", ".avif"), ("still", ".avif"),
                                     ("still", ".png")])
def test_cli_avif(tmp_path, capsys, src, ext):
    """python -m lilliput_tpu_torch with .avif input and output:
    examples/main.py's lines and bytes."""
    inp = tmp_path / "in.avif"
    inp.write_bytes(SOURCES[src])
    outs = {}
    for who, run in (("jax", _jax_cli), ("port", _port_cli)):
        out = tmp_path / f"out_{who}{ext}"
        argv = ["-input", str(inp), "-output", str(out), "-width", "20",
                "-height", "16"] + (["-device", "cpu"] if who == "port"
                                    else [])
        code, lines = run(argv, capsys)
        assert code == 0
        outs[who] = (out.read_bytes(), _untimed(
            [ln.replace(str(out), "OUT") for ln in lines]))
    assert outs["port"][1][0] == "file type: AVIF"
    assert outs["port"] == outs["jax"]
