"""The port's mixed-geometry serving front on the CPU against the JAX
package's MultiGeometryPipeline:

* a shuffled batch of JPEGs in every chroma layout, two sizes, EXIF
  orientations and grayscale, PNGs (RGB, RGBA, gray), a GIF and broken
  buffers: the JAX package's bytes in input order, each group equal to its
  per-signature pipeline, the failures in the same slots;
* a truncated scan (jpeg_huff.cpp declines it, both packages decode it
  through libjpeg) and a WebP source among good ones: every slot equals
  the JAX package's output;
* stats() after repeats, the LRU's order and evictions at
  max_geometries=2, the chroma_mode="direct" fallback
  (tests/test_pipeline.py:197), gray and colour together (:382), warm()'s
  counts, signatures and lane buckets and its too-many-specs ValueError
  (:826), .gif and .webp output routing (.webp failing per request where
  libwebp is missing), a mesh that is not a parallel.Mesh refused, and
  the default device refused without a card.

Both packages' metric registries are process-global: each test that reads
them resets both first. On the CPU the JAX package's upright colour JPEG
groups take its split decode and interleaved resize, which the port does
not follow (it follows the TPU tails, tests/test_torch_pipeline.py); the
two agree at the destination sizes used here and differ by a few
coefficients at some others (96x128 -> 48x48, 160x120 -> 63x63: ROADMAP
queue 3 entry 3).
"""

import dataclasses
import io

import numpy as np
import pytest
import torch
from PIL import Image

from lilliput_tpu import pipeline as JP
from lilliput_tpu.utils.metrics import metrics as jax_metrics
from lilliput_tpu_torch import (JpegTranscodePipeline, MultiGeometryPipeline,
                                StillTranscodePipeline)
from lilliput_tpu_torch import pipeline as TP
from lilliput_tpu_torch.errors import DecodingFailedError
from lilliput_tpu_torch.ops import palette as P
from lilliput_tpu_torch.utils import metrics

from _torch_gif_builders import pan_gif
from _torch_parity import gray_jpeg, layout_jpeg, with_orientation
from _torch_still_builders import png_bytes


def _smooth(w, h, c, seed):
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (6, 8, c), np.uint8)
    img = Image.fromarray(small if c > 1 else small[..., 0])
    return np.asarray(img.resize((w, h), Image.BICUBIC)).reshape(h, w, c)


def _png(w, h, c, seed):
    return png_bytes(_smooth(w, h, c, seed), {1: 0, 3: 2, 4: 6}[c])


def _gif(w, h, seed, frames=3):
    return pan_gif(_smooth(w + 40, h + 30, 3, seed), w, h, frames,
                   start=seed)


def _pair(dst=(48, 48), **kw):
    return (JP.MultiGeometryPipeline(*dst, quality=85, **kw),
            MultiGeometryPipeline(*dst, quality=85, device="cpu", **kw))


def _reset():
    metrics.reset()
    jax_metrics.reset()


def _mixed():
    """(label, bytes) of the mixed batch, shuffled with a fixed seed."""
    items = []
    for sub in ("420", "422", "440", "444"):
        items += [(sub, layout_jpeg(160, 120, q, s, sub))
                  for s, q in ((1, 85), (2, 30))]
    items += [
        ("420_small", layout_jpeg(96, 128, 85, 3, "420")),
        ("420_small", layout_jpeg(96, 128, 95, 4, "420")),
        ("420_o6", with_orientation(layout_jpeg(160, 120, 85, 5, "420"), 6)),
        ("444_o3", with_orientation(layout_jpeg(120, 90, 85, 6, "444"), 3)),
        ("gray", gray_jpeg(160, 120, 85, 7)),
        ("gray_o8", with_orientation(gray_jpeg(120, 96, 85, 8), 8)),
        ("png_rgb", _png(160, 120, 3, 9)), ("png_rgb", _png(160, 120, 3, 10)),
        ("png_rgba", _png(160, 120, 4, 11)),
        ("png_gray", _png(100, 140, 1, 12)),
        ("gif", _gif(100, 80, 13)), ("gif", _gif(100, 80, 14)),
    ]
    rgb = items[-6][1]
    items += [("broken", rgb[:len(rgb) // 2]),          # truncated PNG
              ("broken", b"\x89PNG\r\n\x1a\n" + bytes(9)),  # bad header
              ("broken", b"not an image at all")]
    order = np.random.default_rng(2024).permutation(len(items))
    return [items[i] for i in order]


def _equal_jax(got, want):
    """Bytes equal where the JAX package gave bytes, exceptions where it
    raised (the port's own type: DecodingFailedError for the JAX one)."""
    for i, (g, w) in enumerate(zip(got, want)):
        if isinstance(w, Exception):
            assert isinstance(g, Exception), i
            assert type(g).__name__ == type(w).__name__, (i, g, w)
        else:
            assert g == w, i


def test_mixed_batch_equals_jax_in_input_order():
    items = _mixed()
    labels, bufs = [k for k, _ in items], [b for _, b in items]
    jm, tm = _pair((64, 64))
    _reset()
    want = jm.transcode(bufs, return_exceptions=True)
    got = tm.transcode(bufs, return_exceptions=True)
    _equal_jax(got, want)
    assert [isinstance(g, Exception) for g in got] == [
        k == "broken" for k in labels]
    assert tm.stats() == jm.stats()
    assert tm.stats()["geometries_cached"] == len(set(labels) - {"broken"})
    # each group: its per-signature pipeline on the same members
    for label in set(labels) - {"broken"}:
        idx = [i for i, k in enumerate(labels) if k == label]
        members = [bufs[i] for i in idx]
        cls = (StillTranscodePipeline if label.startswith(("png", "gif"))
               else JpegTranscodePipeline)
        solo = cls(members[0], 64, 64, quality=85, device="cpu")
        assert solo.transcode(members) == [got[i] for i in idx], label
    again = tm.transcode(bufs, return_exceptions=True)
    _equal_jax(again, got)


@pytest.mark.parametrize("src,seeds,dst,bound", [
    ((160, 120), (5,), (63, 63), (1, 3, 6144)),
    ((96, 128), (3, 4), (48, 48), (1, 73, 6912))])
def test_jax_cpu_route_differs_where_the_port_follows_the_tpu_tail(
        src, seeds, dst, bound):
    """The destination sizes the tests above avoid: there the JAX
    pipeline's own CPU step (split decode, interleaved resize) differs
    from its TPU tail (composed with the kernel in interpret mode), which
    the port equals at atol 0 (queue 3 entry 3's counts)."""
    from _torch_parity import jax_tail
    bufs = [layout_jpeg(*src, q, s, "420") for s, q in zip(seeds, (85, 95))]
    jp = JP.JpegTranscodePipeline(bufs[0], *dst, quality=85)
    tp = JpegTranscodePipeline(bufs[0], *dst, quality=85, device="cpu")
    args = jp.decode_entropy(bufs)
    got = [t.numpy() for t in tp.device_step(*tp.decode_entropy(bufs))]
    for g, r in zip(got, jax_tail(jp, *args)):
        np.testing.assert_array_equal(g, r)
    own = [np.asarray(r) for r in jp.device_step(*args, donate=False)]
    d = np.concatenate([np.abs(g.astype(np.int64) - r).ravel()
                        for g, r in zip(got, own)])
    assert (int(d.max()), int((d > 0).sum()), d.size) == bound


def test_truncated_scan_slot_equals_jax():
    """A truncated 4:2:0 scan decodes through libjpeg in both packages (the
    port's copy of jpeg_shim.cpp): its slot, and the rest, a still WebP
    among them (item 6.2), equal the JAX package's outputs, and no slot
    fails."""
    good = [layout_jpeg(160, 120, 85, s, "420") for s in (1, 2)]
    bio = io.BytesIO()
    Image.fromarray(_smooth(64, 48, 3, 3)).save(bio, "WEBP", lossless=True)
    bufs = [good[0], bio.getvalue(), good[1][:len(good[1]) // 2], good[1],
            _png(64, 48, 3, 4)]
    jm, tm = _pair()
    _reset()
    want = jm.transcode(bufs, return_exceptions=True)
    got = tm.transcode(bufs, return_exceptions=True)
    assert all(isinstance(w, bytes) for w in want)
    assert got == want
    assert metrics.snapshot()["counters"].get("serving.poison_isolated",
                                              0) == 0
    assert tm.transcode(bufs) == want


def test_stats_after_repeats_equal_jax():
    bufs = [layout_jpeg(120, 90, 85, 1, "420"), _png(120, 90, 3, 2),
            layout_jpeg(120, 90, 85, 3, "420"), gray_jpeg(120, 90, 85, 4)]
    jm, tm = _pair()
    _reset()
    for n in range(3):
        assert tm.transcode(bufs) == jm.transcode(bufs)
        assert tm.stats() == jm.stats()
    assert tm.stats() == {"geometries_cached": 3, "max_geometries": 64,
                          "compiles": 3, "hits": 9, "evictions": 0}


def _key(k):
    """A signature key as plain data (the JPEG geometry classes differ)."""
    if k[0] == "still":
        return k
    return dataclasses.astuple(k[0]), k[1]


def test_lru_order_and_evictions_equal_jax():
    a, b, c = (layout_jpeg(w, h, 85, 1, "420")
               for w, h in ((120, 90), (96, 64), (64, 96)))
    p = _png(80, 60, 4, 2)
    jm, tm = _pair(max_geometries=2)
    _reset()
    for batch in ([a, b], [a], [c], [p, b], [a, a, p], [c, b]):
        assert tm.transcode(batch) == jm.transcode(batch)
        assert [_key(k) for k in tm._pipes] == [_key(k) for k in jm._pipes]
        assert tm.stats() == jm.stats()
    assert tm.stats()["evictions"] == jm.stats()["evictions"] == 7


def test_direct_mode_falls_back_per_group():
    buf = layout_jpeg(160, 120, 85, 5, "420")
    for dst, mode in (((64, 64), "direct"), ((47, 47), "rgb")):
        jm, tm = _pair(dst, chroma_mode="direct")
        assert tm.transcode([buf, buf]) == jm.transcode([buf, buf])
        pipe = next(iter(tm._pipes.values()))
        assert pipe.chroma_mode == mode
        assert next(iter(jm._pipes.values())).chroma_mode == mode


def test_gray_and_colour_together():
    bufs = [layout_jpeg(160, 100, 85, 1, "420"), gray_jpeg(160, 100, 85, 2),
            layout_jpeg(160, 100, 85, 3, "420"), gray_jpeg(100, 160, 85, 4)]
    jm, tm = _pair((64, 64))
    outs = tm.transcode(bufs)
    assert outs == jm.transcode(bufs)
    for i, o in enumerate(outs):
        img = Image.open(io.BytesIO(o))
        assert img.size == (64, 64)
        assert img.mode == ("L" if i % 2 else "RGB")
        assert tm.transcode([bufs[i]])[0] == o


def test_warm_counts_and_signatures_equal_jax():
    specs = [(120, 90), (100, 76, "422"), (64, 48, "440", True),
             ("png", 64, 48, 4), layout_jpeg(96, 64, 85, 1, "444")]
    jm, tm = _pair((32, 32), max_geometries=len(specs))
    _reset()
    rep, jrep = tm.warm(specs), jm.warm(specs)
    assert rep["warmed"] == jrep["warmed"] == 5
    assert rep["compiled_new"] == jrep["compiled_new"] == 5
    assert [_key(k) for k in tm._pipes] == [_key(k) for k in jm._pipes]
    assert tm.stats() == jm.stats()
    # warmed signatures serve without a new pipeline
    bufs = [layout_jpeg(120, 90, 80, 9, "420"), _png(64, 48, 4, 9),
            gray_jpeg(64, 48, 85, 9)]
    assert tm.transcode(bufs) == jm.transcode(bufs)
    assert tm.stats() == jm.stats()
    assert tm.stats()["compiles"] == 5 and tm.stats()["hits"] == 3
    # one more signature evicts the least recently used
    tm.transcode([layout_jpeg(70, 50, 85, 1, "420")])
    st = tm.stats()
    assert st["evictions"] == 1 and st["geometries_cached"] == 5
    with pytest.raises(ValueError, match="max_geometries"):
        tm.warm(specs + [(10, 10)])
    assert tm.warm([("webp", 16, 16)])["warmed"] == jm.warm(
        [("webp", 16, 16)])["warmed"] == 1
    assert _key(next(reversed(tm._pipes))) == _key(
        next(reversed(jm._pipes))) == ("still", "WebpDecoder", 16, 16, 3, 1)
    with pytest.raises(ValueError, match="unsupported warm still format"):
        tm.warm([("bmp", 16, 16)])


@pytest.mark.parametrize("w,h,quality", [(320, 200, 85), (97, 61, 85),
                                         (1, 1, 85), (33, 47, 30)])
@pytest.mark.parametrize("layout", ["420", "422", "440", "444", "gray"])
def test_synthetic_jpeg_bytes_equal_jax(layout, w, h, quality):
    """warm()'s zero-coefficient JPEG: the port's baseline encoder writes
    the JAX package's libjpeg bytes for every layout, odd sizes and 1x1."""
    from lilliput_tpu.codecs import jpeg as JJ
    from lilliput_tpu_torch.codecs import jpeg as TJ
    kw = (dict(subsampling="420", gray=True) if layout == "gray"
          else dict(subsampling=layout))
    got = TJ.synthetic_jpeg(w, h, quality=quality, **kw)
    assert got == JJ.synthetic_jpeg(w, h, quality=quality, **kw)
    img = Image.open(io.BytesIO(got))
    assert img.size == (w, h) and img.mode == ("L" if layout == "gray"
                                               else "RGB")


def test_stage_times_record_every_group():
    """transcode(stage_times=) of the mixed front: each group's pipeline
    records its stages under the group's request indices, and the bytes
    are those of an untimed call."""
    bufs = [layout_jpeg(96, 64, 85, 1, "420"), _png(60, 40, 3, 2),
            layout_jpeg(96, 64, 85, 3, "420"), gray_jpeg(64, 48, 85, 4),
            b"not an image"]
    _, tm = _pair((32, 32))
    want = tm.transcode(bufs, return_exceptions=True)
    times = {}
    got = tm.transcode(bufs, return_exceptions=True, stage_times=times)
    assert got[:4] == want[:4] and isinstance(got[4], Exception)
    assert sorted(times) == [(0, 2), (1,), (3,)]
    for t in times.values():
        assert sorted(t) == ["device_step", "encode", "host_decode"]
        assert all(len(v) == 1 and v[0] >= 0 for v in t.values())


def test_warm_runs_every_animation_lane_bucket(monkeypatch):
    gif = _gif(40, 30, 5)
    jm, tm = _pair((24, 24), output_format=".gif")
    seen = []
    monkeypatch.setattr(TP.AnimatedTranscodePipeline, "transcode",
                        lambda self, bufs, return_exceptions=False:
                        seen.append(len(bufs)))
    tm.warm([gif])
    want = sorted({1} | {JP._anim_bucket(k, None)
                         for k in range(2, JP._MAX_ANIM_LANES + 1)})
    assert seen == want == sorted(
        {1} | {P.frame_bucket(k) for k in range(2, 33)})
    seen.clear()
    tm.warm([gif], anim_lane_buckets=(1, 2))
    assert seen == [1, 2]


def test_gif_output_routes_animations():
    gifs = [_gif(60, 40, s) for s in (1, 2)]
    bufs = [gifs[0], _png(60, 40, 3, 3), gifs[1], _gif(60, 40, 4, 1)]
    jm, tm = _pair((32, 32), output_format=".gif")
    want = jm.transcode(bufs, return_exceptions=True)
    got = tm.transcode(bufs, return_exceptions=True)
    _equal_jax(got, want)
    assert isinstance(got[1], DecodingFailedError)
    assert "GIF source" in str(got[1])
    assert isinstance(tm._anim_pipe, TP.AnimatedTranscodePipeline)
    assert tm._anim_pipe.device == torch.device("cpu")
    assert not tm._pipes
    # the animated group's stage clock is transcode_gif_batch's
    times = {}
    timed = tm.transcode(bufs, return_exceptions=True, stage_times=times)
    assert [t for t in timed if isinstance(t, bytes)] == [
        g for g in got if isinstance(g, bytes)]
    assert list(times) == [(0, 2, 3)] and "lzw_decode" in times[(0, 2, 3)]


def test_webp_output_fails_per_request(monkeypatch):
    """.webp output (item 4.7b): an animated GIF goes to the animated
    front and a still PNG to a still pipeline (a non-animated GIF takes
    the still route), and the bytes equal the JAX package's. Where libwebp
    is missing (its header path pointed at a missing file) each request
    fails with HostLibraryMissingError: in its slot on the animated front,
    raised by the still group's host encode, which nothing catches."""
    from lilliput_tpu_torch import binding
    from lilliput_tpu_torch.errors import HostLibraryMissingError
    bufs = [_gif(60, 40, 1), _png(60, 40, 3, 2), _gif(60, 40, 3, 1)]
    jm, tm = _pair((32, 32), output_format=".webp")
    got = tm.transcode(bufs, return_exceptions=True)
    assert got == jm.transcode(bufs)
    assert isinstance(tm._anim_pipe, TP.AnimatedTranscodePipeline)
    monkeypatch.setattr(binding, "WEBP_HEADER", "/nonexistent/webp.h")
    for buf in bufs:
        try:
            got = tm.transcode([buf], return_exceptions=True)[0]
        except HostLibraryMissingError as e:
            got = e
        assert isinstance(got, HostLibraryMissingError)
        assert "libwebp" in str(got)


def test_constructor_refusals():
    with pytest.raises(TypeError, match="parallel.Mesh"):
        MultiGeometryPipeline(32, 32, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="output_format"):
        MultiGeometryPipeline(32, 32, output_format=".bmp", device="cpu")
    tm = MultiGeometryPipeline(32, 32, device="cpu")
    assert tm.device == torch.device("cpu")
    tm.transcode([_png(40, 30, 3, 1), layout_jpeg(40, 30, 85, 2, "422")])
    assert all(p.device == torch.device("cpu") for p in tm._pipes.values())
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiGeometryPipeline(32, 32)
