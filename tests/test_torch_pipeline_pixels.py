"""The port's .png serving output and the overlap of transcode_pipelined,
on the CPU, against the JAX package.

* The emit="pixels" device step (packed BGRA int32) equals the JAX step
  at atol 0: upright 4:2:0 against the JAX block tail, upright 4:2:2,
  4:4:0 and 4:4:4 against the JAX packed tail (each composed from the JAX
  package's functions with its Pallas kernel in interpret mode, as
  _torch_parity.jax_tail); grayscale, EXIF orientation 6,
  chroma_mode="direct" and method="linear" against the JAX pipeline's own
  jitted device_step. Their little-endian bytes are B, G, R, 255. The one
  exception is ROADMAP queue 3 entry 3's, held to its count (BOUNDS).
* transcode to .png gives the JAX package's bytes, under both deflate
  routes (LILLIPUT_LIBDEFLATE unset and 0; each module caches its
  decision, so both caches are reset), and PNG_COMPRESSION 0, 6 and 9.
* tests/test_pipeline.py:596-611 and :614-634 for the port: the .png
  output within +-1 of the port's own streaming ImageOps .png; the source
  ICC profile carried into the output; grayscale stays 1 channel.
* transcode_pipelined (the Part A loop) equals transcode per batch for
  .jpeg and .png, with a corrupt buffer isolated in its slot, over batches
  of distinct images, so reusing the pooled arrays never changes an
  earlier batch's bytes.
"""

import io

import numpy as np
import pytest
from PIL import Image

from lilliput_tpu import pipeline as JP
from lilliput_tpu.codecs import png as JPNG
from lilliput_tpu_torch import (ImageOps, ImageOptions, JpegTranscodePipeline,
                                ResizeMethod, new_decoder)
from lilliput_tpu_torch.codecs import png as TPNG
from lilliput_tpu_torch.codecs.icc import REC709_PROFILE
from lilliput_tpu_torch.errors import DecodingFailedError
from lilliput_tpu_torch.framebuffer import PNG_COMPRESSION
from lilliput_tpu_torch.ops import decode_kernels as DK

from _torch_parity import gray_jpeg, jax_tail, layout_jpeg, with_orientation


def _bufs(kind, src=(200, 150), orientation=1, n=3):
    """n images of one geometry at mixed qualities: a chroma layout or
    "gray"."""
    def make(q, seed):
        return (gray_jpeg(*src, q, seed) if kind == "gray"
                else layout_jpeg(*src, q, seed, kind))
    bufs = [make(q, seed) for seed, q in enumerate((30, 85, 95)[:n])]
    if orientation != 1:
        bufs = [with_orientation(b, orientation) for b in bufs]
    return bufs


def _pair(bufs, dst, **kw):
    jp = JP.JpegTranscodePipeline(bufs[0], *dst, quality=85,
                                  output_format=".png", **kw)
    tp = JpegTranscodePipeline(bufs[0], *dst, quality=85,
                               output_format=".png", device="cpu", **kw)
    return jp, tp


def _check_pixel_step(bufs, dst, composed: bool, bound=(0, 0), **kw):
    """The port's pixel step against the JAX one (composed: the JAX tail
    of the layout, else the JAX pipeline's own step): at atol 0, or within
    `bound` (max byte difference, count of differing bytes)."""
    jp, tp = _pair(bufs, dst, **kw)
    jargs = jp.decode_entropy(bufs)
    targs = tp.decode_entropy(bufs)
    if composed:
        ref = jax_tail(jp, *jargs, emit="pixels")
    else:
        ref = [np.asarray(r) for r in jp.device_step(*jargs, donate=False)]
    DK.reset_launches()
    got = [t.numpy() for t in tp.device_step(*targs)]
    assert not any(DK.launches.values())
    assert len(got) == len(ref) == 1
    assert got[0].dtype == np.int32 and got[0].shape == (len(bufs),
                                                          dst[1], dst[0])
    px = got[0].view(np.uint8).reshape(got[0].shape + (4,))
    if bound == (0, 0):
        np.testing.assert_array_equal(got[0], ref[0])
    else:
        d = np.abs(px.astype(int) - ref[0].view(np.uint8).reshape(
            px.shape).astype(int))
        assert d.max() <= bound[0] and (d > 0).sum() <= bound[1]
    assert (px[..., 3] == 255).all()
    return jp, tp


#: ROADMAP queue 3 entry 3 (XLA:CPU's sum order in small banded resize
#: contractions): at 67x61 -> 30x17 one byte of 6,120 moves by 1 on 4:2:0
#: and on 4:4:4 against the composed JAX tail (the JAX pipeline's own CPU
#: step agrees with the port there, bit for bit)
BOUNDS = {("420", (67, 61), (30, 17)): (1, 1),
          ("444", (67, 61), (30, 17)): (1, 1)}


@pytest.mark.parametrize("sub", ["420", "422", "440", "444"])
@pytest.mark.parametrize("src,dst", [((200, 150), (64, 48)),
                                     ((67, 61), (30, 17)),
                                     ((67, 61), (100, 90))])
def test_pixel_step_upright_layouts(sub, src, dst):
    _check_pixel_step(_bufs(sub, src), dst, composed=True,
                      bound=BOUNDS.get((sub, src, dst), (0, 0)))


@pytest.mark.parametrize("kind,orientation,kw", [
    ("gray", 1, {}), ("gray", 6, {}), ("420", 6, {}), ("444", 6, {}),
    ("420", 1, {"chroma_mode": "direct"}),
    ("420", 1, {"chroma_mode": "direct", "dct_scale": 2}),
    ("420", 1, {"method": "linear"}), ("422", 6, {"method": "linear"}),
    ("gray", 1, {"method": "linear"})])
def test_pixel_step_modes(kind, orientation, kw):
    """Grayscale, orientation 6, the direct mode (its colour conversion at
    the output size, the FMAs written out) and LINEAR, against the JAX
    pipeline's own step."""
    _check_pixel_step(_bufs(kind, orientation=orientation), (64, 48),
                      composed=False, **kw)


@pytest.fixture(params=["1", "0"], ids=["libdeflate", "zlib"])
def deflate_route(request, monkeypatch):
    """LILLIPUT_LIBDEFLATE for this test, with both packages' cached
    decisions reset (and restored afterwards)."""
    monkeypatch.setenv("LILLIPUT_LIBDEFLATE", request.param)
    monkeypatch.setattr(JPNG, "_FAST_ZLIB", None)
    monkeypatch.setattr(TPNG, "_FAST_ZLIB", None)
    return request.param


@pytest.mark.parametrize("kind,kw", [
    ("420", {}), ("444", {}), ("gray", {}),
    ("420", {"chroma_mode": "direct"})])
def test_png_transcode_bytes_equal_jax(kind, kw, deflate_route):
    bufs = _bufs(kind)
    jp, tp = _pair(bufs, (64, 48), **kw)
    got = tp.transcode(bufs)
    assert got == jp.transcode(bufs)
    assert TPNG._FAST_ZLIB == (deflate_route == "1")
    ch = 1 if kind == "gray" else 3
    for o in got:
        img = Image.open(io.BytesIO(o))
        assert img.size == (64, 48) and len(img.getbands()) == ch


@pytest.mark.parametrize("level", [0, 6, 9])
def test_png_compression_levels(level, deflate_route):
    bufs = _bufs("420", n=2)
    opts = {PNG_COMPRESSION: level}
    jp = JP.JpegTranscodePipeline(bufs[0], 48, 48, output_format=".png",
                                  encode_options=opts)
    tp = JpegTranscodePipeline(bufs[0], 48, 48, output_format=".png",
                               encode_options=opts, device="cpu")
    got = tp.transcode(bufs)
    assert got == jp.transcode(bufs)
    base = JpegTranscodePipeline(bufs[0], 48, 48, output_format=".png",
                                 device="cpu").transcode(bufs)
    assert (got == base) == (level == 6)      # the default level is 6
    for a, b in zip(got, base):
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(a))),
                                      np.asarray(Image.open(io.BytesIO(b))))


def _png_rgb(buf):
    return np.asarray(Image.open(io.BytesIO(buf)).convert("RGB")).astype(int)


def test_png_output_lossless_vs_streaming():
    """tests/test_pipeline.py:596-611 for the port: the serving .png
    output within +-1 of the port's own streaming ImageOps .png."""
    buf = layout_jpeg(320, 200, 85, 32)
    fused = JpegTranscodePipeline(buf, 64, 64, output_format=".png",
                                  device="cpu").transcode([buf])[0]
    assert fused[:8] == b"\x89PNG\r\n\x1a\n"
    streaming = ImageOps(8192).transform(
        new_decoder(buf, device="cpu"), ImageOptions(
            file_type=".png", width=64, height=64,
            resize_method=ResizeMethod.FIT, encode_timeout=600.0))
    a, b = _png_rgb(fused), _png_rgb(streaming)
    assert a.shape == b.shape == (64, 64, 3)
    assert np.abs(a - b).max() <= 1


def test_png_output_carries_icc_and_gray_stays_one_channel():
    """tests/test_pipeline.py:614-634 for the port's .png output: the
    source ICC profile is embedded; a grayscale source gives a 1-channel
    PNG."""
    bio = io.BytesIO()
    Image.open(io.BytesIO(layout_jpeg(160, 120, 95, 33))).save(
        bio, "JPEG", quality=90, icc_profile=REC709_PROFILE)
    buf = bio.getvalue()
    out = JpegTranscodePipeline(buf, 48, 48, output_format=".png",
                                device="cpu").transcode([buf])[0]
    assert Image.open(io.BytesIO(out)).info.get("icc_profile") == \
        REC709_PROFILE
    gray = gray_jpeg(160, 120, 85, 34)
    outg = JpegTranscodePipeline(gray, 40, 40, output_format=".png",
                                 device="cpu").transcode([gray])[0]
    img = Image.open(io.BytesIO(outg))
    assert img.mode == "L" and img.size == (40, 40)


@pytest.mark.parametrize("fmt", [".jpeg", ".png"])
@pytest.mark.parametrize("kind", ["420", "gray"])
def test_pipelined_equals_transcode_per_batch(fmt, kind):
    """Four batches of distinct images (the pooled input and table arrays
    are rewritten every other batch) through transcode_pipelined equal
    transcode of each batch; a corrupt buffer fails only its own slot."""
    srcs = [_bufs(kind, n=3)]
    srcs += [[(gray_jpeg(200, 150, q, 10 * b + i) if kind == "gray"
               else layout_jpeg(200, 150, q, 10 * b + i, kind))
              for i, q in enumerate((50, 75, 90))] for b in range(1, 4)]
    corrupt = srcs[2][0][:len(srcs[2][0]) // 2]
    batches = [list(b) for b in srcs]
    batches[2][1] = corrupt
    pipe = JpegTranscodePipeline(srcs[0][0], 64, 48, output_format=fmt,
                                 device="cpu")
    got = pipe.transcode_pipelined(batches, return_exceptions=True)
    assert isinstance(got[2][1], DecodingFailedError)
    ref = [JpegTranscodePipeline(srcs[0][0], 64, 48, output_format=fmt,
                                 device="cpu").transcode(
                                     b, return_exceptions=True)
           for b in batches]
    for g, r in zip(got, ref):
        for i, (a, b) in enumerate(zip(g, r)):
            if isinstance(b, Exception):
                assert type(a) is type(b)
            else:
                assert a == b, i
    # distinct inputs give distinct outputs: a reused array did not leak
    assert len({o for b in got for o in b if isinstance(o, bytes)}) == 11


def test_pool_alternates_two_slots():
    """The pinned-array pool (decode_entropy's arrays and tables, _fetch's
    outputs on the card): slot i is handed out again only at the call
    after next (batch i + 2), per key, and the pool stays bounded."""
    pipe = JpegTranscodePipeline(_bufs("420", n=1)[0], 64, 48,
                                 device="cpu")
    made = []

    def alloc():
        made.append(object())
        return made[-1]
    got = [pipe._pooled(("out", 1), alloc) for _ in range(5)]
    assert got == [made[0], made[1], made[0], made[1], made[0]]
    assert pipe._pooled(("out", 2), alloc) is made[2]
    for k in range(10):
        pipe._pooled(("out", 3 + k), alloc)
    assert len(pipe._pool) == 8 and ("out", 1) not in pipe._pool
