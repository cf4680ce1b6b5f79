"""The port's PNG encoder on the CPU against the JAX package's.

* encode_png_pixels gives equal bytes for 1, 3 and 4 channels, at levels
  0, 6 and 9, with each zlib strategy, bilevel, and with an ICC profile,
  under both deflate routes (LILLIPUT_LIBDEFLATE unset and 0; each module
  caches its decision, so both caches are reset);
* PngEncoder through a Framebuffer, with its options and the unknown-key
  warning;
* the chunk walk (iter_chunks, png_content_length, is_apng) on the same
  buffers;
* the port's png_filter.cpp is a byte-for-byte copy of the JAX package's.
"""

import os
import zlib

import numpy as np
import pytest

from lilliput_tpu.codecs import png as JPNG
from lilliput_tpu_torch import binding
from lilliput_tpu_torch.codecs import png as TPNG
from lilliput_tpu_torch.codecs.icc import SRGB_PROFILE
from lilliput_tpu_torch.framebuffer import (PNG_BILEVEL, PNG_COMPRESSION,
                                            PNG_STRATEGY, Framebuffer)


@pytest.fixture(params=["1", "0"], ids=["libdeflate", "zlib"])
def deflate_route(request, monkeypatch):
    monkeypatch.setenv("LILLIPUT_LIBDEFLATE", request.param)
    monkeypatch.setattr(JPNG, "_FAST_ZLIB", None)
    monkeypatch.setattr(TPNG, "_FAST_ZLIB", None)
    return request.param


def _pixels(h, w, c, seed):
    """Smooth pixels (deflate has something to find) with noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    base = (x * 3 + y * 5)[..., None] + np.arange(c) * 40
    return ((base + rng.integers(0, 8, (h, w, c))) % 256).astype(np.uint8)


@pytest.mark.parametrize("level", [0, 6, 9])
@pytest.mark.parametrize("c", [1, 3, 4])
def test_encode_png_pixels_equal_jax(c, level, deflate_route):
    px = _pixels(37, 53, c, seed=c * 10 + level)
    got = TPNG.encode_png_pixels(px, level)
    assert got == JPNG.encode_png_pixels(px, level)
    assert TPNG._FAST_ZLIB == (deflate_route == "1"
                               and bool(binding.load().lp_zlib_fast_available()))


@pytest.mark.parametrize("strategy", [0, 1, 2, 3, 4])
def test_encode_png_strategies_equal_jax(strategy, deflate_route):
    px = _pixels(29, 31, 3, seed=strategy)
    assert TPNG.encode_png_pixels(px, 6, strategy=strategy) == \
        JPNG.encode_png_pixels(px, 6, strategy=strategy)


@pytest.mark.parametrize("c", [1, 3])
def test_encode_png_bilevel_and_icc_equal_jax(c, deflate_route):
    px = _pixels(21, 70, c, seed=5)
    px[::3] = 0
    for kw in ({"bilevel": True}, {"icc": SRGB_PROFILE},
               {"icc": SRGB_PROFILE, "bilevel": True, "strategy": 1}):
        assert TPNG.encode_png_pixels(px, 9, **kw) == \
            JPNG.encode_png_pixels(px, 9, **kw)


def test_png_encoder_framebuffer_and_options(deflate_route):
    px = _pixels(24, 40, 3, seed=9)
    fb = Framebuffer.from_array(px, device="cpu")
    assert fb.array.device.type == "cpu"
    opts = {PNG_COMPRESSION: 9, PNG_STRATEGY: 2}
    got = TPNG.PngEncoder(icc_override=SRGB_PROFILE).encode(fb, opts)
    assert got == JPNG.encode_png_pixels(px, 9, SRGB_PROFILE, strategy=2)
    assert TPNG.PngEncoder().encode(fb, {PNG_BILEVEL: 1}) == \
        JPNG.encode_png_pixels(px, 6, bilevel=True)
    with pytest.warns(UserWarning, match="unknown option key 12345"):
        TPNG.PngEncoder().encode(fb, {12345: 1, 64: 80})   # 64: WebP's key
    with pytest.raises(Exception, match="cannot flush"):
        TPNG.PngEncoder().encode(None, {})


def _chunk(ctype, data=b""):
    return JPNG._png_chunk(ctype, data)


def test_chunk_walk_equal_jax():
    png = JPNG.encode_png_pixels(_pixels(8, 8, 3, 1), 6)
    apng = (JPNG.PNG_MAGIC + _chunk(b"IHDR", png[16:29]) + _chunk(b"acTL",
            bytes(8)) + _chunk(b"IDAT", zlib.compress(bytes(9 * 25)))
            + _chunk(b"IEND"))
    for buf in (png, png + b"trailing bytes", png[:-6], apng,
                JPNG.PNG_MAGIC, JPNG.PNG_MAGIC + b"\x00\x00\x00\x05IHD"):
        assert list(TPNG.iter_chunks(buf)) == list(JPNG.iter_chunks(buf))
        assert TPNG.png_content_length(buf) == JPNG.png_content_length(buf)
        assert TPNG.is_apng(buf) == JPNG.is_apng(buf)
    assert TPNG.png_content_length(png + b"xyz") == len(png)
    assert TPNG.is_apng(apng) and not TPNG.is_apng(png)
    assert TPNG._png_chunk(b"tEXt", b"k\x00v") == _chunk(b"tEXt", b"k\x00v")


def test_png_filter_source_is_the_jax_packages():
    """The port builds the PNG row filters from its own copy of
    png_filter.cpp; the copy must stay byte-identical to the JAX
    package's."""
    ours = os.path.join("lilliput_tpu_torch", "csrc", "host", "png_filter.cpp")
    theirs = os.path.join("lilliput_tpu", "native", "src", "png_filter.cpp")
    assert ours in binding.HOST_SOURCES[2]
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    lib = binding.load()
    assert lib.lp_zlib_fast_available() == int(
        os.path.exists(binding.LIBDEFLATE_HEADER))


def test_png_filter_round_trip():
    """lp_png_filter's rows unfilter back (lp_png_unfilter), as the
    encoder's output decodes."""
    px = _pixels(19, 23, 4, seed=3)
    raw = px.reshape(19, -1)
    lib = binding.load()
    filt = np.empty(19 * (23 * 4 + 1), np.uint8)
    u8 = TPNG._u8ptr
    lib.lp_png_filter(u8(raw), u8(filt), 19, 23 * 4, 4)
    back = np.empty(19 * 23 * 4, np.uint8)
    assert lib.lp_png_unfilter(u8(filt), u8(back), 19, 23 * 4, 4) == 0
    np.testing.assert_array_equal(back.reshape(px.shape), px)
