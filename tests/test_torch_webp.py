"""The port's WebP codec (codecs/webp.py on its copy of webp_shim.cpp),
its libwebp-exact YUV420 emit (ops/color.py) and its animated composite
(ops/palette.composite_animation_rgba) on the CPU against the JAX
package:

* the shim copy equals the JAX package's file byte for byte;
* webp_yuv420_from_packed equals the JAX function (jitted, as it is
  there) and libwebp's own import (the lp_webp_bgra_to_yuv oracle) at atol
  0, at tests/test_webp.py:175-198's shapes and its every-u8-value sweep,
  over leading batch axes too;
* encode_webp_yuv's bytes equal encode_webp_pixels' (q85, q50, with and
  without ICC) and the JAX package's; lossless is rejected there;
* WebpDecoder's header, frames, offsets, dispose, blend, durations, loop
  count, background and ICC equal the JAX package's on PIL stills (RGB,
  RGBA, ICC, lossy) and on animations assembled chunk by chunk
  (tests/_torch_webp_builders.py: sub-rects at offsets, partial alpha,
  every blend/dispose pair, ICC), tests/assets/anim_96x80.webp among
  them;
* WebpEncoder's still and animated bytes equal the JAX package's for
  every key of _WEBP_ENCODE_KEYS; an unknown key warns and is ignored as
  there;
* composite_animation_rgba equals the jitted JAX function at atol 0 at 1,
  3, 8 and 9 frames (bucket padding) and over a leading animation axis;
* where libwebp's header is missing, every entry point raises
  HostLibraryMissingError, naming libwebp.

These run where libwebp's headers exist (skipped elsewhere)."""

import os

import numpy as np
import pytest
import torch

from lilliput_tpu.codecs import webp as JW
from lilliput_tpu.framebuffer import Framebuffer as JFramebuffer
from lilliput_tpu.ops import color as JC
from lilliput_tpu.ops import palette as JPal
from lilliput_tpu_torch import binding
from lilliput_tpu_torch.codecs import webp as TW
from lilliput_tpu_torch.errors import (DecodingFailedError,
                                       HostLibraryMissingError)
from lilliput_tpu_torch.framebuffer import (WEBP_AUTOFILTER,
                                            WEBP_FILTER_STRENGTH,
                                            WEBP_FILTER_TYPE, WEBP_METHOD,
                                            WEBP_PALETTE, WEBP_PARTITIONS,
                                            WEBP_PREPROCESSING, WEBP_QUALITY,
                                            WEBP_SEGMENTS, WEBP_THREAD_LEVEL,
                                            Framebuffer)
from lilliput_tpu_torch.ops import color as TC
from lilliput_tpu_torch.ops import palette as TPal

from _torch_webp_builders import mixed_anim, smooth, still_webp

if not os.path.exists(binding.WEBP_HEADER):
    pytest.skip("libwebp's headers are absent", allow_module_level=True)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ICC = bytes(range(256)) * 2


def test_shim_copy_is_byte_identical():
    with open(os.path.join(ROOT, "lilliput_tpu", "native", "src",
                           "webp_shim.cpp"), "rb") as f:
        jax_src = f.read()
    with open(binding.WEBP_SOURCES[0], "rb") as f:
        assert f.read() == jax_src


def _oracle(px):
    """libwebp's own lossy import of (h, w, 3) BGR pixels: (y, u, v)."""
    import ctypes
    lib = binding.load_webp()
    u8p = ctypes.POINTER(ctypes.c_uint8)
    h, w, ch = px.shape
    px = np.ascontiguousarray(px)
    y = np.zeros(h * w, np.uint8)
    u = np.zeros(((h + 1) // 2) * ((w + 1) // 2), np.uint8)
    v = np.zeros_like(u)
    assert lib.lp_webp_bgra_to_yuv(
        px.ctypes.data_as(u8p), w, h, ch, y.ctypes.data_as(u8p),
        u.ctypes.data_as(u8p), v.ctypes.data_as(u8p), None) == 0
    return (y.reshape(h, w), u.reshape((h + 1) // 2, (w + 1) // 2),
            v.reshape((h + 1) // 2, (w + 1) // 2))


def _pack(px):
    return (px[..., 0].astype(np.int32) | (px[..., 1].astype(np.int32) << 8)
            | (px[..., 2].astype(np.int32) << 16) | np.int32(-16777216))


def _port_yuv(packed):
    return [a.numpy() for a in TC.webp_yuv420_from_packed(
        torch.from_numpy(packed))]


def _sweep():
    """Every u8 value in uniform 2x2 blocks (tests/test_webp.py:187-198)."""
    px = np.zeros((2, 512, 3), np.uint8)
    for v in range(256):
        px[:, 2 * v:2 * v + 2] = v
    return px


@pytest.mark.parametrize("h,w", [(2, 2), (1, 1), (5, 7), (64, 64),
                                 (33, 47), (256, 256)])
def test_yuv420_equals_jax_and_libwebp(h, w):
    px = np.random.default_rng(h * 1000 + w).integers(0, 256, (h, w, 3),
                                                      np.uint8)
    got = _port_yuv(_pack(px)[None])
    want = [np.asarray(a) for a in JC.webp_yuv420_from_packed(
        _pack(px)[None])]
    for g, j, o in zip(got, want, _oracle(px)):
        assert g.dtype == np.uint8
        np.testing.assert_array_equal(g[0], j[0])
        np.testing.assert_array_equal(g[0], o)


def test_yuv420_value_sweep():
    px = _sweep()
    got = _port_yuv(_pack(px)[None])
    want = [np.asarray(a) for a in JC.webp_yuv420_from_packed(
        _pack(px)[None])]
    for g, j, o in zip(got, want, _oracle(px)):
        np.testing.assert_array_equal(g[0], j[0])
        np.testing.assert_array_equal(g[0], o)


def test_yuv420_leading_axes():
    """Any leading batch axes: a (2, 3, 5, 7) stack equals each image's own
    conversion and the JAX function over the same stack."""
    px = np.random.default_rng(7).integers(0, 256, (2, 3, 5, 7, 3), np.uint8)
    got = _port_yuv(_pack(px))
    want = [np.asarray(a) for a in JC.webp_yuv420_from_packed(_pack(px))]
    for g, j in zip(got, want):
        np.testing.assert_array_equal(g, j)
    for i in range(2):
        for k in range(3):
            for g, o in zip(got, _oracle(px[i, k])):
                np.testing.assert_array_equal(g[i, k], o)


@pytest.mark.parametrize("icc", [None, b"\x00" * 64])
@pytest.mark.parametrize("q", [85, 50])
def test_encode_yuv_equals_pixels_and_jax(q, icc):
    px = np.random.default_rng(9).integers(0, 256, (33, 47, 3), np.uint8)
    y, u, v = [a[0] for a in _port_yuv(_pack(px)[None])]
    opts = {WEBP_QUALITY: q}
    got = TW.encode_webp_yuv(y, u, v, opts, icc)
    assert got == TW.encode_webp_pixels(px, opts, icc)
    assert got == JW.encode_webp_yuv(y, u, v, opts, icc)
    assert got == JW.encode_webp_pixels(px, opts, icc)


def test_encode_yuv_rejects_lossless():
    y = np.zeros((8, 8), np.uint8)
    u = v = np.zeros((4, 4), np.uint8)
    with pytest.raises(DecodingFailedError, match="-3"):
        TW.encode_webp_yuv(y, u, v, {WEBP_QUALITY: 101})


def _rgba_ramp(w, h, seed):
    px = smooth(w, h, 4, seed).copy()
    px[..., 3] = np.linspace(0, 255, w, dtype=np.uint8)[None, :]
    return px


STREAMS = {
    "still_rgb": lambda: still_webp(smooth(37, 29, 3, 1)),
    "still_rgba": lambda: still_webp(_rgba_ramp(37, 29, 2)),
    "still_icc": lambda: still_webp(smooth(20, 18, 3, 3), icc=ICC),
    "still_lossy": lambda: still_webp(smooth(37, 29, 3, 4), lossless=False),
    "anim": lambda: mixed_anim(48, 40, 6, 5),
    "anim_icc": lambda: mixed_anim(33, 27, 9, 6, icc=ICC),
    "anim_fixture": lambda: open(os.path.join(
        ROOT, "tests", "assets", "anim_96x80.webp"), "rb").read(),
}


def _frames(dec, fb_cls):
    out = []
    while True:
        fb = fb_cls()
        try:
            dec.decode_to(fb)
        except EOFError:
            return out
        out.append((np.asarray(fb.to_numpy()), fb.x_offset, fb.y_offset,
                    int(fb.dispose), int(fb.blend), fb.duration))


def _header(d):
    h = d.header()
    return (h.width, h.height, h.channels, int(h.orientation), h.num_frames,
            h.content_length, h.is_animated(), h.has_alpha())


@pytest.mark.parametrize("name", list(STREAMS))
def test_decoder_equals_jax(name):
    buf = STREAMS[name]()
    t = TW.WebpDecoder(buf, device="cpu")
    j = JW.WebpDecoder(buf)
    assert _header(t) == _header(j)
    assert (t.description(), t.video_codec()) == ("WEBP", "VP8")
    assert t.loop_count() == j.loop_count()
    assert t.background_color() == j.background_color()
    assert t.duration() == j.duration()
    assert t.icc() == j.icc()
    assert (t.icc() == ICC) == name.endswith("_icc")
    got, want = _frames(t, Framebuffer), _frames(j, JFramebuffer)
    assert len(got) == len(want) == t.header().num_frames
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        assert g[1:] == w[1:]
    if name.startswith("anim"):
        # the builder's frames: offsets, both blends and both disposals
        assert {g[1:5] != (0, 0, 0, 0) for g in got} == {True, False}
        assert {(g[3], g[4]) for g in got[1:]} >= {(0, 0), (1, 1)}
    t.close()
    j.close()


def test_decoder_frames_on_the_device_asked_for():
    d = TW.WebpDecoder(STREAMS["anim"](), device="cpu")
    fb = Framebuffer()
    d.decode_to(fb)
    assert isinstance(fb.array, torch.Tensor)
    assert fb.array.device == torch.device("cpu")
    assert fb.array.dtype == torch.uint8 and fb.channels == 4


def test_decoder_refuses_what_is_not_webp():
    from lilliput_tpu_torch.errors import InvalidImageError
    with pytest.raises(InvalidImageError, match="not a valid WebP"):
        TW.WebpDecoder(b"RIFF\x00\x00\x00\x00WEBPVP8 " + bytes(8),
                       device="cpu")


#: a value for each key of _WEBP_ENCODE_KEYS
KEY_VALUES = {WEBP_QUALITY: 70, WEBP_METHOD: 2, WEBP_FILTER_STRENGTH: 30,
              WEBP_FILTER_TYPE: 0, WEBP_AUTOFILTER: 1, WEBP_PARTITIONS: 2,
              WEBP_SEGMENTS: 2, WEBP_PREPROCESSING: 1, WEBP_THREAD_LEVEL: 1,
              WEBP_PALETTE: 1}


def _encode(enc_cls, fb_of, frames, opts, **kw):
    enc = enc_cls(**kw)
    for px, dur in frames:
        fb = fb_of(px)
        fb.duration = dur
        assert enc.encode(fb, opts) is None
    out = enc.encode(None, opts)
    enc.close()
    return out


def test_encode_keys_cover_the_jax_set():
    assert TW._WEBP_ENCODE_KEYS == JW._WEBP_ENCODE_KEYS == set(KEY_VALUES)


@pytest.mark.parametrize("key", sorted(KEY_VALUES))
def test_encoder_bytes_equal_jax(key):
    opts = {key: KEY_VALUES[key]}
    rgba = _rgba_ramp(30, 22, 8)
    for frames in ([(smooth(30, 22, 3, 8)[..., ::-1], 0.0)],
                   [(rgba, 0.05), (np.roll(rgba, 3, 1), 0.07),
                    (np.roll(rgba, 7, 0), 0.03)]):
        got = _encode(TW.WebpEncoder, lambda p: Framebuffer(
            torch.from_numpy(np.ascontiguousarray(p))), frames, opts)
        want = _encode(JW.WebpEncoder, lambda p: JFramebuffer(
            np.ascontiguousarray(p)), frames, opts)
        assert got == want and got[:4] == b"RIFF"


def test_encoder_keeps_the_decoders_icc_loop_and_background():
    buf = STREAMS["anim_icc"]()
    frames = [(f[0], f[5]) for f in _frames(
        TW.WebpDecoder(buf, device="cpu"), Framebuffer)]
    frames = [(np.ascontiguousarray(np.broadcast_to(
        p[:1, :1], (27, 33, 4))), d) for p, d in frames]
    got = _encode(TW.WebpEncoder, lambda p: Framebuffer(torch.from_numpy(p)),
                  frames, {}, decoded_by=TW.WebpDecoder(buf, device="cpu"))
    want = _encode(JW.WebpEncoder, JFramebuffer, frames, {},
                   decoded_by=JW.WebpDecoder(buf))
    assert got == want
    back = TW.WebpDecoder(got, device="cpu")
    assert back.icc() == ICC and back.loop_count() == 2


def test_unknown_option_key_warns_and_is_ignored():
    px = smooth(16, 12, 3, 1)
    with pytest.warns(UserWarning, match="unknown option key 424242"):
        got = TW.encode_webp_pixels(px, {424242: 1, WEBP_QUALITY: 80})
    with pytest.warns(UserWarning, match="unknown option key 424242"):
        want = JW.encode_webp_pixels(px, {424242: 1, WEBP_QUALITY: 80})
    assert got == want == TW.encode_webp_pixels(px, {WEBP_QUALITY: 80})


def _composite_inputs(rng, lead, n, h, w):
    frames = rng.integers(0, 256, lead + (n, h, w, 4)).astype(np.uint8)
    frames[..., 3] = rng.choice([0, 1, 77, 128, 254, 255],
                                lead + (n, h, w)).astype(np.uint8)
    drawn = rng.random(lead + (n, h, w)) < 0.7
    blends = rng.integers(0, 2, lead + (n,)).astype(np.int32)
    pdisp = rng.integers(0, 2, lead + (n,)).astype(np.int32)
    pdisp[..., 0] = 0
    prects = rng.random(lead + (n, h, w)) < 0.5
    return frames, drawn, blends, pdisp, prects


@pytest.mark.parametrize("n", [1, 3, 8, 9])
def test_composite_animation_rgba_equals_jax(n):
    rng = np.random.default_rng(100 + n)
    inp = _composite_inputs(rng, (), n, 23, 17)
    got = TPal.composite_animation_rgba(
        *[torch.from_numpy(a) for a in inp]).numpy()
    want = np.asarray(JPal.composite_animation_rgba(*inp))
    np.testing.assert_array_equal(got, want)


def test_composite_animation_rgba_over_an_animation_axis():
    rng = np.random.default_rng(5)
    inp = _composite_inputs(rng, (3,), 6, 11, 13)
    got = TPal.composite_animation_rgba(
        *[torch.from_numpy(a) for a in inp]).numpy()
    for k in range(3):
        want = np.asarray(JPal.composite_animation_rgba(
            *[a[k] for a in inp]))
        np.testing.assert_array_equal(got[k], want)


def test_missing_libwebp_raises_and_nothing_falls_back(monkeypatch):
    buf = STREAMS["still_rgb"]()
    px = smooth(8, 8, 3, 1)
    monkeypatch.setattr(binding, "WEBP_HEADER", "/nonexistent/encode.h")
    calls = [lambda: TW.WebpDecoder(buf, device="cpu"),
             lambda: TW.WebpEncoder(),
             lambda: TW.encode_webp_pixels(px),
             lambda: TW.encode_webp_yuv(px[..., 0], px[:4, :4, 0],
                                        px[:4, :4, 0]),
             binding.build_webp]
    for call in calls:
        with pytest.raises(HostLibraryMissingError,
                           match="libwebp.*/nonexistent/encode.h"):
            call()
    assert not issubclass(HostLibraryMissingError, NotImplementedError)
