"""The port's still serving pipeline on the CPU against the JAX package:

* the fused still tail ``pipeline._fused_still_fit_impl`` against the
  jitted ``fused_still_fit_transcode`` at atol 0, over 1, 3 and 4
  channels, EXIF orientations 1-8, JPEG coefficients and packed pixels,
  AREA, LINEAR and CUBIC, LILLIPUT_FUSED_EXACT off and on, at a
  fractional downscale, an integer downscale and an upscale; and, on the
  input where XLA:CPU's one fused program rounds one coefficient another
  way (ROADMAP queue 3 entry 16), equal to the JAX stages jitted apart
  and held to that count against the fused program;
* ``resize_area_mxu_or_exact`` (the interleaved form; queue 3 entry 3's
  count at the dense upscale) and ``_pack_pixels_a`` (alpha >= 128 wraps
  into the int32 sign bit);
* ``StillTranscodePipeline.transcode``: .jpeg and .png bytes equal to the
  JAX pipeline's on PNG RGB8, RGBA8, gray8 and palette8, BMP 24, PPM and
  an animated GIF (its first frame); the ICC profile carried through;
  ``transcode_pipelined`` equal to ``transcode`` per batch; the validation
  errors; corrupt and mismatched buffers isolated in the same slots as the
  JAX pipeline isolates them.

JAX reads LILLIPUT_FUSED_EXACT when it traces, so its caches are cleared
around each setting.
"""

import io

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from lilliput_tpu import pipeline as JP
from lilliput_tpu.codecs.jpeg import scaled_qtables
from lilliput_tpu.ops import resize as JR
from lilliput_tpu.utils.metrics import metrics as jax_metrics
from lilliput_tpu_torch import StillTranscodePipeline
from lilliput_tpu_torch import pipeline as TP
from lilliput_tpu_torch.errors import DecodingFailedError
from lilliput_tpu_torch.ops import decode_kernels as DK
from lilliput_tpu_torch.ops import resize as R
from lilliput_tpu_torch.utils import metrics

from _torch_gif_builders import pan_gif
from _torch_still_builders import png_bytes

#: (src_w, src_h, dst_w, dst_h)
GEOMS = {"down": (67, 45, 24, 20), "int": (96, 64, 48, 32),
         "up": (40, 30, 100, 70)}


@pytest.fixture(params=["0", "1"], ids=["matmul", "exact"])
def exact(request, monkeypatch):
    """LILLIPUT_FUSED_EXACT for this test, the JAX caches cleared before
    and after (JAX reads the variable at trace time)."""
    def clear():
        JP.fused_still_fit_transcode.clear_cache()
        jax.clear_caches()
    clear()
    monkeypatch.setenv("LILLIPUT_FUSED_EXACT", request.param)
    yield request.param
    clear()


def _pixels(seed, c, w, h, batch=2):
    return np.random.default_rng(seed).integers(0, 256, (batch, h, w, c),
                                                np.uint8)


def _check_tail(c, orientation, emit, geom, method="area"):
    sw, sh, dw, dh = GEOMS[geom]
    if orientation >= 5:          # the stored image is transposed
        sw, sh = sh, sw
    px = _pixels(7 * c + orientation + 31 * len(emit) + ord(geom[0]), c,
                 sw, sh)
    ql, qc = scaled_qtables(85)
    want = JP.fused_still_fit_transcode(
        jnp.asarray(px), jnp.asarray(ql), jnp.asarray(qc), src_w=sw,
        src_h=sh, dst_w=dw, dst_h=dh, method=method,
        orientation=orientation, emit=emit)
    want = [np.asarray(w) for w in (want if isinstance(want, tuple)
                                    else (want,))]
    DK.reset_launches()
    got = TP._fused_still_fit_impl(
        torch.from_numpy(px), torch.from_numpy(ql.astype(np.float32)),
        torch.from_numpy(qc.astype(np.float32)), sw, sh, dw, dh,
        method=method, orientation=orientation, emit=emit)
    assert not any(DK.launches.values())
    assert len(got) == len(want) == (1 if emit == "pixels" or c == 1
                                     else 3)
    got = [g.numpy() for g in got]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
    if emit == "pixels":
        assert want[0].shape == (2, dh, dw)
        if c < 4:
            assert (got[0].view(np.uint8).reshape(2, dh, dw, 4)[..., 3]
                    == 255).all()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("emit", ["coefs", "pixels"])
@pytest.mark.parametrize("orientation", range(1, 9))
@pytest.mark.parametrize("c", [1, 3, 4])
def test_still_tail_orientations_match_jax(c, orientation, emit):
    _check_tail(c, orientation, emit, "down")


@pytest.mark.parametrize("emit", ["coefs", "pixels"])
@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("geom", list(GEOMS))
def test_still_tail_geometries_match_jax(geom, c, emit, exact):
    for orientation in (1, 6):
        _check_tail(c, orientation, emit, geom)


@pytest.mark.parametrize("emit", ["coefs", "pixels"])
@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("method", ["linear", "cubic"])
def test_still_tail_methods_match_jax(method, c, emit):
    for orientation in (1, 6):
        _check_tail(c, orientation, emit, "down", method=method)


@pytest.mark.parametrize("geom", list(GEOMS))
def test_resize_area_mxu_or_exact_matches_jax(geom, exact):
    sw, sh, dw, dh = GEOMS[geom]
    img = _pixels(5, 3, sw, sh)
    got = R.resize_area_mxu_or_exact(torch.from_numpy(img), dw, dh)
    want = np.asarray(jax.jit(lambda x: JR.resize_area_mxu_or_exact(
        x, dw, dh))(jnp.asarray(img)))
    assert got.shape == want.shape
    assert got.dtype == (torch.float32 if exact == "1" else torch.uint8)
    # entry 3's dense upscale contraction: its count at this input
    bound = (1, 16) if (geom, exact) == ("up", "0") else (0, 0)
    d = np.abs(got.numpy().astype(np.float64) - want)
    assert (d.max(), int((d > 0).sum())) == bound


def test_still_tail_equals_the_jax_stages_where_the_fused_program_differs():
    """ROADMAP queue 3 entry 16: on this input (the one of seeds 0-199 at
    the down geometry, C=3, orientation 1, JPEG output, where anything
    differs) the jitted JAX tail rounds one luma coefficient another way
    than its own resize and encode jitted apart, which the port equals."""
    from lilliput_tpu.ops import jpeg_kernels as JK
    sw, sh, dw, dh = GEOMS["down"]
    px = np.random.default_rng(191).integers(0, 256, (2, sh, sw, 3),
                                             np.uint8)
    ql, qc = scaled_qtables(85)
    left, top, w, h = JP.fit_rect(sw, sh, dw, dh)
    resized = jax.jit(lambda x: JR.resize_area_mxu_or_exact(
        x[..., top:top + h, left:left + w, :], dw, dh))(jnp.asarray(px))
    staged = jax.jit(lambda r: JK.encode_from_bgr(
        r, jnp.asarray(ql), jnp.asarray(qc)))(resized)
    fused = JP.fused_still_fit_transcode(
        jnp.asarray(px), jnp.asarray(ql), jnp.asarray(qc), src_w=sw,
        src_h=sh, dst_w=dw, dst_h=dh)
    got = TP._fused_still_fit_impl(
        torch.from_numpy(px), torch.from_numpy(ql.astype(np.float32)),
        torch.from_numpy(qc.astype(np.float32)), sw, sh, dw, dh)
    d = []
    for g, s, f in zip(got, staged, fused):
        np.testing.assert_array_equal(g.numpy(), np.asarray(s))
        d.append(np.abs(g.numpy().astype(np.int64) - np.asarray(f)).ravel())
    d = np.concatenate(d)
    assert (int(d.max()), int((d > 0).sum()), d.size) == (1, 1, 3072)


def test_pack_pixels_a_wraps_alpha_into_the_sign_bit():
    planes = [np.array([[0, 255, 17.5, 300.0, -3.0, 128.0]], np.float32)
              for _ in range(3)]
    alpha = np.array([[255, 128, 127, 0, 200, 129]], np.float32)
    want = np.asarray(JP._pack_pixels_a(*(jnp.asarray(p) for p in planes),
                                        jnp.asarray(alpha)))
    got = TP._pack_pixels_a(*(torch.from_numpy(p) for p in planes),
                            torch.from_numpy(alpha)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got[0, [0, 1, 4, 5]] < 0).all()
    assert got.view(np.uint8).reshape(1, 6, 4)[0, :, 3].tolist() == [
        255, 128, 127, 0, 200, 129]


# -- StillTranscodePipeline ---------------------------------------------------

def _smooth(w, h, c, seed):
    """A smooth picture, (h, w, c) u8, RGB(A) or gray."""
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (6, 8, c), np.uint8)
    img = Image.fromarray(small if c > 1 else small[..., 0])
    return np.asarray(img.resize((w, h), Image.BICUBIC)).reshape(h, w, c)


def _pil(arr, fmt, **kw) -> bytes:
    bio = io.BytesIO()
    Image.fromarray(arr if arr.shape[-1] > 1 else arr[..., 0]).save(
        bio, fmt, **kw)
    return bio.getvalue()


def _palette_png(w, h, seed):
    rng = np.random.default_rng(seed)
    pal = rng.integers(0, 256, (256, 3), np.uint8)
    idx = (_smooth(w, h, 1, seed).astype(np.int64) * 37 % 256).astype(
        np.uint8)
    return png_bytes(idx, 3, palette=pal)


#: source kind -> (make(w, h, seed) -> bytes, channels of the decoded frame)
SOURCES = {
    "png_rgb8": (lambda w, h, s: png_bytes(_smooth(w, h, 3, s), 2), 3),
    "png_rgba8": (lambda w, h, s: png_bytes(_smooth(w, h, 4, s), 6), 4),
    "png_gray8": (lambda w, h, s: png_bytes(_smooth(w, h, 1, s), 0), 1),
    "png_palette8": (_palette_png, 3),
    "bmp_24": (lambda w, h, s: _pil(_smooth(w, h, 3, s), "BMP"), 3),
    "ppm": (lambda w, h, s: _pil(_smooth(w, h, 3, s), "PPM"), 3),
    "gif": (lambda w, h, s: pan_gif(_smooth(max(w, 200), max(h, 150), 3, s),
                                    w, h, 3, start=s), 4),
}


def _batch(kind, w=120, h=90, n=3):
    make = SOURCES[kind][0]
    return [make(w, h, 40 + s) for s in range(n)]


def _pair(bufs, dst=(64, 48), **kw):
    jp = JP.StillTranscodePipeline(bufs[0], *dst, quality=85, **kw)
    tp = StillTranscodePipeline(bufs[0], *dst, quality=85, device="cpu",
                                **kw)
    return jp, tp


@pytest.mark.parametrize("fmt", [".jpeg", ".png"])
@pytest.mark.parametrize("kind", list(SOURCES))
def test_transcode_bytes_equal_jax(kind, fmt):
    bufs = _batch(kind)
    jp, tp = _pair(bufs, output_format=fmt)
    assert (tp.kind, tp.src_w, tp.src_h, tp.channels, tp.orientation) == (
        jp.kind, jp.src_w, jp.src_h, jp.channels, jp.orientation)
    assert tp.channels == SOURCES[kind][1]
    DK.reset_launches()
    got = tp.transcode(bufs)
    assert not any(DK.launches.values())
    assert got == jp.transcode(bufs)
    img = Image.open(io.BytesIO(got[0]))
    assert img.size == (64, 48)
    if fmt == ".png":
        assert len(img.getbands()) == tp.channels
    else:
        assert len(img.getbands()) == (1 if tp.channels == 1 else 3)


def test_icc_profile_survives_the_transcode():
    from lilliput_tpu_torch.codecs.icc import REC709_PROFILE
    from lilliput_tpu_torch.codecs.jpeg import read_icc
    bufs = [_pil(_smooth(120, 90, 3, s), "PNG", icc_profile=REC709_PROFILE)
            for s in range(2)]
    for fmt in (".jpeg", ".png"):
        jp, tp = _pair(bufs, output_format=fmt)
        got = tp.transcode(bufs)
        assert got == jp.transcode(bufs)
        if fmt == ".jpeg":
            assert read_icc(got[0]) == REC709_PROFILE
        else:
            assert Image.open(io.BytesIO(got[1])).info.get(
                "icc_profile") == REC709_PROFILE


@pytest.mark.parametrize("fmt", [".jpeg", ".png"])
def test_pipelined_equals_transcode_per_batch(fmt):
    a, b = _batch("png_rgba8", n=3), _batch("png_rgba8", n=4)[1:][::-1]
    bad = a[1][:len(a[1]) // 2]
    tp = StillTranscodePipeline(a[0], 48, 48, output_format=fmt,
                                device="cpu")
    want = [tp.transcode(a), tp.transcode(b),
            tp.transcode([a[0], bad, a[2]], return_exceptions=True)]
    got = tp.transcode_pipelined([a, b, [a[0], bad, a[2]], a],
                                 return_exceptions=True)
    assert got[:2] == want[:2] and got[3] == want[0]
    assert got[2][0] == want[2][0] and got[2][2] == want[2][2]
    assert isinstance(got[2][1], DecodingFailedError)


def test_validation_errors_match_jax():
    from lilliput_tpu.errors import DecodingFailedError as JaxDecodingError
    png = _batch("png_rgb8", n=1)[0]
    jp, tp = _pair([png])
    others = {
        "format": SOURCES["bmp_24"][0](120, 90, 1),
        "geometry": SOURCES["png_rgb8"][0](90, 120, 1),
        "decoded shape": SOURCES["png_rgba8"][0](120, 90, 1),
    }
    for what, buf in others.items():
        with pytest.raises(DecodingFailedError, match=f"{what} mismatch"):
            tp._decode_one(buf)
        with pytest.raises(JaxDecodingError, match=f"{what} mismatch"):
            jp._decode_one(buf)
    jpeg = _pil(_smooth(64, 48, 3, 2), "JPEG")
    with pytest.raises(DecodingFailedError, match="JpegTranscodePipeline"):
        StillTranscodePipeline(jpeg, 32, 32, device="cpu")
    assert StillTranscodePipeline(png, 32, 32, output_format=".webp",
                                  device="cpu")._emit == "yuv420"
    with pytest.raises(NotImplementedError, match="item 2"):
        StillTranscodePipeline(png, 32, 32, optimize_coding=True,
                               device="cpu")
    with pytest.raises(ValueError, match="output_format"):
        StillTranscodePipeline(png, 32, 32, output_format=".gif",
                               device="cpu")


@pytest.mark.parametrize("kind", ["png_rgb8", "gif"])
def test_poison_isolated_in_the_same_slots_as_jax(kind):
    good = _batch(kind, n=2)
    bufs = [good[0], good[1][:len(good[1]) // 3],
            SOURCES[kind][0](90, 120, 7), b"\x89PNG\r\n\x1a\nbroken",
            good[1]]
    jp, tp = _pair(good)
    metrics.reset()
    jax_metrics.reset()
    got = tp.transcode(bufs, return_exceptions=True)
    want = jp.transcode(bufs, return_exceptions=True)
    for g, w in zip(got, want):
        assert isinstance(g, Exception) == isinstance(w, Exception)
        assert isinstance(g, Exception) or g == w
    assert [isinstance(g, Exception) for g in got] == [
        False, True, True, True, False]
    assert (metrics.snapshot()["counters"]["serving.poison_isolated"]
            == jax_metrics.snapshot()["counters"]["serving.poison_isolated"]
            == 3)
    with pytest.raises(DecodingFailedError):
        tp.transcode(bufs)
    # a failed lane of the pooled batch is zeroed, not left to the next
    # batch: the healthy neighbours' bytes do not change
    assert tp.transcode(good) == [got[0], got[4]]


def test_default_device_needs_a_card():
    png = _batch("png_rgb8", n=1)[0]
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StillTranscodePipeline(png, 32, 32)
