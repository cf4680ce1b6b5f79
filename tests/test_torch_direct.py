"""The port's chroma_mode="direct" and dct_scale 2/4 modes on the CPU
against the JAX package, atol 0 unless a ROADMAP queue 3 bound is named:

* the tables: ``area_axis_matrix_scaled``, ``scaled_idct_kron_matrix`` and
  ``scaled_coef_indices`` equal bit for bit;
* ``dequant_idct_scaled`` at k = 4 and 2, 64 and k*k lanes, shared and
  per-image tables, at the CASES geometries, against the jitted JAX
  function (queue 3 entry 9 bounds the per-image k = 4 product of images
  of at most 2x2 blocks, which XLA:CPU sums in another order);
* ``device_step`` and ``transcode``'s bytes against the JAX pipeline: direct
  on the 1080p fixture at 256x256 and synthesized 4:2:0 sources
  (200x150 -> 64x48, 67x61 -> 100x90); dct_scale 2 and 4, colour and
  grayscale, with decode_entropy's truncated arrays equal to the JAX
  package's (and pinned, pooled and zeroed like the full ones);
* the reference's own gates run on the port: direct against rgb (PSNR),
  dct_scale 2 and 4 against direct, the constructor's gates, poison
  isolation and a zeroed pooled lane.
"""

import functools

import cv2
import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lilliput_tpu import pipeline as JP
from lilliput_tpu.ops import jpeg_kernels as JK
from lilliput_tpu.ops import resize as JR
from lilliput_tpu_torch import JpegTranscodePipeline
from lilliput_tpu_torch.errors import DecodingFailedError
from lilliput_tpu_torch.ops import decode_kernels as DK
from lilliput_tpu_torch.ops import jpeg_kernels as K
from lilliput_tpu_torch.ops import resize as R
from lilliput_tpu_torch.utils.metrics import metrics

from _torch_parity import (CASES, bench_bytes, coefs, gray_jpeg, layout_jpeg,
                           qtables, with_orientation)


def check_step(bufs, dst_w, dst_h, ref_step=None, bytes_too=True, **kw):
    """The port's pipeline (device="cpu") against the JAX pipeline built
    with the same keywords: decode_entropy's arrays equal, device_step's
    quantized coefficients equal those of `ref_step(jax pipeline, *args)`
    (default: the JAX pipeline's own device_step) at atol 0, no kernel
    launched, and (bytes_too) the port's encoder on them equal to the JAX
    encode_entropy of the JAX coefficients. Returns (jax pipe, port pipe,
    port args)."""
    jp = JP.JpegTranscodePipeline(bufs[0], dst_w, dst_h, quality=85, **kw)
    tp = JpegTranscodePipeline(bufs[0], dst_w, dst_h, quality=85,
                               device="cpu", **kw)
    assert tp.window_static == jp.window_static
    assert tp.chroma_mode == jp.chroma_mode
    jargs = jp.decode_entropy(bufs)
    targs = tp.decode_entropy(bufs)
    assert len(jargs) == len(targs)
    ntab = 1 if tp.ncomp == 1 else 2   # the per-image tables come last
    for i, (a, b) in enumerate(zip(jargs, targs)):
        # the port's tables are f32 (pinned on CUDA, uploaded as they
        # are), the JAX package's u16: the values must be equal
        if i >= len(jargs) - ntab:
            assert a.dtype == np.uint16 and b.dtype == np.float32
        else:
            assert a.dtype == b.dtype
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    if ref_step is None:
        ref = [np.asarray(r) for r in jp.device_step(*jargs, donate=False)]
    else:
        ref = ref_step(jp, *jargs)
    DK.reset_launches()
    got = [t.numpy() for t in tp.device_step(*targs)]
    assert not any(DK.launches.values())
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == np.int16 and g.shape == r.shape
        np.testing.assert_array_equal(g, r)
    if bytes_too:
        iccs = [b"icc-%d" % i for i in range(len(bufs))]
        assert tp.encode_entropy(*got, iccs=iccs) == jp.encode_entropy(
            *ref, iccs=iccs)
    return jp, tp, targs


# -- tables and the scaled IDCT ----------------------------------------------

@pytest.mark.parametrize("src,dst,scale,offset", [
    (1120, 256, 1080 / 256, 20.0), (70, 32, 1080 / 2 / 256, 10 / 4),
    (35, 64, 1080 / 4 / 256, 5 / 8), (68, 32, 1.984375, 0.75),
    (17, 50, 0.3, 0.0), (9, 9, 1.0, 0.5)])
def test_area_axis_matrix_scaled_equals_jax(src, dst, scale, offset):
    want = JR.area_axis_matrix_scaled(src, dst, scale, offset)
    got = R.area_axis_matrix_scaled(src, dst, scale, offset)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    banded = R.scaled_banded(src, dst, scale, offset, "cpu")
    assert banded is R.scaled_banded(src, dst, scale, offset, "cpu")


@pytest.mark.parametrize("k", [2, 4, 8])
def test_scaled_tables_equal_jax(k):
    np.testing.assert_array_equal(K.scaled_idct_kron_matrix(k),
                                  JK.scaled_idct_kron_matrix(k))
    np.testing.assert_array_equal(K.scaled_coef_indices(k),
                                  JK.scaled_coef_indices(k))
    assert K.scaled_idct_kron_matrix(k).dtype == np.float32


#: (k, CASES geometry) where XLA:CPU sums the per-image k = 4 product of
#: images of at most 2x2 blocks in another order (ROADMAP queue 3 entry 9):
#: f32 values within 2^-10, at most the count named
SCALED_BOUNDED = {(4, (16, 16)): 68, (4, (8, 8)): 31}


@pytest.mark.parametrize("shared", [False, True], ids=["per_image", "shared"])
@pytest.mark.parametrize("lanes", ["64", "kk"])
@pytest.mark.parametrize("k", [4, 2])
@pytest.mark.parametrize("hw", CASES, ids=str)
def test_dequant_idct_scaled_matches_jax(hw, k, lanes, shared):
    rng = np.random.default_rng(hw[0] * 131 + hw[1] + k)
    yc = coefs(rng, *hw)[0]
    if lanes == "kk":
        yc = np.ascontiguousarray(yc[..., JK.scaled_coef_indices(k)])
    qy = qtables()[0]
    q = qy[0] if shared else qy
    want = np.asarray(jax.jit(functools.partial(JK.dequant_idct_scaled,
                                                k=k))(jnp.asarray(yc),
                                                      jnp.asarray(q)))
    got = K.dequant_idct_scaled(torch.from_numpy(yc), torch.from_numpy(
        q.astype(np.int32)), k).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    bound = 0 if shared else SCALED_BOUNDED.get((k, hw), 0)
    d = np.abs(got - want)
    assert (d > 0).sum() <= bound and d.max() <= 2.0 ** -10


def test_dequant_idct_scaled_refuses_other_lane_counts():
    with pytest.raises(ValueError):
        K.dequant_idct_scaled(torch.zeros((1, 2, 2, 9), dtype=torch.int16),
                              torch.ones(64), 4)


# -- the pipeline ------------------------------------------------------------

def _bufs(src, sub="420", n=3):
    return [layout_jpeg(*src, q, seed, sub)
            for seed, q in enumerate((30, 85, 95)[:n])]


def test_direct_step_matches_jax_on_bench_fixture():
    jp, tp, _ = check_step([bench_bytes()], 256, 256, chroma_mode="direct")
    assert tp.window_static == (400, 0, 1120, 1080)


@pytest.mark.parametrize("src,dst", [((200, 150), (64, 48)),
                                     ((67, 61), (100, 90))], ids=str)
def test_direct_step_matches_jax(src, dst):
    check_step(_bufs(src), *dst, chroma_mode="direct")


@pytest.mark.parametrize("scale", [2, 4])
def test_dct_scale_step_matches_jax_on_bench_fixture(scale):
    _, tp, args = check_step([bench_bytes()] * 2, 256, 256,
                             chroma_mode="direct", dct_scale=scale)
    k = 8 // scale
    assert [a.shape[-1] for a in args[:3]] == [k * k] * 3


@pytest.mark.parametrize("scale", [2, 4])
@pytest.mark.parametrize("src,dst", [((200, 150), (64, 48)),
                                     ((67, 61), (100, 90))], ids=str)
def test_dct_scale_step_matches_jax(src, dst, scale):
    check_step(_bufs(src), *dst, chroma_mode="direct", dct_scale=scale)


@pytest.mark.parametrize("scale", [2, 4])
@pytest.mark.parametrize("which", ["fixture", "synth"])
def test_gray_dct_scale_step_matches_jax(which, scale):
    """Grayscale with chroma_mode="direct" becomes "rgb" (the luma-only
    path), keeping dct_scale's reduced decode."""
    if which == "fixture":
        bufs, dst = [bench_bytes("gray")] * 2, (256, 256)
    else:
        bufs, dst = [gray_jpeg(512, 384, q, s)
                     for s, q in enumerate((30, 85, 95))], (128, 128)
    _, tp, args = check_step(bufs, *dst, chroma_mode="direct",
                             dct_scale=scale)
    assert tp.ncomp == 1 and tp.chroma_mode == "rgb"
    assert args[0].shape[-1] == (8 // scale) ** 2


@pytest.mark.parametrize("kw", [{}, {"dct_scale": 2}], ids=["s1", "s2"])
def test_direct_transcode_bytes_equal_jax(kw):
    icc = bytes(range(256)) * 20
    bufs = [layout_jpeg(320, 200, 88, s, "420", icc_profile=icc)
            for s in range(2)]
    jp = JP.JpegTranscodePipeline(bufs[0], 64, 64, quality=85,
                                  chroma_mode="direct", **kw)
    tp = JpegTranscodePipeline(bufs[0], 64, 64, quality=85, device="cpu",
                               chroma_mode="direct", **kw)
    want = jp.transcode(bufs)
    assert tp.transcode(bufs) == want
    assert tp.transcode_pipelined([bufs, bufs[::-1]]) == [want, want[::-1]]


def test_truncated_arrays_are_pooled_and_zeroed():
    """dct_scale's k*k arrays rotate through their own 2-slot pool (slot i
    refilled at batch i+2) and a failed item's lane is zero in them."""
    g, other = (layout_jpeg(320, 200, 85, s, "420") for s in (21, 22))
    pipe = JpegTranscodePipeline(g, 48, 48, device="cpu",
                                 chroma_mode="direct", dct_scale=2)
    first = pipe.decode_entropy([g, other], pool=True)
    second = pipe.decode_entropy([g, other], pool=True)
    third = pipe.decode_entropy([g, other[:80]], pool=True, errors=(e := {}))
    assert first[0] is not second[0] and third[0] is first[0]
    assert list(e) == [1]
    assert all(not np.any(a[1]) for a in third)
    assert all(a.shape[-1] == 16 and a.flags.c_contiguous for a in third[:3])


# -- the reference's own gates, on the port ----------------------------------

def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


def _decode(buf, flag=cv2.IMREAD_COLOR):
    return cv2.imdecode(np.frombuffer(buf, np.uint8), flag)


def test_direct_mode_quality():
    """tests/test_pipeline.py::test_ycc_direct_mode_quality on the port:
    direct within 38 dB of rgb, luma within 42 dB."""
    buf = bench_bytes()
    a = _decode(JpegTranscodePipeline(buf, 256, 256, device="cpu"
                                      ).transcode([buf])[0])
    b = _decode(JpegTranscodePipeline(buf, 256, 256, device="cpu",
                                      chroma_mode="direct"
                                      ).transcode([buf])[0])
    assert a.shape == b.shape == (256, 256, 3)
    assert _psnr(a, b) >= 38.0
    ya = cv2.cvtColor(a, cv2.COLOR_BGR2YCrCb)[..., 0]
    yb = cv2.cvtColor(b, cv2.COLOR_BGR2YCrCb)[..., 0]
    assert _psnr(ya, yb) >= 42.0


@pytest.mark.parametrize("scale,floor", [(2, 34.0), (4, 28.0)])
def test_dct_scale_quality(scale, floor):
    """tests/test_pipeline.py's dct_scale 2 and 4 gates on the port:
    against the full-resolution direct output."""
    buf = bench_bytes()
    full = JpegTranscodePipeline(buf, 256, 256, device="cpu",
                                 chroma_mode="direct")
    red = JpegTranscodePipeline(buf, 256, 256, device="cpu",
                                chroma_mode="direct", dct_scale=scale)
    assert _psnr(_decode(full.transcode([buf])[0]),
                 _decode(red.transcode([buf])[0])) >= floor


def test_gray_dct_scale_quality():
    """test_grayscale_dct_scale_truncation on the port."""
    buf = gray_jpeg(512, 384, 90, 7)
    full = JpegTranscodePipeline(buf, 128, 128, device="cpu")
    half = JpegTranscodePipeline(buf, 128, 128, device="cpu",
                                 chroma_mode="direct", dct_scale=2)
    assert half.decode_entropy([buf])[0].shape[-1] == 16
    a = _decode(full.transcode([buf])[0], cv2.IMREAD_UNCHANGED)
    b = _decode(half.transcode([buf])[0], cv2.IMREAD_UNCHANGED)
    assert a.ndim == b.ndim == 2 and _psnr(a, b) >= 34.0


def test_constructor_gates_match_jax():
    """The gates of tests/test_pipeline.py:187-194, :335-348 and
    :1092-1099, in the JAX package's order and with its exception types,
    on both packages."""
    src = layout_jpeg(320, 200, 85, 6, "420")
    oriented = with_orientation(src, 6)
    from lilliput_tpu.errors import DecodingFailedError as JaxDFE
    for cls, dfe, extra in ((JpegTranscodePipeline, DecodingFailedError,
                             {"device": "cpu"}),
                            (JP.JpegTranscodePipeline, JaxDFE, {})):
        def make(buf, w, h, **kw):
            return cls(buf, w, h, quality=85, **extra, **kw)
        with pytest.raises(dfe, match="direct"):
            make(bench_bytes(), 255, 255, chroma_mode="direct")
        with pytest.raises(dfe, match="direct"):
            make(oriented, 64, 64, chroma_mode="direct")
        with pytest.raises(dfe, match="orientation"):
            make(oriented, 64, 64, chroma_mode="direct", dct_scale=2)
        with pytest.raises(dfe, match="direct"):
            make(src, 63, 64, chroma_mode="direct")
        with pytest.raises(dfe, match="direct"):       # 4:4:4 is not 4:2:0
            make(layout_jpeg(320, 200, 85, 6, "444"), 64, 64,
                 chroma_mode="direct")
        with pytest.raises(ValueError):
            make(src, 64, 64, method="linear", chroma_mode="direct",
                 dct_scale=2)
        with pytest.raises(ValueError):
            make(src, 64, 64, dct_scale=2)             # needs direct
        with pytest.raises(ValueError):
            make(src, 64, 64, dct_scale=3)
        with pytest.raises(dfe, match="direct"):       # direct needs AREA
            make(src, 64, 64, method="cubic", chroma_mode="direct")
        gray = make(gray_jpeg(64, 48, 85, 0), 32, 31, chroma_mode="direct")
        assert gray.chroma_mode == "rgb"               # odd dims: no gate
    assert JpegTranscodePipeline.direct_eligible(
        JpegTranscodePipeline(src, 64, 64, device="cpu").geom, 1, 64, 64,
        R.AREA)


@pytest.mark.parametrize("kw", [{"chroma_mode": "direct"},
                                {"chroma_mode": "direct", "dct_scale": 2}],
                         ids=["direct", "s2"])
def test_poison_isolation_direct_and_scaled(kw):
    g1, g2 = (layout_jpeg(320, 200, 85, s, "420") for s in (11, 12))
    pipe = JpegTranscodePipeline(g1, 64, 64, quality=85, device="cpu", **kw)
    solo1 = pipe.transcode([g1])[0]
    solo2 = pipe.transcode([g2])[0]
    # a truncated scan decodes through libjpeg, as in the JAX package
    # (tests/test_torch_jpeg_libjpeg.py): its slot holds its own transcode
    cut = g1[:len(g1) // 2]
    solo_cut = pipe.transcode([cut])[0]
    assert isinstance(solo_cut, bytes) and solo_cut not in (solo1, solo2)
    assert pipe.transcode([g1, cut, g2]) == [solo1, solo_cut, solo2]
    for poison in (g1[:100],                               # truncated header
                   layout_jpeg(640, 360, 85, 14, "420"),   # other geometry
                   layout_jpeg(320, 200, 85, 15, "444"),   # other layout
                   with_orientation(g2, 6),                # other orientation
                   b"\xff\xd8\xff\xe0garbage"):            # unparseable
        metrics.reset()
        outs = pipe.transcode([g1, poison, g2], return_exceptions=True)
        assert outs[0] == solo1 and outs[2] == solo2
        assert isinstance(outs[1], DecodingFailedError)
        assert metrics.snapshot()["counters"]["serving.poison_isolated"] == 1
    res = pipe.transcode_pipelined([[g1, g2], [g1, g1[:70], g2]],
                                   return_exceptions=True)
    assert res[0] == [solo1, solo2]
    assert res[1][0] == solo1 and res[1][2] == solo2
    assert isinstance(res[1][1], DecodingFailedError)
    pipe.transcode([g1, g2])
    errors = {}
    arrs = pipe.decode_entropy([g1, g2[:80]], pool=True, errors=errors)
    assert list(errors) == [1]
    assert not any(np.any(a[1]) for a in arrs)
