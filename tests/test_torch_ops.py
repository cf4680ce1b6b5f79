"""The port's dense stages (ops/jpeg_kernels, ops/resize) against their JAX
counterparts on the CPU, on the same numpy inputs. Every comparison is
atol 0: the port writes out the multiply-adds XLA fuses on the CPU and
sums the 2x2 mean in XLA's order, and its matmuls take the same order as
XLA's dots (single-row products included, ops/_matmul.py).

The JAX side runs under jax.jit, as it does on the serving path: XLA
fuses (and so contracts a*x + c) only inside a compiled program, so the
same functions called eagerly round differently."""

import functools

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lilliput_tpu import pipeline as JP
from lilliput_tpu.ops import jpeg_kernels as JK
from lilliput_tpu.ops import resize as JR
from lilliput_tpu_torch.ops import jpeg_kernels as K
from lilliput_tpu_torch.ops import resize as R

from _torch_parity import qtables


def _eq(got: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    assert got.dtype == torch.from_numpy(ref[:0]).dtype
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("shape", [(3, 1, 1), (3, 2, 2), (3, 9, 13),
                                   (3, 68, 70)])
def test_dequant_idct(shape):
    rng = np.random.default_rng(sum(shape))
    c = rng.integers(-400, 400, shape + (64,)).astype(np.int16)
    qy, _ = qtables()
    ref = jax.jit(JK.dequant_idct)
    _eq(K.dequant_idct(torch.from_numpy(c), torch.from_numpy(qy)),
        ref(jnp.asarray(c), jnp.asarray(qy)))
    _eq(K.dequant_idct(torch.from_numpy(c), torch.from_numpy(qy[1])),
        ref(jnp.asarray(c), jnp.asarray(qy[1])))


@pytest.mark.parametrize("h,w,oh,ow", [(8, 8, 16, 16), (24, 40, 45, 79),
                                       (136, 140, 272, 280)])
def test_upsample_chroma(h, w, oh, ow):
    rng = np.random.default_rng(h + w)
    p = (rng.random((2, h, w)) * 400 - 70).astype(np.float32)
    ref = jax.jit(JK.upsample_chroma, static_argnums=(1, 2, 3, 4))(
        jnp.asarray(p), 2, 2, oh, ow)
    _eq(K.upsample_chroma(torch.from_numpy(p), 2, 2, oh, ow), ref)


def test_ycbcr_to_bgr():
    rng = np.random.default_rng(2)
    y, cb, cr = ((rng.random((2, 96, 80)) * 400 - 70).astype(np.float32)
                 for _ in range(3))
    ref = np.asarray(jax.jit(JK.ycbcr_to_bgr)(
        jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr)))
    got = K.ycbcr_to_bgr(*(torch.from_numpy(a) for a in (y, cb, cr)))
    for k in range(3):
        _eq(got[k], ref[..., k])


def _resize_pair(plane_hw, crop, dst, batch, seed):
    rng = np.random.default_rng(seed)
    p = rng.integers(0, 256, (batch,) + plane_hw).astype(np.uint8)
    off_x, w, off_y, h = crop
    ref = jax.jit(functools.partial(
        JR.resize_area_plane_embedded, off_x=off_x, w=w, dst_w=dst[0],
        off_y=off_y, h=h, dst_h=dst[1]))(jnp.asarray(p))
    got = R.resize_area_plane_embedded(torch.from_numpy(p), off_x, w, dst[0],
                                       off_y, h, dst[1])
    return got, np.asarray(ref)


def test_resize_bench_window():
    """The serving geometry: the 1080p fixture's decode window (1088 x 1120
    planes) with the Fit crop folded in, to 256 x 256: atol 0."""
    left, top, w, h = JP.fit_rect(1920, 1080, 256, 256)
    _eq(*_resize_pair((1088, 1120), (left - 400, w, top, h), (256, 256),
                      1, 0))


def test_resize_force_linear():
    """A mixed geometry (W up, H down): cv's joint switch makes BOTH axes
    bilinear (force_linear): atol 0."""
    _eq(*_resize_pair((64, 80), (8, 60, 0, 64), (90, 40), 2, 144))


@pytest.mark.parametrize("plane_hw,crop,dst", [
    ((48, 48), (0, 48, 0, 48), (100, 90)),       # both axes up
    ((160, 200), (20, 150, 16, 129), (65, 64)),  # a one-row last slab
])
def test_resize_small_slabs(plane_hw, crop, dst):
    """Geometries whose slabs are narrow (< 64 source rows) or dense: XLA
    sums those small dots in its own emitted order, which torch's BLAS does
    not reproduce, so the f32 sums may differ by a few ulp (observed
    <= 2^-15; bound 2^-12, the reassociation error of a <= 64-term sum of
    total <= 255 in f32). ROADMAP queue 3 logs the counts. After the
    tail's round to u8 at most 1 value in 1000 may move, by 1."""
    got, ref = _resize_pair(plane_hw, crop, dst, 2, sum(plane_hw))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2.0 ** -12)
    d = np.abs(np.clip(np.round(got.numpy()), 0, 255)
               - np.clip(np.round(ref), 0, 255))
    assert d.max() <= 1 and (d > 0).sum() <= 1e-3 * d.size


@pytest.mark.parametrize("w", [16, 32, 128, 256])
def test_downsample_chroma_2x2(w):
    """Power-of-two output widths (the 256x256 serving geometry's 128-wide
    chroma among them), where XLA's CPU reduction sums each 2x2 pairwise
    along the row first: atol 0."""
    rng = np.random.default_rng(w)
    p = (rng.random((2, 64, 2 * w)) * 255).astype(np.float32)
    _eq(K.downsample_chroma_2x2(torch.from_numpy(p)),
        jax.jit(JK.downsample_chroma_2x2)(jnp.asarray(p)))


def test_downsample_chroma_2x2_other_widths():
    """Other output widths: XLA's CPU reduction order there depends on the
    width and on the surrounding fusion (row-sequential when the mean runs
    alone, neither fixed order inside the encode fusion), so the port's
    pairwise sum may differ in the last place: bound 2^-14 (one ulp of a
    4-term sum below 1024, divided by 4). ROADMAP queue 3 logs it; the
    quantized coefficients downstream matched at every geometry tested
    (tests/test_torch_pipeline.py)."""
    rng = np.random.default_rng(3)
    p = (rng.random((2, 64, 96)) * 255).astype(np.float32)
    got = K.downsample_chroma_2x2(torch.from_numpy(p)).numpy()
    ref = np.asarray(jax.jit(JK.downsample_chroma_2x2)(jnp.asarray(p)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=2.0 ** -14)


def test_pad_to():
    p = np.arange(2 * 5 * 7, dtype=np.float32).reshape(2, 5, 7)
    _eq(K._pad_to(torch.from_numpy(p), 16, 16), JK._pad_to(jnp.asarray(p),
                                                          16, 16))
    _eq(K._pad_to(torch.from_numpy(p), 5, 7), jnp.asarray(p))


@pytest.mark.parametrize("q", [30, 85, 100])
def test_fdct_quant(q):
    rng = np.random.default_rng(q)
    p = (rng.random((2, 32, 48)) * 255).astype(np.float32)
    ql, _ = qtables((q,))
    _eq(K.fdct_quant(torch.from_numpy(p), torch.from_numpy(ql[0])),
        jax.jit(JK.fdct_quant)(jnp.asarray(p), jnp.asarray(ql[0])))


@pytest.mark.parametrize("h,w", [(256, 256), (37, 53), (48, 64)])
def test_encode_from_bgr_planes(h, w):
    rng = np.random.default_rng(h * w)
    planes = [rng.integers(0, 256, (2, h, w)).astype(np.float32)
              for _ in range(3)]
    ql, qc = qtables((85,))
    ref = JK.encode_from_bgr_planes(*(jnp.asarray(p) for p in planes),
                                    jnp.asarray(ql[0]), jnp.asarray(qc[0]),
                                    subsample=True)
    got = K.encode_from_bgr_planes(*(torch.from_numpy(p) for p in planes),
                                   torch.from_numpy(ql[0]),
                                   torch.from_numpy(qc[0]), subsample=True)
    assert len(got) == 3
    for g, r in zip(got, ref):
        _eq(g, r)


@pytest.mark.parametrize("h,w,c", [(256, 256, 3), (37, 53, 4)])
def test_encode_from_bgr(h, w, c):
    """The interleaved (..., H, W, 3+) form, alpha ignored, 4:2:0 and
    4:4:4; and bgr_to_ycbcr's planes: atol 0."""
    rng = np.random.default_rng(h + w + c)
    img = rng.integers(0, 256, (2, h, w, c)).astype(np.uint8)
    ql, qc = qtables((85,))
    qt = (torch.from_numpy(ql[0]), torch.from_numpy(qc[0]))
    for sub in (True, False):
        ref = jax.jit(JK.encode_from_bgr, static_argnames="subsample")(
            jnp.asarray(img), jnp.asarray(ql[0]), jnp.asarray(qc[0]),
            subsample=sub)
        got = K.encode_from_bgr(torch.from_numpy(img), *qt, subsample=sub)
        for g, r in zip(got, ref):
            _eq(g, r)
    ref = jax.jit(JK.bgr_to_ycbcr)(jnp.asarray(img[..., :3]))
    for g, r in zip(K.bgr_to_ycbcr(torch.from_numpy(img[..., :3])), ref):
        _eq(g, r)
