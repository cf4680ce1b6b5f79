"""The port's INTER_AREA resize (ops/resize) against lilliput_tpu/ops/resize
on the CPU, the JAX side under jax.jit as on its serving path:

* the streaming ``resize(..., AREA)``, bit-exact to cv::resize: atol 0 on
  u8 at the grayscale tail's 1080x1080 -> 256x256, integer factors (the
  2x2 specialization and the general one), upscales (the Q11 bilinear with
  area coordinates, one axis or both) and odd sizes; f32 inputs at atol 0
  on the integer-factor and fractional downscales;
* ``resize_area_mxu`` (the colour tail's matmul form) at the same standard,
  except where XLA:CPU sums a dense (unbanded) contraction in its own
  order: there within ROADMAP queue 3 entry 3's bound (u8 within 1 on at
  most 1e-3 of the values; 10 of 42,000 move at 40x30 -> 100x70).
"""

import functools

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lilliput_tpu.ops import resize as JR
from lilliput_tpu_torch.ops import resize as R

#: (src_h, src_w, channels), (dst_w, dst_h)
GEOMS = [
    ((1080, 1080, 1), (256, 256)),     # the grayscale oriented tail
    ((96, 64, 3), (32, 48)),           # 2x2 integer factors
    ((90, 120, 1), (40, 30)),          # 3x3 integer factors
    ((131, 77, 3), (37, 29)),          # odd, fractional
    ((40, 30, 3), (100, 70)),          # both axes up
    ((64, 80, 1), (90, 40)),           # W up, H down: bilinear both
    ((75, 1, 1), (1, 20)),             # a one-pixel axis
]
#: resize_area_mxu geometries under ROADMAP queue 3 entry 3's bound
MXU_BOUNDED = [((40, 30, 3), (100, 70))]


def _img(shape, seed, dtype=np.uint8):
    return np.random.default_rng(seed).integers(0, 256, (2,) + shape
                                                 ).astype(dtype)


def _jax(fn, img, dst):
    return np.asarray(jax.jit(functools.partial(fn, dst_w=dst[0],
                                                dst_h=dst[1]))(
        jnp.asarray(img)))


@pytest.mark.parametrize("shape,dst", GEOMS)
def test_resize_area_u8_matches_jax(shape, dst):
    img = _img(shape, sum(shape) + sum(dst))
    got = R.resize(torch.from_numpy(img), *dst, R.AREA)
    want = _jax(JR.resize, img, dst)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape,dst", [g for g in GEOMS
                                       if g[1][0] <= g[0][1]
                                       and g[1][1] <= g[0][0]])
def test_resize_area_f32_matches_jax(shape, dst):
    img = _img(shape, sum(shape), np.float32) + np.float32(0.25)
    got = R.resize(torch.from_numpy(img), *dst, R.AREA)
    want = _jax(JR.resize, img, dst)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape,dst", GEOMS)
def test_resize_area_mxu_matches_jax(shape, dst):
    img = _img(shape, sum(shape) * 3 + sum(dst))
    got = R.resize_area_mxu(torch.from_numpy(img), *dst).numpy()
    want = _jax(JR.resize_area_mxu, img, dst)
    assert got.dtype == np.uint8 and got.shape == want.shape
    d = np.abs(got.astype(int) - want)
    assert d.max() <= 1 and (d > 0).sum() <= 1e-3 * d.size
    if (shape, dst) not in MXU_BOUNDED:
        assert d.max() == 0
    planes = R.resize_area_mxu_planes(
        torch.from_numpy(np.moveaxis(img, -1, 0).copy()), *dst)
    np.testing.assert_array_equal(np.moveaxis(planes.numpy(), 0, -1), got)


def test_resize_refuses_what_is_not_ported():
    """Every method of the JAX resize is ported now (LINEAR and CUBIC, and
    the f32 AREA upscale, in tests/test_torch_resize_methods.py): they
    serve, and only an unknown method refuses."""
    img = torch.zeros((1, 8, 8, 1), dtype=torch.uint8)
    for method in (R.LINEAR, R.CUBIC):
        assert R.resize(img, 4, 4, method).shape == (1, 4, 4, 1)
    with pytest.raises(ValueError):
        R.resize(img, 4, 4, "nearest")
    assert R.resize(img.float(), 16, 16, R.AREA).shape == (1, 16, 16, 1)
    assert R.resize(img, 8, 8, "nearest") is img      # same size: as is
