"""The port's EXIF orientation (ops/orient) against lilliput_tpu/ops/orient
on the CPU: all eight codes (and the out-of-range ones, which leave the
image as it is) on a non-square image, in the interleaved (..., H, W, C)
form and the planes form: equal."""

import numpy as np
import pytest
import torch

from lilliput_tpu.ops import orient as JO
from lilliput_tpu_torch.ops import orient as O


@pytest.mark.parametrize("orientation", range(0, 10))
def test_orient_matches_jax(orientation):
    rng = np.random.default_rng(orientation)
    img = rng.integers(0, 256, (2, 5, 7, 3)).astype(np.uint8)
    want = np.asarray(JO.orient(img, orientation))
    got = O.orient(torch.from_numpy(img), orientation)
    np.testing.assert_array_equal(got.numpy(), want)
    for c in range(3):
        plane = O.orient_planes(torch.from_numpy(img[..., c]), orientation)
        np.testing.assert_array_equal(plane.numpy(), want[..., c])
    swapped = 5 <= orientation <= 8
    assert want.shape[1:3] == ((7, 5) if swapped else (5, 7))
    if 1 <= orientation <= 8:
        assert O.swaps_dimensions(orientation) == JO.swaps_dimensions(
            orientation) == swapped
