"""The port's LINEAR and CUBIC resize, its float AREA upscale and its
LILLIPUT_FUSED_EXACT forms (ops/resize) against lilliput_tpu/ops/resize on
the CPU, the JAX side under jax.jit as on its serving path, atol 0:

* the streaming ``resize`` with LINEAR and CUBIC, u8 (Q11 fixed point;
  OpenCV's portable 8U cubic) and f32 (the separable forms, whose first
  product per pair XLA:CPU fuses), 1 and 3 channels, at downscale, upscale
  and mixed geometries of tests/test_resize_exact.py; ``_cubic_u8`` on an
  input whose int32 accumulator wraps; the f32 INTER_AREA upscale. f32
  CUBIC holds ROADMAP queue 3 entry 8's bound where XLA:CPU fuses the
  other product of a pair (CUBIC_F32_BOUNDED);
* the exact forms (plain gathers in the port, 0/1 selection dots in the
  JAX package): ``resize_area_window_exact``, ``resize_area_exact``,
  ``resize_linear_window_exact_u8``, ``resize_linear_exact_u8``, with the
  JAX declines (an upscaling axis, the 2^24 block-total bound), and the
  switch in ``resize_area_plane_embedded`` and
  ``resize_area_mxu_or_exact_planes`` with the variable set and unset
  (unset, or declined, the matrix form holds queue 3 entry 3's bound).

The pipeline's LINEAR/CUBIC modes and the exact tier end to end are in
tests/test_torch_pipeline_modes.py.
"""

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lilliput_tpu.ops import resize as JR
from lilliput_tpu_torch.ops import resize as R

#: (src_w, src_h, dst_w, dst_h) from tests/test_resize_exact.py: downscales,
#: upscales and mixed up/down
GEOMS = [
    (640, 480, 256, 256), (100, 100, 33, 57), (17, 13, 5, 4),
    (1000, 3, 7, 2), (98, 70, 14, 10), (1923, 1081, 257, 143),
    (17, 13, 40, 31), (5, 7, 113, 99), (1, 7, 9, 3), (64, 64, 65, 63),
    (640, 480, 320, 481), (33, 21, 100, 80), (100, 100, 200, 50),
]
#: f32 CUBIC geometries where XLA:CPU fuses the second product of a pass's
#: first tap pair (ROADMAP queue 3 entry 8): the values differ by at most
#: 2^-14 on at most 18% of them (55,134 of 307,840 at 640x480 -> 320x481)
CUBIC_F32_BOUNDED = [(1000, 3, 7, 2), (1, 7, 9, 3), (64, 64, 65, 63),
                     (640, 480, 320, 481), (100, 100, 200, 50)]


def _img(sw, sh, c, seed, dtype=np.uint8):
    img = np.random.default_rng(seed).integers(0, 256, (2, sh, sw, c))
    if dtype == np.uint8:
        return img.astype(np.uint8)
    return img.astype(np.float32) * np.float32(1.01) + np.float32(0.37)


def _jax(fn, img, *args):
    """fn(img, *args) jitted, the args static, as numpy."""
    return np.asarray(jax.jit(fn, static_argnums=tuple(
        range(1, 1 + len(args))))(jnp.asarray(img), *args))


@pytest.mark.parametrize("geom", GEOMS, ids=str)
@pytest.mark.parametrize("method", ["linear", "cubic"])
@pytest.mark.parametrize("dtype", ["u8", "f32"])
def test_resize_method_matches_jax(geom, method, dtype):
    sw, sh, dw, dh = geom
    c = 3 if (sw + dw) % 2 else 1
    img = _img(sw, sh, c, sw * 7 + dw, np.uint8 if dtype == "u8"
               else np.float32)
    got = R.resize(torch.from_numpy(img), dw, dh, method)
    want = _jax(JR.resize, img, dw, dh, method)
    assert got.dtype == (torch.uint8 if dtype == "u8" else torch.float32)
    assert got.shape == want.shape == (2, dh, dw, c)
    if method == "cubic" and dtype == "f32" and geom in CUBIC_F32_BOUNDED:
        d = np.abs(got.numpy() - want)
        assert d.max() <= 2.0 ** -14 and (d > 0).sum() <= 0.18 * d.size
    else:
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("geom", [g for g in GEOMS
                                  if g[2] > g[0] or g[3] > g[1]], ids=str)
def test_float_area_upscale_matches_jax(geom):
    """INTER_AREA with an upscaling axis on f32: _linear_f32 with the area
    coordinate rule."""
    sw, sh, dw, dh = geom
    img = _img(sw, sh, 3, sw + dh, np.float32)
    got = R.resize(torch.from_numpy(img), dw, dh, R.AREA)
    np.testing.assert_array_equal(got.numpy(),
                                  _jax(JR.resize, img, dw, dh, R.AREA))


@pytest.mark.parametrize("dst", [(23, 9), (70, 50)], ids=str)
def test_cubic_u8_int32_wrap_matches_jax(dst):
    """_cubic_u8 takes any integer image to int32; values far past u8 make
    the second pass's int32 accumulator wrap, which both sides must do
    alike (u8 sources cannot: |acc| < 1.6e9)."""
    img = np.random.default_rng(5).integers(-6000, 6000, (2, 31, 29, 1))
    img = img.astype(np.int32)
    dw, dh = dst
    xi, xq = R.T.cubic_tables_q11(29, dw)
    yi, yq = R.T.cubic_tables_q11(31, dh)
    h = sum(img[:, :, xi[:, k]].astype(np.int64) * xq[:, k, None]
            for k in range(4))
    acc = sum(h[:, yi[:, k]] * yq[:, k, None, None] for k in range(4))
    assert np.abs(acc).max() >= 1 << 31          # the wrap is exercised
    got = R._cubic_u8(torch.from_numpy(img), dw, dh)
    want = _jax(JR._cubic_u8, img, dw, dh)
    np.testing.assert_array_equal(got.numpy(), want)
    # and the wrapped (non-saturated) values are really in the output
    assert 0 < (got.numpy() > 0).mean() < 1


def test_resize_refuses_unknown_methods():
    img = torch.zeros((1, 8, 8, 1), dtype=torch.uint8)
    with pytest.raises(ValueError):
        R.resize(img, 4, 4, "nearest")
    assert R.resize(img, 8, 8, "nearest") is img      # same size: as is


# -- LILLIPUT_FUSED_EXACT ---------------------------------------------------

#: (plane h, w), crop (off_x, w, off_y, h), dst (w, h): general taps, the
#: 2x2 and 3x3 integer paths, identity, pure and mixed upscales
WINDOWS = [
    ((1088, 1120), (20, 1080, 4, 1080), (256, 256)),
    ((48, 64), (2, 60, 3, 40), (30, 20)),
    ((48, 64), (1, 45, 3, 42), (15, 14)),
    ((37, 41), (3, 33, 5, 29), (33, 29)),
    ((37, 41), (3, 33, 5, 29), (50, 40)),
    ((37, 41), (0, 41, 1, 30), (80, 20)),
    ((200, 160), (7, 150, 9, 181), (37, 29)),
]


def _plane(hw, seed, batch=2):
    return np.random.default_rng(seed).integers(0, 256, (batch,) + hw
                                                ).astype(np.uint8)


@pytest.mark.parametrize("hw,crop,dst", WINDOWS, ids=str)
def test_window_exact_forms_match_jax(hw, crop, dst):
    plane = _plane(hw, sum(hw) + sum(dst))
    ox, w, oy, h = crop
    args = (ox, w, dst[0], oy, h, dst[1])
    t = torch.from_numpy(plane)
    if w < dst[0] or h < dst[1]:
        got = R.resize_linear_window_exact_u8(t, *args)
        want = _jax(JR.resize_linear_window_exact_u8, plane, *args)
        assert R.resize_area_window_exact(t, *args) is None
    else:
        got = R.resize_area_window_exact(t, *args)
        want = _jax(JR.resize_area_window_exact, plane, *args)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # byte-identical to crop + streaming AREA once rounded
    crop_t = t[:, oy:oy + h, ox:ox + w, None]
    stream = R.resize(crop_t, dst[0], dst[1], R.AREA)[..., 0]
    np.testing.assert_array_equal(
        torch.clamp(torch.round(got), 0, 255).to(torch.uint8).numpy(),
        stream.numpy())


@pytest.mark.parametrize("shape,dst", [
    ((40, 60, 3), (30, 20)), ((45, 63, 3), (21, 15)), ((41, 37, 3), (23, 19)),
    ((30, 40, 3), (100, 70)), ((64, 80, 1), (90, 40))], ids=str)
def test_interleaved_exact_forms_match_jax(shape, dst):
    img = np.random.default_rng(sum(shape)).integers(
        0, 256, (2,) + shape).astype(np.uint8)
    t = torch.from_numpy(img)
    if dst[0] > shape[1] or dst[1] > shape[0]:
        got = R.resize_linear_exact_u8(t, *dst)
        want = _jax(JR.resize_linear_exact_u8, img, *dst)
        assert R.resize_area_exact(t, *dst) is None
    else:
        got = R.resize_area_exact(t, *dst)
        want = _jax(JR.resize_area_exact, img, *dst)
    np.testing.assert_array_equal(got.numpy(), want)


def test_exact_forms_decline_past_2_24():
    """fx*fy*255 >= 2^24 (257x257 -> 1x1): the block totals could stop
    being exact in f32, so both packages decline to the matrix form."""
    plane = torch.from_numpy(_plane((257, 257), 3))
    assert R.resize_area_window_exact(plane, 0, 257, 1, 0, 257, 1) is None
    assert R.resize_area_exact(plane[..., None], 1, 1) is None
    assert JR.resize_area_exact(jnp.asarray(plane.numpy()[..., None]), 1,
                                1) is None
    ok = R.resize_area_window_exact(plane, 0, 256, 1, 0, 256, 1)
    assert ok is not None                   # 256*256*255 < 2^24


#: resize_area_plane_embedded geometries, the switch's four branches: the
#: general taps, the 2x2 fast path, an upscale, the 2^24 decline
EMBEDDED = [((60, 80), (5, 70, 3, 50), (30, 20)),
            ((60, 80), (4, 64, 2, 48), (32, 24)),
            ((60, 80), (5, 30, 3, 20), (45, 40)),
            ((260, 258), (1, 257, 2, 257), (1, 1))]


@pytest.mark.parametrize("exact", ["1", "0"])
@pytest.mark.parametrize("hw,crop,dst", EMBEDDED, ids=str)
def test_embedded_switch_matches_jax(hw, crop, dst, exact, monkeypatch):
    """resize_area_plane_embedded (the upright tails) and
    resize_area_mxu_or_exact_planes (the oriented colour tail) with
    LILLIPUT_FUSED_EXACT set and unset; JAX reads it at trace time, so its
    caches are cleared around each setting."""
    plane = _plane(hw, sum(crop))
    ox, w, oy, h = crop
    args = (ox, w, dst[0], oy, h, dst[1])
    monkeypatch.setenv("LILLIPUT_FUSED_EXACT", exact)
    jax.clear_caches()
    try:
        got = R.resize_area_plane_embedded(torch.from_numpy(plane), *args)
        want = _jax(JR.resize_area_plane_embedded, plane, *args)
        cropped = np.ascontiguousarray(plane[:, oy:oy + h, ox:ox + w])
        got_o = R.resize_area_mxu_or_exact_planes(torch.from_numpy(cropped),
                                                  *dst)
        want_o = _jax(JR.resize_area_mxu_or_exact, cropped[..., None],
                      *dst)[..., 0]
    finally:
        monkeypatch.delenv("LILLIPUT_FUSED_EXACT")
        jax.clear_caches()
    declined = dst == (1, 1)
    if exact == "1" and not declined:
        np.testing.assert_array_equal(got.numpy(), want)
        assert got_o.numpy().dtype == want_o.dtype == np.float32
        np.testing.assert_array_equal(got_o.numpy(), want_o)
        return
    # the matrix form: queue 3 entry 3's bound after the tails' round and
    # clip, and the port's own matrix form bit for bit
    def u8(x):
        return np.clip(np.round(np.asarray(x, np.float32)), 0, 255)
    for g, w in ((got.numpy(), want), (got_o.numpy(), want_o)):
        d = np.abs(u8(g) - u8(w))
        assert d.max() <= 1 and (d > 0).sum() <= max(1, 1e-3 * d.size)
    np.testing.assert_array_equal(got.numpy(), R._resize_area_plane_matrices(
        torch.from_numpy(plane), *args).numpy())
    np.testing.assert_array_equal(got_o.numpy(), R.resize_area_mxu_planes(
        torch.from_numpy(cropped), *dst).numpy())


def test_linear_tables_stay_int32_on_the_device():
    """The Q11 tables keep int32 (an int64 weight would promote the
    fixed-point sums, which then no longer wrap like the JAX kernel's)."""
    for _, _, a0, a1 in [R._linear_taps(9, 4, False, True, True, "cpu")]:
        assert a0.dtype == a1.dtype == torch.int32
    assert all(w.dtype == torch.int32
               for _, w in R._cubic_taps(9, 4, True, "cpu"))
    assert R._cubic_taps(9, 4, True, "cpu") is R._cubic_taps(9, 4, True,
                                                              "cpu")
