"""The port's colour ops (ops/color.py: YUV <-> BGR and the HDR -> SDR tone
map) and AVIF's host YUV -> BGR (codecs/yuv_rgb.py over its copy of
yuv_bgr.cpp) on the CPU against the JAX package:

* yuv420_to_bgr and bgr_to_yuv equal the jitted JAX functions at atol 0
  on u8, and yuv_to_rgb_norm bit for bit on its f32 output, over the
  four matrix families, both ranges, 4:2:0 (odd sizes too), 4:2:2, 4:4:0
  and 4:4:4, 8/10/12 bits. XLA:CPU folds the chroma scale into each
  coefficient, multiplies by the f32 reciprocal where the source divides
  by a constant, and fuses the multiply-adds; the port writes that form
  out, so the tier is exact;
* hdr_to_sdr (PQ and HLG, BT.2020, P3 and BT.709 primaries) stays within
  one u8 of the JAX function on at most 1e-3 of the values (STEP_MAX_*):
  XLA:CPU's exp, log and pow and its 3x3 dot differ from torch's in the
  low bits; pq_to_linear and hlg_to_linear stay within 5e-5 relative
  (PQ's ep - c1 cancels near black, where a pow ulp grows tenfold);
* KR_KB, AVCOL_SPC, the coefficient table and the primaries matrices
  equal the JAX package's;
* yuv_to_bgr_u8's C++ row kernel equals its Python reference and the JAX
  package's at atol 0 over every subsampling, parity, range and matrix,
  and planes_to_bgr_u8 equals the JAX package's on every depth branch.

These need neither ffmpeg nor a card."""

import jax
import numpy as np
import pytest
import torch

from lilliput_tpu.codecs import yuv_rgb as JY
from lilliput_tpu.ops import color as JC
from lilliput_tpu_torch.codecs import yuv_rgb as TY
from lilliput_tpu_torch.ops import color as TC

#: hdr_to_sdr's tier: at most 1 u8 apart, on at most this share of values
STEP_MAX_DIFF = 1
STEP_MAX_SHARE = 1e-3

SPACES = ["bt601", "bt709", "bt2020", "smpte240"]
#: luma (h, w) -> chroma (h, w) of each layout, at an odd size
LAYOUTS = {
    "420": ((33, 47), (17, 24)),
    "422": ((20, 30), (20, 15)),
    "440": ((22, 18), (11, 18)),
    "444": ((9, 14), (9, 14)),
}


def _planes(layout, depth, seed):
    rng = np.random.default_rng(seed)
    (h, w), (ch, cw) = LAYOUTS[layout]
    dt = np.uint8 if depth == 8 else np.uint16
    mx = 1 << depth
    return (rng.integers(0, mx, (h, w)).astype(dt),
            rng.integers(0, mx, (ch, cw)).astype(dt),
            rng.integers(0, mx, (ch, cw)).astype(dt))


def _t(a):
    """A host plane as a torch tensor (u16 held in int32)."""
    return torch.from_numpy(a.astype(np.int32) if a.dtype == np.uint16
                            else a)


def test_tables_equal_jax():
    assert TC.KR_KB == JC.KR_KB and TC.AVCOL_SPC == JC.AVCOL_SPC
    for space in SPACES:
        assert TC.yuv_to_bgr_coeffs(space) == JC.yuv_to_bgr_coeffs(space)
    for src in ("bt709", "bt2020", "p3", "bt601"):
        np.testing.assert_array_equal(TC.primaries_to_bt709_matrix(src),
                                      JC.primaries_to_bt709_matrix(src))


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("full", [False, True], ids=["limited", "full"])
@pytest.mark.parametrize("space", SPACES)
def test_yuv420_to_bgr_equals_jax(space, full, layout):
    y, u, v = _planes(layout, 8, 7)
    h, w = y.shape
    want = np.asarray(JC.yuv420_to_bgr(y, u, v, space=space,
                                       full_range=full, out_h=h, out_w=w))
    got = TC.yuv420_to_bgr(_t(y), _t(u), _t(v), space=space,
                           full_range=full, out_h=h, out_w=w)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_yuv420_to_bgr_value_sweep():
    """Every (y, u, v) on a 16-step grid of each axis, 4:4:4, both
    ranges."""
    g = np.arange(0, 256, 15, dtype=np.uint8)
    y, u, v = (a.reshape(g.size, -1).copy() for a in
               np.meshgrid(g, g, g, indexing="ij"))
    for full in (False, True):
        for space in ("bt601", "bt709"):
            want = np.asarray(JC.yuv420_to_bgr(y, u, v, space=space,
                                               full_range=full))
            got = TC.yuv420_to_bgr(_t(y), _t(u), _t(v), space=space,
                                   full_range=full).numpy()
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("full", [False, True], ids=["limited", "full"])
@pytest.mark.parametrize("depth", [8, 10, 12])
def test_yuv_to_rgb_norm_bit_exact(depth, full, layout):
    """The f32 output, not only its rounding: every value equal."""
    for space in ("bt2020", "bt709"):
        y, u, v = _planes(layout, depth, depth * 10 + full)
        h, w = y.shape
        want = np.asarray(JC.yuv_to_rgb_norm(
            y, u, v, space=space, full_range=full, depth=depth, out_h=h,
            out_w=w))
        got = TC.yuv_to_rgb_norm(_t(y), _t(u), _t(v), space=space,
                                 full_range=full, depth=depth, out_h=h,
                                 out_w=w)
        assert got.dtype == torch.float32 and got.shape == (h, w, 3)
        np.testing.assert_array_equal(got.numpy(), want)


def test_yuv422_full_height_chroma_is_not_doubled():
    """tests/test_color_yuv.py's regression on the port: a 4:2:2 frame
    whose chroma is red on the bottom half comes out red there."""
    h, w = 32, 16
    y = np.full((h, w), 128, np.uint8)
    u = np.full((h, w // 2), 128, np.uint8)
    v = np.full((h, w // 2), 128, np.uint8)
    v[h // 2:] = 240
    out = TC.yuv420_to_bgr(_t(y), _t(u), _t(v), out_h=h, out_w=w).numpy()
    assert out[-1, :, 2].min() > out[-1, :, 0].max() + 100
    np.testing.assert_array_equal(out, np.asarray(JC.yuv420_to_bgr(
        y, u, v, out_h=h, out_w=w)))


@pytest.mark.parametrize("subsample", [True, False], ids=["420", "444"])
@pytest.mark.parametrize("hw", [(33, 47), (32, 48), (1, 1), (7, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_bgr_to_yuv_equals_jax(hw, subsample):
    for seed, space in enumerate(("bt601", "bt709", "bt2020")):
        bgr = np.random.default_rng(seed).integers(0, 256, hw + (3,),
                                                   np.uint8)
        want = JC.bgr_to_yuv(bgr, space=space, subsample=subsample)
        got = TC.bgr_to_yuv(torch.from_numpy(bgr), space=space,
                            subsample=subsample)
        for g, j in zip(got, want):
            assert g.dtype == torch.uint8
            np.testing.assert_array_equal(g.numpy(), np.asarray(j))


def test_transfer_functions_close_to_jax():
    """pq_to_linear and hlg_to_linear: XLA:CPU's pow and exp are its own,
    so the values agree to a few f32 ulps, not bit for bit; PQ's ep - c1
    cancels near black and multiplies that up to ~3e-5 relative."""
    x = np.random.default_rng(3).random(20000, dtype=np.float32)
    for name in ("pq_to_linear", "hlg_to_linear"):
        want = np.asarray(jax.jit(getattr(JC, name))(x))
        got = getattr(TC, name)(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=5e-5, atol=1e-30)


def hdr_planes(h, w, depth, layout, seed):
    """Smooth gradients plus noise at `depth` bits (Reinhard's statistics
    are not degenerate on them): u16 Y, U, V for `layout`."""
    rng = np.random.default_rng(seed)
    mx = (1 << depth) - 1
    ch, cw = {"420": ((h + 1) // 2, (w + 1) // 2), "422": (h, (w + 1) // 2),
              "444": (h, w)}[layout]

    def plane(ph, pw, k):
        yy, xx = np.mgrid[0:ph, 0:pw]
        g = 0.5 + 0.35 * np.sin(yy / ph * 3.1 + k) * np.cos(xx / pw * 2.3 - k)
        g = g * mx + rng.normal(0, mx * 0.02, (ph, pw))
        return np.clip(g, 0, mx).astype(np.uint16)
    return plane(h, w, 0.3), plane(ch, cw, 1.1), plane(ch, cw, 2.0)


HDR_CASES = [  # (depth, layout, full range, matrix space, primaries, transfer)
    (10, "420", False, "bt2020", "bt2020", "pq"),
    (12, "422", True, "bt2020", "p3", "hlg"),
    (10, "444", False, "bt709", "bt709", "pq"),
    (12, "420", False, "bt2020", "bt2020", "hlg"),
    (10, "420", True, "bt601", "p3", "pq"),
]


@pytest.mark.parametrize("depth,layout,full,space,prim,transfer", HDR_CASES,
                         ids=[f"d{c[0]}-{c[1]}-{c[4]}-{c[5]}"
                              for c in HDR_CASES])
def test_hdr_to_sdr_within_the_tier(depth, layout, full, space, prim,
                                    transfer):
    y, u, v = hdr_planes(90, 121, depth, layout, depth + len(layout))
    rgb_j = JC.yuv_to_rgb_norm(y, u, v, space=space, full_range=full,
                               depth=depth, out_h=90, out_w=121)
    rgb_t = TC.yuv_to_rgb_norm(_t(y), _t(u), _t(v), space=space,
                               full_range=full, depth=depth, out_h=90,
                               out_w=121)
    np.testing.assert_array_equal(rgb_t.numpy(), np.asarray(rgb_j))
    want = np.asarray(JC.hdr_to_sdr(rgb_j, transfer=transfer,
                                    primaries=prim)).astype(int)
    got = TC.hdr_to_sdr(rgb_t, transfer=transfer, primaries=prim)
    assert got.dtype == torch.uint8 and got.shape == (90, 121, 3)
    d = np.abs(got.numpy().astype(int) - want)
    assert d.max() <= STEP_MAX_DIFF
    assert (d > 0).sum() <= STEP_MAX_SHARE * d.size
    # the tone map does map: no channel collapses to a constant
    assert all(np.ptp(got.numpy()[..., c]) > 50 for c in range(3))


# -- codecs/yuv_rgb.py -------------------------------------------------------


def _yuv_cases():
    """tests/test_avif.py:551-590's planes: every subsampling at even and
    odd sizes, with and without alpha."""
    rng = np.random.default_rng(11)
    cases = []
    for (h, w) in ((16, 16), (17, 19), (31, 33), (8, 64), (1, 7), (7, 1)):
        chh, cwh = (h + 1) // 2, (w + 1) // 2

        def r(*s):
            return rng.integers(0, 256, s, np.uint8)
        y, a = r(h, w), r(h, w)
        cases += [("420", y, r(chh, cwh), r(chh, cwh), a),
                  ("422", y, r(h, cwh), r(h, cwh), None),
                  ("444", y, r(h, w), r(h, w), a),
                  ("mono", y, None, None, None),
                  ("mono_alpha", y, None, None, a),
                  ("identity", y, r(h, w), r(h, w), a)]
    return cases


def test_yuv_to_bgr_u8_cpp_equals_python_and_jax(monkeypatch):
    for name, y, u, v, a in _yuv_cases():
        h, w = y.shape
        combos = ([(0, True)] if name == "identity" else
                  [(1, True), (1, False), (5, False), (6, True),
                   (9, False), (2, True)])
        for matrix, fr in combos:
            monkeypatch.setenv("LILLIPUT_YUV_RGB", "py")
            ref = TY.yuv_to_bgr_u8(y, u, v, matrix, fr, h, w, alpha=a)
            monkeypatch.setenv("LILLIPUT_YUV_RGB", "native")
            got = TY.yuv_to_bgr_u8(y, u, v, matrix, fr, h, w, alpha=a)
            want = JY.yuv_to_bgr_u8(y, u, v, matrix, fr, h, w, alpha=a)
            msg = f"{name} m{matrix} fr{fr} {h}x{w}"
            np.testing.assert_array_equal(got, ref, err_msg=msg)
            np.testing.assert_array_equal(got, want, err_msg=msg)


def test_yuv_to_bgr_u8_dav1d_padding_is_windowed():
    """dav1d pads planes to even sizes: the conversion reads the top-left
    (h, w) window of a larger plane."""
    rng = np.random.default_rng(2)
    y = rng.integers(0, 256, (18, 20), np.uint8)
    u = rng.integers(0, 256, (9, 10), np.uint8)
    v = rng.integers(0, 256, (9, 10), np.uint8)
    for h, w in ((17, 19), (18, 20), (17, 20)):
        got = TY.yuv_to_bgr_u8(y, u, v, 1, False, h, w)
        assert got.shape == (h, w, 3)
        np.testing.assert_array_equal(
            got, JY.yuv_to_bgr_u8(y, u, v, 1, False, h, w))


#: (depth, layout, full range, matrix, alpha, primaries): one case per
#: branch of planes_to_bgr_u8 (the JAX tests' _HBD_CASES and
#: _EXOTIC_CASES rules, and its declines)
PLANE_CASES = [
    (10, "420", True, 1, True, 1), (10, "420", False, 9, True, 1),
    (10, "422", True, 5, True, 1), (10, "444", False, 1, True, 1),
    (12, "420", True, 1, True, 1), (12, "422", True, 1, True, 1),
    (10, "420", False, 9, False, 1), (12, "444", False, 9, False, 1),
    (10, "mono", True, 1, False, 1), (10, "mono", False, 1, True, 1),
    (10, "identity", True, 0, True, 1), (8, "420", False, 9, True, 1),
    (8, "420", True, 8, True, 1), (12, "420", True, 8, False, 1),
    (8, "444", True, 12, False, 12), (12, "422", True, 12, True, 12),
    (8, "444", True, 12, False, 10), (10, "420", True, 12, True, 1),
    (10, "mono", False, 12, True, 12), (10, "mono", True, 8, False, 1),
    (8, "420", False, 8, False, 1), (16, "420", True, 1, False, 1),
    (10, "420", True, 14, False, 1),
]


@pytest.mark.parametrize("depth,layout,full,matrix,alpha,prim", PLANE_CASES,
                         ids=[f"d{c[0]}-{c[1]}-{'full' if c[2] else 'lim'}"
                              f"-m{c[3]}-{'A' if c[4] else 'noA'}-p{c[5]}"
                              for c in PLANE_CASES])
def test_planes_to_bgr_u8_equals_jax(depth, layout, full, matrix, alpha,
                                     prim):
    rng = np.random.default_rng(depth * 100 + matrix)
    h, w = 17, 23
    mx = 1 << min(depth, 12)
    dt = np.uint8 if depth == 8 else np.uint16

    def r(*s):
        return rng.integers(0, mx, s).astype(dt)
    y = r(h + 1, w + 1)          # dav1d-style even padding
    if layout == "mono":
        u = v = None
    else:
        cs = {"420": ((h + 2) // 2, (w + 2) // 2), "422": (h + 1, (w + 2) // 2),
              "444": (h + 1, w + 1), "identity": (h + 1, w + 1)}[layout]
        u, v = r(*cs), r(*cs)
    a = r(h + 1, w + 1) if alpha else None
    kw = dict(alpha=a, alpha_depth=depth if alpha else None, primaries=prim)
    want = JY.planes_to_bgr_u8(y, u, v, depth, matrix, full, h, w, **kw)
    got = TY.planes_to_bgr_u8(y, u, v, depth, matrix, full, h, w, **kw)
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got, want)
