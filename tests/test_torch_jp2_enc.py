"""The port's JPEG 2000 encoder on the CPU against the JAX package's: the
bytes of encode_j2k/encode_jp2 for every fixture option (lossless at odd
sizes, 9/7, rate and qscale, tiles, codeblock sizes and styles, PPT/PPM,
SOP/EPH, per-component COC styles, ROI, subsampled components, the QCD
exponent bump), from a numpy array and from a tensor; Jp2Encoder through
new_encoder(".jp2"/".j2k") with and without JPEG2000_RATE; the errors on
bad input; and the round trip through the port's own decoder. Pixels are
made with numpy from a seed.
"""

import numpy as np
import pytest
import torch

import lilliput_tpu as L
from lilliput_tpu.codecs import jp2 as JD
from lilliput_tpu.codecs import jp2_enc as JE
import lilliput_tpu_torch as T
from lilliput_tpu_torch.codecs import jp2 as TD
from lilliput_tpu_torch.codecs import jp2_enc as TE
from lilliput_tpu_torch.framebuffer import Framebuffer

from test_torch_jp2 import _img, _port, _smooth


CASES = {
    **{f"lossless_{w}x{h}": ((h, w, 3), {}) for w, h in
       ((64, 64), (63, 61), (17, 13), (1, 1), (5, 129), (200, 3))},
    "gray": ((50, 70, 0), {}),
    "rgba": ((40, 44, 4), {}),
    "two_comps": ((20, 18, 2), {}),
    "tiled": ((100, 90, 3), dict(tile=(32, 32))),
    "tiled_odd": ((70, 66, 3), dict(tile=(23, 17))),
    "nomct": ((32, 32, 3), dict(mct=False)),
    "levels2": ((33, 47, 3), dict(levels=2)),
    "levels0": ((20, 24, 3), dict(levels=0)),
    "cblk_3x4": ((40, 36, 3), dict(cblk=(3, 4))),
    "cblk_10x2": ((40, 36, 0), dict(cblk=(10, 2))),
    "97": ((80, 96, 3), dict(reversible=False)),
    "97_nomct": ((80, 96, 3), dict(reversible=False, mct=False)),
    "97_rgba": ((40, 44, 4), dict(reversible=False)),
    "97_tiled": ((70, 66, 3), dict(reversible=False, tile=(32, 32))),
    "97_qscale": ((64, 72, 3), dict(reversible=False, qscale=6.0)),
    **{f"97_rate{r}": ((64, 72, 3), dict(reversible=False, rate=r))
       for r in (4.0, 12.0, 40.0)},
    "97_rate_gray_levels2": ((48, 40, 0), dict(reversible=False, rate=8.0,
                                               levels=2, mct=False)),
    **{f"style_{s:02x}": ((44, 38, 3), dict(style=s))
       for s in (0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x05, 0x29, 0x2F)},
    "ppt": ((70, 66, 3), dict(ppt=True)),
    "ppt_tiles": ((70, 66, 3), dict(ppt=True, tile=(32, 32))),
    "ppm": ((70, 66, 3), dict(ppm=True)),
    "ppm_tiles_styled": ((70, 66, 3), dict(ppm=True, tile=(32, 32),
                                           style=0x05)),
    "sop": ((70, 66, 3), dict(sop=True)),
    "eph": ((70, 66, 3), dict(eph=True)),
    "sop_eph_ppt_bypass": ((70, 66, 3), dict(sop=True, eph=True, ppt=True,
                                             style=0x01)),
    "coc_styles": ((70, 66, 3), dict(coc_styles={1: 0x01, 2: 0x0D})),
    "roi": ((70, 66, 3), dict(roi=(10, 10, 40, 40))),
    "roi_shift": ((70, 66, 3), dict(roi=(0, 0, 20, 20), roi_shift=14)),
    "roi_tiles_gray": ((70, 66, 0), dict(roi=(4, 4, 50, 30),
                                         tile=(32, 32))),
    "sub_420": ((70, 66, 3), dict(sub=[(1, 1), (2, 2), (2, 2)])),
    "sub_mixed": ((70, 66, 3), dict(sub=[(1, 1), (2, 1), (1, 2)])),
    "sub_tiles_97": ((70, 66, 3), dict(sub=[(1, 1), (2, 2), (2, 2)],
                                       tile=(24, 24), reversible=False)),
    "eps_bump": ((30, 34, 3), dict(qcd_eps_bump=1)),
}


def _case(name):
    (h, w, c), kw = CASES[name]
    seed = sum(map(ord, name))
    if kw.get("reversible", True):
        return _img(h, w, c, seed), kw
    img = _smooth(h, w, max(c, 1), seed)
    return (img[..., 0] if c == 0 else img), kw


@pytest.mark.parametrize("name", list(CASES))
def test_encode_bytes_equal_jax(name):
    img, kw = _case(name)
    want = JE.encode_jp2(img, **kw)
    assert TE.encode_jp2(img, **kw) == want
    # a tensor encodes where it lives (here the CPU) to the same bytes
    assert TE.encode_jp2(torch.from_numpy(img), **kw) == want
    assert TE.encode_j2k(img, **kw) == JE.encode_j2k(img, **kw)
    # (tiles off the 2^levels grid: ROADMAP queue 3 entry 17)
    if (kw.get("reversible", True) and "sub" not in kw and "roi" not in kw
            and name != "tiled_odd"):
        got = _port(want)
        ref = img[..., None] if img.ndim == 2 else img
        ref = ref[..., [2, 1, 0, 3]] if ref.shape[2] == 4 else (
            ref[..., ::-1] if ref.shape[2] == 3 else ref)
        if ref.shape[2] == 2:           # gray+alpha decodes to BGRA
            ref = ref[..., [0, 0, 0, 1]]
        np.testing.assert_array_equal(got, ref)


def test_rate_search_shares_the_forward_transform(monkeypatch):
    """A rate search's trials run the forward wavelet once; the bytes
    equal the JAX package's, whose trials each run it."""
    img, _ = _case("97")
    calls = []
    orig = TE.forward_tile_planes

    def count(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    monkeypatch.setattr(TE, "forward_tile_planes", count)
    b = TE.encode_jp2(img, reversible=False, rate=30.0)
    assert b == JE.encode_jp2(img, reversible=False, rate=30.0)
    n_once = len(calls)
    calls.clear()
    TE.encode_jp2(img, reversible=False, qscale=1.0)
    assert n_once == len(calls)


@pytest.mark.parametrize("ext", [".jp2", ".j2k"])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_jp2_encoder_bytes_equal_jax(channels, ext):
    """new_encoder(".jp2"/".j2k") of a BGR(A) or gray frame, lossless and
    with JPEG2000_RATE (9/7), the JAX package's bytes."""
    img = _smooth(60, 80, channels, 40 + channels)
    enc, jenc = T.new_encoder(ext), L.new_encoder(ext)
    assert isinstance(enc, TD.Jp2Encoder)
    fb = Framebuffer.from_array(img, device="cpu")
    jfb = L.Framebuffer.from_array(img)
    for opts in ({}, {T.JPEG2000_RATE: 8000}, {T.JPEG2000_RATE: 500}):
        b = enc.encode(fb, opts)
        assert b == jenc.encode(jfb, opts)
        assert b.startswith(b"\x00\x00\x00\x0cjP")
    np.testing.assert_array_equal(_port(enc.encode(fb, {})), img)
    assert T.JPEG2000_RATE == JD.JPEG2000_RATE == 1000
    with pytest.raises(T.DecodingFailedError):
        enc.encode(None, {})


def test_encoder_rejects_bad_input_as_jax():
    for img, kw in ((np.zeros((4, 4), np.uint16), {}),
                    (np.zeros((4, 4, 3), np.uint8), dict(cblk=(10, 10))),
                    (np.zeros((4, 4, 5), np.uint8), {}),
                    (np.zeros((4, 4, 3), np.uint8), dict(sub=[(1, 1)] * 2)),
                    (np.zeros((4, 4, 3), np.uint8), dict(sub=[(5, 1)] * 3)),
                    (np.zeros((8, 8, 3), np.uint8),
                     dict(roi=(0, 0, 4, 4), reversible=False)),
                    (np.zeros((8, 8, 3), np.uint8), dict(ppt=True,
                                                         ppm=True))):
        with pytest.raises(L.errors.InvalidImageError) as want:
            JE.encode_j2k(img, **kw)
        with pytest.raises(T.InvalidImageError) as got:
            TE.encode_j2k(img, **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(T.InvalidImageError):
        TE.encode_j2k(torch.zeros((4, 4), dtype=torch.int16))


def test_forward_tile_planes_inverts_exactly():
    """forward_tile_planes on a stack, then the port's decoder-side
    inverse level by level, gives the planes back (5/3), and each member
    equals the JAX package's pyramid."""
    from lilliput_tpu_torch.ops import wavelet as TW
    rng = np.random.default_rng(8)
    rect, levels = (3, 5, 61, 60), 3
    x = rng.integers(-1000, 1000, (2, 55, 58))
    bands = TE.forward_tile_planes(torch.from_numpy(x), rect, levels, True)
    for m in range(2):
        want = JE.forward_tile_planes(x[m], rect, levels, True)
        for r in range(levels + 1):
            for o, a in want[r].items():
                np.testing.assert_array_equal(bands[r][o][m].numpy(), a)
    geo = TD.band_geometry(*rect, levels)
    ll = bands[0][0]
    for r in range(1, levels + 1):
        ll = TW.inverse_dwt_level(ll, bands[r][1], bands[r][2], bands[r][3],
                                  geo[r - 1][0], geo[r][0], True)
    np.testing.assert_array_equal(ll.numpy(), x)
