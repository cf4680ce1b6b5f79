"""The port's JPEG 2000 decoder on the CPU against the JAX package's, at
atol 0:

* ops/wavelet: every function equal to the JAX numpy one, for odd and
  even origins, single samples and batched stacks; the constants copied;
* the host code: jp2_t1.cpp byte-identical to the JAX package's, the C++
  Tier-1 equal to the port's Python reference (decode and every encode
  style), a host library that does not load raises;
* Jp2Decoder's pixels and Jp2Image's planes equal the JAX decoder's on
  the streams tests/test_jp2.py and tests/test_jp2_enc.py build: the JAX
  encoder's (lossless at odd sizes, 9/7, gray, RGBA, tiles, every
  codeblock style, PPT/PPM, SOP/EPH, ROI, subsampled components, sYCC)
  and OpenJPEG's through PIL (progression orders, precincts, layers,
  rates, gray+alpha), pixels made with numpy from a seed; the same error
  class on malformed and unsupported streams;
* the whole slice: ImageOps.transform from JP2 to .jpeg, .png and .jp2,
  StillTranscodePipeline and MultiGeometryPipeline over JP2 sources, and
  the CLI, with the JAX package's bytes.
"""

import inspect
import io
import os
import struct

import numpy as np
import pytest
import torch

import lilliput_tpu as L
from lilliput_tpu import pipeline as JP
from lilliput_tpu.codecs import jp2 as JD
from lilliput_tpu.codecs import jp2_enc as JE
from lilliput_tpu.codecs import jp2_t1 as JT1
from lilliput_tpu.ops import wavelet as JW
from lilliput_tpu.utils.metrics import metrics as jax_metrics
import lilliput_tpu_torch as T
from lilliput_tpu_torch import binding
from lilliput_tpu_torch.codecs import jp2 as TD
from lilliput_tpu_torch.codecs import jp2_t1 as TT1
from lilliput_tpu_torch.errors import LilliputError
from lilliput_tpu_torch.framebuffer import Framebuffer
from lilliput_tpu_torch.ops import decode_kernels as DK
from lilliput_tpu_torch.ops import wavelet as TW
from lilliput_tpu_torch.utils import metrics

from test_torch_cli import _jax_cli, _port_cli, _untimed

FIT = T.ResizeMethod.FIT


def _img(h, w, c, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (h, w, c) if c else (h, w), np.uint8)


def _smooth(h, w, c, seed):
    """A smooth picture (compressible like a photo): bilinear blow-up of
    random 4x5 pixels, in numpy."""
    small = np.random.default_rng(seed).integers(0, 256, (4, 5, c))
    ys = np.linspace(0, 3, h)[:, None]
    xs = np.linspace(0, 4, w)[None, :]
    y0, x0 = np.minimum(ys.astype(int), 2), np.minimum(xs.astype(int), 3)
    fy, fx = (ys - y0)[..., None], (xs - x0)[..., None]
    s = small.astype(np.float64)
    top = s[y0, x0] * (1 - fx) + s[y0, x0 + 1] * fx
    bot = s[y0 + 1, x0] * (1 - fx) + s[y0 + 1, x0 + 1] * fx
    return np.round(top * (1 - fy) + bot * fy).astype(np.uint8)


def _jax(b):
    fb = L.Framebuffer()
    L.new_decoder(b).decode_to(fb)
    return np.asarray(fb.array)


def _port(b):
    fb = Framebuffer()
    T.new_decoder(b, device="cpu").decode_to(fb)
    return fb.array.numpy()


def _outcome(decode, b):
    """Pixels, or the name of the typed error the decode raised."""
    try:
        return decode(b)
    except (LilliputError, L.errors.LilliputError, EOFError) as e:
        return type(e).__name__


def _assert_same(b):
    want, got = _jax(b), _port(b)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


# -- ops/wavelet --------------------------------------------------------------

RECTS = [(x0, y0, x0 + w, y0 + h) for x0, y0 in ((0, 0), (1, 0), (0, 1),
                                                 (3, 5))
         for w, h in ((1, 1), (1, 6), (7, 1), (2, 2), (8, 5), (13, 16))]


@pytest.mark.parametrize("reversible", [True, False], ids=["53", "97"])
@pytest.mark.parametrize("origin", [(0, 0), (1, 0), (0, 1), (3, 5)],
                         ids=str)
def test_wavelet_levels_equal_jax(reversible, origin):
    """forward_dwt_level and inverse_dwt_level on a stack of 3 equal the
    numpy functions on each member, bit for bit."""
    rng = np.random.default_rng(sum(origin) + reversible)
    for rect in (r for r in RECTS if r[:2] == origin):
        w, h = rect[2] - rect[0], rect[3] - rect[1]
        xs = [rng.integers(-1000, 1000, (h, w)) if reversible
              else rng.normal(0, 300, (h, w)) for _ in range(3)]
        got = TW.forward_dwt_level(torch.from_numpy(np.stack(xs)), rect,
                                   reversible)
        for m, x in enumerate(xs):
            for a, b in zip(JW.forward_dwt_level(x, rect, reversible), got):
                assert b[m].shape == a.shape
                np.testing.assert_array_equal(b[m].numpy(), a)
        bands = [np.stack([rng.integers(-500, 500, a.shape[1:])
                           if reversible else rng.normal(0, 100, a.shape[1:])
                           for _ in range(3)]) for a in got]
        out = TW.inverse_dwt_level(*[torch.from_numpy(b) for b in bands],
                                   None, rect, reversible)
        for m in range(3):
            want = JW.inverse_dwt_level(*[b[m] for b in bands], None, rect,
                                        reversible)
            np.testing.assert_array_equal(out[m].numpy(), want)
        # the port's pair inverts exactly (5/3)
        if reversible:
            back = TW.inverse_dwt_level(*got, None, rect, True)
            np.testing.assert_array_equal(back.numpy(), np.stack(xs))


def test_colour_transforms_and_constants_equal_jax():
    rng = np.random.default_rng(3)
    ints = [rng.integers(-128, 128, (9, 11)) for _ in range(3)]
    floats = [rng.normal(0, 60, (9, 11)) for _ in range(3)]
    for name, args in (("forward_rct", ints), ("inverse_rct", ints),
                       ("forward_ict", ints), ("inverse_ict", floats)):
        want = getattr(JW, name)(*args)
        got = getattr(TW, name)(*[torch.from_numpy(a) for a in args])
        for a, b in zip(want, got):
            assert b.dtype == torch.from_numpy(np.asarray(a)).dtype
            np.testing.assert_array_equal(b.numpy(), a)
    for k in ("ALPHA", "BETA", "GAMMA", "DELTA", "KK"):
        assert getattr(TW, k) == getattr(JW, k)
    assert TT1.MQ_STATES == JT1.MQ_STATES
    assert (TT1.N_CTX, TT1.CTX_UNI, TT1.CTX_RL, TT1.CTX_MR, TT1.CTX_SC) == (
        JT1.N_CTX, JT1.CTX_UNI, JT1.CTX_RL, JT1.CTX_MR, JT1.CTX_SC)
    # the sYCC fixed-point coefficients and descale of both conversions
    for src in (inspect.getsource(JD.Jp2Decoder.decode_to),
                inspect.getsource(TD.Jp2Decoder._pixels)):
        for k in ("33292 * cb", "-6472 * cb - 9519 * cr", "18678 * cr",
                  "(x + (1 << 13)) >> 14"):
            assert k in src


def test_division_by_a_constant_is_numpys():
    x = np.random.default_rng(4).normal(0, 1e3, 4096)
    for d in (1.772, 1.402, 0.1234567, 3.0):
        np.testing.assert_array_equal(
            TW._div(torch.from_numpy(x), d).numpy(), x / d)


# -- host code ----------------------------------------------------------------

def test_jp2_t1_source_is_the_jax_packages():
    """The port builds its Tier-1 coder from its own copy of jp2_t1.cpp;
    the copy must stay byte-identical to the JAX package's."""
    ours = os.path.join("lilliput_tpu_torch", "csrc", "host", "jp2_t1.cpp")
    theirs = os.path.join("lilliput_tpu", "native", "src", "jp2_t1.cpp")
    assert any(p.endswith(ours) for p in binding.HOST_SOURCES)
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("style", [0x00, 0x01, 0x02, 0x04, 0x08, 0x20,
                                   0x05, 0x2F], ids=lambda s: f"0x{s:02x}")
def test_t1_cpp_equals_python_reference(style):
    """The C++ Tier-1 coder (encode, and segment-aware decode) equals the
    port's pure-Python reference, and the JAX package's C++ coder."""
    rng = np.random.default_rng(style + 100)
    for (h, w, band, amp) in [(16, 16, 0, 2000), (33, 29, 1, 30000),
                              (7, 5, 2, 3), (4, 64, 2, 255)]:
        coefs = rng.integers(-amp, amp + 1, (h, w)).astype(np.int32)
        mb = max(int(np.abs(coefs).max()).bit_length(), 1) + 2
        enc = TT1.encode_codeblock(coefs, band, mb, style)
        assert enc == TT1.encode_codeblock_py(coefs, band, mb, style)
        assert enc == JT1.encode_codeblock(coefs, band, mb, style)
        segs, np_, zp = enc
        data = b"".join(s for s, _ in segs)
        meta = [(len(s), p) for s, p in segs]
        fast = TT1.decode_codeblock(data, w, h, band, zp, np_, mb, style,
                                    meta)
        slow = TT1._decode_codeblock_py(data, w, h, band, zp, np_, mb,
                                        style, meta)
        np.testing.assert_array_equal(fast, slow)
        np.testing.assert_array_equal(
            np.sign(fast) * (np.abs(fast) >> 1), coefs)
        # truncated: the first passes only (opj's midpoint rule)
        part = TT1.decode_codeblock(data, w, h, band, zp, min(np_, 4), mb,
                                    style, meta)
        np.testing.assert_array_equal(part, TT1._decode_codeblock_py(
            data, w, h, band, zp, min(np_, 4), mb, style, meta))


def test_t1_without_the_host_library_raises(monkeypatch):
    """No quiet Python fallback: a host library that does not load
    raises from both entry points."""
    def broken():
        raise OSError("no host library")
    monkeypatch.setattr(binding, "load", broken)
    coefs = np.ones((4, 4), np.int32)
    with pytest.raises(OSError):
        TT1.encode_codeblock(coefs, 0, 4)
    with pytest.raises(OSError):
        TT1.decode_codeblock(b"\x00", 4, 4, 0, 0, 1, 4)
    with pytest.raises(OSError):
        _port(JE.encode_jp2(_img(8, 8, 3, 0)))


def test_t1_profile_errors_equal_jax():
    for args in ((b"\x00", 5000, 4, 0, 0, 1, 4),      # side > 4096
                 (b"\x00" * 8, 4, 4, 0, 0, 3, 40)):     # 40 bitplanes
        with pytest.raises(T.DecodingFailedError, match="profile"):
            TT1.decode_codeblock(*args)
        with pytest.raises(L.errors.DecodingFailedError, match="profile"):
            JT1.decode_codeblock(*args)


# -- the decoder on the JAX encoder's streams ---------------------------------

ENC_CASES = {
    # lossless at odd sizes (tests/test_jp2_enc.py's geometries)
    **{f"lossless_{w}x{h}": ((h, w, 3), {}) for w, h in
       ((64, 64), (63, 61), (17, 13), (1, 1), (5, 129), (200, 3))},
    "gray": ((50, 70, 0), {}),
    "rgba": ((40, 44, 4), {}),
    "tiled": ((100, 90, 3), dict(tile=(32, 32))),
    "tiled_97": ((100, 90, 3), dict(tile=(32, 32), reversible=False)),
    "tiled_odd_97": ((70, 66, 3), dict(tile=(23, 17), reversible=False,
                                       levels=2)),
    "nomct": ((32, 32, 3), dict(mct=False)),
    "levels2": ((33, 47, 3), dict(levels=2)),
    "levels0": ((20, 24, 3), dict(levels=0)),
    "97": ((80, 96, 3), dict(reversible=False)),
    "97_nomct": ((80, 96, 3), dict(reversible=False, mct=False)),
    "97_gray": ((41, 37, 0), dict(reversible=False)),
    "97_rate": ((64, 72, 3), dict(reversible=False, rate=12.0)),
    "97_qscale": ((64, 72, 3), dict(reversible=False, qscale=6.0)),
    "cblk_4x5": ((48, 40, 3), dict(cblk=(4, 5))),
    **{f"style_{s:02x}": ((44, 38, 3), dict(style=s))
       for s in (0x01, 0x02, 0x04, 0x08, 0x20, 0x05, 0x29, 0x2F)},
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
    "roi_tiles": ((70, 66, 3), dict(roi=(10, 10, 50, 40), tile=(32, 32))),
    "sub_420": ((70, 66, 3), dict(sub=[(1, 1), (2, 2), (2, 2)])),
    "sub_mixed": ((70, 66, 3), dict(sub=[(1, 1), (2, 1), (1, 2)])),
    "sub_tiles": ((70, 66, 3), dict(sub=[(1, 1), (2, 2), (2, 2)],
                                    tile=(24, 24))),
    "eps_bump": ((30, 34, 3), dict(qcd_eps_bump=1)),
}


def _enc_stream(name):
    shape, kw = ENC_CASES[name]
    h, w, c = shape
    seed = sum(map(ord, name))
    if kw.get("reversible", True):
        img = _img(h, w, c, seed)
    else:   # lossy: a smooth picture, as a photo compresses
        img = _smooth(h, w, max(c, 1), seed)
        img = img[..., 0] if c == 0 else img
    return JE.encode_jp2(img, **kw), img


@pytest.mark.parametrize("name", list(ENC_CASES))
def test_decode_equals_jax_on_encoder_streams(name):
    b, img = _enc_stream(name)
    got = _assert_same(b)
    planes = TD.Jp2Image(b, device="cpu").decode()
    for p, q in zip(planes, JD.Jp2Image(b).decode()):
        assert p.dtype == torch.int64
        np.testing.assert_array_equal(p.numpy(), q)
    if ENC_CASES[name][1].get("reversible", True) and "sub" not in name:
        want = img[..., None] if img.ndim == 2 else (
            img[..., [2, 1, 0, 3]] if img.shape[2] == 4 else img[..., ::-1])
        np.testing.assert_array_equal(got, want)      # lossless


@pytest.mark.parametrize("levels", [2, 4, 5])
def test_jax_fault_on_unaligned_tiles_is_reproduced(levels):
    """ROADMAP queue 3 entry 17: with 23x17 tiles (origins off the
    2^levels grid) the JAX decoder reads its own encoder's lossless
    stream to other pixels (2 and 5 levels) or fails with "packet body
    truncated" (4 levels), where OpenJPEG gives the image back. The port
    copies its Tier-2 and geometry, so it gives the same outcome."""
    img = _img(70, 66, 3, sum(map(ord, "tiled_odd")))
    b = JE.encode_jp2(img, tile=(23, 17), levels=levels)
    want, got = _outcome(_jax, b), _outcome(_port, b)
    if levels == 4:
        assert want == got == "DecodingFailedError"
    else:
        np.testing.assert_array_equal(got, want)
        assert not np.array_equal(got, img[..., ::-1])
    # and a 9/7 stream of a smooth picture at 5 levels
    img = _smooth(70, 66, 3, sum(map(ord, "tiled_odd_97")))
    b = JE.encode_jp2(img, tile=(23, 17), reversible=False, levels=levels)
    want, got = _outcome(_jax, b), _outcome(_port, b)
    if isinstance(want, str):
        assert got == want
    else:
        np.testing.assert_array_equal(got, want)


def test_j2k_codestream_and_header():
    img = _img(30, 41, 3, 5)
    b = JE.encode_j2k(img)
    assert b[:4] == b"\xff\x4f\xff\x51"
    np.testing.assert_array_equal(_assert_same(b), img[..., ::-1])
    d = T.new_decoder(JE.encode_jp2(_img(33, 47, 3, 9)), device="cpu")
    jd = L.new_decoder(JE.encode_jp2(_img(33, 47, 3, 9)))
    assert isinstance(d, TD.Jp2Decoder)
    fields = ("width", "height", "channels", "orientation", "num_frames",
              "content_length")
    assert [getattr(d.header(), k) for k in fields] == [
        getattr(jd.header(), k) for k in fields]
    assert (d.description(), d.duration(), d.icc(), d.loop_count()) == (
        "JP2", 0.0, b"", 0)
    fb = Framebuffer()
    d.decode_to(fb)
    assert fb.array.shape == (33, 47, 3) and fb.array.device.type == "cpu"
    with pytest.raises(EOFError):
        d.decode_to(fb)


@pytest.mark.parametrize("geom", [(16, 16), (21, 33)], ids=str)
def test_sycc_equals_jax(geom):
    """colr enumcs 18 (sYCC), as tests/test_jp2.py patches it."""
    h, w = geom
    buf = bytearray(JE.encode_jp2(_img(h, w, 3, h * w), mct=False))
    i = bytes(buf).find(b"colr")
    buf[i + 7:i + 11] = struct.pack(">I", 18)
    _assert_same(bytes(buf))


def test_tiles_of_one_geometry_are_one_stack():
    """90x100 in 32x32 tiles, 2 levels (tile origins keep every
    resolution's parity): the six full tiles' 18 tile-components go
    through the wavelet as one stack, the right column's 9, the bottom
    row's 6 and the corner's 3 as three more; the pixels equal the JAX
    package's."""
    b = JE.encode_jp2(_img(100, 90, 3, 11), tile=(32, 32), levels=2)
    img = TD.Jp2Image(b, device="cpu")
    seen = []
    orig = TD.Jp2Image._synthesize

    def spy(self, tiles, groups, vals, n_rev):
        seen.extend((len(g.members), g.rects[-1]) for g in groups)
        return orig(self, tiles, groups, vals, n_rev)
    TD.Jp2Image._synthesize = spy
    try:
        img.decode()
    finally:
        TD.Jp2Image._synthesize = orig
    # 3x4 tiles: 2x3 full ones, a column of 2, a row of 3, the corner
    assert sorted(n for n, _ in seen) == [3, 6, 9, 18]
    _assert_same(b)


def test_stage_times_recorded():
    times = {}
    d = TD.Jp2Decoder(JE.encode_jp2(_img(20, 24, 3, 1)), device="cpu",
                      stage_times=times)
    d.decode_to(Framebuffer())
    assert sorted(times) == ["device_convert", "device_synthesis",
                             "host_tier2_tier1"]
    assert all(len(v) == 1 and v[0] >= 0 for v in times.values())


# -- the decoder on OpenJPEG's streams (PIL) ----------------------------------

def _pil_enc(img, **kw):
    Image = pytest.importorskip("PIL.Image")
    from PIL import features
    if not features.check("jpg_2000"):
        pytest.skip("PIL lacks JPEG 2000")
    bio = io.BytesIO()
    mode = "LA" if img.ndim == 3 and img.shape[2] == 2 else None
    Image.fromarray(img, mode=mode).save(bio, format="JPEG2000", **kw)
    return bio.getvalue()


_RAMP = (np.mgrid[0:80, 0:96][0] * 3 % 256).astype(np.uint8)
PIL_CASES = {
    **{f"prog_{p}": (lambda: _img(70, 66, 3, 4), dict(progression=p))
       for p in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")},
    "precincts": (lambda: _img(70, 66, 3, 6), dict(precinct_size=(64, 64))),
    "tile_size": (lambda: _img(100, 90, 3, 3), dict(tile_size=(32, 32))),
    "mct": (lambda: _img(40, 40, 3, 3), dict(mct=1)),
    "raw_j2k": (lambda: _img(40, 40, 3, 3), dict(no_jp2=True)),
    "gray": (lambda: _img(50, 70, 0, 3), {}),
    "rgba": (lambda: _img(40, 44, 4, 3), {}),
    "gray_alpha": (lambda: _img(20, 24, 2, 13), {}),
    "97_rate10": (lambda: np.stack([_RAMP, _RAMP, 255 - _RAMP], -1),
                  dict(irreversible=True, quality_mode="rates",
                       quality_layers=[10])),
    "97_mct_rate10": (lambda: np.stack([_RAMP, _RAMP, 255 - _RAMP], -1),
                      dict(irreversible=True, mct=1, quality_mode="rates",
                           quality_layers=[10])),
    "layers": (lambda: np.stack([_RAMP, _RAMP, 255 - _RAMP], -1),
               dict(quality_mode="rates", quality_layers=[40, 10, 1])),
    **{f"97_layers_{'_'.join(map(str, r))}_mct{m}": (
        lambda: _smooth(48, 56, 3, 21),
        dict(irreversible=True, quality_mode="rates", quality_layers=r,
             mct=m))
       for r, m in (([5], 0), ([80], 1), ([60, 25, 8], 1),
                    ([100, 50, 20, 5], 0))},
    "97_db": (lambda: _smooth(48, 56, 3, 22),
              dict(irreversible=True, quality_mode="dB",
                   quality_layers=[28, 35, 42])),
}


@pytest.mark.parametrize("name", list(PIL_CASES))
def test_decode_equals_jax_on_openjpeg_streams(name):
    make, kw = PIL_CASES[name]
    _assert_same(_pil_enc(make(), **kw))


# -- errors -------------------------------------------------------------------

def _patch(b, marker, offset, new):
    i = b.find(marker)
    m = bytearray(b)
    m[i + offset] = new
    return bytes(m)


def test_malformed_and_unsupported_streams_fail_as_jax():
    b = JE.encode_jp2(_img(32, 32, 3, 14))
    sig = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
    cases = [sig + b"\x00" * 64, b"\xff\x4f\xff\x51" + b"\x00" * 64,
             b[:len(b) // 2], b[:len(b) - 40],
             _patch(b, b"\xff\x52", 4, 0x06),          # SOP/EPH flags
             _patch(b, b"\xff\x52", 4, 0x08),          # undefined Scod
             _patch(b, b"\xff\x52", 10, 0x0F),         # xcb+ycb > 12
             _patch(_patch(b, b"\xff\x5c", 4, 0xE0), b"\xff\x5c", 5,
                    0xF8)]                             # Mb > 30
    tiled = JE.encode_jp2(_img(70, 66, 3, 15), tile=(32, 32))
    cut = tiled.rfind(b"\xff\x90")
    cases += [tiled[:cut + 40], tiled[:cut]]          # last tile cut, gone
    for case in cases:
        want, got = _outcome(_jax, case), _outcome(_port, case)
        if isinstance(want, str):
            assert got == want
        else:
            np.testing.assert_array_equal(got, want)


def test_fuzzed_streams_fail_or_decode_as_jax():
    """Truncations and byte flips of a plain and a styled stream: each
    either decodes to the JAX package's pixels or raises the same typed
    error class."""
    rng = np.random.default_rng(12)
    cases = []
    for b in (JE.encode_jp2(_img(24, 24, 3, 11)),
              JE.encode_jp2(_img(24, 24, 3, 42), style=0x05, ppt=True,
                            sop=True, eph=True)):
        cases += [b[:n] for n in range(0, len(b), 173)]
        for _ in range(20):
            m = bytearray(b)
            for _ in range(rng.integers(1, 5)):
                m[rng.integers(0, len(m))] = rng.integers(0, 256)
            cases.append(bytes(m))
    for case in cases:
        want, got = _outcome(_jax, case), _outcome(_port, case)
        if isinstance(want, str):
            assert got == want
        else:
            np.testing.assert_array_equal(got, want)


# -- the whole slice ----------------------------------------------------------

def _transform(new_decoder, ops, opts_cls, b, device=None, **opt):
    d = new_decoder(b) if device is None else new_decoder(b, device=device)
    return ops(8192).transform(d, opts_cls(**opt))


@pytest.mark.parametrize("fmt", [".jpeg", ".png", ".jp2"])
@pytest.mark.parametrize("src", ["lossless", "97", "gray", "rgba"])
def test_transform_bytes_equal_jax(src, fmt):
    b = {"lossless": lambda: JE.encode_jp2(_img(60, 80, 3, 8)),
         "97": lambda: JE.encode_jp2(_smooth(60, 80, 3, 8),
                                     reversible=False),
         "gray": lambda: JE.encode_j2k(_img(45, 52, 0, 8)),
         "rgba": lambda: JE.encode_jp2(_img(40, 44, 4, 8))}[src]()
    # JPEG2000_RATE is read by the .jp2 encoder alone
    for opts in ({}, {T.JPEG2000_RATE: 8000})[:2 if fmt == ".jp2" else 1]:
        a = _transform(L.new_decoder, L.ImageOps, L.ImageOptions, b,
                       file_type=fmt, width=40, height=30,
                       resize_method=FIT, encode_options=opts)
        c = _transform(T.new_decoder, T.ImageOps, T.ImageOptions, b, "cpu",
                       file_type=fmt, width=40, height=30,
                       resize_method=FIT, encode_options=opts)
        assert a == c


def _pipe_sources(n=3, w=64, h=48):
    return [JE.encode_jp2(_smooth(h, w, 3, 30 + s)) for s in range(n)]


@pytest.mark.parametrize("fmt", [".jpeg", ".png"])
def test_still_pipeline_bytes_equal_jax(fmt):
    bufs = _pipe_sources()
    jp = JP.StillTranscodePipeline(bufs[0], 32, 24, quality=85,
                                   output_format=fmt)
    tp = T.StillTranscodePipeline(bufs[0], 32, 24, quality=85,
                                  output_format=fmt, device="cpu")
    assert (tp.kind, tp.src_w, tp.src_h, tp.channels) == (
        jp.kind, jp.src_w, jp.src_h, jp.channels) == ("Jp2Decoder", 64,
                                                      48, 3)
    DK.reset_launches()
    got = tp.transcode(bufs + [bufs[0][:200]], return_exceptions=True)
    assert not any(DK.launches.values())
    want = jp.transcode(bufs + [bufs[0][:200]], return_exceptions=True)
    assert got[:3] == want[:3]
    assert type(got[3]).__name__ == type(want[3]).__name__


def test_multigeometry_routes_jp2_as_jax():
    """JP2 sources of two signatures among PNG and JPEG-free traffic and a
    truncated stream: the JAX package's bytes in input order, the failure
    in its slot, the same stats."""
    from _torch_still_builders import png_bytes
    j1 = _pipe_sources(2)
    j2 = [JE.encode_jp2(_img(40, 50, 0, 61)), JE.encode_j2k(_img(40, 50, 0,
                                                                  62))]
    png = png_bytes(_smooth(48, 64, 3, 63), 2)
    bufs = [j1[0], png, j2[0], j1[1], j1[0][:300], j2[1]]
    metrics.reset()
    jax_metrics.reset()
    want = JP.MultiGeometryPipeline(32, 32, quality=85).transcode(
        bufs, return_exceptions=True)
    tm = T.MultiGeometryPipeline(32, 32, quality=85, device="cpu")
    got = tm.transcode(bufs, return_exceptions=True)
    for g, w in zip(got, want):
        if isinstance(w, Exception):
            assert type(g).__name__ == type(w).__name__
        else:
            assert g == w
    assert [isinstance(g, Exception) for g in got] == [0, 0, 0, 0, 1, 0]
    assert tm.stats()["geometries_cached"] == 3


def test_cli_jp2_equal_examples_main(tmp_path, capsys):
    src = tmp_path / "in.jp2"
    src.write_bytes(JE.encode_jp2(_img(48, 64, 3, 70)))
    for ext in (".png", ".jp2"):
        outs = {}
        for who, run in (("jax", _jax_cli), ("port", _port_cli)):
            out = tmp_path / f"out_{who}{ext}"
            argv = ["-input", str(src), "-output", str(out), "-width", "40",
                    "-height", "32"] + (["-device", "cpu"]
                                        if who == "port" else [])
            code, lines = run(argv, capsys)
            assert code == 0
            outs[who] = (out.read_bytes(), _untimed(
                [ln.replace(str(out), "OUT") for ln in lines]))
        assert outs["port"] == outs["jax"]
        assert outs["port"][1][0] == "file type: JP2"
