"""The port's AVIF codec (codecs/avif.py, av1_raw.py and avif_enc.py on its
copy of avformat_shim.cpp) on the CPU against the JAX package:

* SDR frames at atol 0 on every branch of tests/test_avif.py's _HBD_CASES
  and _EXOTIC_CASES (stills the JAX encoder writes losslessly at 8/10/12
  bits), and on the committed fixtures (tests/assets/still_alpha_64x48.avif:
  RGBA with an ICC profile; anim_4f_48x40.avif: 4 RGBA frames of 40, 80,
  120 and 160 ms, loop count 3); header, ICC, durations, loop count,
  offsets, skip_frame sequences and clean-aperture offsets equal;
* HDR stills (colr/nclx PQ and HLG) take the HDR route in both packages;
  their frames, tone-mapped with the transfer and primaries the box names
  where the sequence header leaves them unspecified, are within one u8 of
  the JAX package's chain given those values on at most 1e-3 of the
  values (test_torch_color.STEP_MAX_*), the alpha rescale at atol 0, and
  tone_mapping_enabled=False gives the SDR route's frames at atol 0.
  The device half (hdr_planes_to_bgr) is held to the JAX decoder's on
  planes made here too: PQ and HLG, BT.2020, P3 and BT.709, identity and
  monochrome, the colr box's transfer where the sequence header has none;
* the ISOBMFF parsers give equal results or equal errors on truncated and
  mutated boxes;
* AvifEncoder's bytes equal the JAX package's: a still, alpha, gray,
  lossless (q100), an ICC profile, animations with and without alpha;
* the PIL route (LILLIPUT_AVIF=pil, limited-range YCgCo, which the native
  route declines) gives the JAX package's frames or error class;
* with ffmpeg's header missing (binding.AVFORMAT_HEADER monkeypatched
  away) the decode and encode raise HostLibraryMissingError naming
  ffmpeg, and nothing turns to PIL;
* a failing device half raises from decode_to: no PIL frame comes back.

The tests that run dav1d or libaom skip where ffmpeg's headers are
absent; the parsers and the missing-library test run everywhere."""

import dataclasses
import os
import struct

import numpy as np
import pytest
import torch

from lilliput_tpu.codecs import av1_raw as JAR
from lilliput_tpu.codecs import avif as JA
from lilliput_tpu.framebuffer import Framebuffer as JFramebuffer
from lilliput_tpu_torch import binding, new_decoder, new_encoder
from lilliput_tpu_torch.codecs import av1_raw as TAR
from lilliput_tpu_torch.codecs import avif as TA
from lilliput_tpu_torch.codecs.icc import REC709_PROFILE
from lilliput_tpu_torch.errors import HostLibraryMissingError
from lilliput_tpu_torch.framebuffer import (AVIF_QUALITY, AVIF_SPEED,
                                            Framebuffer)

from test_torch_color import STEP_MAX_DIFF, STEP_MAX_SHARE, hdr_planes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(ROOT, "tests", "assets")
HAVE_FFMPEG = os.path.exists(binding.AVFORMAT_HEADER)
needs_ffmpeg = pytest.mark.skipif(not HAVE_FFMPEG,
                                  reason="ffmpeg's headers are absent")
FIXTURES = ("still_alpha_64x48.avif", "anim_4f_48x40.avif")


def fixture(name: str) -> bytes:
    with open(os.path.join(ASSETS, name), "rb") as f:
        return f.read()


def _jax_avif_tests():
    """tests/test_avif.py's fixture makers (imported on use: that module
    skips itself where PIL lacks AVIF)."""
    import test_avif
    return test_avif


def decode_all(pkg: str, buf: bytes, **kw):
    """(header fields, frames, frame metadata, icc, duration, loops) of
    every frame, through the JAX package ("jax") or the port on the CPU."""
    if pkg == "jax":
        d, fb_cls = JA.AvifDecoder(buf, **kw), JFramebuffer
    else:
        d, fb_cls = TA.AvifDecoder(buf, device="cpu", **kw), Framebuffer
    h = d.header()
    frames, metas = [], []
    for _ in range(h.num_frames):
        fb = fb_cls()
        d.decode_to(fb)
        frames.append(np.asarray(fb.to_numpy()).copy())
        metas.append((fb.duration, fb.x_offset, fb.y_offset,
                      int(fb.blend), int(fb.dispose)))
    out = ((h.width, h.height, h.channels, int(h.orientation),
            h.num_frames, h.content_length), frames, metas, d.icc(),
           d.duration(), d.loop_count())
    d.close()
    return out


def assert_decodes_equal(buf: bytes, **kw):
    j = decode_all("jax", buf, **kw)
    t = decode_all("port", buf, **kw)
    assert t[0] == j[0]
    assert len(t[1]) == len(j[1])
    for a, b in zip(t[1], j[1]):
        np.testing.assert_array_equal(a, b)
    assert t[2:] == j[2:]
    return t


# -- SDR decode ---------------------------------------------------------------


def _sdr_cases():
    t = _jax_avif_tests()
    return ([c + (1,) for c in t._HBD_CASES]
            + [(d, s, f, m, a, p) for d, s, f, m, p, a in t._EXOTIC_CASES])


SDR_CASES = [
    (10, "420", True, 1, True, 1), (10, "420", False, 9, True, 1),
    (10, "422", True, 5, True, 1), (10, "444", False, 1, True, 1),
    (12, "420", True, 1, True, 1), (12, "420", False, 9, True, 1),
    (12, "422", True, 1, True, 1), (12, "444", False, 9, True, 1),
    (10, "420", False, 9, False, 1), (12, "444", False, 9, False, 1),
    (12, "420", True, 2, False, 1), (10, "mono", True, 1, False, 1),
    (12, "mono", False, 1, False, 1), (10, "mono", False, 1, True, 1),
    (10, "identity", True, 0, True, 1), (12, "identity", True, 0, False, 1),
    (8, "420", False, 9, True, 1), (8, "mono", False, 1, False, 1),
    (8, "420", True, 8, True, 1), (10, "444", True, 8, False, 1),
    (12, "420", True, 8, True, 1), (8, "444", True, 12, False, 12),
    (12, "422", True, 12, True, 12), (8, "444", True, 12, False, 10),
    (10, "420", True, 12, True, 1), (8, "444", False, 12, False, 5),
    (10, "mono", False, 12, True, 12),
]


@needs_ffmpeg
def test_sdr_cases_cover_the_jax_tests():
    assert sorted(SDR_CASES) == sorted(_sdr_cases())


@needs_ffmpeg
@pytest.mark.parametrize(
    "depth,sub,full,matrix,alpha,prim", SDR_CASES,
    ids=[f"d{d}-{s}-{'full' if f else 'lim'}-m{m}-{'A' if a else 'noA'}-p{p}"
         for d, s, f, m, a, p in SDR_CASES])
def test_sdr_frames_equal_jax(depth, sub, full, matrix, alpha, prim):
    buf = _jax_avif_tests()._hbd_fixture(depth, sub, full, matrix, alpha,
                                         primaries=prim)
    t = assert_decodes_equal(buf)
    assert t[1][0].shape == (33, 47, 4 if alpha else 3)


@needs_ffmpeg
@pytest.mark.parametrize("name", FIXTURES)
def test_fixtures_equal_jax(name):
    """Header, frames, per-frame metadata, ICC, duration and loop count."""
    t = assert_decodes_equal(fixture(name))
    if name.startswith("still"):
        assert t[0][:5] == (64, 48, 4, 1, 1)
        assert t[3] == binding_icc("srgb")
    else:
        assert t[0][:5] == (48, 40, 4, 1, 4)
        assert [m[0] for m in t[2]] == [0.04, 0.08, 0.12, 0.16]
        assert t[4:] == (0.4, 3)


def binding_icc(name: str) -> bytes:
    with open(os.path.join(ROOT, "lilliput_tpu_torch", "icc_profiles",
                           f"{name}_profile.icc"), "rb") as f:
        return f.read()


@needs_ffmpeg
@pytest.mark.parametrize("ops", ["sd", "dsd", "ssd", "dssd", "sdsd"])
def test_skip_frame_equals_jax(ops):
    """skip_frame consumes a stream frame exactly when decode_to would,
    before the first decode too (tests/test_avif.py:521-548)."""
    buf = fixture("anim_4f_48x40.avif")
    got = []
    for pkg in ("jax", "port"):
        d = (JA.AvifDecoder(buf) if pkg == "jax"
             else TA.AvifDecoder(buf, device="cpu"))
        frames = []
        for op in ops:
            if op == "s":
                d.skip_frame()
            else:
                fb = JFramebuffer() if pkg == "jax" else Framebuffer()
                d.decode_to(fb)
                frames.append(np.asarray(fb.to_numpy()).copy())
        got.append(frames)
    for a, b in zip(*got):
        np.testing.assert_array_equal(a, b)


@needs_ffmpeg
def test_clap_offsets_equal_jax():
    t = _jax_avif_tests()
    base = t._hbd_fixture(8, "420", True, 1, False)
    buf = t._inject_clap(base, (20, 1, 10, 1, 7, 2, -5, 1))
    out = assert_decodes_equal(buf)
    assert out[2][0][1:3] == (3, -5)


# -- HDR ----------------------------------------------------------------------


def hdr_still(cicp, depth=10, sub="420", full=False, matrix=9, alpha=True,
              h=33, w=47):
    """A still the JAX encoder writes, re-muxed with colr/nclx `cicp`
    (tests/test_avif.py:596-617's planes). The encoder's sequence header
    names primaries and transfer "unspecified" (2)."""
    from lilliput_tpu.codecs import avif_enc as JE
    still = _jax_avif_tests()._hbd_fixture(depth, sub, full, matrix, alpha,
                                           h=h, w=w, seed=5)
    si = JAR.parse_still_items(still)
    fmt = {"420": 0, "444": 1, "422": 4}[sub]
    return JE.mux_still(w, h, fmt, si.color_data, si.color_av1c,
                        si.alpha_data, si.alpha_av1c, depth=depth,
                        cicp=cicp)


def assert_within_tier(got: np.ndarray, want: np.ndarray):
    assert got.shape == want.shape
    d = np.abs(got[..., :3].astype(int) - want[..., :3].astype(int))
    assert d.max() <= STEP_MAX_DIFF, d.max()
    assert (d > 0).sum() <= STEP_MAX_SHARE * d.size, (d > 0).sum()
    # alpha: the rescale is exact
    np.testing.assert_array_equal(got[..., 3:], want[..., 3:])


HDR_CICP = {"pq": (9, 16, 9, 0), "hlg": (12, 18, 9, 1)}


def jax_hdr_from_box(buf: bytes) -> np.ndarray:
    """The JAX decoder's HDR frame of `buf` with the sequence header's
    unspecified (2) primaries and transfer read as absent, so that its
    colr box governs them: the port's rule (ROADMAP queue 3 entry 20)."""
    jd = JA.AvifDecoder(buf)
    host_half = jd._next_planes

    def planes():
        rp, ap = host_half()
        return dataclasses.replace(
            rp, primaries=0 if rp.primaries == 2 else rp.primaries,
            trc=0 if rp.trc == 2 else rp.trc), ap
    jd._next_planes = planes
    return np.asarray(jd._decode_raw_hdr())


@needs_ffmpeg
@pytest.mark.parametrize("name", list(HDR_CICP))
def test_hdr_stills_take_the_hdr_route(name):
    """Both packages take the device route. The sequence header names
    primaries and transfer "unspecified" (2), so the port tone-maps with
    the colr box's (PQ and BT.2020, HLG and P3): within the tier of the
    JAX chain given the box's values, and apart from the JAX decoder,
    which takes the header's 2 as HLG, BT.2020 (ROADMAP queue 3 entry
    20). The Rec709 profile replaces the ICC; tone_mapping_enabled=False
    gives the SDR route's frames at atol 0."""
    buf = hdr_still(HDR_CICP[name])
    jd, td = JA.AvifDecoder(buf), TA.AvifDecoder(buf, device="cpu")
    assert jd._use_raw and td._use_raw
    rp, _ = td._next_planes()
    assert (rp.trc, rp.primaries) == (2, 2)
    j = decode_all("jax", buf)
    t = decode_all("port", buf)
    assert t[0] == j[0] and t[2:] == j[2:] and t[3] == REC709_PROFILE
    assert_within_tier(t[1][0], jax_hdr_from_box(buf))
    d = np.abs(t[1][0][..., :3].astype(int) - j[1][0][..., :3].astype(int))
    assert d.max() > STEP_MAX_DIFF
    off = assert_decodes_equal(buf, tone_mapping_enabled=False)
    assert off[3] != REC709_PROFILE


def raw_planes(depth, layout, full, matrix, primaries, trc, seed,
               h=45, w=61, pad=1):
    """A RawPlanes as dav1d hands it over (padded to even sizes), with an
    alpha RawPlanes."""
    if layout == "mono":
        y = hdr_planes(h + pad, w + pad, depth, "444", seed)[0]
        u = v = None
    else:
        y, u, v = hdr_planes(h + pad, w + pad, depth, layout, seed)
    a = hdr_planes(h + pad, w + pad, depth, "444", seed + 1)[1]
    rp = TAR.RawPlanes(y=y, u=u, v=v, width=w + pad, height=h + pad,
                       depth=depth, full_range=full, matrix=matrix,
                       primaries=primaries, trc=trc)
    ap = TAR.RawPlanes(y=a, u=None, v=None, width=w + pad, height=h + pad,
                       depth=depth, full_range=True, matrix=2,
                       primaries=2, trc=2)
    return rp, ap


DEVICE_HALF = [  # depth, layout, full, matrix, primaries, trc, cicp
    (10, "420", False, 9, 9, 16, None),
    (12, "422", True, 9, 12, 18, None),
    (10, "444", False, 1, 1, 16, None),
    (12, "444", True, 0, 9, 18, None),        # identity: planes G, B, R
    (10, "mono", False, 9, 9, 16, None),
    (10, "420", False, 9, 0, 0, (12, 16, 9, 0)),  # the colr box's values
    (10, "420", True, 6, 0, 0, None),         # neither: PQ, BT.2020
]


@needs_ffmpeg
@pytest.mark.parametrize("depth,layout,full,matrix,prim,trc,cicp",
                         DEVICE_HALF,
                         ids=[f"d{c[0]}-{c[1]}-m{c[3]}-p{c[4]}-t{c[5]}"
                              + ("-cicp" if c[6] else "")
                              for c in DEVICE_HALF])
def test_hdr_device_half_equals_jax(depth, layout, full, matrix, prim, trc,
                                    cicp):
    """hdr_planes_to_bgr against the JAX decoder's _decode_raw_hdr fed the
    same planes (its host half replaced), alpha and all."""
    rp, ap = raw_planes(depth, layout, full, matrix, prim, trc, depth + trc)
    h, w = 45, 61
    jd = JA.AvifDecoder(fixture("still_alpha_64x48.avif"))
    jd._w, jd._h, jd._cicp = w, h, cicp
    jd._next_planes = lambda: (rp, ap)
    want = np.asarray(jd._decode_raw_hdr())
    got = TA.hdr_planes_to_bgr(rp, ap, h, w, cicp, "cpu")
    assert got.dtype == torch.uint8
    assert_within_tier(got.numpy(), want)
    without = TA.hdr_planes_to_bgr(rp, None, h, w, cicp, "cpu")
    np.testing.assert_array_equal(without.numpy(), got.numpy()[..., :3])


@needs_ffmpeg
def test_hdr_device_half_records_its_stages():
    rp, ap = raw_planes(10, "420", False, 9, 9, 16, 3)
    times = {}
    TA.hdr_planes_to_bgr(rp, ap, 45, 61, None, "cpu", stage_times=times)
    assert sorted(times) == ["device_convert", "h2d"]


@needs_ffmpeg
def test_a_failing_device_half_raises(monkeypatch):
    """No except on the HDR path returns another route's frame: a device
    step that fails raises out of decode_to (the JAX package would hand
    back PIL's 8-bit frame, avif.py:513-523)."""
    buf = hdr_still(HDR_CICP["pq"])

    def boom(*a, **k):
        raise RuntimeError("device step failed")

    monkeypatch.setattr(TA, "_pil_image", lambda: pytest.fail("PIL route"))
    for target, name in ((TA, "hdr_planes_to_bgr"),
                         (TA.COLOR, "hdr_to_sdr"),
                         (TA.COLOR, "yuv_to_rgb_norm")):
        with monkeypatch.context() as m:
            m.setattr(target, name, boom)
            d = TA.AvifDecoder(buf, device="cpu")
            with pytest.raises(RuntimeError, match="device step failed"):
                d.decode_to(Framebuffer())


# -- parsers --------------------------------------------------------------------


def _hostile(buf: bytes):
    """Truncations at every 29th byte and size-field mutations across the
    header region."""
    cases = [buf[:n] for n in range(0, len(buf), 29)]
    for off in range(0, min(len(buf), 640), 12):
        for val in (0xFFFFFFFF, 1, 0, 9):
            m = bytearray(buf)
            m[off:off + 4] = val.to_bytes(4, "big")
            cases.append(bytes(m))
    stts = buf.find(b"stts")
    if stts > 0:
        cases.append(buf[:stts + 8] + struct.pack(">I", 1 << 31)
                     + buf[stts + 12:])
        cases.append(buf[:stts + 8] + struct.pack(">III", 1, 0xFFFFFFFF, 1)
                     + buf[stts + 20:])
    return cases


def _outcome(fn, buf):
    try:
        return ("ok", fn(buf))
    except Exception as e:  # noqa: BLE001 -- the error class is compared
        return ("raised", type(e).__name__)


@pytest.mark.parametrize("name", FIXTURES)
def test_parsers_equal_jax_on_hostile_boxes(name):
    parsers = [(JA.parse_avis_timing, TA.parse_avis_timing),
               (JA.parse_cicp, TA.parse_cicp),
               (JAR.parse_loop_count, TAR.parse_loop_count),
               (lambda b: JA._set_avis_repetitions(b, 3),
                lambda b: TA._set_avis_repetitions(b, 3)),
               (JAR.parse_still_items, TAR.parse_still_items)]
    tracks = (lambda p: lambda b: (
        None if (r := p(b)) is None else
        [None if x is None else (x.samples, x.av1c, x.width, x.height,
                                 x.icc, x.is_alpha) for x in r]))
    parsers.append((tracks(JAR.parse_tracks), tracks(TAR.parse_tracks)))
    n = 0
    for buf in [fixture(name)] + _hostile(fixture(name)):
        for jf, tf in parsers:
            j, t = _outcome(jf, buf), _outcome(tf, buf)
            if j[0] == "ok" and hasattr(j[1], "__dataclass_fields__"):
                j = ("ok", vars(j[1]))
                t = ("ok", vars(t[1])) if t[0] == "ok" else t
            assert t == j
            n += 1
    assert n > 300


def test_hostile_stts_is_bounded():
    buf = fixture("anim_4f_48x40.avif")
    for evil in _hostile(buf)[-2:]:
        assert len(TA.parse_avis_timing(evil)[0]) <= 1 << 16
    assert TAR.parse_loop_count(TA._set_avis_repetitions(buf, 2)) == 2


def test_parse_cicp_ignores_mdat_bytes():
    """A hostile PQ colrnclx in a trailing free box does not make an SDR
    still HDR (tests/test_avif.py:294-309)."""
    buf = fixture("still_alpha_64x48.avif")
    hostile = b"colrnclx" + struct.pack(">HHH", 9, 16, 9) + b"\x80"
    evil = buf + struct.pack(">I", 8 + len(hostile)) + b"free" + hostile
    assert TA.parse_cicp(evil) == TA.parse_cicp(buf) == JA.parse_cicp(evil)
    assert not TA.AvifDecoder(evil, device="cpu")._is_hdr


# -- encoder ------------------------------------------------------------------


def _frame(px, duration=0.0, pkg="port"):
    fb = (Framebuffer(torch.from_numpy(px)) if pkg == "port"
          else JFramebuffer(px))
    fb.duration = duration
    return fb


def _smooth(h, w, c, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    px = np.stack([127 + 100 * np.sin(xx / (4 + k) + yy / (6 + k) + seed)
                   for k in range(c)], -1) + rng.normal(0, 5, (h, w, c))
    return np.clip(px, 0, 255).astype(np.uint8)


ENCODES = {  # name -> (frames, durations, options, icc)
    "still": ([_smooth(37, 52, 3, 1)], [0], {AVIF_QUALITY: 60}, None),
    "alpha": ([_smooth(30, 41, 4, 2)], [0], {AVIF_QUALITY: 70,
                                             AVIF_SPEED: 8}, None),
    "gray": ([_smooth(33, 29, 1, 3)], [0], {AVIF_QUALITY: 50}, None),
    "lossless": ([_smooth(24, 31, 3, 4)], [0], {AVIF_QUALITY: 100,
                                                AVIF_SPEED: 10}, None),
    "icc": ([_smooth(20, 26, 3, 5)], [0], {}, b"\x00" * 128),
    "animation": ([_smooth(28, 36, 3, 6 + i) for i in range(3)],
                  [0.05, 0.1, 0.02], {AVIF_QUALITY: 40, AVIF_SPEED: 9},
                  None),
    "animation_alpha": ([_smooth(28, 36, 4, 9 + i) for i in range(3)],
                        [0.03, 0.03, 0.07], {AVIF_QUALITY: 60}, None),
}


@needs_ffmpeg
@pytest.mark.parametrize("name", list(ENCODES))
def test_encoder_bytes_equal_jax(name):
    frames, durs, opts, icc = ENCODES[name]
    outs = []
    for pkg, enc in (("jax", JA.AvifEncoder(icc_override=icc)),
                     ("port", new_encoder(".avif", icc_override=icc))):
        for px, d in zip(frames, durs):
            assert enc.encode(_frame(px, d, pkg), opts) is None
        outs.append(enc.encode(None, opts))
    assert outs[1] == outs[0] and outs[1][4:12] in (b"ftypavif", b"ftypavis")
    back = decode_all("port", outs[1])
    assert back[0][4] == len(frames)
    if name == "lossless":
        np.testing.assert_array_equal(back[1][0], frames[0])


@needs_ffmpeg
def test_encoder_keeps_the_source_loop_count_and_icc():
    """new_encoder(".avif", decoder) takes the decoder's ICC and loop
    count, as the JAX package's does."""
    buf = fixture("anim_4f_48x40.avif")
    outs = []
    for pkg in ("jax", "port"):
        if pkg == "jax":
            d = JA.AvifDecoder(buf)
            enc, fb_cls = JA.AvifEncoder(d), JFramebuffer
        else:
            d = new_decoder(buf, device="cpu")
            enc, fb_cls = new_encoder(".avif", d), Framebuffer
        for _ in range(4):
            fb = fb_cls()
            d.decode_to(fb)
            enc.encode(fb, {AVIF_SPEED: 10})
        outs.append(enc.encode(None, {AVIF_SPEED: 10}))
    assert outs[0] == outs[1]
    assert TAR.parse_loop_count(outs[1]) == 3


# -- the PIL route ------------------------------------------------------------


@needs_ffmpeg
@pytest.mark.parametrize("name", FIXTURES)
def test_pil_route_equals_jax(name, monkeypatch):
    monkeypatch.setenv("LILLIPUT_AVIF", "pil")
    assert_decodes_equal(fixture(name))


@needs_ffmpeg
def test_declined_limited_ycgco_fails_as_jax():
    """Limited-range YCgCo: the native route declines, PIL/libavif fails
    to convert it; both packages raise the same class."""
    buf = _jax_avif_tests()._hbd_fixture(8, "420", False, 8, False)
    errs = []
    for pkg in ("jax", "port"):
        try:
            decode_all(pkg, buf)
            errs.append(None)
        except Exception as e:  # noqa: BLE001 -- the class is compared
            errs.append(type(e).__name__)
    assert errs[0] is not None and errs[0] == errs[1]


def test_api_dispatch():
    buf = fixture("still_alpha_64x48.avif")
    d = new_decoder(buf, tone_mapping_enabled=False, device="cpu")
    assert isinstance(d, TA.AvifDecoder) and not d._tone_map
    assert d.header().width == 64 and d.description() == "AVIF"
    assert isinstance(new_encoder(".avif"), TA.AvifEncoder)


# -- a machine without ffmpeg -------------------------------------------------


def test_missing_ffmpeg_raises_and_nothing_falls_back(monkeypatch):
    monkeypatch.setattr(binding, "AVFORMAT_HEADER",
                        "/nonexistent/libavformat/avformat.h")
    monkeypatch.setattr(binding, "_avformat_lib", None)
    monkeypatch.setattr(TA, "_pil_image", lambda: pytest.fail("PIL route"))
    from lilliput_tpu_torch.pipeline import (AnimatedTranscodePipeline,
                                             transcode_avif,
                                             transcode_avif_batch)
    still, anim = (fixture(n) for n in FIXTURES)
    d = new_decoder(still, device="cpu")
    assert (d.header().width, d.header().height) == (64, 48)
    assert d.icc() == binding_icc("srgb")
    a = new_decoder(anim, device="cpu")
    assert (a.loop_count(), a.duration()) == (3, 0.4)
    match = "ffmpeg.*/nonexistent/libavformat/avformat.h"
    enc = new_encoder(".avif")
    enc.encode(_frame(_smooth(8, 8, 3, 0)), {})
    hdr = hdr_still(HDR_CICP["pq"]) if HAVE_FFMPEG else None
    calls = [lambda: new_decoder(still, device="cpu").decode_to(
                 Framebuffer()),
             lambda: new_decoder(anim, device="cpu").decode_to(
                 Framebuffer()),
             lambda: new_decoder(anim, device="cpu").skip_frame(),
             lambda: enc.encode(None, {}),
             lambda: transcode_avif(anim, 16, 16, device="cpu"),
             lambda: transcode_avif_batch([anim, anim], 16, 16,
                                          device="cpu"),
             binding.build_avformat, binding.load_avformat]
    if hdr is not None:
        calls.append(lambda: new_decoder(hdr, device="cpu").decode_to(
            Framebuffer()))
    for call in calls:
        with pytest.raises(HostLibraryMissingError, match=match):
            call()
    res = AnimatedTranscodePipeline(16, 16, output_format=".avif",
                                    device="cpu").transcode(
        [anim, anim], return_exceptions=True)
    assert all(isinstance(r, HostLibraryMissingError) for r in res)
    assert not issubclass(HostLibraryMissingError, NotImplementedError)


# -- ROADMAP queue 3 entry 23: ADVICE.md's AVIF parser findings -----------------


def _box_iter(buf: bytes, s: int, e: int):
    """(type, start, end) of the boxes in buf[s:e] (32-bit sizes)."""
    i = s
    while i + 8 <= e:
        size = struct.unpack(">I", buf[i:i + 4])[0]
        yield buf[i + 4:i + 8], i, i + size
        i += size


def _box(buf: bytes, s: int, e: int, kind: bytes):
    return next((b for b in _box_iter(buf, s, e) if b[0] == kind), None)


def _stbl(buf: bytes, track: int):
    """(minf, stbl) spans of the track-th trak of the fixture's moov."""
    moov = _box(buf, 0, len(buf), b"moov")
    trak = [b for b in _box_iter(buf, moov[1] + 8, moov[2])
            if b[0] == b"trak"][track]
    mdia = _box(buf, trak[1] + 8, trak[2], b"mdia")
    minf = _box(buf, mdia[1] + 8, mdia[2], b"minf")
    return minf, _box(buf, minf[1] + 8, minf[2], b"stbl")


def _full(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 12 + len(payload)) + kind + bytes(4) + payload


def _track_table(buf: bytes, track: int, offsets, stsc, sizes=None) -> bytes:
    """buf with the track's chunk offsets (stco), sample-to-chunk entries
    (stsc) and, where given, sample sizes (stsz) replaced. The minf keeps
    its size (its vmhd and dinf, which no parser reads, give way to the
    larger tables and a free box), so no other offset in the file moves."""
    (_, m0, m1), (_, s0, s1) = _stbl(buf, track)
    new = {b"stco": _full(b"stco", struct.pack(f">I{len(offsets)}I",
                                               len(offsets), *offsets)),
           b"stsc": _full(b"stsc", struct.pack(">I", len(stsc)) + b"".join(
               struct.pack(">III", *e) for e in stsc))}
    if sizes is not None:
        new[b"stsz"] = _full(b"stsz", struct.pack(f">II{len(sizes)}I", 0,
                                                  len(sizes), *sizes))
    body = b"".join(new.get(k, buf[a:b]) for k, a, b in
                    _box_iter(buf, s0 + 8, s1))
    stbl = struct.pack(">I", 8 + len(body)) + b"stbl" + body
    pad = (m1 - m0 - 8) - len(stbl)
    assert pad >= 8
    minf = (buf[m0:m0 + 8] + struct.pack(">I", pad) + b"free" + bytes(pad - 8)
            + stbl)
    return buf[:m0] + minf + buf[m1:]


def _samples(buf: bytes, track: int):
    """(chunk offset, sizes) of the fixture's one-chunk track."""
    _, (_, s0, s1) = _stbl(buf, track)
    stco = _box(buf, s0 + 8, s1, b"stco")
    stsz = _box(buf, s0 + 8, s1, b"stsz")
    off = struct.unpack(">I", buf[stco[1] + 16:stco[1] + 20])[0]
    n = struct.unpack(">I", buf[stsz[1] + 16:stsz[1] + 20])[0]
    return off, list(struct.unpack(f">{n}I",
                                   buf[stsz[1] + 20:stsz[1] + 20 + 4 * n]))


def _downgraded() -> bytes:
    """Finding 1: the colour track's first sample size past the buffer, so
    parse_tracks raises, while the still meta keeps its ispe."""
    buf = bytearray(fixture("anim_4f_48x40.avif"))
    _, (_, s0, s1) = _stbl(bytes(buf), 0)
    stsz = _box(bytes(buf), s0 + 8, s1, b"stsz")
    buf[stsz[1] + 20:stsz[1] + 24] = struct.pack(">I", 0x7FFFFFFF)
    return bytes(buf)


def _stsc_unsorted() -> bytes:
    """Finding 2: the colour samples in three chunks (1, 1 and 2 samples)
    whose stsc entries run (1, 1), (3, 2), (2, 1): first_chunk out of
    order."""
    buf = fixture("anim_4f_48x40.avif")
    off, sizes = _samples(buf, 0)
    starts = [off + sum(sizes[:k]) for k in range(3)]
    return _track_table(buf, 0, starts, [(1, 1, 1), (3, 2, 1), (2, 1, 1)])


def _zero_width() -> bytes:
    """Finding 4: the colour sample entry's 16-bit width reads 0."""
    buf = bytearray(fixture("anim_4f_48x40.avif"))
    _, (_, s0, s1) = _stbl(bytes(buf), 0)
    stsd = _box(bytes(buf), s0 + 8, s1, b"stsd")
    av01 = stsd[1] + 16
    assert buf[av01 + 4:av01 + 8] == b"av01"
    buf[av01 + 32:av01 + 34] = bytes(2)
    return bytes(buf)


def _alpha_without_frame() -> bytes:
    """Finding 3: the alpha track's second sample is the first sample's
    12-byte sequence header OBU alone, a temporal unit that yields no
    frame, while the colour track yields one per sample."""
    buf = fixture("anim_4f_48x40.avif")
    off, sizes = _samples(buf, 1)
    assert buf[off:off + 2] == b"\x0a\x0a"     # OBU_SEQUENCE_HEADER, 10 B
    starts = [off, off] + [off + sum(sizes[:k]) for k in (2, 3)]
    return _track_table(buf, 1, starts, [(1, 1, 1)],
                        [sizes[0], 12] + sizes[2:])


ENTRY23 = {"downgrade": _downgraded, "stsc_unsorted": _stsc_unsorted,
           "pairing": _alpha_without_frame, "zero_width": _zero_width}


@pytest.mark.parametrize("name", list(ENTRY23))
def test_entry23_parsers_equal_jax(name):
    """The hostile tables parse to the same tracks, or raise the same
    error class, in both packages."""
    buf = ENTRY23[name]()

    def tracks(p):
        r = p(buf)
        return None if r is None else [
            None if x is None else (x.samples, x.av1c, x.width, x.height)
            for x in r]
    t = _outcome(lambda b: tracks(TAR.parse_tracks), buf)
    assert t == _outcome(lambda b: tracks(JAR.parse_tracks), buf)
    want = {"downgrade": ("raised", "InvalidImageError"),
            "stsc_unsorted": None, "pairing": None, "zero_width": None}
    if want[name]:
        assert t == want[name]
    elif name == "stsc_unsorted":
        # the last entry with first_chunk <= chunk wins: chunk 3 gets one
        # sample, not two, and the fourth sample is never read
        assert len(t[1][0][0]) == 3 and len(t[1][1][0]) == 4
    elif name == "zero_width":
        assert t[1][0][2:] == (0, 40)
    else:
        assert [len(s) for s in t[1][1][0]][:2] == [27, 12]


def _frames_until_error(pkg: str, buf: bytes):
    """(header fields, the frames decode_to gave, the first error as
    'Class: message' or None) through the JAX package or the port."""
    if pkg == "jax":
        d, fb_cls = JA.AvifDecoder(buf), JFramebuffer
    else:
        d, fb_cls = TA.AvifDecoder(buf, device="cpu"), Framebuffer
    h = d.header()
    frames, err = [], None
    for _ in range(h.num_frames):
        fb = fb_cls()
        try:
            d.decode_to(fb)
        except Exception as e:  # noqa: BLE001 -- compared across packages
            err = f"{type(e).__name__}: {e}"
            break
        frames.append(np.asarray(fb.to_numpy()).copy())
    d.close()
    return (h.width, h.height, h.channels, h.num_frames), frames, err


@needs_ffmpeg
@pytest.mark.parametrize("name", list(ENTRY23))
def test_entry23_decodes_equal_jax(name):
    """Header, frames and the first error of each hostile input equal the
    JAX package's: the port reproduces each finding (queue 3 entry 23)."""
    buf = ENTRY23[name]()
    header, frames, err = _frames_until_error("port", buf)
    jheader, jframes, jerr = _frames_until_error("jax", buf)
    assert (header, err) == (jheader, jerr)
    assert len(frames) == len(jframes)
    for a, b in zip(frames, jframes):
        np.testing.assert_array_equal(a, b)
    clean = _frames_until_error("port", fixture("anim_4f_48x40.avif"))[1]
    if name == "downgrade":
        # a 1-frame still from the meta's ispe, without the alpha track:
        # the animation is lost, and no error says so
        assert (header, len(frames), err) == ((48, 40, 3, 1), 1, None)
    elif name == "stsc_unsorted":
        # three frames, the source's first three; the fourth is dropped
        assert (header, len(frames), err) == ((48, 40, 4, 3), 3, None)
        assert all(np.array_equal(a, b) for a, b in zip(frames, clean))
    elif name == "zero_width":
        # the native walk gives up its geometry and PIL (libavif) decodes
        assert (header, len(frames), err) == ((48, 40, 4, 4), 4, None)
    else:
        # the alpha FIFO runs one frame behind the colour one: frame 2
        # takes sample 3's alpha without an error, then the alpha stream
        # runs dry and frame 3 takes the PIL route, where libavif fails
        assert header == (48, 40, 4, 4) and len(frames) == 3
        assert np.array_equal(frames[2][..., :3], clean[2][..., :3])
        assert not np.array_equal(frames[2][..., 3], clean[2][..., 3])
        assert err.startswith("RuntimeError: Failed to decode frame 3")
