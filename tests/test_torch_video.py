"""The port's video codec (codecs/video.py on its copy of
avformat_shim.cpp) on the CPU against the JAX package's:

* every accessor of VideoDecoder (header, description, duration, codec
  names, subtitles, streamability, ICC, keyframe index, codec parameters)
  equal on an MPEG-4 Part 2 MP4, MJPEG and PNG AVIs, an FFV1 MKV, a VP8
  WebM (cv2.VideoWriter clips, tests/_torch_video_builders.py), the
  committed tests/assets/tiny_vp8.webm and a WAV (Python's wave module);
* decode_to's frames at atol 0, through the device route (planar YUV:
  MP4, MJPEG's full range, VP8) and the shim's BGRA route (PNG, FFV1), to
  the end of each clip;
* the rotate tag's orientations (tools/make_webm_fixture), the quadrant
  and non-quadrant values of tests/test_video.py;
* anamorphic MP4s (12:11 and 10:11 pixel aspects patched into the VOL
  header) through the fixed-point LINEAR upscale to the display size;
* the keyframe index, codec parameters and raw keyframe decodes, on the
  whole file and on an ftyp + moov cut of it;
* is_streamable_mp4 on tests/test_video.py's synthetic atoms;
* new_decoder's fallthrough: WAV and AVI open, other bytes raise
  InvalidImageError; with ffmpeg's header missing (binding.AVFORMAT_HEADER
  monkeypatched away) a sniffed container raises HostLibraryMissingError
  naming ffmpeg and nothing else does;
* the device half alone (frame_to_bgra, bgra_to_display) on planes made
  here, 4:2:0, 4:2:2 and 4:4:4, limited and full range, four matrices, at
  and off the display size, equal to the JAX decoder's chain.

The tests that open a container skip where ffmpeg's headers are absent;
the device half, the streamability scan and the missing-library test run
everywhere."""

import os
import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lilliput_tpu import new_decoder as jax_new_decoder
from lilliput_tpu.codecs import video as JV
from lilliput_tpu.framebuffer import Framebuffer as JFramebuffer
from lilliput_tpu.ops import blend as JB
from lilliput_tpu.ops import color as JC
from lilliput_tpu.ops import resize as JR
from lilliput_tpu_torch import binding, new_decoder
from lilliput_tpu_torch.codecs import video as TV
from lilliput_tpu_torch.errors import (HostLibraryMissingError,
                                       InvalidImageError)
from lilliput_tpu_torch.framebuffer import Framebuffer

import _torch_video_builders as VB

HAVE_FFMPEG = os.path.exists(binding.AVFORMAT_HEADER)
needs_ffmpeg = pytest.mark.skipif(not HAVE_FFMPEG,
                                  reason="ffmpeg's headers are absent")
#: every container input, by name
INPUTS = dict({n: (lambda n=n: VB.clip(n)) for n in VB.CLIPS},
              tiny_vp8=VB.tiny_vp8, wav=VB.wav_bytes)
VIDEOS = [n for n in INPUTS if n != "wav"]


def _outcome(fn):
    """fn()'s value, or its exception's class name and message."""
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 -- compared, not handled
        return (type(e).__name__, str(e))


def _accessors(d):
    h = d.header()
    return {
        "header": (h.width, h.height, h.channels, int(h.orientation),
                   h.num_frames, h.content_length),
        "description": d.description(), "duration": d.duration(),
        "video_codec": d.video_codec(), "audio_codec": d.audio_codec(),
        "has_subtitles": d.has_subtitles(),
        "is_streamable": d.is_streamable(), "icc": d.icc(),
        "loop_count": d.loop_count(),
        "background_color": d.background_color(),
        "keyframes": _outcome(d.keyframes),
        "codec_params": _outcome(d.codec_params),
    }


def _frames(d, fb_cls, n=None):
    """Up to n frames (every frame when None) as numpy, then the outcome
    of one more decode_to (EOFError at the end)."""
    out = []
    while n is None or len(out) < n:
        fb = fb_cls()
        try:
            d.decode_to(fb)
        except EOFError:
            return out, "EOFError"
        out.append(fb.to_numpy())
    return out, None


@needs_ffmpeg
@pytest.mark.parametrize("name", list(INPUTS))
def test_accessors_equal_jax(name):
    buf = INPUTS[name]()
    d, j = new_decoder(buf, device="cpu"), jax_new_decoder(buf)
    assert type(d).__name__ == type(j).__name__ == "VideoDecoder"
    got, want = _accessors(d), _accessors(j)
    assert got == want
    if name == "wav":
        assert (got["description"], got["audio_codec"],
                got["header"][0]) == ("WAV", "Unknown", 0)
    d.close()
    d.close()


@needs_ffmpeg
@pytest.mark.parametrize("name", VIDEOS)
def test_frames_equal_jax(name):
    """Every frame of each clip at atol 0, and EOFError after the last."""
    buf = INPUTS[name]()
    d = new_decoder(buf, device="cpu")
    got, end = _frames(d, Framebuffer)
    want, jend = _frames(jax_new_decoder(buf), JFramebuffer)
    assert end == jend == "EOFError"
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.shape == w.shape == (d.header().height, d.header().width, 4)
        assert np.array_equal(g, w)


@needs_ffmpeg
def test_audio_only_decode_fails_as_jax():
    buf = VB.wav_bytes()
    got = _outcome(lambda: new_decoder(buf, device="cpu").decode_to(
        Framebuffer()))
    want = _outcome(lambda: jax_new_decoder(buf).decode_to(JFramebuffer()))
    assert got == want == ("DecodingFailedError", "no video stream")


@needs_ffmpeg
def test_route_per_pixel_format():
    """Which route each clip takes: planar 8-bit YUV converts on the
    device, the rest through the shim's BGRA."""
    routes = {}
    for name in VIDEOS:
        d = TV.VideoDecoder(INPUTS[name](), device="cpu")
        routes[name] = d.next_frame()[0]
    assert routes == {"mp4": "planes", "avi_mjpg": "planes",
                      "avi_png": "bgra", "mkv_ffv1": "bgra",
                      "webm_vp8": "planes", "tiny_vp8": "planes"}


@needs_ffmpeg
@pytest.mark.parametrize("deg,orient", [(90, 6), (180, 3), (270, 8),
                                        (None, 1), (-90, 1), (45, 1),
                                        (360, 1), (91, 1)])
def test_rotate_tag_orientation_equal_jax(deg, orient):
    buf = VB.webm_with_rotate(deg)
    got = new_decoder(buf, device="cpu").header().orientation
    assert got == jax_new_decoder(buf).header().orientation == orient


@needs_ffmpeg
@pytest.mark.parametrize("ar,display", [(2, (87, 60)), (3, (80, 66))],
                         ids=["12:11", "10:11"])
def test_anamorphic_linear_upscale_equal_jax(ar, display):
    """A pixel aspect other than 1 gives a display size other than the
    coded 80x60: the frame is upscaled by the u8 fixed-point LINEAR
    resize, as the JAX decoder's R.resize does."""
    buf = VB.anamorphic_mp4(ar)
    d = new_decoder(buf, device="cpu")
    assert (d.header().width, d.header().height) == display
    got, _ = _frames(d, Framebuffer, 3)
    want, _ = _frames(jax_new_decoder(buf), JFramebuffer, 3)
    for g, w in zip(got, want):
        assert g.shape == (display[1], display[0], 4)
        assert np.array_equal(g, w)


@needs_ffmpeg
@pytest.mark.parametrize("name", ["mp4", "avi_mjpg"])
def test_raw_keyframes_equal_jax(name):
    buf = VB.clip(name)
    d = TV.VideoDecoder(buf, device="cpu")
    j = JV.VideoDecoder(buf)
    kf, (cid, extradata) = d.keyframes(), d.codec_params()
    assert kf == j.keyframes() and (cid, extradata) == j.codec_params()
    assert len(kf) >= 2
    w, h = d.header().width, d.header().height
    for ts, off, size in kf[:3]:
        pkt = buf[off:off + size]
        got = TV.decode_raw_keyframe(cid, extradata, pkt, w, h)
        out = np.zeros((h, w, 4), np.uint8)
        assert TV.decode_raw_keyframe(cid, extradata, pkt, w, h,
                                      out=out) is out
        want = JV.decode_raw_keyframe(cid, extradata, pkt, w, h)
        assert np.array_equal(got, want) and np.array_equal(out, want)
    with pytest.raises(ValueError):
        TV.decode_raw_keyframe(cid, extradata, pkt, w, h,
                               out=np.zeros((h, w, 3), np.uint8))
    assert (_outcome(lambda: TV.decode_raw_keyframe(cid, extradata,
                                                    b"\0" * 16, w, h))
            == _outcome(lambda: JV.decode_raw_keyframe(cid, extradata,
                                                       b"\0" * 16, w, h)))


@needs_ffmpeg
def test_moov_only_index_and_raw_decode_equal_jax():
    """The media-proxy workflow (tests/test_video.py): the index and codec
    parameters from an ftyp + moov cut, the packets from the whole file.
    Without a frame to decode, ffmpeg reads no size from MPEG-4 Part 2's
    moov (the header says 0x0 in both packages), so the size is the whole
    file's."""
    full = VB.clip("mp4")
    moov = VB.extract_ftyp_moov(full)
    assert 0 < len(moov) < len(full)
    d, j = TV.VideoDecoder(moov, device="cpu"), JV.VideoDecoder(moov)
    assert _accessors(d) == _accessors(j)
    kf = d.keyframes()
    cid, extradata = d.codec_params()
    whole = TV.VideoDecoder(full, device="cpu")
    assert (kf, (cid, extradata)) == (whole.keyframes(),
                                      whole.codec_params())
    assert kf and cid > 0 and extradata
    w, h = whole.header().width, whole.header().height
    for ts, off, size in kf:
        pkt = full[off:off + size]
        assert np.array_equal(
            TV.decode_raw_keyframe(cid, extradata, pkt, w, h),
            JV.decode_raw_keyframe(cid, extradata, pkt, w, h))


def _atom(typ: bytes, n: int) -> bytes:
    return struct.pack(">I", 8 + n) + typ + b"\0" * n


@pytest.mark.parametrize("buf", [
    _atom(b"free", 40000) + _atom(b"moov", 8),     # moov past the 32 KB peek
    _atom(b"free", 8) + _atom(b"moov", 8),
    _atom(b"ftyp", 8) + _atom(b"mdat", 8) + _atom(b"moov", 8),
    _atom(b"ftyp", 8) + struct.pack(">I", 4) + b"moov",   # size < 8
    _atom(b"ftyp", 8) + struct.pack(">I", 99) + b"moov",  # past the end
    b"", b"\x1a\x45\xdf\xa3" + bytes(40)],
    ids=["far", "near", "mdat_first", "small", "overrun", "empty", "ebml"])
def test_is_streamable_mp4_equal_jax(buf):
    assert TV.is_streamable_mp4(buf) == JV.is_streamable_mp4(buf)


def test_is_streamable_mp4_cases():
    assert not TV.is_streamable_mp4(_atom(b"free", 40000) + _atom(b"moov", 8))
    assert TV.is_streamable_mp4(_atom(b"free", 8) + _atom(b"moov", 8))
    assert not TV.is_streamable_mp4(VB.tiny_vp8())


def test_feature_gates():
    """set_hevc_enabled and set_av1_enabled switch what lp_av_open is
    told, as in the JAX module."""
    for fn, name in ((TV.set_hevc_enabled, "_hevc_enabled"),
                     (TV.set_av1_enabled, "_av1_enabled")):
        assert getattr(TV, name) is False
        fn(True)
        try:
            assert getattr(TV, name) is True
        finally:
            fn(False)


@needs_ffmpeg
@pytest.mark.parametrize("buf", [b"not an image at all", bytes(64),
                                 b"RIFF" + bytes(60),
                                 b"\x1a\x45\xdf\xa3" + bytes(12),
                                 b"\x00\x00\x00\x18ftypisom" + bytes(8)],
                         ids=["text", "zeros", "riff", "ebml", "ftyp"])
def test_new_decoder_refuses_what_ffmpeg_refuses(buf):
    with pytest.raises(InvalidImageError, match="unrecognized image format"):
        new_decoder(buf, device="cpu")
    with pytest.raises(Exception) as e:
        jax_new_decoder(buf)
    assert type(e.value).__name__ == "InvalidImageError"


def test_missing_ffmpeg_raises_only_for_video(monkeypatch):
    monkeypatch.setattr(binding, "AVFORMAT_HEADER",
                        "/nonexistent/libavformat/avformat.h")
    monkeypatch.setattr(binding, "_avformat_lib", None)
    from lilliput_tpu_torch.pipeline import spritesheet
    match = "ffmpeg.*/nonexistent/libavformat/avformat.h"
    webm = VB.tiny_vp8()
    for call in (lambda: new_decoder(webm, device="cpu"),
                 lambda: new_decoder(b"\x00\x00\x00\x18ftypisom" + bytes(8),
                                     device="cpu"),
                 lambda: TV.VideoDecoder(webm, device="cpu"),
                 lambda: spritesheet(webm, 16, 12, device="cpu"),
                 lambda: TV.decode_raw_keyframe(139, b"", b"\0", 8, 8)):
        with pytest.raises(HostLibraryMissingError, match=match):
            call()
    for buf in (b"not an image at all", VB.wav_bytes(), b"RIFF" + bytes(60)):
        with pytest.raises(InvalidImageError):
            new_decoder(buf, device="cpu")
    assert not issubclass(HostLibraryMissingError, InvalidImageError)


def _planes(rng, h, w, ch, cw):
    return (rng.integers(0, 256, (h, w), np.uint8),
            rng.integers(0, 256, (ch, cw), np.uint8),
            rng.integers(0, 256, (ch, cw), np.uint8))


def _jax_chain(y, u, v, spc, rng, fmt, dw, dh):
    """The JAX decoder's device lines (lilliput_tpu/codecs/video.py
    :211-236) on these planes."""
    bgr = JC.yuv420_to_bgr(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v),
                           space=JC.AVCOL_SPC.get(spc, "bt601"),
                           full_range=rng == 2 or fmt in JV._FULL_RANGE_FMTS,
                           out_h=y.shape[0], out_w=y.shape[1])
    arr = JB.to_bgra(bgr)
    if (arr.shape[1], arr.shape[0]) != (dw, dh):
        arr = JR.resize(arr, dw, dh, JR.LINEAR)
    return np.asarray(arr)


@pytest.mark.parametrize("fmt,spc,rng", [
    (0, 1, 1), (0, 5, 2), (12, 2, 0), (4, 6, 1), (13, 5, 2), (5, 9, 1),
    (14, 7, 0), (5, 10, 2)])
@pytest.mark.parametrize("size,display", [
    ((61, 90), None), ((40, 66), (93, 40)), ((58, 47), (47, 63))],
    ids=["as_coded", "wider", "taller"])
def test_frame_to_bgra_equal_jax_chain(fmt, spc, rng, size, display):
    """frame_to_bgra alone (no ffmpeg): 4:2:0 (fmt 0, 12), 4:2:2 (4, 13)
    and 4:4:4 (5, 14) planes, odd sizes, limited and full range, the
    bt709, bt601, smpte240 and bt2020 matrices and an unlisted one (2),
    at the coded size and LINEAR-upscaled."""
    h, w = size
    sx, sy = TV._PLANAR_YUV[fmt]
    planes = _planes(np.random.default_rng(fmt * 100 + spc), h, w,
                     -(-h // sy), -(-w // sx))
    dw, dh = display or (w, h)
    times = {}
    got = TV.frame_to_bgra(*planes, spc=spc, rng=rng, fmt=fmt, display_w=dw,
                           display_h=dh, device="cpu", stage_times=times)
    assert set(times) == {"h2d", "device_convert"}
    assert got.dtype == torch.uint8 and tuple(got.shape) == (dh, dw, 4)
    assert np.array_equal(got.numpy(),
                          _jax_chain(*planes, spc, rng, fmt, dw, dh))


@pytest.mark.parametrize("display", [(37, 29), (50, 29), (37, 44)])
def test_bgra_to_display_equal_jax_resize(display):
    px = np.random.default_rng(7).integers(0, 256, (29, 37, 4), np.uint8)
    got = TV.bgra_to_display(px, display_w=display[0],
                             display_h=display[1], device="cpu")
    want = (px if display == (37, 29)
            else np.asarray(JR.resize(jnp.asarray(px), *display, JR.LINEAR)))
    assert np.array_equal(got.numpy(), want)
