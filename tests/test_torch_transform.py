"""The port's single-image surface on the CPU against the JAX package:
new_decoder -> ImageOps.transform -> new_encoder, JPEG in, JPEG or PNG
out, with device="cpu" (the decode kernels' plain versions).

* Bytes equal to the JAX package's ImageOps.transform on the same input:
  Fit, stretch (RESIZE) and NO_RESIZE in the four chroma layouts and
  grayscale at an odd geometry (67x61 -> 30x17, and up to 100x90); EXIF
  orientations 1-8; a progressive source; JPEG quality options and the
  progressive, optimize and restart-interval options.
* Units: ops/blend function by function, Framebuffer.fit and resize_to,
  the animated composite helpers of ImageOps, the decoder's header.
* Errors: new_decoder and new_encoder raise NotImplementedError naming
  the ROADMAP queue 1 item of each format not ported (never
  InvalidImageError), and the ported still formats fail as in the JAX
  package on a bad header, InvalidImageError for what is no image; the
  max_size, zero-dimension and force_sdr paths behave as in the JAX
  package.
* The five .icc profiles are byte-for-byte copies of the JAX package's.
"""

import io
import os
import struct

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp
import lilliput_tpu as L
from lilliput_tpu.codecs import icc as JICC
from lilliput_tpu.codecs import jpeg as JJ
from lilliput_tpu.ops import blend as JB
import lilliput_tpu_torch as T
from lilliput_tpu_torch.codecs import icc as TICC
from lilliput_tpu_torch.codecs import jpeg as TJ
from lilliput_tpu_torch.codecs.png import PngEncoder
from lilliput_tpu_torch.errors import (BufTooSmallError, DecodingFailedError,
                                       InvalidImageError)
from lilliput_tpu_torch.framebuffer import (JPEG_CHROMA_QUALITY,
                                            JPEG_LUMA_QUALITY, JPEG_OPTIMIZE,
                                            JPEG_PROGRESSIVE, JPEG_QUALITY,
                                            JPEG_RST_INTERVAL, PNG_COMPRESSION,
                                            BlendMethod, DisposeMethod,
                                            Framebuffer, ImageHeader)
from lilliput_tpu_torch.ops import blend as TB
from lilliput_tpu_torch.ops import decode_kernels as DK

from _torch_parity import gray_jpeg, layout_jpeg, with_orientation

FIT, RESIZE, NO_RESIZE = (T.ResizeMethod.FIT, T.ResizeMethod.RESIZE,
                          T.ResizeMethod.NO_RESIZE)


def _source(kind, w=67, h=61, seed=7, quality=85):
    return (gray_jpeg(w, h, quality, seed) if kind == "gray"
            else layout_jpeg(w, h, quality, seed, kind))


def _both(buf, max_size=8192, **opt):
    """(JAX bytes, port bytes) of ImageOps.transform with these options."""
    a = L.ImageOps(max_size).transform(L.new_decoder(buf),
                                       L.ImageOptions(**opt))
    b = T.ImageOps(max_size).transform(T.new_decoder(buf, device="cpu"),
                                       T.ImageOptions(**opt))
    return a, b


@pytest.mark.parametrize("fmt", [".jpeg", ".png"])
@pytest.mark.parametrize("method", [FIT, RESIZE, NO_RESIZE],
                         ids=["fit", "stretch", "no_resize"])
@pytest.mark.parametrize("kind", ["420", "422", "440", "444", "gray"])
def test_transform_bytes_equal_jax(kind, method, fmt):
    a, b = _both(_source(kind), file_type=fmt, width=30, height=17,
                 resize_method=method)
    assert a == b


@pytest.mark.parametrize("dst", [(100, 90), (16, 16), (61, 61)])
@pytest.mark.parametrize("kind", ["420", "444", "gray"])
def test_transform_upscale_and_square_equal_jax(kind, dst):
    """Fit sizing quirks (calculate_expected_size) and the area-rule
    bilinear of an upscale."""
    for fmt in (".jpeg", ".png"):
        a, b = _both(_source(kind), file_type=fmt, width=dst[0],
                     height=dst[1], resize_method=FIT)
        assert a == b


@pytest.mark.parametrize("fmt", [".jpeg", ".png"])
@pytest.mark.parametrize("orientation", range(1, 9))
@pytest.mark.parametrize("kind", ["420", "gray"])
def test_transform_orientations_equal_jax(kind, orientation, fmt):
    buf = with_orientation(_source(kind, 48, 40, seed=orientation),
                           orientation)
    assert T.new_decoder(buf, device="cpu").header().orientation == \
        orientation
    a, b = _both(buf, file_type=fmt, width=24, height=20, resize_method=FIT)
    assert a == b


def test_transform_progressive_source_equal_jax():
    bio = io.BytesIO()
    Image.open(io.BytesIO(_source("420", 96, 72))).save(
        bio, "JPEG", quality=80, progressive=True)
    buf = bio.getvalue()
    assert TJ.read_info(buf).progressive == 1
    for fmt in (".jpeg", ".png"):
        a, b = _both(buf, file_type=fmt, width=40, height=40,
                     resize_method=FIT)
        assert a == b


@pytest.mark.parametrize("opts", [
    {JPEG_QUALITY: 50}, {JPEG_QUALITY: 100},
    {JPEG_LUMA_QUALITY: 90, JPEG_CHROMA_QUALITY: 40},
    {JPEG_LUMA_QUALITY: 70}, {JPEG_PROGRESSIVE: 0, JPEG_OPTIMIZE: 0},
    {PNG_COMPRESSION: 1}])
@pytest.mark.parametrize("kind", ["420", "gray"])
def test_jpeg_encode_options_equal_jax(kind, opts):
    a, b = _both(_source(kind), file_type=".jpeg", width=30, height=17,
                 resize_method=FIT, encode_options=opts)
    assert a == b


@pytest.mark.parametrize("key", [JPEG_PROGRESSIVE, JPEG_OPTIMIZE,
                                 JPEG_RST_INTERVAL])
def test_jpeg_encoder_libjpeg_options_equal_jax(key):
    """The options the JAX package hands to libjpeg: the port's own encoder
    (jpeg_enc.cpp) writes the same bytes, in both the colour and the gray
    encoder, at two restart intervals."""
    for kind in ("420", "gray"):
        for v in (1, 2):
            a, b = _both(_source(kind), file_type=".jpg", width=30,
                         height=17, resize_method=FIT,
                         encode_options={key: v, JPEG_QUALITY: 80})
            assert a == b
    assert (b"\xff\xc2" in a) == (key == JPEG_PROGRESSIVE)
    assert (b"\xff\xdd" in a) == (key == JPEG_RST_INTERVAL)


# -- the decoder ---------------------------------------------------------------

@pytest.mark.parametrize("kind", ["420", "422", "440", "444", "gray"])
def test_decoder_frame_and_header_equal_jax(kind):
    buf = _source(kind) + b"trailing bytes"
    jd, td = L.new_decoder(buf), T.new_decoder(buf, device="cpu")
    jh, th = jd.header(), td.header()
    assert (th.width, th.height, th.channels, th.orientation,
            th.num_frames, th.content_length) == (
        jh.width, jh.height, jh.channels, jh.orientation, jh.num_frames,
        jh.content_length)
    assert th.content_length == len(buf) - len(b"trailing bytes")
    assert td.description() == "JPEG" and td.icc() == jd.icc() == b""
    jf, tf = L.Framebuffer(), Framebuffer()
    jd.decode_to(jf)
    DK.reset_launches()
    td.decode_to(tf)
    assert not any(DK.launches.values())      # CPU: the plain versions
    assert tf.array.dtype == torch.uint8 and tf.device.type == "cpu"
    np.testing.assert_array_equal(tf.to_numpy(), np.asarray(jf.array))
    with pytest.raises(EOFError):
        td.decode_to(tf)


def _rgb_and_cmyk_sources():
    """A small JCS_RGB source (a 4:4:4 stream behind an Adobe marker with
    transform 0) and a PIL CMYK one."""
    buf = _source("444", 32, 24)
    app0 = int.from_bytes(buf[4:6], "big")
    adobe = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00"  # transform 0
    rgb = b"\xff\xd8" + adobe + buf[4 + app0:]
    assert TJ.read_info(rgb).jpeg_color_space == TJ.JCS_RGB
    bio = io.BytesIO()
    Image.new("CMYK", (32, 24), (10, 20, 30, 40)).save(bio, "JPEG")
    assert TJ.has_adobe_marker(bio.getvalue())
    assert not TJ.has_adobe_marker(buf)
    return rgb, bio.getvalue()


def test_rgb_and_cmyk_sources_decode_as_jax():
    """JCS_RGB and 4-component sources decode as in the JAX package
    (tests/test_torch_still_codecs.py holds every variant)."""
    for b in _rgb_and_cmyk_sources():
        assert TJ.has_adobe_marker(b) == JJ.has_adobe_marker(b)
        jf, tf = L.Framebuffer(), Framebuffer()
        L.new_decoder(b).decode_to(jf)
        T.new_decoder(b, device="cpu").decode_to(tf)
        np.testing.assert_array_equal(tf.to_numpy(), np.asarray(jf.array))


def test_decoder_refuses_rgb_and_cmyk_sources():
    """The 4-component sources both packages refuse: CMYK and YCCK (Adobe
    transform 0 and 2) with a subsampled component. The header still
    parses (new_decoder is not the place they fail, as in the JAX
    package)."""
    for transform in (0, 2):
        cmyk = bytearray(_rgb_and_cmyk_sources()[1])
        cmyk[cmyk.index(b"Adobe") + 11] = transform
        cmyk[cmyk.index(b"\xff\xc0") + 11] = 0x22  # component 1 at 2x2
        for dec, fb, err in (
                (L.new_decoder(bytes(cmyk)), L.Framebuffer(),
                 L.DecodingFailedError),
                (T.new_decoder(bytes(cmyk), device="cpu"), Framebuffer(),
                 DecodingFailedError)):
            with pytest.raises(err, match="subsampled CMYK"):
                dec.decode_to(fb)


def test_content_length_equal_jax():
    buf = _source("420")
    for b in (buf, buf + b"\xff\xd9tail", buf[:-2], buf[:40],
              with_orientation(buf, 3) + bytes(7)):
        assert TJ.jpeg_content_length(b) == JJ.jpeg_content_length(b)


def test_decoder_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.new_decoder(_source("420"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.JpegTranscodePipeline(_source("420"), 16, 16)


# -- API errors ------------------------------------------------------------------

_ISO_BMFF = b"\x00\x00\x00\x18ftyp"
NOT_PORTED_DECODERS = {
    "avif": (_ISO_BMFF + b"avif" + bytes(8), "item 6.5"),
    "mp4": (_ISO_BMFF + b"isom" + bytes(8), "item 6.6"),
    "mov": (_ISO_BMFF + b"qt  " + bytes(8), "item 6.6"),
    "webm": (b"\x1a\x45\xdf\xa3" + bytes(12), "item 6.6"),
}
#: headers of the formats ported in items 5.3, 6.1, 6.2, 6.3 and 6.4 that
#: no decoder reads: each raises what the JAX package raises
PORTED_BAD_HEADERS = {
    "webp": b"RIFF\x00\x00\x00\x00WEBPVP8 " + bytes(8),
    "jp2": b"\x00\x00\x00\x0cjP  \r\n\x87\n" + bytes(8),
    "j2k": b"\xff\x4f\xff\x51" + bytes(8),
    "gif": b"GIF89a" + bytes(20),
    "png": b"\x89PNG\r\n\x1a\n" + bytes(16),
    "bmp": b"BM" + bytes(40),
    "pnm": b"P6\n2 2\n255\n" + bytes(12),
    "pam": b"P7\nWIDTH 1\n",
    "sunras": b"\x59\xa6\x6a\x95" + bytes(40),
    "hdr": b"#?RADIANCE\n",
    "pfm": b"PF\n1 1\n-1\n" + bytes(12),
}


@pytest.mark.parametrize("name", list(NOT_PORTED_DECODERS))
def test_new_decoder_names_the_item(name):
    buf, item = NOT_PORTED_DECODERS[name]
    with pytest.raises(NotImplementedError, match=item):
        T.new_decoder(buf, device="cpu")


@pytest.mark.parametrize("name", list(PORTED_BAD_HEADERS))
def test_new_decoder_of_a_ported_format_fails_as_jax(name):
    buf = PORTED_BAD_HEADERS[name]
    errs = []
    for new, fb in ((L.new_decoder, L.Framebuffer),
                    (lambda b: T.new_decoder(b, device="cpu"), Framebuffer)):
        try:
            new(buf).decode_to(fb())
            errs.append(None)
        except NotImplementedError:
            errs.append("NotImplementedError")
        except Exception as e:
            errs.append(type(e).__name__)
    assert errs[1] != "NotImplementedError"
    assert errs[0] == errs[1], errs
    if name in ("jp2", "j2k"):
        with pytest.raises(InvalidImageError, match="JPEG 2000"):
            T.new_decoder(buf, device="cpu")


@pytest.mark.parametrize("buf", [b"", b"not an image at all", bytes(64),
                                 b"\xff\xd8\xff\xe0" + bytes(4)])
def test_new_decoder_refuses_what_is_no_image(buf):
    with pytest.raises(InvalidImageError):
        d = T.new_decoder(buf, device="cpu")
        d.decode_to(Framebuffer())


@pytest.mark.parametrize("ext,item", [(".avif", "item 6.5")])
def test_new_encoder_names_the_item(ext, item):
    with pytest.raises(NotImplementedError, match=item):
        T.new_encoder(ext)
    with pytest.raises(NotImplementedError, match=item):
        T.ImageOps(8192).transform(
            T.new_decoder(_source("420"), device="cpu"),
            T.ImageOptions(file_type=ext, width=8, height=8,
                           resize_method=FIT))


def test_new_encoder_webp_equal_jax():
    """The WebP encoder (item 4.7b): new_encoder gives it, and the
    transform's bytes equal the JAX package's (tests/test_torch_webp.py
    holds every option)."""
    from lilliput_tpu_torch.codecs.webp import WebpEncoder
    assert isinstance(T.new_encoder(".webp"), WebpEncoder)
    a, b = _both(_source("420"), file_type=".webp", width=8, height=8,
                 resize_method=FIT, encode_timeout=60.0)
    assert a == b and a[:4] == b"RIFF"


@pytest.mark.parametrize("ext", [".jp2", ".j2k"])
def test_new_encoder_jp2_equal_jax(ext):
    """The JPEG 2000 encoder (item 6.4): new_encoder gives it, and the
    transform's bytes equal the JAX package's (tests/test_torch_jp2_enc.py
    holds every option)."""
    from lilliput_tpu_torch.codecs.jp2 import Jp2Encoder
    assert isinstance(T.new_encoder(ext), Jp2Encoder)
    a, b = _both(_source("420"), file_type=ext, width=8, height=8,
                 resize_method=FIT)
    assert a == b and b.startswith(b"\x00\x00\x00\x0cjP")


@pytest.mark.parametrize("ext", [".thumbhash", ".bmp", ".ppm", ".pam",
                                 ".ras", ".hdr", ".pfm"])
def test_new_encoder_of_a_ported_format_equal_jax(ext):
    """The encoders ported in item 5.3/6.3: the transform's bytes equal
    the JAX package's (tests/test_torch_still_codecs.py holds them on
    every channel count)."""
    a, b = _both(_source("420"), file_type=ext, width=8, height=8,
                 resize_method=FIT)
    assert a == b


def test_new_encoder_dispatch():
    assert isinstance(T.new_encoder(".JPG"), TJ.JpegEncoder)
    assert isinstance(T.new_encoder(".png"), PngEncoder)
    for ext in (".mp4", ".webm", ".xyz"):
        with pytest.raises(InvalidImageError):
            T.new_encoder(ext)


def test_max_size_and_zero_dimensions_behave_as_jax():
    buf = _source("420")
    for ops, opt in ((60, dict(width=30, height=17, resize_method=FIT)),
                     (8192, dict(width=9000, height=17, resize_method=FIT)),
                     (8192, dict(width=17, height=9000,
                                 resize_method=RESIZE))):
        with pytest.raises(L.errors.BufTooSmallError):
            L.ImageOps(ops).transform(L.new_decoder(buf),
                                      L.ImageOptions(**opt))
        with pytest.raises(BufTooSmallError):
            T.ImageOps(ops).transform(T.new_decoder(buf, device="cpu"),
                                      T.ImageOptions(**opt))
    # NO_RESIZE ignores the requested dims, as in the reference
    a, b = _both(buf, file_type=".png", width=9000, height=9000,
                 resize_method=NO_RESIZE)
    assert a == b
    for opt in (dict(width=0, height=17, resize_method=FIT),
                dict(width=30, height=0, resize_method=RESIZE)):
        with pytest.raises(ValueError, match="must be positive"):
            L.ImageOps(8192).transform(L.new_decoder(buf),
                                       L.ImageOptions(**opt))
        with pytest.raises(ValueError, match="must be positive"):
            T.ImageOps(8192).transform(T.new_decoder(buf, device="cpu"),
                                       T.ImageOptions(**opt))


def _hdr_profile() -> bytes:
    """A minimal ICC profile whose cicp tag reports PQ (transfer 16)."""
    body = b"cicp" + bytes(4) + bytes([9, 16, 0, 1])
    size = 132 + 12 + len(body)
    head = struct.pack(">I", size) + bytes(124)
    return head + struct.pack(">I4sII", 1, b"cicp", 144, 12) + body


def test_force_sdr_behaves_as_jax():
    hdr = _hdr_profile()
    assert TICC.is_hdr_icc_profile(hdr) and JICC.is_hdr_icc_profile(hdr)
    assert TICC.parse_cicp(hdr) == (9, 16, 0, 1)
    bio = io.BytesIO()
    Image.open(io.BytesIO(_source("420"))).save(bio, "JPEG", quality=90,
                                                icc_profile=hdr)
    buf = bio.getvalue()
    assert T.new_decoder(buf, device="cpu").icc() == hdr
    for fmt in (".jpeg", ".png"):
        for force in (False, True):
            a, b = _both(buf, file_type=fmt, width=30, height=17,
                         resize_method=FIT, force_sdr=force)
            assert a == b
            want = TICC.SRGB_PROFILE if force else hdr
            if fmt == ".png":
                assert Image.open(io.BytesIO(b)).info["icc_profile"] == want
            else:
                assert TJ.read_icc(b) == want


def test_icc_profiles_are_the_jax_packages():
    names = sorted(os.listdir("lilliput_tpu/icc_profiles"))
    assert len(names) == 5
    for name in names:
        with open(os.path.join("lilliput_tpu", "icc_profiles", name),
                  "rb") as f, open(os.path.join(
                      "lilliput_tpu_torch", "icc_profiles", name), "rb") as g:
            assert f.read() == g.read()
    for n in ("SRGB_PROFILE", "REC709_PROFILE", "REC2020_PROFILE",
              "REC601_PAL_PROFILE", "REC601_NTSC_PROFILE"):
        ours = getattr(TICC, n)
        assert ours == getattr(L.codecs.icc, n)
        assert TICC.is_hdr_icc_profile(ours) == \
            JICC.is_hdr_icc_profile(ours)


# -- units: blend, Framebuffer, the animated helpers ------------------------------

def _img(h, w, c, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c),
                                                dtype=np.uint8)


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("c", [1, 3, 4])
def test_blend_channel_conversions(c):
    x = _img(5, 7, c, c)
    _eq(TB.to_bgra(torch.from_numpy(x)), JB.to_bgra(jnp.asarray(x)))
    for to in (3, 4) + ((1,) if c == 1 else ()):
        _eq(TB.to_channels(torch.from_numpy(x), to),
            JB.to_channels(jnp.asarray(x), to))
    with pytest.raises(ValueError):
        TB.to_bgra(torch.zeros((2, 2, 2), dtype=torch.uint8))


def test_blend_alpha_blend_full():
    dst, src = _img(16, 16, 4, 1), _img(16, 16, 4, 2)
    src[0, :, 3] = 0
    dst[1, :, 3] = 0
    src[1, :8, 3] = 0      # 0/0: both transparent
    src[2, :, 3] = 255
    _eq(TB.alpha_blend_full(torch.from_numpy(dst), torch.from_numpy(src)),
        JB.alpha_blend_full(jnp.asarray(dst), jnp.asarray(src)))


@pytest.mark.parametrize("dc,sc,sw,sh", [(4, 4, 5, 3), (3, 4, 5, 3),
                                         (4, 3, 9, 7), (3, 1, 5, 3)])
def test_blend_region_copies(dc, sc, sw, sh):
    """copy_to_region(_with_alpha) with channel conversion, and an
    INTER_LINEAR resize when the source is not the rect's size (5x3)."""
    dst, src = _img(10, 12, dc, 3), _img(sh, sw, sc, 4)
    args = (2, 4, 5, 3)
    _eq(TB.copy_to_region_with_alpha(torch.from_numpy(dst),
                                     torch.from_numpy(src), *args),
        JB.copy_to_region_with_alpha(jnp.asarray(dst), jnp.asarray(src),
                                     *args))
    _eq(TB.copy_to_region(torch.from_numpy(dst), torch.from_numpy(src),
                          *args),
        JB.copy_to_region(jnp.asarray(dst), jnp.asarray(src), *args))


def test_blend_clear_crop_set_color():
    x = _img(9, 11, 4, 5)
    t, j = torch.from_numpy(x), jnp.asarray(x)
    _eq(TB.clear_to_transparent(t, 3, 2, 4, 5),
        JB.clear_to_transparent(j, 3, 2, 4, 5))
    assert (t.numpy() == x).all()             # the input is not written
    _eq(TB.crop(t, 3, 2, 4, 5), JB.crop(j, 3, 2, 4, 5))
    _eq(TB.set_color(t, (1, 2, 3, 4)), JB.set_color(j, (1, 2, 3, 4)))
    _eq(TB.set_color(t[..., :3], (9, 8, 7, 6)),
        JB.set_color(j[..., :3], (9, 8, 7, 6)))


@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("src,dst", [((67, 61), (30, 17)),
                                     ((40, 30), (100, 70)),
                                     ((200, 150), (64, 64)),
                                     ((33, 90), (33, 90))])
def test_framebuffer_fit_and_resize_to(c, src, dst):
    x = _img(src[1], src[0], c, src[0] + c)
    tf = Framebuffer.from_array(x, device="cpu", duration=0.5, x_offset=3)
    jf = L.Framebuffer.from_array(x, duration=0.5, x_offset=3)
    for t, j in ((tf.fit(*dst), jf.fit(*dst)),
                 (tf.resize_to(*dst), jf.resize_to(*dst))):
        _eq(t.array, j.array)
        assert (t.duration, t.x_offset) == (0.5, 3)
        assert (t.width, t.height, t.channels) == (dst[0], dst[1], c)
    with pytest.raises(ValueError):
        Framebuffer().fit(4, 4)


def test_framebuffer_orientation_and_regions():
    x = _img(6, 9, 3, 11)
    tf = Framebuffer.from_array(torch.from_numpy(x))
    jf = L.Framebuffer.from_array(x)
    for o in range(1, 9):
        a, b = Framebuffer(tf.array), L.Framebuffer(jf.array)
        a.orientation_transform(o)
        b.orientation_transform(o)
        _eq(a.array, b.array)
    src = Framebuffer.from_array(_img(2, 3, 4, 12), device="cpu")
    tf.copy_to_offset_with_alpha_blending(src, 1, 1, 3, 2)
    jf.copy_to_offset_with_alpha_blending(
        L.Framebuffer.from_array(src.to_numpy()), 1, 1, 3, 2)
    _eq(tf.array, jf.array)
    with pytest.raises(ValueError, match="exceeds"):
        tf.copy_to_offset_no_blend(src, 8, 5, 3, 2)
    tf.create_4channel(5, 4, device="cpu")
    assert tf.array.shape == (4, 5, 4) and not tf.array.any()


def test_animated_composite_helpers_equal_jax():
    """ImageOps._fit_or_resize over two 4-channel frames of an animated
    header: blend (alpha, then none), Fit of the canvas, dispose to
    background; the port's canvas lives on the frame's device."""
    header_t = ImageHeader(width=20, height=14, channels=4, num_frames=2)
    header_j = L.ImageHeader(width=20, height=14, channels=4, num_frames=2)
    ops_t, ops_j = T.ImageOps(8192), L.ImageOps(8192)
    for k, (blend, dispose) in enumerate((
            (BlendMethod.USE_ALPHA_BLENDING,
             DisposeMethod.DISPOSE_TO_BACKGROUND_COLOR),
            (BlendMethod.NO_BLEND, DisposeMethod.NO_DISPOSE))):
        x = _img(8, 11, 4, 20 + k)
        meta = dict(x_offset=3 + k, y_offset=2, blend=blend, dispose=dispose)
        ft = Framebuffer.from_array(x, device="cpu", **meta)
        fj = L.Framebuffer.from_array(x, **meta)
        for fit in (True, False):
            ot = ops_t._fit_or_resize(ft, header_t, 12, 9, fit)
            oj = ops_j._fit_or_resize(fj, header_j, 12, 9, fit)
            _eq(ot.array, oj.array)
            assert ot.x_offset == meta["x_offset"]
        _eq(ops_t._composite.array, ops_j._composite.array)
        assert ops_t._composite.device.type == "cpu"
    ops_t.clear()
    assert ops_t._composite is None
