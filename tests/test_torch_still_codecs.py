"""The port's still decoders and encoders on the CPU against the JAX
package: JCS_RGB and CMYK/YCCK JPEG, PNG/APNG, BMP, PNM/PAM, Sun Raster,
Radiance HDR and PFM, through new_decoder / new_encoder with
device="cpu".

Every input is synthesized from a seed (PIL, or the standard-library
packers of tests/_torch_still_builders.py, which chip_smoke.py builds
its 1080p inputs with). The same bytes go through both packages; the
decoded frames (pixels, shape, header fields) and the encoded bytes must
be equal (atol 0), and so must ImageOps.transform's bytes to .jpeg, .png
and .thumbhash. The 16-bit bitfield extraction is held over all 65,536 values under the 555
and 565 masks, and the HDR encoder's exponent over all 256 values of the
largest channel.
"""

import io
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp
import lilliput_tpu as L
from lilliput_tpu.codecs import bmp as JB
from lilliput_tpu.codecs import hdr as JH
import lilliput_tpu_torch as T
from lilliput_tpu_torch.codecs import bmp as TB
from lilliput_tpu_torch.codecs import hdr as TH
from lilliput_tpu_torch.codecs import jpeg as TJ
from lilliput_tpu_torch.errors import DecodingFailedError, InvalidImageError
from lilliput_tpu_torch.framebuffer import Framebuffer
from lilliput_tpu_torch.ops import decode_kernels as DK

import _torch_still_builders as B

FIT = T.ResizeMethod.FIT


def _smooth(h, w, c, seed):
    """A smooth (h, w, c) u8 picture: 6x6 random values, bicubic up."""
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (6, 6, c), np.uint8)
    img = Image.fromarray(small[..., 0] if c == 1 else small)
    out = np.asarray(img.resize((w, h), Image.BICUBIC))
    return np.array(out.reshape(h, w, c))


def _noise(h, w, c, seed, hi=256):
    return np.random.default_rng(seed).integers(0, hi, (h, w, c))


def _frames(buf):
    """(JAX frame, port frame, JAX header, port header) of a buffer."""
    jd, td = L.new_decoder(buf), T.new_decoder(buf, device="cpu")
    jf, tf = L.Framebuffer(), Framebuffer()
    jd.decode_to(jf)
    td.decode_to(tf)
    assert tf.device.type == "cpu" and tf.array.dtype == torch.uint8
    return np.asarray(jf.array), tf.to_numpy(), jd, td


def _assert_same_decode(buf):
    a, b, jd, td = _frames(buf)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(b, a)
    jh, th = jd.header(), td.header()
    assert (th.width, th.height, th.channels, th.orientation, th.num_frames,
            th.content_length) == (jh.width, jh.height, jh.channels,
                                   jh.orientation, jh.num_frames,
                                   jh.content_length)
    assert td.description() == jd.description()
    assert td.icc() == jd.icc()
    return b


def _assert_same_transforms(buf, w=24, h=20, fmts=(".jpeg", ".png",
                                                   ".thumbhash")):
    for fmt in fmts:
        a = L.ImageOps(8192).transform(L.new_decoder(buf), L.ImageOptions(
            file_type=fmt, width=w, height=h, resize_method=FIT))
        b = T.ImageOps(8192).transform(
            T.new_decoder(buf, device="cpu"), T.ImageOptions(
                file_type=fmt, width=w, height=h, resize_method=FIT))
        assert a == b, fmt


def _encoded(ext, arr):
    """(JAX bytes, port bytes) of one frame through new_encoder(ext)."""
    a = L.new_encoder(ext).encode(L.Framebuffer.from_array(arr), {})
    b = T.new_encoder(ext).encode(Framebuffer.from_array(arr, device="cpu"),
                                  {})
    return a, b


# -- JPEG: JCS_RGB, CMYK, YCCK ---------------------------------------------------

def _pil_jpeg(img: Image.Image, **kw) -> bytes:
    bio = io.BytesIO()
    img.save(bio, "JPEG", **kw)
    return bio.getvalue()


def _as_rgb(buf: bytes) -> bytes:
    """A YCbCr JPEG whose JFIF APP0 is replaced by an Adobe APP14 with
    transform 0: the same scan, read as JCS_RGB (any subsampling)."""
    app0 = int.from_bytes(buf[4:6], "big")
    adobe = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00"
    return b"\xff\xd8" + adobe + buf[4 + app0:]


def _adobe_at(buf: bytes) -> int:
    return buf.index(b"\xff\xee\x00\x0eAdobe")


def _with_transform(buf: bytes, t: int) -> bytes:
    """The Adobe APP14 transform byte set to t (2: YCCK)."""
    b = bytearray(buf)
    b[_adobe_at(buf) + 4 + 11] = t
    return bytes(b)


def _without_adobe(buf: bytes) -> bytes:
    i = _adobe_at(buf)
    return buf[:i] + buf[i + 2 + 14:]


def _rgb_source(kind, w, h, seed):
    img = Image.fromarray(_smooth(h, w, 3, seed))
    if kind == "rgb444":
        return _pil_jpeg(img, quality=85, subsampling=0, keep_rgb=True)
    sub = {"rgb422": 1, "rgb420": 2}[kind]
    return _as_rgb(_pil_jpeg(img, quality=85, subsampling=sub))


def _cmyk_source(kind, w, h, seed):
    buf = _pil_jpeg(Image.fromarray(_smooth(h, w, 3, seed)).convert("CMYK"),
                    quality=85)
    return {"cmyk": buf, "ycck": _with_transform(buf, 2),
            "cmyk_no_adobe": _without_adobe(buf)}[kind]


JPEG_KINDS = ["rgb444", "rgb422", "rgb420", "cmyk", "ycck", "cmyk_no_adobe"]


def _jpeg_source(kind, w=67, h=61, seed=3):
    return (_rgb_source if kind.startswith("rgb") else _cmyk_source)(
        kind, w, h, seed)


@pytest.mark.parametrize("kind", JPEG_KINDS)
def test_rgb_and_cmyk_jpeg_decode_equal_jax(kind):
    buf = _jpeg_source(kind)
    want = (TJ.JCS_RGB if kind.startswith("rgb")
            else TJ.JCS_YCCK if kind == "ycck" else TJ.JCS_CMYK)
    assert TJ.read_info(buf).jpeg_color_space == want
    DK.reset_launches()
    px = _assert_same_decode(buf)
    assert not any(DK.launches.values())      # CPU: the plain versions
    assert px.shape == (61, 67, 3)


@pytest.mark.parametrize("kind", JPEG_KINDS)
def test_rgb_and_cmyk_jpeg_transforms_equal_jax(kind):
    _assert_same_transforms(_jpeg_source(kind, 45, 37, seed=11))


@pytest.mark.parametrize("kind", ["rgb444", "cmyk", "ycck"])
@pytest.mark.parametrize("size", [(8, 8), (130, 17), (17, 129)])
def test_rgb_and_cmyk_jpeg_odd_geometries_equal_jax(kind, size):
    _assert_same_decode(_jpeg_source(kind, *size, seed=size[0]))


def test_ycck_chroma_skips_the_level_shift():
    """XLA folds the JAX package's (x + 128) - 128 of the YCCK chroma to
    x; the port's centered epilogue leaves the shift out, and keeping
    the round trip would move values of this input (ROADMAP queue 3)."""
    from lilliput_tpu_torch.ops import jpeg_kernels as K
    coefs = torch.from_numpy(np.random.default_rng(5).integers(
        -400, 400, (2, 3, 4, 64)).astype(np.int16))
    qt = torch.from_numpy(TJ.scaled_qtables(50)[1].astype(np.float32))
    wq = K.fold_qtables(qt)
    shifted = DK.dequant_idct_blocks(coefs, wq)
    centered = DK.dequant_idct_blocks(coefs, wq, out="centered")
    np.testing.assert_array_equal(centered.numpy(),
                                  K.idct_folded(coefs, wq, False).numpy())
    assert ((shifted - 128.0) != centered).any()
    with pytest.raises(ValueError, match="centered"):
        DK.dequant_idct_blocks(coefs, wq, out="f16")


def test_ycck_1080p_equal_jax_and_the_round_trip_is_not(monkeypatch):
    """The 1080p CMYK fixture as YCCK (Adobe transform byte 2, the input
    of chip_smoke phase 7) decodes to the JAX package's pixels; the same
    decode keeping the chroma's (x + 128) - 128 round trip does not: it
    moves some values by 1 (ROADMAP queue 3 entry 11)."""
    from lilliput_tpu_torch.ops import jpeg_kernels as K
    with open("tests/assets/bench_1080p_cmyk.jpg", "rb") as f:
        buf = _with_transform(f.read(), 2)
    jf = L.Framebuffer()
    L.new_decoder(buf).decode_to(jf)
    want = np.asarray(jf.array)
    np.testing.assert_array_equal(_frames(buf)[1], want)
    dequant_idct = K.dequant_idct

    def round_trip(coefs, qtable, plain=False, out="f32"):
        if out == "centered":
            return dequant_idct(coefs, qtable, plain) - 128.0
        return dequant_idct(coefs, qtable, plain, out)
    monkeypatch.setattr(K, "dequant_idct", round_trip)
    tf = Framebuffer()
    T.new_decoder(buf, device="cpu").decode_to(tf)
    d = np.abs(tf.to_numpy().astype(np.int16) - want)
    assert d.max() == 1 and 0 < (d > 0).sum() < 1e-5 * d.size


def test_subsampled_cmyk_refused_as_in_jax():
    buf = _cmyk_source("cmyk", 32, 24, 1)
    info = TJ.read_info(buf)
    sof = buf.index(b"\xff\xc0")
    b = bytearray(buf)
    b[sof + 11] = 0x22          # component 1: 2x2 sampling, the rest 1x1
    b = bytes(b)
    for dec, fb in ((L.new_decoder(b), L.Framebuffer()),
                    (T.new_decoder(b, device="cpu"), Framebuffer())):
        with pytest.raises(Exception, match="subsampled CMYK"):
            dec.decode_to(fb)
    assert info.num_components == 4


# -- PNG -------------------------------------------------------------------------

#: (colour type, bit depth) of every legal PNG
PNG_TYPES = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16),
             (3, 1), (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]
_PNG_CH = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _png_samples(ct, depth, h, w, seed):
    hi = (1 << depth) if ct != 3 else min(1 << depth, 40)
    return _noise(h, w, _PNG_CH[ct], seed, hi)


def _png(ct, depth, h=19, w=23, interlace=0, seed=0, trns=False):
    s = _png_samples(ct, depth, h, w, seed)
    pal, key = None, None
    if ct == 3:
        pal = np.random.default_rng(seed + 1).integers(0, 256, (40, 3))
        if trns:
            key = bytes(np.random.default_rng(seed + 2).integers(
                0, 256, 30).astype(np.uint8))   # shorter than the palette
    elif trns:
        # the colour key of an existing sample, so some pixels match
        v = s[h // 2, w // 2]
        key = b"".join(struct.pack(">H", int(x)) for x in v)
    return B.png_bytes(s, ct, depth, interlace, pal, key,
                       filters=(0, 1, 2, 3, 4))


@pytest.mark.parametrize("interlace", [0, 1], ids=["flat", "adam7"])
@pytest.mark.parametrize("ct,depth", PNG_TYPES)
def test_png_decode_equal_jax(ct, depth, interlace):
    buf = _png(ct, depth, interlace=interlace, seed=ct * 100 + depth)
    px = _assert_same_decode(buf)
    assert px.shape[:2] == (19, 23)


@pytest.mark.parametrize("ct,depth", [(0, 2), (0, 8), (0, 16), (2, 8),
                                      (2, 16), (3, 4), (3, 8)])
def test_png_trns_equal_jax(ct, depth):
    for interlace in (0, 1):
        px = _assert_same_decode(_png(ct, depth, interlace=interlace,
                                      seed=7 + depth, trns=True))
        assert px.shape[2] == 4
        if ct != 3:
            assert (px[..., 3] == 0).any() and (px[..., 3] == 255).any()


@pytest.mark.parametrize("ct,depth", [(0, 8), (2, 8), (3, 8), (4, 8),
                                      (6, 16), (0, 1)])
def test_png_transforms_equal_jax(ct, depth):
    _assert_same_transforms(_png(ct, depth, 31, 45, seed=ct))


def test_png_odd_adam7_geometries_equal_jax():
    for h, w in ((1, 1), (1, 9), (9, 1), (5, 3), (17, 33)):
        _assert_same_decode(B.png_bytes(_noise(h, w, 3, h * w), 2, 8, 1,
                                        filters=(4, 3)))


def test_png_icc_and_trailing_bytes_equal_jax():
    from lilliput_tpu_torch.codecs import icc as TICC
    icc = TICC.SRGB_PROFILE
    base = B.png_bytes(_noise(9, 11, 3, 1), 2)
    iccp = B.png_chunk(b"iCCP", b"sRGB\x00\x00" + zlib.compress(icc))
    buf = base[:33] + iccp + base[33:] + b"trailing"
    px = _assert_same_decode(buf)
    assert T.new_decoder(buf, device="cpu").icc() == icc
    assert px.shape == (9, 11, 3)


@pytest.mark.parametrize("buf", [
    B.png_bytes(_noise(4, 4, 3, 0), 2)[:-30],                # truncated
    B.png_bytes(_noise(4, 4, 3, 0), 2).replace(b"IHDR", b"IHDX"),
    b"\x89PNG\r\n\x1a\n" + bytes(16)])
def test_png_bad_streams_raise_as_jax(buf):
    errs = []
    for new, fb in ((L.new_decoder, L.Framebuffer),
                    (lambda b: T.new_decoder(b, device="cpu"), Framebuffer)):
        try:
            new(buf).decode_to(fb())
            errs.append(None)
        except Exception as e:
            errs.append(type(e).__name__)
    assert errs[0] == errs[1] and errs[0] is not None


def _apng(ct=6):
    """A 3-frame APNG on a 21x17 canvas: a full first frame, then frames
    at offsets with each dispose and blend."""
    ch = _PNG_CH[ct]
    frames = [(_noise(17, 21, ch, 0), 0, 0, 1, 10, 1, 0),
              (_noise(7, 9, ch, 1), 3, 4, 5, 0, 0, 1),
              (_noise(5, 11, ch, 2), 10, 12, 2, 100, 2, 1)]
    return B.apng_bytes(21, 17, ct, frames)


@pytest.mark.parametrize("ct", [2, 6])
def test_apng_frames_equal_jax(ct):
    buf = _apng(ct)
    jd, td = L.new_decoder(buf), T.new_decoder(buf, device="cpu")
    assert td.is_apng and td.header().num_frames == 3
    assert td.loop_count() == jd.loop_count() == 0
    while True:
        jf, tf = L.Framebuffer(), Framebuffer()
        try:
            jd.decode_to(jf)
        except EOFError:
            with pytest.raises(EOFError):
                td.decode_to(tf)
            break
        td.decode_to(tf)
        np.testing.assert_array_equal(tf.to_numpy(), np.asarray(jf.array))
        assert (tf.duration, tf.x_offset, tf.y_offset, tf.dispose,
                tf.blend) == (jf.duration, jf.x_offset, jf.y_offset,
                              jf.dispose, jf.blend)


@pytest.mark.parametrize("ct", [2, 6])
def test_apng_transform_to_png_equal_jax(ct):
    _assert_same_transforms(_apng(ct), 15, 12, (".png", ".jpeg"))


# -- BMP -------------------------------------------------------------------------

def _pal(n, seed, gray=False):
    p = np.random.default_rng(seed).integers(0, 256, (n, 3))
    return np.repeat(p[:, :1], 3, axis=1) if gray else p


def _bmp_indexed(bpp, w, h, seed, gray=False, core=False, top_down=False):
    n = 1 << bpp
    idx = _noise(h, w, 1, seed, n)[..., 0]
    rows = B.pack_samples(idx[..., None], bpp)
    if top_down:
        return B.bmp_bytes(w, h, bpp, B.bmp_rows(rows[::-1]),
                           _pal(n, seed, gray), top_down=True)
    return B.bmp_bytes(w, h, bpp, B.bmp_rows(rows), _pal(n, seed, gray),
                       core=core)


def _bmp16(w, h, seed, masks):
    v = _noise(h, w, 1, seed, 1 << 16)[..., 0]
    rows = np.stack([v & 255, v >> 8], axis=-1).reshape(h, -1)
    return B.bmp_bytes(w, h, 16, B.bmp_rows(rows.astype(np.uint8)),
                       compression=0 if masks is None else 3, masks=masks)


def _bmp_rle4(idx):
    """RLE4 of (h, w) 4-bit indices, bottom-up: pairs as runs of two
    alternating nibbles, a chunk of 4 in absolute mode every other time."""
    out = bytearray()
    for row in idx[::-1]:
        x = 0
        while x < len(row):
            ch = row[x:x + 4]
            if len(ch) == 4 and x % 8 == 0:
                out += bytes([0, 4, ch[0] << 4 | ch[1], ch[2] << 4 | ch[3]])
            elif len(ch) >= 2:
                out += bytes([2, ch[0] << 4 | ch[1]])
                ch = ch[:2]
            else:
                out += bytes([1, ch[0] << 4])
            x += len(ch)
        out += b"\x00\x00"
    return bytes(out + b"\x00\x01")


BMP_KINDS = {
    "1bpp": lambda: _bmp_indexed(1, 37, 11, 1),
    "4bpp": lambda: _bmp_indexed(4, 37, 11, 2),
    "8bpp": lambda: _bmp_indexed(8, 37, 11, 3),
    "8bpp_gray": lambda: _bmp_indexed(8, 37, 11, 4, gray=True),
    "8bpp_core": lambda: _bmp_indexed(8, 37, 11, 5, core=True),
    "8bpp_top_down": lambda: _bmp_indexed(8, 37, 11, 6, top_down=True),
    "16bpp_555": lambda: _bmp16(37, 11, 7, None),
    "16bpp_565": lambda: _bmp16(37, 11, 8, (0xF800, 0x07E0, 0x001F)),
    "24bpp": lambda: B.bmp_bytes(37, 11, 24, B.bmp_rows(
        _noise(11, 37, 3, 9).reshape(11, -1).astype(np.uint8))),
    "32bpp": lambda: B.bmp_bytes(37, 11, 32, B.bmp_rows(
        _noise(11, 37, 4, 10).reshape(11, -1).astype(np.uint8))),
    "rle8": lambda: B.bmp_bytes(37, 11, 8, B.bmp_rle8(np.repeat(
        _noise(11, 10, 1, 11, 256)[..., 0], 4, axis=1)[:, :37].astype(
            np.uint8)), _pal(256, 11), compression=1),
    "rle4": lambda: B.bmp_bytes(37, 11, 4, _bmp_rle4(
        _noise(11, 37, 1, 12, 16)[..., 0]), _pal(16, 12), compression=2),
    "pil_rgb": lambda: _pil(Image.fromarray(_smooth(13, 29, 3, 13)), "BMP"),
    "pil_1bit": lambda: _pil(Image.fromarray(
        _smooth(13, 29, 1, 14)[..., 0]).convert("1"), "BMP"),
}


def _pil(img, fmt, **kw):
    bio = io.BytesIO()
    img.save(bio, fmt, **kw)
    return bio.getvalue()


@pytest.mark.parametrize("kind", list(BMP_KINDS))
def test_bmp_decode_equal_jax(kind):
    _assert_same_decode(BMP_KINDS[kind]())


@pytest.mark.parametrize("kind", ["8bpp", "16bpp_565", "32bpp", "rle8"])
def test_bmp_transforms_equal_jax(kind):
    _assert_same_transforms(BMP_KINDS[kind]())


@pytest.mark.parametrize("mask", [(0x7C00, 0x03E0, 0x001F),
                                  (0xF800, 0x07E0, 0x001F)],
                         ids=["555", "565"])
def test_bitfields_every_16bit_value(mask):
    """_mask_extract over all 65,536 words under each channel mask (and
    an empty and a wide mask), int64 in the port, uint32 in JAX."""
    vals = np.arange(1 << 16, dtype=np.uint32)
    for m in mask + (0, 0xFFFF, 0x0FF0):
        a = np.asarray(JB._mask_extract(jnp.asarray(vals), m))
        b = TB._mask_extract(torch.from_numpy(vals.astype(np.int64)), m)
        np.testing.assert_array_equal(b.numpy(), a)


@pytest.mark.parametrize("ext", [".bmp", ".pam", ".ras", ".sr", ".hdr",
                                 ".pfm", ".pnm", ".ppm", ".pgm", ".pbm"])
@pytest.mark.parametrize("ch", [1, 3, 4])
def test_encoders_bytes_equal_jax(ext, ch):
    arr = _noise(13, 22, ch, ch).astype(np.uint8)
    if ext in (".ppm", ".pgm", ".pbm") and (ch == 1) == (ext == ".ppm"):
        # a channel count the extension does not take
        with pytest.raises(L.DecodingFailedError):
            L.new_encoder(ext).encode(L.Framebuffer.from_array(arr), {})
        with pytest.raises(DecodingFailedError):
            T.new_encoder(ext).encode(Framebuffer.from_array(arr, "cpu"), {})
        return
    a, b = _encoded(ext, arr)
    assert a == b


@pytest.mark.parametrize("ext", [".bmp", ".pam", ".ras", ".hdr", ".pfm",
                                 ".ppm"])
def test_encoder_round_trips_equal_jax(ext):
    """Each encoder's output decodes to the same frame in both packages,
    and transforms to the same bytes."""
    arr = _smooth(23, 31, 3, 21)
    buf = T.new_encoder(ext).encode(Framebuffer.from_array(arr, "cpu"), {})
    _assert_same_decode(buf)
    _assert_same_transforms(buf)


# -- PNM / PAM -------------------------------------------------------------------

def _ascii(kind, samples, maxval=None):
    h, w, _ = samples.shape
    head = b"P%d\n# a comment\n%d %d\n" % (kind, w, h)
    if maxval is not None:
        head += b"%d\n" % maxval
    body = b"\n".join(b" ".join(b"%d" % v for v in row)
                      for row in samples.reshape(h, -1))
    return head + body + b"\n"


def _binary(kind, samples, maxval):
    h, w, _ = samples.shape
    dt = ">u2" if maxval > 255 else np.uint8
    return (b"P%d\n%d %d\n%d\n" % (kind, w, h, maxval)
            + samples.astype(dt).tobytes())


PNM_KINDS = {
    "p1": lambda: _ascii(1, _noise(7, 13, 1, 1, 2)),
    "p1_packed": lambda: b"P1\n4 2\n0110\n1001\n",
    "p2": lambda: _ascii(2, _noise(7, 13, 1, 2), 255),
    "p2_maxval100": lambda: _ascii(2, _noise(7, 13, 1, 3, 101), 100),
    "p2_16bit": lambda: _ascii(2, _noise(7, 13, 1, 4, 65536), 65535),
    "p3": lambda: _ascii(3, _noise(7, 13, 3, 5), 255),
    "p3_maxval15": lambda: _ascii(3, _noise(7, 13, 3, 6, 16), 15),
    "p4": lambda: b"P4\n13 7\n" + np.packbits(
        _noise(7, 13, 1, 7, 2)[..., 0].astype(np.uint8), axis=1).tobytes(),
    "p5": lambda: _binary(5, _noise(7, 13, 1, 8), 255),
    "p5_maxval100": lambda: _binary(5, _noise(7, 13, 1, 9, 101), 100),
    "p5_16bit": lambda: B.pnm16(_noise(7, 13, 1, 10, 65536)),
    "p6": lambda: _binary(6, _noise(7, 13, 3, 11), 255),
    "p6_16bit": lambda: B.pnm16(_noise(7, 13, 3, 12, 65536)),
    "p6_maxval1000": lambda: _binary(6, _noise(7, 13, 3, 13, 1001), 1000),
}


def _pam(depth, tupl, maxval=255, h=7, w=13, seed=0):
    s = _noise(h, w, depth, seed, maxval + 1)
    head = b"P7\n# comment\nWIDTH %d\nHEIGHT %d\nDEPTH %d\nMAXVAL %d\n" % (
        w, h, depth, maxval)
    if tupl:
        head += b"TUPLTYPE " + tupl + b"\n"
    dt = ">u2" if maxval > 255 else np.uint8
    return head + b"ENDHDR\n" + s.astype(dt).tobytes()


PAM_KINDS = {
    "gray": lambda: _pam(1, None),
    "gray_alpha": lambda: _pam(2, b"GRAYSCALE_ALPHA", seed=1),
    "rgb": lambda: _pam(3, b"RGB", seed=2),
    "rgb_alpha": lambda: _pam(4, b"RGB_ALPHA", seed=3),
    "rgb_16bit": lambda: _pam(3, None, 65535, seed=4),
    "gray_maxval7": lambda: _pam(1, b"GRAYSCALE", 7, seed=5),
}


@pytest.mark.parametrize("kind", list(PNM_KINDS))
def test_pnm_decode_equal_jax(kind):
    _assert_same_decode(PNM_KINDS[kind]())


@pytest.mark.parametrize("kind", list(PAM_KINDS))
def test_pam_decode_equal_jax(kind):
    _assert_same_decode(PAM_KINDS[kind]())


@pytest.mark.parametrize("kind", ["p2_maxval100", "p6_16bit", "p4"])
def test_pnm_transforms_equal_jax(kind):
    _assert_same_transforms(PNM_KINDS[kind]())


@pytest.mark.parametrize("kind", ["rgb", "rgb_alpha", "gray"])
def test_pam_transforms_equal_jax(kind):
    _assert_same_transforms(PAM_KINDS[kind](), fmts=(".png", ".thumbhash"))


@pytest.mark.parametrize("buf", [
    b"P6\n2 2\n255\n" + bytes(5), b"P2\n2 x\n255\n", b"P5\n0 2\n255\n",
    b"P7\nWIDTH 1\n", b"P7\nWIDTH 1\nHEIGHT 1\nDEPTH 2\nMAXVAL 255\nENDHDR\n",
    b"P3\n1 1\n255\n1 2\n"])
def test_netpbm_bad_streams_raise_as_jax(buf):
    errs = []
    for new, fb in ((L.new_decoder, L.Framebuffer),
                    (lambda b: T.new_decoder(b, device="cpu"), Framebuffer)):
        try:
            new(buf).decode_to(fb())
            errs.append(None)
        except Exception as e:
            errs.append(type(e).__name__)
    assert errs[0] == errs[1] and errs[0] is not None


# -- Sun Raster ------------------------------------------------------------------

def _ras_rows(rows):
    pad = -rows.shape[1] % 2
    return np.pad(rows.astype(np.uint8), ((0, 0), (0, pad))).tobytes()


def _ras_rle(data: bytes) -> bytes:
    """Sun byte-RLE: runs of 3+ as 0x80, n-1, v; a lone 0x80 as 0x80, 0."""
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j < len(data) and data[j] == data[i] and j - i < 255:
            j += 1
        if j - i >= 3:
            out += bytes([0x80, j - i - 1, data[i]])
        elif data[i] == 0x80:
            out += b"\x80\x00" * (j - i)
        else:
            out += data[i:j]
        i = j
    return bytes(out)


def _ras(depth, kind=1, cmap=None, w=13, h=7, seed=0):
    c = {1: 1, 8: 1, 24: 3, 32: 4}[depth]
    if depth == 1:
        rows = np.packbits(_noise(h, w, 1, seed, 2)[..., 0].astype(np.uint8),
                           axis=1)
    else:
        hi = 256 if cmap is None or depth != 8 else len(cmap)
        rows = _noise(h, w, c, seed, hi).reshape(h, -1)
    data = _ras_rows(rows)
    if kind == 2:
        data = _ras_rle(data)
    return B.sunras_bytes(w, h, depth, data, kind, cmap)


RAS_KINDS = {
    "1bit": lambda: _ras(1, seed=1),
    "1bit_map": lambda: _ras(1, cmap=_pal(2, 2), seed=2),
    "8bit": lambda: _ras(8, seed=3),
    "8bit_gray_map": lambda: _ras(8, cmap=_pal(256, 4, gray=True), seed=4),
    "8bit_color_map": lambda: _ras(8, cmap=_pal(17, 5), seed=5),
    "24bit": lambda: _ras(24, seed=6),
    "24bit_rgb": lambda: _ras(24, kind=3, seed=7),
    "32bit": lambda: _ras(32, seed=8),
    "32bit_rgb": lambda: _ras(32, kind=3, seed=9),
    "rle": lambda: _ras(8, kind=2, w=40, seed=10, cmap=_pal(3, 10)),
    "rle_24bit": lambda: B.sunras_bytes(13, 7, 24, _ras_rle(_ras_rows(
        np.repeat(_noise(7, 1, 3, 11), 13, axis=1).reshape(7, -1))), 2),
}


@pytest.mark.parametrize("kind", list(RAS_KINDS))
def test_sunras_decode_equal_jax(kind):
    _assert_same_decode(RAS_KINDS[kind]())


@pytest.mark.parametrize("kind", ["8bit_color_map", "24bit_rgb", "1bit"])
def test_sunras_transforms_equal_jax(kind):
    _assert_same_transforms(RAS_KINDS[kind]())


# -- Radiance HDR ----------------------------------------------------------------

def _hdr(rgbe, style="flat"):
    h, w = rgbe.shape[:2]
    head = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y %d +X %d\n" % (h, w)
    if style == "flat":
        return head + rgbe.astype(np.uint8).tobytes()
    out = bytearray(head)
    for row in rgbe.astype(np.uint8):
        if style == "new":
            out += bytes([2, 2, w >> 8, w & 255])
            for c in range(4):
                comp, x = row[:, c], 0
                while x < w:
                    n = 1
                    while x + n < w and comp[x + n] == comp[x] and n < 127:
                        n += 1
                    if n >= 3:
                        out += bytes([128 + n, comp[x]])
                    else:
                        n = min(w - x, 5)
                        out += bytes([n]) + comp[x:x + n].tobytes()
                    x += n
        else:  # old style: repeat the previous pixel by (1, 1, 1, count)
            out += row[0].tobytes() + bytes([1, 1, 1, w - 2]) \
                + row[w - 1].tobytes()
    return bytes(out)


def _rgbe(h, w, seed, runs=False):
    rng = np.random.default_rng(seed)
    m = rng.integers(0, 256, (h, w, 3))
    e = rng.integers(120, 140, (h, w, 1))
    e[0, 0] = 0
    if runs:
        m[:, :] = m[:, :1]
        e[:, :] = e[:, :1]
    return np.concatenate([m, e], axis=-1)


HDR_KINDS = {
    "flat": lambda: _hdr(_rgbe(9, 17, 1)),
    "new_rle": lambda: _hdr(np.repeat(_rgbe(9, 6, 2), 3, axis=1), "new"),
    "old_rle": lambda: _hdr(_rgbe(9, 17, 3, runs=True), "old"),
    "from_encoder": lambda: T.new_encoder(".hdr").encode(
        Framebuffer.from_array(_smooth(9, 17, 3, 4), "cpu"), {}),
}


@pytest.mark.parametrize("kind", list(HDR_KINDS))
def test_hdr_decode_equal_jax(kind):
    _assert_same_decode(HDR_KINDS[kind]())


def test_hdr_transforms_equal_jax():
    _assert_same_transforms(HDR_KINDS["new_rle"]())


def test_hdr_every_exponent_and_mantissa():
    """rgbe_to_u8_bgr over all 256 exponent bytes x all 256 mantissas."""
    m = np.arange(256)
    rgbe = np.stack(np.broadcast_arrays(m[None, :], m[None, ::-1],
                                        m[None, :] // 2, m[:, None]),
                    axis=-1).astype(np.uint8)
    a = np.asarray(JH.rgbe_to_u8_bgr(jnp.asarray(rgbe)))
    b = TH.rgbe_to_u8_bgr(torch.from_numpy(rgbe)).numpy()
    np.testing.assert_array_equal(b, a)


def test_hdr_encoder_every_largest_channel():
    """u8_bgr_to_rgbe's exponent depends only on the largest channel: all
    256 values of it, each with random smaller channels in every
    position (which one is largest), against the JAX package's."""
    rng = np.random.default_rng(0)
    top = np.repeat(np.arange(256), 48)
    px = (rng.random((top.size, 3)) * (top[:, None] + 1)).astype(np.int64)
    px = np.minimum(px, top[:, None])
    px[np.arange(top.size), np.arange(top.size) % 3] = top
    px = px.astype(np.uint8).reshape(64, -1, 3)
    a = np.asarray(JH.u8_bgr_to_rgbe(jnp.asarray(px)))
    b = TH.u8_bgr_to_rgbe(torch.from_numpy(px)).numpy()
    np.testing.assert_array_equal(b, a)


# -- PFM -------------------------------------------------------------------------

def _pfm(values, color, little=True):
    h, w = values.shape[:2]
    dt = "<f4" if little else ">f4"
    head = b"%s\n%d %d\n%s\n" % (b"PF" if color else b"Pf", w, h,
                                 b"-1.0" if little else b"1.0")
    return head + values.astype(dt).tobytes()


def _pfm_values(h, w, c, seed):
    v = np.random.default_rng(seed).uniform(-40, 300, (h, w, c))
    v = v.astype(np.float32)
    v.flat[:9] = [np.nan, np.inf, -np.inf, 0.5, 1.5, 2.5, 254.5, 255.5, -0.5]
    return v


@pytest.mark.parametrize("color", [True, False], ids=["PF", "Pf"])
@pytest.mark.parametrize("little", [True, False], ids=["le", "be"])
def test_pfm_decode_equal_jax(color, little):
    """Non-finite samples included: NaN decodes to 0 in both, +inf to
    255, -inf to 0; .5 ties round to even."""
    v = _pfm_values(7, 13, 3 if color else 1, int(color) * 2 + little)
    px = _assert_same_decode(_pfm(v, color, little))
    first = px[::-1].reshape(-1, px.shape[2])[:, ::-1].reshape(-1)[:9]
    assert list(first) == [0, 255, 0, 0, 2, 2, 254, 255, 0]


def test_pfm_transforms_equal_jax():
    _assert_same_transforms(_pfm(_pfm_values(23, 31, 3, 9), True))


# -- dispatch --------------------------------------------------------------------

PORTED = {"png": lambda: _png(2, 8), "bmp": BMP_KINDS["24bpp"],
          "pnm": PNM_KINDS["p6"], "pam": PAM_KINDS["rgb"],
          "sunras": RAS_KINDS["24bit"], "hdr": HDR_KINDS["flat"],
          "pfm": lambda: _pfm(_pfm_values(3, 4, 3, 0), True),
          "rgb_jpeg": lambda: _jpeg_source("rgb444"),
          "cmyk_jpeg": lambda: _jpeg_source("cmyk"),
          "ycck_jpeg": lambda: _jpeg_source("ycck")}


@pytest.mark.parametrize("name", list(PORTED))
def test_new_decoder_dispatches_every_ported_still(name):
    buf = PORTED[name]()
    td = T.new_decoder(buf, device="cpu")
    assert type(td).__name__ == type(L.new_decoder(buf)).__name__
    assert td.device.type == "cpu"


def test_decoders_without_a_card_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for name in ("png", "bmp", "pnm", "pam", "sunras", "hdr", "pfm"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.new_decoder(PORTED[name]())


def test_header_only_decoders_refuse_what_jax_refuses():
    for buf in (b"BM" + bytes(10), b"#?RADIANCE\n\n-Y 2 -X 2\n",
                b"PF\n1 1\n0\n", b"\x59\xa6\x6a\x95" + bytes(28)):
        with pytest.raises(L.InvalidImageError):
            L.new_decoder(buf)
        with pytest.raises(InvalidImageError):
            T.new_decoder(buf, device="cpu")
