"""Host stages of the port against the JAX package's libjpeg-backed ones.

The port runs where libjpeg is absent, so it parses JPEG headers in Python
(codecs/jpeg.read_info), scales tables in Python (scaled_qtables) and
Huffman-encodes with its own encoder (csrc/host/jpeg_enc.cpp,
lpt_jpeg_encode_coefs). Each is held here to EXACT equality with the
libjpeg call it replaces: lp_jpeg_get_info field for field,
lp_jpeg_scale_qtable value for value, and lp_jpeg_encode_coefs(progressive=0,
optimize=0, restart=0) byte for byte (tests/test_torch_jpeg_enc.py holds
the other options).
"""

import ctypes
import io

import numpy as np
import pytest

from lilliput_tpu import binding as jax_binding
from lilliput_tpu.codecs import jpeg as JJ
from lilliput_tpu_torch import binding
from lilliput_tpu_torch.codecs import jpeg as TJ
from lilliput_tpu_torch.errors import DecodingFailedError

PIL = pytest.importorskip("PIL.Image")

FIELDS = [f for f, _ in TJ._JpegInfo._fields_]
_i16p = ctypes.POINTER(ctypes.c_int16)
_u16p = ctypes.POINTER(ctypes.c_uint16)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def _ref_info(buf: bytes):
    lib = jax_binding.load()
    arr = np.frombuffer(buf, np.uint8)
    info = JJ._JpegInfo()
    rc = lib.lp_jpeg_get_info(arr.ctypes.data_as(_u8p), arr.size,
                              ctypes.byref(info))
    return None if rc != 0 else info


def _fields(info):
    return {f: (list(getattr(info, f)) if isinstance(getattr(info, f),
                                                     ctypes.Array)
                else getattr(info, f)) for f in FIELDS}


def _pil_jpeg(w, h, mode="RGB", seed=0, **kw):
    rng = np.random.default_rng(seed)
    ch = {"RGB": 3, "L": 1, "CMYK": 4}[mode]
    small = rng.integers(0, 256, (6, 6, ch), np.uint8)
    img = PIL.fromarray(small[..., 0] if ch == 1 else small, mode)
    img = img.resize((w, h), PIL.BICUBIC)
    bio = io.BytesIO()
    img.save(bio, "JPEG", **kw)
    return bio.getvalue()


def _strip_app0_set_ids(buf: bytes, ids) -> bytes:
    """Drop the JFIF APP0 segment and rewrite the component ids of the SOF
    and SOS headers."""
    b = bytearray(buf)
    assert b[2:4] == b"\xff\xe0"
    seglen = int.from_bytes(b[4:6], "big")
    del b[2:4 + seglen]
    i = b.index(b"\xff\xc0")
    j = b.index(b"\xff\xda")
    for c, cid in enumerate(ids):
        b[i + 10 + 3 * c] = cid
        b[j + 5 + 2 * c] = cid
    return bytes(b)


def _header_cases():
    with open("tests/assets/bench_1080p.jpg", "rb") as f:
        bench = f.read()
    icc = bytes(range(256)) * 300          # 76.8 kB: two APP2 chunks
    cases = {
        "bench_1080p": bench,
        "420": _pil_jpeg(200, 150, subsampling=2),
        "422": _pil_jpeg(67, 61, subsampling=1),
        "444": _pil_jpeg(33, 17, subsampling=0, quality=95),
        "progressive": _pil_jpeg(130, 17, progressive=True),
        "gray": _pil_jpeg(24, 129, mode="L"),
        "cmyk_adobe": _pil_jpeg(40, 30, mode="CMYK"),
        "icc": _pil_jpeg(64, 48, icc_profile=icc),
        "rgb_ids": _strip_app0_set_ids(_pil_jpeg(32, 32), b"RGB"),
        "ycc_ids_no_jfif": _strip_app0_set_ids(_pil_jpeg(32, 32), b"\1\2\3"),
    }
    cv2 = pytest.importorskip("cv2")
    img = np.random.default_rng(3).integers(0, 256, (48, 80, 3), np.uint8)
    ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_RST_INTERVAL, 2])
    cases["restart"] = enc.tobytes()
    return cases


def test_read_info_matches_lp_jpeg_get_info():
    """Every field of every header equals lp_jpeg_get_info's."""
    for name, buf in _header_cases().items():
        ref = _ref_info(buf)
        assert ref is not None, name
        assert _fields(TJ.read_info(buf)) == _fields(ref), name


def test_read_info_fails_where_libjpeg_fails():
    """Malformed and truncated headers: the port fails exactly where
    lp_jpeg_get_info fails, and agrees on every field where it succeeds."""
    base = _header_cases()["420"]
    sos = base.index(b"\xff\xda")
    bufs = [b"", b"\xff", b"\xff\xd8", b"\xff\xd8\xff\xd9",
            b"\xff\xd8\xff\xe0garbage", b"not a jpeg at all",
            base.replace(b"\xff\xc0", b"\xff\xc3", 1),      # lossless SOF
            base[:sos] + base[2:],                           # two SOFs
            base.replace(b"\xff\xdd", b"\xff\xc8", 1)]
    bufs += [base[:k] for k in range(0, sos + 20, 7)]
    for k, buf in enumerate(bufs):
        ref = _ref_info(buf)
        if ref is None:
            with pytest.raises(DecodingFailedError):
                TJ.read_info(buf)
        else:
            assert _fields(TJ.read_info(buf)) == _fields(ref), k


@pytest.mark.parametrize("q", range(1, 101))
def test_scaled_qtables_match_libjpeg(q):
    lt, ct = TJ.scaled_qtables(q)
    lj, cj = JJ.scaled_qtables(q)
    np.testing.assert_array_equal(lt, lj)
    np.testing.assert_array_equal(ct, cj)
    assert lt.dtype == lj.dtype == np.uint16


def _random_coefs(rng, bh, bw, sparsity=0.7):
    c = rng.integers(-200, 200, (bh, bw, 64)).astype(np.int16)
    c[rng.random(c.shape) < sparsity] = 0
    c[..., 0] = rng.integers(-400, 400, (bh, bw))
    c[..., 60:] = 0                                   # long zero runs -> EOB
    c[:, :, 5] = rng.integers(-1023, 1024, (bh, bw))  # widest AC category
    return c


def _encode_both(w, h, comps, hs, vs, ql, qc, icc=b""):
    out_j = np.empty(w * h * 8 + len(icc) + (1 << 16), np.uint8)
    out_t = np.empty_like(out_j)
    nc = len(comps)
    ptrs = (_i16p * nc)(*[c.ctypes.data_as(_i16p) for c in comps])
    hsa = (ctypes.c_int32 * nc)(*hs)
    vsa = (ctypes.c_int32 * nc)(*vs)
    icc_arr = np.frombuffer(icc, np.uint8) if icc else None
    icc_p = icc_arr.ctypes.data_as(_u8p) if icc else None
    nj = jax_binding.load().lp_jpeg_encode_coefs(
        w, h, nc, hsa, vsa, ptrs, ql.ctypes.data_as(_u16p),
        qc.ctypes.data_as(_u16p), 0, 0, 0, icc_p, len(icc),
        out_j.ctypes.data_as(_u8p), out_j.size)
    nt = binding.load().lpt_jpeg_encode_coefs(
        w, h, nc, hsa, vsa, ptrs, ql.ctypes.data_as(_u16p),
        qc.ctypes.data_as(_u16p), 0, 0, 0, icc_p, len(icc),
        out_t.ctypes.data_as(_u8p), out_t.size)
    return out_j[:nj].tobytes(), out_t[:nt].tobytes()


@pytest.mark.parametrize("w,h,sub", [
    (256, 256, "420"), (67, 61, "420"), (8, 8, "420"), (17, 33, "420"),
    (130, 17, "422"), (24, 129, "444"), (40, 30, "gray")])
def test_baseline_encoder_byte_identical(w, h, sub):
    rng = np.random.default_rng(w * 1000 + h)
    hs, vs = {"420": ([2, 1, 1], [2, 1, 1]), "422": ([2, 1, 1], [1, 1, 1]),
              "444": ([1, 1, 1], [1, 1, 1]), "gray": ([1], [1])}[sub]
    hmax, vmax = max(hs), max(vs)
    comps = [_random_coefs(rng, -(-h * v // (8 * vmax)),
                           -(-w * hh // (8 * hmax)))
             for hh, v in zip(hs, vs)]
    for q in (30, 85, 100):
        ql, qc = TJ.scaled_qtables(q)
        ref, got = _encode_both(w, h, comps, hs, vs, ql, qc)
        assert len(ref) > 0
        assert got == ref, (sub, q)


def test_baseline_encoder_icc_and_wide_tables():
    """ICC profiles (one chunk, and more than one APP2 chunk) and 16-bit
    quant tables (SOF1) are written byte-identically too."""
    rng = np.random.default_rng(5)
    comps = [_random_coefs(rng, 4, 4), _random_coefs(rng, 2, 2),
             _random_coefs(rng, 2, 2)]
    ql, qc = TJ.scaled_qtables(75)
    for icc in (b"tiny profile", bytes(rng.integers(0, 256, 150000,
                                                     np.uint8))):
        ref, got = _encode_both(32, 32, comps, [2, 1, 1], [2, 1, 1], ql, qc,
                                icc)
        assert got == ref
    wide = ql.copy()
    wide[3] = 300
    ref, got = _encode_both(32, 32, comps, [2, 1, 1], [2, 1, 1], wide, qc)
    assert got == ref and b"\xff\xc1" in got


def test_encoded_stream_decodes_to_same_coefficients():
    """Round trip through the port's own Huffman decoder."""
    rng = np.random.default_rng(9)
    comps = [_random_coefs(rng, 6, 8), _random_coefs(rng, 3, 4),
             _random_coefs(rng, 3, 4)]
    ql, qc = TJ.scaled_qtables(85)
    _, buf = _encode_both(64, 48, comps, [2, 1, 1], [2, 1, 1], ql, qc)
    outs = [np.zeros_like(c) for c in comps]
    qt = np.zeros((4, 64), np.uint16)
    arr = np.frombuffer(buf, np.uint8)
    rc = binding.load().lp_jpeg_decode_coefs_fast(
        arr.ctypes.data_as(_u8p), arr.size,
        (_i16p * 3)(*[o.ctypes.data_as(_i16p) for o in outs]),
        qt.ctypes.data_as(_u16p), 1)
    assert rc == 0
    for o, c in zip(outs, comps):
        np.testing.assert_array_equal(o, c)
    np.testing.assert_array_equal(qt[0], ql)
    np.testing.assert_array_equal(qt[1], qc)


def test_host_decoder_source_is_the_jax_packages():
    """The port builds its Huffman decoder from its own copy of
    jpeg_huff.cpp; the copy must stay byte-identical to the JAX package's,
    so the two packages decode every stream alike."""
    import os
    ours = os.path.join("lilliput_tpu_torch", "csrc", "host", "jpeg_huff.cpp")
    theirs = os.path.join("lilliput_tpu", "native", "src", "jpeg_huff.cpp")
    assert ours in binding.HOST_SOURCES[0]
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("name,sources", [
    ("yuv_bgr.cpp", binding.HOST_SOURCES),
    ("avformat_shim.cpp", binding.AVFORMAT_SOURCES)])
def test_avif_host_sources_are_the_jax_packages(name, sources):
    """AVIF's host sources are copies: yuv_bgr.cpp (the libyuv-exact row
    kernel, in the host library) and avformat_shim.cpp (dav1d and libaom
    through ffmpeg, a library of its own), byte-identical to the JAX
    package's, so both packages decode and encode alike."""
    import os
    ours = [s for s in sources if os.path.basename(s) == name]
    assert len(ours) == 1
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(ours[0], "rb") as f, open(os.path.join(
            root, "lilliput_tpu", "native", "src", name), "rb") as g:
        assert f.read() == g.read()
