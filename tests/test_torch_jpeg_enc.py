"""The port's JPEG entropy encoder (csrc/host/jpeg_enc.cpp,
lpt_jpeg_encode_coefs) against libjpeg: byte for byte the JAX package's
lp_jpeg_encode_coefs (lilliput_tpu.binding) and the port's own copy of
jpeg_shim.cpp (binding.load_jpeg), for every option.

* The matrix: 4:2:0, 4:2:2, 4:4:0, 4:4:4 and gray; 1x1, 8x8, 17x33, 67x61,
  130x17, 24x129 and 256x256; q30, q85 and q100; progressive, optimize and
  restart rows 0, 1 and 3, alone and together; coefficients from a seed,
  sparse, dense, all zero and at +-1023.
* ICC profiles of one chunk and of several, 16-bit tables, a restart
  interval that clamps at 65535, and the EOB-run limit (0x7FFF) of an
  all-zero 1024x2048 gray image.
* Every output decodes through the port's Huffman decoder (jpeg_huff.cpp)
  to the coefficients it was made from.
* Out-of-range coefficients: -1 where libjpeg fails; -1 too in a baseline,
  non-optimized scan, where libjpeg writes codes its tables lack.
"""

import ctypes
import itertools

import numpy as np
import pytest

from lilliput_tpu import binding as jax_binding
from lilliput_tpu_torch import binding
from lilliput_tpu_torch.codecs import jpeg as TJ

_i16p = ctypes.POINTER(ctypes.c_int16)
_u16p = ctypes.POINTER(ctypes.c_uint16)
_u8p = ctypes.POINTER(ctypes.c_uint8)

LAYOUTS = {"420": ([2, 1, 1], [2, 1, 1]), "422": ([2, 1, 1], [1, 1, 1]),
           "440": ([1, 1, 1], [2, 1, 1]), "444": ([1, 1, 1], [1, 1, 1]),
           "gray": ([1], [1])}
GEOMETRIES = [(1, 1), (8, 8), (17, 33), (67, 61), (130, 17), (24, 129),
              (256, 256)]
#: (progressive, optimize, restart rows): each alone and together
OPTIONS = list(itertools.product((0, 1), (0, 1), (0, 1, 3)))
KINDS = ("sparse", "dense", "zero", "max")


def _coefs(rng, bh, bw, kind):
    if kind == "zero":
        return np.zeros((bh, bw, 64), np.int16)
    if kind == "max":
        return rng.choice(np.array([-1023, 1023, 0, 0, 1, -1], np.int16),
                          (bh, bw, 64))
    c = rng.integers(-200, 200, (bh, bw, 64)).astype(np.int16)
    c[rng.random(c.shape) < (0.9 if kind == "sparse" else 0.2)] = 0
    c[..., 0] = rng.integers(-400, 400, (bh, bw))
    return c


def _components(rng, w, h, hs, vs, kind):
    hmax, vmax = max(hs), max(vs)
    return [_coefs(rng, -(-h * v // (8 * vmax)), -(-w * hh // (8 * hmax)),
                   kind) for hh, v in zip(hs, vs)]


def _encode(fn, w, h, comps, hs, vs, ql, qc, opts, icc=b""):
    """fn's bytes (or its negative return code) for these arguments."""
    out = np.empty(w * h * 8 + len(icc) + (1 << 16), np.uint8)
    nc = len(comps)
    icc_arr = np.frombuffer(icc, np.uint8) if icc else None
    n = fn(w, h, nc, (ctypes.c_int32 * nc)(*hs), (ctypes.c_int32 * nc)(*vs),
           (_i16p * nc)(*[c.ctypes.data_as(_i16p) for c in comps]),
           ql.ctypes.data_as(_u16p), qc.ctypes.data_as(_u16p), *opts,
           icc_arr.ctypes.data_as(_u8p) if icc else None, len(icc),
           out.ctypes.data_as(_u8p), out.size)
    return out[:n].tobytes() if n > 0 else n


def _three(w, h, comps, hs, vs, ql, qc, opts, icc=b""):
    """(JAX package's libjpeg, the port's libjpeg copy, the port's encoder)."""
    return tuple(_encode(fn, w, h, comps, hs, vs, ql, qc, opts, icc)
                 for fn in (jax_binding.load().lp_jpeg_encode_coefs,
                            binding.load_jpeg().lp_jpeg_encode_coefs,
                            binding.load().lpt_jpeg_encode_coefs))


def _decodes_back(buf, comps, ql, qc):
    """buf decodes through jpeg_huff.cpp to comps and its tables."""
    outs = [np.full_like(c, 7) for c in comps]
    qt = np.zeros((4, 64), np.uint16)
    arr = np.frombuffer(buf, np.uint8)
    rc = binding.load().lp_jpeg_decode_coefs_fast(
        arr.ctypes.data_as(_u8p), arr.size,
        (_i16p * len(outs))(*[o.ctypes.data_as(_i16p) for o in outs]),
        qt.ctypes.data_as(_u16p), 1)
    assert rc == 0
    for o, c in zip(outs, comps):
        np.testing.assert_array_equal(o, c)
    np.testing.assert_array_equal(qt[0], ql)
    if len(comps) > 1:
        np.testing.assert_array_equal(qt[1], qc)


@pytest.mark.parametrize("geom", GEOMETRIES, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_encode_coefs_byte_identical_to_libjpeg(layout, geom):
    w, h = geom
    hs, vs = LAYOUTS[layout]
    rng = np.random.default_rng(w * 1000 + h)
    for q, kind in itertools.product((30, 85, 100), KINDS):
        comps = _components(rng, w, h, hs, vs, kind)
        ql, qc = TJ.scaled_qtables(q)
        for opts in OPTIONS:
            ref, copy, got = _three(w, h, comps, hs, vs, ql, qc, opts)
            assert isinstance(ref, bytes)
            assert got == ref == copy, (q, kind, opts)
            assert got[:2] == b"\xff\xd8" and got[-2:] == b"\xff\xd9"
            assert (b"\xff\xc2" in got) == bool(opts[0])
            _decodes_back(got, comps, ql, qc)


@pytest.mark.parametrize("opts", OPTIONS, ids=lambda o: "p%do%dr%d" % o)
def test_icc_and_wide_tables_byte_identical(opts):
    """ICC profiles of one APP2 chunk and of three, and a 16-bit table
    (SOF1 in a sequential scan, SOF2 when progressive)."""
    rng = np.random.default_rng(5)
    hs, vs = LAYOUTS["420"]
    comps = _components(rng, 40, 24, hs, vs, "dense")
    ql, qc = TJ.scaled_qtables(75)
    for icc in (b"tiny profile", bytes(rng.integers(0, 256, 150000,
                                                     np.uint8))):
        ref, copy, got = _three(40, 24, comps, hs, vs, ql, qc, opts, icc)
        assert got == ref == copy
        assert TJ.read_icc(got) == icc
    wide = ql.copy()
    wide[3] = 300
    ref, copy, got = _three(40, 24, comps, hs, vs, wide, qc, opts)
    assert got == ref == copy
    assert (b"\xff\xc2" if opts[0] else b"\xff\xc1") in got
    _decodes_back(got, comps, wide, qc)


@pytest.mark.parametrize("progressive", [0, 1])
def test_restart_interval_clamps_at_65535(progressive):
    """65500 wide, one component: 9 rows of 8188 blocks is 73692 MCUs, so
    each scan's DRI holds 65535."""
    rng = np.random.default_rng(11)
    comps = _components(rng, 65500, 16, [1], [1], "sparse")
    ql, qc = TJ.scaled_qtables(85)
    for optimize in (0, 1):
        opts = (progressive, optimize, 9)
        ref, copy, got = _three(65500, 16, comps, [1], [1], ql, qc, opts)
        assert got == ref == copy
        assert b"\xff\xdd\x00\x04\xff\xff" in got
        _decodes_back(got, comps, ql, qc)


def test_eobrun_limit_on_a_zero_gray_image():
    """32768 all-zero blocks: every AC scan's EOB run reaches 0x7FFF and is
    forced out once before the scan ends."""
    comps = [np.zeros((256, 128, 64), np.int16)]
    ql, qc = TJ.scaled_qtables(85)
    for opts in OPTIONS:
        ref, copy, got = _three(1024, 2048, comps, [1], [1], ql, qc, opts)
        assert got == ref == copy, opts
        _decodes_back(got, comps, ql, qc)


def test_out_of_range_coefficients():
    rng = np.random.default_rng(3)
    hs, vs = LAYOUTS["420"]
    ql, qc = TJ.scaled_qtables(85)
    for value, pos in itertools.product((1500, 2048, -4096, 32767), (0, 5)):
        comps = _components(rng, 32, 32, hs, vs, "dense")
        comps[0][0, 0, pos] = value
        for opts in ((0, 1, 0), (1, 0, 0), (1, 1, 1)):
            ref, copy, got = _three(32, 32, comps, hs, vs, ql, qc, opts)
            assert got == ref == copy, (value, pos, opts)
        if value != 1500 or pos:
            assert _three(32, 32, comps, hs, vs, ql, qc, (0, 0, 0))[2] == -1


def test_encode_coefs_helper_and_threads():
    """codecs/jpeg.encode_coefs (what JpegEncoder, the serving fronts and
    synthetic_jpeg call) writes lpt_jpeg_encode_coefs's bytes, the same
    from 8 threads at once as from one."""
    from concurrent.futures import ThreadPoolExecutor
    rng = np.random.default_rng(8)
    hs, vs = LAYOUTS["420"]
    ql, qc = TJ.scaled_qtables(85)
    imgs = [_components(rng, 67, 61, hs, vs, "dense") for _ in range(16)]
    opts = [(i % 2, (i // 2) % 2, i % 3) for i in range(16)]
    want = [_three(67, 61, c, hs, vs, ql, qc, o)[0]
            for c, o in zip(imgs, opts)]
    with ThreadPoolExecutor(8) as ex:
        got = list(ex.map(lambda a: TJ.encode_coefs(
            67, 61, a[0], hs, vs, ql, qc, *a[1]), zip(imgs, opts)))
    assert got == want
    with pytest.raises(TJ.DecodingFailedError, match="encode failed"):
        TJ.encode_coefs(67, 61, imgs[0], hs, vs, ql, qc,
                        out=np.empty(16, np.uint8))
