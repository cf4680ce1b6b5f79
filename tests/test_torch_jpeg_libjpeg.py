"""The port's libjpeg route on the CPU against the JAX package's: the
decode of the JPEG streams jpeg_huff.cpp declines, through the port's copy
of jpeg_shim.cpp (binding.load_jpeg).

* The copy is byte-identical to the JAX package's jpeg_shim.cpp.
* Declined streams (baseline and progressive scans cut at several points,
  grayscale too, a missing DQT, an MCU of 12 blocks): JpegDecoder's
  coefficients and tables, and ImageOps' bytes, equal the JAX package's;
  where the JAX package fails, the port fails alike.
* JpegTranscodePipeline.decode_entropy over batches that mix them with
  good streams, in window mode, whole-frame (EXIF-oriented), dct_scale=2
  and grayscale, with errors=: the arrays, tables and failed slots equal
  the JAX package's.
* LILLIPUT_JPEG_HUFF=libjpeg, and the restart-marker slicer at intra > 1,
  equal the JAX package, and the slicer is the route taken.
* With binding.JPEG_HEADER pointing nowhere (the H100 machine's case) each
  libjpeg call raises HostLibraryMissingError, in its own slot under
  errors=, while every JPEG encode option still works.
"""

import os

import numpy as np
import pytest

import lilliput_tpu as L
from lilliput_tpu import pipeline as JP
from lilliput_tpu.codecs import jpeg as JJ
import lilliput_tpu_torch as T
from lilliput_tpu_torch import binding
from lilliput_tpu_torch.codecs import jpeg as TJ
from lilliput_tpu_torch.errors import HostLibraryMissingError
from lilliput_tpu_torch.framebuffer import (JPEG_OPTIMIZE, JPEG_PROGRESSIVE,
                                            JPEG_RST_INTERVAL)

from _torch_parity import gray_jpeg, layout_jpeg, with_orientation

FIT = T.ResizeMethod.FIT
CUTS = (0.35, 0.6, 0.85)


def _cut(buf, frac):
    return buf[:int(len(buf) * frac)]


def _drop_dqt(buf):
    """buf without its DQT segments: libjpeg fails at the first scan."""
    out, i = bytearray(buf[:2]), 2
    while buf[i + 1] != 0xDA:
        n = 2 + int.from_bytes(buf[i + 2:i + 4], "big")
        if buf[i + 1] != 0xDB:
            out += buf[i:i + n]
        i += n
    return bytes(out + buf[i:])


def _big_mcu(buf):
    """A 4:4:4 stream whose SOF says 2x2 for every component: 12 blocks
    per MCU, more than libjpeg's 10."""
    i = buf.index(b"\xff\xc0")
    b = bytearray(buf)
    for c in range(3):
        b[i + 11 + 3 * c] = 0x22
    return bytes(b)


def _declined():
    base = layout_jpeg(96, 72, 85, 1, "420")
    prog = layout_jpeg(96, 72, 85, 2, "420", progressive=True)
    gray = gray_jpeg(96, 72, 85, 3)
    items = {f"base{c}": _cut(base, c) for c in CUTS}
    items.update({f"prog{c}": _cut(prog, c) for c in CUTS})
    items.update({"gray0.5": _cut(gray, 0.5), "no_dqt": _drop_dqt(base),
                  "big_mcu": _big_mcu(layout_jpeg(96, 72, 85, 4, "444"))})
    return items


DECLINED = _declined()


def _outcome(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 — compared across packages
        return type(e).__name__


def test_jpeg_shim_copy_is_the_jax_packages():
    ours = os.path.join("lilliput_tpu_torch", "csrc", "host", "jpeg_shim.cpp")
    theirs = os.path.join("lilliput_tpu", "native", "src", "jpeg_shim.cpp")
    assert binding.JPEG_SOURCES[0].endswith(ours)
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    assert not any("jpeg_shim" in s for s in binding.HOST_SOURCES)


class _Counting:
    """binding.load_jpeg's library, counting the calls of each entry."""

    def __init__(self, lib, calls):
        self._lib, self._calls = lib, calls

    def __getattr__(self, name):
        fn = getattr(self._lib, name)

        def call(*a):
            rc = fn(*a)
            self._calls.append((name, rc))
            return rc
        return call


def _count_libjpeg(monkeypatch):
    """The list of (entry, return code) of the port's libjpeg calls."""
    real = binding.load_jpeg
    calls = []
    monkeypatch.setattr(binding, "load_jpeg",
                        lambda: _Counting(real(), calls))
    return calls


def _coefs(dec):
    dec._decode_coefs_cached()
    return [c.copy() for c in dec._coefs], dec._qtables.copy()


@pytest.mark.parametrize("name", list(DECLINED))
def test_decoder_on_declined_streams_equals_jax(name, monkeypatch):
    buf = DECLINED[name]
    calls = _count_libjpeg(monkeypatch)
    want = _outcome(lambda: _coefs(L.new_decoder(buf)))
    got = _outcome(lambda: _coefs(T.new_decoder(buf, device="cpu")))
    assert [n for n, _ in calls] == ["lp_jpeg_decode_coefs"]  # declined
    if isinstance(want, str):
        assert got == want
        return
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[1], want[1])
    opts = dict(file_type=".png", width=40, height=30, resize_method=FIT)
    a = L.ImageOps(8192).transform(L.new_decoder(buf), L.ImageOptions(**opts))
    b = T.ImageOps(8192).transform(T.new_decoder(buf, device="cpu"),
                                   T.ImageOptions(**opts))
    assert a == b


def _decode_both(bufs, dst=(40, 30), workers=None, **kw):
    jp = JP.JpegTranscodePipeline(bufs[0], *dst, quality=85, **kw)
    tp = T.JpegTranscodePipeline(bufs[0], *dst, quality=85, device="cpu",
                                 **kw)
    je, te = {}, {}
    want = jp.decode_entropy(bufs, workers=workers, errors=je)
    got = tp.decode_entropy(bufs, workers=workers, errors=te)
    assert sorted(te) == sorted(je)
    assert [type(te[i]).__name__ for i in sorted(te)] == [
        type(je[i]).__name__ for i in sorted(je)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g, np.float32),
                                      np.asarray(w, np.float32))
    return tp, te


def _mixed(sub, seed, oriented=False):
    good = layout_jpeg(96, 72, 85, seed, sub)
    prog = layout_jpeg(96, 72, 85, seed + 1, sub, progressive=True)
    bufs = [good, _cut(prog, 0.5), _cut(good, 0.4), prog, _cut(good, 0.8),
            good[:90]]
    if oriented:
        bufs = [with_orientation(b, 6) for b in bufs]
    return bufs


@pytest.mark.parametrize("mode", ["window", "whole", "dct_scale2", "gray",
                                  "window422"])
def test_pipeline_decode_entropy_equals_jax(mode):
    if mode == "gray":
        good = gray_jpeg(96, 72, 85, 5)
        bufs = [good, _cut(good, 0.5), good, _cut(good, 0.3), good[:80]]
        kw = {}
    elif mode == "dct_scale2":
        bufs, kw = _mixed("420", 6), {"chroma_mode": "direct",
                                      "dct_scale": 2}
    else:
        bufs, kw = _mixed("422" if mode == "window422" else "420", 7,
                          oriented=mode == "whole"), {}
    tp, errs = _decode_both(bufs, workers=1, **kw)
    assert (tp.window_static is None) == (mode == "whole")
    assert sorted(errs) == [len(bufs) - 1]          # the header cut alone
    _decode_both(bufs, workers=4, **kw)             # threaded, intra 1


def _dri_jpeg(w, h, seed, rows):
    """A 4:2:0 JPEG with a restart marker every `rows` MCU rows, written
    by the port's encoder from a PIL source's coefficients."""
    d = T.new_decoder(layout_jpeg(w, h, 85, seed, "420"), device="cpu")
    comps, qt = _coefs(d)
    return TJ.encode_coefs(w, h, comps, [2, 1, 1], [2, 1, 1], qt[0], qt[1],
                           restart_rows=rows)


def test_libjpeg_route_and_restart_slicer_equal_jax(monkeypatch):
    calls = _count_libjpeg(monkeypatch)
    monkeypatch.setenv("LILLIPUT_JPEG_HUFF", "libjpeg")
    assert not TJ.use_fast_huff() and not JJ.use_fast_huff()
    dri = [_dri_jpeg(96, 72, s, 1) for s in (8, 9)]
    bufs = dri + [layout_jpeg(96, 72, 85, 10, "420"), _cut(dri[0], 0.6)]
    _decode_both(bufs, workers=1)
    assert {n for n, _ in calls} == {"lp_jpeg_decode_coefs"}
    calls.clear()
    _decode_both(dri, workers=8)                    # intra 4: the slicer
    assert calls == [("lp_jpeg_decode_coefs_parallel", 0)] * 2
    for buf in bufs:
        want = _outcome(lambda: _coefs(L.new_decoder(buf)))
        got = _outcome(lambda: _coefs(T.new_decoder(buf, device="cpu")))
        for a, b in zip(got[0], want[0]):
            np.testing.assert_array_equal(a, b)
    monkeypatch.setenv("LILLIPUT_JPEG_INTRA_WORKERS", "4")
    calls.clear()
    want = _coefs(L.new_decoder(dri[1]))
    got = _coefs(T.new_decoder(dri[1], device="cpu"))
    assert calls == [("lp_jpeg_decode_coefs_parallel", 0)]
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[1], want[1])


def test_without_libjpeg_each_libjpeg_call_raises(monkeypatch):
    """The H100 machine's case: no jpeglib.h. The declined stream and the
    forced libjpeg route raise HostLibraryMissingError; the fast decoder's
    streams and every encode option need no libjpeg."""
    monkeypatch.setattr(binding, "JPEG_HEADER", "/nonexistent/jpeglib.h")
    with pytest.raises(HostLibraryMissingError, match="libjpeg"):
        binding.load_jpeg()
    good = layout_jpeg(96, 72, 85, 11, "420")
    cut = _cut(good, 0.5)
    with pytest.raises(HostLibraryMissingError):
        _coefs(T.new_decoder(cut, device="cpu"))
    pipe = T.JpegTranscodePipeline(good, 40, 30, optimize_coding=True,
                                   device="cpu")
    outs = pipe.transcode([good, cut, good], return_exceptions=True)
    assert isinstance(outs[1], HostLibraryMissingError)
    assert outs[0] == outs[2] and outs[0][:2] == b"\xff\xd8"
    monkeypatch.setenv("LILLIPUT_JPEG_HUFF", "libjpeg")
    with pytest.raises(HostLibraryMissingError):
        _coefs(T.new_decoder(good, device="cpu"))
    monkeypatch.delenv("LILLIPUT_JPEG_HUFF")
    d = T.new_decoder(good, device="cpu")
    for opts in ({JPEG_PROGRESSIVE: 1}, {JPEG_OPTIMIZE: 1},
                 {JPEG_RST_INTERVAL: 2},
                 {JPEG_PROGRESSIVE: 1, JPEG_OPTIMIZE: 1,
                  JPEG_RST_INTERVAL: 1}):
        out = T.ImageOps(8192).transform(d, T.ImageOptions(
            file_type=".jpg", width=40, height=30, resize_method=FIT,
            encode_options=opts))
        assert out[:2] == b"\xff\xd8"
        d = T.new_decoder(good, device="cpu")
