"""The port's constant tables equal the JAX package's bit for bit, and the
port imports neither jax nor lilliput_tpu.

The system has no learned weights; the state that must carry across is the
constant tables: the IDCT kron matrix, the dequant-folded matrices and the
fDCT/quantization matrices for every quality, and the AREA resize
matrices with their band slabs at the serving and test geometries."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lilliput_tpu import pipeline as JP
from lilliput_tpu.codecs import jpeg as JJ
from lilliput_tpu.ops import jpeg_kernels as JK
from lilliput_tpu.ops import resize as JR
from lilliput_tpu_torch import pipeline as TP
from lilliput_tpu_torch.codecs import jpeg as TJ
from lilliput_tpu_torch.ops import jpeg_kernels as K
from lilliput_tpu_torch.ops import resize as R

PKG = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                   "lilliput_tpu_torch")


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def test_dct_tables():
    np.testing.assert_array_equal(_bits(K.dct_matrix()),
                                  _bits(JK.dct_matrix()))
    np.testing.assert_array_equal(_bits(K.idct_kron_matrix()),
                                  _bits(JK.idct_kron_matrix()))


def test_folded_and_fdct_tables_all_qualities():
    """W_q = diag(q)·W (decode) and W^T / q (encode), q = 1..100, both
    tables, computed on each side the way each package computes them."""
    w_j = jnp.asarray(JK.idct_kron_matrix())
    for q in range(1, 101):
        for tj, tt in zip(JJ.scaled_qtables(q), TJ.scaled_qtables(q)):
            np.testing.assert_array_equal(tj, tt)
            qf = jnp.asarray(tj).astype(jnp.float32)
            ref = w_j[None] * qf.reshape(-1, 64)[:, :, None]
            got = K.fold_qtables(torch.from_numpy(tt.astype(np.float32)))
            np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref))
            ref_f = w_j.T / qf[None, :]
            got_f = (K.idct_kron("cpu").transpose(0, 1)
                     / torch.from_numpy(tt.astype(np.float32))[None, :])
            np.testing.assert_array_equal(_bits(got_f.numpy()),
                                          _bits(ref_f))


def _geometries():
    """(plane_w, plane_h, off_x, w, dst_w, off_y, h, dst_h) of the serving
    path at the bench geometry and the test geometries."""
    out = []
    for src, dst in (((1920, 1080), (256, 256)), ((200, 150), (64, 48)),
                     ((67, 61), (100, 90)), ((320, 200), (64, 64))):
        left, top, w, h = JP.fit_rect(*src, *dst)
        hb, wb = -(-src[1] // 16), -(-src[0] // 16)
        win = JP.mcu_decode_window(*src, *dst, True, True,
                                   ((2 * hb, 2 * wb), (hb, wb)), 2 * hb)
        cbh = win[6].stop - win[6].start
        cbw = win[7].stop - win[7].start
        out.append((16 * cbw, 16 * cbh, left - win[0], w, dst[0],
                    top - win[1], h, dst[1]))
    return out


@pytest.mark.parametrize("geom", _geometries())
def test_area_matrices_and_slabs(geom):
    pw, ph, ox, w, dw, oy, h, dh = geom
    lin = dw > w or dh > h
    for window, off, length, dst in ((pw, ox, w, dw), (ph, oy, h, dh)):
        ref = JR.area_matrix_embedded(window, off, length, dst, lin)
        got = R.area_matrix_embedded(window, off, length, dst, lin)
        np.testing.assert_array_equal(_bits(got), _bits(ref))
        gj, gt = JR._banded_groups(ref), R._banded_groups(got)
        assert (gj is None) == (gt is None)
        for (lj, hj, sj), (lt, ht, st) in zip(gj or [], gt or []):
            assert (lj, hj) == (lt, ht)
            np.testing.assert_array_equal(_bits(st), _bits(sj))
        dev = R._embedded_banded(window, off, length, dst, lin, "cpu")
        slabs = [dev] if isinstance(dev, torch.Tensor) else [
            s for _, _, s in dev]
        for s, (_, _, sj) in zip(slabs, gj or [(0, 0, ref)]):
            np.testing.assert_array_equal(_bits(s.numpy()), _bits(sj))


def test_window_geometry_matches_jax():
    for src, dst in (((1920, 1080), (256, 256)), ((67, 61), (100, 90))):
        hb, wb = -(-src[1] // 16), -(-src[0] // 16)
        args = (*src, *dst, True, True, ((2 * hb, 2 * wb), (hb, wb)), 2 * hb)
        assert TP.mcu_decode_window(*args) == JP.mcu_decode_window(*args)
        assert TP.fit_rect(*src, *dst) == JP.fit_rect(*src, *dst)


def test_import_pulls_in_no_jax():
    """Importing every module of the port (but __main__, which runs the
    command line) pulls in neither jax nor the JAX package."""
    code = (
        "import importlib, pkgutil, sys, lilliput_tpu_torch as P; "
        "names = sorted(m.name for m in pkgutil.walk_packages("
        "P.__path__, 'lilliput_tpu_torch.') "
        "if not m.name.endswith('__main__')); "
        "[importlib.import_module(n) for n in names]; "
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'lilliput_tpu' or "
        "m.startswith('lilliput_tpu.')]; "
        "assert not bad, bad; print(' '.join(names))")
    root = os.path.dirname(PKG)
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    for mod in ("api", "cli", "pipeline", "imageops", "framebuffer",
                "ops.decode_kernels", "codecs.jpeg", "codecs.png",
                "codecs.bmp", "codecs.pnm", "codecs.sunras", "codecs.hdr",
                "codecs.pfm", "codecs.thumbhash"):
        assert "lilliput_tpu_torch." + mod in names, mod


def test_no_jax_import_in_source():
    pat = re.compile(r"^\s*(import|from)\s+(jax|lilliput_tpu)(\.|\s|$)",
                     re.M)
    sources = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs
               if f.endswith(".py")]
    assert len(sources) >= 10
    for path in sources + [os.path.join(os.path.dirname(PKG),
                                        "chip_smoke.py")]:
        with open(path) as f:
            assert not pat.search(f.read()), path
