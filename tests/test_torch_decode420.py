"""The port's 4:2:0 decode (ops/decode_kernels) against the JAX package's
decode: the split path (jpeg_kernels.decode_ycc_420, the CPU default) and
the Pallas megakernel (pallas_kernels._decode420_call, interpret mode).

On the CPU the wrapper takes the plain PyTorch version (decode_ycc_reference
with h2=v2=True), which must match the JAX split path BIT FOR BIT (atol 0)
and the megakernel bit for bit wherever the megakernel agrees with the
split path: planes against decode_ycc_u8_plane_blocks +
_blocks_to_plane_xla, packed BGRA against _decode_ycc_megakernel, at the
odd geometries of test_megakernel.py with per-image tables, and at the
bench window. The megakernel itself departs
from the split path by 1 u8 on 1 of 2304 values at 16x16 (seed 16016,
per-image q30/85/95 tables; ROADMAP queue 3): XLA fuses the kernel body's
multiply-adds differently in interpret mode. There the port keeps the
split path's value, within 1 of the megakernel's.

The CUDA kernel itself is held against the plain version on the card in
tests/test_torch_gpu.py and chip_smoke.py phase 2.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lilliput_tpu import pipeline as JP
from lilliput_tpu.ops import jpeg_kernels as JK
from lilliput_tpu_torch import pipeline as TP
from lilliput_tpu_torch.ops import decode_kernels as DK
from lilliput_tpu_torch.ops import jpeg_kernels as K

from _torch_parity import CASES, bench_bytes, coefs, jax_planes, qtables


def _reference(*args, out="planes"):
    return DK.decode_ycc_reference(*args, True, True, out=out)


def _folded(qy, qc, device="cpu"):
    return tuple(K.fold_qtables(torch.from_numpy(q.astype(np.float32))
                                .to(device)) for q in (qy, qc))


def _torch_args(yc, cb, cr, qy, qc, device="cpu"):
    return tuple(torch.from_numpy(a).to(device)
                 for a in (yc, cb, cr)) + _folded(qy, qc, device)


def _split_bgr(yc, cb, cr, qy, qc):
    """JAX split decode cropped to the luma plane: (B, oh, ow, 3) u8."""
    oh, ow = 8 * yc.shape[1], 8 * yc.shape[2]
    return np.asarray(JK.decode_ycc_420(
        jnp.asarray(yc), jnp.asarray(cb), jnp.asarray(cr), jnp.asarray(qy),
        jnp.asarray(qc), oh, ow, True, True))


def _assert_matches_jax(got_planes, split, mk_planes):
    """atol 0 against the split path; against the megakernel, equal
    wherever the megakernel equals the split path, else within 1."""
    oh, ow = split.shape[1:3]
    for k, (g, m) in enumerate(zip(got_planes, mk_planes)):
        g = g[:, :oh, :ow]
        m = m[:, :oh, :ow]
        np.testing.assert_array_equal(g, split[..., k])
        agree = m == split[..., k]
        np.testing.assert_array_equal(g[agree], m[agree])
        assert np.abs(g.astype(int) - m.astype(int)).max() <= 1
        assert (~agree).sum() <= max(1, 1e-3 * agree.size)


@pytest.mark.parametrize("h,w", CASES)
def test_planes_match_jax(h, w):
    rng = np.random.default_rng(h * 1000 + w)
    yc, cb, cr = coefs(rng, h, w)
    qy, qc = qtables()
    got = _reference(*_torch_args(yc, cb, cr, qy, qc))
    oh, ow = 16 * cb.shape[1], 16 * cb.shape[2]
    for g in got:
        assert g.dtype == torch.uint8 and g.shape == (3, oh, ow)
    _assert_matches_jax([g.numpy() for g in got],
                        _split_bgr(yc, cb, cr, qy, qc),
                        jax_planes(yc, cb, cr, qy, qc))


@pytest.mark.parametrize("h,w", CASES)
def test_packed_matches_jax(h, w):
    rng = np.random.default_rng(h * 7 + w)
    yc, cb, cr = coefs(rng, h, w)
    qy, qc = qtables()
    ref = np.asarray(JK._decode_ycc_megakernel(
        jnp.asarray(yc), jnp.asarray(cb), jnp.asarray(cr), jnp.asarray(qy),
        jnp.asarray(qc), h, w, True, True, interpret=True))
    got = _reference(*_torch_args(yc, cb, cr, qy, qc), out="packed")
    assert got.dtype == torch.int32
    bgra = got.numpy().view(np.uint8).reshape(got.shape + (4,))
    split = _split_bgr(yc, cb, cr, qy, qc)[:, :h, :w]
    _assert_matches_jax([bgra[:, :h, :w, k] for k in range(3)], split,
                        [ref[..., k] for k in range(3)])
    assert np.all(bgra[..., 3] == 255)


def test_bench_window_matches_jax():
    """The fixture's real window coefficients (batch 1), as the serving
    path decodes them."""
    buf = bench_bytes()
    pipe = TP.JpegTranscodePipeline(buf, 256, 256, device="cpu")
    yc, cb, cr, qy, qc = pipe.decode_entropy([buf])
    got = _reference(*_torch_args(yc, cb, cr, qy, qc))
    _assert_matches_jax([g.numpy() for g in got],
                        _split_bgr(yc, cb, cr, qy, qc),
                        jax_planes(yc, cb, cr, qy, qc))


def test_wrapper_takes_plain_version_on_cpu():
    rng = np.random.default_rng(5)
    yc, cb, cr = coefs(rng, 67, 61)
    qy, qc = qtables()
    args = _torch_args(yc, cb, cr, qy, qc)
    DK.reset_launches()
    for out in ("planes", "packed"):
        got = DK.decode420(*args, out=out)
        ref = _reference(*args, out=out)
        for g, r in zip(got if out == "planes" else [got],
                        ref if out == "planes" else [ref]):
            assert torch.equal(g, r)
    assert DK.launches["decode420"] == 0


def test_serving_entry_matches_jax_entry():
    """jpeg_kernels.decode_ycc_u8_plane_blocks: the same (B, 64) tables
    and the same 4:2:0 gate as the JAX function; raster planes out."""
    rng = np.random.default_rng(8)
    yc, cb, cr = coefs(rng, 130, 17)
    qy, qc = qtables()
    got = K.decode_ycc_u8_plane_blocks(
        *(torch.from_numpy(a) for a in (yc, cb, cr)),
        torch.from_numpy(qy.astype(np.float32)),
        torch.from_numpy(qc.astype(np.float32)), True, True)
    _assert_matches_jax([g.numpy() for g in got],
                        _split_bgr(yc, cb, cr, qy, qc),
                        jax_planes(yc, cb, cr, qy, qc))
    t = [torch.from_numpy(a) for a in (yc, cb, cr)]
    qt = torch.from_numpy(qy.astype(np.float32))
    assert K.decode_ycc_u8_plane_blocks(*t, qt, qt, True, False) is None
    assert K.decode_ycc_u8_plane_blocks(t[0], t[0], t[0], qt, qt,
                                        True, True) is None


def test_wrapper_rejects_bad_inputs():
    rng = np.random.default_rng(6)
    yc, cb, cr = coefs(rng, 32, 32)
    qy, qc = qtables()
    args = list(_torch_args(yc, cb, cr, qy, qc))
    with pytest.raises(TypeError):
        DK.decode420(args[0].to(torch.int32), *args[1:])
    with pytest.raises(ValueError):
        DK.decode420(args[0][:, :1], *args[1:])       # not the 4:2:0 luma
    with pytest.raises(ValueError):
        DK.decode420(*args[:3], args[3][:1, :32], args[4])
    with pytest.raises(ValueError):
        DK.decode420(*args, out="rgb")
    assert DK.launches["decode420"] == 0


def test_jax_pipeline_geometry_is_the_ports():
    """Both pipelines cut the same MCU window for the bench geometry."""
    buf = bench_bytes()
    jp = JP.JpegTranscodePipeline(buf, 256, 256)
    tp = TP.JpegTranscodePipeline(buf, 256, 256, device="cpu")
    assert tp.window_static == jp.window_static
    assert tp._window[4:] == jp._window[4:]
