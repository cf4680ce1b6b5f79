"""The split-path IDCT and the decodes built on it, against the JAX package
on the CPU:

* ops/decode_kernels.dequant_idct_blocks_reference, the plain version of
  the dequant_idct_blocks kernel, against the Pallas kernel
  pallas_kernels.dequant_idct_blocks in interpret mode, vmapped over
  per-image tables as jpeg_kernels.dequant_idct does: atol 0 at the odd
  geometries of test_megakernel.py with q30/85/95 tables, and at the
  grayscale fixture's whole frame; its u8 epilogue (and the wrapper's, on
  the CPU) against the Pallas kernel's output rounded and clipped, atol 0,
  also at block grids on either side of the CUDA kernel's strip and step
  edges;
* ops/jpeg_kernels.dequant_idct, dequant_idct_u8, decode_gray and
  decode_ycc_420 (the kernel route and the split route) against the JAX
  functions under jax.jit: atol 0;
* the wrapper's contract on the CPU: the plain version, no launch counted,
  and bad inputs raise.

The CUDA kernel itself is held against the plain version on the card in
tests/test_torch_gpu.py and chip_smoke.py phase 2."""

import functools

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lilliput_tpu.ops import jpeg_kernels as JK
from lilliput_tpu.ops import pallas_kernels as PK
from lilliput_tpu_torch import pipeline as TP
from lilliput_tpu_torch.ops import decode_kernels as DK
from lilliput_tpu_torch.ops import jpeg_kernels as K

from _torch_parity import (CASES, LAYOUTS, QUALITIES, bench_bytes, coefs,
                           qtables)


def _blocks(h, w, batch, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-400, 400, (batch, -(-h // 8), -(-w // 8), 64)
                        ).astype(np.int16)


def _jax_blocks_raster(yc: np.ndarray, wq: np.ndarray) -> np.ndarray:
    """The Pallas kernel (interpret mode) vmapped over images, its (N, 64)
    blocks laid out as the raster plane (jpeg_kernels.py:213-215)."""
    b, bh, bw = yc.shape[:3]
    out = jax.vmap(functools.partial(PK.dequant_idct_blocks, interpret=True))(
        jnp.asarray(yc.reshape(b, -1, 64)), jnp.asarray(wq))
    return np.asarray(out).reshape(b, bh, bw, 8, 8).transpose(
        0, 1, 3, 2, 4).reshape(b, 8 * bh, 8 * bw)


def _folded(qt: np.ndarray) -> torch.Tensor:
    return K.fold_qtables(torch.from_numpy(qt.astype(np.float32)))


@pytest.mark.parametrize("q", QUALITIES)
@pytest.mark.parametrize("h,w", CASES)
def test_plain_version_matches_pallas_kernel(h, w, q):
    yc = _blocks(h, w, 2, h * 1000 + w + q)
    other = QUALITIES[(QUALITIES.index(q) + 1) % len(QUALITIES)]
    wq = _folded(qtables((q, other))[0])
    got = DK.dequant_idct_blocks_reference(torch.from_numpy(yc), wq)
    assert got.dtype == torch.float32 and got.shape == (2, 8 * yc.shape[1],
                                                        8 * yc.shape[2])
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_blocks_raster(yc, wq.numpy()))


def test_plain_version_matches_pallas_kernel_on_gray_frame():
    """The grayscale fixture's whole-frame coefficients (135 x 240 blocks),
    as the oriented serving path decodes them, with the image's own
    table."""
    buf = bench_bytes("gray_o6")
    ys, qty = TP.JpegTranscodePipeline(buf, 256, 256,
                                       device="cpu").decode_entropy([buf])
    assert ys.shape == (1, 135, 240, 64)
    wq = _folded(qty)
    got = DK.dequant_idct_blocks_reference(torch.from_numpy(ys), wq)
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_blocks_raster(ys, wq.numpy()))


#: block grids (bh, bw) on either side of the CUDA kernel's strip (16
#: block columns) and step (4 block rows) edges
EDGE_GRIDS = [(bh, bw) for bh in (3, 4, 5) for bw in (15, 16, 17)]


@pytest.mark.parametrize("shared", [False, True], ids=["per_image", "shared"])
@pytest.mark.parametrize("bh,bw", [(-(-h // 8), -(-w // 8))
                                   for h, w in CASES] + EDGE_GRIDS)
def test_u8_epilogue_matches_pallas_kernel(bh, bw, shared):
    """out="u8" of the wrapper (its plain version on the CPU) and of the
    plain version against clip(round(.)) of the Pallas kernel in interpret
    mode, with per-image tables and with one shared table."""
    yc = _blocks(8 * bh, 8 * bw, 3, bh * 100 + bw)
    qy = qtables()[0]
    wq = _folded(qy[1] if shared else qy)
    want = _jax_blocks_raster(yc, np.broadcast_to(wq.numpy(), (3, 64, 64)))
    want = np.clip(np.round(want), 0, 255).astype(np.uint8)
    for fn in (DK.dequant_idct_blocks, DK.dequant_idct_blocks_reference):
        got = fn(torch.from_numpy(yc), wq, out="u8")
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_takes_plain_version_on_cpu():
    yc = torch.from_numpy(_blocks(67, 61, 3, 7))
    qy = qtables()[0]
    DK.reset_launches()
    for wq in (_folded(qy), _folded(qy[1])):      # per image, and shared
        got = DK.dequant_idct_blocks(yc, wq)
        assert torch.equal(got, DK.dequant_idct_blocks_reference(yc, wq))
    assert not any(DK.launches.values())
    # a shared table is the per-image one repeated
    assert torch.equal(DK.dequant_idct_blocks(yc, _folded(qy[1])),
                       DK.dequant_idct_blocks(yc, _folded(qy[[1, 1, 1]])))


def test_wrapper_rejects_bad_inputs():
    yc = torch.from_numpy(_blocks(32, 48, 3, 8))
    wq = _folded(qtables()[0])
    for fn in (DK.dequant_idct_blocks, DK.dequant_idct_blocks_reference):
        with pytest.raises(TypeError):
            fn(yc.to(torch.int32), wq)
        with pytest.raises(TypeError):
            fn(yc, wq.double())
        with pytest.raises(ValueError):
            fn(yc[..., :32], wq)                      # not 64 coefficients
        with pytest.raises(ValueError):
            fn(yc[0], wq)                             # no batch axis
        with pytest.raises(ValueError):
            fn(yc, wq[:2])                            # 2 tables, 3 images
        with pytest.raises(ValueError):
            fn(yc, wq, out="f16")                     # no such epilogue
    assert not any(DK.launches.values())


@pytest.mark.parametrize("shape", [(3, 9, 13), (3, 68, 70), (2, 1, 1)])
def test_dequant_idct_u8(shape):
    rng = np.random.default_rng(sum(shape) + 1)
    c = rng.integers(-400, 400, shape + (64,)).astype(np.int16)
    qy = qtables()[0][:shape[0]]
    ref = jax.jit(JK.dequant_idct_u8)
    for q in (qy, qy[0]):                             # per image, and shared
        got = K.dequant_idct_u8(torch.from_numpy(c), torch.from_numpy(q))
        want = np.asarray(ref(jnp.asarray(c), jnp.asarray(q)))
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))


def test_dequant_idct_gates_batched_tables():
    c = torch.from_numpy(_blocks(16, 16, 3, 9))
    qy = torch.from_numpy(qtables()[0])
    for fn in (K.dequant_idct, K.dequant_idct_u8):
        with pytest.raises(ValueError):
            fn(c, qy[:2])
    assert torch.equal(K.dequant_idct(c, qy, plain=True),
                       K.dequant_idct(c, qy))


@pytest.mark.parametrize("h,w", [(67, 61), (130, 17), (8, 8)])
def test_decode_gray(h, w):
    yc = _blocks(h, w, 3, h + w)
    qy = qtables()[0]
    got = K.decode_gray(torch.from_numpy(yc), torch.from_numpy(qy), h, w)
    want = np.asarray(jax.jit(JK.decode_gray, static_argnums=(2, 3))(
        jnp.asarray(yc), jnp.asarray(qy), h, w))
    assert got.dtype == torch.uint8 and want.shape == (3, h, w, 1)
    np.testing.assert_array_equal(got.numpy(), want[..., 0])


def _decode_ycc_420_pair(sub, h, w, split):
    rng = np.random.default_rng(h * 7 + w + int(sub))
    yc, cb, cr = coefs(rng, h, w, sub)
    qy, qc = qtables()
    h2, v2 = LAYOUTS[sub]
    kw = {"qt_chroma2": qc} if split else {}
    want = np.asarray(JK.decode_ycc_420(
        *(jnp.asarray(a) for a in (yc, cb, cr, qy, qc)), h, w, h2, v2,
        **{k: jnp.asarray(v) for k, v in kw.items()}))
    got = K.decode_ycc_420(
        *(torch.from_numpy(a) for a in (yc, cb, cr)),
        *(torch.from_numpy(q.astype(np.float32)) for q in (qy, qc)),
        h, w, h2, v2, **{k: torch.from_numpy(v.astype(np.float32))
                         for k, v in kw.items()})
    return got, want


@pytest.mark.parametrize("split", [False, True], ids=["kernel", "split"])
@pytest.mark.parametrize("h,w", [(67, 61), (24, 129)])
@pytest.mark.parametrize("sub", list(LAYOUTS))
def test_decode_ycc_420(sub, h, w, split):
    """Both routes of decode_ycc_420: the layout's decode kernel (its plain
    version on the CPU), and the split path through dequant_idct, which a
    distinct Cr table (qt_chroma2, here equal to Cb's) forces in both
    packages. The JAX function on the CPU always takes its split path.
    4:4:4's split route keeps the chroma's (x + 128) - 128, which XLA folds
    to x (ROADMAP queue 3 entry 5); no value of these inputs moves by it,
    and no serving path takes that route."""
    got, want = _decode_ycc_420_pair(sub, h, w, split)
    assert want.shape == (3, h, w, 3)
    for k in range(3):
        assert got[k].dtype == torch.uint8
        np.testing.assert_array_equal(got[k].numpy(), want[..., k])
