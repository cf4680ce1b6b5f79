"""The port's thumbhash encoder on the CPU against the JAX package.

Frames synthesized from a seed (the JAX package's goldens read the
reference checkout's images, which this tree does not hold): 1-, 3- and 4-channel frames,
opaque and with alpha, landscape, portrait and square, smaller and larger
than the 100 px working size, through ThumbhashEncoder, thumbhash_batch
and ImageOps.transform. The hash bytes must be equal (atol 0). The f32
coefficient grids and, with alpha, the composited planes are not bit for
bit XLA's (its dot and jnp.sum sum in their own order; ROADMAP queue 3
entry 12): they are held at atol 1e-6, and no hash byte has moved.
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp
import lilliput_tpu as L
from lilliput_tpu.codecs import thumbhash as JT
import lilliput_tpu_torch as T
from lilliput_tpu_torch.codecs import thumbhash as TT
from lilliput_tpu_torch.framebuffer import Framebuffer

GRID_ATOL = 1e-6


def _frame(h, w, c, seed, alpha="mixed"):
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (6, 6, c), np.uint8)
    img = Image.fromarray(small[..., 0] if c == 1 else small)
    px = np.array(np.asarray(img.resize((w, h), Image.BICUBIC)).reshape(
        h, w, c))
    if c == 4 and alpha == "opaque":
        px[..., 3] = 255
    if c == 4 and alpha == "clear":
        px[..., 3] = 0
    return px


def _hashes(px):
    a = JT.ThumbhashEncoder().encode(L.Framebuffer.from_array(px), {})
    b = TT.ThumbhashEncoder().encode(Framebuffer.from_array(px, "cpu"), {})
    return a, b


SIZES = [(37, 61), (61, 37), (33, 33), (7, 11), (150, 97), (97, 203),
         (100, 100), (101, 300), (1, 1)]


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", ["gray", "bgr", "bgra_opaque", "bgra_alpha",
                                  "bgra_clear"])
def test_thumbhash_equal_jax(kind, size):
    c = {"gray": 1, "bgr": 3}.get(kind, 4)
    alpha = kind.split("_")[-1]
    for seed in range(4):
        px = _frame(*size, c, seed * 31 + size[0], alpha)
        a, b = _hashes(px)
        assert a == b, (seed, a.hex(), b.hex())


def test_thumbhash_batch_equal_jax():
    frames = np.stack([_frame(40, 30, 4, s) for s in range(6)]
                      + [_frame(40, 30, 4, 9, "opaque")])
    assert TT.thumbhash_batch(frames, device="cpu") == \
        JT.thumbhash_batch(frames)
    assert TT.thumbhash_batch(torch.from_numpy(frames), device="cpu") == \
        JT.thumbhash_batch(frames)


def test_thumbhash_batch_differs_from_jax_only_at_ties():
    """Tiles whose alpha is a ramp along x, constant along y: their alpha
    ACs with cy > 0 are zero in exact arithmetic and sit at the rounding
    tie 15 * f = 7.5 but for the sign of an f32 residue, which is the
    summation order's (ROADMAP queue 3 entry 12). The grids are held at
    GRID_ATOL; every hash without such a tie equals the JAX package's."""
    rng = np.random.default_rng(7)
    tiles = np.stack([_frame(30, 40, 4, s) for s in range(24)])
    ramp = np.sort(rng.integers(0, 256, (24, 1, 40)), axis=-1)
    tiles[..., 3] = ramp.astype(np.uint8)
    j_l, j_p, j_q, j_a, j_sum = jax.vmap(JT._lpqa_from_bgra)(
        jnp.asarray(tiles))
    want = [np.asarray(JT._dct_grid_batch(x, n, n))
            for x, n in ((j_l, 7), (j_p, 3), (j_q, 3), (j_a, 5))]
    grids, sums = TT.batch_grids(tiles, device="cpu")
    for g, w in zip(grids, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=GRID_ATOL)
    got, ref = TT.thumbhash_batch(tiles, device="cpu"), \
        JT.thumbhash_batch(tiles)
    ties = [TT.order_dependent(TT.hash_fields(grids, sums, i, 40, 30),
                               GRID_ATOL) for i in range(len(tiles))]
    assert sum(ties) >= len(tiles) // 2
    assert all(t or a == b for a, b, t in zip(got, ref, ties))


def test_thumbhash_batch_runs_on_cuda_by_default():
    """Without device="cpu" the batch goes to the card: with none, it
    raises before any work instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    frames = np.stack([_frame(40, 30, 4, s) for s in range(2)])
    for f in (frames, torch.from_numpy(frames)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TT.thumbhash_batch(f)


@pytest.mark.parametrize("n", [(7, 7), (3, 3), (5, 5), (7, 4), (3, 6)])
def test_dct_grid_within_atol(n):
    for seed, (h, w) in enumerate([(37, 61), (100, 67), (7, 11)]):
        pl = np.random.default_rng(seed).random((h, w)).astype(np.float32)
        a = np.asarray(JT._dct_grid(jnp.asarray(pl), *n))
        b = TT._dct_grid(torch.from_numpy(pl), *n).numpy()
        np.testing.assert_allclose(b, a, rtol=0, atol=GRID_ATOL)
    np.testing.assert_array_equal(TT._cos_matrix(7, 61),
                                  JT._cos_matrix(7, 61))


def test_lpqa_planes_equal_jax():
    """The L/P/Q/A planes (XLA's fused composite over the average colour
    written out): at atol 0 for opaque frames and the alpha plane; with
    alpha, the average comes from jnp.sum, whose f32 order XLA picks, so
    L, P and Q are held at GRID_ATOL (queue 3 entry 12)."""
    for alpha in ("opaque", "mixed"):
        px = _frame(53, 47, 4, 3, alpha)
        ja = [np.asarray(x) for x in JT._lpqa_from_bgra(jnp.asarray(px))]
        ta = [x.numpy() for x in TT._lpqa_from_bgra(torch.from_numpy(px))]
        np.testing.assert_array_equal(ta[3], ja[3])
        np.testing.assert_allclose(ta[4], ja[4], rtol=1e-6, atol=0)
        for a, b in zip(ja[:3], ta[:3]):
            if alpha == "opaque":
                np.testing.assert_array_equal(b, a)
            np.testing.assert_allclose(b, a, rtol=0, atol=GRID_ATOL)
    ja = [np.asarray(x) for x in JT._lpqa_from_bgr(jnp.asarray(px[..., :3]))]
    ta = [x.numpy() for x in TT._lpqa_from_bgr(torch.from_numpy(px[..., :3]))]
    for a, b in zip(ja, ta):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("c", [1, 3])
def test_transform_to_thumbhash_equal_jax(c):
    px = _frame(90, 130, c, 5)
    buf = T.new_encoder(".png").encode(Framebuffer.from_array(px, "cpu"), {})
    for method in (T.ResizeMethod.FIT, T.ResizeMethod.NO_RESIZE):
        a = L.ImageOps(8192).transform(L.new_decoder(buf), L.ImageOptions(
            file_type=".thumbhash", width=64, height=48,
            resize_method=method))
        b = T.ImageOps(8192).transform(
            T.new_decoder(buf, device="cpu"), T.ImageOptions(
                file_type=".thumbhash", width=64, height=48,
                resize_method=method))
        assert a == b


def test_flush_without_a_frame_raises():
    with pytest.raises(T.DecodingFailedError):
        TT.ThumbhashEncoder().encode(None, {})
