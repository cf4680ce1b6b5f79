"""The port's palette ops (lilliput_tpu_torch/ops/palette.py) on the CPU
against the JAX package's (lilliput_tpu/ops/palette.py, jitted), at atol
0 on the same numpy-seeded inputs: frame_bucket, lut_select(_batched),
_crush, quantize_to_palette with its carried cache tables,
quantize_animation (single and over a leading animation axis, against
the JAX package's jit and vmap) and composite_animation.

The quantizer cases cover palettes with duplicate entries and black
padding (ties: the first lowest index wins), a transparent index inside,
outside and absent, a palette change clearing the cache, a clear on every
frame with the frame count on its bucket, and the JAX package's
int32-overflow fallback branch (forced by setting its _PACK_LIMIT to 0
inside the test). The cache's dump slot (CACHE_SIZE - 1) is written by
transparent pixels and never read; the port resets it, so the caches are
compared without it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from lilliput_tpu.ops import palette as JP
from lilliput_tpu_torch.ops import palette as TP

H, W = 12, 10      # one frame shape for every quantizer case


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _frame(rng, h=H, w=W):
    """A BGRA frame with crushed-key collisions, light and dark extremes
    and low-alpha pixels."""
    img = rng.integers(0, 256, (h, w, 4), np.uint8)
    img[:3, :3, :3] = rng.integers(0, 16, (3, 3, 3))
    img[3:5, :4, :3] = rng.integers(241, 256, (2, 4, 3))
    img[:, 6:8, :3] = (img[:, 6:8, :3] & 0xF8) | rng.integers(0, 8, (h, 2, 3))
    img[8:] = img[8]                       # repeated rows: same keys
    img[..., 3] = np.where(img[..., 3] < 60, 10, 255)
    return img


def _palette(rng, kind):
    """(P, 3) RGB: random, with duplicate entries, or PIL-style (a few
    colours padded with black to 256)."""
    if kind == "dup":
        p = rng.integers(0, 256, (24, 3), np.uint8)
        p[12:] = p[:12]                    # every entry twice
        p[5] = p[3]
        return p
    if kind == "pad":
        p = np.zeros((256, 3), np.uint8)
        p[:9] = rng.integers(0, 256, (9, 3))
        return p
    return rng.integers(0, 256, (40, 3), np.uint8)


def test_frame_bucket_equals_jax():
    assert [TP.frame_bucket(n) for n in range(0, 700)] == \
        [JP.frame_bucket(n) for n in range(0, 700)]
    assert TP._FRAME_BUCKETS == JP._FRAME_BUCKETS
    assert TP.CACHE_SIZE == JP.CACHE_SIZE


@pytest.mark.parametrize("batched", [False, True], ids=["one", "batched"])
def test_lut_select_clamps_out_of_range_indices(batched):
    """A plain gather with the index clamped to [0, P-1]: equal to the
    JAX package's selection dots and to jnp.take(mode='clip') for every
    index, out-of-range and negative ones included."""
    rng = np.random.default_rng(7)
    if batched:
        luts = rng.integers(0, 256, (3, 200, 4), np.uint8)
        idx = rng.integers(-5, 260, (3, 6, 6), np.int64).astype(np.int32)
        want = np.asarray(jax.jit(JP.lut_select_batched)(jnp.asarray(luts),
                                                         jnp.asarray(idx)))
        got = TP.lut_select_batched(_t(luts), _t(idx)).numpy()
        clip = np.stack([np.take(luts[i], idx[i], axis=0, mode="clip")
                         for i in range(3)])
    else:
        luts = rng.integers(0, 256, (200, 4), np.uint8)
        idx = np.array([[0, 199, 200, 255], [-1, 64, 1000, 5]], np.int32)
        want = np.asarray(jax.jit(JP.lut_select)(jnp.asarray(luts),
                                                 jnp.asarray(idx)))
        got = TP.lut_select(_t(luts), _t(idx)).numpy()
        clip = np.take(luts, idx, axis=0, mode="clip")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, clip)


def test_crush_equals_jax():
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (3, 20000), np.int32)
    rgb[:, :256] = np.arange(256)          # every level, gray
    rgb[:, 256:512] = np.arange(256)[::-1]
    want = jax.jit(JP._crush)(*(jnp.asarray(c) for c in rgb))
    got = TP._crush(*(_t(c) for c in rgb))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


#: (palette kind, transparent index per frame, previous-frame flags), over
#: three frames; the palette changes before frame 2 (the cache clears)
QUANT_CASES = {
    "trans_inside": ("rand", [7, 7, 3], [False, True, True]),
    "trans_outside": ("rand", [45, 60, 200], [False, True, True]),
    "no_trans": ("rand", [-1, -1, -1], [False, True, True]),
    "trans_changes": ("rand", [5, -1, 9], [False, True, False]),
    "dup_entries": ("dup", [2, 2, 30], [False, True, True]),
    "black_padding": ("pad", [-1, 8, 200], [False, True, True]),
}


def _quant_inputs(case):
    kind, trans, prev_ok = QUANT_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    frames = [_frame(rng) for _ in range(3)]
    pa, pb = _palette(rng, kind), _palette(rng, kind)
    return frames, [pa, pa, pb], trans, prev_ok


def _jax_sequential(frames, pals, trans, prev_ok):
    """The JAX package's per-frame quantize_to_palette calls with carried
    cache tables, as its GifEncoder makes them."""
    seen = jnp.zeros((JP.CACHE_SIZE,), jnp.bool_)
    cache = jnp.zeros((JP.CACHE_SIZE,), jnp.uint8)
    prev_bytes, prev, outs, clears = None, None, [], []
    for img, pal, tr, pv in zip(frames, pals, trans, prev_ok):
        clear = prev_bytes != pal.tobytes()
        clears.append(clear)
        if clear:
            seen = jnp.zeros((JP.CACHE_SIZE,), jnp.bool_)
            cache = jnp.zeros((JP.CACHE_SIZE,), jnp.uint8)
        prev_bytes = pal.tobytes()
        use_prev = bool(pv and tr >= 0 and prev is not None)
        idx, seen, cache = JP.quantize_to_palette(
            jnp.asarray(img), jnp.asarray(pal.astype(np.int32)),
            jnp.asarray(prev if use_prev else np.zeros_like(img)),
            seen, cache, int(tr), tr >= 0, use_prev)
        outs.append((np.asarray(idx), np.asarray(seen), np.asarray(cache)))
        prev = img
    return outs, clears


def _port_sequential(frames, pals, trans, prev_ok, device="cpu"):
    seen = cache = None
    prev_bytes, prev, outs = None, None, []
    for img, pal, tr, pv in zip(frames, pals, trans, prev_ok):
        if prev_bytes != pal.tobytes():
            seen = torch.zeros(TP.CACHE_SIZE, dtype=torch.bool, device=device)
            cache = torch.zeros(TP.CACHE_SIZE, dtype=torch.uint8,
                                device=device)
        prev_bytes = pal.tobytes()
        use_prev = bool(pv and tr >= 0 and prev is not None)
        idx, seen, cache = TP.quantize_to_palette(
            _t(img).to(device), _t(pal.astype(np.int32)).to(device),
            _t(prev if use_prev else np.zeros_like(img)).to(device),
            seen, cache, int(tr), tr >= 0, use_prev)
        outs.append((idx.cpu().numpy(), seen.cpu().numpy(),
                     cache.cpu().numpy()))
        prev = img
    return outs


@pytest.mark.parametrize("case", list(QUANT_CASES))
def test_quantize_to_palette_equals_jax(case):
    """Indices, seen-key table and cache (but its dump slot) after each
    frame, across a palette change."""
    frames, pals, trans, prev_ok = _quant_inputs(case)
    want, _ = _jax_sequential(frames, pals, trans, prev_ok)
    got = _port_sequential(frames, pals, trans, prev_ok)
    for k, ((wi, ws, wc), (gi, gs, gc)) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(gi, wi, err_msg=f"frame {k}")
        np.testing.assert_array_equal(gs, ws, err_msg=f"frame {k}")
        np.testing.assert_array_equal(gc[:-1], wc[:-1], err_msg=f"frame {k}")
        assert gc[-1] == 0 and not gs[-1]


def test_quantize_ties_pick_the_first_lowest_index():
    """Every colour of the palette twice: the search must return the first
    copy (giflib), which the midpoint of each entry's own colour finds at
    distance 0."""
    pal = np.array([[0, 0, 0], [40, 80, 120], [40, 80, 120], [200, 8, 8],
                    [0, 0, 0], [200, 8, 8]], np.uint8)
    img = np.zeros((2, 3, 4), np.uint8)
    img[..., 3] = 255
    img[0, :, :3] = (pal[[1, 3, 0], ::-1] & 0xF8) | 4   # BGR midpoints
    idx, _, _ = TP.quantize_to_palette(
        _t(img), _t(pal.astype(np.int32)), _t(np.zeros_like(img)),
        torch.zeros(TP.CACHE_SIZE, dtype=torch.bool),
        torch.zeros(TP.CACHE_SIZE, dtype=torch.uint8), -1, False, False)
    assert idx.numpy()[0].tolist() == [1, 3, 0]


def _stacked(pals, trans, clears, prev_ok):
    n = len(pals)
    palettes = np.zeros((n, 256, 3), np.int32)
    counts = np.zeros(n, np.int32)
    for i, p in enumerate(pals):
        palettes[i, :len(p)] = p
        counts[i] = len(p)
    use_prev = np.array([pv and t >= 0 and i > 0 for i, (pv, t)
                         in enumerate(zip(prev_ok, trans))])
    return (palettes, counts, np.array(trans, np.int32), np.array(clears),
            use_prev)


def _anim_case(case):
    """A six-frame animation: two palette segments (the transparent index
    changes inside the first), or every frame on its own palette with the
    frame count on its bucket (4)."""
    rng = np.random.default_rng(77 if case == "segments" else 5)
    if case == "segments":
        frames = [_frame(rng) for _ in range(6)]
        pa, pb = _palette(rng, "rand"), _palette(rng, "dup")
        pals = [pa, pa, pa, pb, pb, pb]
        trans = [5, 9, -1, 3, 3, 200]
        prev_ok = [False, True, True, True, False, True]
    else:
        frames = [_frame(rng) for _ in range(4)]
        for f in frames:
            f[:3, :3, :3] = 255            # white: crushed key 32767
            f[..., 3] = 255
        pals = [rng.integers(0, 256, (17 + k, 3), np.uint8) for k in range(4)]
        trans = [3, 3, 3, 3]
        prev_ok = [False, True, True, True]
    return frames, pals, trans, prev_ok


@pytest.mark.parametrize("fallback", [False, True], ids=["sort", "fallback"])
@pytest.mark.parametrize("case", ["segments", "every_frame_clears"])
def test_quantize_animation_equals_jax_and_sequential(case, fallback,
                                                      monkeypatch):
    """The port's whole-animation quantizer equals the JAX package's (its
    sort branch, and its overflow fallback forced with _PACK_LIMIT = 0)
    and the port's own sequential quantize_to_palette calls."""
    frames, pals, trans, prev_ok = _anim_case(case)
    seq, clears = _jax_sequential(frames, pals, trans, prev_ok)
    args = _stacked(pals, trans, clears, prev_ok)
    quantize = JP.quantize_animation
    if fallback:
        # a fresh jit traces the JAX function with the patched limit
        monkeypatch.setattr(JP, "_PACK_LIMIT", 0)
        quantize = jax.jit(JP.quantize_animation.__wrapped__)
    want = np.asarray(quantize(jnp.asarray(np.stack(frames)),
                               *(jnp.asarray(a) for a in args)))
    got = TP.quantize_animation(_t(np.stack(frames)),
                                *(_t(a) for a in args)).numpy()
    np.testing.assert_array_equal(got, want)
    port_seq = _port_sequential(frames, pals, trans, prev_ok)
    for k in range(len(frames)):
        np.testing.assert_array_equal(got[k], seq[k][0], err_msg=f"frame {k}")
        np.testing.assert_array_equal(got[k], port_seq[k][0])


def test_quantize_animation_over_animations_equals_jax_vmap(monkeypatch):
    """A leading animation axis (the batch path) equals the JAX package's
    vmapped quantizer, with an inert padding lane, and each lane equals
    the unbatched call; the distances in chunks of 2 frames or of a
    frame's pixel bands give the same indices."""
    lanes = [_anim_case("segments"), _anim_case("every_frame_clears")]
    n = 6
    stacks = []
    for frames, pals, trans, prev_ok in lanes:
        frames = frames + [np.zeros_like(frames[0])] * (n - len(frames))
        pals = pals + [np.zeros((1, 3), np.uint8)] * (n - len(pals))
        trans = trans + [-1] * (n - len(trans))
        prev_ok = prev_ok + [False] * (n - len(prev_ok))
        _, clears = _jax_sequential(frames, pals, trans, prev_ok)
        stacks.append((np.stack(frames),) + _stacked(pals, trans, clears,
                                                     prev_ok))
    stacks.append(tuple(np.zeros_like(a) for a in stacks[0]))  # inert lane
    batch = [np.stack([s[i] for s in stacks]) for i in range(6)]
    want = np.asarray(jax.jit(jax.vmap(JP.quantize_animation))(
        *(jnp.asarray(a) for a in batch)))
    got = TP.quantize_animation(*(_t(a) for a in batch)).numpy()
    np.testing.assert_array_equal(got, want)
    for k, s in enumerate(stacks):
        np.testing.assert_array_equal(
            got[k], TP.quantize_animation(*(_t(a) for a in s)).numpy())
    for chunk in (2 * H * W * 256, 7 * 256):
        monkeypatch.setattr(TP, "_DIST_CHUNK", chunk)
        np.testing.assert_array_equal(
            TP.quantize_animation(*(_t(a) for a in batch)).numpy(), got)


def _composite_inputs(rng, n, h=H, w=W):
    """Per-frame inputs of composite_animation: random indices into
    palettes of 1-256 entries, clipped rects, disposals 0-3."""
    idxs = rng.integers(0, 256, (n, h, w), np.uint8)
    drawn = np.zeros((n, h, w), bool)
    prects = np.zeros((n, h, w), bool)
    luts = rng.integers(0, 256, (n, 256, 4), np.uint8)
    counts = rng.integers(1, 257, n).astype(np.int32)
    counts[1] = 0                           # an inert frame
    trans = rng.integers(-1, 300, n).astype(np.int32)
    pdisp = rng.integers(0, 4, n).astype(np.int32)
    pdisp[0] = 3                            # restores transparent black
    for k in range(n):
        t, l = rng.integers(0, h), rng.integers(0, w)
        drawn[k, t:t + rng.integers(1, h + 1), l:l + rng.integers(1, w + 1)] \
            = True
        if k:
            prects[k] = drawn[k - 1]
    prects[0, :4, :4] = True
    drawn[0] = True
    bg = rng.integers(0, 256, 4).astype(np.uint8)
    return idxs, drawn, luts, counts, trans, pdisp, prects, bg


def test_composite_animation_equals_jax():
    rng = np.random.default_rng(11)
    one = _composite_inputs(rng, 7)
    want = np.asarray(JP.composite_animation(*(jnp.asarray(a) for a in one)))
    got = TP.composite_animation(*(_t(a) for a in one)).numpy()
    np.testing.assert_array_equal(got, want)
    two = _composite_inputs(rng, 7)
    batch = [np.stack([a, b]) for a, b in zip(one, two)]
    wantb = np.asarray(jax.jit(jax.vmap(JP.composite_animation))(
        *(jnp.asarray(a) for a in batch)))
    gotb = TP.composite_animation(*(_t(a) for a in batch)).numpy()
    np.testing.assert_array_equal(gotb, wantb)
    np.testing.assert_array_equal(gotb[0], got)
