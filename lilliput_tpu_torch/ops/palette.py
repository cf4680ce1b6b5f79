"""Palette ops on the device: LUT expansion, GIF compositing and
nearest-palette quantization.

The counterpart of ``lilliput_tpu/ops/palette.py``. The palette -> BGRA
expansion (giflib.cpp:515-541) is a gather; the encoder's crushed-RGB
nearest-palette search with its midpoint/extreme-colour rules and the
previous-frame transparency optimization (giflib.cpp:1006-1093) is an
|dR|+|dG|+|dB| argmin over the palette axis. Every function takes and
returns tensors on the caller's device.

Differences of form from the JAX package, none of value:

* ``lut_select`` is a plain gather with the index clamped to [0, P-1]
  (the ``mode='clip'`` contract); the JAX package's hi/lo one-hot
  selection dots exist because TPU gathers are slow.
* ``quantize_animation`` finds each crushed key's first occurrence with a
  ``scatter_reduce(..., "amin")`` of global int64 pixel indices (exact, no
  overflow branch) where the JAX package sorts; its (N, H, W, P) distances
  are made in frame chunks of int16 (every distance is at most 765), as
  eager torch would otherwise hold them all at once.
* ``composite_animation`` is a loop over frames of ``torch.where`` on the
  packed BGRA pixels (int32), over any leading animation axes, where the
  JAX package runs a ``lax.scan`` (vmapped for a batch).
"""

from __future__ import annotations

import torch

#: crushed-RGB cache size + 1 dump slot for masked scatters
CACHE_SIZE = (1 << 15) + 1

#: frame-count buckets for the animation paths: padding an animation's
#: frame axis up to the next bucket lets same-canvas animations of any
#: length share one batch (the JAX package's compile-reuse buckets)
_FRAME_BUCKETS = (1, 2, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256)

#: largest int16 distance sentinel: dead palette rows never win (a live
#: distance is at most 3 * 255)
_DEAD = 32767

#: pixels x palette rows of one chunk of the quantizer's int16 distances
#: (64 M entries: 128 MB per distance intermediate)
_DIST_CHUNK = 1 << 26


def frame_bucket(n: int) -> int:
    """Smallest scheduled bucket >= n (multiples of 128 past the table)."""
    for b in _FRAME_BUCKETS:
        if n <= b:
            return b
    return -(-n // 128) * 128


def lut_select(lut: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Palette LUT expansion: lut (P, C), idx (...,) int -> (..., C) u8.
    Out-of-range indices clamp to the nearest valid row, as
    ``jnp.take(mode='clip')``."""
    p = lut.shape[0]
    i = idx.to(torch.int64).clamp(0, p - 1)
    return lut.to(torch.uint8)[i]


def lut_select_batched(luts: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """lut_select with a leading batch axis shared by table and indices:
    luts (N, P, C), idx (N, ...) int -> (N, ..., C) u8, clamped alike."""
    n, p, c = luts.shape
    i = idx.to(torch.int64).clamp(0, p - 1).reshape(n, -1)
    flat = i + torch.arange(n, device=idx.device)[:, None] * p
    out = luts.to(torch.uint8).reshape(n * p, c)[flat]
    return out.reshape(tuple(idx.shape) + (c,))


def _crush(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor):
    """giflib's crushed-RGB key rules (giflib.cpp:1027-1046): extreme
    light/dark pixels search on their exact values, everything else on the
    5-bit midpoint; the cache key is the 15-bit crushed RGB. Returns
    (rc, gc, bc, crushed)."""
    extreme = (((r > 240) & (g > 240) & (b > 240))
               | ((r < 15) & (g < 15) & (b < 15)))
    rc = torch.where(extreme, r, (r & 0xF8) | 4)
    gc = torch.where(extreme, g, (g & 0xF8) | 4)
    bc = torch.where(extreme, b, (b & 0xF8) | 4)
    crushed = ((r >> 3) << 10) | ((g >> 3) << 5) | (b >> 3)
    return rc, gc, bc, crushed


def _nearest(rc, gc, bc, pal: torch.Tensor, dead: torch.Tensor):
    """Midpoint argmin and its distance over the palette rows.

    rc/gc/bc (F, n) int16 search colours, pal (F, P, 3) int16 RGB, dead
    (F, P) bool rows that never win. Returns (best (F, n) int64, least
    (F, n) int16); the first lowest row wins (giflib), and a pixel whose
    rows are all dead gets row 0 at distance _DEAD. The (F, n, P)
    distances are made at most _DIST_CHUNK at a time: a few frames, or
    a band of one frame's pixels."""
    f, n = rc.shape
    p = pal.shape[1]
    best = torch.empty((f, n), dtype=torch.int64, device=rc.device)
    least = torch.empty((f, n), dtype=torch.int16, device=rc.device)
    frames = max(1, _DIST_CHUNK // max(1, n * p))
    band = n if frames > 1 else max(1, _DIST_CHUNK // p)
    for s in range(0, f, frames):
        fs = slice(s, min(f, s + frames))
        pk = pal[fs, None]                                    # (k,1,P,3)
        for j in range(0, n, band):
            ps = slice(j, min(n, j + band))
            d = (rc[fs, ps, None] - pk[..., 0]).abs_()
            d += (gc[fs, ps, None] - pk[..., 1]).abs_()
            d += (bc[fs, ps, None] - pk[..., 2]).abs_()
            d.masked_fill_(dead[fs, None, :], _DEAD)
            least[fs, ps], best[fs, ps] = torch.min(d, dim=-1)
            del d
    return best, least


def _quantize_core(img: torch.Tensor, pal: torch.Tensor, pal_count: int,
                   prev_bgra: torch.Tensor, seen_keys: torch.Tensor,
                   cache_idx: torch.Tensor, trans: int, use_prev: bool):
    """One frame's quantizer with the crushed-key cache carried in
    seen_keys (CACHE_SIZE,) bool and cache_idx (CACHE_SIZE,) u8: `pal`
    may be padded past `pal_count` rows (masked out of the search) and
    `trans` is -1 for no transparency. Returns (indices (H, W) u8,
    new_seen, new_cache).

    Every pixel of a crushed key writes one value into the cache (its
    first occurrence's result, or the cached one), so the scatter is
    deterministic though many pixels share a key; transparent pixels
    write the dump slot (CACHE_SIZE - 1), which is reset in both tables
    and never read."""
    dev = img.device
    b = img[..., 0].to(torch.int32)
    g = img[..., 1].to(torch.int32)
    r = img[..., 2].to(torch.int32)
    a = img[..., 3].to(torch.int32)
    h, w = r.shape
    n = h * w
    have_trans = trans >= 0

    rc, gc, bc, crushed_hw = _crush(r, g, b)
    pal16 = pal.to(torch.int16)
    rows = torch.arange(pal.shape[0], device=dev)
    dead = rows >= pal_count
    if have_trans and trans < pal_count:
        dead = dead | (rows == trans)
    best_mid, least_mid = _nearest(
        rc.reshape(1, n).to(torch.int16), gc.reshape(1, n).to(torch.int16),
        bc.reshape(1, n).to(torch.int16), pal16[None], dead[None])
    best_mid, least_mid = best_mid[0], least_mid[0].to(torch.int32)

    rf, gf, bf = r.reshape(-1), g.reshape(-1), b.reshape(-1)
    crushed = crushed_hw.reshape(-1).to(torch.int64)
    # transparent pixels skip the cache (only when transparency exists)
    valid = (a.reshape(-1) >= 128) | (not have_trans)

    lin = torch.arange(n, device=dev)
    first_of_key = torch.full((CACHE_SIZE,), n, dtype=torch.int64, device=dev)
    first_of_key.scatter_reduce_(0, crushed, torch.where(valid, lin, n),
                                 "amin")
    first_idx = first_of_key[crushed]
    frame_first_best = best_mid[first_idx.clamp(0, n - 1)]

    seen = seen_keys[crushed]
    cached = cache_idx[crushed].to(torch.int64)
    best = torch.where(seen, cached, frame_first_best)
    is_first = valid & (first_idx == lin) & ~seen

    best_rgb = lut_select(pal, best).to(torch.int32)
    least_actual = ((rf - best_rgb[:, 0]).abs() + (gf - best_rgb[:, 1]).abs()
                    + (bf - best_rgb[:, 2]).abs())
    least = torch.where(is_first, least_mid, least_actual)

    if use_prev and have_trans:
        pb = prev_bgra.reshape(-1, prev_bgra.shape[-1]).to(torch.int32)
        dp = ((rf - pb[:, 2]).abs() + (gf - pb[:, 1]).abs()
              + (bf - pb[:, 0]).abs())
        best = torch.where(dp < least, trans, best)
    if have_trans:
        best = torch.where(valid, best, trans)

    crushed_w = torch.where(valid, crushed, CACHE_SIZE - 1)
    upd = torch.where(seen, cached, frame_first_best).to(torch.uint8)
    new_cache = cache_idx.index_put((crushed_w,), upd)
    new_seen = seen_keys.index_put((crushed_w,), torch.ones_like(valid))
    new_seen[CACHE_SIZE - 1] = False
    new_cache[CACHE_SIZE - 1] = 0
    return best.reshape(h, w).to(torch.uint8), new_seen, new_cache


def quantize_to_palette(img: torch.Tensor, palette_rgb: torch.Tensor,
                        prev_bgra: torch.Tensor, seen_keys: torch.Tensor,
                        cache_idx: torch.Tensor, trans_idx: int,
                        have_trans: bool, use_prev: bool):
    """(H, W, 4) u8 BGRA -> (H, W) u8 palette indices, the exact emulation
    of giflib.cpp:1006-1093 with its sequential crushed-key cache:

      * alpha < 128 and transparency available -> the transparent index,
        and the pixel does not touch the cache;
      * on a cache miss (the first occurrence of a crushed key in raster
        order) the search runs on the crushed midpoint ((c & 0xF8) | 4, or
        the exact value of an extreme light/dark pixel), Manhattan
        distance, first lowest index wins; least_dist is that distance;
      * on a hit the index comes from the cache (the key's first
        occurrence, possibly in an earlier frame of the same palette) and
        least_dist is the actual pixel's distance to it;
      * a pixel closer to the previous output frame's pixel than
        least_dist becomes transparent (smaller LZW).

    palette_rgb (N, 3) int RGB; seen_keys (CACHE_SIZE,) bool and
    cache_idx (CACHE_SIZE,) u8 persist across same-palette frames, and
    callers reset both when the palette changes (giflib.cpp:974-996).
    Returns (indices, new_seen, new_cache)."""
    trans_eff = trans_idx if have_trans else -1
    return _quantize_core(img, palette_rgb, palette_rgb.shape[0], prev_bgra,
                          seen_keys, cache_idx, int(trans_eff),
                          bool(use_prev))


def quantize_animation(frames: torch.Tensor, palettes: torch.Tensor,
                       pal_counts: torch.Tensor, trans_idx: torch.Tensor,
                       clear_flags: torch.Tensor,
                       use_prev_flags: torch.Tensor) -> torch.Tensor:
    """Quantize whole animations' composited frames at once, bit-identical
    to GifEncoder's sequential quantize_to_palette calls.

    The loop-carried cache collapses because clear_flags are set exactly
    when the palette bytes change (giflib.cpp:974-996): within a
    clear-delimited segment the palette is constant, so the value the
    cache holds for a crushed key is the midpoint argmin at the key's
    first valid occurrence in the segment (frame, then raster order). So
    the argmin vectorizes over every frame, "the cache" is one
    scatter-min of global pixel indices into a (segments x keys) table
    and one gather back, and the previous-frame optimization reads
    frames[k-1].

      frames         (..., N, H, W, 4) u8 composited, resized frames
      palettes       (..., N, 256, 3)  int RGB (rows >= pal_counts ignored)
      pal_counts     (..., N)          int effective palette sizes
      trans_idx      (..., N)          int transparent index (-1 = none)
      clear_flags    (..., N)          bool clear the cache BEFORE the frame
      use_prev_flags (..., N)          bool previous output frame valid for
                                       the transparency optimization

    Leading axes are independent animations. Returns (..., N, H, W) u8.
    """
    lead = tuple(frames.shape[:-4])
    nf, h, w = frames.shape[-4], frames.shape[-3], frames.shape[-2]
    dev = frames.device
    na = 1
    for d in lead:
        na *= d
    n = h * w
    f_all = na * nf
    fr = frames.reshape(f_all, n, 4)
    pal = palettes.reshape(f_all, -1, 3).to(torch.int16)
    counts = pal_counts.reshape(f_all, 1).to(torch.int64)
    trans = trans_idx.reshape(f_all).to(torch.int64)
    have_trans = trans >= 0                                   # (F,)

    b = fr[..., 0].to(torch.int16)
    g = fr[..., 1].to(torch.int16)
    r = fr[..., 2].to(torch.int16)
    a = fr[..., 3]
    rc, gc, bc, crushed = _crush(r, g, b)                     # (F, n)
    rows = torch.arange(pal.shape[1], device=dev)
    dead = ((rows >= counts)
            | (have_trans[:, None] & (rows == trans[:, None])
               & (trans[:, None] < counts)))                  # (F, P)
    best_mid, least_mid = _nearest(rc, gc, bc, pal, dead)
    del rc, gc, bc

    valid = (a >= 128) | ~have_trans[:, None]                 # (F, n)

    # segment-global first occurrence per animation. seg is 1-based when
    # frame 0 clears, so each animation needs nf + 1 segment slots (nf
    # slots would drop the last segment when every frame clears and the
    # count sits exactly on its bucket)
    seg = torch.cumsum(clear_flags.reshape(na, nf).to(torch.int64), dim=1)
    lane = torch.arange(na, device=dev)[:, None]
    slot = (lane * (nf + 1) + seg).reshape(f_all, 1)
    ckey = slot * (CACHE_SIZE - 1) + crushed.to(torch.int64)  # (F, n)
    table_n = na * (nf + 1) * (CACHE_SIZE - 1)
    total = f_all * n
    glin = torch.arange(total, device=dev).reshape(f_all, n)
    table = torch.full((table_n,), total, dtype=torch.int64, device=dev)
    table.scatter_reduce_(0, ckey.reshape(-1),
                          torch.where(valid, glin, total).reshape(-1), "amin")
    first_g = table[ckey]
    del table
    is_first = valid & (first_g == glin)
    best = torch.where(
        valid, best_mid.reshape(-1)[first_g.clamp(max=total - 1)], best_mid)
    del first_g, glin, ckey

    # least_dist: the midpoint distance at the first occurrence, the
    # actual distance to the cached colour everywhere else
    ri, gi, bi = r.to(torch.int32), g.to(torch.int32), b.to(torch.int32)
    best_rgb = lut_select_batched(pal, best).to(torch.int32)  # (F, n, 3)
    least = torch.where(
        is_first, least_mid.to(torch.int32),
        (ri - best_rgb[..., 0]).abs() + (gi - best_rgb[..., 1]).abs()
        + (bi - best_rgb[..., 2]).abs())
    del best_rgb

    # the previous-frame transparency optimization vs the previous INPUT
    # frame of the same animation
    prev = torch.zeros_like(fr.reshape(na, nf, n, 4))
    prev[:, 1:] = fr.reshape(na, nf, n, 4)[:, :-1]
    pb = prev.reshape(f_all, n, 4).to(torch.int32)
    dp = ((ri - pb[..., 2]).abs() + (gi - pb[..., 1]).abs()
          + (bi - pb[..., 0]).abs())
    del prev, pb
    tr = trans[:, None]
    usep = use_prev_flags.reshape(f_all, 1) & have_trans[:, None]
    best = torch.where(usep & (dp < least), tr, best)
    best = torch.where(have_trans[:, None] & ~valid, tr, best)
    return best.to(torch.uint8).reshape(lead + (nf, h, w))


def _packed(u8x4: torch.Tensor) -> torch.Tensor:
    """(..., 4) u8 -> (...) int32 holding the four bytes (B in the low
    byte on a little-endian host, as the pixels lie in memory)."""
    return u8x4.contiguous().view(torch.int32).squeeze(-1)


def composite_animation(idx_frames: torch.Tensor, drawn_masks: torch.Tensor,
                        luts: torch.Tensor, pal_counts: torch.Tensor,
                        trans_idx: torch.Tensor, prev_disposal: torch.Tensor,
                        prev_rect_masks: torch.Tensor,
                        bg_bgra: torch.Tensor) -> torch.Tensor:
    """Composite whole GIF animations: the dispose/draw dependence
    (giflib.cpp:400-541) as a loop over frames carrying (canvas,
    prev_canvas), each step a few ``torch.where`` over every animation of
    the leading axes at once. Every per-frame input is pre-scattered to
    canvas shape on the host:

      idx_frames      (..., N, H, W)   u8 palette indices scattered into
                                       the canvas
      drawn_masks     (..., N, H, W)   bool, inside the frame's clipped rect
      luts            (..., N, 256, 4) u8 BGRA palette
      pal_counts      (..., N)         int effective palette sizes
      trans_idx       (..., N)         int transparent index (-1 = none)
      prev_disposal   (..., N)         int GIF disposal of frame k-1 (0 for
                                       k = 0)
      prev_rect_masks (..., N, H, W)   bool rect of frame k-1
      bg_bgra         (..., 4)         u8 background

    Returns (..., N, H, W, 4) u8 composited frames.
    """
    lead = tuple(idx_frames.shape[:-3])
    n, h, w = idx_frames.shape[-3:]
    dev = idx_frames.device
    na = 1
    for d in lead:
        na *= d
    idxs = idx_frames.reshape(na, n, h * w)
    drawn = drawn_masks.reshape(na, n, h * w)
    prects = prev_rect_masks.reshape(na, n, h * w)
    lut32 = _packed(luts.reshape(na, n, -1, 4))               # (A, N, 256)
    counts = pal_counts.reshape(na, n, 1).to(torch.int64)
    trans = trans_idx.reshape(na, n, 1).to(torch.int64)
    disp = prev_disposal.reshape(na, n, 1)
    init = _packed(bg_bgra.reshape(na, 1, 4)).expand(na, h * w)
    canvas = init
    prev = torch.zeros((na, h * w), dtype=torch.int32, device=dev)
    out = torch.empty((na, n, h * w), dtype=torch.int32, device=dev)
    lim = lut32.shape[-1] - 1
    for k in range(n):
        m = prects[:, k]
        # dispose the previous frame's region (giflib.cpp:400-489)
        canvas = torch.where((disp[:, k] == 2) & m, init, canvas)
        canvas = torch.where((disp[:, k] == 3) & m, prev, canvas)
        # saved post-disposal, pre-draw; giflib's prev_frame_bgra starts
        # zeroed and is never saved before frame 1 (giflib.cpp:491-494)
        if k > 0:
            prev = canvas
        idx = idxs[:, k].to(torch.int64)
        color = torch.gather(lut32[:, k], 1, idx.clamp(0, lim))
        valid = drawn[:, k] & (idx != trans[:, k]) & (idx < counts[:, k])
        canvas = torch.where(valid, color, canvas)
        out[:, k] = canvas
    return out.view(torch.uint8).reshape(lead + (n, h, w, 4))


def composite_animation_rgba(frames_full: torch.Tensor,
                             drawn_masks: torch.Tensor,
                             blend_flags: torch.Tensor,
                             prev_disposal: torch.Tensor,
                             prev_rect_masks: torch.Tensor) -> torch.Tensor:
    """Composite animated-WebP-style clips (the JAX package's
    composite_animation_rgba, a lax.scan): a loop over frames of
    ``torch.where`` and ``ops.blend.alpha_blend_full`` over every
    animation of the leading axes at once, so a batch needs no vmap.

    Frames carry their own BGRA pixels, scattered to canvas shape on the
    host (zeros outside the rect); per-frame blend is WebP's (0 = alpha
    blend, 1 = replace) and disposal 1 clears the previous frame's rect to
    transparent: the ops the streaming ImageOps path applies per frame
    (ops.go:150-218, 431-461), so the outputs are byte-identical.

      frames_full     (..., N, H, W, 4) u8
      drawn_masks     (..., N, H, W)    bool
      blend_flags     (..., N)          int (0 blend / 1 no-blend)
      prev_disposal   (..., N)          int disposal of frame k-1 (0 for
                                        k = 0)
      prev_rect_masks (..., N, H, W)    bool rect of frame k-1

    Returns (..., N, H, W, 4) u8 composited frames.
    """
    from .blend import alpha_blend_full
    lead = tuple(frames_full.shape[:-4])
    n, h, w = frames_full.shape[-4:-1]
    na = 1
    for d in lead:
        na *= d
    frames = frames_full.reshape(na, n, h, w, 4)
    drawn = drawn_masks.reshape(na, n, h, w, 1)
    prects = prev_rect_masks.reshape(na, n, h, w, 1)
    blend = blend_flags.reshape(na, n, 1, 1, 1)
    disp = prev_disposal.reshape(na, n, 1, 1, 1)
    canvas = torch.zeros((na, h, w, 4), dtype=torch.uint8,
                         device=frames.device)
    out = torch.empty((na, n, h, w, 4), dtype=torch.uint8,
                      device=frames.device)
    for k in range(n):
        frame, drawn_k = frames[:, k], drawn[:, k]
        canvas = torch.where((disp[:, k] == 1) & prects[:, k], 0, canvas)
        blended = alpha_blend_full(canvas, frame)
        canvas = torch.where(drawn_k & (blend[:, k] == 0), blended, canvas)
        canvas = torch.where(drawn_k & (blend[:, k] != 0), frame, canvas)
        out[:, k] = canvas
    return out.reshape(lead + (n, h, w, 4))
