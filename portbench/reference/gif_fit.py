"""Plain reference of the animated GIF Fit transcode (avatar128_gif).

From an animation's index frames, palettes and frame fields, as the input
maker wrote them, it works out the palette indices each output frame has
to hold, with lilliput's semantics (giflib.cpp, as the program documents
them):

* composite: a canvas of the background colour (the global palette's
  background entry, transparent when the first graphics control
  extension has a transparent index); before frame k the previous
  frame's rect is disposed (2: to the background, 3: to the canvas saved
  before that frame was drawn); a frame draws its pixels inside its rect
  clipped to the canvas, except its transparent index;
* Fit: the centre crop (jpeg_fit.fit_rect), then cv::resize INTER_AREA of
  the four BGRA channels, rounded half to even;
* quantize, per frame in order, to the frame's own palette: the
  transparent index resolved as the encoder does (forced to the last
  entry on a partial frame without one; dropped when it is the opaque
  background's entry of the global palette), the crushed-RGB cache
  (15-bit keys, cleared when the palette's bytes change; a miss searches
  the key's midpoint, or the exact colour of a very light or dark pixel,
  by |dR|+|dG|+|dB|, the first lowest entry winning, never the
  transparent one), a pixel closer to the previous input frame's than to
  its colour made transparent (when the previous frame kept its canvas),
  and alpha under 128 made transparent.

The resize runs in ``dtype`` on ``device``: float64 for the reference, a
lower precision for the control. Nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .jpeg_fit import area_matrix, fit_rect


def _clip(left, top, w, h, cw, ch):
    w, h = min(w, cw - left), min(h, ch - top)
    return left, top, max(w, 0), max(h, 0)


def _frame_palette(anim: Dict, f: Dict) -> np.ndarray:
    return f["palette"] if f["palette"] is not None \
        else anim["global_palette"]


def background(anim: Dict) -> np.ndarray:
    """The canvas's starting BGRA."""
    pal = anim["global_palette"]
    bg = pal[anim["bg_index"]]
    alpha = 0 if anim["frames"][0]["trans"] >= 0 else 255
    return np.array([bg[2], bg[1], bg[0], alpha], np.uint8)


def composite(anim: Dict) -> np.ndarray:
    """(N, H, W, 4) u8 BGRA frames as shown."""
    cw, ch = anim["width"], anim["height"]
    init = np.broadcast_to(background(anim), (ch, cw, 4))
    canvas = init.copy()
    saved = np.zeros_like(canvas)
    out = []
    prev = None
    for k, f in enumerate(anim["frames"]):
        if prev is not None:
            pl, pt, pw, ph = _clip(prev["left"], prev["top"],
                                   prev["indices"].shape[1],
                                   prev["indices"].shape[0], cw, ch)
            if prev["disposal"] == 2:
                canvas[pt:pt + ph, pl:pl + pw] = init[pt:pt + ph, pl:pl + pw]
            elif prev["disposal"] == 3:
                canvas[pt:pt + ph, pl:pl + pw] = saved[pt:pt + ph,
                                                       pl:pl + pw]
        if k > 0:
            saved = canvas.copy()
        pal = _frame_palette(anim, f)
        lut = np.zeros((256, 4), np.uint8)
        lut[:len(pal), :3] = pal[:, ::-1]
        lut[:len(pal), 3] = 255
        l, t, w, h = _clip(f["left"], f["top"], f["indices"].shape[1],
                           f["indices"].shape[0], cw, ch)
        idx = f["indices"][:h, :w]
        draw = idx < len(pal)
        if f["trans"] >= 0:
            draw &= idx != f["trans"]
        region = canvas[t:t + h, l:l + w]
        region[draw] = lut[idx[draw]]
        out.append(canvas.copy())
        prev = f
    return np.stack(out)


def fit_frames(frames: np.ndarray, dst_w: int, dst_h: int, dtype,
               device) -> np.ndarray:
    """(N, H, W, 4) u8 -> (N, dst_h, dst_w, 4) u8: Fit crop + AREA."""
    _, h, w, _ = frames.shape
    left, top, cw, ch = fit_rect(w, h, dst_w, dst_h)
    x = torch.from_numpy(np.ascontiguousarray(
        frames[:, top:top + ch, left:left + cw])).to(device)
    x = x.to(dtype).permute(0, 3, 1, 2)
    my = area_matrix(ch, dst_h, dtype, device)
    mx = area_matrix(cw, dst_w, dtype, device)
    y = torch.clamp(torch.round(torch.matmul(torch.matmul(my, x), mx.T)),
                    0, 255)
    return y.permute(0, 2, 3, 1).to(torch.uint8).cpu().numpy()


def plans(anim: Dict) -> List[Dict]:
    """Per output frame: trans (-1: none), palette (RGB rows in force),
    local (whether it is written as a local palette), clear (the cache is
    cleared before it) and use_prev."""
    cw, ch = anim["width"], anim["height"]
    gpal = anim["global_palette"]
    bg_opaque = background(anim)[3] == 255
    out, prev_bytes, prev_disposal, first = [], None, 0, True
    for f in anim["frames"]:
        pal = _frame_palette(anim, f)
        trans = f["trans"]
        l, t, w, h = _clip(f["left"], f["top"], f["indices"].shape[1],
                           f["indices"].shape[0], cw, ch)
        if (w < cw or h < ch or l or t) and trans < 0:
            trans = len(pal) - 1
        local = f["palette"] is not None
        if (trans >= 0 and not local and len(gpal) > 0
                and trans == anim["bg_index"] and bg_opaque):
            trans = -1
        pb = pal.tobytes()
        out.append({"trans": trans, "palette": pal, "local": local,
                    "clear": pb != prev_bytes,
                    "use_prev": (not first) and prev_disposal in (0, 1)
                    and trans >= 0})
        prev_bytes, prev_disposal, first = pb, f["disposal"], False
    return out


def quantize(frames: np.ndarray, plan: List[Dict]) -> np.ndarray:
    """(N, H, W, 4) u8 BGRA -> (N, H, W) u8 indices."""
    n, h, w, _ = frames.shape
    px = frames.reshape(n, h * w, 4).astype(np.int64)
    b, g, r, a = px[..., 0], px[..., 1], px[..., 2], px[..., 3]
    out = np.zeros((n, h * w), np.uint8)
    cache: Dict[int, int] = {}
    for k, p in enumerate(plan):
        if p["clear"]:
            cache = {}
        pal = p["palette"].astype(np.int64)
        trans = p["trans"]
        live = np.ones(len(pal), bool)
        if 0 <= trans < len(pal):
            live[trans] = False
        rk, gk, bk = r[k], g[k], b[k]
        key = (rk >> 3) << 10 | (gk >> 3) << 5 | (bk >> 3)
        valid = (a[k] >= 128) | (trans < 0)
        extreme = ((rk > 240) & (gk > 240) & (bk > 240)) | \
            ((rk < 15) & (gk < 15) & (bk < 15))
        best = np.zeros(h * w, np.int64)
        least = np.zeros(h * w, np.int64)
        first = np.zeros(h * w, bool)
        vi = np.nonzero(valid)[0]
        ukeys, uidx = np.unique(key[vi], return_index=True)
        pos = vi[uidx]
        miss = np.array([int(u) not in cache for u in ukeys], bool)
        mpos = pos[miss]
        if mpos.size:
            sc = np.stack([np.where(extreme[mpos], c[mpos], (c[mpos] & 0xF8) | 4)
                           for c in (rk, gk, bk)], 1)
            d = np.abs(sc[:, None, :] - pal[None, :, :]).sum(-1)
            d[:, ~live] = 1 << 20
            sel = d.argmin(1)
            for u, s in zip(ukeys[miss], sel):
                cache[int(u)] = int(s)
            first[mpos] = True
            least[mpos] = d[np.arange(mpos.size), sel]
        lookup = np.array([cache[int(u)] for u in ukeys], np.int64)
        best[vi] = lookup[np.searchsorted(ukeys, key[vi])]
        chosen = pal[best]
        actual = np.abs(rk - chosen[:, 0]) + np.abs(gk - chosen[:, 1]) + \
            np.abs(bk - chosen[:, 2])
        least = np.where(first, least, actual)
        if p["use_prev"] and k > 0:
            dp = np.abs(rk - r[k - 1]) + np.abs(gk - g[k - 1]) + \
                np.abs(bk - b[k - 1])
            best = np.where(dp < least, trans, best)
        if trans >= 0:
            best = np.where(valid, best, trans)
        out[k] = best
    return out.reshape(n, h, w)


def transcode_indices(anim: Dict, dst_w: int, dst_h: int,
                      dtype=torch.float64, device="cpu"):
    """(indices (N, dst_h, dst_w) u8, plans) of the Fit transcode."""
    frames = fit_frames(composite(anim), dst_w, dst_h, dtype, device)
    plan = plans(anim)
    return quantize(frames, plan), plan


def emit(anim: Dict, params: Dict, dtype, device) -> bytes:
    """The reference put in the program's place: the output GIF of `anim`
    computed in `dtype` and LZW-coded by the frozen encoder, its frames
    whole-canvas with the source frames' fields."""
    from portbench import native
    idx, plan = transcode_indices(anim, params["dst_w"], params["dst_h"],
                                  dtype, device)
    frames = [{"indices": idx[k], "left": 0, "top": 0,
               "palette": p["palette"] if p["local"] else None,
               "trans": p["trans"], "disposal": f["disposal"],
               "delay_cs": f["delay_cs"], "interlace": f["interlace"],
               "ext": f.get("ext", b"")}
              for k, (p, f) in enumerate(zip(plan, anim["frames"]))]
    return native.gif_encode(params["dst_w"], params["dst_h"],
                             anim["global_palette"], anim["bg_index"],
                             frames)


def index_share(buf: bytes, anim: Dict, dst_w: int, dst_h: int,
                want=None) -> float:
    """Share of the output's palette indices unlike the reference's; 1.0
    when the output does not parse or differs in its frames' layout,
    palettes, transparency, disposal or timing."""
    from .gif_decode import decode_gif
    if want is None:
        want = transcode_indices(anim, dst_w, dst_h)
    idx, plan = want
    try:
        got = decode_gif(buf)
    except ValueError:
        return 1.0
    if (got["width"], got["height"]) != (dst_w, dst_h) or \
            len(got["frames"]) != len(plan):
        return 1.0
    differ = 0
    for k, (f, p, src) in enumerate(zip(got["frames"], plan,
                                        anim["frames"])):
        pal = f["palette"] if f["palette"] is not None \
            else got["global_palette"]
        if (f["left"], f["top"], f["indices"].shape) != (0, 0, idx[k].shape) \
                or f["trans"] != p["trans"] \
                or (f["palette"] is not None) != p["local"] \
                or pal is None or not np.array_equal(
                    pal[:len(p["palette"])], p["palette"]) \
                or f["disposal"] != src["disposal"] \
                or f["delay_cs"] != src["delay_cs"]:
            return 1.0
        differ += int(np.count_nonzero(f["indices"] != idx[k]))
    return differ / idx.size


def check(anims: List[Dict], outputs: Dict[int, bytes], params: Dict,
          device) -> Dict[str, float]:
    """The compared numbers of an animated GIF Fit cell. outputs maps a
    sampled animation's index to one output the program gave for it.
    index_share: the largest share, over those outputs, of output palette
    indices unlike the reference's."""
    worst = 0.0
    for i, buf in outputs.items():
        worst = max(worst, index_share(
            buf, anims[i], params["dst_w"], params["dst_h"],
            transcode_indices(anims[i], params["dst_w"], params["dst_h"],
                              device=device)))
    return {"index_share": worst}
