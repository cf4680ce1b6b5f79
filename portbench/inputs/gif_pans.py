"""Input maker: distinct animated GIFs that pan across photo-like canvases.

The frame structure follows phase 8 of chip_smoke.py (``pan_frames`` of
tests/_torch_gif_builders.py): a 3-3-2 global palette, every fourth frame
on a local 6x6x6 palette, frames 1, 4, 7, ... partial rects (frame 4 runs
off the canvas at the bottom right), a transparent band on every third
frame, disposals 1, 2, 3, 0 in turn, frame 5 interlaced, delays of 4-6
centiseconds, the NETSCAPE loop extension and a comment. The photos
are jpeg_photos.photo_rgb's, made on the device from the seed; the LZW
streams are written by the frozen copy of the program's GIF encoder
(portbench/native), dictionary LZW as a real file has. The index frames,
palettes and frame fields are kept for the reference.

Parameters: canvas (the square size), frame_counts (one per animation:
every seed gets this set, in an order drawn from the seed), photo_width,
photo_height, photos (how many the animations share), texture, rects.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np
import torch

from portbench import native
from portbench.inputs.jpeg_photos import photo_rgb

BG_INDEX = 3


def palette_332() -> np.ndarray:
    i = np.arange(256)
    return np.stack([(i >> 5) * 255 // 7, ((i >> 2) & 7) * 255 // 7,
                     (i & 3) * 255 // 3], axis=1).astype(np.uint8)


def palette_666() -> np.ndarray:
    i = np.arange(216)
    cube = np.stack([i // 36, (i // 6) % 6, i % 6], axis=1) * 51
    gray = np.repeat((np.arange(40) * 255 // 39)[:, None], 3, axis=1)
    return np.concatenate([cube, gray]).astype(np.uint8)


def _q332(rgb: np.ndarray) -> np.ndarray:
    r, g, b = (rgb[..., k].astype(np.int64) for k in range(3))
    return ((r >> 5) << 5 | (g >> 5) << 2 | (b >> 6)).astype(np.uint8)


def _q666(rgb: np.ndarray) -> np.ndarray:
    q = (rgb.astype(np.int64) * 5 + 127) // 255
    return (q[..., 0] * 36 + q[..., 1] * 6 + q[..., 2]).astype(np.uint8)


def _netscape(loops: int) -> bytes:
    return b"\xff\x0bNETSCAPE2.0\x03\x01" + loops.to_bytes(2, "little") + \
        b"\x00"


def _comment(text: bytes) -> bytes:
    return b"\xfe" + bytes([len(text)]) + text + b"\x00"


def pan_frames(q332: np.ndarray, q666: np.ndarray, size: int, nframes: int,
               start: int) -> List[Dict]:
    """The frames of one animation (native.gif_encode's frame dicts)."""
    h, w = q332.shape
    span_x, span_y = max(1, w - size), max(1, h - size)
    pal666 = palette_666()
    frames = []
    for k in range(nframes):
        t = start + 7 * k
        x0, y0 = (t * 13) % span_x, (t * 5) % span_y
        local = k % 4 == 3
        idx = (q666 if local else q332)[y0:y0 + size, x0:x0 + size].copy()
        f = {"indices": idx, "left": 0, "top": 0,
             "palette": pal666 if local else None, "trans": -1,
             "disposal": (1, 2, 3, 0)[k % 4], "delay_cs": 4 + k % 3,
             "interlace": k == 5, "ext": b""}
        if k % 3 == 2:
            f["trans"] = 7 if local else 255
            idx[size // 3:size // 3 + size // 8] = f["trans"]
        if k % 3 == 1:
            r0 = size // 8 + (k % 5) * (size // 16)
            if k == 4:
                f["left"], f["top"] = size - size // 4, size - size // 4
                f["indices"] = idx[:size // 2, :size // 2].copy()
            else:
                f["left"], f["top"] = r0, size // 6
                f["indices"] = idx[:size // 2, :size - r0].copy()
        frames.append(f)
    frames[0]["ext"] = _netscape(0)
    if nframes > 1:
        frames[1]["ext"] = _comment(b"portbench pan")
    return frames


def make(params: Dict, seed: int, device) -> Dict:
    """{"bufs": the GIFs, "sources": per animation {width, height,
    global_palette, bg_index, frames}, "frames": the frame count}."""
    size = params["canvas"]
    rng = np.random.default_rng(seed)
    counts = [params["frame_counts"][i]
              for i in rng.permutation(len(params["frame_counts"]))]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    photos = []
    for _ in range(params["photos"]):
        rgb = photo_rgb(g, 1, params["photo_height"], params["photo_width"],
                        params["texture"], params["rects"], device)
        rgb = rgb[0].permute(1, 2, 0).to(torch.uint8).cpu().numpy()
        photos.append((_q332(rgb), _q666(rgb)))
    starts = rng.integers(0, 1 << 16, len(counts))
    sources = []
    for k, n in enumerate(counts):
        q332, q666 = photos[k % len(photos)]
        sources.append({"width": size, "height": size,
                        "global_palette": palette_332(),
                        "bg_index": BG_INDEX,
                        "frames": pan_frames(q332, q666, size, n,
                                             int(starts[k]))})

    def encode(src):
        return native.gif_encode(size, size, src["global_palette"],
                                 src["bg_index"], src["frames"])
    with ThreadPoolExecutor(8) as ex:
        bufs = list(ex.map(encode, sources))
    return {"bufs": bufs, "sources": sources, "frames": int(sum(counts))}
