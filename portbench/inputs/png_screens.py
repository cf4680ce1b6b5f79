"""Input maker: distinct desktop-screenshot PNGs, made from the seed.

Each source is what a window capture of a chat client looks like: flat
UI panels (a server rail, a channel list, a header bar with a vertical
gradient, buttons and cards with one-pixel borders, a full-width dotted
rule of black and white pixels in turn, as a selection marquee draws
it), rows of
anti-aliased text-like glyphs in the list and the message area, one
photographic region (jpeg_photos.photo_rgb's content) covering
``photo_share`` of the area, and opaque alpha except transparent rounded
corners. The pixels are composed on the device; the PNG is written here,
without the program: all five filter types computed over the whole
image, chosen per row by the least sum of absolute values (libpng's
heuristic, each byte read as signed), compressed by Python's zlib at
``zlib_level`` and cut into 8 KiB IDAT chunks, as libpng writes them.
The source pixels are kept for the reference.

Parameters (the cell's "inputs"): width, height, sources (how many
distinct), channels (4: RGBA8, colour type 6; 3: RGB8, colour type 2),
photo_share, zlib_level.
"""

from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from portbench.inputs.jpeg_photos import photo_rgb

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
#: libpng's IDAT chunk size (PNG_ZBUF_SIZE)
IDAT_BYTES = 8192
#: text metrics at every size: a glyph cell and a line
CELL_W, CELL_H, LINE_H = 9, 16, 22
GLYPHS = 80


def _chunk(ctype: bytes, data: bytes) -> bytes:
    body = ctype + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def filter_rows(px: torch.Tensor) -> torch.Tensor:
    """(h, w, c) u8 pixels -> (h, 1 + w*c) u8 filtered scanlines: each
    row under the filter type (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)
    whose bytes, read as signed, have the least sum of absolute values
    (the lowest type on a tie)."""
    h, w, c = px.shape
    x = px.reshape(h, w * c).to(torch.int16)
    a = F.pad(x, (c, 0))[:, :w * c]
    b = torch.cat([torch.zeros_like(x[:1]), x[:-1]])
    d = F.pad(b, (c, 0))[:, :w * c]
    p = a + b - d
    pa, pb, pc = (p - a).abs(), (p - b).abs(), (p - d).abs()
    paeth = torch.where((pa <= pb) & (pa <= pc), a,
                        torch.where(pb <= pc, b, d))
    cand = torch.remainder(torch.stack(
        [x, x - a, x - b, x - torch.div(a + b, 2, rounding_mode="floor"),
         x - paeth]), 256)
    cost = torch.where(cand < 128, cand, 256 - cand).to(torch.int32).sum(-1)
    kind = torch.argmin(cost, dim=0)
    rows = torch.gather(cand, 0, kind[None, :, None].expand(
        1, h, w * c))[0]
    return torch.cat([kind[:, None], rows], 1).to(torch.uint8)


def png_bytes(filtered: np.ndarray, w: int, h: int, channels: int,
              level: int) -> bytes:
    """The PNG of (h, 1 + w*channels) filtered scanlines, 8 bits a
    sample, zlib at `level`, 8 KiB IDAT chunks."""
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6 if channels == 4 else 2, 0, 0,
                       0)
    comp = zlib.compress(filtered.tobytes(), level)
    idats = [_chunk(b"IDAT", comp[i:i + IDAT_BYTES])
             for i in range(0, len(comp), IDAT_BYTES)]
    return b"".join([PNG_MAGIC, _chunk(b"IHDR", ihdr)] + idats
                    + [_chunk(b"IEND", b"")])


def _glyph_atlas(rng: np.random.Generator, device) -> torch.Tensor:
    """(GLYPHS + 1, CELL_H, CELL_W) float32 coverage in 0..1 of
    stroke-like glyphs (a 5x3 grid of random strokes, scaled, edges
    softened); the last glyph is a blank."""
    grid = (rng.random((GLYPHS, 1, 5, 3)) < 0.45).astype(np.float32)
    g = F.interpolate(torch.from_numpy(grid), size=(11, 6), mode="nearest")
    g = F.avg_pool2d(F.pad(g, (1, 1, 1, 1)), 2, stride=1)
    atlas = torch.zeros(GLYPHS + 1, CELL_H, CELL_W)
    atlas[:GLYPHS, 3:3 + g.shape[2], 1:1 + g.shape[3]] = g[:, 0]
    return atlas.to(device)


def _text(rng: np.random.Generator, atlas: torch.Tensor, rows: int,
          cols: int, fill: float) -> torch.Tensor:
    """(rows*LINE_H, cols*CELL_W) text coverage: lines of words (a blank
    after about every sixth glyph), each line filled to a random share
    of its width, a share `fill` of the lines written."""
    idx = rng.integers(0, GLYPHS, (rows, cols))
    idx[rng.random((rows, cols)) < 0.17] = GLYPHS
    length = (rng.uniform(0.2, 1.0, rows) * cols).astype(int)
    idx[np.arange(cols)[None, :] >= length[:, None]] = GLYPHS
    idx[rng.random(rows) > fill] = GLYPHS
    cells = atlas[torch.from_numpy(idx).to(atlas.device)]
    lines = F.pad(cells, (0, 0, 0, LINE_H - CELL_H))
    return lines.permute(0, 2, 1, 3).reshape(rows * LINE_H, cols * CELL_W)


def screen(rng: np.random.Generator, g: torch.Generator, h: int, w: int,
           photo_share: float, device) -> torch.Tensor:
    """(h, w, 4) u8 RGBA of one screenshot."""
    def colour(lo, hi):
        return torch.tensor(rng.uniform(lo, hi, 3), dtype=torch.float32,
                            device=device)
    dark = rng.random() < 0.7
    base = (30, 70) if dark else (215, 250)
    img = colour(*base)[None, None].expand(h, w, 3).clone()
    rail = int(w * rng.uniform(0.025, 0.04))
    side = rail + int(w * rng.uniform(0.09, 0.14))
    head = max(4, int(h * rng.uniform(0.03, 0.045)))
    img[:, :rail] = colour(*base) * 0.8
    img[:, rail:side] = colour(*base) * 0.9
    ramp = torch.linspace(1.0, 0.85, head, device=device)[:, None, None]
    img[:head, side:] = colour(*base) * ramp
    for _ in range(int(rng.integers(6, 13))):
        y0, x0 = int(rng.integers(head, h - 8)), int(rng.integers(side, w - 8))
        bh = int(rng.integers(6, max(8, h // 10)))
        bw = int(rng.integers(12, max(16, w // 6)))
        img[y0:y0 + bh, x0:x0 + bw] = colour(*base) * 0.6
        img[y0 + 1:y0 + bh - 1, x0 + 1:x0 + bw - 1] = colour(0, 255)
    atlas = _glyph_atlas(rng, device)
    for x0, x1, y0, fill in ((rail, side, head, 0.9),
                             (side, w, head, 0.6)):
        rows, cols = (h - y0 - 4) // LINE_H, (x1 - x0 - 16) // CELL_W
        if rows > 0 and cols > 0:
            cover = _text(rng, atlas, rows, cols, fill)[..., None]
            ink = colour(180, 240) if dark else colour(10, 70)
            sl = img[y0 + 4:y0 + 4 + cover.shape[0],
                     x0 + 8:x0 + 8 + cover.shape[1]]
            sl.copy_(sl * (1 - cover) + ink * cover)
    aspect = rng.uniform(1.2, 1.8)
    ph = min(h, max(2, int(round((photo_share * h * w / aspect) ** 0.5))))
    pw = min(w, max(2, int(round(photo_share * h * w / ph))))
    y0, x0 = int(rng.integers(0, h - ph + 1)), int(rng.integers(0, w - pw + 1))
    img[y0:y0 + ph, x0:x0 + pw] = photo_rgb(g, 1, ph, pw, 1.75, 6,
                                            device)[0].permute(1, 2, 0)
    rule = int(rng.integers(head, h - head))
    img[rule] = 255.0 * (torch.arange(w, device=device) % 2)[:, None]
    alpha = torch.full((h, w, 1), 255.0, device=device)
    r = max(1, min(10, h // 8, w // 8))
    yy = torch.arange(r, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(r, device=device, dtype=torch.float32)[None, :]
    outside = ((r - 0.5 - yy) ** 2 + (r - 0.5 - xx) ** 2) > r * r
    for ys in (slice(0, r), slice(h - r, h)):
        for xs in (slice(0, r), slice(w - r, w)):
            o = outside.flip(0) if ys.start else outside
            o = o.flip(1) if xs.start else o
            alpha[ys, xs][o] = 0.0
    rgba = torch.cat([img, alpha], -1)
    rgba = torch.where(alpha > 0, rgba, torch.zeros_like(rgba))
    return torch.clamp(torch.round(rgba), 0, 255).to(torch.uint8)


def make(params: Dict, seed: int, device) -> Dict:
    """{"bufs": the PNGs, "sources": per source {width, height, channels,
    pixels ((h, w, channels) u8 RGB(A), numpy)}, "bytes_per_source": the
    mean PNG size}."""
    w, h, n = params["width"], params["height"], params["sources"]
    c = params.get("channels", 4)
    rng = np.random.default_rng([int(seed) % (1 << 63), 26])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    sources: List[Dict] = []
    filtered = []
    for _ in range(n):
        px = screen(rng, g, h, w, params["photo_share"], device)[..., :c]
        filtered.append(filter_rows(px).cpu().numpy())
        sources.append({"width": w, "height": h, "channels": c,
                        "pixels": px.cpu().numpy()})
    with ThreadPoolExecutor(8) as ex:
        bufs = list(ex.map(lambda f: png_bytes(f, w, h, c,
                                               params["zlib_level"]),
                           filtered))
    return {"bufs": bufs, "sources": sources,
            "bytes_per_source": float(np.mean([len(b) for b in bufs]))}
