"""Input maker: distinct photo-like 4:2:0 JPEGs, made from the seed.

Each source is a smooth colour field (a coarse random grid, upsampled),
a few hard-edged rectangles of other colours, and fine texture (smoothed
noise): gradients, edges and noise, at about the bits per pixel of a
camera photo at its quality. The planes are made on the device with a
torch.Generator, converted to YCbCr, the chroma averaged 2x2, transformed
by the 8x8 DCT and quantized by the IJG tables of each source's quality;
the frozen copy of the program's entropy encoder (portbench/native) writes
the JPEG. The quantized coefficients and tables are kept, so the
reference works from them and never from the program.

Parameters (the cell's "inputs"): width, height, sources (how many
distinct), qualities (the set the sources cycle through, in an order drawn
from the seed), orientation (EXIF, 1 or 6), texture (the noise's standard
deviation in u8 steps), rects (hard-edged rectangles per source).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from portbench import native
from portbench.reference.jpeg_fit import dct_matrix, ijg_tables


def exif_app1(orientation: int) -> bytes:
    """An APP1 Exif segment whose big-endian TIFF holds one entry: tag
    0x0112 (Orientation), SHORT, count 1."""
    tiff = (b"MM\x00*" + (8).to_bytes(4, "big") + (1).to_bytes(2, "big")
            + (0x0112).to_bytes(2, "big") + (3).to_bytes(2, "big")
            + (1).to_bytes(4, "big") + orientation.to_bytes(2, "big")
            + bytes(2) + bytes(4))
    return (b"\xff\xe1" + (len(tiff) + 8).to_bytes(2, "big")
            + b"Exif\x00\x00" + tiff)


def photo_rgb(g: torch.Generator, n: int, h: int, w: int, texture: float,
              rects: int, device) -> torch.Tensor:
    """(n, 3, h, w) float32 RGB in 0..255 (rounded to integers)."""
    def rand(*shape):
        return torch.rand(shape, generator=g, device=device)
    coarse = 40 + 175 * rand(n, 3, 5, 8)
    img = F.interpolate(coarse, size=(h, w), mode="bicubic",
                        align_corners=False)
    ys = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    box = rand(n, rects, 4)
    col = 20 + 215 * rand(n, rects, 3)
    for k in range(rects):
        y0 = box[:, k, 0, None, None] * h * 0.8
        x0 = box[:, k, 1, None, None] * w * 0.8
        y1 = y0 + (0.1 + 0.3 * box[:, k, 2, None, None]) * h
        x1 = x0 + (0.1 + 0.3 * box[:, k, 3, None, None]) * w
        inside = ((ys >= y0) & (ys < y1) & (xs >= x0) & (xs < x1))[:, None]
        img = torch.where(inside, col[:, k, :, None, None] + 0.25 * (
            img - img.mean(dim=(2, 3), keepdim=True)), img)
    noise = torch.randn((n, 1, h, w), generator=g, device=device)
    noise = F.avg_pool2d(noise, 3, stride=1, padding=1) * 3 * texture
    img = img + noise + 0.3 * texture * torch.randn(
        (n, 3, h, w), generator=g, device=device)
    return torch.clamp(torch.round(img), 0, 255)


def _pad(p: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Edge-replicate the last two axes up to (ph, pw)."""
    h, w = p.shape[-2:]
    if ph > h:
        p = torch.cat([p, p[..., -1:, :].expand(*p.shape[:-2], ph - h, w)],
                      -2)
    if pw > w:
        p = torch.cat([p, p[..., -1:].expand(*p.shape[:-1], pw - w)], -1)
    return p


def _quantize(planes: torch.Tensor, table: np.ndarray) -> torch.Tensor:
    """(n, H, W) planes (H, W multiples of 8) -> (n, H/8, W/8, 64) int16
    quantized DCT coefficients, natural order."""
    n, h, w = planes.shape
    a = dct_matrix(torch.float32, planes.device)
    b = (planes - 128).reshape(n, h // 8, 8, w // 8, 8).permute(0, 1, 3, 2, 4)
    k = torch.matmul(torch.matmul(a, b), a.T).reshape(n, h // 8, w // 8, 64)
    q = torch.from_numpy(table.astype(np.float32)).to(planes.device)
    return torch.clamp(torch.round(k / q), -1023, 1023).to(torch.int16)


def make(params: Dict, seed: int, device) -> Dict:
    """{"bufs": the JPEGs, "sources": per source {width, height,
    orientation, quality, coefs (y, cb, cr), qtables (luma, chroma)},
    "bits_per_pixel": the mean compressed size}."""
    w, h = params["width"], params["height"]
    n = params["sources"]
    orientation = params.get("orientation", 1)
    rng = np.random.default_rng(seed)
    qualities = list(params["qualities"])
    qualities = [qualities[i] for i in rng.permutation(
        np.arange(n) % len(qualities))]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    ph, pw = -(-h // 16) * 16, -(-w // 16) * 16
    sources: List[Dict] = []
    chunk = max(1, min(n, (1 << 26) // (h * w)))
    for s in range(0, n, chunk):
        m = min(chunk, n - s)
        rgb = _pad(photo_rgb(g, m, h, w, params["texture"], params["rects"],
                             device), ph, pw)
        r, gg, b = rgb[:, 0], rgb[:, 1], rgb[:, 2]
        y = 0.299 * r + 0.587 * gg + 0.114 * b
        cb = -0.168735892 * r - 0.331264108 * gg + 0.5 * b + 128
        cr = 0.5 * r - 0.418687589 * gg - 0.081312411 * b + 128
        cb, cr = (p.reshape(m, ph // 2, 2, pw // 2, 2).mean(dim=(2, 4))
                  for p in (cb, cr))
        for j in range(m):
            q = qualities[s + j]
            ql, qc = ijg_tables(q)
            coefs = tuple(
                _quantize(p[j:j + 1], t)[0].cpu().numpy()
                for p, t in ((y, ql), (cb, qc), (cr, qc)))
            yb, cbb = (-(-h // 8), -(-w // 8)), (-(-h // 16), -(-w // 16))
            coefs = (np.ascontiguousarray(coefs[0][:yb[0], :yb[1]]),
                     np.ascontiguousarray(coefs[1][:cbb[0], :cbb[1]]),
                     np.ascontiguousarray(coefs[2][:cbb[0], :cbb[1]]))
            sources.append({"width": w, "height": h,
                            "orientation": orientation, "quality": q,
                            "coefs": coefs, "qtables": (ql, qc)})

    def encode(src):
        buf = native.jpeg_encode(w, h, src["coefs"], [2, 1, 1], [2, 1, 1],
                                 *src["qtables"])
        if orientation != 1:
            buf = buf[:2] + exif_app1(orientation) + buf[2:]
        return buf
    with ThreadPoolExecutor(8) as ex:
        bufs = list(ex.map(encode, sources))
    return {"bufs": bufs, "sources": sources,
            "bits_per_pixel": 8 * float(np.mean([len(b) for b in bufs]))
            / (w * h)}
