"""Plain reference of the JPEG Fit transcode (thumb256_jpeg).

From a source's quantized coefficients and tables, as the input maker
wrote them into the JPEG the program reads, it works out the quantized
coefficients the transcode has to produce, with lilliput's semantics:

* decode: dequantize, the orthonormal 8x8 IDCT, + 128, libjpeg's "fancy"
  triangle upsampling of 4:2:0 chroma (3/4 and 1/4 taps, the block-padded
  plane's edges replicated), BT.601 full-range YCbCr -> RGB, rounded half
  to even and clipped to u8;
* EXIF orientation (1, or 6: a quarter turn clockwise);
* Fit: the centre crop of lilliput's opencv.go (``fit_rect``), then
  cv::resize INTER_AREA to the destination (separable area weights),
  rounded half to even and clipped to u8;
* encode: RGB -> YCbCr, edge-replicated padding to whole MCUs, 2x2 box
  means of the chroma, the forward DCT of (plane - 128), divided by the
  IJG tables of the destination quality, rounded half to even, clipped to
  +-2047.

Every step is a torch op in ``dtype`` on ``device``: float64 for the
reference, a lower precision for the control. Nothing here imports the
program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

#: ITU T.81 Annex K tables, natural order
STD_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
STD_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32)

#: zigzag position -> natural index
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])


def ijg_tables(quality: int) -> Tuple[np.ndarray, np.ndarray]:
    """libjpeg's jpeg_set_quality tables (force_baseline), natural order,
    u16: (luma, chroma)."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q

    def one(base):
        return np.clip((base * scale + 50) // 100, 1, 255).astype(np.uint16)
    return one(STD_LUMA), one(STD_CHROMA)


def dct_matrix(dtype=torch.float64, device="cpu") -> torch.Tensor:
    """Orthonormal DCT-II matrix A (forward: A @ P @ A.T)."""
    a = np.zeros((8, 8))
    for k in range(8):
        c = math.sqrt((1 if k == 0 else 2) / 8)
        for n in range(8):
            a[k, n] = c * math.cos((2 * n + 1) * k * math.pi / 16)
    return torch.tensor(a, dtype=dtype, device=device)


def fit_rect(src_w: int, src_h: int, dst_w: int, dst_h: int):
    """(left, top, w, h) of lilliput's Fit centre crop (opencv.go)."""
    if src_w / src_h > dst_w / dst_h:
        w, h = int(dst_w / dst_h * src_h + 0.5), src_h
    else:
        w, h = src_w, int(src_w / (dst_w / dst_h) + 0.5)
    w, h = max(w, 1), max(h, 1)
    return (max(int((src_w - w) * 0.5), 0), max(int((src_h - h) * 0.5), 0),
            w, h)


def area_matrix(src: int, dst: int, dtype=torch.float64,
                device="cpu") -> torch.Tensor:
    """(dst, src) weights of cv::resize INTER_AREA for a downscale along
    one axis: each output cell [o*s, (o+1)*s), s = src / dst, averages the
    source pixels it covers, each weighted by the length it covers."""
    if dst > src:
        raise ValueError("the reference's AREA covers downscales only")
    s = src / dst
    m = np.zeros((dst, src))
    for o in range(dst):
        f1 = o * s
        f2 = f1 + s
        cell = min(s, src - f1)
        s1, s2 = math.ceil(f1), math.floor(f2)
        s2 = min(s2, src - 1)
        s1 = min(s1, s2)
        if s1 - f1 > 1e-3:
            m[o, s1 - 1] = (s1 - f1) / cell
        m[o, s1:s2] = 1.0 / cell
        if f2 - s2 > 1e-3:
            m[o, s2] = min(min(f2 - s2, 1.0), cell) / cell
    return torch.tensor(m, dtype=dtype, device=device)


def _round_u8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x), 0, 255)


def _blocks_to_plane(p: torch.Tensor) -> torch.Tensor:
    bh, bw = p.shape[0], p.shape[1]
    return p.reshape(bh, bw, 8, 8).permute(0, 2, 1, 3).reshape(bh * 8, bw * 8)


def _plane_to_blocks(p: torch.Tensor) -> torch.Tensor:
    h, w = p.shape
    return p.reshape(h // 8, 8, w // 8, 8).permute(0, 2, 1, 3).reshape(
        h // 8, w // 8, 8, 8)


def idct_plane(coefs: np.ndarray, qtable: np.ndarray, dtype,
               device) -> torch.Tensor:
    """(bh, bw, 64) quantized coefficients (natural order) -> the plane of
    their level-shifted IDCT, (bh*8, bw*8)."""
    a = dct_matrix(dtype, device)
    k = torch.from_numpy(np.asarray(coefs, np.float32)).to(device, dtype)
    q = torch.from_numpy(np.asarray(qtable, np.float32)).to(device, dtype)
    k = (k * q).reshape(coefs.shape[0], coefs.shape[1], 8, 8)
    p = torch.matmul(torch.matmul(a.T, k), a) + 128
    return _blocks_to_plane(p.reshape(coefs.shape[0], coefs.shape[1], 64))


def _fancy2x(x: torch.Tensor, axis: int) -> torch.Tensor:
    x = x.movedim(axis, -1)
    left = torch.cat([x[..., :1], x[..., :-1]], dim=-1)
    right = torch.cat([x[..., 1:], x[..., -1:]], dim=-1)
    out = torch.stack([(3 * x + left) / 4, (3 * x + right) / 4], dim=-1)
    return out.reshape(x.shape[:-1] + (2 * x.shape[-1],)).movedim(-1, axis)


def decode_rgb(src: Dict, dtype, device) -> torch.Tensor:
    """(3, H, W) RGB u8 values (in `dtype`) of a 4:2:0 source: src has
    width, height, coefs (y, cb, cr) and qtables (luma, chroma)."""
    w, h = src["width"], src["height"]
    (yc, cbc, crc), (ql, qc) = src["coefs"], src["qtables"]
    y = idct_plane(yc, ql, dtype, device)[:h, :w]
    cb, cr = (_fancy2x(_fancy2x(idct_plane(c, qc, dtype, device), 0),
                       1)[:h, :w] for c in (cbc, crc))
    cb, cr = cb - 128, cr - 128
    r = y + 1.402 * cr
    g = y - 0.344136286 * cb - 0.714136286 * cr
    b = y + 1.772 * cb
    return _round_u8(torch.stack([r, g, b]))


def orient(img: torch.Tensor, orientation: int) -> torch.Tensor:
    """(C, H, W) shown upright: EXIF orientation 1 or 6 (the stored image
    turned a quarter clockwise)."""
    if orientation == 1:
        return img
    if orientation == 6:
        return torch.rot90(img, k=-1, dims=(1, 2))
    raise ValueError(f"orientation {orientation} is not in the reference")


def fit_area(img: torch.Tensor, dst_w: int, dst_h: int) -> torch.Tensor:
    """(C, H, W) -> (C, dst_h, dst_w): Fit crop, then INTER_AREA, u8."""
    _, h, w = img.shape
    left, top, cw, ch = fit_rect(w, h, dst_w, dst_h)
    crop = img[:, top:top + ch, left:left + cw]
    my = area_matrix(ch, dst_h, img.dtype, img.device)
    mx = area_matrix(cw, dst_w, img.dtype, img.device)
    return _round_u8(torch.matmul(torch.matmul(my, crop), mx.T))


def encode_coefs(rgb: torch.Tensor, quality: int):
    """(3, H, W) RGB u8 values -> quantized 4:2:0 coefficients, each
    (bh, bw, 64) int64 in natural order: (y, cb, cr)."""
    r, g, b = rgb
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128
    cr = 0.5 * r - 0.418687589 * g - 0.081312411 * b + 128
    h, w = y.shape
    ph, pw = -(-h // 16) * 16, -(-w // 16) * 16

    def pad(p):
        p = torch.cat([p, p[-1:].expand(ph - h, w)], 0) if ph > h else p
        return torch.cat([p, p[:, -1:].expand(ph, pw - w)], 1) if pw > w \
            else p
    y, cb, cr = pad(y), pad(cb), pad(cr)
    cb, cr = (p.reshape(ph // 2, 2, pw // 2, 2).mean(dim=(1, 3))
              for p in (cb, cr))
    a = dct_matrix(rgb.dtype, rgb.device)
    tl, tc = ijg_tables(quality)
    out = []
    for p, t in ((y, tl), (cb, tc), (cr, tc)):
        blocks = _plane_to_blocks(p - 128)
        k = torch.matmul(torch.matmul(a, blocks), a.T).reshape(
            blocks.shape[0], blocks.shape[1], 64)
        q = torch.from_numpy(t.astype(np.float32)).to(rgb.device, rgb.dtype)
        out.append(torch.clamp(torch.round(k / q), -2047, 2047).to(
            torch.int64))
    return tuple(out)


def transcode_coefs(src: Dict, dst_w: int, dst_h: int, quality: int,
                    dtype=torch.float64, device="cpu"):
    """The quantized output coefficients (y, cb, cr), as numpy int64, that
    the Fit transcode of `src` has to produce."""
    img = fit_area(orient(decode_rgb(src, dtype, device),
                          src.get("orientation", 1)), dst_w, dst_h)
    return tuple(c.cpu().numpy() for c in encode_coefs(img, quality))


def emit(src: Dict, params: Dict, dtype, device) -> bytes:
    """The reference put in the program's place: the output JPEG of `src`
    computed in `dtype` and Huffman-coded by the frozen encoder."""
    from portbench import native
    coefs = transcode_coefs(src, params["dst_w"], params["dst_h"],
                            params["quality"], dtype, device)
    return native.jpeg_encode(params["dst_w"], params["dst_h"],
                              [c.astype(np.int16) for c in coefs],
                              [2, 1, 1], [2, 1, 1],
                              *ijg_tables(params["quality"]))


def coef_share(got: Sequence[np.ndarray], want: Sequence[np.ndarray]) -> float:
    """Share of the coefficients of `got` that differ from `want` (1.0
    where a component's block grid differs)."""
    total = differ = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            return 1.0
        total += g.size
        differ += int(np.count_nonzero(g.astype(np.int64) != w))
    return differ / max(total, 1)


def check(sources: List[Dict], outputs: Dict[int, bytes], params: Dict,
          device) -> Dict[str, float]:
    """The compared numbers of a JPEG Fit cell. outputs maps a sampled
    source's index to one output the program gave for it. coef_share:
    the largest share, over those outputs, of output coefficients unlike
    the reference's (1.0 for an output that does not parse or has
    another geometry, quality or layout)."""
    from .jpeg_decode import decode_baseline
    dst_w, dst_h, quality = params["dst_w"], params["dst_h"], \
        params["quality"]
    want_tables = ijg_tables(quality)
    worst = 0.0
    for i, buf in outputs.items():
        try:
            got = decode_baseline(buf)
        except ValueError:
            worst = 1.0
            continue
        ok = (got["width"] == dst_w and got["height"] == dst_h
              and got["sampling"] == [(2, 2), (1, 1), (1, 1)]
              and np.array_equal(got["qtables"][0], want_tables[0])
              and np.array_equal(got["qtables"][1], want_tables[1]))
        if not ok:
            worst = 1.0
            continue
        want = transcode_coefs(sources[i], dst_w, dst_h, quality,
                               device=device)
        worst = max(worst, coef_share(got["coefs"], want))
    return {"coef_share": worst}
