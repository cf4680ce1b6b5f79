"""Thumbhash encoder: the pixel stage on the frame's device, the packing
on the host.

The counterpart of ``lilliput_tpu/codecs/thumbhash.py`` (the reference's
thumbhash.cpp:29-277, a port of evanw/thumbhash): nearest-neighbour
downsample to <= 100 px, the alpha-weighted average colour, the L/P/Q/A
planes and each plane's cosine transform (two matmuls) run on the device
of the frame; the triangular coefficient selection, the 4-bit AC
quantization and the 5-6 byte header run on the host in np.float32
arithmetic, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..errors import DecodingFailedError
from ..framebuffer import Framebuffer
from ..interfaces import Decoder, Encoder
from ..ops.jpeg_kernels import _fma
from ..utils import resolve_device
from ._raster import to_device

MAX_DIMENSION = 100
_PI = np.float32(3.14159265)
_INV255 = float(np.float32(1.0 / 255.0))
# XLA compiles x / 3.0 as x * f32(1/3), as every division by a constant
_THIRD = float(np.float32(1.0 / 3.0))


def _cos_matrix(n_coeff: int, size: int) -> np.ndarray:
    """(n_coeff, size) float32: cos(PI/size * c * (x + 0.5))."""
    c = np.arange(n_coeff, dtype=np.float32)[:, None]
    x = np.arange(size, dtype=np.float32)[None, :] + np.float32(0.5)
    return np.cos(_PI / np.float32(size) * c * x).astype(np.float32)


def _dct_grid(channels: torch.Tensor, nx: int, ny: int) -> torch.Tensor:
    """(..., h, w) planes -> (..., ny, nx) cosine-coefficient grids,
    mean-normalized: cos_y . plane . cos_x^T / (w*h)."""
    h, w = channels.shape[-2], channels.shape[-1]
    cosx = to_device(_cos_matrix(nx, w), channels.device)
    cosy = to_device(_cos_matrix(ny, h), channels.device)
    f = torch.matmul(torch.matmul(cosy, channels), cosx.transpose(0, 1))
    return f * float(np.float32(1.0) / np.float32(w * h))


def _encode_channel(grid: np.ndarray, nx: int, ny: int):
    """Triangular selection + AC normalization (thumbhash.cpp:41-73)."""
    dc = float(grid[0, 0])
    ac = []
    for cy in range(ny):
        cx = 1 if cy == 0 else 0
        while cx * ny < nx * (ny - cy):
            ac.append(float(grid[cy, cx]))
            cx += 1
    scale = max((abs(v) for v in ac), default=0.0)
    if scale > 0:
        ac = [float(np.float32(0.5) + np.float32(0.5) / np.float32(scale)
                    * np.float32(v)) for v in ac]
    return dc, ac, scale


def _lpqa_from_bgra(img: torch.Tensor):
    """(..., h, w, 4) u8 BGRA -> the L, P, Q, A planes and the alpha sum
    per image: colours composited over the alpha-weighted average colour
    (its a*x + c written as one fused multiply-add, as XLA compiles it)."""
    f = img.to(torch.float32)
    alpha = f[..., 3] * _INV255
    ab, ag, ar = (alpha * f[..., i] * _INV255 for i in range(3))
    suma = alpha.sum(dim=(-2, -1))
    den = torch.clamp(suma, min=1e-12)

    def over(a_c):
        avg = torch.where(suma > 0, a_c.sum(dim=(-2, -1)) / den, 0.0)
        return _fma(avg[..., None, None], 1.0 - alpha, a_c)
    r, g, b = over(ar), over(ag), over(ab)
    return (r + g + b) * _THIRD, (r + g) * 0.5 - b, r - g, alpha, suma


def _lpqa_from_bgr(img: torch.Tensor):
    """(..., h, w, 3) u8 BGR -> the L, P, Q planes. XLA fuses the 1/255
    scaling of r (and of b in L) into the sums that take it."""
    f = img.to(torch.float32)
    b0, r0 = f[..., 0], f[..., 2]
    g, b = f[..., 1] * _INV255, b0 * _INV255
    rg = _fma(_INV255, r0, g)
    return (_fma(_INV255, b0, rg) * _THIRD, rg * 0.5 - b,
            _fma(_INV255, r0, -g))


def _round_u(x: float) -> int:
    return int(np.round(np.float32(x)))


def _l_counts(has_alpha: bool, w: int, h: int):
    """(lx, ly): the luma coefficient counts along x and y."""
    l_limit = 5 if has_alpha else 7
    m = max(w, h)
    lx = max(int(np.round(np.float32(l_limit * w) / np.float32(m))), 1)
    ly = max(int(np.round(np.float32(l_limit * h) / np.float32(m))), 1)
    return lx, ly


def batch_grids(frames, device="cuda"):
    """The coefficient grids of a batch of same-shaped (B, H, W, 4) u8
    BGRA images (numpy or a tensor) on `device` ("cuda" unless the caller
    asks for "cpu"; a CUDA device without a card raises), at the largest
    coefficient counts: ([L (B, 7, 7), P and Q (B, 3, 3), A (B, 5, 5)]
    as host arrays, the alpha sum of each image)."""
    dev = resolve_device(device)
    frames = (to_device(frames, dev) if isinstance(frames, np.ndarray)
              else frames.to(dev))
    l, p, q, a, suma = _lpqa_from_bgra(frames)
    return ([_dct_grid(x, n, n).cpu().numpy()
             for x, n in ((l, 7), (p, 3), (q, 3), (a, 5))],
            suma.cpu().numpy())


def hash_fields(grids, sums, i: int, w: int, h: int) -> tuple:
    """Image i's arguments of _pack_hash from batch_grids' output: each
    image's coefficient selection and AC normalization, on the host."""
    gl, gp, gq, ga = (g[i] for g in grids)
    has_alpha = float(sums[i]) < float(w * h)
    lx, ly = _l_counts(has_alpha, w, h)
    return (has_alpha, w > h, lx, ly,
            *_encode_channel(gl, max(lx, 3), max(ly, 3)),
            *_encode_channel(gp, 3, 3), *_encode_channel(gq, 3, 3),
            *(_encode_channel(ga, 5, 5) if has_alpha else (1.0, [], 1.0)))


def order_dependent(fields, grid_atol: float) -> bool:
    """Whether a 4-bit AC of these hash fields lies so near a rounding tie
    (15 * f = k + 0.5) that a grid error of grid_atol can move it across:
    a coefficient that is zero in exact arithmetic (a plane constant along
    one axis) normalizes to 0.5 exactly but for its f32 residue, whose
    sign is the summation order's (ROADMAP queue 3 entry 12)."""
    for ac, scale in zip(fields[5::3], fields[6::3]):
        for f in ac:
            d = abs(15.0 * f - np.floor(15.0 * f) - 0.5)
            if d <= 15.0 * grid_atol / max(scale, 1e-30):
                return True
    return False


def thumbhash_batch(frames, device="cuda") -> list:
    """Thumbhashes of a batch of same-shaped (B, H, W, 4) u8 BGRA images
    (numpy or a tensor; each side <= 100 px, e.g. spritesheet tiles) in a
    few passes on `device` ("cuda" unless the caller asks for "cpu"): the
    grids at the largest coefficient counts for the whole batch, each
    image's selection on the host."""
    grids, sums = batch_grids(frames, device)
    h, w = frames.shape[1], frames.shape[2]
    return [_pack_hash(*hash_fields(grids, sums, i, w, h))
            for i in range(len(sums))]


def _pack_hash(has_alpha, is_landscape, lx, ly, l_dc, l_ac, l_scale,
               p_dc, p_ac, p_scale, q_dc, q_ac, q_scale,
               a_dc, a_ac, a_scale) -> bytes:
    """Header + 4-bit AC packing (thumbhash.cpp:222-268)."""
    header24 = (_round_u(63.0 * l_dc)
                | (_round_u(31.5 + 31.5 * p_dc) << 6)
                | (_round_u(31.5 + 31.5 * q_dc) << 12)
                | (_round_u(31.0 * l_scale) << 18)
                | ((1 << 23) if has_alpha else 0))
    header16 = ((ly if is_landscape else lx)
                | (_round_u(63.0 * p_scale) << 3)
                | (_round_u(63.0 * q_scale) << 9)
                | ((1 << 15) if is_landscape else 0))
    out = bytearray([header24 & 255, (header24 >> 8) & 255, header24 >> 16,
                     header16 & 255, header16 >> 8])
    if has_alpha:
        out.append(_round_u(15.0 * a_dc) | (_round_u(15.0 * a_scale) << 4))
    is_odd = False
    acs = [l_ac, p_ac, q_ac] + ([a_ac] if has_alpha else [])
    for ac in acs:
        for f in ac:
            u = _round_u(15.0 * f)
            if is_odd:
                out[-1] |= u << 4
            else:
                out.append(u)
            is_odd = not is_odd
    return bytes(out)


class ThumbhashEncoder(Encoder):
    """Single-frame encoder producing the <= 25-byte thumbhash."""

    def __init__(self, decoded_by: Optional[Decoder] = None):
        del decoded_by  # palette-free; kept for constructor parity

    def encode(self, fb: Optional[Framebuffer],
               opts: Dict[int, int]) -> Optional[bytes]:
        if fb is None:
            raise DecodingFailedError("thumbhash encoder needs a frame")
        arr = fb.array
        orig_h, orig_w = fb.height, fb.width
        w, h = orig_w, orig_h
        if orig_w > MAX_DIMENSION or orig_h > MAX_DIMENSION:
            aspect = np.float32(orig_w) / np.float32(orig_h)
            if orig_w > orig_h:
                w = MAX_DIMENSION
                h = int(np.float32(w) / aspect)
            else:
                h = MAX_DIMENSION
                w = int(np.float32(h) * aspect)
        # nearest-neighbour gather: orig_i = floor(i * ratio)
        # (thumbhash.cpp:110-130)
        rows = (np.arange(h, dtype=np.float32)
                * (np.float32(orig_h) / np.float32(h))).astype(np.int64)
        cols = (np.arange(w, dtype=np.float32)
                * (np.float32(orig_w) / np.float32(w))).astype(np.int64)
        small = arr.index_select(0, to_device(rows, arr.device)).index_select(
            1, to_device(cols, arr.device))

        channels = fb.channels
        ones = torch.ones((h, w), dtype=torch.float32, device=arr.device)
        if channels == 4:
            l, p, q, a, suma = _lpqa_from_bgra(small)
            has_alpha = float(suma) < float(w * h)
        elif channels == 3:
            (l, p, q), a, has_alpha = _lpqa_from_bgr(small), ones, False
        elif channels == 1:
            l = small[..., 0].to(torch.float32) * _INV255
            p = q = torch.zeros_like(ones)
            a, has_alpha = ones, False
        else:
            raise DecodingFailedError(
                "unsupported channel count for thumbhash")

        lx, ly = _l_counts(has_alpha, w, h)
        nlx, nly = max(lx, 3), max(ly, 3)
        l_dc, l_ac, l_scale = _encode_channel(
            _dct_grid(l, nlx, nly).cpu().numpy(), nlx, nly)
        p_dc, p_ac, p_scale = _encode_channel(
            _dct_grid(p, 3, 3).cpu().numpy(), 3, 3)
        q_dc, q_ac, q_scale = _encode_channel(
            _dct_grid(q, 3, 3).cpu().numpy(), 3, 3)
        if has_alpha:
            a_dc, a_ac, a_scale = _encode_channel(
                _dct_grid(a, 5, 5).cpu().numpy(), 5, 5)
        else:
            a_dc, a_ac, a_scale = 1.0, [], 1.0
        return _pack_hash(has_alpha, w > h, lx, ly,
                          l_dc, l_ac, l_scale, p_dc, p_ac, p_scale,
                          q_dc, q_ac, q_scale, a_dc, a_ac, a_scale)
