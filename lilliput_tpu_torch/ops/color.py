"""Colour conversions on the device: the WebP part of
``lilliput_tpu/ops/color.py`` (``_webp_gamma_tables`` and
``webp_yuv420_from_packed``, :257-343), libwebp's exact YUV420 import.

The rest of the JAX module (the AVIF/YUV conversions and the HDR tone map)
belongs to AVIF and is not in the port yet. The gamma lookups are plain
int32 tables indexed by gathers, where the JAX package selects u8 columns
by one-hot dots (TPU gathers are slow); the arithmetic is the same int32
throughout (``>>`` of a negative int32 is arithmetic in both).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _webp_gamma_tables():
    """libwebp 1.2.x picture_csp_enc.c gamma tables (InitGammaTables):
    chroma downsampling is gamma-corrected, u8 -> 12-bit linear through a
    256-entry pow(0.80) table, a 2x2 sum, then back through a 33-entry
    inverse table with 9-bit linear interpolation. Returns (g2l, l2g),
    int32 numpy tables of 256 and 33 entries."""
    gamma_fix, gamma_tab_fix = 12, 7
    scale_max = (1 << gamma_fix) - 1                      # 4095
    g2l = np.array([int((v / 255.0) ** 0.80 * scale_max + 0.5)
                    for v in range(256)], np.int32)
    scale = (1 << gamma_tab_fix) / scale_max
    # 1 << (GAMMA_FIX - GAMMA_TAB_FIX) + 1 = 33 entries: the interpolation
    # reads rows t and t + 1 for t = s >> 9 <= 31 (s <= 4 * 4095)
    tab_size = 1 << (gamma_fix - gamma_tab_fix)           # 32
    l2g = np.array([int(255.0 * (scale * v) ** (1.0 / 0.80) + 0.5)
                    for v in range(tab_size + 1)], np.int32)
    return g2l, l2g


_WEBP_G2L, _WEBP_L2G = _webp_gamma_tables()
_tables: Dict[torch.device, tuple] = {}


def _device_tables(device: torch.device):
    t = _tables.get(device)
    if t is None:
        t = _tables[device] = (torch.from_numpy(_WEBP_G2L).to(device),
                               torch.from_numpy(_WEBP_L2G).to(device))
    return t


def _edge_pad(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., H + H%2, W + W%2), the last row and column
    repeated (jnp.pad mode="edge"; F.pad "replicate" has no integer CPU
    form)."""
    if x.shape[-2] & 1:
        x = torch.cat([x, x[..., -1:, :]], dim=-2)
    if x.shape[-1] & 1:
        x = torch.cat([x, x[..., :, -1:]], dim=-1)
    return x


def webp_yuv420_from_packed(packed: torch.Tensor):
    """Packed BGRA int32 (..., H, W) -> libwebp-import-identical YUV420.

    Returns (y (..., H, W) u8, u, v (..., ceil(H/2), ceil(W/2)) u8) with
    exactly the values libwebp's lossy import (ImportYUVAFromRGBA) makes
    of the same pixels: per-pixel fixed-point RGBToY, gamma-corrected 2x2
    chroma sums (SUM4/SUM2's edge duplication is a plain 2x2 sum over an
    edge-replicated pad), VP8ClipUV. That identity lets the serving path
    ship 1.5 B/px of planes to the host instead of 4 B/px of BGRA, with
    the same .webp bytes. Any leading batch dimensions."""
    packed = packed.to(torch.int32)
    g2l, l2g = _device_tables(packed.device)
    b = packed & 0xFF
    g = (packed >> 8) & 0xFF
    r = (packed >> 16) & 0xFF
    yv = (16839 * r + 33059 * g + 6420 * b
          + ((16 << 16) + (1 << 15))) >> 16
    y_out = yv.to(torch.uint8)

    def mapped_sum(chan):
        # u8 -> 12-bit linear, 2x2 block sum
        lin = _edge_pad(g2l[chan.long()])
        s = (lin[..., 0::2, 0::2] + lin[..., 0::2, 1::2]
             + lin[..., 1::2, 0::2] + lin[..., 1::2, 1::2])
        # LinearToGamma(s, 0): 9-bit interpolation between rows t, t + 1
        tab_pos = (s >> 9).long()
        x = s & 511
        v0, v1 = l2g[tab_pos], l2g[tab_pos + 1]
        return (v1 * x + v0 * (512 - x) + 64) >> 7

    ru, gu, bu = mapped_sum(r), mapped_sum(g), mapped_sum(b)

    def clip_uv(uv):
        # non-negative before the shift for all u8 inputs (see VP8ClipUV)
        return torch.clamp((uv + ((1 << 17) + (128 << 18))) >> 18,
                           0, 255).to(torch.uint8)

    u_out = clip_uv(-9719 * ru - 19081 * gu + 28800 * bu)
    v_out = clip_uv(28800 * ru - 24116 * gu - 4684 * bu)
    return y_out, u_out, v_out
