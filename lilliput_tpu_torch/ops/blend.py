"""Frame compositing primitives on the pixels' device (torch).

The counterpart of ``lilliput_tpu/ops/blend.py``, which replaces the
reference's region copy / alpha-blend / clear shims (opencv.cpp:384-628),
used by ``ImageOps`` animated compositing (ops.go:431-461). Same semantics:

* alpha blend is straight (non-premultiplied) source-over in float32:
  ``out_a = sa + da*(1-sa)``, ``out_rgb = (src*sa + dst*da*(1-sa)) / out_a``
  with 0/0 -> 0, then saturate back to u8 with round-half-even;
* plain copy overwrites the destination rect (with channel conversion and an
  INTER_LINEAR resize when the source does not match the rect size);
* clear_to_transparent zeroes the rect (all channels, including alpha).

The JAX package calls these eagerly, one XLA op at a time, so each
elementwise step rounds on its own; the torch ops here run the same steps
in the same order. Functions that write a rect return a new tensor.
"""

from __future__ import annotations

import torch

from .resize import LINEAR, resize


def _round_u8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x), 0.0, 255.0).to(torch.uint8)


def _alpha(img: torch.Tensor) -> torch.Tensor:
    return torch.full(img.shape[:-1] + (1,), 255, dtype=img.dtype,
                      device=img.device)


def to_bgra(img: torch.Tensor) -> torch.Tensor:
    """Convert 1/3/4-channel u8 image to 4-channel (alpha=255)."""
    c = img.shape[-1]
    if c == 4:
        return img
    if c == 3:
        return torch.cat([img, _alpha(img)], dim=-1)
    if c == 1:
        return torch.cat([img, img, img, _alpha(img)], dim=-1)
    raise ValueError(f"unsupported channel count {c}")


def to_channels(img: torch.Tensor, channels: int) -> torch.Tensor:
    """Convert between 1/3/4 channel counts (BGRA drop/add alpha, gray expand)."""
    c = img.shape[-1]
    if c == channels:
        return img
    if channels == 4:
        return to_bgra(img)
    if channels == 3:
        if c == 4:
            return img[..., :3]
        if c == 1:
            return torch.cat([img, img, img], dim=-1)
    raise ValueError(f"cannot convert {c} -> {channels} channels")


def alpha_blend_full(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Source-over blend of equal-shaped 4-channel u8 images (float math)."""
    inv255 = 1.0 / 255.0
    sa = src[..., 3:4].to(torch.float32) * inv255
    da = dst[..., 3:4].to(torch.float32) * inv255
    sc = src[..., :3].to(torch.float32) * inv255
    dc = dst[..., :3].to(torch.float32) * inv255
    one_minus_sa = 1.0 - sa
    out_a = sa + da * one_minus_sa
    num = sc * sa + dc * da * one_minus_sa
    pos = out_a > 0.0
    rgb = torch.where(pos, num / torch.where(pos, out_a,
                                             torch.ones_like(out_a)), 0.0)
    out = torch.cat([rgb, out_a], dim=-1)
    return _round_u8(out * 255.0)


def _set_rect(dst: torch.Tensor, x: int, y: int, w: int, h: int,
              value) -> torch.Tensor:
    out = dst.clone()
    out[..., y:y + h, x:x + w, :] = value
    return out


def copy_to_region_with_alpha(dst: torch.Tensor, src: torch.Tensor,
                              x: int, y: int, w: int, h: int) -> torch.Tensor:
    """Alpha-blend src into dst[y:y+h, x:x+w]; returns the new dst."""
    if src.shape[-3] != h or src.shape[-2] != w:
        src = resize(src, w, h, LINEAR)
    src4 = to_bgra(src)
    dst4 = to_bgra(dst)
    region = dst4[..., y:y + h, x:x + w, :]
    blended = alpha_blend_full(region, src4)
    return to_channels(_set_rect(dst4, x, y, w, h, blended), dst.shape[-1])


def copy_to_region(dst: torch.Tensor, src: torch.Tensor,
                   x: int, y: int, w: int, h: int) -> torch.Tensor:
    """Overwrite dst[y:y+h, x:x+w] with src (resize/convert as needed)."""
    if src.shape[-3] != h or src.shape[-2] != w:
        src = resize(src, w, h, LINEAR)
    return _set_rect(dst, x, y, w, h, to_channels(src, dst.shape[-1]))


def clear_to_transparent(img: torch.Tensor, x: int, y: int, w: int,
                         h: int) -> torch.Tensor:
    """Zero out the rect (transparent black)."""
    return _set_rect(img, x, y, w, h, 0)


def crop(img: torch.Tensor, x: int, y: int, w: int, h: int) -> torch.Tensor:
    """Static crop (cv::Mat ROI equivalent, opencv.cpp:204-209)."""
    return img[..., y:y + h, x:x + w, :]


def set_color(img: torch.Tensor, bgra) -> torch.Tensor:
    """Fill the whole image with a color (opencv_mat_set_color)."""
    c = img.shape[-1]
    col = torch.tensor(list(bgra[:c]), dtype=img.dtype, device=img.device)
    return col.expand(img.shape)
