"""EXIF orientation normalization (torch).

The counterpart of ``lilliput_tpu/ops/orient.py``: the 8 EXIF orientations
as flips and transposes. ``orient`` takes the JAX function's interleaved
(..., H, W, C) form; ``orient_planes`` takes (..., H, W) planes, the form
the port's decode kernels write, so the colour path stays on planes.
"""

from __future__ import annotations

import torch

# EXIF orientation codes (matching the reference's ImageOrientation enum).
ORIENTATION_TOP_LEFT = 1      # identity
ORIENTATION_TOP_RIGHT = 2     # mirror horizontal
ORIENTATION_BOTTOM_RIGHT = 3  # rotate 180
ORIENTATION_BOTTOM_LEFT = 4   # mirror vertical
ORIENTATION_LEFT_TOP = 5      # mirror horizontal + rotate 270 CW (transpose)
ORIENTATION_RIGHT_TOP = 6     # rotate 90 CW
ORIENTATION_RIGHT_BOTTOM = 7  # mirror horizontal + rotate 90 CW (anti-transpose)
ORIENTATION_LEFT_BOTTOM = 8   # rotate 270 CW


def swaps_dimensions(orientation: int) -> bool:
    """True when the transform swaps width and height (orientations 5-8)."""
    return orientation >= ORIENTATION_LEFT_TOP


def _orient(x: torch.Tensor, orientation: int, h: int, w: int) -> torch.Tensor:
    """The transform of `orientation` with the image rows on axis h and the
    columns on axis w; codes outside 2..8 leave x as it is."""
    o = int(orientation)
    if o <= ORIENTATION_TOP_LEFT or o > ORIENTATION_LEFT_BOTTOM:
        return x
    if o >= ORIENTATION_LEFT_TOP:
        x = x.transpose(h, w)
    flips = {ORIENTATION_TOP_RIGHT: (w,), ORIENTATION_BOTTOM_RIGHT: (h, w),
             ORIENTATION_BOTTOM_LEFT: (h,), ORIENTATION_LEFT_TOP: (),
             ORIENTATION_RIGHT_TOP: (w,), ORIENTATION_RIGHT_BOTTOM: (h, w),
             ORIENTATION_LEFT_BOTTOM: (h,)}[o]
    return torch.flip(x, flips) if flips else x


def orient(img: torch.Tensor, orientation: int) -> torch.Tensor:
    """Apply the EXIF orientation transform to (..., H, W, C); the output
    is upright (orientation 1)."""
    return _orient(img, orientation, -3, -2)


def orient_planes(plane: torch.Tensor, orientation: int) -> torch.Tensor:
    """orient for (..., H, W) planes: the same transform with the rows on
    axis -2 and the columns on axis -1."""
    return _orient(plane, orientation, -2, -1)
