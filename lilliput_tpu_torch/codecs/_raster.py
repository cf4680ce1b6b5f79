"""Device helpers shared by the still-image decoders.

The JAX package's decoders walk headers, RLE streams and filters on the
host and expand the samples with jnp gathers and shifts. The port does the
same on the decoder's torch device: ``to_device`` ships host samples once,
``unpack_bits`` is ``np.unpackbits(axis=1)`` and ``lut_gather`` is
``jnp.take(lut, idx, axis=0, mode="clip")``. ``StillDecoder`` holds the
Decoder answers the one-frame raster decoders share.
"""

from __future__ import annotations

import numpy as np
import torch

from ..interfaces import Decoder


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on `device` (read-only arrays, such as
    views of the input bytes, are copied on the host first)."""
    return torch.from_numpy(np.require(a, requirements="CW")).to(device)


def unpack_bits(rows: torch.Tensor) -> torch.Tensor:
    """(h, n) u8 -> (h, 8n) u8 bits, most significant bit first."""
    shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=rows.device)
    bits = (rows.to(torch.int32)[..., None] >> shifts) & 1
    return bits.to(torch.uint8).reshape(rows.shape[0], -1)


def lut_gather(lut: np.ndarray, idx: torch.Tensor) -> torch.Tensor:
    """lut[idx] along lut's first axis with indices clamped into range
    (jnp.take's mode="clip"); the result is on idx's device."""
    t = to_device(lut, idx.device)
    flat = idx.reshape(-1).to(torch.int64).clamp(0, t.shape[0] - 1)
    return t.index_select(0, flat).reshape(tuple(idx.shape) + t.shape[1:])


def take_channels(px: torch.Tensor, order) -> torch.Tensor:
    """px's channels (last axis) in `order`, by index_select: advanced
    indexing's CPU kernel took 87 ms for a 2560x1440 RGBA image on one
    core, and longer on torch's intra-op threads while eight decode
    workers ran it at once, where index_select takes 4-8 ms."""
    return px.index_select(-1, torch.tensor(order, device=px.device))


def bgr_from_rgb(px: torch.Tensor) -> torch.Tensor:
    """(..., 3 or 4) RGB(A) -> BGR(A): swap the first and third channels."""
    return take_channels(px, [2, 1, 0] + list(range(3, px.shape[-1])))


class StillDecoder(Decoder):
    """What the one-frame raster decoders (PNM, PAM, Sun Raster, HDR,
    PFM) share: no animation, no ICC, no frame to skip."""

    def icc(self) -> bytes:
        return b""

    def skip_frame(self) -> None:
        raise NotImplementedError

    def is_streamable(self) -> bool:
        return False

    def video_codec(self) -> str:
        return ""

    def audio_codec(self) -> str:
        return ""
