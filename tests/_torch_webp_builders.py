"""WebP inputs for the port's tests, packed in memory: stills through PIL
(libwebp) and animated WebP containers assembled chunk by chunk (RIFF,
VP8X, ICCP, ANIM, ANMF) around lossless frames PIL encodes, so each
frame's offset, duration, blend and dispose are chosen, not left to
libwebp's animation encoder."""

import io
import struct
from typing import NamedTuple, Optional, Sequence

import numpy as np
from PIL import Image


class Frame(NamedTuple):
    px: np.ndarray          # (h, w, 4) RGBA u8
    x: int = 0              # even offsets (the container stores x / 2)
    y: int = 0
    duration_ms: int = 50
    blend: bool = True      # False: the frame replaces its rect
    dispose: bool = False   # True: clear the rect after the frame


def _chunk(kind: bytes, data: bytes) -> bytes:
    pad = b"\x00" if len(data) & 1 else b""
    return kind + struct.pack("<I", len(data)) + data + pad


def _u24(v: int) -> bytes:
    return struct.pack("<I", v)[:3]


def _chunks(riff: bytes):
    """(kind, data) of a RIFF/WEBP file's chunks."""
    pos = 12
    while pos + 8 <= len(riff):
        kind = riff[pos:pos + 4]
        n = struct.unpack("<I", riff[pos + 4:pos + 8])[0]
        yield kind, riff[pos + 8:pos + 8 + n]
        pos += 8 + n + (n & 1)


def still_webp(px: np.ndarray, lossless: bool = True, quality: int = 80,
               icc: Optional[bytes] = None) -> bytes:
    """A still WebP of (h, w, 3|4) RGB(A) pixels through PIL."""
    kw = {"icc_profile": icc} if icc else {}
    bio = io.BytesIO()
    Image.fromarray(px).save(bio, "WEBP", lossless=lossless, quality=quality,
                             exact=True, **kw)
    return bio.getvalue()


def _frame_data(px: np.ndarray) -> bytes:
    """The image chunks (VP8L) of one lossless frame."""
    return b"".join(_chunk(k, d) for k, d in _chunks(still_webp(px))
                    if k in (b"VP8L", b"VP8 ", b"ALPH"))


def anim_webp(width: int, height: int, frames: Sequence[Frame],
              loops: int = 0, bgcolor: int = 0xFFFFFFFF,
              icc: Optional[bytes] = None) -> bytes:
    """An animated WebP of `frames` on a width x height canvas."""
    flags = 0x02 | 0x10 | (0x20 if icc else 0)   # animation, alpha, ICC
    body = _chunk(b"VP8X", bytes([flags, 0, 0, 0]) + _u24(width - 1)
                  + _u24(height - 1))
    if icc:
        body += _chunk(b"ICCP", icc)
    body += _chunk(b"ANIM", struct.pack("<IH", bgcolor, loops))
    for f in frames:
        h, w = f.px.shape[:2]
        assert f.x % 2 == 0 and f.y % 2 == 0
        hdr = (_u24(f.x // 2) + _u24(f.y // 2) + _u24(w - 1) + _u24(h - 1)
               + _u24(f.duration_ms)
               + bytes([(0 if f.blend else 0x02) | (0x01 if f.dispose
                                                     else 0)]))
        body += _chunk(b"ANMF", hdr + _frame_data(f.px))
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def smooth(w: int, h: int, c: int, seed: int) -> np.ndarray:
    """A smooth (h, w, c) u8 picture from a seed."""
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (6, 8, c), np.uint8)
    return np.asarray(Image.fromarray(small).resize((w, h), Image.BICUBIC))


def mixed_anim(width: int, height: int, n: int, seed: int,
               icc: Optional[bytes] = None) -> bytes:
    """n frames: a full first frame, then sub-rects at even offsets with
    partial alpha, every blend/dispose combination, durations 30-90 ms."""
    rng = np.random.default_rng(seed)
    frames = [Frame(smooth(width, height, 4, seed), duration_ms=40)]
    for k in range(1, n):
        w = int(rng.integers(2, width + 1))
        h = int(rng.integers(2, height + 1))
        x = int(rng.integers(0, (width - w) // 2 + 1)) * 2
        y = int(rng.integers(0, (height - h) // 2 + 1)) * 2
        px = smooth(w, h, 4, seed * 31 + k).copy()
        px[..., 3] = rng.choice([0, 77, 200, 255], (h, w)).astype(np.uint8)
        frames.append(Frame(px, x, y, 30 + 10 * (k % 7), bool(k & 1),
                            bool(k & 2)))
    return anim_webp(width, height, frames, loops=2, icc=icc)
