"""Plain reference of the PNG Fit transcode (screenshot256_png).

From a source's kept pixels (straight, not premultiplied, RGB or RGBA
u8), it works out the thumbnail the transcode has to produce, with
lilliput's semantics: the centre crop of opencv.go's Fit
(``jpeg_fit.fit_rect``), then cv::resize INTER_AREA to the destination
over each channel, alpha included (``jpeg_fit.fit_area``: separable area
weights, rounded half to even, clipped to u8), in ``dtype`` on
``device``: float64 for the reference, a lower precision for the
control. The program's output PNG is read by this file's own decoder:
the chunk walk, zlib's inflate, and the five row filters undone. Nothing
here imports the program.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List

import numpy as np
import torch

from portbench.reference.jpeg_fit import fit_area

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
#: channels -> PNG colour type (8 bits a sample)
COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}
CHANNELS = {v: k for k, v in COLOR_TYPE.items()}


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def unfilter_row(kind: int, cur: np.ndarray, prev: np.ndarray,
                 bpp: int) -> np.ndarray:
    """One scanline's bytes with its filter undone (PNG spec 9.2), given
    the previous reconstructed scanline (zeros above the first)."""
    cur = cur.astype(np.int64)
    if kind == 0:
        return cur
    if kind == 1:
        return cur.reshape(-1, bpp).cumsum(0).reshape(-1) % 256
    if kind == 2:
        return (cur + prev) % 256
    if kind not in (3, 4):
        raise ValueError(f"PNG filter type {kind}")
    out, up = cur.tolist(), prev.tolist()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        if kind == 3:
            out[i] = (out[i] + (a + up[i]) // 2) & 255
        else:
            c = up[i - bpp] if i >= bpp else 0
            out[i] = (out[i] + _paeth(a, up[i], c)) & 255
    return np.array(out, np.int64)


def decode_png(buf: bytes) -> Dict:
    """{width, height, bit_depth, color_type, pixels ((h, w, channels) u8,
    None unless 8 bits a sample and not interlaced), filters (each row's
    filter type)}. ValueError where the stream is not a whole PNG."""
    if not buf.startswith(PNG_MAGIC):
        raise ValueError("not a PNG")
    pos, header, idat = len(PNG_MAGIC), None, []
    while True:
        if pos + 12 > len(buf):
            raise ValueError("PNG ends before IEND")
        (n,) = struct.unpack(">I", buf[pos:pos + 4])
        if pos + 12 + n > len(buf):
            raise ValueError("PNG chunk runs past the end")
        kind, data = buf[pos + 4:pos + 8], buf[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", buf[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + data) & 0xFFFFFFFF != crc:
            raise ValueError(f"bad {kind!r} chunk")
        pos += 12 + n
        if kind == b"IHDR":
            if n != 13:
                raise ValueError("bad IHDR")
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    out = {"width": w, "height": h, "bit_depth": depth, "color_type": ctype,
           "pixels": None, "filters": None}
    if depth != 8 or interlace or ctype not in CHANNELS:
        return out
    c = CHANNELS[ctype]
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"PNG inflate: {e}") from e
    stride = w * c
    if raw.size != h * (stride + 1):
        raise ValueError("PNG data of another size than its header's")
    rows = raw.reshape(h, stride + 1)
    prev = np.zeros(stride, np.int64)
    px = np.empty((h, stride), np.uint8)
    for y in range(h):
        prev = unfilter_row(int(rows[y, 0]), rows[y, 1:], prev, c)
        px[y] = prev
    out["pixels"] = px.reshape(h, w, c)
    out["filters"] = rows[:, 0].copy()
    return out


def fit_pixels(src: Dict, dst_w: int, dst_h: int, dtype=torch.float64,
               device="cpu") -> np.ndarray:
    """(dst_h, dst_w, channels) u8: the Fit thumbnail of a source's kept
    pixels, each channel computed in `dtype`."""
    img = torch.from_numpy(np.ascontiguousarray(src["pixels"])).to(
        device, dtype).permute(2, 0, 1)
    out = fit_area(img, dst_w, dst_h).permute(1, 2, 0)
    return out.to(torch.float64).cpu().numpy().astype(np.uint8)


def emit(src: Dict, params: Dict, dtype, device) -> bytes:
    """The reference put in the program's place: the PNG (no row filter,
    zlib level 1) of `src`'s thumbnail computed in `dtype`."""
    from portbench.inputs.png_screens import png_bytes
    px = fit_pixels(src, params["dst_w"], params["dst_h"], dtype, device)
    h, w, c = px.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           px.reshape(h, w * c)], 1)
    return png_bytes(rows, w, h, c, 1)


def check(sources: List[Dict], outputs: Dict[int, bytes], params: Dict,
          device) -> Dict[str, float]:
    """The compared numbers of a PNG Fit cell. outputs maps a sampled
    source's index to one output the program gave for it. px_share: the
    largest share, over those outputs, of output channel values unlike
    the reference's (1.0 for an output that does not parse, or has
    another size, colour type or bit depth)."""
    dst_w, dst_h = params["dst_w"], params["dst_h"]
    worst = 0.0
    for i, buf in outputs.items():
        src = sources[i]
        try:
            got = decode_png(buf)
        except ValueError:
            worst = 1.0
            continue
        if (got["pixels"] is None or (got["width"], got["height"])
                != (dst_w, dst_h)
                or got["color_type"] != COLOR_TYPE[src["channels"]]):
            worst = 1.0
            continue
        want = fit_pixels(src, dst_w, dst_h, torch.float64, device)
        worst = max(worst, np.count_nonzero(got["pixels"] != want)
                    / want.size)
    return {"px_share": worst}
