"""A plain GIF89a reader (Python and numpy), written from the GIF89a
specification: the logical screen, palettes, graphics control extensions,
image descriptors and the variable-width LZW rasters, de-interlaced. It
reads the program's GIF outputs only to judge them."""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def _sub_blocks(buf: bytes, pos: int):
    """(data of the sub-blocks starting at pos, position after them)."""
    out = bytearray()
    while True:
        if pos >= len(buf):
            raise ValueError("sub-blocks run past the end")
        n = buf[pos]
        pos += 1
        if n == 0:
            return bytes(out), pos
        out += buf[pos:pos + n]
        pos += n


def lzw_decode(data: bytes, mcs: int, npix: int) -> np.ndarray:
    """The first npix indices of a GIF LZW code stream."""
    clear, end = 1 << mcs, (1 << mcs) + 1
    out = bytearray()
    table: List[bytes] = []
    width = mcs + 1
    acc = nbits = pos = 0
    prev = None

    def reset():
        table.clear()
        table.extend(bytes([i]) for i in range(clear))
        table.extend((b"", b""))
    reset()
    while len(out) < npix:
        while nbits < width:
            if pos >= len(data):
                raise ValueError("LZW data ran out")
            acc |= data[pos] << nbits
            pos += 1
            nbits += 8
        code = acc & ((1 << width) - 1)
        acc >>= width
        nbits -= width
        if code == clear:
            reset()
            width, prev = mcs + 1, None
            continue
        if code == end:
            break
        if prev is None:
            if code >= len(table):
                raise ValueError("bad first LZW code")
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        elif code == len(table):
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError("LZW code past the table")
        out += entry
        prev = entry
        if len(table) == (1 << width) and width < 12:
            width += 1
    if len(out) < npix:
        raise ValueError("raster cut short")
    return np.frombuffer(bytes(out[:npix]), np.uint8)


def _deinterlace(rows: np.ndarray) -> np.ndarray:
    h = rows.shape[0]
    order = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                            np.arange(2, h, 4), np.arange(1, h, 2)])
    out = np.empty_like(rows)
    out[order] = rows
    return out


def decode_gif(buf: bytes) -> Dict:
    """{width, height, global_palette ((n, 3) u8 or None), bg_index,
    frames: [{left, top, indices (h, w) u8, palette (local or None),
    trans (-1: none), disposal, delay_cs, interlace}]}. Raises ValueError
    on anything it does not read."""
    if buf[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError("not a GIF")
    width = int.from_bytes(buf[6:8], "little")
    height = int.from_bytes(buf[8:10], "little")
    flags, bg_index = buf[10], buf[11]
    pos = 13
    gpal = None
    if flags & 0x80:
        n = 2 << (flags & 7)
        gpal = np.frombuffer(buf[pos:pos + 3 * n], np.uint8).reshape(n, 3)
        pos += 3 * n
    frames = []
    gce = {"trans": -1, "disposal": 0, "delay_cs": 0}
    while pos < len(buf):
        rec = buf[pos]
        pos += 1
        if rec == 0x3B:
            break
        if rec == 0x21:
            func = buf[pos]
            data, pos = _sub_blocks(buf, pos + 1)
            if func == 0xF9 and len(data) >= 4:
                gce = {"trans": data[3] if data[0] & 1 else -1,
                       "disposal": (data[0] >> 2) & 7,
                       "delay_cs": data[1] | data[2] << 8}
            continue
        if rec != 0x2C:
            raise ValueError(f"unknown block 0x{rec:02x}")
        left, top, w, h = (int.from_bytes(buf[pos + 2 * i:pos + 2 * i + 2],
                                          "little") for i in range(4))
        iflags = buf[pos + 8]
        pos += 9
        local = None
        if iflags & 0x80:
            n = 2 << (iflags & 7)
            local = np.frombuffer(buf[pos:pos + 3 * n],
                                  np.uint8).reshape(n, 3)
            pos += 3 * n
        mcs = buf[pos]
        data, pos = _sub_blocks(buf, pos + 1)
        idx = lzw_decode(data, mcs, w * h).reshape(h, w)
        interlace = bool(iflags & 0x40)
        if interlace:
            idx = _deinterlace(idx)
        frames.append(dict(gce, left=left, top=top, indices=idx,
                           palette=local, interlace=interlace))
        gce = {"trans": -1, "disposal": 0, "delay_cs": 0}
    return {"width": width, "height": height, "global_palette": gpal,
            "bg_index": bg_index, "frames": frames}
