"""GIF87a/GIF89a writers in numpy and the standard library (no PIL).

What they write: global and local palettes, a graphics control extension
(GCE) with delay, disposal 0-3 and a transparent index, frames without a
GCE, partial frame rects (also ones that run off the canvas), interlaced
frames, NETSCAPE2.0 loop and comment extensions, and a raster cut short by
an early end-of-information code.

``gif_bytes`` writes a literal-only LZW stream: every pixel is one code,
and a clear code comes before the dictionary would widen the codes (after
2^mcs - 2 literals), so every code has mcs + 1 bits and the whole stream
packs with numpy. Any GIF decoder reads it, but no GIF encoder in use
writes it: it is about as large as the raster. ``codec_gif_bytes`` writes
the same frames through the port's C++ GIF encoder (``lp_gif_enc_*``,
the dictionary LZW that a real encoder writes), for inputs whose decode
cost should be that of a real file.

The parity tests (tests/test_torch_gif.py, tests/test_torch_palette.py)
build their inputs with these, and chip_smoke.py its 480x480 animations
and 1080p GIF (``pan_gif(..., codec=True)``).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class Frame:
    """One image of a GIF: palette indices at (left, top), with an optional
    local palette ((n, 3) u8 RGB) and GCE."""
    indices: np.ndarray                   # (h, w) u8
    left: int = 0
    top: int = 0
    palette: Optional[np.ndarray] = None  # local colour table
    gce: bool = True                      # write a graphics control ext.
    delay_cs: int = 4
    disposal: int = 0                     # 0 none given, 1 keep, 2 bg, 3 prev
    trans: Optional[int] = None           # transparent index
    interlace: bool = False
    comment: Optional[bytes] = None       # comment extension before it
    stop_after: Optional[int] = None      # end-of-information after n px


def _table_bits(n: int) -> int:
    """The colour-table size field: 2 << bits >= n."""
    bits = 0
    while (2 << bits) < n:
        bits += 1
    return bits


def _color_table(pal: np.ndarray) -> bytes:
    pal = np.asarray(pal, np.uint8).reshape(-1, 3)
    size = 2 << _table_bits(len(pal))
    out = np.zeros((size, 3), np.uint8)
    out[:len(pal)] = pal
    return out.tobytes()


def sub_blocks(data: bytes) -> bytes:
    """Data sub-blocks of at most 255 bytes, then the terminator."""
    a = np.frombuffer(data, np.uint8)
    n = a.size // 255
    full = np.concatenate([np.full((n, 1), 255, np.uint8),
                           a[:n * 255].reshape(n, 255)], axis=1)
    tail = a[n * 255:]
    parts = [full.tobytes()]
    if tail.size:
        parts.append(bytes([tail.size]) + tail.tobytes())
    return b"".join(parts) + b"\x00"


def lzw_literal(indices: np.ndarray, mcs: int,
                stop_after: Optional[int] = None) -> bytes:
    """Image data of `indices` (raster order): the LZW minimum code size
    byte and the sub-blocks of a literal-only code stream. stop_after=n
    ends the stream after n pixels (a premature end of information)."""
    x = np.asarray(indices, np.uint16).reshape(-1)
    if stop_after is not None:
        x = x[:stop_after]
    clear, eoi = 1 << mcs, (1 << mcs) + 1
    k = (1 << mcs) - 2                    # literals per clear
    n = x.size
    groups = max(1, -(-n // k))
    codes = np.empty(n + groups + 1, np.uint16)
    codes[np.arange(groups) * (k + 1)] = clear
    at = np.arange(n)
    codes[at + at // k + 1] = x
    codes[-1] = eoi
    width = mcs + 1
    bits = ((codes[:, None] >> np.arange(width, dtype=np.uint16)) & 1)
    packed = np.packbits(bits.astype(np.uint8).reshape(-1), bitorder="little")
    return bytes([mcs]) + sub_blocks(packed.tobytes())


def interlace_rows(indices: np.ndarray) -> np.ndarray:
    """Rows in the GIF interlace order (passes from rows 0, 4, 2, 1 in
    steps of 8, 8, 4, 2)."""
    return np.concatenate([indices[0::8], indices[4::8], indices[2::4],
                           indices[1::2]])


def gce(delay_cs: int, disposal: int, trans: Optional[int]) -> bytes:
    flags = ((disposal & 7) << 2) | (trans is not None)
    return (b"\x21\xf9\x04" + bytes([flags]) + struct.pack("<H", delay_cs)
            + bytes([0 if trans is None else trans, 0]))


def netscape_loop(loops: int) -> bytes:
    return (b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", loops)
            + b"\x00")


def comment(text: bytes) -> bytes:
    return b"\x21\xfe" + sub_blocks(text)


def gif_bytes(width: int, height: int, frames: Sequence[Frame],
              global_palette: Optional[np.ndarray] = None,
              bg_index: int = 0, loop: Optional[int] = None,
              version: bytes = b"GIF89a", aspect: int = 0,
              trailer: bool = True) -> bytes:
    """A whole GIF: header, logical screen, optional global colour table,
    the NETSCAPE loop extension (loop=None: none) and each frame."""
    flags = 0x70  # colour resolution 8 bits
    if global_palette is not None:
        flags |= 0x80 | _table_bits(len(global_palette))
    out = [version, struct.pack("<HH", width, height),
           bytes([flags, bg_index, aspect])]
    if global_palette is not None:
        out.append(_color_table(global_palette))
    if loop is not None:
        out.append(netscape_loop(loop))
    for f in frames:
        if f.comment is not None:
            out.append(comment(f.comment))
        if f.gce:
            out.append(gce(f.delay_cs, f.disposal, f.trans))
        h, w = f.indices.shape
        iflags = 0x40 if f.interlace else 0
        pal = f.palette if f.palette is not None else global_palette
        if f.palette is not None:
            iflags |= 0x80 | _table_bits(len(f.palette))
        out.append(b"\x2c" + struct.pack("<HHHH", f.left, f.top, w, h)
                   + bytes([iflags]))
        if f.palette is not None:
            out.append(_color_table(f.palette))
        mcs = 8 if pal is None else max(2, _table_bits(len(pal)) + 1)
        rows = interlace_rows(f.indices) if f.interlace else f.indices
        out.append(lzw_literal(rows, mcs, f.stop_after))
    if trailer:
        out.append(b"\x3b")
    return b"".join(out)


def codec_gif_bytes(width: int, height: int, frames: Sequence[Frame],
                    global_palette: np.ndarray, bg_index: int = 0,
                    loop: Optional[int] = None) -> bytes:
    """gif_bytes's GIF89a with dictionary LZW, through the port's C++ GIF
    encoder: the same header, palettes, extensions and frames, decoding to
    the same pictures. Every frame has a GCE and runs to its end (no
    ``gce=False``, no ``stop_after``)."""
    import ctypes
    from lilliput_tpu_torch import binding
    lib = binding.load()
    u8p, i32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32)

    def ptr(a: np.ndarray):
        return a.ctypes.data_as(u8p)

    gpal = np.ascontiguousarray(global_palette, np.uint8).reshape(-1, 3)
    h = lib.lp_gif_enc_new(width, height, 8, 0, bg_index, ptr(gpal),
                           len(gpal))
    try:
        for k, f in enumerate(frames):
            if not f.gce or f.stop_after is not None:
                raise ValueError("codec_gif_bytes writes whole frames with "
                                 "a GCE only")
            ext = b""
            if k == 0 and loop is not None:
                ext += netscape_loop(loop)[1:]
            if f.comment is not None:
                ext += comment(f.comment)[1:]
            fh, fw = f.indices.shape
            mcs = max(2, _table_bits(len(gpal)) + 1)
            desc = np.array([f.left, f.top, fw, fh, int(f.interlace),
                             -1 if f.trans is None else f.trans, f.delay_cs,
                             f.disposal, mcs], np.int32)
            extb = np.frombuffer(ext, np.uint8)
            local = (None if f.palette is None else
                     np.ascontiguousarray(f.palette, np.uint8).reshape(-1, 3))
            idx = np.ascontiguousarray(f.indices, np.uint8)
            rc = lib.lp_gif_enc_frame(
                h, ptr(extb) if extb.size else None, extb.size,
                desc.ctypes.data_as(i32p),
                None if local is None else ptr(local),
                0 if local is None else len(local), ptr(idx))
            if rc != 0:
                raise ValueError(f"frame {k} did not encode")
        out = np.empty(lib.lp_gif_enc_size(h), np.uint8)
        n = lib.lp_gif_enc_finish(h, ptr(out), out.size)
        if n < 0:
            raise ValueError("the GIF did not finish")
        return out[:n].tobytes()
    finally:
        lib.lp_gif_enc_free(h)


# -- palettes and quantization of RGB pictures --------------------------------


def palette_332() -> np.ndarray:
    """256 RGB entries: 3 bits red, 3 green, 2 blue."""
    i = np.arange(256)
    return np.stack([(i >> 5) * 255 // 7, ((i >> 2) & 7) * 255 // 7,
                     (i & 3) * 255 // 3], axis=1).astype(np.uint8)


def quantize_332(rgb: np.ndarray) -> np.ndarray:
    r, g, b = (rgb[..., k].astype(np.int64) for k in range(3))
    return ((r >> 5) << 5 | (g >> 5) << 2 | (b >> 6)).astype(np.uint8)


def palette_666() -> np.ndarray:
    """256 RGB entries: a 6x6x6 cube, then 40 grays."""
    i = np.arange(216)
    cube = np.stack([i // 36, (i // 6) % 6, i % 6], axis=1) * 51
    gray = np.repeat((np.arange(40) * 255 // 39)[:, None], 3, axis=1)
    return np.concatenate([cube, gray]).astype(np.uint8)


def quantize_666(rgb: np.ndarray) -> np.ndarray:
    q = (rgb.astype(np.int64) * 5 + 127) // 255
    return (q[..., 0] * 36 + q[..., 1] * 6 + q[..., 2]).astype(np.uint8)


def pan_frames(rgb: np.ndarray, width: int, height: int, nframes: int,
               start: int = 0) -> List[Frame]:
    """An animation of `nframes` width x height views panning across `rgb`
    ((H, W, 3) u8): the 3-3-2 global palette, every fourth frame on a local
    6x6x6 palette; frames 1, 4, 7, ... a partial rect, one of them running
    off the canvas; a transparent index on every third frame (a band of
    it drawn, which shows the canvas below); disposals cycling 1, 2, 3,
    0; frame 5 interlaced."""
    h, w = rgb.shape[:2]
    q332, q666 = quantize_332(rgb), quantize_666(rgb)
    pal666 = palette_666()
    span_x, span_y = max(1, w - width), max(1, h - height)
    frames = []
    for k in range(nframes):
        t = start + 7 * k
        x0, y0 = (t * 13) % span_x, (t * 5) % span_y
        local = k % 4 == 3
        idx = (q666 if local else q332)[y0:y0 + height,
                                        x0:x0 + width].copy()
        f = Frame(idx, palette=pal666 if local else None,
                  disposal=(1, 2, 3, 0)[k % 4], delay_cs=4 + k % 3,
                  interlace=k == 5)
        if k % 3 == 2:
            f.trans = 7 if local else 255
            idx[height // 3:height // 3 + height // 8] = f.trans
        if k % 3 == 1 and k > 0:
            r0 = width // 8 + (k % 5) * (width // 16)
            if k == 4:          # off the canvas at the bottom right
                f.left, f.top = width - width // 4, height - height // 4
                f.indices = idx[:height // 2, :width // 2].copy()
            else:
                f.left, f.top = r0, height // 6
                f.indices = idx[:height // 2, :width - r0].copy()
        frames.append(f)
    return frames


def pan_gif(rgb: np.ndarray, width: int, height: int, nframes: int,
            start: int = 0, loop: int = 0, codec: bool = False) -> bytes:
    """A width x height GIF89a of pan_frames(...) with the NETSCAPE loop
    extension and a comment before frame 1; codec=True writes it through
    codec_gif_bytes (dictionary LZW), else through gif_bytes."""
    frames = pan_frames(rgb, width, height, nframes, start)
    if nframes > 1:
        frames[1].comment = b"lilliput pan"
    write = codec_gif_bytes if codec else gif_bytes
    return write(width, height, frames, global_palette=palette_332(),
                 bg_index=3, loop=loop)
