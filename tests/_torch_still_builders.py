"""Packers of still-image test inputs with the standard library and
numpy (no PIL or cv2): PNG and APNG (every colour type and bit depth,
the five row filters, Adam7), BMP (palettes, BI_BITFIELDS, RLE8, core
and top-down headers), 16-bit PNM and Sun Raster.

The parity tests (tests/test_torch_still_codecs.py) build their inputs
with these, and chip_smoke.py its 1080p still-format inputs.
"""

import struct
import zlib

import numpy as np


def png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def pack_samples(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, c) integer samples -> (h, stride) u8 PNG rows: big-endian
    16-bit, bytes, or 1/2/4-bit values packed most significant first."""
    h = samples.shape[0]
    s = samples.reshape(h, -1).astype(np.int64)
    if depth == 16:
        return np.stack([s >> 8, s & 255], axis=-1).reshape(h, -1).astype(
            np.uint8)
    if depth == 8:
        return s.astype(np.uint8)
    bits = (s[..., None] >> np.arange(depth - 1, -1, -1)) & 1
    return np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1)


def png_filter(rows: np.ndarray, bpp: int, filters=(0,)) -> bytes:
    """Filter (h, stride) u8 rows, row r with type filters[r % len]: None,
    Sub, Up, Average, Paeth (PNG spec 9.2), each byte from unfiltered
    neighbours."""
    out = []
    prev = np.zeros(rows.shape[1], np.int64)
    for r, row in enumerate(rows.astype(np.int64)):
        ft = filters[r % len(filters)]
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if ft == 0:
            pred = np.zeros_like(row)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = prev
        elif ft == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, ul))
        out.append(bytes([ft]) + ((row - pred) & 255).astype(
            np.uint8).tobytes())
        prev = row
    return b"".join(out)


_ADAM7 = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)]


def png_image_data(samples: np.ndarray, depth: int, interlace: int = 0,
                   filters=(0,)) -> bytes:
    """The filtered (and for interlace=1, Adam7) stream of (h, w, c)
    samples, before deflate."""
    c = samples.shape[2]
    bpp = max(1, c * depth // 8)
    if not interlace:
        return png_filter(pack_samples(samples, depth), bpp, filters)
    return b"".join(
        png_filter(pack_samples(samples[y0::dy, x0::dx], depth), bpp, filters)
        for x0, y0, dx, dy in _ADAM7
        if samples[y0::dy, x0::dx].size)


def png_bytes(samples: np.ndarray, color_type: int, depth: int = 8,
              interlace: int = 0, palette=None, trns: bytes = None,
              filters=(0,), level: int = 6) -> bytes:
    """A PNG of (h, w, c) samples in the file's channel order (RGB(A),
    gray(+alpha) or palette indices): IHDR, PLTE, tRNS, one IDAT, IEND."""
    h, w = samples.shape[:2]
    out = [b"\x89PNG\r\n\x1a\n", png_chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color_type, 0, 0, interlace))]
    if palette is not None:
        out.append(png_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    if trns is not None:
        out.append(png_chunk(b"tRNS", trns))
    out.append(png_chunk(b"IDAT", zlib.compress(
        png_image_data(samples, depth, interlace, filters), level)))
    out.append(png_chunk(b"IEND", b""))
    return b"".join(out)


def apng_bytes(width: int, height: int, color_type: int, frames) -> bytes:
    """An 8-bit APNG of `frames`, each (samples, x, y, delay_num,
    delay_den, dispose, blend); the first frame is the IDAT image."""
    out = [b"\x89PNG\r\n\x1a\n", png_chunk(b"IHDR", struct.pack(
        ">IIBBBBB", width, height, 8, color_type, 0, 0, 0)),
        png_chunk(b"acTL", struct.pack(">II", len(frames), 0))]
    seq = 0
    for i, (px, x, y, dn, dd, dispose, blend) in enumerate(frames):
        h, w = px.shape[:2]
        out.append(png_chunk(b"fcTL", struct.pack(
            ">IIIIIHHBB", seq, w, h, x, y, dn, dd, dispose, blend)))
        seq += 1
        data = zlib.compress(png_image_data(px, 8, 0, (0, 1, 4)))
        if i == 0:
            out.append(png_chunk(b"IDAT", data))
        else:
            out.append(png_chunk(b"fdAT", struct.pack(">I", seq) + data))
            seq += 1
    out.append(png_chunk(b"IEND", b""))
    return b"".join(out)


def bmp_bytes(w: int, h: int, bpp: int, data: bytes, palette=None,
              compression: int = 0, masks=None, top_down: bool = False,
              core: bool = False) -> bytes:
    """A BMP around `data` (rows bottom-up unless top_down, each padded to
    4 bytes, or an RLE stream): a BITMAPINFOHEADER (BITMAPCOREHEADER when
    core), the BI_BITFIELDS masks (R, G, B) after it, a BGR(0) palette."""
    if core:
        hdr = struct.pack("<IhhHH", 12, w, h, 1, bpp)
    else:
        hdr = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1,
                          bpp, compression, len(data), 2835, 2835,
                          0 if palette is None else len(palette), 0)
    extra = b"" if masks is None else struct.pack("<III", *masks)
    pal = b""
    if palette is not None:
        p = np.asarray(palette, np.uint8)
        pal = (p if core else np.concatenate(
            [p, np.zeros((len(p), 1), np.uint8)], axis=1)).tobytes()
    off = 14 + len(hdr) + len(extra) + len(pal)
    return (b"BM" + struct.pack("<IHHI", off + len(data), 0, 0, off) + hdr
            + extra + pal + data)


def bmp_rows(rows: np.ndarray) -> bytes:
    """(h, n) u8 rows, top row first -> bottom-up rows padded to 4 bytes."""
    pad = -rows.shape[1] % 4
    return np.pad(rows, ((0, 0), (0, pad)))[::-1].tobytes()


def bmp_rle8(idx: np.ndarray) -> bytes:
    """RLE8 of (h, w) palette indices, bottom-up: chunks of 8 pixels as a
    run when all equal, in absolute mode otherwise (runs of 1 for a tail
    of fewer than 3), end of line after each row, end of bitmap."""
    out = bytearray()
    for row in idx[::-1]:
        for x in range(0, len(row), 8):
            ch = row[x:x + 8]
            if (ch == ch[0]).all():
                out += bytes([len(ch), ch[0]])
            elif len(ch) >= 3:
                out += bytes([0, len(ch)]) + ch.tobytes() + bytes(len(ch) & 1)
            else:
                for v in ch:
                    out += bytes([1, v])
        out += b"\x00\x00"
    return bytes(out + b"\x00\x01")


def pnm16(samples: np.ndarray) -> bytes:
    """Binary 16-bit PGM/PPM (maxval 65535) of (h, w, 1 or 3) samples,
    big-endian, RGB order."""
    h, w, c = samples.shape
    head = b"P%d\n%d %d\n65535\n" % (5 if c == 1 else 6, w, h)
    return head + samples.astype(">u2").tobytes()


def sunras_bytes(w: int, h: int, depth: int, data: bytes, kind: int = 1,
                 colormap=None) -> bytes:
    """A Sun Raster around `data` (rows padded to even bytes, or an RLE
    stream for kind 2); colormap (n, 3) RGB, stored all R, all G, all B."""
    cmap = (b"" if colormap is None
            else np.asarray(colormap, np.uint8).T.tobytes())
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(data), kind,
                       1 if cmap else 0, len(cmap)) + cmap + data
