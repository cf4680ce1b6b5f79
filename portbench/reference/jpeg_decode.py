"""A plain baseline JPEG parser and Huffman decoder (Python and numpy).

It reads what the program's outputs are: baseline sequential JPEGs
(SOF0), Huffman-coded, interleaved, without restart markers, and gives
back each component's quantized coefficients in natural order, with the
tables and sampling factors. It reads the outputs only to judge them.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np

from .jpeg_fit import ZIGZAG


@functools.lru_cache(maxsize=16)
def _lookup(bits: bytes, vals: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """16-bit-window tables of a Huffman table: (symbol, code length) of
    the code that starts each 16-bit window (length 0: no code)."""
    sym = np.zeros(1 << 16, np.int32)
    length = np.zeros(1 << 16, np.int32)
    code, k = 0, 0
    for n in range(1, 17):
        for _ in range(bits[n - 1]):
            lo = code << (16 - n)
            hi = (code + 1) << (16 - n)
            sym[lo:hi] = vals[k]
            length[lo:hi] = n
            k += 1
            code += 1
        code <<= 1
    return sym, length


def _segments(buf: bytes):
    """(marker, payload start, payload end) of each marker segment up to
    and including SOS; the last item is the SOS's."""
    if buf[:2] != b"\xff\xd8":
        raise ValueError("no SOI")
    pos = 2
    while pos + 4 <= len(buf):
        if buf[pos] != 0xFF:
            raise ValueError("marker expected")
        marker = buf[pos + 1]
        n = int.from_bytes(buf[pos + 2:pos + 4], "big")
        yield marker, pos + 4, pos + 2 + n
        if marker == 0xDA:
            return
        pos += 2 + n
    raise ValueError("no SOS")


def _entropy_bits(buf: bytes, start: int) -> str:
    """The entropy-coded data after SOS as a bit string, byte stuffing
    removed, up to the next marker, then 16 one-bits of padding."""
    data = buf[start:]
    out, i = bytearray(), 0
    while i < len(data):
        b = data[i]
        if b == 0xFF:
            if i + 1 < len(data) and data[i + 1] == 0x00:
                out.append(0xFF)
                i += 2
                continue
            break
        out.append(b)
        i += 1
    return "".join(f"{x:08b}" for x in out) + "1" * 16


def _value(bits: str, pos: int, size: int) -> int:
    """The signed value of a `size`-bit magnitude category (T.81 F.2.2.1)."""
    v = int(bits[pos:pos + size], 2)
    return v if bits[pos] == "1" else v - (1 << size) + 1


def _block(bits: str, pos: int, dc, ac, pred: int):
    """(the block's 64 coefficients in natural order, the position after
    it, the component's new DC predictor)."""
    blk = np.zeros(64, np.int64)
    w16 = int(bits[pos:pos + 16], 2)
    if not dc[1][w16]:
        raise ValueError("bad DC code")
    t = int(dc[0][w16])
    pos += int(dc[1][w16])
    if t:
        pred += _value(bits, pos, t)
        pos += t
    blk[0] = pred
    k = 1
    while k < 64:
        w16 = int(bits[pos:pos + 16], 2)
        if not ac[1][w16]:
            raise ValueError("bad AC code")
        rs = int(ac[0][w16])
        pos += int(ac[1][w16])
        r, z = rs >> 4, rs & 15
        if z == 0:
            if r != 15:
                break
            k += 16
            continue
        k += r
        if k > 63:
            raise ValueError("AC index past 63")
        blk[ZIGZAG[k]] = _value(bits, pos, z)
        pos += z
        k += 1
    return blk, pos, pred


def decode_baseline(buf: bytes) -> Dict:
    """{width, height, sampling [(h, v)...], qtables [luma, chroma] (u16,
    natural order, by each component's table), coefs [(bh, bw, 64) int64
    per component]}. Raises ValueError on anything it does not read."""
    qts: Dict[int, np.ndarray] = {}
    huff: Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray]] = {}
    comps, sos = [], None
    width = height = 0
    for marker, a, b in _segments(buf):
        seg = buf[a:b]
        if marker == 0xDB:
            p = 0
            while p < len(seg):
                pq, tq = seg[p] >> 4, seg[p] & 15
                n = 64 * (2 if pq else 1)
                raw = np.frombuffer(seg[p + 1:p + 1 + n],
                                    ">u2" if pq else np.uint8)
                t = np.zeros(64, np.uint16)
                t[ZIGZAG] = raw
                qts[tq] = t
                p += 1 + n
        elif marker == 0xC4:
            p = 0
            while p < len(seg):
                tc, th = seg[p] >> 4, seg[p] & 15
                bits = seg[p + 1:p + 17]
                nv = sum(bits)
                huff[(tc, th)] = _lookup(bytes(bits),
                                         bytes(seg[p + 17:p + 17 + nv]))
                p += 17 + nv
        elif marker in (0xC0, 0xC1):
            height = int.from_bytes(seg[1:3], "big")
            width = int.from_bytes(seg[3:5], "big")
            for c in range(seg[5]):
                cid, hv, tq = seg[6 + 3 * c:9 + 3 * c]
                comps.append({"id": cid, "h": hv >> 4, "v": hv & 15,
                              "tq": tq})
        elif marker in (0xC2, 0xC3) or 0xC5 <= marker <= 0xCF and \
                marker != 0xC8 and marker != 0xCC:
            raise ValueError("not a baseline JPEG")
        elif marker == 0xDD:
            raise ValueError("restart intervals are not read")
        elif marker == 0xDA:
            sos = (seg, b)
    if not comps or sos is None:
        raise ValueError("no frame or scan")
    seg, data_start = sos
    ns = seg[0]
    if ns != len(comps):
        raise ValueError("non-interleaved scans are not read")
    for k in range(ns):
        cid, tab = seg[1 + 2 * k], seg[2 + 2 * k]
        c = next(c for c in comps if c["id"] == cid)
        c["td"], c["ta"] = tab >> 4, tab & 15
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    mx = -(-width // (8 * hmax))
    my = -(-height // (8 * vmax))
    for c in comps:
        c["grid"] = np.zeros((my * c["v"], mx * c["h"], 64), np.int64)
        c["bh"] = -(-height * c["v"] // (8 * vmax))
        c["bw"] = -(-width * c["h"] // (8 * hmax))
        c["pred"] = 0
    bits = _entropy_bits(buf, data_start)
    pos = 0
    for m in range(mx * my):
        mrow, mcol = divmod(m, mx)
        for c in comps:
            dc, ac = huff[(0, c["td"])], huff[(1, c["ta"])]
            for by in range(c["v"]):
                for bx in range(c["h"]):
                    blk, pos, c["pred"] = _block(bits, pos, dc, ac, c["pred"])
                    c["grid"][mrow * c["v"] + by, mcol * c["h"] + bx] = blk
    if pos > len(bits) - 16:
        raise ValueError("entropy data ran out")
    return {"width": width, "height": height,
            "sampling": [(c["h"], c["v"]) for c in comps],
            "qtables": [qts[c["tq"]] for c in comps[:2]],
            "coefs": [c["grid"][:c["bh"], :c["bw"]] for c in comps]}
