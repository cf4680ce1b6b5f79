"""JPEG host helpers of the serving slice: header parse, marker walkers,
quantization tables.

The counterpart of the host half of ``lilliput_tpu/codecs/jpeg.py``. That
module reads headers through libjpeg (``lp_jpeg_get_info``) and scales
tables with ``lp_jpeg_scale_qtable``; the port runs where libjpeg may be
absent, so ``read_info`` parses the header in Python to the same fields
(held against ``lp_jpeg_get_info`` in tests/test_torch_host.py) and
``scaled_qtables`` is libjpeg's ``jpeg_quality_scaling`` arithmetic. The
full ``JpegDecoder``/``JpegEncoder`` are not ported yet (ROADMAP queue 1).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from ..errors import DecodingFailedError

# Standard Annex K base quantization tables (JPEG spec Tables K.1/K.2).
STD_LUMA_QTABLE = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99], dtype=np.uint16)
STD_CHROMA_QTABLE = np.array([
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99], dtype=np.uint16)

_MAX_COMPONENTS = 4

# libjpeg J_COLOR_SPACE values
JCS_UNKNOWN, JCS_GRAYSCALE, JCS_RGB, JCS_YCBCR, JCS_CMYK, JCS_YCCK = range(6)


class _JpegInfo(ctypes.Structure):
    """Same layout and meaning as lilliput_tpu.codecs.jpeg._JpegInfo (the
    lp_jpeg_info struct of jpeg_shim.cpp)."""
    _fields_ = [
        ("width", ctypes.c_int32),
        ("height", ctypes.c_int32),
        ("num_components", ctypes.c_int32),
        ("progressive", ctypes.c_int32),
        ("icc_length", ctypes.c_int32),
        ("comp_h_samp", ctypes.c_int32 * _MAX_COMPONENTS),
        ("comp_v_samp", ctypes.c_int32 * _MAX_COMPONENTS),
        ("comp_quant_tbl", ctypes.c_int32 * _MAX_COMPONENTS),
        ("comp_blocks_w", ctypes.c_int32 * _MAX_COMPONENTS),
        ("comp_blocks_h", ctypes.c_int32 * _MAX_COMPONENTS),
        ("comp_downsampled_w", ctypes.c_int32 * _MAX_COMPONENTS),
        ("comp_downsampled_h", ctypes.c_int32 * _MAX_COMPONENTS),
        ("jpeg_color_space", ctypes.c_int32),
        ("restart_interval", ctypes.c_int32),
    ]


def use_fast_huff() -> bool:
    """Own baseline Huffman decoder (jpeg_huff.cpp) on by default;
    LILLIPUT_JPEG_HUFF=libjpeg asks for the libjpeg path, which the port
    does not have (its callers raise)."""
    return os.environ.get("LILLIPUT_JPEG_HUFF", "fast") != "libjpeg"


# ---------------------------------------------------------------------------
# host-side byte walkers (mirroring the reference's pure-Go JPEG walkers)
# ---------------------------------------------------------------------------

def supported_subsampling(info) -> bool:
    """True when a 3-component JPEG's chroma layout maps onto the device
    decode paths: INTEGER 1x/2x luma:chroma factors on both axes and
    IDENTICAL Cb/Cr sampling. Legal-but-exotic layouts (4:1:1, 3:2
    ratios, Cb != Cr sampling) must be rejected, not mis-decoded — the
    device fns derive one (h2, v2) pair from component 1."""
    hy, vy = info.comp_h_samp[0], info.comp_v_samp[0]
    for c in (1, 2):
        hc, vc = info.comp_h_samp[c], info.comp_v_samp[c]
        if hc <= 0 or vc <= 0 or hy % hc or vy % vc:
            return False
        if hy // hc not in (1, 2) or vy // vc not in (1, 2):
            return False
    return (info.comp_h_samp[1] == info.comp_h_samp[2]
            and info.comp_v_samp[1] == info.comp_v_samp[2])


def _iter_marker_segments(buf: bytes):
    """Header-phase JPEG marker walk, shared by every marker reader below
    (one copy of the hardening: 0xFF fill bytes, standalone RST/TEM/SOI
    skip, SOS/EOI stop, seglen/overrun guards). Yields
    (marker, payload_offset, seglen) where payload starts right after the
    2 length bytes and spans seglen-2 bytes."""
    n = len(buf)
    i = 2  # past SOI
    while i + 4 <= n and buf[i] == 0xFF:
        while i + 2 <= n and buf[i + 1] == 0xFF:  # 0xFF fill bytes (T.81)
            i += 1
        if i + 4 > n:
            break
        marker = buf[i + 1]
        if marker == 0xD8 or 0xD0 <= marker <= 0xD7 or marker == 0x01:
            i += 2
            continue
        if marker in (0xD9, 0xDA):  # EOI / SOS: header segments are over
            break
        seglen = int.from_bytes(buf[i + 2:i + 4], "big")
        if seglen < 2 or i + 2 + seglen > n:
            break
        yield marker, i + 4, seglen
        i += 2 + seglen


def exif_orientation(buf: bytes) -> int:
    """EXIF orientation (1..8) from the APP1 segment; 1 when absent."""
    for marker, off, seglen in _iter_marker_segments(buf):
        if marker == 0xE1 and buf[off:off + 6] == b"Exif\x00\x00":
            o = _parse_tiff_orientation(buf[off + 6:off - 2 + seglen])
            if o:
                return o
    return 1


def _parse_tiff_orientation(tiff: bytes) -> int:
    if len(tiff) < 14:
        return 0
    if tiff[:4] == b"II*\x00":
        end = "little"
    elif tiff[:4] == b"MM\x00*":
        end = "big"
    else:
        return 0
    off = int.from_bytes(tiff[4:8], end)
    if off + 2 > len(tiff):
        return 0
    count = int.from_bytes(tiff[off:off + 2], end)
    for k in range(count):
        e = off + 2 + k * 12
        if e + 12 > len(tiff):
            return 0
        tag = int.from_bytes(tiff[e:e + 2], end)
        if tag == 0x0112:
            val = int.from_bytes(tiff[e + 8:e + 10], end)
            return val if 1 <= val <= 8 else 0
    return 0


_ICC_MARKER_PREFIX = b"ICC_PROFILE\x00"
_ICC_MAX_BYTES = 1 << 20  # same hardening cap as lilliput_tpu/codecs/icc.py


def read_icc(buf: bytes) -> bytes:
    """Assemble a JPEG's ICC profile from its APP2 marker segments (pure
    header byte walk — no entropy decode). Mirrors libjpeg's
    jpeg_read_icc_profile chunk reassembly (seq 1..count, consistent count,
    no duplicates) with the 1 MB hardening cap. Returns b"" when absent or
    malformed. The serving pipeline carries the source profile into the
    transcoded output."""
    if len(buf) < 4 or buf[0:2] != b"\xff\xd8":
        return b""
    chunks = {}
    count = 0
    for marker, off, seglen in _iter_marker_segments(buf):
        if marker == 0xE2:
            p = buf[off:off - 2 + seglen]
            if p[:12] == _ICC_MARKER_PREFIX and len(p) >= 14:
                seq, cnt = p[12], p[13]
                if count == 0:
                    count = cnt
                # all-or-nothing like libjpeg's jpeg_read_icc_profile: a
                # duplicate seq number or a chunk whose count byte disagrees
                # with the first chunk's marks the whole profile malformed
                if cnt != count or not 1 <= seq <= count or seq in chunks:
                    return b""
                chunks[seq] = p[14:]
    if not count or len(chunks) != count:
        return b""
    out = b"".join(chunks[s] for s in range(1, count + 1))
    return out if 0 < len(out) <= _ICC_MAX_BYTES else b""


# ---------------------------------------------------------------------------
# header parse (libjpeg jpeg_read_header semantics)
# ---------------------------------------------------------------------------

_SOF_SUPPORTED = {0xC0: False, 0xC1: False, 0xC2: True,   # Huffman
                  0xC9: False, 0xCA: True}                 # arithmetic
_SOF_UNSUPPORTED = {0xC3, 0xC5, 0xC6, 0xC7, 0xCB, 0xCD, 0xCE, 0xCF}
_MAX_DIMENSION = 65500  # libjpeg JPEG_MAX_DIMENSION


def _fail(why: str):
    raise DecodingFailedError(f"JPEG header parse failed: {why}")


def read_info(buf: bytes) -> _JpegInfo:
    """Header-only parse to the fields ``lp_jpeg_get_info`` reports.

    Walks markers the way libjpeg's jpeg_read_header does (stray bytes
    before a marker skipped, fill bytes, SOF/DQT/DHT/DRI/SOS length and
    index checks, JFIF APP0 and Adobe APP14 examined for the colour space)
    and stops at the first SOS. Raises DecodingFailedError wherever
    jpeg_read_header would fail. ``icc_length`` is the length of
    ``read_icc(buf)``."""
    n = len(buf)
    if n < 2 or buf[0] != 0xFF or buf[1] != 0xD8:
        _fail("no SOI")
    info = _JpegInfo()
    comp_ids = []
    saw_sof = saw_jfif = saw_adobe = False
    adobe_transform = 0
    i = 2
    while True:
        # next_marker: skip stray bytes, then 0xFF fill bytes
        while i < n and buf[i] != 0xFF:
            i += 1
        while i + 1 < n and buf[i + 1] == 0xFF:
            i += 1
        if i + 1 >= n:
            _fail("no image before end of data")
        m = buf[i + 1]
        i += 2
        if 0xD0 <= m <= 0xD7 or m == 0x01:
            continue
        if m == 0xD8:
            _fail("duplicate SOI")
        if m == 0xD9:
            _fail("EOI before the first scan")
        if m in _SOF_UNSUPPORTED or not (
                m in _SOF_SUPPORTED or m in (0xC4, 0xCC, 0xDA, 0xDB, 0xDC,
                                             0xDD, 0xFE)
                or 0xE0 <= m <= 0xEF):
            _fail(f"unsupported marker 0x{m:02X}")
        if i + 2 > n:
            _fail("truncated segment")
        seglen = int.from_bytes(buf[i:i + 2], "big")
        seg = buf[i + 2:i + seglen]
        if seglen < 2 or i + seglen > n:
            _fail("truncated segment")
        i += seglen
        plen = seglen - 2
        if m in _SOF_SUPPORTED:
            if saw_sof:
                _fail("duplicate SOF")
            if plen < 6:
                _fail("short SOF")
            ncomp = seg[5]
            if plen != 6 + 3 * ncomp:
                _fail("bad SOF length")
            if seg[0] != 8:
                _fail(f"{seg[0]}-bit samples")
            height = int.from_bytes(seg[1:3], "big")
            width = int.from_bytes(seg[3:5], "big")
            if width <= 0 or height <= 0 or ncomp <= 0:
                _fail("empty image")
            if width > _MAX_DIMENSION or height > _MAX_DIMENSION:
                _fail("image too big")
            if ncomp > _MAX_COMPONENTS:
                _fail(f"{ncomp} components")
            hs, vs, tq = [], [], []
            for c in range(ncomp):
                comp_ids.append(seg[6 + 3 * c])
                hs.append(seg[7 + 3 * c] >> 4)
                vs.append(seg[7 + 3 * c] & 15)
                tq.append(seg[8 + 3 * c])
                if not (1 <= hs[-1] <= 4 and 1 <= vs[-1] <= 4):
                    _fail("bad sampling factors")
            info.width, info.height, info.num_components = width, height, ncomp
            info.progressive = int(_SOF_SUPPORTED[m])
            max_h, max_v = max(hs), max(vs)
            for c in range(ncomp):
                info.comp_h_samp[c] = hs[c]
                info.comp_v_samp[c] = vs[c]
                info.comp_quant_tbl[c] = tq[c]
                info.comp_blocks_w[c] = -(-width * hs[c] // (8 * max_h))
                info.comp_blocks_h[c] = -(-height * vs[c] // (8 * max_v))
                info.comp_downsampled_w[c] = -(-width * hs[c] // max_h)
                info.comp_downsampled_h[c] = -(-height * vs[c] // max_v)
            saw_sof = True
        elif m == 0xDB:          # DQT
            k = 0
            while k < plen:
                prec, idx = seg[k] >> 4, seg[k] & 15
                if idx >= 4:
                    _fail("DQT index")
                k += 1
                # a short last table is read as far as it goes (libjpeg)
                k += (min(128, (plen - k) // 2 * 2) if prec
                      else min(64, plen - k))
            if k != plen:
                _fail("bad DQT length")
        elif m == 0xC4:          # DHT
            k = 0
            while plen - k > 16:
                idx = seg[k] & ~0x10
                count = sum(seg[k + 1:k + 17])
                k += 17
                if count > 256 or count > plen - k:
                    _fail("bad Huffman table")
                if idx < 0 or idx >= 4:
                    _fail("DHT index")
                k += count
            if k != plen:
                _fail("bad DHT length")
        elif m == 0xDD:          # DRI
            if plen != 2:
                _fail("bad DRI length")
            info.restart_interval = int.from_bytes(seg[0:2], "big")
        elif m == 0xE0:          # APP0: JFIF marks YCbCr
            if plen >= 14 and seg[:5] == b"JFIF\x00":
                saw_jfif = True
        elif m == 0xEE:          # APP14: Adobe colour transform
            if plen >= 12 and seg[:5] == b"Adobe":
                saw_adobe = True
                adobe_transform = seg[11]
        elif m == 0xDA:          # SOS: the header ends here
            if not saw_sof:
                _fail("SOS before SOF")
            ns = seg[0] if plen else 0
            if plen != 2 * ns + 4 or not 1 <= ns <= 4:
                _fail("bad SOS length")
            seen = []
            for c in range(ns):
                cid = seg[1 + 2 * c]
                if cid not in comp_ids or cid in seen:
                    _fail("bad component id in SOS")
                seen.append(cid)
            break
    info.jpeg_color_space = _color_space(
        info.num_components, comp_ids, saw_jfif, saw_adobe, adobe_transform)
    info.icc_length = len(read_icc(buf))
    return info


def _color_space(ncomp: int, ids, jfif: bool, adobe: bool,
                 transform: int) -> int:
    """libjpeg default_decompress_parms' guess of the stored colour space."""
    if ncomp == 1:
        return JCS_GRAYSCALE
    if ncomp == 3:
        if jfif:
            return JCS_YCBCR
        if adobe:
            return JCS_RGB if transform == 0 else JCS_YCBCR
        if list(ids) == [82, 71, 66]:  # 'R', 'G', 'B'
            return JCS_RGB
        return JCS_YCBCR
    if ncomp == 4:
        if adobe:
            return JCS_CMYK if transform == 0 else JCS_YCCK
        return JCS_CMYK
    return JCS_UNKNOWN


# ---------------------------------------------------------------------------
# quantization tables
# ---------------------------------------------------------------------------

def _quality_scaling(quality: int) -> int:
    """libjpeg jpeg_quality_scaling: quality 1..100 -> percentage scale."""
    quality = min(max(int(quality), 1), 100)
    return 5000 // quality if quality < 50 else 200 - 2 * quality


def _scale_qtable(base: np.ndarray, quality: int) -> np.ndarray:
    """lp_jpeg_scale_qtable with force_baseline: (base*scale + 50) // 100,
    clamped to 1..255."""
    v = (base.astype(np.int64) * _quality_scaling(quality) + 50) // 100
    return np.clip(v, 1, 255).astype(np.uint16)


def scaled_qtables(quality: int, chroma_quality: Optional[int] = None):
    """Annex-K tables scaled by libjpeg quality semantics; chroma_quality
    scales the chroma table independently."""
    return (_scale_qtable(STD_LUMA_QTABLE, quality),
            _scale_qtable(STD_CHROMA_QTABLE,
                          quality if chroma_quality is None
                          else chroma_quality))
