"""JPEG codec: host entropy stages + device dense transforms.

The counterpart of ``lilliput_tpu/codecs/jpeg.py``: header parse, marker
walkers (EXIF orientation, ICC, Adobe APP14, content length), quantization
tables, and the single-image ``JpegDecoder``/``JpegEncoder``. That module
reads headers through libjpeg (``lp_jpeg_get_info``) and scales tables with
``lp_jpeg_scale_qtable``; the port runs where libjpeg may be absent, so
``read_info`` parses the header in Python to the same fields (held against
``lp_jpeg_get_info`` in tests/test_torch_host.py) and ``scaled_qtables`` is
libjpeg's ``jpeg_quality_scaling`` arithmetic.

``JpegDecoder`` Huffman-decodes on the host (jpeg_huff.cpp: baseline and
progressive; the streams it declines, truncated ones among them, through
libjpeg as the JAX package does: ``libjpeg_decode_coefs``, a copy of its
``jpeg_shim.cpp``, which raises HostLibraryMissingError where libjpeg is
absent) and decodes the pixels on its device: the layout's CUDA decode
kernel for YCbCr sources (``ops/jpeg_kernels.decode_ycc_420``), the
``dequant_idct_blocks`` kernel's u8 epilogue for grayscale
(``decode_gray``), and its f32 epilogue once per plane for JCS_RGB and
CMYK/YCCK sources (``decode_rgb``, ``decode_cmyk``). ``JpegEncoder`` runs
the colour conversion, fDCT and quantization on the frame's device and the
port's own Huffman encoder (``encode_coefs``, ``csrc/host/jpeg_enc.cpp``)
on the host, which needs no libjpeg and writes libjpeg's bytes for every
option: baseline, progressive, optimized tables and restart markers.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..errors import DecodingFailedError, InvalidImageError
from ..framebuffer import (JPEG_CHROMA_QUALITY, JPEG_LUMA_QUALITY,
                           JPEG_OPTIMIZE, JPEG_PROGRESSIVE, JPEG_QUALITY,
                           JPEG_RST_INTERVAL, Framebuffer, ImageHeader)
from ..interfaces import Decoder, Encoder, check_encode_options
from ..utils import resolve_device

_JPEG_ENCODE_KEYS = frozenset({
    JPEG_QUALITY, JPEG_PROGRESSIVE, JPEG_OPTIMIZE, JPEG_RST_INTERVAL,
    JPEG_LUMA_QUALITY, JPEG_CHROMA_QUALITY})
_i16p = ctypes.POINTER(ctypes.c_int16)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_u16p = ctypes.POINTER(ctypes.c_uint16)

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
    LILLIPUT_JPEG_HUFF=libjpeg forces the libjpeg path everywhere (the
    escape hatch mirrors LILLIPUT_PALLAS)."""
    return os.environ.get("LILLIPUT_JPEG_HUFF", "fast") != "libjpeg"


def libjpeg_decode_coefs(buf: np.ndarray, comps, qtables: np.ndarray, info,
                         workers: int) -> None:
    """The JAX package's libjpeg route (csrc/host/jpeg_shim.cpp) into
    `comps`, each component's full-geometry int16 blocks, and `qtables`
    ((4, 64) u16): the restart-marker slicer lp_jpeg_decode_coefs_parallel
    where workers > 1 and the stream has a DRI and is not progressive,
    then lp_jpeg_decode_coefs. Raises HostLibraryMissingError where
    libjpeg is absent, DecodingFailedError where libjpeg fails."""
    from .. import binding
    lib = binding.load_jpeg()
    ptrs = (_i16p * len(comps))(*[c.ctypes.data_as(_i16p) for c in comps])
    qt = qtables.ctypes.data_as(_u16p)
    rc = -10
    if (workers > 1 and info.restart_interval > 0
            and not info.progressive):
        rc = lib.lp_jpeg_decode_coefs_parallel(_u8ptr(buf), buf.size, ptrs,
                                               qt, workers)
    if rc != 0:
        rc = lib.lp_jpeg_decode_coefs(_u8ptr(buf), buf.size, ptrs, qt,
                                      None, 0)
    if rc != 0:
        raise DecodingFailedError(f"JPEG entropy decode failed ({rc})")


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


#: subsampling name -> (h_samp, v_samp) per component
_SAMP = {"420": ([2, 1, 1], [2, 1, 1]), "422": ([2, 1, 1], [1, 1, 1]),
         "440": ([1, 1, 1], [2, 1, 1]), "444": ([1, 1, 1], [1, 1, 1])}


def synthetic_jpeg(w: int, h: int, subsampling: str = "420",
                   gray: bool = False, quality: int = 85) -> bytes:
    """Zero-coefficient baseline JPEG of an exact geometry (dims, sampling
    factors, quant tables of `quality`): the warm-up input of
    MultiGeometryPipeline.warm(). Written by the port's encoder
    (csrc/host/jpeg_enc.cpp), baseline, with libjpeg's bytes."""
    if subsampling not in _SAMP:
        raise ValueError(f"unknown subsampling {subsampling!r}")
    qt_l, qt_c = scaled_qtables(quality)
    h_samp, v_samp = ([1], [1]) if gray else _SAMP[subsampling]
    max_h, max_v = max(h_samp), max(v_samp)
    comps = [np.zeros(((h * v + 8 * max_v - 1) // (8 * max_v),
                       (w * hs + 8 * max_h - 1) // (8 * max_h), 64), np.int16)
             for hs, v in zip(h_samp, v_samp)]
    return encode_coefs(w, h, comps, h_samp, v_samp, qt_l, qt_c)


def encode_coefs(w: int, h: int, comps, h_samp, v_samp, qt_l: np.ndarray,
                 qt_c: np.ndarray, progressive: int = 0, optimize: int = 0,
                 restart_rows: int = 0, icc: bytes = b"",
                 out: Optional[np.ndarray] = None) -> bytes:
    """Huffman-code quantized coefficients on the host with the port's
    lpt_jpeg_encode_coefs (csrc/host/jpeg_enc.cpp), which writes the bytes
    of the JAX package's lp_jpeg_encode_coefs (libjpeg) for every option:
    progressive (jpeg_simple_progression's script), optimize (optimal
    Huffman tables), restart_rows (a restart marker every that many MCU
    rows). comps: each component's contiguous int16 (blocks_h, blocks_w,
    64) coefficients at libjpeg's block geometry; qt_*: u16 (64,) tables;
    out: a u8 buffer to write into (one is made when None)."""
    from .. import binding
    nc = len(comps)
    if out is None:
        out = np.empty(w * h * 4 + len(icc) + (1 << 20), np.uint8)
    icc_arr = np.frombuffer(icc, np.uint8) if icc else None
    n = binding.load().lpt_jpeg_encode_coefs(
        w, h, nc, (ctypes.c_int32 * nc)(*h_samp),
        (ctypes.c_int32 * nc)(*v_samp),
        (_i16p * nc)(*[c.ctypes.data_as(_i16p) for c in comps]),
        qt_l.ctypes.data_as(_u16p), qt_c.ctypes.data_as(_u16p),
        int(progressive), int(optimize), int(restart_rows),
        icc_arr.ctypes.data_as(_u8p) if icc_arr is not None else None,
        len(icc), _u8ptr(out), out.size)
    if n < 0:
        raise DecodingFailedError(f"JPEG entropy encode failed ({n})")
    return out[:n].tobytes()


# ---------------------------------------------------------------------------
# byte walkers of the single-image surface
# ---------------------------------------------------------------------------

def has_adobe_marker(buf: bytes) -> bool:
    """APP14 'Adobe' marker: CMYK/YCCK samples are stored inverted.

    libjpeg (examine_app14) matches the 5 ASCII bytes "Adobe" with a
    12-byte payload (seglen >= 14 counting the length field)."""
    for marker, off, seglen in _iter_marker_segments(buf):
        if marker == 0xEE and seglen >= 14 and buf[off:off + 5] == b"Adobe":
            return True
    return False


def jpeg_content_length(buf: bytes) -> int:
    """Length up to and including EOI; trailing bytes beyond are unwanted
    (acropalypse-type leak surface, see reference opencv.go:502-557).

    Walks marker segments (so EOIs inside EXIF thumbnails are skipped), then
    scans entropy data where 0xFF is always escaped (FF 00) or a RST marker,
    making the first unescaped FF D9 the real EOI."""
    n = len(buf)
    i = 2  # past SOI
    in_scan = False
    while i + 1 < n:
        if not in_scan:
            if buf[i] != 0xFF:
                return n  # malformed; keep everything
            while i + 2 < n and buf[i + 1] == 0xFF:  # 0xFF fill bytes
                i += 1
            marker = buf[i + 1]
            if marker == 0xD9:
                return i + 2
            if marker == 0xDA:
                i += 2 + int.from_bytes(buf[i + 2:i + 4], "big")
                in_scan = True
                continue
            if marker in (0x01,) or 0xD0 <= marker <= 0xD8:
                i += 2
                continue
            if i + 4 > n:
                return n
            i += 2 + int.from_bytes(buf[i + 2:i + 4], "big")
        else:
            idx = buf.find(b"\xff", i)
            if idx == -1 or idx + 1 >= n:
                return n
            m = buf[idx + 1]
            if m == 0xD9:
                return idx + 2
            if m == 0x00 or 0xD0 <= m <= 0xD7:
                i = idx + 2  # stuffed byte or restart marker: still in scan
            else:
                i = idx      # next marker segment (e.g. progressive scans)
                in_scan = False
    return n


def intra_decode_workers() -> int:
    """Host threads for restart-marker-parallel Huffman decode of ONE image
    (LILLIPUT_JPEG_INTRA_WORKERS; default 1 = serial)."""
    try:
        return max(int(os.environ.get("LILLIPUT_JPEG_INTRA_WORKERS", "1")), 1)
    except ValueError:
        return 1


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

class JpegDecoder(Decoder):
    """One JPEG still: the header on construction, the pixels on
    ``decode_to`` as an (H, W, 3) BGR or (H, W, 1) gray u8 tensor on
    `device` ("cuda" unless the caller asks for the CPU)."""

    def __init__(self, buf: bytes, device="cuda"):
        if len(buf) < 3 or buf[0] != 0xFF or buf[1] != 0xD8:
            raise InvalidImageError("not a JPEG")
        self.device = resolve_device(device)
        self._buf = np.frombuffer(buf, np.uint8)
        self._raw = buf
        from .. import binding
        self._lib = binding.load()
        try:
            self._info = read_info(buf)
        except DecodingFailedError as e:
            raise InvalidImageError(str(e)) from e
        self._decoded = False
        self._header: Optional[ImageHeader] = None

    def header(self) -> ImageHeader:
        if self._header is None:
            info = self._info
            self._header = ImageHeader(
                width=info.width,
                height=info.height,
                channels=1 if info.num_components == 1 else 3,
                orientation=exif_orientation(self._raw),
                num_frames=1,
                content_length=jpeg_content_length(self._raw),
            )
        return self._header

    def description(self) -> str:
        return "JPEG"

    def icc(self) -> bytes:
        # jpeg_huff.cpp skips APPn payloads; the APP2 walk returns the
        # concatenation libjpeg's reader does
        return read_icc(self._raw) if self._info.icc_length > 0 else b""

    def _decode_coefs_cached(self):
        if hasattr(self, "_coefs"):
            return
        info = self._info
        nc = info.num_components
        coefs = [np.empty((info.comp_blocks_h[c], info.comp_blocks_w[c], 64),
                          np.int16) for c in range(nc)]
        qtables = np.zeros((4, 64), np.uint16)
        workers = intra_decode_workers()
        rc = -10
        if use_fast_huff():
            rc = self._lib.lp_jpeg_decode_coefs_fast(
                _u8ptr(self._buf), self._buf.size,
                (_i16p * nc)(*[c.ctypes.data_as(_i16p) for c in coefs]),
                qtables.ctypes.data_as(_u16p), workers)
        if rc != 0:
            # jpeg_huff.cpp declines (truncated scans, arithmetic coding,
            # non-interleaved baseline scans, ...): libjpeg, as the JAX
            # package decodes them; the restart slicer only without an
            # ICC profile, as there
            libjpeg_decode_coefs(self._buf, coefs, qtables, info,
                                 workers if info.icc_length == 0 else 1)
        self._coefs = coefs
        self._qtables = qtables

    def _coef(self, c: int) -> torch.Tensor:
        return torch.from_numpy(self._coefs[c]).to(self.device)

    def _qtable(self, c: int) -> torch.Tensor:
        t = self._qtables[self._info.comp_quant_tbl[c]].astype(np.float32)
        return torch.from_numpy(t).to(self.device)

    def decode_to(self, fb: Framebuffer) -> None:
        if self._decoded:
            raise EOFError()
        fb.array = self.frame(self._coef, self._qtable)
        fb.duration = 0.0
        fb.x_offset = fb.y_offset = 0
        self._decoded = True

    def frame(self, coef, qtable, plain: bool = False) -> torch.Tensor:
        """The pixels, (..., H, W, 3) BGR or (..., H, W, 1) gray u8, from
        `coef(c)` and `qtable(c)`, component c's coefficients and f32
        quant table (self._coef and self._qtable, or stacks of them);
        plain=True takes the kernels' plain versions. Each colour space
        runs its kernels once: the layout's decode kernel for YCbCr,
        dequant_idct_blocks once per component for gray (u8 epilogue),
        JCS_RGB and CMYK/YCCK (f32 epilogues)."""
        from ..ops import jpeg_kernels as K
        info = self._info
        h, w, nc = info.height, info.width, info.num_components
        if nc == 1:
            self._decode_coefs_cached()
            return K.decode_gray(coef(0), qtable(0), h, w, plain)[..., None]
        if nc == 3:
            if not supported_subsampling(info):
                raise DecodingFailedError("unsupported chroma subsampling")
            if info.jpeg_color_space not in (JCS_RGB, JCS_YCBCR):
                raise DecodingFailedError(
                    f"unsupported 3-component JPEG colorspace "
                    f"{info.jpeg_color_space}")
            self._decode_coefs_cached()
            h2 = info.comp_h_samp[0] // info.comp_h_samp[1] == 2
            v2 = info.comp_v_samp[0] // info.comp_v_samp[1] == 2
            if info.jpeg_color_space == JCS_RGB:
                return K.decode_rgb(*(coef(c) for c in range(3)),
                                    *(qtable(c) for c in range(3)),
                                    h, w, h2, v2, plain)
            tcb, tcr = info.comp_quant_tbl[1], info.comp_quant_tbl[2]
            planes = K.decode_ycc_420(
                coef(0), coef(1), coef(2), qtable(0), qtable(1), h, w,
                h2, v2, qt_chroma2=None if tcr == tcb else qtable(2),
                plain=plain)
            return torch.stack(planes, dim=-1)
        if nc == 4:
            # CMYK (JCS_CMYK) / YCCK (JCS_YCCK): uniform sampling only
            if len({(info.comp_h_samp[i], info.comp_v_samp[i])
                    for i in range(4)}) != 1:
                raise DecodingFailedError("subsampled CMYK JPEG unsupported")
            self._decode_coefs_cached()
            return K.decode_cmyk(*(coef(c) for c in range(4)),
                                 *(qtable(c) for c in range(4)), h, w,
                                 info.jpeg_color_space == JCS_YCCK,
                                 has_adobe_marker(self._raw), plain)
        raise DecodingFailedError(
            f"unsupported JPEG component count {nc}")


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

class JpegEncoder(Encoder):
    """Single-frame encoder: colour conversion, fDCT and quantization on
    the frame's device, Huffman coding on the host (encode_coefs: baseline,
    JPEG_PROGRESSIVE, JPEG_OPTIMIZE and JPEG_RST_INTERVAL, as the JAX
    package's libjpeg writes them)."""

    def __init__(self, decoded_by: Optional[Decoder] = None,
                 icc_override: Optional[bytes] = None):
        self._icc = icc_override
        if self._icc is None and decoded_by is not None:
            try:
                self._icc = decoded_by.icc() or None
            except Exception:
                self._icc = None

    def encode(self, fb: Optional[Framebuffer], opts: Dict[int, int]) -> Optional[bytes]:
        if fb is None:
            raise DecodingFailedError("JPEG encoder cannot flush without a frame")
        opts = opts or {}
        check_encode_options(opts, _JPEG_ENCODE_KEYS, "jpeg")
        quality = int(opts.get(JPEG_QUALITY, 95))
        quality = min(max(quality, 1), 100)
        progressive = 1 if opts.get(JPEG_PROGRESSIVE, 0) else 0
        optimize = 1 if opts.get(JPEG_OPTIMIZE, 0) else 0
        rst_rows = max(int(opts.get(JPEG_RST_INTERVAL, 0)), 0)
        # per-table quality: LUMA_QUALITY overrides the overall quality for
        # the luma table; CHROMA_QUALITY defaults to LUMA_QUALITY and is
        # ignored without it (cv2's own gate)
        luma_q = int(opts.get(JPEG_LUMA_QUALITY, -1))
        if luma_q >= 0:
            luma_q = min(max(luma_q, 1), 100)
            chroma_q = int(opts.get(JPEG_CHROMA_QUALITY, luma_q))
            chroma_q = min(max(chroma_q, 1), 100)
            qt_l, qt_c = scaled_qtables(luma_q, chroma_q)
        else:
            qt_l, qt_c = scaled_qtables(quality)

        from ..ops import jpeg_kernels as K
        arr = fb.array
        h, w = fb.height, fb.width

        def dev(qt):
            return torch.from_numpy(qt.astype(np.float32)).to(arr.device)
        if fb.channels == 1:
            comps = [K.encode_gray_from_u8(arr, dev(qt_l))]
            h_samp, v_samp = [1], [1]
        else:
            comps = list(K.encode_from_bgr(arr, dev(qt_l), dev(qt_c),
                                           subsample=True))
            h_samp, v_samp = [2, 1, 1], [2, 1, 1]
        # crop the MCU padding to libjpeg's block geometry
        # (width_in_blocks = ceil(w*hs/(8*max_h)), same for rows)
        max_h, max_v = max(h_samp), max(v_samp)
        for i in range(len(comps)):
            exp_bw = (w * h_samp[i] + 8 * max_h - 1) // (8 * max_h)
            exp_bh = (h * v_samp[i] + 8 * max_v - 1) // (8 * max_v)
            comps[i] = np.ascontiguousarray(
                comps[i][:exp_bh, :exp_bw].cpu().numpy())
        return encode_coefs(w, h, comps, h_samp, v_samp, qt_l, qt_c,
                            progressive, optimize, rst_rows,
                            self._icc or b"")


def _u8ptr(arr: np.ndarray):
    return arr.ctypes.data_as(_u8p)
