"""The AVIF encoder: libaom-av1 through the ffmpeg shim and the port's own
ISOBMFF muxer, the counterpart of ``lilliput_tpu/codecs/avif_enc.py``.

The reference drives aom through its vendored libavif (avif.cpp:614-776:
the quality, speed and timescale knobs); this module calls the system
libavcodec's libaom-av1 (``lp_av1_encode`` of ``csrc/host/avformat_shim.cpp``,
a copy of the JAX package's, built by ``binding.load_avformat``) and writes
the AVIF container itself, the mirror of what codecs/av1_raw.py parses.
Where ffmpeg's headers are absent the encode raises
``errors.HostLibraryMissingError``.

Pixels: BGR -> YUV (BT.601 studio, 4:2:0) is ops/color.bgr_to_yuv on CPU
tensors, because the encoder's frames are host arrays already (the JAX
package pins it to its host CPU device too); the AV1 coding is host native
code, as the reference's aom is. quality >= 100 switches to true lossless
(identity-matrix 4:4:4 full range, aom lossless=1), which round-trips bit
for bit.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..errors import DecodingFailedError

_TIMESCALE = 1000  # ms timescale, avif.cpp:756 parity

def _lib():
    from .. import binding
    return binding.load_avformat()


def require() -> None:
    """Raise HostLibraryMissingError where ffmpeg is absent."""
    _lib()


def _encode_frames(planes: np.ndarray, w: int, h: int, fmt: int,
                   n_frames: int, durations: Sequence[int],
                   crf: int, cpu_used: int, lossless: bool,
                   keyint: int) -> List[bytes]:
    import ctypes as c
    lib = _lib()
    u8p = c.POINTER(c.c_uint8)
    i64p = c.POINTER(c.c_int64)
    planes = np.ascontiguousarray(planes, np.uint8)
    durs = np.ascontiguousarray(durations, np.int64)
    cap = planes.size * 2 + (1 << 20)
    out = np.empty(cap, np.uint8)
    sizes = np.zeros(max(n_frames * 2, 16), np.int64)
    n = lib.lp_av1_encode(
        planes.ctypes.data_as(u8p), w, h, fmt, n_frames, _TIMESCALE,
        durs.ctypes.data_as(i64p), crf, cpu_used, 1 if lossless else 0,
        1, keyint, out.ctypes.data_as(u8p), cap,
        sizes.ctypes.data_as(i64p), len(sizes))
    if n < 0:
        raise DecodingFailedError(f"AVIF encoder: aom failed ({n})")
    pkts = []
    pos = 0
    for i in range(n):
        ln = int(sizes[i])
        pkts.append(out[pos:pos + ln].tobytes())
        pos += ln
    return pkts


def encode_still_hbd(y: np.ndarray, u: Optional[np.ndarray],
                     v: Optional[np.ndarray], depth: int, matrix: int,
                     full_range: bool,
                     alpha: Optional[np.ndarray] = None,
                     lossless: bool = True, cpu_used: int = 8,
                     primaries: int = 1) -> bytes:
    """Synthesize a still AVIF at arbitrary depth/subsampling/matrix/
    range — the fixture generator for the >8-bit SDR decode pinning
    tests (the product encode surface stays 8-bit, matching the
    reference's 8-bit BGRA intake, avif.cpp:614). Planes are uint16
    for depth>8. Lossless by default so the decoded planes equal the
    inputs and the test pins only the YUV->RGB conversion."""
    import ctypes as c
    lib = _lib()
    h, w = y.shape
    if u is None:
        fmt = 2
    elif u.shape == (h, w):
        fmt = 1
    elif u.shape == ((h + 1) // 2, (w + 1) // 2):
        fmt = 0
    elif u.shape == (h, (w + 1) // 2):
        fmt = 4
    else:
        raise ValueError(f"chroma shape {u.shape} vs luma {(h, w)}")
    dt = np.uint16 if depth > 8 else np.uint8
    parts = [np.ascontiguousarray(p, dt)
             for p in ((y, u, v) if u is not None else (y,))]
    planes = np.concatenate([p.reshape(-1) for p in parts]).view(np.uint8)

    def run(buf, run_fmt, run_matrix, run_range):
        u8p = c.POINTER(c.c_uint8)
        i64p = c.POINTER(c.c_int64)
        durs = np.ones(1, np.int64)
        cap = buf.size * 2 + (1 << 20)
        out = np.empty(cap, np.uint8)
        sizes = np.zeros(16, np.int64)
        n = lib.lp_av1_encode_hbd(
            buf.ctypes.data_as(u8p), w, h, run_fmt, depth, run_matrix,
            1 if run_range else 0, 1, _TIMESCALE,
            durs.ctypes.data_as(i64p), 0, cpu_used,
            1 if lossless else 0, 1, 1, out.ctypes.data_as(u8p), cap,
            sizes.ctypes.data_as(i64p), len(sizes))
        if n < 0:
            raise DecodingFailedError(f"AVIF hbd encoder failed ({n})")
        return b"".join(out[sum(int(s) for s in sizes[:i]):
                            sum(int(s) for s in sizes[:i + 1])].tobytes()
                        for i in range(n))
    color_pkt = run(planes, fmt, matrix, full_range)
    seq, color_obus = _split_obus(color_pkt)
    av1c_color = _build_av1c(seq, fmt, depth)
    alpha_obus = av1c_alpha = None
    if alpha is not None:
        abuf = np.ascontiguousarray(alpha, dt).reshape(-1).view(np.uint8)
        aseq, alpha_obus = _split_obus(run(abuf, 2, -1, True))
        av1c_alpha = _build_av1c(aseq, 2, depth)
    return mux_still(w, h, fmt, color_obus, av1c_color, alpha_obus,
                     av1c_alpha, depth=depth,
                     cicp=(primaries, 13, matrix, full_range))


# ---------------------------------------------------------------------------
# OBU utilities
# ---------------------------------------------------------------------------

def _iter_obus(data: bytes):
    i, n = 0, len(data)
    while i < n:
        hdr = data[i]
        typ = (hdr >> 3) & 0x0F
        j = i + 1
        if hdr & 0x04:  # extension header
            j += 1
        if hdr & 0x02:  # has_size_field (libaom always sets it)
            sz = 0
            shift = 0
            while j < n:
                bb = data[j]
                j += 1
                sz |= (bb & 0x7F) << shift
                shift += 7
                if not (bb & 0x80):
                    break
        else:
            sz = n - j
        yield typ, data[i:j + sz]
        i = j + sz


def _split_obus(pkt: bytes) -> Tuple[bytes, bytes]:
    """(sequence-header OBU, sample payload without temporal
    delimiters) — AVIF samples omit TD OBUs; the sequence header goes
    into av1C configOBUs like libavif does."""
    seq = b""
    keep = []
    for typ, raw in _iter_obus(pkt):
        if typ == 2:          # temporal delimiter
            continue
        if typ == 1:          # sequence header
            seq = raw
        keep.append(raw)
    return seq, b"".join(keep)


def _build_av1c(seq_obu: bytes, fmt: int, depth: int = 8) -> bytes:
    """av1C payload: marker/version, profile/level from the sequence
    header, layout flags from the requested format, configOBUs = the
    sequence header itself (what dav1d actually reads)."""
    profile = 0
    level = 31  # "maximum parameters" when not cheaply parseable
    if seq_obu:
        # payload starts after the 1-byte header (+leb128 size)
        body_off = 1
        if len(seq_obu) > 1 and seq_obu[0] & 0x02:
            while seq_obu[body_off] & 0x80:
                body_off += 1
            body_off += 1
        if len(seq_obu) > body_off:
            first = seq_obu[body_off]
            profile = (first >> 5) & 0x07
            reduced = (first >> 3) & 1
            if reduced:
                level = ((first & 0x07) << 2) | (seq_obu[body_off + 1] >> 6)
    mono = 1 if fmt == 2 else 0
    cx = 1 if fmt in (0, 2, 4) else 0
    cy = 1 if fmt in (0, 2) else 0
    highbd = 1 if depth > 8 else 0
    twelve = 1 if depth == 12 else 0
    b0 = 0x81  # marker | version 1
    b1 = ((profile & 0x7) << 5) | (level & 0x1F)
    b2 = (0 << 7) | (highbd << 6) | (twelve << 5) | (mono << 4) \
        | (cx << 3) | (cy << 2) | 0
    b3 = 0
    return bytes([b0, b1, b2, b3]) + seq_obu


# ---------------------------------------------------------------------------
# box helpers
# ---------------------------------------------------------------------------

def _box(typ: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", len(payload) + 8) + typ + payload


def _full(typ: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return _box(typ, struct.pack(">I", (version << 24) | flags) + payload)


def _nclx(fmt: int, cicp=None) -> bytes:
    if cicp is not None:  # (primaries, trc, matrix, full_range)
        p, t, m, full = cicp
        return b"nclx" + struct.pack(">HHHB", p, t, m,
                                     0x80 if full else 0)
    if fmt == 3:
        return b"nclx" + struct.pack(">HHHB", 1, 13, 0, 0x80)  # identity
    if fmt == 2:
        # monochrome planes are encoded full range (alpha semantics)
        return b"nclx" + struct.pack(">HHHB", 1, 13, 6, 0x80)
    return b"nclx" + struct.pack(">HHHB", 1, 13, 6, 0)         # BT.601


_AUXC_ALPHA = b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha\x00"


def _meta_box(w: int, h: int, color_len: int, alpha_len: int,
              fmt: int, icc: Optional[bytes], av1c_color: bytes,
              av1c_alpha: Optional[bytes], mdat_payload_offset: int,
              depth: int = 8, cicp=None) -> bytes:
    """The still-image meta box; iloc offsets are absolute, so the
    caller builds this twice (sizes are offset-independent)."""
    hdlr = _full(b"hdlr", 0, 0,
                 struct.pack(">I", 0) + b"pict" + b"\0" * 12 + b"\0")
    pitm = _full(b"pitm", 0, 0, struct.pack(">H", 1))
    items = [(1, mdat_payload_offset, color_len)]
    if alpha_len:
        items.append((2, mdat_payload_offset + color_len, alpha_len))
    iloc_body = bytes([0x44, 0x00]) + struct.pack(">H", len(items))
    for (iid, off, ln) in items:
        iloc_body += struct.pack(">HHHII", iid, 0, 1, off, ln)
    iloc = _full(b"iloc", 0, 0, iloc_body)
    infes = _full(b"infe", 2, 0,
                  struct.pack(">HH", 1, 0) + b"av01" + b"Color\0")
    if alpha_len:
        infes += _full(b"infe", 2, 0,
                       struct.pack(">HH", 2, 0) + b"av01" + b"Alpha\0")
    iinf = _full(b"iinf", 0, 0,
                 struct.pack(">H", 2 if alpha_len else 1) + infes)
    iref = b""
    if alpha_len:
        iref = _full(b"iref", 0, 0,
                     _box(b"auxl", struct.pack(">HHH", 2, 1, 1)))
    # ipco: 1 ispe, 2 pixi(color), 3 av1C(color), 4 colr [5 icc]
    #       then alpha: pixi(1ch), av1C, auxC
    nch = 1 if fmt == 2 else 3
    props = [
        _full(b"ispe", 0, 0, struct.pack(">II", w, h)),
        _full(b"pixi", 0, 0, bytes([nch] + [depth] * nch)),
        _box(b"av1C", av1c_color),
        _box(b"colr", _nclx(fmt, cicp)),
    ]
    color_assoc = [(0x80 | 1), (0x00 | 2), (0x80 | 3), (0x00 | 4)]
    if icc:
        props.append(_box(b"colr", b"prof" + icc))
        color_assoc.append(0x00 | len(props))
    alpha_assoc = []
    if alpha_len:
        props.append(_full(b"pixi", 0, 0, bytes([1, depth])))
        alpha_assoc.append(0x00 | len(props))
        props.append(_box(b"av1C", av1c_alpha))
        alpha_assoc.append(0x80 | len(props))
        props.append(_full(b"auxC", 0, 0, _AUXC_ALPHA))
        alpha_assoc.append(0x80 | len(props))
        alpha_assoc.insert(0, 0x80 | 1)  # ispe (shared)
    ipco = _box(b"ipco", b"".join(props))
    ipma_body = struct.pack(">I", 2 if alpha_len else 1)
    ipma_body += struct.pack(">HB", 1, len(color_assoc)) \
        + bytes(color_assoc)
    if alpha_len:
        ipma_body += struct.pack(">HB", 2, len(alpha_assoc)) \
            + bytes(alpha_assoc)
    ipma = _full(b"ipma", 0, 0, ipma_body)
    iprp = _box(b"iprp", ipco + ipma)
    return _full(b"meta", 0, 0, hdlr + pitm + iloc + iinf + iref + iprp)


def mux_still(w: int, h: int, fmt: int, color_obus: bytes,
              av1c_color: bytes, alpha_obus: Optional[bytes] = None,
              av1c_alpha: Optional[bytes] = None,
              icc: Optional[bytes] = None, depth: int = 8,
              cicp=None) -> bytes:
    ftyp = _box(b"ftyp", b"avif" + struct.pack(">I", 0)
                + b"avifmif1miaf")
    alpha_len = len(alpha_obus) if alpha_obus else 0
    meta = _meta_box(w, h, len(color_obus), alpha_len, fmt, icc,
                     av1c_color, av1c_alpha, 0, depth, cicp)
    mdat_payload = color_obus + (alpha_obus or b"")
    offset = len(ftyp) + len(meta) + 8
    meta = _meta_box(w, h, len(color_obus), alpha_len, fmt, icc,
                     av1c_color, av1c_alpha, offset, depth, cicp)
    return ftyp + meta + _box(b"mdat", mdat_payload)


# ---------------------------------------------------------------------------
# animated (avis) muxer
# ---------------------------------------------------------------------------

def _av01_sample_entry(w: int, h: int, av1c: bytes, fmt: int) -> bytes:
    vse = (b"\0" * 6 + struct.pack(">H", 1)            # data_ref_index
           + b"\0" * 16
           + struct.pack(">HH", w, h)
           + struct.pack(">II", 0x00480000, 0x00480000)
           + b"\0" * 4
           + struct.pack(">H", 1)                      # frame_count
           + b"\0" * 32                                # compressorname
           + struct.pack(">Hh", 24, -1))
    return _box(b"av01", vse + _box(b"av1C", av1c)
                + _box(b"colr", _nclx(fmt)))


def mux_animation(w: int, h: int, fmt: int, samples: List[bytes],
                  durations_ms: List[int], av1c: bytes, loop_count: int,
                  icc: Optional[bytes] = None,
                  first_frame_meta: bool = True,
                  alpha_samples: Optional[List[bytes]] = None,
                  av1c_alpha: Optional[bytes] = None) -> bytes:
    """avis container: still meta for the first frame (compatibility,
    like libavif) + one pict track, plus an auxv alpha track when
    alpha_samples is given (tref/auxl to the color track — exactly the
    structure libavif writes and av1_raw.parse_tracks reads back).
    loop_count semantics mirror the decoder's parse_loop_count /
    avif.cpp:401-413: mvhd.duration = track_duration * (loop_count + 1),
    infinite (0) writes the unknown-duration sentinel."""
    ftyp = _box(b"ftyp", b"avis" + struct.pack(">I", 0)
                + b"avisavifmif1miafmsf1iso8")
    track_dur = sum(durations_ms)
    if loop_count > 0:
        movie_dur = track_dur * (loop_count + 1)
        if movie_dur >= 0xFFFFFFFF:
            movie_dur = 0xFFFFFFFF
    else:
        movie_dur = 0xFFFFFFFF  # infinite
    n_tracks = 2 if alpha_samples else 1
    mvhd = _full(b"mvhd", 0, 0, struct.pack(
        ">IIII", 0, 0, _TIMESCALE, movie_dur)
        + struct.pack(">IHH", 0x00010000, 0x0100, 0)
        + b"\0" * 8
        + struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                      0x40000000)
        + b"\0" * 24 + struct.pack(">I", n_tracks + 1))

    # stts with run-length compression of equal durations (shared: the
    # alpha track carries the same timing as the color track)
    runs = []
    for d in durations_ms:
        if runs and runs[-1][1] == d:
            runs[-1][0] += 1
        else:
            runs.append([1, d])
    stts = _full(b"stts", 0, 0, struct.pack(">I", len(runs))
                 + b"".join(struct.pack(">II", n, d) for (n, d) in runs))
    stss = _full(b"stss", 0, 0, struct.pack(">II", 1, 1))

    def trak(track_id: int, handler: bytes, tfmt: int, tav1c: bytes,
             tsamples: List[bytes], chunk_offset: int,
             tref: bytes = b"") -> bytes:
        tkhd = _full(b"tkhd", 0, 3, struct.pack(
            ">IIIII", 0, 0, track_id, 0, track_dur)
            + b"\0" * 8 + struct.pack(">HHHH", 0, 0, 0, 0)
            + struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                          0x40000000)
            + struct.pack(">II", w << 16, h << 16))
        mdhd = _full(b"mdhd", 0, 0, struct.pack(
            ">IIIIHH", 0, 0, _TIMESCALE, track_dur, 0x55C4, 0))
        hdlr = _full(b"hdlr", 0, 0,
                     struct.pack(">I", 0) + handler + b"\0" * 12 + b"\0")
        vmhd = _full(b"vmhd", 0, 1, b"\0" * 8)
        dref = _full(b"dref", 0, 0, struct.pack(">I", 1)
                     + _full(b"url ", 0, 1, b""))
        dinf = _box(b"dinf", dref)
        stsd = _full(b"stsd", 0, 0, struct.pack(">I", 1)
                     + _av01_sample_entry(w, h, tav1c, tfmt))
        stsc = _full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1,
                                                len(tsamples), 1))
        stsz = _full(b"stsz", 0, 0, struct.pack(">II", 0, len(tsamples))
                     + b"".join(struct.pack(">I", len(sm))
                                for sm in tsamples))
        stco = _full(b"stco", 0, 0, struct.pack(">II", 1, chunk_offset))
        stbl = _box(b"stbl", stsd + stts + stsc + stsz + stss + stco)
        minf = _box(b"minf", vmhd + dinf + stbl)
        mdia = _box(b"mdia", mdhd + hdlr + minf)
        return _box(b"trak", tkhd + tref + mdia)

    color_len = sum(len(s) for s in samples)

    def assemble(chunk_offset: int, meta: bytes) -> bytes:
        traks = trak(1, b"pict", fmt, av1c, samples, chunk_offset)
        if alpha_samples:
            tref = _box(b"tref", _box(b"auxl", struct.pack(">I", 1)))
            traks += trak(2, b"auxv", 2, av1c_alpha or b"",
                          alpha_samples, chunk_offset + color_len,
                          tref=tref)
        moov = _box(b"moov", mvhd + traks)
        return ftyp + meta + moov

    meta = b""
    if first_frame_meta:
        meta = _meta_box(w, h, len(samples[0]), 0, fmt, icc, av1c,
                         None, 0)
    head = assemble(0, meta)
    mdat_payload = b"".join(samples) + b"".join(alpha_samples or [])
    chunk_offset = len(head) + 8
    if first_frame_meta:
        meta = _meta_box(w, h, len(samples[0]), 0, fmt, icc, av1c,
                         None, chunk_offset)
    head = assemble(chunk_offset, meta)
    return head + _box(b"mdat", mdat_payload)


# ---------------------------------------------------------------------------
# top-level encode
# ---------------------------------------------------------------------------

def _quality_to_crf(quality: int) -> int:
    """libavif's quality->qp mapping (avifQualityToQuantizer)."""
    quality = min(max(quality, 0), 100)
    return ((100 - quality) * 63 + 50) // 100


def _prep_planes(frame_rgba: np.ndarray, lossless: bool):
    """frame in R,G,B(,A) channel order (or 2-D gray) ->
    (fmt, planes bytes, alpha plane or None, w, h)."""
    import torch

    from ..ops import color as C
    h, w = frame_rgba.shape[:2]
    nch = 1 if frame_rgba.ndim == 2 else frame_rgba.shape[2]
    alpha = None
    if nch == 1:
        gray = frame_rgba if frame_rgba.ndim == 2 else frame_rgba[:, :, 0]
        return 2, np.ascontiguousarray(gray, np.uint8).ravel(), None, w, h
    if nch == 4:
        alpha = np.ascontiguousarray(frame_rgba[:, :, 3], np.uint8)
    if lossless:
        # AV1 identity matrix: planes are G, B, R
        g = frame_rgba[:, :, 1]
        b = frame_rgba[:, :, 2]
        r = frame_rgba[:, :, 0]
        planes = np.concatenate([np.ascontiguousarray(p, np.uint8).ravel()
                                 for p in (g, b, r)])
        return 3, planes, alpha, w, h
    y, u, v = (p.numpy() for p in C.bgr_to_yuv(torch.from_numpy(
        np.ascontiguousarray(frame_rgba[:, :, 2::-1]))))
    planes = np.concatenate([y.ravel(), u.ravel(), v.ravel()])
    return 0, planes, alpha, w, h


def encode(frames_rgba: List[np.ndarray], durations_ms: List[float],
           quality: int = 60, speed: int = 6, loop_count: int = 0,
           icc: Optional[bytes] = None) -> bytes:
    """Encode one still (single frame) or an animation to AVIF bytes.
    Frames are R,G,B(,A) channel order (the PIL convention the
    AvifEncoder buffers). quality 0..100 (>=100 = true lossless),
    speed 0..10 (aom cpu-used, clamped to 8 like ffmpeg's good-quality
    mode)."""
    frames_bgra = frames_rgba
    lossless = quality >= 100
    crf = _quality_to_crf(quality)
    cpu = min(max(speed, 0), 8)
    fmt, planes0, alpha0, w, h = _prep_planes(frames_bgra[0], lossless)
    if len(frames_bgra) == 1:
        pkts = _encode_frames(planes0, w, h, fmt, 1, [1], crf, cpu,
                              lossless, 1)
        seq, sample = _split_obus(b"".join(pkts))
        av1c = _build_av1c(seq, fmt)
        alpha_obus = av1c_a = None
        if alpha0 is not None:
            apkts = _encode_frames(alpha0.ravel(), w, h, 2, 1, [1],
                                   crf, cpu, lossless, 1)
            aseq, alpha_obus = _split_obus(b"".join(apkts))
            av1c_a = _build_av1c(aseq, 2)
        return mux_still(w, h, fmt, sample, av1c, alpha_obus, av1c_a,
                         icc)
    # animation: all frames share geometry/format; alpha planes (if any)
    # encode as a second monochrome AV1 stream in an auxv track
    frame_planes = [planes0]
    alpha_planes = [alpha0] if alpha0 is not None else None
    for f in frames_bgra[1:]:
        fm, pl, al, ww, hh = _prep_planes(f, lossless)
        if fm != fmt or ww != w or hh != h:
            raise DecodingFailedError(
                "AVIF encoder: mixed frame formats in animation")
        if (al is not None) != (alpha_planes is not None):
            raise DecodingFailedError(
                "AVIF encoder: mixed alpha presence in animation")
        if alpha_planes is not None:
            alpha_planes.append(al)
        frame_planes.append(pl)
    durs = [max(int(round(d)), 1) for d in durations_ms]
    pkts = _encode_frames(np.concatenate(frame_planes), w, h, fmt,
                          len(frame_planes), durs, crf, cpu, lossless,
                          0)
    if len(pkts) != len(frame_planes):
        raise DecodingFailedError("AVIF encoder: packet count mismatch")
    seq, first_sample = _split_obus(pkts[0])
    av1c = _build_av1c(seq, fmt)
    samples = [first_sample] + [_split_obus(p)[1] for p in pkts[1:]]
    alpha_samples = av1c_a = None
    if alpha_planes is not None:
        apkts = _encode_frames(
            np.concatenate([a.ravel() for a in alpha_planes]), w, h, 2,
            len(alpha_planes), durs, crf, cpu, lossless, 0)
        if len(apkts) != len(alpha_planes):
            raise DecodingFailedError(
                "AVIF encoder: alpha packet count mismatch")
        aseq, afirst = _split_obus(apkts[0])
        av1c_a = _build_av1c(aseq, 2)
        alpha_samples = [afirst] + [_split_obus(p)[1] for p in apkts[1:]]
    return mux_animation(w, h, fmt, samples, durs, av1c, loop_count,
                         icc, alpha_samples=alpha_samples,
                         av1c_alpha=av1c_a)
