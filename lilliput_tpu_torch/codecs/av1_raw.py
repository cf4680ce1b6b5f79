"""Native-bit-depth AV1 decode for AVIF: the counterpart of
``lilliput_tpu/codecs/av1_raw.py``.

The reference tone-maps dav1d's 10/12-bit output (avif.cpp:88-199), and
PIL's libavif plugin only surfaces 8-bit RGB, so the decode goes under
it: the ISOBMFF walk below extracts the AV1 OBU payloads (still items
through pitm/iloc/iinf, animation samples through the pict track's
stsz/stsc/stco) with the av1C config and the clap/ispe properties, in pure
Python; the ffmpeg shim (``csrc/host/avformat_shim.cpp``, a copy of the
JAX package's, built by ``binding.load_avformat``) decodes them through
libdav1d into full-precision YUV planes (``RawPlanes``), which the caller
converts: on the host for SDR (codecs/yuv_rgb.py), on its device for the
HDR tone map (ops/color.py). Where ffmpeg's headers are absent the
decode raises ``errors.HostLibraryMissingError``; the walk needs no
library.
"""

from __future__ import annotations

import ctypes
import dataclasses
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import binding
from ..errors import InvalidImageError

_u8p = ctypes.POINTER(ctypes.c_uint8)


def _iter_boxes(buf: bytes, start: int, end: int):
    pos = start
    while pos + 8 <= end:
        size = int.from_bytes(buf[pos:pos + 4], "big")
        typ = buf[pos + 4:pos + 8]
        hdr = 8
        if size == 1:
            if pos + 16 > end:
                return
            size = int.from_bytes(buf[pos + 8:pos + 16], "big")
            hdr = 16
        elif size == 0:
            size = end - pos
        if size < hdr or pos + size > end:
            return
        yield typ, pos + hdr, pos + size
        pos += size


def _child(buf, start, end, typ):
    for t, s, e in _iter_boxes(buf, start, end):
        if t == typ:
            return s, e
    return None


@dataclasses.dataclass
class StillItems:
    color_data: bytes
    color_av1c: bytes
    alpha_data: Optional[bytes]
    alpha_av1c: Optional[bytes]
    clap: Optional[Tuple[int, int, int, int, int, int, int, int]]
    # the PRIMARY item's colr payload when of nclx type ("nclx" + 7 bytes);
    # ipma-scoped so an alpha item's colr can never be misattributed
    nclx: Optional[bytes] = None
    # the PRIMARY item's ICC profile (colr of prof/rICC type), ipma-scoped
    icc: bytes = b""
    # the PRIMARY item's ispe (coded width, height), or None
    ispe: Optional[Tuple[int, int]] = None
    # Exif item payload (TIFF bytes, the 4-byte tiff-offset header
    # stripped), or b""
    exif: bytes = b""


def parse_still_items(buf: bytes) -> Optional[StillItems]:
    """Primary (color) + auxiliary alpha item payloads and properties."""
    meta = _child(buf, 0, len(buf), b"meta")
    if not meta:
        return None
    ms, me = meta[0] + 4, meta[1]  # meta is a fullbox

    pitm = _child(buf, ms, me, b"pitm")
    if not pitm:
        return None
    pv = buf[pitm[0]]
    primary_id = (int.from_bytes(buf[pitm[0] + 4:pitm[0] + 6], "big") if pv == 0
                  else int.from_bytes(buf[pitm[0] + 4:pitm[0] + 8], "big"))

    # iinf: item types
    item_types: Dict[int, bytes] = {}
    iinf = _child(buf, ms, me, b"iinf")
    if iinf:
        iv = buf[iinf[0]]
        pos = iinf[0] + 4 + (2 if iv == 0 else 4)
        for t, s, e in _iter_boxes(buf, pos, iinf[1]):
            if t != b"infe":
                continue
            ev = buf[s]
            if ev >= 3:
                iid = int.from_bytes(buf[s + 4:s + 8], "big")
                ityp = buf[s + 10:s + 14]
            elif ev == 2:
                iid = int.from_bytes(buf[s + 4:s + 6], "big")
                ityp = buf[s + 8:s + 12]
            else:
                # infe v0/1 has NO item_type field (pre-HEIF layout:
                # item_ID + protection_index + item_name string) — the
                # v2 offsets would read the first 4 item_name bytes as a
                # type. HEIF/AVIF items require v>=2; skip these.
                continue
            item_types[iid] = ityp

    # iloc: item extents
    extents: Dict[int, List[Tuple[int, int]]] = {}
    iloc = _child(buf, ms, me, b"iloc")
    if not iloc:
        return None
    p = iloc[0]
    version = buf[p]
    p += 4
    offset_size = buf[p] >> 4
    length_size = buf[p] & 0xF
    base_offset_size = buf[p + 1] >> 4
    index_size = (buf[p + 1] & 0xF) if version in (1, 2) else 0
    p += 2
    if version < 2:
        item_count = int.from_bytes(buf[p:p + 2], "big")
        p += 2
    else:
        item_count = int.from_bytes(buf[p:p + 4], "big")
        p += 4

    def rd(n):
        nonlocal p
        v = int.from_bytes(buf[p:p + n], "big") if n else 0
        p += n
        return v

    for _ in range(item_count):
        iid = rd(2 if version < 2 else 4)
        cm = 0
        if version in (1, 2):
            cm = rd(2) & 0xF
        rd(2)  # data_reference_index
        base = rd(base_offset_size)
        ecount = rd(2)
        exts = []
        for _ in range(ecount):
            rd(index_size)
            off = rd(offset_size)
            ln = rd(length_size)
            exts.append((base + off, ln))
        if cm == 0:
            extents[iid] = exts

    # iref: find the alpha auxiliary item pointing at the primary
    alpha_id = None
    iref = _child(buf, ms, me, b"iref")
    if iref:
        rv = buf[iref[0]]
        for t, s, e in _iter_boxes(buf, iref[0] + 4, iref[1]):
            if t != b"auxl":
                continue
            n = 4 if rv else 2
            from_id = int.from_bytes(buf[s:s + n], "big")
            cnt = int.from_bytes(buf[s + n:s + n + 2], "big")
            tos = [int.from_bytes(buf[s + n + 2 + i * n:s + n + 2 + (i + 1) * n],
                                  "big") for i in range(cnt)]
            if primary_id in tos:
                alpha_id = from_id

    # iprp/ipco + ipma: per-item properties (av1C, clap)
    props: List[Tuple[bytes, bytes]] = []
    assoc: Dict[int, List[int]] = {}
    iprp = _child(buf, ms, me, b"iprp")
    if iprp:
        ipco = _child(buf, iprp[0], iprp[1], b"ipco")
        if ipco:
            for t, s, e in _iter_boxes(buf, ipco[0], ipco[1]):
                props.append((t, buf[s:e]))
        ipma = _child(buf, iprp[0], iprp[1], b"ipma")
        if ipma:
            av = buf[ipma[0]]
            aflags = int.from_bytes(buf[ipma[0] + 1:ipma[0] + 4], "big")
            q = ipma[0] + 4
            ecount = int.from_bytes(buf[q:q + 4], "big")
            q += 4
            for _ in range(ecount):
                iid = int.from_bytes(buf[q:q + (2 if av < 1 else 4)], "big")
                q += 2 if av < 1 else 4
                acount = buf[q]
                q += 1
                idxs = []
                for _ in range(acount):
                    if aflags & 1:
                        idxs.append(int.from_bytes(buf[q:q + 2], "big") & 0x7FFF)
                        q += 2
                    else:
                        idxs.append(buf[q] & 0x7F)
                        q += 1
                assoc[iid] = idxs

    def prop_of(iid: int, typ: bytes) -> Optional[bytes]:
        for k in assoc.get(iid, []):
            if 1 <= k <= len(props) and props[k - 1][0] == typ:
                return props[k - 1][1]
        return None

    def item_data(iid: Optional[int]) -> Optional[bytes]:
        if iid is None or iid not in extents:
            return None
        return b"".join(buf[o:o + ln] for o, ln in extents[iid])

    color = item_data(primary_id)
    if color is None:
        return None
    clap_raw = prop_of(primary_id, b"clap")
    clap = struct.unpack(">8i", clap_raw[:32]) if clap_raw and len(clap_raw) >= 32 else None
    # an item may carry BOTH colr/prof (ICC) and colr/nclx — keep both
    nclx = None
    icc = b""
    for k in assoc.get(primary_id, []):
        if 1 <= k <= len(props) and props[k - 1][0] == b"colr":
            pl = props[k - 1][1]
            if pl[:4] == b"nclx" and len(pl) >= 11 and nclx is None:
                nclx = pl
            elif pl[:4] in (b"prof", b"rICC") and not icc:
                icc = pl[4:]
    ispe_raw = prop_of(primary_id, b"ispe")
    ispe = (tuple(struct.unpack(">II", ispe_raw[4:12]))
            if ispe_raw and len(ispe_raw) >= 12 else None)
    # Exif item: iinf type "Exif"; payload = u32 tiff-header offset + data
    exif = b""
    for iid, ityp in item_types.items():
        if ityp == b"Exif":
            raw = item_data(iid)
            if raw and len(raw) >= 4:
                off = int.from_bytes(raw[:4], "big")
                if 0 <= off <= len(raw) - 4:
                    exif = raw[4 + off:]
            break
    return StillItems(
        color_data=color,
        color_av1c=prop_of(primary_id, b"av1C") or b"",
        alpha_data=item_data(alpha_id),
        alpha_av1c=prop_of(alpha_id, b"av1C") if alpha_id else None,
        clap=clap,
        nclx=nclx,
        icc=icc,
        ispe=ispe,
        exif=exif)


@dataclasses.dataclass
class Track:
    samples: List[bytes]
    av1c: bytes
    width: int = 0
    height: int = 0
    icc: bytes = b""
    is_alpha: bool = False


def _parse_one_track(buf: bytes, s: int, e: int) -> Optional[Track]:
    mdia = _child(buf, s, e, b"mdia")
    if not mdia:
        return None
    hdlr = _child(buf, *mdia, b"hdlr")
    # auxv = auxiliary video (the alpha track's handler type)
    if hdlr and buf[hdlr[0] + 8:hdlr[0] + 12] not in (b"pict", b"vide",
                                                      b"auxv"):
        return None
    minf = _child(buf, *mdia, b"minf")
    if not minf:
        return None
    stbl = _child(buf, *minf, b"stbl")
    if not stbl:
        return None
    stsd = _child(buf, *stbl, b"stsd")
    av1c = b""
    width = height = 0
    icc = b""
    if stsd:
        # fullbox + entry_count, first entry is the sample description
        for t2, s2, e2 in _iter_boxes(buf, stsd[0] + 8, stsd[1]):
            if t2 == b"av01":
                # visual sample entry header = 78 bytes, then boxes
                width = int.from_bytes(buf[s2 + 24:s2 + 26], "big")
                height = int.from_bytes(buf[s2 + 26:s2 + 28], "big")
                c = _child(buf, s2 + 78, e2, b"av1C")
                if c:
                    av1c = buf[c[0]:c[1]]
                for t3, s3, e3 in _iter_boxes(buf, s2 + 78, e2):
                    if (t3 == b"colr"
                            and buf[s3:s3 + 4] in (b"prof", b"rICC")):
                        icc = buf[s3 + 4:e3]
            break
    if not av1c:
        return None
    stsz = _child(buf, *stbl, b"stsz")
    stco = _child(buf, *stbl, b"stco")
    co64 = _child(buf, *stbl, b"co64")
    stsc = _child(buf, *stbl, b"stsc")
    if not stsz or not stsc or not (stco or co64):
        return None
    p = stsz[0] + 4
    sample_size, count = struct.unpack(">II", buf[p:p + 8])
    sizes = ([sample_size] * count if sample_size
             else list(struct.unpack(f">{count}I", buf[p + 8:p + 8 + 4 * count])))
    if co64:
        p = co64[0] + 4
        (n,) = struct.unpack(">I", buf[p:p + 4])
        chunk_offsets = list(struct.unpack(f">{n}Q", buf[p + 4:p + 4 + 8 * n]))
    else:
        p = stco[0] + 4
        (n,) = struct.unpack(">I", buf[p:p + 4])
        chunk_offsets = list(struct.unpack(f">{n}I", buf[p + 4:p + 4 + 4 * n]))
    p = stsc[0] + 4
    (n,) = struct.unpack(">I", buf[p:p + 4])
    stsc_entries = [struct.unpack(">III", buf[p + 4 + i * 12:p + 16 + i * 12])
                    for i in range(n)]
    # expand sample->chunk map
    samples: List[bytes] = []
    si = 0
    for ci in range(len(chunk_offsets)):
        spc = 1
        for first, per, _desc in stsc_entries:
            if ci + 1 >= first:
                spc = per
        off = chunk_offsets[ci]
        for _ in range(spc):
            if si >= len(sizes):
                break
            if off + sizes[si] > len(buf) or sizes[si] <= 0:
                # truncated/hostile stco/stsz: an out-of-range slice
                # silently yields b"", which the stream shim treats as a
                # FLUSH, EOFing the decoder mid-animation — fail the
                # parse here so the caller takes the typed-error path
                raise InvalidImageError("avis sample outside buffer")
            samples.append(buf[off:off + sizes[si]])
            off += sizes[si]
            si += 1
    if not samples:
        return None
    # an alpha track references the color track via tref/auxl
    tref = _child(buf, s, e, b"tref")
    is_alpha = bool(tref and _child(buf, *tref, b"auxl"))
    return Track(samples=samples, av1c=av1c, width=width, height=height,
                 icc=icc, is_alpha=is_alpha)


def parse_tracks(buf: bytes) -> Optional[Tuple[Track, Optional[Track]]]:
    """(color track, alpha track or None) from an avis animation."""
    moov = _child(buf, 0, len(buf), b"moov")
    if not moov:
        return None
    color = alpha = None
    for t, s, e in _iter_boxes(buf, *moov):
        if t != b"trak":
            continue
        tr = _parse_one_track(buf, s, e)
        if tr is None:
            continue
        if tr.is_alpha and alpha is None:
            alpha = tr
        elif not tr.is_alpha and color is None:
            color = tr
    if color is None:
        return None
    return color, alpha


def parse_track_samples(buf: bytes) -> Optional[Tuple[List[bytes], bytes]]:
    """(per-frame OBU payloads, av1C) from the avis pict COLOR track."""
    tracks = parse_tracks(buf)
    if tracks is None:
        return None
    return tracks[0].samples, tracks[0].av1c


def parse_loop_count(buf: bytes) -> int:
    """Repetitions from mvhd vs track duration (libavif writes
    mvhd.duration = track_duration * (loops + 1); infinite/unknown -> 0,
    parity with avif.cpp:401-413)."""
    moov = _child(buf, 0, len(buf), b"moov")
    if not moov:
        return 0
    mvhd = _child(buf, *moov, b"mvhd")
    if not mvhd:
        return 0
    v = buf[mvhd[0]]
    if v == 1:
        mts = int.from_bytes(buf[mvhd[0] + 20:mvhd[0] + 24], "big")
        mdur = int.from_bytes(buf[mvhd[0] + 24:mvhd[0] + 32], "big")
        unknown = (1 << 64) - 1
    else:
        mts = int.from_bytes(buf[mvhd[0] + 12:mvhd[0] + 16], "big")
        mdur = int.from_bytes(buf[mvhd[0] + 16:mvhd[0] + 20], "big")
        unknown = (1 << 32) - 1
    if not mts or not mdur or mdur == unknown:
        return 0  # unknown movie duration -> infinite -> 0
    for t, s, e in _iter_boxes(buf, *moov):
        if t != b"trak":
            continue
        mdia = _child(buf, s, e, b"mdia")
        if not mdia:
            continue
        mdhd = _child(buf, *mdia, b"mdhd")
        if not mdhd:
            continue
        hv = buf[mdhd[0]]
        if hv == 1:
            ts = int.from_bytes(buf[mdhd[0] + 20:mdhd[0] + 24], "big")
            dur = int.from_bytes(buf[mdhd[0] + 24:mdhd[0] + 32], "big")
        else:
            ts = int.from_bytes(buf[mdhd[0] + 12:mdhd[0] + 16], "big")
            dur = int.from_bytes(buf[mdhd[0] + 16:mdhd[0] + 20], "big")
        if not ts or not dur:
            continue
        track_s = dur / ts
        movie_s = mdur / mts
        if track_s > 0 and 1.5 < movie_s / track_s < (1 << 30):
            return max(int(round(movie_s / track_s)) - 1, 0)
    return 0


@dataclasses.dataclass
class RawPlanes:
    y: np.ndarray            # (h, w) u8 or u16
    u: Optional[np.ndarray]  # (ch, cw) or None (monochrome)
    v: Optional[np.ndarray]
    width: int
    height: int
    depth: int
    full_range: bool
    matrix: int              # AVCOL_SPC_*
    primaries: int           # AVCOL_PRI_*
    trc: int                 # AVCOL_TRC_*


def _av1c_extradata(av1c: bytes) -> bytes:
    """lavc's AV1 decoder takes the av1C payload verbatim as extradata."""
    return av1c


class Av1StreamDecoder:
    """Stateful AV1 sample-stream decoder (lp_av_stream_* shim): AVIF
    animation samples are inter-coded, so frames must decode in order
    against live decoder state — the stateless decode_av1_planes below
    can only handle keyframes (stills)."""

    def __init__(self, av1c: bytes):
        self._lib = binding.load_avformat()
        extradata = np.frombuffer(av1c, np.uint8) if av1c else None
        self._h = self._lib.lp_av_stream_open(
            b"libdav1d",
            extradata.ctypes.data_as(_u8p)
            if extradata is not None and extradata.size else None,
            extradata.size if extradata is not None else 0)
        if not self._h:
            self._h = self._lib.lp_av_stream_open(
                b"av1",
                extradata.ctypes.data_as(_u8p)
                if extradata is not None and extradata.size else None,
                extradata.size if extradata is not None else 0)
        if not self._h:
            raise RuntimeError("no AV1 decoder available")

    def _collect(self, info) -> Optional[RawPlanes]:
        w, hh = info[0], info[1]
        planes, cw, ch = info[5], info[6], info[7]
        depth, prim, trc, bps = info[8], info[9], info[10], info[11]
        dt = np.uint16 if bps == 2 else np.uint8

        def plane(idx, pw, ph):
            out = np.empty((ph, pw), dt)
            rc = self._lib.lp_av_stream_plane(
                self._h, idx, out.ctypes.data_as(_u8p), pw * bps, ph)
            return out if rc == 0 else None

        y = plane(0, w, hh)
        if y is None:
            return None
        u = plane(1, cw, ch) if planes >= 3 else None
        v = plane(2, cw, ch) if planes >= 3 else None
        return RawPlanes(y=y, u=u, v=v, width=w, height=hh, depth=depth,
                         full_range=(info[4] == 2), matrix=info[3],
                         primaries=prim, trc=trc)

    def feed(self, sample: Optional[bytes]) -> List[RawPlanes]:
        """Feed one coded sample (None = flush) and return the frames
        that became ready (0 or more). Raises on decode failure."""
        info = (ctypes.c_int32 * 12)()
        out: List[RawPlanes] = []
        if sample is not None:
            pkt = np.frombuffer(sample, np.uint8)
            rc = self._lib.lp_av_stream_next(
                self._h, pkt.ctypes.data_as(_u8p), pkt.size, info)
            if rc == 0:
                rp = self._collect(info)
                if rp is None:
                    raise RuntimeError("plane read failed")
                out.append(rp)
            elif rc != 1:
                raise RuntimeError(f"AV1 stream decode failed ({rc})")
            return out
        while True:  # flush: drain decoder delay
            rc = self._lib.lp_av_stream_next(self._h, None, 0, info)
            if rc == 0:
                rp = self._collect(info)
                if rp is None:
                    raise RuntimeError("plane read failed")
                out.append(rp)
            elif rc in (1, 2):
                return out
            else:
                raise RuntimeError(f"AV1 stream flush failed ({rc})")

    def decode_all(self, samples: List[bytes]) -> List[RawPlanes]:
        """Decode every sample; raises on any decode failure (callers
        treat a short animation as corrupt, not truncated-silently)."""
        out: List[RawPlanes] = []
        for smp in samples:
            out.extend(self.feed(smp))
        if len(out) < len(samples):
            out.extend(self.feed(None))
        if len(out) != len(samples):
            raise RuntimeError(
                f"AV1 stream returned {len(out)}/{len(samples)} frames")
        return out

    def close(self) -> None:
        if self._h:
            self._lib.lp_av_stream_free(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover — belt and braces
        try:
            self.close()
        except Exception:
            pass


def decode_av1_planes(av1c: bytes, obus: bytes) -> Optional[RawPlanes]:
    """The stateless decode of one keyframe (a still item); None when no
    AV1 decoder takes it."""
    lib = binding.load_avformat()
    info = (ctypes.c_int32 * 12)()
    extradata = np.frombuffer(_av1c_extradata(av1c), np.uint8) if av1c else None
    pkt = np.frombuffer(obus, np.uint8)
    h = lib.lp_av_raw_frame_decode(
        b"libdav1d", 0,
        extradata.ctypes.data_as(_u8p) if extradata is not None and extradata.size else None,
        extradata.size if extradata is not None else 0,
        pkt.ctypes.data_as(_u8p), pkt.size, info)
    if not h:
        # fall back to any available AV1 decoder by name
        h = lib.lp_av_raw_frame_decode(
            b"av1", 0,
            extradata.ctypes.data_as(_u8p) if extradata is not None and extradata.size else None,
            extradata.size if extradata is not None else 0,
            pkt.ctypes.data_as(_u8p), pkt.size, info)
    if not h:
        return None
    try:
        w, hh = info[0], info[1]
        planes, cw, ch = info[5], info[6], info[7]
        depth, prim, trc, bps = info[8], info[9], info[10], info[11]
        dt = np.uint16 if bps == 2 else np.uint8

        def plane(idx, pw, ph):
            out = np.empty((ph, pw), dt)
            rc = lib.lp_av_raw_frame_plane(
                h, idx, out.ctypes.data_as(_u8p), pw * bps, ph)
            return out if rc == 0 else None

        y = plane(0, w, hh)
        u = plane(1, cw, ch) if planes >= 3 else None
        v = plane(2, cw, ch) if planes >= 3 else None
        if y is None:
            return None
        return RawPlanes(y=y, u=u, v=v, width=w, height=hh, depth=depth,
                         full_range=(info[4] == 2), matrix=info[3],
                         primaries=prim, trc=trc)
    finally:
        lib.lp_av_raw_frame_free(h)
