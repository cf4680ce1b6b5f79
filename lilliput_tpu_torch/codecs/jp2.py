"""JPEG 2000 decoder (JP2 container + J2K codestream), ISO/IEC 15444-1:
the counterpart of ``lilliput_tpu/codecs/jp2.py``, with the same
profile, geometry, errors and pixels (the reference decodes .jp2 through
OpenJPEG inside OpenCV).

Where each stage runs:

* the host: the box walk, the marker segments (SIZ/COD/COC/QCD/QCC/RGN/
  SOT/PPM/PPT), Tier-2 packet parsing (tag trees, bit-stuffed headers,
  every progression order the JAX package reads) in Python, and the
  EBCOT Tier-1 codeblock decode in C++ (``codecs/jp2_t1.py`` ->
  ``csrc/host/jp2_t1.cpp``) on a thread pool over every tile's
  codeblocks. The codeblocks are pasted into one int32 buffer (page-
  locked when the device is CUDA) that crosses to the decoder's device in
  one copy;
* the decoder's device, as torch ops (no kernel): the ROI shift,
  dequantization, the inverse 5/3 or 9/7 wavelet (``ops/wavelet.py``),
  the rint, tile placement, the inverse RCT/ICT and all of
  ``Jp2Decoder.decode_to``'s conversions (component replication, sYCC,
  level shift, clip, channel stack). The tile-components whose
  resolution rects agree in sizes and origin parities (the components of
  a tile, and equal tiles of a grid) are synthesized as one stack, in
  one call per wavelet level; stacking changes no value.

The JAX package's docstring calls that tail device-friendly but runs it
in host numpy; here it runs on the device the decoder was given. Every
value equals the JAX package's: the wavelet is bit-exact to its numpy
form (``ops/wavelet.py``), the dequantization multiplies by the same
float64 step.
"""

from __future__ import annotations

import math
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..errors import DecodingFailedError, InvalidImageError
from ..framebuffer import (JPEG2000_RATE, Framebuffer, ImageHeader,
                           ImageOrientation)
from ..interfaces import Encoder
from ..ops import wavelet as W
from ..utils import StageClock, resolve_device
from . import jp2_t1 as _t1
from ._raster import StillDecoder

JP2_SIG = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
J2K_SOC = b"\xff\x4f\xff\x51"

_MAX_DIM = 1 << 20
_MAX_COMPS = 4


def is_jp2(buf: bytes) -> bool:
    return buf.startswith(JP2_SIG) or buf.startswith(J2K_SOC)


# ---------------------------------------------------------------------------
# Tier-2 helpers
# ---------------------------------------------------------------------------

class _BitReader:
    """Packet-header bit reader with 0xFF bit-stuffing (B.10.1)."""

    def __init__(self, data: bytes, pos: int):
        self.d = data
        self.pos = pos
        self.bits = 0
        self.nbits = 0
        self.last = 0

    def bit(self) -> int:
        if self.nbits == 0:
            if self.pos >= len(self.d):
                raise DecodingFailedError("JPEG 2000 packet header truncated")
            b = self.d[self.pos]
            self.pos += 1
            self.nbits = 7 if self.last == 0xFF else 8
            self.last = b
            self.bits = b & ((1 << self.nbits) - 1)
        self.nbits -= 1
        return (self.bits >> self.nbits) & 1

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def align(self) -> int:
        """Flush to byte boundary. When the final header byte was 0xFF,
        the encoder emitted a stuffing byte after it (B.10.1) — consume
        it too, like opj_bio_inalign does."""
        self.nbits = 0
        if self.last == 0xFF:
            self.pos += 1
        self.last = 0
        return self.pos


class _TagTree:
    def __init__(self, w: int, h: int):
        self.levels = []
        while True:
            self.levels.append((w, h))
            if w == 1 and h == 1:
                break
            w, h = (w + 1) // 2, (h + 1) // 2
        self.value = [np.zeros((h_, w_), np.int32)
                      for (w_, h_) in self.levels]
        self.low = [np.zeros((h_, w_), np.int32)
                    for (w_, h_) in self.levels]
        self.known = [np.zeros((h_, w_), np.uint8)
                      for (w_, h_) in self.levels]

    def decode(self, br: _BitReader, x: int, y: int, threshold: int) -> bool:
        """True when value(x, y) < threshold (decoding bits as needed)."""
        stack = []
        xx, yy = x, y
        for lv in range(len(self.levels)):
            stack.append((lv, xx, yy))
            xx, yy = xx // 2, yy // 2
        low = 0
        for lv, xx, yy in reversed(stack):
            if self.low[lv][yy, xx] < low:
                self.low[lv][yy, xx] = low
            while (not self.known[lv][yy, xx]
                   and self.low[lv][yy, xx] < threshold):
                if br.bit():
                    self.known[lv][yy, xx] = 1
                    self.value[lv][yy, xx] = self.low[lv][yy, xx]
                else:
                    self.low[lv][yy, xx] += 1
            if self.known[lv][yy, xx]:
                low = self.value[lv][yy, xx]
            else:
                low = self.low[lv][yy, xx]
                return False  # value >= threshold (still unknown)
        return self.value[0][y, x] < threshold

    def get(self, x: int, y: int) -> int:
        return int(self.value[0][y, x])


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def band_geometry(tcx0, tcy0, tcx1, tcy1, levels):
    """Per resolution r: (res rect, [(orient, band rect), ...]) on the
    tile-component rect (B.5); shared by the decoder and the encoder
    (codecs/jp2_enc.py) so split geometry can never diverge."""
    out = []
    for r in range(levels + 1):
        nb = levels - r
        trx0, try0 = _ceil_div(tcx0, 1 << nb), _ceil_div(tcy0, 1 << nb)
        trx1, try1 = _ceil_div(tcx1, 1 << nb), _ceil_div(tcy1, 1 << nb)
        if r == 0:
            bands = [(0, trx0, try0, trx1, try1)]
        else:
            nb2 = levels - r + 1
            bands = []
            for orient, (xo, yo) in ((1, (1, 0)), (2, (0, 1)),
                                     (3, (1, 1))):
                bx0 = _ceil_div(tcx0 - (1 << (nb2 - 1)) * xo, 1 << nb2)
                by0 = _ceil_div(tcy0 - (1 << (nb2 - 1)) * yo, 1 << nb2)
                bx1 = _ceil_div(tcx1 - (1 << (nb2 - 1)) * xo, 1 << nb2)
                by1 = _ceil_div(tcy1 - (1 << (nb2 - 1)) * yo, 1 << nb2)
                bands.append((orient, bx0, by0, bx1, by1))
        out.append(((trx0, try0, trx1, try1), bands))
    return out


# ---------------------------------------------------------------------------
# codestream structures
# ---------------------------------------------------------------------------

class _Siz:
    pass


class _Cod:
    pass


class _Qcd:
    pass


class _CodeBlock:
    __slots__ = ("x0", "y0", "x1", "y1", "included", "zero_planes",
                 "lblock", "numpasses", "segs", "band")

    def __init__(self, x0, y0, x1, y1, band):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.included = False
        self.zero_planes = 0
        self.lblock = 3
        self.numpasses = 0
        # codeword segments: [bytearray, passes] per terminated segment
        # (one open-ended segment for the default style; bypass/termall
        # split per jp2_t1.seg_maxpasses)
        self.segs = []
        self.band = band


class _Band:
    __slots__ = ("orient", "x0", "y0", "x1", "y1", "cblks",
                 "eps", "mu", "gain")

    def __init__(self):
        self.cblks = []


class _Precinct:
    # pws: per-band codeblock-grid width of THIS precinct — it must live
    # here, not on the shared _Band: later layers revisit earlier
    # precincts, and a band-level slot would hold whichever precinct was
    # initialized last (wrong tag-tree coords on any band whose
    # precincts have different grid widths; review finding)
    __slots__ = ("bands_cblks", "incl_tt", "zp_tt", "pws")


def _parse_siz(seg: bytes) -> _Siz:
    s = _Siz()
    if len(seg) < 39:
        raise InvalidImageError("JPEG 2000: truncated SIZ")
    (s.rsiz, s.xsiz, s.ysiz, s.xosiz, s.yosiz, s.xtsiz, s.ytsiz,
     s.xtosiz, s.ytosiz, s.csiz) = struct.unpack(">HIIIIIIIIH", seg[:36])
    if len(seg) < 36 + 3 * s.csiz:
        raise InvalidImageError("JPEG 2000: truncated SIZ components")
    if s.xtsiz == 0 or s.ytsiz == 0:
        raise InvalidImageError("JPEG 2000: zero tile size")
    if (s.xosiz >= s.xsiz or s.yosiz >= s.ysiz
            or s.xtosiz > s.xosiz or s.ytosiz > s.yosiz):
        raise InvalidImageError("JPEG 2000: invalid grid offsets")
    if not (0 < s.xsiz <= _MAX_DIM and 0 < s.ysiz <= _MAX_DIM):
        raise InvalidImageError("JPEG 2000: invalid image size")
    if not 1 <= s.csiz <= _MAX_COMPS:
        raise InvalidImageError(
            f"JPEG 2000: {s.csiz} components unsupported")
    s.comps = []
    for c in range(s.csiz):
        ssiz, xr, yr = struct.unpack(">BBB", seg[36 + 3 * c:39 + 3 * c])
        depth = (ssiz & 0x7F) + 1
        signed = bool(ssiz & 0x80)
        if depth > 16:
            raise InvalidImageError("JPEG 2000: >16-bit components")
        if not (1 <= xr <= 4 and 1 <= yr <= 4):
            raise InvalidImageError(
                f"JPEG 2000: subsampling {xr}x{yr} out of the "
                "supported 1..4 range")
        s.comps.append((depth, signed, xr, yr))
    return s


def _parse_cod(seg: bytes) -> _Cod:
    c = _Cod()
    if len(seg) < 10:
        raise InvalidImageError("JPEG 2000: truncated COD")
    c.scod = seg[0]
    c.prog = seg[1]
    c.layers = struct.unpack(">H", seg[2:4])[0]
    c.mct = seg[4]
    c.levels = seg[5]
    c.cbw = (seg[6] & 0x0F) + 2
    c.cbh = (seg[7] & 0x0F) + 2
    c.cblk_style = seg[8]
    c.transform = seg[9]  # 0 = 9/7 irreversible, 1 = 5/3 reversible
    if c.scod & 0xF8:
        raise InvalidImageError(
            "JPEG 2000: undefined Scod bits")
    if c.cbw > 12 or c.cbh > 12 or c.cbw + c.cbh > 12:
        raise InvalidImageError(
            "JPEG 2000: invalid codeblock exponents (xcb+ycb must be "
            "<= 12, B.7)")
    if c.prog > 4:
        raise InvalidImageError(
            f"JPEG 2000: invalid progression order {c.prog}")
    if c.cblk_style & 0xC0:
        raise InvalidImageError(
            "JPEG 2000: undefined codeblock-style bits")
    if c.layers < 1:
        raise InvalidImageError("JPEG 2000: zero layers")
    c.precw = [15] * (c.levels + 1)
    c.prech = [15] * (c.levels + 1)
    if c.scod & 1:  # user precincts
        if len(seg) < 11 + c.levels:
            raise InvalidImageError("JPEG 2000: truncated COD precincts")
        for r in range(c.levels + 1):
            pp = seg[10 + r]
            c.precw[r] = pp & 0x0F
            c.prech[r] = pp >> 4
    return c


def _parse_coc_body(seg: bytes, base: "_Cod") -> _Cod:
    """SPcoc mirrors COD's SPcod (A.6.2); prog/layers/mct inherit from
    the main COD."""
    c = _Cod()
    if len(seg) < 6:
        raise InvalidImageError("JPEG 2000: truncated COC")
    c.scod = seg[0] & 0x01  # only the precinct bit exists in Scoc
    c.prog = base.prog
    c.layers = base.layers
    c.mct = base.mct
    c.levels = seg[1]
    c.cbw = (seg[2] & 0x0F) + 2
    c.cbh = (seg[3] & 0x0F) + 2
    c.cblk_style = seg[4]
    c.transform = seg[5]
    if c.cbw > 12 or c.cbh > 12 or c.cbw + c.cbh > 12:
        raise InvalidImageError("JPEG 2000: invalid COC codeblock size")
    if c.cblk_style & 0xC0:
        raise InvalidImageError("JPEG 2000: undefined COC style bits")
    c.precw = [15] * (c.levels + 1)
    c.prech = [15] * (c.levels + 1)
    if c.scod & 1:
        if len(seg) < 7 + c.levels:
            raise InvalidImageError("JPEG 2000: truncated COC precincts")
        for r in range(c.levels + 1):
            pp = seg[6 + r]
            c.precw[r] = pp & 0x0F
            c.prech[r] = pp >> 4
    return c


def _parse_qcd(seg: bytes, levels: int) -> _Qcd:
    q = _Qcd()
    if len(seg) < 2:
        raise InvalidImageError("JPEG 2000: truncated QCD")
    sqcd = seg[0]
    q.style = sqcd & 0x1F
    q.guard = sqcd >> 5
    body = seg[1:]
    nb = 3 * levels + 1
    q.eps = []
    q.mu = []
    if q.style == 0:        # no quantization (reversible)
        if len(body) < nb:
            raise InvalidImageError("JPEG 2000: truncated QCD exponents")
        for i in range(nb):
            q.eps.append(body[i] >> 3)
            q.mu.append(0)
    elif q.style == 1:      # scalar derived: one value, derive others
        if len(body) < 2:
            raise InvalidImageError("JPEG 2000: truncated QCD")
        v = struct.unpack(">H", body[0:2])[0]
        e0, m0 = v >> 11, v & 0x7FF
        for i in range(nb):
            # band i at decomposition level: derived exponents
            if i == 0:
                lvl = levels
            else:
                lvl = levels - (i - 1) // 3
            q.eps.append(e0 - levels + lvl)
            q.mu.append(m0)
    else:                   # scalar expounded
        if len(body) < 2 * nb:
            raise InvalidImageError("JPEG 2000: truncated QCD exponents")
        for i in range(nb):
            v = struct.unpack(">H", body[2 * i:2 * i + 2])[0]
            q.eps.append(v >> 11)
            q.mu.append(v & 0x7FF)
    return q


# ---------------------------------------------------------------------------
# decoder core
# ---------------------------------------------------------------------------

class _Group:
    """Tile-components synthesized as one stack: equal resolution rects
    up to a translation that keeps every origin parity, one transform.
    members: (tile, component) in stack order; bands[r][bi]: (offset in
    the reversible or irreversible part of the coefficient buffer, rows,
    cols) of the (B, rows, cols) stack."""

    def __init__(self, reversible: bool, rects):
        self.reversible = reversible
        self.rects = rects          # per resolution, of the first member
        self.members: List[Tuple[int, int]] = []
        self.bands: List[List[Tuple[int, int, int]]] = []


class Jp2Image:
    """Parsed codestream + tier-2 state; decode() produces component
    planes, int64 tensors on `device` ("cuda" by default; it raises
    without a card unless the caller passes device="cpu")."""

    def __init__(self, buf: bytes, device="cuda"):
        self.device = resolve_device(device)
        try:
            cs, self.meta = _extract_codestream(buf)
            self._parse_codestream(cs)
        except (struct.error, IndexError) as e:
            # residual short-read corners the explicit guards missed:
            # still a malformed file, still a typed error (fuzz totality)
            raise InvalidImageError(f"JPEG 2000: malformed marker ({e})")

    def _parse_codestream(self, cs: bytes) -> None:
        if cs[:2] != b"\xff\x4f":
            raise InvalidImageError("JPEG 2000: missing SOC")
        i = 2
        self.siz: Optional[_Siz] = None
        self.cod: Optional[_Cod] = None
        self.coc: Dict[int, _Cod] = {}
        self.qcd: Optional[_Qcd] = None
        self.qcc: Dict[int, _Qcd] = {}
        self.rgn: Dict[int, int] = {}       # component -> ROI maxshift
        self.tile_parts: Dict[int, List[bytes]] = {}
        ppm_parts: List[Tuple[int, bytes]] = []   # (Zppm, data)
        tile_ppt: Dict[int, List[Tuple[int, bytes]]] = {}
        tile_tp_seq: Dict[int, List[int]] = {}    # tile -> tile-part nos
        tp_counter = 0
        coc_segs: Dict[int, bytes] = {}           # deferred COC bodies
        qcd_seg: Optional[bytes] = None           # deferred QCD body
        qcc_segs: Dict[int, bytes] = {}           # deferred QCC bodies
        n = len(cs)
        while i + 4 <= n:
            marker = cs[i:i + 2]
            if marker == b"\xff\xd9":  # EOC
                break
            ln = struct.unpack(">H", cs[i + 2:i + 4])[0]
            seg = cs[i + 4:i + 2 + ln]
            if marker == b"\xff\x51":
                self.siz = _parse_siz(seg)
            elif marker == b"\xff\x52":
                self.cod = _parse_cod(seg)
            elif marker == b"\xff\x53":  # COC
                # ISO 15444-1 A.2 allows main-header markers in any
                # order after SIZ — COC/QCD/QCC may legally precede COD,
                # so their bodies are STASHED here and parsed after the
                # walk when COD (and each COC's levels) is known
                if self.siz is None or not seg:
                    raise InvalidImageError("JPEG 2000: bad COC placement")
                off = 1 if self.siz.csiz < 257 else 2
                ci = seg[0] if off == 1 else \
                    struct.unpack(">H", seg[:2])[0]
                if ci >= self.siz.csiz:
                    raise InvalidImageError("JPEG 2000: COC component")
                coc_segs[ci] = seg[off:]
            elif marker == b"\xff\x5c":
                qcd_seg = seg
            elif marker == b"\xff\x5d":  # QCC
                if self.siz is None:
                    raise InvalidImageError("JPEG 2000: QCC before SIZ")
                off = 1 if self.siz.csiz < 257 else 2
                ci = seg[0] if off == 1 else struct.unpack(">H", seg[:2])[0]
                qcc_segs[ci] = seg[off:]
            elif marker == b"\xff\x60":  # PPM (packed headers, main)
                if not seg:
                    raise InvalidImageError("JPEG 2000: empty PPM")
                ppm_parts.append((seg[0], seg[1:]))
            elif marker == b"\xff\x5e":  # RGN
                if self.siz is None or not seg:
                    raise InvalidImageError("JPEG 2000: bad RGN")
                off = 1 if self.siz.csiz < 257 else 2
                ci = seg[0] if off == 1 else \
                    struct.unpack(">H", seg[:2])[0]
                if len(seg) < off + 2 or seg[off] != 0:
                    raise InvalidImageError(
                        "JPEG 2000: only maxshift ROI (Srgn=0) exists")
                shift = seg[off + 1]
                if shift > 37:
                    raise InvalidImageError("JPEG 2000: ROI shift > 37")
                self.rgn[ci] = shift
            elif marker == b"\xff\x90":  # SOT
                if len(seg) < 8:
                    raise InvalidImageError("JPEG 2000: truncated SOT")
                isot, psot, tpsot, tnsot = struct.unpack(
                    ">HIBB", seg[:8])
                end = i + psot if psot else n
                # tile-part header: markers until SOD
                j = i + 2 + ln
                while cs[j:j + 2] != b"\xff\x93":
                    if j + 4 > n:
                        raise InvalidImageError(
                            "JPEG 2000: SOT without SOD")
                    tm = cs[j:j + 2]
                    tln = struct.unpack(">H", cs[j + 2:j + 4])[0]
                    tseg = cs[j + 4:j + 2 + tln]
                    if tm == b"\xff\x61":  # PPT
                        if not tseg:
                            raise InvalidImageError("JPEG 2000: bad PPT")
                        tile_ppt.setdefault(isot, []).append(
                            (tseg[0], tseg[1:]))
                    elif tm in (b"\xff\x58", b"\xff\x64"):
                        pass  # PLT / COM: informational
                    elif tm in (b"\xff\x52", b"\xff\x53", b"\xff\x5c",
                                b"\xff\x5d", b"\xff\x5e"):
                        raise InvalidImageError(
                            "JPEG 2000: tile-specific coding/quant "
                            "overrides unsupported")
                    else:
                        raise InvalidImageError(
                            f"JPEG 2000: unexpected marker "
                            f"{tm.hex()} in tile-part header")
                    j += 2 + tln
                tile_tp_seq.setdefault(isot, []).append(tp_counter)
                tp_counter += 1
                self.tile_parts.setdefault(isot, []).append(cs[j + 2:end])
                i = end
                continue
            i += 2 + ln
        if self.siz is None or self.cod is None or qcd_seg is None:
            raise InvalidImageError("JPEG 2000: missing SIZ/COD/QCD")
        # deferred marker resolution (see the COC branch above): COC
        # first, so each QCC resolves its level count against the REAL
        # per-component COC even when the QCC appeared earlier in the
        # header
        for ci, body in coc_segs.items():
            self.coc[ci] = _parse_coc_body(body, self.cod)
        self.qcd = _parse_qcd(qcd_seg, self.cod.levels)
        for ci, body in qcc_segs.items():
            lv = self.coc[ci].levels if ci in self.coc else self.cod.levels
            self.qcc[ci] = _parse_qcd(body, lv)
        # packed packet headers: PPT per tile (Zppt order), else PPM
        # chunks ([Nppm u32 | data] per tile-part, consumed in
        # codestream tile-part order, A.7.4/A.7.5)
        self.tile_packed: Dict[int, bytes] = {}
        for t, parts in tile_ppt.items():
            self.tile_packed[t] = b"".join(
                d for _, d in sorted(parts, key=lambda z: z[0]))
        if ppm_parts:
            if tile_ppt:
                raise InvalidImageError(
                    "JPEG 2000: PPM and PPT both present")
            stream = b"".join(d for _, d in sorted(
                ppm_parts, key=lambda z: z[0]))
            chunks = []
            p = 0
            while p + 4 <= len(stream):
                cl = struct.unpack(">I", stream[p:p + 4])[0]
                if p + 4 + cl > len(stream):
                    raise InvalidImageError("JPEG 2000: truncated PPM")
                chunks.append(stream[p + 4:p + 4 + cl])
                p += 4 + cl
            for t, seqs in tile_tp_seq.items():
                try:
                    self.tile_packed[t] = b"".join(
                        chunks[s] for s in seqs)
                except IndexError:
                    raise InvalidImageError(
                        "JPEG 2000: PPM chunk count < tile-parts")

    # -- geometry -----------------------------------------------------------

    def _tile_grid(self):
        s = self.siz
        ntx = _ceil_div(s.xsiz - s.xtosiz, s.xtsiz)
        nty = _ceil_div(s.ysiz - s.ytosiz, s.ytsiz)
        return ntx, nty

    def decode(self, clock: Optional[StageClock] = None
               ) -> List[torch.Tensor]:
        """Decode all tiles; returns per-component planes, int64 tensors
        on the device (pre level-shift, post wavelet + MCT), each at the
        COMPONENT's own grid resolution (ceil-divided by XRsiz/YRsiz,
        B.3). clock times the host stages ("host_tier2_tier1") and the
        device ones ("device_synthesis")."""
        clock = clock or StageClock(None, self.device)
        try:
            with clock("host_tier2_tier1"):
                staged = self._host_stages()
            with clock("device_synthesis", device=True):
                return self._device_stages(*staged)
        except (struct.error, IndexError, ValueError, RuntimeError) as e:
            # RuntimeError: what torch raises where numpy's ValueError
            raise DecodingFailedError(
                f"JPEG 2000: malformed codestream ({e})")

    def _host_stages(self):
        """Tier-2 and Tier-1 of every tile into the coefficient buffer:
        (tiles, groups, buffer, reversible element count)."""
        s = self.siz
        ntx, nty = self._tile_grid()
        # Tier-2 of every tile, then one Tier-1 pool over all of their
        # codeblocks. What the JAX package raises in tile t (it decodes
        # tile by tile) comes after the Tier-1 of the tiles before it, so
        # an error here waits until theirs has run.
        tiles = []
        jobs = []
        pending = None
        for t in range(ntx * nty):
            data = b"".join(self.tile_parts.get(t, []))
            tx = t % ntx
            ty = t // ntx
            tx0 = max(s.xtosiz + tx * s.xtsiz, s.xosiz)
            ty0 = max(s.ytosiz + ty * s.ytsiz, s.yosiz)
            tx1 = min(s.xtosiz + (tx + 1) * s.xtsiz, s.xsiz)
            ty1 = min(s.ytosiz + (ty + 1) * s.ytsiz, s.ysiz)
            if tx0 >= tx1 or ty0 >= ty1:
                continue
            rects = []
            for c in range(s.csiz):
                _, _, xr, yr = s.comps[c]
                rects.append((_ceil_div(tx0, xr), _ceil_div(ty0, yr),
                              _ceil_div(tx1, xr), _ceil_div(ty1, yr)))
            try:
                comps = self._tier2(t, data, rects)
                jobs += self._t1_jobs(len(tiles), comps)
            except Exception as e:  # noqa: BLE001 -- raised after Tier-1
                pending = e
                break
            tiles.append((t, rects, comps))
        groups, n_rev, n_all = self._layout(tiles)
        host = torch.zeros(n_all, dtype=torch.int32,
                           pin_memory=self.device.type == "cuda")
        self._tier1(jobs, tiles, groups, host.numpy(), n_rev)
        if pending is not None:
            raise pending
        return tiles, groups, host, n_rev

    def _device_stages(self, tiles, groups, host, n_rev):
        """One copy of the buffer to the device, then the synthesis, the
        tile placement and the inverse MCT there."""
        s, cod = self.siz, self.cod
        vals = host.to(self.device, non_blocking=True)
        comps_out = self._synthesize(tiles, groups, vals, n_rev)
        planes = self._place(tiles, groups, comps_out)
        # inverse multi-component transform: requires the first three
        # components on one sampling grid (G.2/G.3; opj skips it
        # otherwise)
        if cod.mct and s.csiz >= 3 and \
                s.comps[0][2:] == s.comps[1][2:] == s.comps[2][2:]:
            inv = W.inverse_rct if cod.transform == 1 else W.inverse_ict
            planes[0], planes[1], planes[2] = inv(planes[0], planes[1],
                                                  planes[2])
        return planes

    # -- per-tile -----------------------------------------------------------

    def _qcd_for(self, c: int) -> _Qcd:
        return self.qcc.get(c, self.qcd)

    def _cod_for(self, c: int) -> _Cod:
        return self.coc.get(c, self.cod)

    def _band_geometry(self, tcx0, tcy0, tcx1, tcy1, levels):
        return band_geometry(tcx0, tcy0, tcx1, tcy1, levels)

    def _tier2(self, t, data, rects):
        """The tile's band/precinct/codeblock structures and its packets
        (Tier-2), as the JAX package's _decode_tile reads them; returns
        per component the list of resolutions."""
        s, cod = self.siz, self.cod
        ncomp = s.csiz
        max_levels = max(self._cod_for(c).levels for c in range(ncomp))
        # build band/precinct/codeblock structures per component
        comps = []
        for c in range(ncomp):
            cod_c = self._cod_for(c)
            tx0, ty0, tx1, ty1 = rects[c]
            geo = self._band_geometry(tx0, ty0, tx1, ty1, cod_c.levels)
            q = self._qcd_for(c)
            res_list = []
            for r, (rrect, bands) in enumerate(geo):
                trx0, try0, trx1, try1 = rrect
                ppx, ppy = cod_c.precw[r], cod_c.prech[r]
                # precinct grid on the resolution
                if trx1 > trx0:
                    npw = _ceil_div(trx1, 1 << ppx) - (trx0 >> ppx)
                    nph = _ceil_div(try1, 1 << ppy) - (try0 >> ppy)
                else:
                    npw = nph = 0
                # codeblock size in band coordinates
                cbw_exp = min(cod_c.cbw, ppx - 1 if r else ppx)
                cbh_exp = min(cod_c.cbh, ppy - 1 if r else ppy)
                band_objs = []
                for bi, (orient, bx0, by0, bx1, by1) in enumerate(bands):
                    b = _Band()
                    b.orient = orient
                    b.x0, b.y0, b.x1, b.y1 = bx0, by0, bx1, by1
                    if r == 0:
                        qi = 0
                        b.gain = 0
                    else:
                        qi = 3 * (r - 1) + bi + 1
                        b.gain = (0, 1, 1, 2)[orient]
                    b.eps = q.eps[qi]
                    b.mu = q.mu[qi]
                    band_objs.append(b)
                res_list.append({
                    "rect": rrect, "bands": band_objs,
                    "npw": npw, "nph": nph, "ppx": ppx, "ppy": ppy,
                    "cbw_exp": cbw_exp, "cbh_exp": cbh_exp,
                    "precincts": {},
                })
            comps.append(res_list)

        # Tier-2: iterate packets in progression order (resolutions a
        # component lacks — COC levels below the tile max — simply
        # contribute no packets)
        order = []
        nprec = lambda c, r: (comps[c][r]["npw"] * comps[c][r]["nph"]
                              if r < len(comps[c]) else 0)
        if cod.prog == 0:    # LRCP
            for l in range(cod.layers):
                for r in range(max_levels + 1):
                    for c in range(ncomp):
                        for p in range(nprec(c, r)):
                            order.append((l, r, c, p))
        elif cod.prog == 1:  # RLCP
            for r in range(max_levels + 1):
                for l in range(cod.layers):
                    for c in range(ncomp):
                        for p in range(nprec(c, r)):
                            order.append((l, r, c, p))
        elif cod.prog == 2:  # RPCL (precinct-major over position)
            # index-lockstep across components equals the spec's
            # position order only when every component shares the same
            # precinct grid at each resolution — with divergent grids
            # (subsampled components / per-component COC levels) the
            # spec interleaves by grid POSITION, which this reader does
            # not implement; decline like PCRL/CPRL rather than parse
            # packet headers against the wrong precinct's tag trees
            for r in range(max_levels + 1):
                grids = {(comps[c][r]["npw"], comps[c][r]["nph"])
                         for c in range(ncomp) if r < len(comps[c])}
                if len(grids) > 1 and max(
                        nprec(c, r) for c in range(ncomp)) > 1:
                    raise InvalidImageError(
                        "JPEG 2000: RPCL with divergent component "
                        "precinct grids unsupported")
            for r in range(max_levels + 1):  # whole-tile precincts
                for p in range(max(nprec(c, r)              # this order
                                   for c in range(ncomp))):  # is spec's
                    for c in range(ncomp):
                        if p < nprec(c, r):
                            for l in range(cod.layers):
                                order.append((l, r, c, p))
        else:                # PCRL / CPRL: positional orders — supported
            # for the whole-tile-precinct case (what encoders emit by
            # default), where every (r, c) has exactly one precinct and
            # the position loop degenerates
            if any(nprec(c, r) > 1 for c in range(ncomp)
                   for r in range(max_levels + 1)):
                raise InvalidImageError(
                    "JPEG 2000: PCRL/CPRL with multiple precincts "
                    "unsupported")
            for c in range(ncomp):
                for r in range(len(comps[c])):
                    for l in range(cod.layers):
                        order.append((l, r, c, 0))
        packed = self.tile_packed.get(t)
        sop = bool(cod.scod & 0x02)
        eph = bool(cod.scod & 0x04)
        if packed is not None:
            hdr_br = _BitReader(packed, 0)
            body_pos = 0
            for (l, r, c, p) in order:
                hdr_br, body_pos = self._read_packet(
                    hdr_br, comps[c][r], l, p, self._cod_for(c),
                    body=data, body_pos=body_pos, sop=sop, eph=eph)
        else:
            br = _BitReader(data, 0)
            for (l, r, c, p) in order:
                br, _ = self._read_packet(br, comps[c][r], l, p,
                                          self._cod_for(c), sop=sop,
                                          eph=eph)

        return comps

    def _t1_jobs(self, k: int, comps):
        """The Tier-1 jobs of the k-th decoded tile, (k, component,
        resolution, band index, codeblock, band, Mb, style), collected as
        the JAX package collects them."""
        jobs = []
        for c in range(self.siz.csiz):
            qc = self._qcd_for(c)
            style_c = self._cod_for(c).cblk_style
            # ROI maxshift raises the coded bitplane count (B.10.4 +
            # opj parity: numbps includes the shift; decoded values
            # >= 2^shift are ROI and downshift after Tier-1)
            shift_c = self.rgn.get(c, 0)
            for r, res in enumerate(comps[c]):
                for bi, b in enumerate(res["bands"]):
                    mb = qc.guard + b.eps - 1 + shift_c
                    if mb > 30:
                        # no legitimate profile reaches this (precision
                        # <=16 + band gain + guard bits); int32 magnitudes
                        # cap the decodable range
                        raise InvalidImageError(
                            f"JPEG 2000: magnitude bitplanes exceed 30 "
                            f"(Mb={mb})")
                    for cb in b.cblks:
                        if cb.numpasses and cb.segs:
                            jobs.append((k, c, r, bi, cb, b, mb, style_c))
        return jobs

    def _layout(self, tiles):
        """Group the tile-components (see _Group) and give each group's
        band stacks their place in the coefficient buffer: the reversible
        groups first, then the irreversible ones. Returns (groups,
        reversible element count, total element count)."""
        by_key: Dict[tuple, _Group] = {}
        for k, (_, _, comps) in enumerate(tiles):
            for c in range(self.siz.csiz):
                rev = self._cod_for(c).transform == 1
                rects = [res["rect"] for res in comps[c]]
                key = (rev, tuple((x1 - x0, y1 - y0, x0 & 1, y0 & 1)
                                  for x0, y0, x1, y1 in rects))
                if key not in by_key:
                    by_key[key] = _Group(rev, rects)
                by_key[key].members.append((k, c))
        groups = sorted(by_key.values(), key=lambda g: not g.reversible)
        off = 0
        n_rev = None
        for g in groups:
            # by component, then tile: a component's members are one
            # slice of the stack, in the tile grid's row-major order
            g.members.sort(key=lambda kc: (kc[1], kc[0]))
            if not g.reversible and n_rev is None:
                n_rev = off
            base = 0 if g.reversible else n_rev
            k0, c0 = g.members[0]
            nb = len(g.members)
            for res in tiles[k0][2][c0]:
                row = []
                for b in res["bands"]:
                    bh, bw = b.y1 - b.y0, b.x1 - b.x0
                    row.append((off - base, bh, bw))
                    off += nb * bh * bw
                g.bands.append(row)
        return groups, off if n_rev is None else n_rev, off

    def _tier1(self, jobs, tiles, groups, host: np.ndarray, n_rev: int):
        """Tier-1 decode of every job (jp2_t1.run_jobs), each codeblock
        pasted into its band's place in `host`."""
        where = {}
        for g in groups:
            base = 0 if g.reversible else n_rev
            for m, kc in enumerate(g.members):
                where[kc] = (g, m, base)

        def one(job):
            k, c, r, bi, cb, b, mb, style = job
            g, m, base = where[(k, c)]
            off, bh, bw = g.bands[r][bi]
            band = host[base + off + m * bh * bw:
                        base + off + (m + 1) * bh * bw].reshape(bh, bw)
            data = b"".join(bytes(s[0]) for s in cb.segs)
            seg_meta = [(len(s[0]), s[1]) for s in cb.segs]
            band[cb.y0 - b.y0:cb.y1 - b.y0, cb.x0 - b.x0:cb.x1 - b.x0] = \
                _t1.decode_codeblock(
                    data, cb.x1 - cb.x0, cb.y1 - cb.y0,
                    (0, 1, 0, 2)[b.orient], cb.zero_planes, cb.numpasses,
                    mb, style, seg_meta)

        _t1.run_jobs(one, jobs)

    def _per_block(self, tiles, groups, fn, reversible=None):
        """(values, repeats) of fn(component, band) for every band block
        in buffer order (of the reversible or irreversible part only, if
        `reversible` is given)."""
        vals, reps = [], []
        for g in groups:
            if reversible is not None and g.reversible != reversible:
                continue
            for r, row in enumerate(g.bands):
                for bi, (_, bh, bw) in enumerate(row):
                    for k, c in g.members:
                        vals.append(fn(c, tiles[k][2][c][r]["bands"][bi]))
                        reps.append(bh * bw)
        return vals, reps

    def _expand(self, vals, reps, dtype, n: int) -> torch.Tensor:
        """Per-block values repeated over each block's elements, on the
        device."""
        v = torch.tensor(vals, dtype=dtype).to(self.device)
        r = torch.tensor(reps, dtype=torch.int64).to(self.device)
        return torch.repeat_interleave(v, r, output_size=n)

    def _synthesize(self, tiles, groups, vals: torch.Tensor, n_rev: int):
        """The device tail up to the rint, per group: the ROI shift, the
        dequantization of the whole buffer at once, then each level's
        inverse wavelet on the group's stack. Returns per group the
        (B, rows, cols) int64 tile-components."""
        vals = vals.to(torch.int64)
        if any(self.rgn.get(c, 0) for g in groups for _, c in g.members):
            # maxshift ROI exactly as opj: threshold and downshift applied
            # in Tier-1's 2x domain (shift 0 leaves a value as it is)
            sv, reps = self._per_block(tiles, groups,
                                       lambda c, b: self.rgn.get(c, 0))
            sh = self._expand(sv, reps, torch.int64, vals.numel())
            mags = vals.abs()
            vals = torch.where(mags >= (1 << sh),
                               torch.sign(vals) * (mags >> sh), vals)
        # Tier-1 outputs opj's 2x-domain values (2*mag + 2^last decoded
        # plane): reversible: value / 2 with C truncation toward zero;
        # irreversible: value * delta / 2
        rev = torch.div(vals[:n_rev], 2, rounding_mode="trunc")
        irr = vals[n_rev:]
        if irr.numel():
            def half_delta(c, b):
                rb = self.siz.comps[c][0] + b.gain
                delta = 2.0 ** (rb - b.eps) * (1.0 + b.mu / 2048.0)
                return 0.5 * delta
            fv, reps = self._per_block(tiles, groups, half_delta, False)
            irr = irr.to(torch.float64) * self._expand(
                fv, reps, torch.float64, irr.numel())
        out = []
        for g in groups:
            part = rev if g.reversible else irr
            nb = len(g.members)

            def band(r, bi):
                off, bh, bw = g.bands[r][bi]
                return part[off:off + nb * bh * bw].view(nb, bh, bw)
            ll = band(0, 0)
            for r in range(1, len(g.rects)):
                ll = W.inverse_dwt_level(ll, band(r, 0), band(r, 1),
                                         band(r, 2), g.rects[r - 1],
                                         g.rects[r], g.reversible)
            if not g.reversible:
                ll = torch.round(ll)
            out.append(ll.to(torch.int64))
        return out

    def _place(self, tiles, groups, comps_out) -> List[torch.Tensor]:
        """Tile placement into per-component planes. The members of one
        component that fill a rectangle of the tile grid go in one copy
        (equal tiles abut; a component's members are one slice of the
        stack, in the grid's row-major order), the others one by one."""
        s = self.siz
        ntx, _ = self._tile_grid()
        planes = []
        for c in range(s.csiz):
            _, _, xr, yr = s.comps[c]
            cw = _ceil_div(s.xsiz, xr) - _ceil_div(s.xosiz, xr)
            ch = _ceil_div(s.ysiz, yr) - _ceil_div(s.yosiz, yr)
            planes.append(torch.zeros((ch, cw), dtype=torch.int64,
                                      device=self.device))
        for g, out in zip(groups, comps_out):
            by_comp: Dict[int, List[int]] = {}
            for m, (_, c) in enumerate(g.members):
                by_comp.setdefault(c, []).append(m)
            h, w = out.shape[-2:]
            for c, ms in by_comp.items():
                _, _, xr, yr = s.comps[c]
                pos = []
                for m in ms:
                    t, rects, _ = tiles[g.members[m][0]]
                    pos.append((t // ntx, t % ntx,
                                rects[c][1] - _ceil_div(s.yosiz, yr),
                                rects[c][0] - _ceil_div(s.xosiz, xr)))
                rows = sorted({p[0] for p in pos})
                cols = sorted({p[1] for p in pos})
                if (h and w and len(rows) * len(cols) == len(ms)
                        and rows[-1] - rows[0] + 1 == len(rows)
                        and cols[-1] - cols[0] + 1 == len(cols)):
                    _, _, cy0, cx0 = pos[0]
                    nr, nc = len(rows), len(cols)
                    planes[c][cy0:cy0 + nr * h, cx0:cx0 + nc * w].view(
                        nr, h, nc, w).copy_(out[ms[0]:ms[-1] + 1].view(
                            nr, nc, h, w).permute(0, 2, 1, 3))
                    continue
                for m, (_, _, cy0, cx0) in zip(ms, pos):
                    planes[c][cy0:cy0 + h, cx0:cx0 + w] = out[m]
        return planes

    def _read_packet(self, br: _BitReader, res, layer: int, p: int, cod,
                     body=None, body_pos: int = 0, sop: bool = False,
                     eph: bool = False):
        """Parse one packet header + collect codeblock data.

        br reads the packet HEADER (the tile stream normally; the
        PPM/PPT packed-header stream when `body` is given, in which
        case packet bodies advance `body_pos` through `body`). SOP
        markers live in the body stream; EPH follows each packet
        header in the header stream. Returns (next header reader,
        next body position)."""
        packed = body is not None
        if sop:
            bstream = body if packed else br.d
            bpos = body_pos if packed else br.pos
            if bstream[bpos:bpos + 2] == b"\xff\x91":
                if packed:
                    body_pos += 6
                else:
                    br = _BitReader(br.d, bpos + 6)
        prec = res["precincts"].get(p)
        if prec is None:
            prec = self._init_precinct(res, p, cod)
            res["precincts"][p] = prec
        # empty-packet bit
        if not br.bit():
            pos = br.align()
            if eph and br.d[pos:pos + 2] == b"\xff\x92":
                pos += 2
            return _BitReader(br.d, pos), body_pos
        chunks = []
        for bi, (band, cblks) in enumerate(prec.bands_cblks):
            itt, ztt = prec.incl_tt[bi], prec.zp_tt[bi]
            pw = max(prec.pws[bi], 1)
            for ci, cb in enumerate(cblks):
                gx = ci % pw
                gy = ci // pw
                if not cb.included:
                    inc = itt.decode(br, gx, gy, layer + 1)
                else:
                    inc = br.bit()
                if not inc:
                    continue
                if not cb.included:
                    # zero bitplanes: decode until known
                    thr = 1
                    while not ztt.decode(br, gx, gy, thr):
                        thr += 1
                    cb.zero_planes = ztt.get(gx, gy)
                    cb.included = True
                    cb.lblock = 3
                # number of passes
                if not br.bit():
                    np_ = 1
                elif not br.bit():
                    np_ = 2
                else:
                    v = br.read(2)
                    if v < 3:
                        np_ = 3 + v
                    else:
                        v = br.read(5)
                        if v < 31:
                            np_ = 6 + v
                        else:
                            np_ = 37 + br.read(7)
                # Lblock update (one per contribution), then one length
                # per codeword segment touched (B.10.7.1)
                while br.bit():
                    cb.lblock += 1
                style = cod.cblk_style
                remaining = np_
                while remaining > 0:
                    si = len(cb.segs) - 1
                    if si < 0 or cb.segs[si][1] >= _t1.seg_maxpasses(
                            style, si):
                        cb.segs.append([bytearray(), 0])
                        si += 1
                    cap = _t1.seg_maxpasses(style, si) - cb.segs[si][1]
                    k = min(remaining, cap)
                    nbits = cb.lblock + int(math.floor(math.log2(k)))
                    seg_len = br.read(nbits)
                    cb.segs[si][1] += k
                    cb.numpasses += k
                    chunks.append((cb, si, seg_len))
                    remaining -= k
        pos = br.align()
        if eph and br.d[pos:pos + 2] == b"\xff\x92":
            pos += 2
        if packed:
            d = body
            bpos = body_pos
        else:
            d = br.d
            bpos = pos
        for cb, si, seg_len in chunks:
            if bpos + seg_len > len(d):
                raise DecodingFailedError("JPEG 2000 packet body truncated")
            cb.segs[si][0] += d[bpos:bpos + seg_len]
            bpos += seg_len
        if packed:
            return _BitReader(br.d, pos), bpos
        return _BitReader(d, bpos), body_pos

    def _init_precinct(self, res, p: int, cod):
        prec = _Precinct()
        prec.bands_cblks = []
        prec.incl_tt = []
        prec.zp_tt = []
        prec.pws = []
        trx0, try0, trx1, try1 = res["rect"]
        ppx, ppy = res["ppx"], res["ppy"]
        px = p % res["npw"]
        py = p // res["npw"]
        r0 = 1 if len(res["bands"]) == 3 else 0  # band-coord halving
        # precinct rect on the RESOLUTION grid
        prx0 = max(((trx0 >> ppx) + px) << ppx, trx0)
        pry0 = max(((try0 >> ppy) + py) << ppy, try0)
        prx1 = min(((trx0 >> ppx) + px + 1) << ppx, trx1)
        pry1 = min(((try0 >> ppy) + py + 1) << ppy, try1)
        for band in res["bands"]:
            # precinct rect mapped into band coordinates
            if r0:
                bpx0, bpy0 = _ceil_div(prx0, 2), _ceil_div(pry0, 2)
                bpx1, bpy1 = _ceil_div(prx1, 2), _ceil_div(pry1, 2)
            else:
                bpx0, bpy0, bpx1, bpy1 = prx0, pry0, prx1, pry1
            bpx0, bpy0 = max(bpx0, band.x0), max(bpy0, band.y0)
            bpx1, bpy1 = min(bpx1, band.x1), min(bpy1, band.y1)
            cbw = 1 << res["cbw_exp"]
            cbh = 1 << res["cbh_exp"]
            cblks = []
            if bpx1 > bpx0 and bpy1 > bpy0:
                cgx0 = bpx0 // cbw
                cgx1 = _ceil_div(bpx1, cbw)
                cgy0 = bpy0 // cbh
                cgy1 = _ceil_div(bpy1, cbh)
            else:
                cgx0 = cgx1 = cgy0 = cgy1 = 0
            pw = max(cgx1 - cgx0, 0)
            ph = max(cgy1 - cgy0, 0)
            prec.pws.append(pw)
            for gy in range(cgy0, cgy1):
                for gx in range(cgx0, cgx1):
                    cb = _CodeBlock(max(gx * cbw, bpx0),
                                    max(gy * cbh, bpy0),
                                    min((gx + 1) * cbw, bpx1),
                                    min((gy + 1) * cbh, bpy1),
                                    band.orient)
                    cblks.append(cb)
                    band.cblks.append(cb)
            prec.bands_cblks.append((band, cblks))
            prec.incl_tt.append(_TagTree(max(pw, 1), max(ph, 1)))
            prec.zp_tt.append(_TagTree(max(pw, 1), max(ph, 1)))
        return prec



def _extract_codestream(buf: bytes) -> Tuple[bytes, dict]:
    if buf.startswith(J2K_SOC):
        return buf, {}
    if not buf.startswith(JP2_SIG):
        raise InvalidImageError("not a JPEG 2000 file")
    i = 0
    meta: dict = {}
    n = len(buf)
    while i + 8 <= n:
        ln = struct.unpack(">I", buf[i:i + 4])[0]
        typ = buf[i + 4:i + 8]
        off = 8
        if ln == 1:
            if i + 16 > n:
                raise InvalidImageError("JPEG 2000: truncated box header")
            ln = struct.unpack(">Q", buf[i + 8:i + 16])[0]
            off = 16
        if ln == 0:
            ln = n - i
        if typ == b"jp2h":
            j = i + off
            end = min(i + ln, n)
            while j + 8 <= end:
                sl = struct.unpack(">I", buf[j:j + 4])[0]
                st = buf[j + 4:j + 8]
                if st == b"ihdr" and sl >= 22:
                    h, w, nc, bpc = struct.unpack(
                        ">IIHB", buf[j + 8:j + 19])
                    meta["ihdr"] = (w, h, nc, bpc)
                if st == b"colr" and sl >= 15 and buf[j + 8] == 1:
                    meta["colorspace"] = struct.unpack(
                        ">I", buf[j + 11:j + 15])[0]
                j += max(sl, 8)
        elif typ == b"jp2c":
            return buf[i + off:i + ln if ln > 1 else n], meta
        i += max(ln, 8)
    raise InvalidImageError("JPEG 2000: no codestream box")


# ---------------------------------------------------------------------------
# public Decoder
# ---------------------------------------------------------------------------

class Jp2Decoder(StillDecoder):
    """A JP2 or J2K stream's one frame, (H, W, C) u8 BGR(A) or gray on
    `device` ("cuda" unless the caller asks for the CPU). stage_times: a
    dict to which decode_to appends the ms of "host_tier2_tier1",
    "device_synthesis" and "device_convert" (utils.StageClock), or
    None."""

    def __init__(self, buf: bytes, device="cuda",
                 stage_times: Optional[Dict[str, List[float]]] = None):
        self.device = resolve_device(device)
        self._img = Jp2Image(buf, device=self.device)
        self._buf = buf
        self._decoded = False
        self.stage_times = stage_times
        s = self._img.siz
        self._w = s.xsiz - s.xosiz
        self._h = s.ysiz - s.yosiz
        self._nc = s.csiz

    def header(self) -> ImageHeader:
        return ImageHeader(width=self._w, height=self._h,
                           channels=4 if self._nc == 2 else self._nc,
                           orientation=ImageOrientation.TOP_LEFT,
                           num_frames=1, content_length=len(self._buf))

    def description(self) -> str:
        return "JP2"

    def decode_to(self, fb: Framebuffer) -> None:
        if self._decoded:
            raise EOFError()
        clock = StageClock(self.stage_times, self.device)
        planes = self._img.decode(clock)
        with clock("device_convert", device=True):
            fb.array = self._pixels(planes)
        fb.duration = 0.0
        fb.x_offset = fb.y_offset = 0
        self._decoded = True

    def _pixels(self, planes) -> torch.Tensor:
        """decode_to's conversions on the planes' device: component
        replication, sYCC, level shift, clip, 8-bit scale, BGR(A)."""
        s = self._img.siz
        vals = []   # (plane int64 pre-level-shift, depth) post-upsample
        chans = []
        for c, pl in enumerate(planes):
            depth, signed, xr, yr = s.comps[c]
            if xr > 1 or yr > 1:
                if pl.shape[0] == 0 or pl.shape[1] == 0:
                    raise DecodingFailedError(
                        "JPEG 2000: empty subsampled component")
                # subsampled component: sample replication back to the
                # image grid, honoring the reference-grid origin phase
                # (component sample k sits at grid x in
                # [k*XRsiz, (k+1)*XRsiz), B.3; image pixel j is grid
                # x = XOsiz + j)
                cols = np.clip((s.xosiz + np.arange(self._w)) // xr
                               - _ceil_div(s.xosiz, xr), 0,
                               pl.shape[1] - 1)
                rows = np.clip((s.yosiz + np.arange(self._h)) // yr
                               - _ceil_div(s.yosiz, yr), 0,
                               pl.shape[0] - 1)
                pl = pl.index_select(0, torch.from_numpy(rows).to(
                    self.device)).index_select(1, torch.from_numpy(
                        cols).to(self.device))
            vals.append((pl, depth))
        # sYCC (colr enumcs 18): OpenCV's cvtColor(COLOR_YUV2BGR)
        # fixed-point kernel (coefficients x 2^14 + CV_DESCALE), which
        # the reference stack applies, on pre-level-shift planes (Y
        # centered, Cb/Cr already offset-subtracted by construction)
        if (self._img.meta.get("colorspace") == 18 and self._nc >= 3
                and len({d for _, d in vals[:3]}) == 1):
            d = vals[0][1]
            off = 1 << (d - 1)
            yv = vals[0][0] + off
            cb = vals[1][0]
            cr = vals[2][0]

            def desc(x):
                return (x + (1 << 13)) >> 14

            b = yv + desc(33292 * cb)
            g = yv + desc(-6472 * cb - 9519 * cr)
            r = yv + desc(18678 * cr)
            vals[0] = (r - off, d)
            vals[1] = (g - off, d)
            vals[2] = (b - off, d)
        for pl, depth in vals:
            # unsigned: undo the DC level shift; signed: same offset maps
            # [-2^(d-1), 2^(d-1)) onto the unsigned range the way
            # OpenCV's grfmt_jpeg2000 renders signed components
            pl = torch.clamp(pl + (1 << (depth - 1)), 0, (1 << depth) - 1)
            if depth > 8:   # scale like OpenCV's 16->8 convention
                pl = pl >> (depth - 8)
            chans.append(pl.to(torch.uint8))
        if self._nc >= 3:
            px = torch.stack([chans[2], chans[1], chans[0]]
                             + ([chans[3]] if self._nc == 4 else []), -1)
        elif self._nc == 2:  # gray+alpha -> BGRA (the PNG decoder's form)
            px = torch.stack([chans[0], chans[0], chans[0], chans[1]], -1)
        else:
            px = chans[0][..., None]
        return px


class Jp2Encoder(Encoder):
    """The port's JP2 encoder (codecs/jp2_enc.py). Lossless 5/3 by
    default; JPEG2000_RATE (encode option key 1000) sets an irreversible
    9/7 compression-ratio target in 1/1000ths like OpenCV's
    IMWRITE_JPEG2000_COMPRESSION_X1000. The frame is encoded where it
    lives: its forward transforms run on its device."""

    def __init__(self, decoded_by=None, icc_override=None):
        del decoded_by, icc_override

    def encode(self, fb, opts):
        from . import jp2_enc
        if fb is None:
            raise DecodingFailedError(
                "JP2 encoder cannot flush without a frame")
        arr = fb.array
        if arr.dim() == 3 and arr.shape[2] == 1:
            arr = arr[:, :, 0]
        if arr.dim() == 3:   # BGR(A) -> RGB(A)
            arr = arr[:, :, [2, 1, 0, 3]] if arr.shape[2] == 4 \
                else arr.flip(-1)
        rate = int(opts.get(JPEG2000_RATE, 0)) if opts else 0
        if rate > 0:
            return jp2_enc.encode_jp2(arr, reversible=False,
                                      rate=max(rate / 1000.0, 1.0))
        return jp2_enc.encode_jp2(arr)
