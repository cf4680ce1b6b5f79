"""JPEG 2000 encoder (JP2 container + J2K codestream), ISO/IEC 15444-1:
the counterpart of ``lilliput_tpu/codecs/jp2_enc.py``, giving the same
bytes for every option (codeblock styles, PPT/PPM, SOP/EPH, precincts of
the whole tile, ROI, subsampled components, per-component COC styles,
``rate``/``qscale``).

Where each stage runs: the level shift, the forward RCT/ICT, the
subsampling, the ROI maximum, the forward wavelet (``ops/wavelet.py``,
tile-components of one geometry as one stack) and the quantizer run as
torch ops on the image's device: a tensor's own, the CPU for a numpy
array. The quantized bands then cross to the host in one copy for the
EBCOT Tier-1 coder (C++, ``codecs/jp2_t1.py``, on a thread pool over
every codeblock) and the Tier-2 packet and marker layers (Python, as
in the JAX package). A ``rate`` search encodes up to eight times with
different quantizer scales; its trials share one forward transform.
"""

from __future__ import annotations

import math
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..errors import InvalidImageError
from ..ops import wavelet as W
from . import jp2_t1
from .jp2 import _ceil_div, band_geometry

# codeblock-style bits (SPcod byte 4, Table A.19)
STY_LAZY = 0x01     # selective arithmetic coding bypass
STY_RESET = 0x02    # context reset on each pass
STY_TERMALL = 0x04  # termination on each pass
STY_VSC = 0x08      # vertically stripe-causal contexts
STY_PTERM = 0x10    # predictable termination
STY_SEGSYM = 0x20   # segmentation symbols


class _BitWriter:
    """Packet-header bit writer with 0xFF stuffing — mirror of
    jp2.py's _BitReader (B.10.1)."""

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nacc = 0
        self.last = 0

    def _cap(self) -> int:
        return 7 if self.last == 0xFF else 8

    def bit(self, b: int):
        self.acc = (self.acc << 1) | (b & 1)
        self.nacc += 1
        if self.nacc == self._cap():
            self.out.append(self.acc)
            self.last = self.acc
            self.acc = 0
            self.nacc = 0

    def write(self, v: int, n: int):
        for i in range(n - 1, -1, -1):
            self.bit((v >> i) & 1)

    def align(self):
        """Pad to byte boundary; emit the stuffing byte after a final
        0xFF like the reader's align consumes (B.10.1)."""
        if self.nacc:
            self.acc <<= self._cap() - self.nacc
            self.out.append(self.acc)
            self.last = self.acc
            self.acc = 0
            self.nacc = 0
        if self.last == 0xFF:
            self.out.append(0)
            self.last = 0

    def data(self) -> bytes:
        return bytes(self.out)


class _TagTreeEnc:
    """Tag-tree encoder (B.10.2) — exact dual of jp2.py's _TagTree
    decoder: same node walk, emitting the bits it consumes."""

    def __init__(self, w: int, h: int, leaves: np.ndarray):
        self.levels = []
        while True:
            self.levels.append((w, h))
            if w == 1 and h == 1:
                break
            w, h = (w + 1) // 2, (h + 1) // 2
        self.value = []
        cur = np.asarray(leaves, np.int64)
        for (w_, h_) in self.levels:
            if cur.shape != (h_, w_):
                raise ValueError("tag tree leaf shape mismatch")
            self.value.append(cur)
            if w_ == 1 and h_ == 1:
                break
            ph, pw = (h_ + 1) // 2, (w_ + 1) // 2
            nxt = np.full((ph, pw), np.iinfo(np.int64).max, np.int64)
            for yy in range(h_):
                for xx in range(w_):
                    nxt[yy // 2, xx // 2] = min(nxt[yy // 2, xx // 2],
                                                cur[yy, xx])
            cur = nxt
        self.low = [np.zeros((h_, w_), np.int64) for (w_, h_) in self.levels]
        self.known = [np.zeros((h_, w_), np.uint8)
                      for (w_, h_) in self.levels]

    def encode(self, bw: _BitWriter, x: int, y: int, threshold: int):
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
                if self.low[lv][yy, xx] == self.value[lv][yy, xx]:
                    bw.bit(1)
                    self.known[lv][yy, xx] = 1
                else:
                    bw.bit(0)
                    self.low[lv][yy, xx] += 1
            if self.known[lv][yy, xx]:
                low = int(self.value[lv][yy, xx])
            else:
                return  # threshold reached without resolving — decoder
                # stops here too ("value >= threshold")


class _EncBlock:
    __slots__ = ("x0", "y0", "x1", "y1", "segs", "numpasses",
                 "zero_planes", "lblock")

    def __init__(self, x0, y0, x1, y1):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.segs: List[Tuple[bytes, int]] = []  # (data, passes)
        self.numpasses = 0
        self.zero_planes = 0
        self.lblock = 3


def _write_numpasses(bw: _BitWriter, np_: int):
    """B.10.6 — mirror of the decoder's read."""
    if np_ == 1:
        bw.bit(0)
    elif np_ == 2:
        bw.bit(1)
        bw.bit(0)
    elif np_ <= 5:
        bw.write(0b11, 2)
        bw.write(np_ - 3, 2)
    elif np_ <= 36:
        bw.write(0b1111, 4)
        bw.write(np_ - 6, 5)
    elif np_ <= 164:
        bw.write(0b111111111, 9)
        bw.write(np_ - 37, 7)
    else:
        raise InvalidImageError("JPEG 2000: > 164 coding passes")


def _grid_dims(bx0, by0, bx1, by1, cbw_exp, cbh_exp):
    if bx1 <= bx0 or by1 <= by0:
        return 0, 0, 0, 0
    cbw, cbh = 1 << cbw_exp, 1 << cbh_exp
    cgx0, cgx1 = bx0 // cbw, _ceil_div(bx1, cbw)
    cgy0, cgy1 = by0 // cbh, _ceil_div(by1, cbh)
    return cgx0, cgy0, cgx1 - cgx0, cgy1 - cgy0


def _build_bands(tile_rect, levels, cbw_e, cbh_e):
    """Per resolution: list of (orient, rect, grid origin+dims) for the
    whole-tile-precinct layout (precinct exponent 15)."""
    geo = band_geometry(*tile_rect, levels)
    out = []
    for r, (rrect, bands) in enumerate(geo):
        binfo = []
        for orient, bx0, by0, bx1, by1 in bands:
            cbw_exp = cbw_e if r else cbw_e  # precinct 15 never clamps
            binfo.append((orient, (bx0, by0, bx1, by1),
                          _grid_dims(bx0, by0, bx1, by1, cbw_exp, cbh_e)))
        out.append((rrect, binfo))
    return out


_BAND_CTX = (0, 1, 0, 2)  # orient -> T1 context family (LL/LH, HL, HH)
_BAND_GAIN = (0, 1, 1, 2)


def _t1_encode(coefs, orient, mb, style=0):
    """One codeblock through the Tier-1 coder. Returns (segments
    [(bytes, passes)], numpasses, zero_planes)."""
    return jp2_t1.encode_codeblock(coefs, _BAND_CTX[orient], mb, style)


def forward_tile_planes(planes, tile_rect, levels, reversible):
    """Forward DWT pyramid of tile-components (..., rows, cols) over
    tile_rect: per resolution a dict orient -> band tensor (..., bh, bw)
    matching band_geometry's rects, on the planes' device."""
    geo = band_geometry(*tile_rect, levels)
    res_bands: List[dict] = [dict() for _ in range(levels + 1)]
    cur = planes
    for d in range(levels):
        r = levels - d          # resolution whose H-bands this step makes
        # rect of the CURRENT ll (resolution r coordinates)
        ll, hl, lh, hh = W.forward_dwt_level(cur, geo[r][0], reversible)
        res_bands[r][1] = hl
        res_bands[r][2] = lh
        res_bands[r][3] = hh
        cur = ll
    res_bands[0][0] = cur
    return res_bands


def _quantize_band(arr, reversible, depth, gain, eps, mu):
    """Scalar deadzone quantization (E.1) of a band tensor on its
    device; reversible bands pass as int64."""
    if reversible:
        return arr.to(torch.int64)
    rb = depth + gain
    delta = 2.0 ** (rb - eps) * (1.0 + mu / 2048.0)
    a = W._div(arr.to(torch.float64), delta)
    return (torch.sign(a) * torch.floor(torch.abs(a))).to(torch.int64)


class _TileEncoder:
    """One tile's packets (Tier-2) from its coded codeblocks. comps: per
    component, per resolution {"rect", "bands": [{"orient", "rect",
    "grid", "cblks"}]}."""

    def __init__(self, comps, cod):
        self.cod = cod
        self.comps = comps
        self.ncomp = len(comps)

    def packets(self) -> List[Tuple[bytes, bytes]]:
        """All packets of this tile in LRCP order (single layer,
        whole-tile precincts => one precinct per (r, c)), as
        (header, body) pairs so PPT/SOP/EPH assembly can split them."""
        cod = self.cod
        out = []
        for r in range(cod["levels"] + 1):
            for c in range(self.ncomp):
                res = self.comps[c][r]
                trx0, try0, trx1, try1 = res["rect"]
                if trx1 <= trx0 or try1 <= try0:
                    continue  # decoder sees nprec == 0: no packet
                out.append(self._one_packet(res))
        return out

    def _one_packet(self, res) -> Tuple[bytes, bytes]:
        bw = _BitWriter()
        styled = self.cod.get("style", 0)
        any_inc = any(cb.numpasses
                      for b in res["bands"] for cb in b["cblks"])
        if not any_inc:
            bw.bit(0)
            bw.align()
            return bw.data(), b""
        bw.bit(1)
        bodies = []
        for b in res["bands"]:
            _, _, gw, gh = b["grid"]
            if gw == 0 or gh == 0:
                continue
            incl = np.ones((gh, gw), np.int64)
            zps = np.zeros((gh, gw), np.int64)
            for ci, cb in enumerate(b["cblks"]):
                incl[ci // gw, ci % gw] = 0 if cb.numpasses else 1
                zps[ci // gw, ci % gw] = cb.zero_planes
            itt = _TagTreeEnc(gw, gh, incl)
            ztt = _TagTreeEnc(gw, gh, zps)
            for ci, cb in enumerate(b["cblks"]):
                gx, gy = ci % gw, ci // gw
                itt.encode(bw, gx, gy, 1)
                if not cb.numpasses:
                    continue
                thr = 1
                while thr <= cb.zero_planes:
                    ztt.encode(bw, gx, gy, thr)
                    thr += 1
                ztt.encode(bw, gx, gy, thr)
                _write_numpasses(bw, cb.numpasses)
                # Lblock signalling then one length per codeword
                # segment (B.10.7.1): a single increment must satisfy
                # every segment's length
                k = 0
                for (seg, np_) in cb.segs:
                    base = cb.lblock + int(math.floor(math.log2(np_)))
                    while len(seg) >= (1 << (base + k)):
                        k += 1
                for _ in range(k):
                    bw.bit(1)
                bw.bit(0)
                cb.lblock += k
                for (seg, np_) in cb.segs:
                    bits = cb.lblock + int(math.floor(math.log2(np_)))
                    bw.write(len(seg), bits)
                bodies.append(b"".join(s for s, _ in cb.segs))
        del styled
        bw.align()
        return bw.data(), b"".join(bodies)


def _marker(code: int, payload: bytes) -> bytes:
    return struct.pack(">HH", code, len(payload) + 2) + payload


_NORM_CACHE: dict = {}


def _band_norm(levels: int, r: int, orient: int) -> float:
    """L2 synthesis norm of a unit coefficient in band (r, orient) of a
    `levels`-deep 9/7 pyramid, computed numerically through our own
    inverse transform (on the CPU; the sum in numpy, as the JAX package
    sums it); weights the lossy quantizer steps so distortion per unit
    delta is uniform."""
    key = (levels, r, orient)
    v = _NORM_CACHE.get(key)
    if v is not None:
        return v
    size = 8 << max(levels - (1 if r == 0 else r), 0)
    size = min(max(size, 16), 512)
    geo = band_geometry(0, 0, size, size, levels)
    ll = None
    prev_rect = None
    for rr, (rrect, bands) in enumerate(geo):
        arrs = []
        for orient_b, bx0, by0, bx1, by1 in bands:
            a = np.zeros((by1 - by0, bx1 - bx0), np.float64)
            if rr == r and orient_b == orient and a.size:
                a[a.shape[0] // 2, a.shape[1] // 2] = 1.0
            arrs.append(torch.from_numpy(a))
        if rr == 0:
            ll = arrs[0]
        else:
            ll = W.inverse_dwt_level(ll, arrs[0], arrs[1], arrs[2],
                                     prev_rect, rrect, False)
        prev_rect = rrect
    v = float(np.sqrt((ll.numpy() ** 2).sum()))
    _NORM_CACHE[key] = v
    return v


def _lossy_qparams(levels: int, depth: int, scale: float):
    """Per-band (eps, mu) for scalar-expounded 9/7 quantization with
    step sizes delta_b = scale / norm_b (uniform distortion weighting).
    Returns (qcd_values, [(eps, mu)] in QCD band order)."""
    out = []
    for qi in range(3 * levels + 1):
        if qi == 0:
            r, orient = 0, 0
        else:
            r = (qi - 1) // 3 + 1
            orient = (qi - 1) % 3 + 1
        gain = _BAND_GAIN[orient]
        rb = depth + gain
        delta = max(scale / _band_norm(levels, r, orient), 2.0 ** -20)
        eps = rb - int(math.floor(math.log2(delta)))
        eps = max(0, min(31, eps))
        mu = int(round((delta / 2.0 ** (rb - eps) - 1.0) * 2048.0))
        mu = max(0, min(2047, mu))
        out.append((eps, mu))
    return out


def encode_j2k(img, *, reversible: bool = True,
               levels: Optional[int] = None, mct: Optional[bool] = None,
               tile: Optional[Tuple[int, int]] = None,
               cblk: Tuple[int, int] = (6, 6),
               style: int = 0,
               rate: Optional[float] = None,
               qscale: Optional[float] = None,
               sub: Optional[Sequence[Tuple[int, int]]] = None,
               sop: bool = False, eph: bool = False, ppt: bool = False,
               ppm: bool = False,
               roi: Optional[Tuple[int, int, int, int]] = None,
               roi_shift: Optional[int] = None,
               coc_styles: Optional[dict] = None,
               qcd_eps_bump: int = 0) -> bytes:
    """Encode HxW or HxWxC uint8 (components in R,G,B(,A) order; a numpy
    array, encoded on the CPU, or a tensor, encoded on its device) to a
    raw J2K codestream. Single quality layer, LRCP, whole-tile
    precincts; `style` sets the SPcod codeblock-style byte.

    `rate` (irreversible only) targets a compression ratio (raw/coded
    bytes, the OpenCV X1000 / OpenJPEG "rates" semantic) by a secant
    search on the global quantizer scale, each trial a full encode but
    for the forward transform, which the trials share; the trials take
    the other options' defaults, as in the JAX package. `qscale` pins
    the scale directly."""
    if rate is not None and rate > 1.0 and not reversible:
        if img.ndim == 2:
            raw = img.shape[0] * img.shape[1]
        else:
            raw = img.shape[0] * img.shape[1] * img.shape[2]
        fwd: dict = {}
        target = max(raw / rate, 64.0)
        pts = []  # (log2 qscale, size)
        lg = 0.0
        best = None        # largest size <= target
        smallest = None    # fallback when the header floor exceeds it
        for _ in range(8):
            b = _encode(img, fwd, reversible=False, levels=levels,
                        mct=mct, tile=tile, cblk=cblk, style=style,
                        qscale=2.0 ** lg)
            size = len(b)
            if size <= target and (best is None or size > best[0]):
                best = (size, b)
            if smallest is None or size < smallest[0]:
                smallest = (size, b)
            if size <= target and (lg == 0.0 or size >= target * 0.80):
                break  # base quality already fits, or close enough
            pts.append((lg, float(size)))
            if len(pts) >= 2 and pts[-1][1] != pts[-2][1] \
                    and pts[-1][0] != pts[-2][0]:
                (x0, y0), (x1, y1) = pts[-2], pts[-1]
                slope = (y1 - y0) / (x1 - x0)
                if slope < 0:
                    lg = x1 + (target * 0.92 - y1) / slope
                else:
                    lg = x1 + (2.0 if size > target else -1.0)
            else:
                lg += 2.0 if size > target else -1.0
            if size > target:
                lg = max(lg, pts[-1][0] + 0.5)  # guaranteed progress
            lg = max(0.0, min(16.0, lg))
        return (best or smallest)[1]
    return _encode(img, {}, reversible=reversible, levels=levels, mct=mct,
                   tile=tile, cblk=cblk, style=style, qscale=qscale,
                   sub=sub, sop=sop, eph=eph, ppt=ppt, ppm=ppm, roi=roi,
                   roi_shift=roi_shift, coc_styles=coc_styles,
                   qcd_eps_bump=qcd_eps_bump)


def _is_u8(img) -> bool:
    if isinstance(img, np.ndarray):
        return img.dtype == np.uint8
    return img.dtype == torch.uint8


def _forward(img, fwd: dict, nc, depth, use_mct, reversible, sub, levels,
             tiles):
    """The qscale-independent part of an encode, memoized in `fwd` (one
    dict per image and options): the component planes (level shift, MCT,
    subsampling) and each tile-component's forward wavelet bands, the
    tile-components of equal geometry as one stack. Sets fwd["planes"]
    and fwd["groups"]: [(members [(tile index, component)], stack bands
    per resolution {orient: (B, bh, bw)})]."""
    if "groups" in fwd:
        return
    if isinstance(img, np.ndarray):
        img = torch.from_numpy(np.ascontiguousarray(img))
    px = img.to(torch.int64) - (1 << (depth - 1))
    planes = [px[:, :, c] for c in range(nc)]
    if use_mct:
        fct = W.forward_rct if reversible else W.forward_ict
        planes[0], planes[1], planes[2] = fct(planes[0], planes[1],
                                              planes[2])
    # subsampled components keep every XRsiz/YRsiz-th sample
    # (decimation — the component grid per B.3)
    planes = [p[::sub[c][1], ::sub[c][0]] for c, p in enumerate(planes)]
    if not reversible:
        planes = [p.to(torch.float64) for p in planes]
    by_key: dict = {}
    for k, rects in enumerate(tiles):
        for c in range(nc):
            rc = rects[c]
            key = tuple((x1 - x0, y1 - y0, x0 & 1, y0 & 1) for
                        (x0, y0, x1, y1), _ in band_geometry(*rc, levels))
            by_key.setdefault(key, []).append((k, c))
    groups = []
    for members in by_key.values():
        k0, c0 = members[0]
        stack = torch.stack([planes[c][rects[c][1]:rects[c][3],
                                       rects[c][0]:rects[c][2]]
                             for rects, c in ((tiles[k], c)
                                              for k, c in members)])
        groups.append((members, forward_tile_planes(
            stack, tiles[k0][c0], levels, reversible)))
    fwd["planes"], fwd["groups"] = planes, groups


def _quantized(fwd, reversible, depths, qparams, roi: bool):
    """Every tile-component's quantized bands, on the host after one
    copy: {(tile index, component): [per resolution {orient: array}]}.
    int32 (what Tier-1 codes), int64 when the ROI upshift comes next."""
    parts, where = [], []
    off = 0
    for members, bands in fwd["groups"]:
        for r, res in enumerate(bands):
            for orient, stack in res.items():
                qi = 0 if r == 0 else 3 * (r - 1) + orient
                qs = [(depths[c], _BAND_GAIN[orient]) + tuple(qparams[c][qi])
                      for _, c in members]
                if len(set(qs)) == 1:
                    q = _quantize_band(stack, reversible, *qs[0])
                else:
                    q = torch.stack([_quantize_band(stack[m], reversible,
                                                    *qs[m])
                                     for m in range(len(members))])
                parts.append(q.reshape(-1))
                n = q[0].numel() if len(members) else 0
                for m, kc in enumerate(members):
                    where.append((kc, r, orient, off + m * n, q.shape[1:]))
                off += q.numel()
    flat = torch.cat(parts) if parts else torch.zeros(0, dtype=torch.int64)
    host = flat.to(torch.int64 if roi else torch.int32).cpu().numpy()
    out: dict = {}
    nres = len(fwd["groups"][0][1]) if fwd["groups"] else 0
    for kc, r, orient, o, shape in where:
        res = out.setdefault(kc, [dict() for _ in range(nres)])
        res[r][orient] = host[o:o + shape[0] * shape[1]].reshape(shape)
    return out


def _encode(img, fwd: dict, *, reversible, levels, mct, tile, cblk, style,
            qscale, sub=None, sop=False, eph=False, ppt=False, ppm=False,
            roi=None, roi_shift=None, coc_styles=None,
            qcd_eps_bump=0) -> bytes:
    """encode_j2k without the rate search; `fwd` memoizes the forward
    transform (_forward) across calls with the same image and options."""
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, nc = img.shape
    if not _is_u8(img):
        raise InvalidImageError("JPEG 2000 encoder: uint8 input only")
    if h < 1 or w < 1 or nc < 1 or nc > 4:
        raise InvalidImageError("JPEG 2000 encoder: bad geometry")
    depth = 8
    sub = list(sub) if sub else [(1, 1)] * nc
    if len(sub) != nc or any(not (1 <= xr <= 4 and 1 <= yr <= 4)
                             for (xr, yr) in sub):
        raise InvalidImageError("JPEG 2000 encoder: bad subsampling")
    same_grid = all(sv == sub[0] for sv in sub[:3])
    use_mct = (nc >= 3) if mct is None else (mct and nc >= 3)
    if use_mct and not same_grid:
        use_mct = False  # MCT needs co-sited components (G.2)
    if levels is None:
        levels = max(0, min(5, int(math.floor(math.log2(min(w, h))))
                            if min(w, h) > 1 else 0))
    xts, yts = (tile if tile else (w, h))
    cbw_e, cbh_e = cblk
    if not (2 <= cbw_e <= 10 and 2 <= cbh_e <= 10 and cbw_e + cbh_e <= 12):
        raise InvalidImageError("JPEG 2000 encoder: bad codeblock size")

    # ---- headers
    guard = 2
    comps_siz = b"".join(struct.pack(">BBB", depth - 1, xr, yr)
                         for (xr, yr) in sub)
    siz = struct.pack(">HIIIIIIIIH", 0, w, h, 0, 0, xts, yts, 0, 0, nc) \
        + comps_siz
    sgcod = struct.pack(">BHB", 0, 1, 1 if use_mct else 0)
    spcod = struct.pack(">BBBBB", levels, cbw_e - 2, cbh_e - 2, style,
                        1 if reversible else 0)
    scod = (0x02 if sop else 0) | (0x04 if eph else 0)
    cod = bytes([scod]) + sgcod + spcod
    nbands = 3 * levels + 1
    qparams = []

    def band_gain(qi):
        if qi == 0:
            return 0
        return _BAND_GAIN[(qi - 1) % 3 + 1]

    if reversible:
        eps_list = []
        for c in range(nc):
            d_eff = depth + (1 if (use_mct and c > 0) else 0)
            eps_list.append([d_eff + band_gain(qi) + qcd_eps_bump
                             for qi in range(nbands)])
        qcd = bytes([(guard << 5) | 0]) \
            + bytes(e << 3 for e in eps_list[0])
        qparams = [[(e, 0) for e in eps_list[c]] for c in range(nc)]
        qcc_list = [
            (c, bytes([(guard << 5) | 0])
             + bytes(e << 3 for e in eps_list[c]))
            for c in range(nc) if eps_list[c] != eps_list[0]]
    else:
        # scalar expounded 9/7 quantization, norm-weighted steps
        pairs = _lossy_qparams(levels, depth,
                               1.0 if qscale is None else qscale)
        qcd = bytes([(guard << 5) | 2]) + b"".join(
            struct.pack(">H", (e << 11) | m) for (e, m) in pairs)
        qparams = [list(pairs) for _ in range(nc)]
        qcc_list = []

    head = b"\xff\x4f" + _marker(0xFF51, siz) + _marker(0xFF52, cod) \
        + _marker(0xFF5C, qcd)
    comp_styles = [style] * nc
    if coc_styles:
        for c, st in sorted(coc_styles.items()):
            comp_styles[c] = st
            spcoc = struct.pack(">BBBBBB", 0, levels, cbw_e - 2,
                                cbh_e - 2, st, 1 if reversible else 0)
            head += _marker(0xFF53, bytes([c]) + spcoc)
    for (c, qbody) in qcc_list:
        qcc = bytes([c]) + qbody if nc < 257 else \
            struct.pack(">H", c) + qbody
        head += _marker(0xFF5D, qcc)

    # ---- tiles: rects of every component
    ntx, nty = _ceil_div(w, xts), _ceil_div(h, yts)
    tiles = []
    for t in range(ntx * nty):
        tx, ty = t % ntx, t // ntx
        tx0, ty0 = tx * xts, ty * yts
        tx1, ty1 = min(tx0 + xts, w), min(ty0 + yts, h)
        tiles.append([(_ceil_div(tx0, xr), _ceil_div(ty0, yr),
                       _ceil_div(tx1, xr), _ceil_div(ty1, yr))
                      for xr, yr in sub])
    # ---- component planes and forward wavelet, on the image's device
    _forward(img, fwd, nc, depth, use_mct, reversible, sub, levels, tiles)

    # maxshift ROI: the shift must clear every background coefficient
    # (the decoder separates ROI samples by the 2^shift threshold)
    roi_shifts = None
    if roi is not None:
        if not reversible:
            raise InvalidImageError(
                "JPEG 2000 encoder: ROI fixtures are reversible-only")
        roi_shifts = []
        for c in range(nc):
            p = fwd["planes"][c]
            mx = int(p.abs().max()) if p.numel() else 0
            # conservative: any 5/3 coefficient magnitude is bounded by
            # 4x the plane's max absolute sample. +1 margin because
            # OpenJPEG applies its ROI threshold in the x2-scaled T1
            # domain (background must stay below 2^(shift-1) there)
            s_c = roi_shift if roi_shift is not None \
                else (4 * mx + 1).bit_length() + 1
            roi_shifts.append(s_c)
        for c in range(nc):
            head += _marker(0xFF5E, bytes([c, 0, roi_shifts[c]]))

    cod_dict = {"levels": levels, "cbw_e": cbw_e, "cbh_e": cbh_e,
                "transform": 1 if reversible else 0, "guard": guard,
                "style": style}
    if ppm and ppt:
        raise InvalidImageError("JPEG 2000 encoder: PPM xor PPT")

    # ---- quantize (device), then Tier-1 on the host
    qbands = _quantized(fwd, reversible, [depth] * nc, qparams,
                        roi is not None)
    encoders, jobs = [], []
    for k, rects in enumerate(tiles):
        comps = []
        for c in range(nc):
            tile_rect = rects[c]
            shift = roi_shifts[c] if roi_shifts else 0
            res_list = []
            for r, (rrect, binfo) in enumerate(_build_bands(
                    tile_rect, levels, cbw_e, cbh_e)):
                nb2 = levels - r + (1 if r else 0)
                bands = []
                for (orient, brect, grid) in binfo:
                    qi = 0 if r == 0 else 3 * (r - 1) + orient
                    eps, _ = qparams[c][qi]
                    mb = guard + eps - 1 + shift
                    q = qbands[(k, c)][r][orient]
                    bx0, by0, bx1, by1 = brect
                    if roi and shift and q.size:
                        # maxshift: upshift coefficients whose band
                        # coords fall in the (scaled) ROI rect — any
                        # encoder-side mask is legal; the decoder
                        # recovers values by the 2^shift threshold
                        rx0, ry0, rx1, ry1 = roi
                        sbx0 = max(rx0 >> nb2, bx0)
                        sby0 = max(ry0 >> nb2, by0)
                        sbx1 = min(_ceil_div(rx1, 1 << nb2), bx1)
                        sby1 = min(_ceil_div(ry1, 1 << nb2), by1)
                        if sbx1 > sbx0 and sby1 > sby0:
                            q[sby0 - by0:sby1 - by0,
                              sbx0 - bx0:sbx1 - bx0] <<= shift
                    cgx0, cgy0, gw, gh = grid
                    cblks = []
                    cbw, cbh = 1 << cbw_e, 1 << cbh_e
                    for gy in range(gh):
                        for gx in range(gw):
                            x0 = max((cgx0 + gx) * cbw, bx0)
                            y0 = max((cgy0 + gy) * cbh, by0)
                            x1 = min((cgx0 + gx + 1) * cbw, bx1)
                            y1 = min((cgy0 + gy + 1) * cbh, by1)
                            cb = _EncBlock(x0, y0, x1, y1)
                            jobs.append((cb, q[y0 - by0:y1 - by0,
                                               x0 - bx0:x1 - bx0],
                                         orient, mb, comp_styles[c]))
                            cblks.append(cb)
                    bands.append({"orient": orient, "rect": brect,
                                  "grid": grid, "cblks": cblks})
                res_list.append({"rect": rrect, "bands": bands})
            comps.append(res_list)
        encoders.append(_TileEncoder(comps, cod_dict))
    _code_blocks(jobs)

    # ---- packets and tile-parts
    body = b""
    ppm_chunks = []
    nsop = 0
    for t, te in enumerate(encoders):
        hdrs = []
        bodies = []
        for (hd, bd) in te.packets():
            if sop:
                bodies.append(_marker(0xFF91, struct.pack(">H",
                                                          nsop & 0xFFFF)))
                nsop += 1
            if eph:
                hd += b"\xff\x92"
            hdrs.append(hd)
            bodies.append(bd)
        if ppm:
            # one Nppm-prefixed chunk per tile-part (A.7.4)
            blob = b"".join(hdrs)
            ppm_chunks.append(struct.pack(">I", len(blob)) + blob)
            pk = b"".join(bodies)
            sot_body = struct.pack(">HIBB", t, 12 + 2 + len(pk), 0, 1)
            body += _marker(0xFF90, sot_body) + b"\xff\x93" + pk
        elif ppt:
            ppt_seg = _marker(0xFF61, bytes([0]) + b"".join(hdrs))
            pk = b"".join(bodies)
            sot_body = struct.pack(">HIBB", t, 12 + len(ppt_seg) + 2
                                   + len(pk), 0, 1)
            body += _marker(0xFF90, sot_body) + ppt_seg \
                + b"\xff\x93" + pk
        else:
            # interleave: header then body per packet
            pk_parts = []
            bi = 0
            for hd in hdrs:
                if sop:
                    pk_parts.append(bodies[bi])
                    bi += 1
                pk_parts.append(hd)
                pk_parts.append(bodies[bi])
                bi += 1
            pk = b"".join(pk_parts)
            sot_body = struct.pack(">HIBB", t, 12 + 2 + len(pk), 0, 1)
            body += _marker(0xFF90, sot_body) + b"\xff\x93" + pk
    if ppm_chunks:
        stream = b"".join(ppm_chunks)
        # split across PPM segments if oversized (Lppm is 16-bit)
        z = 0
        while stream:
            part, stream = stream[:65000], stream[65000:]
            head += _marker(0xFF60, bytes([z]) + part)
            z += 1
    return head + body + b"\xff\xd9"




def _code_blocks(jobs) -> None:
    """Tier-1 of every codeblock (jp2_t1.run_jobs); the results land on
    the blocks, the bytes as one thread would give them."""
    def one(job):
        cb, coefs, orient, mb, st = job
        segs, np_, zp = _t1_encode(coefs, orient, mb, st)
        cb.segs = segs
        cb.numpasses = np_
        cb.zero_planes = zp if np_ else mb

    jp2_t1.run_jobs(one, jobs)


def _box(typ: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", len(payload) + 8) + typ + payload


def encode_jp2(img: np.ndarray, **kw) -> bytes:
    """J2K codestream wrapped in the JP2 container (signature + ftyp +
    jp2h(ihdr, colr) + jp2c)."""
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, nc = img.shape
    cs = encode_j2k(img, **kw)
    ihdr = struct.pack(">IIHBBBB", h, w, nc, 7, 7, 0, 0)
    colr = struct.pack(">BBBI", 1, 0, 0, 16 if nc >= 3 else 17)
    jp2h = _box(b"ihdr", ihdr) + _box(b"colr", colr)
    out = (b"\x00\x00\x00\x0cjP  \r\n\x87\n"
           + _box(b"ftyp", b"jp2 " + struct.pack(">I", 0) + b"jp2 ")
           + _box(b"jp2h", jp2h)
           + _box(b"jp2c", cs))
    return out
