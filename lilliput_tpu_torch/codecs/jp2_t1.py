"""JPEG 2000 Tier-1 (EBCOT) codeblock coder: the counterpart of
``lilliput_tpu/codecs/jp2_t1.py``.

MQ arithmetic coder + the three coding passes (significance
propagation, magnitude refinement, cleanup) per ISO/IEC 15444-1 Annexes
C/D. ``decode_codeblock`` and ``encode_codeblock`` run the C++ coder of
``csrc/host/jp2_t1.cpp`` (a byte-for-byte copy of the JAX package's
``native/src/jp2_t1.cpp``) through ``binding``; a host library that does
not load raises, and nothing falls back to Python. The pure-Python forms
(``_decode_codeblock_py``, ``encode_codeblock_py``) are the plain
versions the tests hold the C++ coder to. Tier-1 runs on the host: it is
serial entropy coding, one codeblock per call (a thread pool spreads
codeblocks over the host's cores), while the port runs the dense stages
after it, dequantization and the inverse wavelet, as torch ops on the
decoder's device (``codecs/jp2.py``, ``ops/wavelet.py``).
"""

from __future__ import annotations

import os

import numpy as np

from .. import binding
from ..errors import DecodingFailedError

# Annex C, Table C-2: (Qe, NMPS, NLPS, SWITCH)
MQ_STATES = [
    (0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0),
    (0x0AC1, 4, 12, 0), (0x0521, 5, 29, 0), (0x0221, 38, 33, 0),
    (0x5601, 7, 6, 1), (0x5401, 8, 14, 0), (0x4801, 9, 14, 0),
    (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
    (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1),
    (0x5401, 16, 14, 0), (0x5101, 17, 15, 0), (0x4801, 18, 16, 0),
    (0x3801, 19, 17, 0), (0x3401, 20, 18, 0), (0x3001, 21, 19, 0),
    (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
    (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0),
    (0x1401, 28, 25, 0), (0x1201, 29, 26, 0), (0x1101, 30, 27, 0),
    (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0), (0x08A1, 33, 30, 0),
    (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
    (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0),
    (0x0085, 40, 37, 0), (0x0049, 41, 38, 0), (0x0025, 42, 39, 0),
    (0x0015, 43, 40, 0), (0x0009, 44, 41, 0), (0x0005, 45, 42, 0),
    (0x0001, 45, 43, 0), (0x5601, 46, 46, 0),
]

# context indices (OpenJPEG numbering): 0..8 zero coding, 9..13 sign
# coding, 14..16 magnitude refinement, 17 run-length (UNI... here:
# RL=17, UNI=18)
N_CTX = 19
CTX_UNI = 18
CTX_RL = 17
CTX_MR = 14  # 14,15,16
CTX_SC = 9   # 9..13


def _fresh_ctx():
    ctx = [(0, 0)] * N_CTX
    ctx[CTX_UNI] = (46, 0)
    ctx[CTX_RL] = (3, 0)
    ctx[0] = (4, 0)
    return ctx


class MQDecoder:
    """Annex C software-conventions MQ decoder (matches OpenJPEG).
    `ctx` adopts an existing context-state list so states persist
    across codeword segments (termall/bypass styles re-init only the
    register state per segment, D.4.1)."""

    def __init__(self, data: bytes, ctx=None):
        self.data = data
        self.n = len(data)
        self.bp = 0
        b0 = data[0] if self.n else 0xFF
        self.c = b0 << 16
        self._bytein()
        self.c <<= 7
        self.ct -= 7
        self.a = 0x8000
        # ctx state: (index, mps)
        self.ctx = ctx if ctx is not None else _fresh_ctx()

    def reset_ctx(self):
        self.ctx[:] = _fresh_ctx()

    def _bytein(self):
        d, n = self.data, self.n
        bp = self.bp
        if bp < n and d[bp] == 0xFF:
            if bp + 1 >= n or d[bp + 1] > 0x8F:
                self.c += 0xFF00
                self.ct = 8
            else:
                self.bp = bp + 1
                self.c += d[bp + 1] << 9
                self.ct = 7
        else:
            self.bp = bp + 1
            nxt = d[bp + 1] if bp + 1 < n else 0xFF
            self.c += nxt << 8
            self.ct = 8

    def decode(self, cx: int) -> int:
        idx, mps = self.ctx[cx]
        qe, nmps, nlps, sw = MQ_STATES[idx]
        self.a -= qe
        if ((self.c >> 16) & 0xFFFF) < qe:
            # LPS exchange path
            if self.a < qe:
                d = mps
                self.ctx[cx] = (nmps, mps)
            else:
                d = 1 - mps
                if sw:
                    mps = 1 - mps
                self.ctx[cx] = (nlps, mps)
            self.a = qe
        else:
            self.c -= qe << 16
            if self.a & 0x8000:
                return mps
            if self.a < qe:
                d = 1 - mps
                if sw:
                    mps = 1 - mps
                self.ctx[cx] = (nlps, mps)
            else:
                d = mps
                self.ctx[cx] = (nmps, mps)
        # renormalize
        while True:
            if self.ct == 0:
                self._bytein()
            self.a <<= 1
            self.c = (self.c << 1) & 0xFFFFFFFF
            self.ct -= 1
            if self.a & 0x8000:
                break
        return d


# zero-coding context tables (OpenJPEG lut_ctxno_zc equivalents),
# computed from the spec rules per band orientation
def _zc_context(band: int, h: int, v: int, d: int) -> int:
    # band: 0=LL/LH-style (use h), 1=HL (swap h/v), 2=HH
    if band == 1:
        h, v = v, h
    if band != 2:
        if h == 2:
            return 8
        if h == 1:
            if v >= 1:
                return 7
            return 6 if d >= 1 else 5
        if v == 2:
            return 4
        if v == 1:
            return 3
        return min(d, 2)
    # HH
    if d >= 3:
        return 8
    if d == 2:
        return 7 if h + v >= 1 else 6
    if d == 1:
        if h + v >= 2:
            return 5
        return 4 if h + v == 1 else 3
    if h + v >= 2:
        return 2
    return h + v  # 0 or 1


def _sc_context(h0, h1, v0, v1):
    """Sign-coding: returns (context 9..13, xorbit) from neighbor
    significance/sign (each in {-1, 0, +1})."""
    hc = min(max(h0 + h1, -1), 1)
    vc = min(max(v0 + v1, -1), 1)
    if hc == 1:
        if vc == 1:
            return 13, 0
        if vc == 0:
            return 12, 0
        return 11, 0
    if hc == 0:
        if vc == 1:
            return 10, 0
        if vc == 0:
            return 9, 0
        return 10, 1
    if vc == 1:
        return 11, 1
    if vc == 0:
        return 12, 1
    return 13, 1


class MQEncoder:
    """Annex C MQ encoder (software conventions, mirrors opj mqc.c).

    The byte before a fresh segment is a 0x00 sentinel (dropped at
    flush); for continuation segments (termall) pass the previous
    segment's final byte so CT initializes to 13 after 0xFF (C.2.8)."""

    def __init__(self, prev_byte: int = 0):
        self.buf = bytearray([prev_byte])
        self.bp = 0
        self.c = 0
        self.a = 0x8000
        self.ct = 13 if prev_byte == 0xFF else 12
        self.ctx = [(0, 0)] * N_CTX
        self.reset_ctx()

    def reset_ctx(self):
        for i in range(N_CTX):
            self.ctx[i] = (0, 0)
        self.ctx[CTX_UNI] = (46, 0)
        self.ctx[CTX_RL] = (3, 0)
        self.ctx[0] = (4, 0)

    def _byteout(self):
        b = self.buf
        if b[self.bp] == 0xFF:
            self.bp += 1
            b.append((self.c >> 20) & 0xFF)
            self.c &= 0xFFFFF
            self.ct = 7
        elif (self.c & 0x8000000) == 0:
            self.bp += 1
            b.append((self.c >> 19) & 0xFF)
            self.c &= 0x7FFFF
            self.ct = 8
        else:
            b[self.bp] += 1
            if b[self.bp] == 0xFF:
                self.c &= 0x7FFFFFF
                self.bp += 1
                b.append((self.c >> 20) & 0xFF)
                self.c &= 0xFFFFF
                self.ct = 7
            else:
                self.bp += 1
                b.append((self.c >> 19) & 0xFF)
                self.c &= 0x7FFFF
                self.ct = 8

    def _renorm(self):
        while True:
            self.a = (self.a << 1) & 0xFFFF
            self.c = (self.c << 1) & 0xFFFFFFFF
            self.ct -= 1
            if self.ct == 0:
                self._byteout()
            if self.a & 0x8000:
                break

    def encode(self, d: int, cx: int):
        idx, mps = self.ctx[cx]
        qe, nmps, nlps, sw = MQ_STATES[idx]
        self.a -= qe
        if d == mps:
            if (self.a & 0x8000) == 0:
                if self.a < qe:
                    self.a = qe
                else:
                    self.c += qe
                self.ctx[cx] = (nmps, mps)
                self._renorm()
            else:
                self.c += qe
        else:
            if self.a < qe:
                self.c += qe
            else:
                self.a = qe
            if sw:
                mps = 1 - mps
            self.ctx[cx] = (nlps, mps)
            self._renorm()

    def flush(self) -> bytes:
        """Standard Elias termination (C.2.9 FLUSH); returns the
        segment bytes (sentinel dropped, trailing 0xFF excluded)."""
        tempc = self.c + self.a
        self.c |= 0xFFFF
        if self.c >= tempc:
            self.c -= 0x8000
        self.c = (self.c << self.ct) & 0xFFFFFFFF
        self._byteout()
        self.c = (self.c << self.ct) & 0xFFFFFFFF
        self._byteout()
        end = self.bp + 1 if self.buf[self.bp] != 0xFF else self.bp
        return bytes(self.buf[1:end])


class RawEncoder:
    """Raw (bypass) bit writer, D.6 — mirror of RawDecoder: MSB-first,
    a byte following 0xFF carries 7 bits; flush zero-pads and never
    ends the segment on 0xFF."""

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nacc = 0
        self.last = 0

    def _cap(self):
        return 7 if self.last == 0xFF else 8

    def bit(self, b):
        self.acc = (self.acc << 1) | (b & 1)
        self.nacc += 1
        if self.nacc == self._cap():
            self.out.append(self.acc)
            self.last = self.acc
            self.acc = 0
            self.nacc = 0

    def flush(self) -> bytes:
        if self.nacc:
            self.acc <<= self._cap() - self.nacc
            self.out.append(self.acc)
            self.last = self.acc
            self.acc = 0
            self.nacc = 0
        if self.last == 0xFF:
            self.out.append(0)
            self.last = 0
        return bytes(self.out)


def encode_codeblock_py(coefs: np.ndarray, band: int, mb: int,
                        style: int = 0):
    """Encode one codeblock (signed int coefficients, (h, w)), all
    passes, per Annex D (mirror of _decode_codeblock_py) with full
    codeblock-style support. Returns (segments, numpasses,
    zero_planes) where segments is [(bytes, passes)] per codeword
    segment (termination points per the opj rule: every pass for
    termall; pass 10 then each raw pair / MQ cleanup for bypass).
    Empty blocks return ([], 0, mb)."""
    coefs = np.asarray(coefs, np.int64)
    h, w = coefs.shape
    mag_all = np.abs(coefs)
    sgn_in = np.where(coefs < 0, -1, 1).astype(np.int8)
    maxmag = int(mag_all.max()) if mag_all.size else 0
    nb = maxmag.bit_length()
    if nb == 0:
        return [], 0, mb
    if nb > mb:
        raise ValueError(f"codeblock needs {nb} bitplanes > Mb={mb}")
    zero_planes = mb - nb
    vsc = bool(style & STY_VSC)

    sig = np.zeros((h, w), np.uint8)
    vis = np.zeros((h, w), np.uint8)
    first_ref = np.ones((h, w), np.uint8)
    sgn_out = np.zeros((h, w), np.int8)
    ctx = _fresh_ctx()
    state = {"mq": None, "raw": None}

    def neigh_sig(x, y):
        s = vsc and (y & 3) == 3
        hn = ((sig[y, x - 1] if x > 0 else 0)
              + (sig[y, x + 1] if x + 1 < w else 0))
        vn = ((sig[y - 1, x] if y > 0 else 0)
              + (sig[y + 1, x] if y + 1 < h and not s else 0))
        dn = ((sig[y - 1, x - 1] if x > 0 and y > 0 else 0)
              + (sig[y - 1, x + 1] if x + 1 < w and y > 0 else 0))
        if not s:
            dn += ((sig[y + 1, x - 1] if x > 0 and y + 1 < h else 0)
                   + (sig[y + 1, x + 1] if x + 1 < w and y + 1 < h
                      else 0))
        return hn, vn, dn

    def encode_sign(x, y):
        s = vsc and (y & 3) == 3

        def sv(xx, yy):
            if s and yy > y:
                return 0
            if 0 <= xx < w and 0 <= yy < h and sig[yy, xx]:
                return int(sgn_out[yy, xx])
            return 0
        cx, xorbit = _sc_context(sv(x - 1, y), sv(x + 1, y),
                                 sv(x, y - 1), sv(x, y + 1))
        bit = (1 if sgn_in[y, x] < 0 else 0) ^ xorbit
        state["mq"].encode(bit, cx)
        sgn_out[y, x] = sgn_in[y, x]

    def spp(p, is_raw):
        for y0 in range(0, h, 4):
            for x in range(w):
                for y in range(y0, min(y0 + 4, h)):
                    if sig[y, x]:
                        continue
                    hn, vn, dn = neigh_sig(x, y)
                    if hn + vn + dn == 0:
                        continue
                    vis[y, x] = 1
                    bit = int((mag_all[y, x] >> p) & 1)
                    if is_raw:
                        state["raw"].bit(bit)
                        if bit:
                            sig[y, x] = 1
                            state["raw"].bit(1 if sgn_in[y, x] < 0
                                             else 0)
                            sgn_out[y, x] = sgn_in[y, x]
                        continue
                    state["mq"].encode(bit, _zc_context(band, hn, vn, dn))
                    if bit:
                        sig[y, x] = 1
                        encode_sign(x, y)

    def mrp(p, is_raw):
        for y0 in range(0, h, 4):
            for x in range(w):
                for y in range(y0, min(y0 + 4, h)):
                    if not sig[y, x] or vis[y, x]:
                        continue
                    bit = int((mag_all[y, x] >> p) & 1)
                    if is_raw:
                        state["raw"].bit(bit)
                        vis[y, x] = 1
                        continue
                    if first_ref[y, x]:
                        hn, vn, dn = neigh_sig(x, y)
                        cx = 15 if hn + vn + dn else 14
                        first_ref[y, x] = 0
                    else:
                        cx = 16
                    state["mq"].encode(bit, cx)
                    vis[y, x] = 1

    def cleanup(p):
        mq = state["mq"]
        for y0 in range(0, h, 4):
            x = 0
            while x < w:
                y = y0
                if y0 + 4 <= h:
                    runlen_ok = True
                    for yy in range(y0, y0 + 4):
                        if sig[yy, x] or vis[yy, x]:
                            runlen_ok = False
                            break
                        hn, vn, dn = neigh_sig(x, yy)
                        if hn + vn + dn:
                            runlen_ok = False
                            break
                    if runlen_ok:
                        r = -1
                        for yy in range(y0, y0 + 4):
                            if (mag_all[yy, x] >> p) & 1:
                                r = yy - y0
                                break
                        if r < 0:
                            mq.encode(0, CTX_RL)
                            x += 1
                            continue
                        mq.encode(1, CTX_RL)
                        mq.encode((r >> 1) & 1, CTX_UNI)
                        mq.encode(r & 1, CTX_UNI)
                        y = y0 + r
                        sig[y, x] = 1
                        encode_sign(x, y)
                        y += 1
                for yy in range(y, min(y0 + 4, h)):
                    if sig[yy, x] or vis[yy, x]:
                        vis[yy, x] = 0
                        continue
                    hn, vn, dn = neigh_sig(x, yy)
                    bit = int((mag_all[yy, x] >> p) & 1)
                    mq.encode(bit, _zc_context(band, hn, vn, dn))
                    if bit:
                        sig[yy, x] = 1
                        encode_sign(x, yy)
                x += 1
        vis[:] = 0
        if style & STY_SEGSYM:
            mq.encode(1, CTX_UNI)
            mq.encode(0, CTX_UNI)
            mq.encode(1, CTX_UNI)
            mq.encode(0, CTX_UNI)

    segments = []
    seg_passes = 0
    prev_byte = 0
    bpno = nb - 1
    passtype = 2
    passidx = 0
    numpasses = 3 * nb - 2

    def want_raw():
        return (bool(style & STY_LAZY) and passtype < 2
                and passidx >= 10)

    def open_coder():
        if want_raw():
            state["raw"] = RawEncoder()
            state["mq"] = None
        else:
            enc = MQEncoder(prev_byte)
            enc.ctx = ctx
            state["mq"] = enc
            state["raw"] = None

    def close_coder():
        nonlocal prev_byte, seg_passes
        if state["raw"] is not None:
            data = state["raw"].flush()
        else:
            data = state["mq"].flush()
        segments.append((data, seg_passes))
        if data:
            prev_byte = data[-1]
        seg_passes = 0

    open_coder()
    while bpno >= 0:
        is_raw = state["raw"] is not None
        if passtype == 0:
            spp(bpno, is_raw)
        elif passtype == 1:
            mrp(bpno, is_raw)
        else:
            cleanup(bpno)
        if style & STY_RESET and state["mq"] is not None:
            state["mq"].ctx[:] = _fresh_ctx()
        seg_passes += 1
        passidx += 1
        last_pass = (passtype == 2 and bpno == 0)
        # opj termination rule: termall -> every pass; bypass -> after
        # pass 9 (cleanup of plane nb-4), then after each raw MRP and
        # each MQ cleanup
        term = False
        if style & STY_TERMALL:
            term = not last_pass
        elif style & STY_LAZY:
            term = ((bpno < nb - 4 and passtype > 0)
                    or (bpno == nb - 4 and passtype == 2))
        passtype += 1
        if passtype == 3:
            passtype = 0
            bpno -= 1
        if last_pass or term:
            close_coder()
            if not last_pass:
                open_coder()
    return segments, numpasses, zero_planes


def run_jobs(fn, jobs) -> None:
    """fn over the codeblock jobs on the JAX package's Tier-1 pool (twice
    the host's cores when there are more than 8 jobs, else this thread):
    the C++ coder releases the GIL through ctypes. The first job in order
    that raises raises here."""
    nw = min(len(jobs), (os.cpu_count() or 1) * 2)
    if nw > 1 and len(jobs) > 8:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(nw) as ex:
            list(ex.map(fn, jobs))
    else:
        for job in jobs:
            fn(job)


def encode_codeblock(coefs, band: int, mb: int, style: int = 0):
    """Encode one codeblock; returns (segments, numpasses,
    zero_planes) where segments is a list of (bytes, passes) codeword
    segments (one element for the default style).

    The C++ coder codes every codeblock-style bit (bypass, reset,
    termall, vsc, pterm, segsym), so no style takes the Python route.
    What does, as in the JAX package, is a return code other than 0 and
    -2: -1 (Mb outside 1..31, or a side outside 1..4096) and -4 (more
    than 256 codeword segments, or output past the buffer), which
    encode_codeblock_py then codes."""
    import ctypes as c
    coefs = np.ascontiguousarray(coefs, np.int32)
    h, w = coefs.shape
    lib = binding.load()
    cap = w * h * 8 + 1024
    out = np.empty(cap, np.uint8)
    max_segs = 256
    seg_lens = np.zeros(max_segs, np.int32)
    seg_passes = np.zeros(max_segs, np.int32)
    out_len = c.c_int32()
    out_np = c.c_int32()
    out_zp = c.c_int32()
    n_segs = c.c_int32()
    rc = lib.lp_jp2_t1_encode(
        coefs.ctypes.data_as(c.POINTER(c.c_int32)), w, h, band, mb,
        style, out.ctypes.data_as(c.POINTER(c.c_uint8)), cap,
        c.byref(out_len), c.byref(out_np), c.byref(out_zp),
        seg_lens.ctypes.data_as(c.POINTER(c.c_int32)),
        seg_passes.ctypes.data_as(c.POINTER(c.c_int32)),
        c.byref(n_segs), max_segs)
    if rc == 0:
        segs = []
        pos = 0
        for i in range(n_segs.value):
            ln = int(seg_lens[i])
            segs.append((out[pos:pos + ln].tobytes(), int(seg_passes[i])))
            pos += ln
        return segs, out_np.value, out_zp.value
    if rc == -2:
        raise ValueError("codeblock bitplanes exceed Mb")
    return encode_codeblock_py(coefs, band, mb, style)


def decode_codeblock(data: bytes, w: int, h: int, band: int,
                     missing_bitplanes: int, numpasses: int,
                     mb: int, style: int = 0, segs=None) -> np.ndarray:
    """Decode one codeblock with the C++ coder: (h, w) int32 in opj's
    2x domain (see _decode_codeblock_py). A codeblock outside the
    decodable profile raises DecodingFailedError."""
    import ctypes as c
    lib = binding.load()
    arr = np.frombuffer(data, np.uint8) if data else np.zeros(1, np.uint8)
    out = np.empty((h, w), np.int32)
    if segs is None:
        segs = [(len(data), numpasses)]
    seg_lens = np.ascontiguousarray([s[0] for s in segs], np.int32)
    seg_passes = np.ascontiguousarray([s[1] for s in segs], np.int32)
    rc = lib.lp_jp2_t1_decode2(
        arr.ctypes.data_as(c.POINTER(c.c_uint8)), len(data),
        seg_lens.ctypes.data_as(c.POINTER(c.c_int32)),
        seg_passes.ctypes.data_as(c.POINTER(c.c_int32)),
        len(segs), w, h, band, missing_bitplanes, numpasses, mb,
        style, out.ctypes.data_as(c.POINTER(c.c_int32)))
    if rc != 0:
        raise DecodingFailedError(
            f"JPEG 2000: codeblock outside decodable profile ({rc})")
    return out


class RawDecoder:
    """Raw (bypass) bit reader, D.6 — port of opj raw decode: bytes
    MSB-first; after a 0xFF byte the next byte carries 7 bits; reads
    past the end feed 0xFF."""

    def __init__(self, data: bytes):
        self.d = data
        self.pos = 0
        self.c = 0
        self.ct = 0

    def bit(self) -> int:
        if self.ct == 0:
            self.ct = 8
            if self.pos >= len(self.d):
                self.c = 0xFF
            else:
                if self.c == 0xFF:
                    self.ct = 7
                self.c = self.d[self.pos]
                self.pos += 1
        self.ct -= 1
        return (self.c >> self.ct) & 1


# style bits (SPcod Table A.19) — shared with codecs/jp2_enc.py
STY_LAZY = 0x01
STY_RESET = 0x02
STY_TERMALL = 0x04
STY_VSC = 0x08
STY_PTERM = 0x10
STY_SEGSYM = 0x20


def seg_maxpasses(style: int, seg_index: int) -> int:
    """Codeword-segment pass capacity (opj opj_t2_init_seg): termall
    -> 1; bypass -> 10 then alternating 2 (raw SPP+MRP) / 1 (MQ
    cleanup); default -> 109."""
    if style & STY_TERMALL:
        return 1
    if style & STY_LAZY:
        if seg_index == 0:
            return 10
        return 2 if seg_index % 2 == 1 else 1
    return 109


def _decode_codeblock_py(data: bytes, w: int, h: int, band: int,
                         missing_bitplanes: int, numpasses: int,
                         mb: int, style: int = 0,
                         segs=None) -> np.ndarray:
    """Decode one codeblock to signed integer coefficients (h, w) int32.

    band: 0 LL/LH, 1 HL, 2 HH (context orientation). mb: max magnitude
    bitplanes for the subband (guard bits + exponent - 1);
    missing_bitplanes: from the zero-bitplane tag tree. style: SPcod
    codeblock-style byte (bypass/reset/termall/vsc/segsym all
    supported); segs: [(byte_length, passes)] codeword segments within
    `data` (None = one segment holding every pass, the default-style
    layout)."""
    mag = np.zeros((h, w), np.int32)
    sig = np.zeros((h, w), np.uint8)    # significant
    sgn = np.zeros((h, w), np.int8)     # sign: +1 / -1 once significant
    vis = np.zeros((h, w), np.uint8)    # coded in current bitplane
    lastp = np.zeros((h, w), np.int8)   # lowest plane decoded per coef
    nb = mb - missing_bitplanes  # number of bitplanes actually coded
    if nb <= 0 or numpasses <= 0:
        return mag
    if segs is None:
        segs = [(len(data), numpasses)]
    vsc = bool(style & STY_VSC)
    ctx = _fresh_ctx()
    mq = None   # type: Optional[MQDecoder]
    raw = None  # type: Optional[RawDecoder]

    def neigh_sig(x, y):
        # VSC: the row below a stripe boundary is treated insignificant
        # for context formation (D.7)
        s = vsc and (y & 3) == 3
        hn = ((sig[y, x - 1] if x > 0 else 0)
              + (sig[y, x + 1] if x + 1 < w else 0))
        vn = ((sig[y - 1, x] if y > 0 else 0)
              + (sig[y + 1, x] if y + 1 < h and not s else 0))
        dn = ((sig[y - 1, x - 1] if x > 0 and y > 0 else 0)
              + (sig[y - 1, x + 1] if x + 1 < w and y > 0 else 0))
        if not s:
            dn += ((sig[y + 1, x - 1] if x > 0 and y + 1 < h else 0)
                   + (sig[y + 1, x + 1] if x + 1 < w and y + 1 < h
                      else 0))
        return hn, vn, dn

    def decode_sign(x, y):
        s = vsc and (y & 3) == 3

        def sv(xx, yy):
            if s and yy > y:
                return 0
            if 0 <= xx < w and 0 <= yy < h and sig[yy, xx]:
                return int(sgn[yy, xx])
            return 0
        cx, xorbit = _sc_context(sv(x - 1, y), sv(x + 1, y),
                                 sv(x, y - 1), sv(x, y + 1))
        bit = mq.decode(cx) ^ xorbit
        sgn[y, x] = -1 if bit else 1

    def spp(p, is_raw):
        bit = 1 << p
        for y0 in range(0, h, 4):
            for x in range(w):
                for y in range(y0, min(y0 + 4, h)):
                    if sig[y, x]:
                        continue
                    hn, vn, dn = neigh_sig(x, y)
                    if hn + vn + dn == 0:
                        continue
                    vis[y, x] = 1
                    if is_raw:
                        if raw.bit():
                            sig[y, x] = 1
                            mag[y, x] |= bit
                            lastp[y, x] = p
                            sgn[y, x] = -1 if raw.bit() else 1
                    elif mq.decode(_zc_context(band, hn, vn, dn)):
                        sig[y, x] = 1
                        mag[y, x] |= bit
                        lastp[y, x] = p
                        decode_sign(x, y)

    def mrp(p, first_ref, is_raw):
        # OpenJPEG context rule: refinement ctx 14 (no sig neighbors) /
        # 15 (some) on the FIRST refinement of a sample, 16 afterwards.
        # (opj applies no VSC masking to the refinement context — the
        # oracle behavior we must match.)
        bit = 1 << p
        for y0 in range(0, h, 4):
            for x in range(w):
                for y in range(y0, min(y0 + 4, h)):
                    if not sig[y, x] or vis[y, x]:
                        continue
                    if is_raw:
                        if raw.bit():
                            mag[y, x] |= bit
                        lastp[y, x] = p
                        vis[y, x] = 1
                        continue
                    if first_ref[y, x]:
                        hn, vn, dn = neigh_sig(x, y)
                        cx = 15 if hn + vn + dn else 14
                        first_ref[y, x] = 0
                    else:
                        cx = 16
                    if mq.decode(cx):
                        mag[y, x] |= bit
                    lastp[y, x] = p
                    vis[y, x] = 1

    def cleanup(p):
        bit = 1 << p
        for y0 in range(0, h, 4):
            x = 0
            while x < w:
                y = y0
                # run-length mode: whole 4-column unvisited & insignificant
                # with no significant neighbors
                if (y0 + 4 <= h):
                    runlen_ok = True
                    for yy in range(y0, y0 + 4):
                        if sig[yy, x] or vis[yy, x]:
                            runlen_ok = False
                            break
                        hn, vn, dn = neigh_sig(x, yy)
                        if hn + vn + dn:
                            runlen_ok = False
                            break
                    if runlen_ok:
                        if not mq.decode(CTX_RL):
                            x += 1
                            continue
                        r = (mq.decode(CTX_UNI) << 1) | mq.decode(CTX_UNI)
                        y = y0 + r
                        # first significant sample of the run
                        sig[y, x] = 1
                        mag[y, x] |= bit
                        lastp[y, x] = p
                        decode_sign(x, y)
                        y += 1
                for yy in range(y, min(y0 + 4, h)):
                    if sig[yy, x] or vis[yy, x]:
                        vis[yy, x] = 0
                        continue
                    hn, vn, dn = neigh_sig(x, yy)
                    if mq.decode(_zc_context(band, hn, vn, dn)):
                        sig[yy, x] = 1
                        mag[yy, x] |= bit
                        lastp[yy, x] = p
                        decode_sign(x, yy)
                x += 1
        vis[:] = 0
        if style & STY_SEGSYM:
            # segmentation symbol 1010: decode and discard (opj warns
            # on mismatch but still returns the data)
            for _ in range(4):
                mq.decode(CTX_UNI)

    first_ref = np.ones((h, w), np.uint8)
    bpno = nb - 1
    passtype = 2
    passidx = 0
    pos = 0
    for (seg_len, seg_passes) in segs:
        if passidx >= numpasses or bpno < 0:
            break
        seg_data = data[pos:pos + seg_len]
        pos += seg_len
        is_raw = bool(style & STY_LAZY) and passtype < 2 and passidx >= 10
        if is_raw:
            raw = RawDecoder(seg_data)
        else:
            mq = MQDecoder(seg_data, ctx=ctx)
        for _ in range(seg_passes):
            if passidx >= numpasses or bpno < 0:
                break
            if passtype == 0:
                spp(bpno, is_raw)
            elif passtype == 1:
                mrp(bpno, first_ref, is_raw)
            else:
                cleanup(bpno)
            if style & STY_RESET and not is_raw:
                mq.reset_ctx()
            passidx += 1
            passtype += 1
            if passtype == 3:
                passtype = 0
                bpno -= 1
    # opj-parity reconstruction domain: value_2x = 2*mag + 2^lastp for
    # decoded coefficients (the uncertainty midpoint sits at the LAST
    # decoded plane — for truncated streams this differs from a flat
    # +0.5 by up to a factor 2^lastp and is what the oracle does)
    out2x = np.where(mag != 0,
                     2 * mag.astype(np.int64)
                     + (np.int64(1) << lastp.astype(np.int64)), 0)
    return (out2x * np.where(sgn < 0, -1, 1)).astype(np.int32)
