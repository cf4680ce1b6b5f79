"""The device Huffman decoder of baseline JPEG scans: CUDA on the card,
plain NumPy beside it.

Replaces no Pallas kernel: the JAX package decodes every scan on the host.
It moves ``csrc/host/jpeg_huff.cpp``'s baseline decode (``decode_mcus``)
to the card, so the serving front ships the entropy-coded scans (about
0.75 bit a pixel) instead of dense int16 coefficients (16 bits a
coefficient) and the host keeps only the marker parse and the destuffing
(``csrc/host/jpeg_scan.cpp``, ``prepare_stream``).

Scans without restart markers have no known codeword boundary inside
them, so the decoder finds them in parallel by self-synchronisation
(Weissenberger and Schmidt, "Accelerating JPEG Decompression on GPUs",
arXiv:2111.09219). Each restart segment is cut into subsequences of
``SUBSEQ_BITS`` bits, one thread each; a decoder state is (bit position,
block of the MCU, zigzag index k). Phases, one launch sequence a batch:

1. zero-fill of the destination arrays (the caller's ``torch.zeros``);
2. sync: each subsequence decodes from a guessed state (its first bit,
   block 0, k 0) until it passes its end and records the state there
   (``out``) and the blocks it started (``cnt``); then, again and again,
   subsequence t decodes from t-1's recorded state until no recorded state
   changes (inside a CUDA block in shared memory, then across blocks in up
   to ``SYNC_PASSES`` passes). A segment's first subsequence starts from a
   known state, so the fixed point is the true decode by induction;
3. scan: an exclusive prefix sum of ``cnt`` gives each subsequence its
   first block;
4. write: each subsequence decodes again from t-1's state, writes AC
   coefficients in natural order into its blocks (the in-window real
   blocks that ``decode_mcus`` stores) and each block's DC difference to a
   side array; it checks that it ends in its recorded state with its
   recorded count, so a sync that did not converge flags its image
   instead of writing a wrong decode;
5. DC: a segmented inclusive scan of the differences per image, component
   and restart segment writes each block's coefficient 0.

A stream is flagged in ``status`` wherever ``decode_mcus`` returns
non-zero (a bad code, k > 63, a DC size over 15, bits used past the
segment's end) or where the check of phase 4 fails; its caller decodes
it again by the host route. Every stream not flagged decodes to
``jpeg_huff.cpp``'s coefficients bit for bit.

What bounds it on the card: the decode is a serial dependency chain per
thread (a table lookup, shifts and a branch a symbol), so it is bound by
latency and divergence, not bytes: the scans are ~36 MB a batch of 32
at 12 MP, the writes and the zero-fill ~1.2 GB (0.35 ms at 3.35 TB/s).
The design spends threads: ~280,000 subsequences a batch, each a short
chain; tables are read through the read-only cache (1424 bytes each,
shared by every thread of an image); sync costs about two decodes of each
bit and the write one more.

* A CUDA tensor launches the kernels (``csrc/huffman_decode.cu``, built
  with nvcc for sm_90a at first use) or the call raises.
* A CPU tensor takes the plain version (``huffman_decode_plain``): the
  same phases in NumPy, every subsequence stepped in lock step, the sync
  iterated to its fixed point.

``launches["huffman_decode"]`` counts the launch sequences (plain-version
calls do not count), so a run can show the serving path went through the
kernels.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from . import _build

#: bits a subsequence of a restart segment covers: a constant of the
#: kernel, chosen on the card (PERF.md)
SUBSEQ_BITS = 2048
#: cross-block sync passes before phase 4 checks what is left
SYNC_PASSES = 4
#: bytes of one table as jpeg_scan.cpp writes it (DevHuff)
TABLE_BYTES = 1424
#: lpt_jpeg_scan_prepare's info: bytes used, segments, restart interval,
#: MCUs, then (h, v) of up to four components
INFO_LEN = 12
#: the sync state that stands for "no state" (a decode error)
ERR_STATE = np.uint64(0xFFFFFFFFFFFFFFFF)

launches: Dict[str, int] = {"huffman_decode": 0}

_LIB = "libhuffman_decode"
#: the kernels' CUDA source under csrc/
SOURCE = "huffman_decode.cu"
_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}

# zigzag position -> natural (row-major) position, ISO/IEC 10918-1 fig A.6
ZIGZAG_NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    np.int64)


class ScanGeometry(NamedTuple):
    """What the kernels need of a batch's frame: components, the block
    schedule of an MCU (component, dx, dy of each block), each
    component's sampling factors, true block size and store window
    (y0, x0, h, w in blocks: the destination array holds blocks [y0,
    y0+h) x [x0, x0+w)), the MCUs of a row and of the frame."""
    ncomp: int
    sched: tuple
    h: tuple
    v: tuple
    bw: tuple
    bh: tuple
    win: tuple
    mcus_x: int
    nmcu: int

    @property
    def bpm(self) -> int:
        return len(self.sched)


def scan_geometry(width: int, height: int, samp: Sequence[tuple],
                  win: Sequence[tuple]) -> ScanGeometry:
    """The geometry of a baseline frame with components sampled (h, v)
    and store windows `win`, as jpeg_huff.cpp's decode_mcus walks it."""
    n = len(samp)
    hmax = max(h for h, _ in samp)
    vmax = max(v for _, v in samp)
    bw = tuple(-(-width * h // (8 * hmax)) for h, _ in samp)
    bh = tuple(-(-height * v // (8 * vmax)) for _, v in samp)
    if n == 1:
        sched = ((0, 0, 0),)
        mcus_x, mcus_y = bw[0], bh[0]
        hs, vs = (1,), (1,)
    else:
        sched = tuple((c, j, i) for c, (h, v) in enumerate(samp)
                      for i in range(v) for j in range(h))
        mcus_x = -(-width // (8 * hmax))
        mcus_y = -(-height // (8 * vmax))
        hs = tuple(h for h, _ in samp)
        vs = tuple(v for _, v in samp)
    return ScanGeometry(n, sched, hs, vs, bw, bh, tuple(map(tuple, win)),
                        mcus_x, mcus_x * mcus_y)


# -- host preparation ---------------------------------------------------------

def scan_capacity(nbytes: int, nmcu: int) -> int:
    """Bytes a stream of `nbytes` may take in the scan buffer: its
    destuffed bytes plus, per restart segment, alignment and 8 zero bytes
    (at most nmcu segments, each with at least one byte and a 2-byte
    marker); a multiple of 16, so each stream of a batch laid end to end
    starts on a word of the kernels' 4-byte loads."""
    segs = min(nmcu, nbytes // 3 + 1)
    return (nbytes + 12 * segs + 16 + 15) & ~15


def prepare_stream(lib, buf: np.ndarray, scan: np.ndarray, segs: np.ndarray,
                   tables: np.ndarray, qtables: np.ndarray, win_p) -> \
        Optional[np.ndarray]:
    """lpt_jpeg_scan_prepare of one stream into its slice of the batch's
    scan buffer, its (ncomp * 2, TABLE_BYTES) tables and (4, 64) u16
    quantization tables; segs is (capacity, 2) int32 scratch. Returns the
    info row (INFO_LEN int32), or None where the stream is declined."""
    info = np.zeros(INFO_LEN, np.int32)
    c = ctypes
    rc = lib.lpt_jpeg_scan_prepare(
        buf.ctypes.data_as(c.POINTER(c.c_uint8)), buf.size, win_p,
        scan.ctypes.data_as(c.POINTER(c.c_uint8)), scan.size,
        segs.ctypes.data_as(c.POINTER(c.c_int32)), segs.shape[0],
        tables.ctypes.data_as(c.POINTER(c.c_uint8)),
        qtables.ctypes.data_as(c.POINTER(c.c_uint16)),
        info.ctypes.data_as(c.POINTER(c.c_int32)))
    return info if rc == 0 else None


class SegmentTable(NamedTuple):
    """A batch's restart segments for the kernels. seg is (nseg, 8) int32:
    word offset in the scan buffer, bits, image, first block (first MCU x
    blocks an MCU), blocks, first subsequence, subsequences, 0; sub_start
    is (nseg + 1,) int32, each segment's first subsequence and the total;
    img_ri (B,) int32 is each image's restart interval (0: none), -1 for
    a lane the card does not decode; subseq_bits the subsequences' bits
    (SUBSEQ_BITS when the table was made)."""
    seg: np.ndarray
    sub_start: np.ndarray
    img_ri: np.ndarray
    subseq_bits: int

    @property
    def nsub(self) -> int:
        return int(self.sub_start[-1])


def segment_table(geom: ScanGeometry, offsets: Sequence[int],
                  streams: Sequence[Optional[tuple]]) -> SegmentTable:
    """The SegmentTable of a batch whose image i was prepared at byte
    offset offsets[i] of the scan buffer, streams[i] = (segs, ri) with
    segs its (nsegs, 2) {byte offset, byte length} rows, or None for a
    lane the card does not decode."""
    subseq_bits = SUBSEQ_BITS
    rows = []
    img_ri = np.full(len(streams), -1, np.int32)
    bpm = geom.bpm
    for i, st in enumerate(streams):
        if st is None:
            continue
        segs, ri = st
        img_ri[i] = ri
        n = segs.shape[0]
        per = ri if ri > 0 else geom.nmcu
        m0 = np.arange(n, dtype=np.int64) * per
        r = np.zeros((n, 8), np.int64)
        r[:, 0] = (offsets[i] + segs[:, 0].astype(np.int64)) // 4
        r[:, 1] = segs[:, 1].astype(np.int64) * 8
        r[:, 2] = i
        r[:, 3] = m0 * bpm
        r[:, 4] = (np.minimum(m0 + per, geom.nmcu) - m0) * bpm
        rows.append(r)
    seg = (np.concatenate(rows) if rows else np.zeros((0, 8), np.int64))
    # a segment of no bytes still gets a subsequence: its write flags it
    nsub = np.maximum(1, -(-seg[:, 1] // subseq_bits))
    sub_start = np.zeros(len(seg) + 1, np.int64)
    np.cumsum(nsub, out=sub_start[1:])
    seg[:, 5] = sub_start[:-1]
    seg[:, 6] = nsub
    if sub_start[-1] >= 2 ** 31:
        raise ValueError("batch has too many subsequences")
    return SegmentTable(seg.astype(np.int32), sub_start.astype(np.int32),
                        img_ri, subseq_bits)


# -- the decode ---------------------------------------------------------------

def huffman_decode(scan: torch.Tensor, segs: SegmentTable,
                   seg: torch.Tensor, sub_start: torch.Tensor,
                   img_ri: torch.Tensor, tables: torch.Tensor,
                   geom: ScanGeometry, outs: Sequence[torch.Tensor],
                   status: torch.Tensor) -> None:
    """Decode a batch's scans into `outs`, one zero-filled (B, h, w, 64)
    int16 array per component (each its component's store window), and
    set status[i] to 1 for each image whose stream the host must decode
    again. scan: the uint8 scan buffer (a multiple of 4 bytes); segs: its
    SegmentTable on the host, and seg, sub_start, img_ri: those arrays on
    the scan's device; tables: (B, 2 * ncomp, TABLE_BYTES) uint8; status:
    (B,) int32 zeros. A CPU scan takes the plain version."""
    _check(scan, seg, sub_start, img_ri, tables, geom, outs, status)
    if scan.device.type == "cpu":
        huffman_decode_plain(scan.numpy(), segs, tables.numpy(), geom,
                             [o.numpy() for o in outs], status.numpy())
        return
    if scan.device.type != "cuda":
        raise ValueError(f"huffman_decode runs on cuda or cpu, not "
                         f"{scan.device}")
    nsub = segs.nsub
    if nsub == 0:
        return
    lib = _load()
    dev = scan.device
    g = _geom_struct(geom)
    out = torch.empty(nsub, dtype=torch.int64, device=dev)
    inu = torch.empty(nsub, dtype=torch.int64, device=dev)
    cnt = torch.empty(nsub, dtype=torch.int32, device=dev)
    flags = torch.zeros(SYNC_PASSES + 1, dtype=torch.int32, device=dev)
    b = int(img_ri.shape[0])
    diff = torch.empty((b, geom.nmcu * geom.bpm), dtype=torch.int16,
                       device=dev)
    ptrs = [o.data_ptr() for o in outs] + [0] * (3 - len(outs))
    common = (scan.data_ptr(), seg.data_ptr(), sub_start.data_ptr(),
              int(seg.shape[0]), nsub, tables.data_ptr(), ctypes.byref(g),
              segs.subseq_bits)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _call(lib.lpt_huff_sync, *common, out.data_ptr(), inu.data_ptr(),
              cnt.data_ptr(), flags.data_ptr(), SYNC_PASSES, stream)
        first = torch.cumsum(cnt, 0, dtype=torch.int32) - cnt
        _call(lib.lpt_huff_write, *common, out.data_ptr(), cnt.data_ptr(),
              first.data_ptr(), diff.data_ptr(), *ptrs, status.data_ptr(),
              stream)
        _call(lib.lpt_huff_dc, diff.data_ptr(), img_ri.data_ptr(), b,
              ctypes.byref(g), *ptrs, stream)
    launches["huffman_decode"] += 1


def _check(scan, seg, sub_start, img_ri, tables, geom, outs, status):
    if scan.dtype != torch.uint8 or scan.dim() != 1 or scan.numel() % 4:
        raise ValueError("scan must be 1-D uint8, a multiple of 4 bytes")
    b = int(img_ri.shape[0])
    for name, t, dt in (("seg", seg, torch.int32),
                        ("sub_start", sub_start, torch.int32),
                        ("img_ri", img_ri, torch.int32),
                        ("tables", tables, torch.uint8),
                        ("status", status, torch.int32)):
        if t.dtype != dt or t.device != scan.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dt} on "
                             f"{scan.device}")
    if tuple(tables.shape) != (b, 2 * geom.ncomp, TABLE_BYTES):
        raise ValueError(f"tables must be ({b}, {2 * geom.ncomp}, "
                         f"{TABLE_BYTES}), got {tuple(tables.shape)}")
    if len(outs) != geom.ncomp:
        raise ValueError(f"{geom.ncomp} destination arrays expected")
    for c, o in enumerate(outs):
        shape = (b, geom.win[c][2], geom.win[c][3], 64)
        if (o.dtype != torch.int16 or tuple(o.shape) != shape
                or o.device != scan.device or not o.is_contiguous()):
            raise ValueError(f"outs[{c}] must be contiguous int16 {shape}")


class _Geom(ctypes.Structure):
    """struct Geom of csrc/huffman_decode.cu."""
    _fields_ = [("ncomp", ctypes.c_int32), ("bpm", ctypes.c_int32),
                ("mcus_x", ctypes.c_int32), ("nmcu", ctypes.c_int32),
                ("sched", ctypes.c_int32 * 10)] + [
        (k, ctypes.c_int32 * 4)
        for k in ("h", "v", "bw", "bh", "wy0", "wx0", "wh", "ww")]


def _geom_struct(geom: ScanGeometry) -> _Geom:
    g = _Geom()
    g.ncomp, g.bpm, g.mcus_x, g.nmcu = (geom.ncomp, geom.bpm, geom.mcus_x,
                                        geom.nmcu)
    for i, (c, dx, dy) in enumerate(geom.sched):
        g.sched[i] = c | dx << 4 | dy << 8
    for c in range(geom.ncomp):
        g.h[c], g.v[c] = geom.h[c], geom.v[c]
        g.bw[c], g.bh[c] = geom.bw[c], geom.bh[c]
        g.wy0[c], g.wx0[c], g.wh[c], g.ww[c] = geom.win[c]
    return g


def _call(fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError("huffman_decode kernel launch failed: "
                           + _libs[_LIB].lpt_cuda_error_string(rc).decode())


def _load() -> ctypes.CDLL:
    with _lock:
        if _LIB not in _libs:
            lib = ctypes.CDLL(build())
            vp, i32 = ctypes.c_void_p, ctypes.c_int
            common = [vp, vp, vp, i32, i32, vp, vp, i32]
            lib.lpt_huff_sync.argtypes = common + [vp, vp, vp, vp, i32, vp]
            lib.lpt_huff_write.argtypes = common + [vp, vp, vp, vp, vp, vp,
                                                    vp, vp, vp]
            lib.lpt_huff_dc.argtypes = [vp, vp, i32, vp, vp, vp, vp, vp]
            for fn in (lib.lpt_huff_sync, lib.lpt_huff_write,
                       lib.lpt_huff_dc):
                fn.restype = i32
            lib.lpt_cuda_error_string.argtypes = [i32]
            lib.lpt_cuda_error_string.restype = ctypes.c_char_p
            _libs[_LIB] = lib
    return _libs[_LIB]


def build() -> str:
    """Build (or find) the kernels' library; returns its path."""
    return _build.build_cuda(_LIB, (os.path.join(_build.CSRC_DIR, SOURCE),))


# -- plain version ------------------------------------------------------------

class _Lanes(NamedTuple):
    """Per-subsequence constants of the plain version."""
    word0: np.ndarray    # first word of the segment
    seg_bits: np.ndarray
    img: np.ndarray
    start: np.ndarray    # first bit, relative to the segment
    end: np.ndarray      # bit past the subsequence
    first: np.ndarray    # the segment's first subsequence
    last: np.ndarray     # the segment's last subsequence
    blk0: np.ndarray     # the segment's first block
    nblk: np.ndarray     # the segment's blocks
    seg_first_sub: np.ndarray


def _lanes(segs: SegmentTable) -> _Lanes:
    subseq_bits = segs.subseq_bits
    seg = segs.seg.astype(np.int64)
    nsub = segs.nsub
    s = np.repeat(np.arange(len(seg)), seg[:, 6])
    j = np.arange(nsub) - seg[s, 5]
    start = j * subseq_bits
    end = np.minimum(start + subseq_bits, seg[s, 1])
    return _Lanes(seg[s, 0], seg[s, 1], seg[s, 2], start, end, j == 0,
                  j == seg[s, 6] - 1, seg[s, 3], seg[s, 4], seg[s, 5])


def _pack(pos, blk, k) -> np.ndarray:
    return ((pos.astype(np.uint64) << np.uint64(16))
            | (blk.astype(np.uint64) << np.uint64(8)) | k.astype(np.uint64))


def _unpack(st):
    return ((st >> np.uint64(16)).astype(np.int64),
            ((st >> np.uint64(8)) & np.uint64(0xFF)).astype(np.int64),
            (st & np.uint64(0xFF)).astype(np.int64))


class _Tables(NamedTuple):
    lut: np.ndarray       # (ntab, 512)
    maxcode: np.ndarray   # (ntab, 18)
    valoff: np.ndarray    # (ntab, 18)
    vals: np.ndarray      # (ntab, 256)


def _tables(tables: np.ndarray) -> _Tables:
    t = np.ascontiguousarray(tables).reshape(-1, TABLE_BYTES)
    return _Tables(t[:, :1024].copy().view(np.uint16).astype(np.int64),
                   t[:, 1024:1096].copy().view(np.int32).astype(np.int64),
                   t[:, 1096:1168].copy().view(np.int32).astype(np.int64),
                   t[:, 1168:].astype(np.int64))


def _decode(words, lanes: _Lanes, tabs: _Tables, geom: ScanGeometry,
            idx: np.ndarray, state: np.ndarray, write=None):
    """Decode lanes `idx` from their states (ERR_STATE: the lane's guess)
    in lock step, one symbol a lane a step.

    Without `write` (sync): until the state's bit position reaches the
    lane's end, at a codeword boundary; returns (state, blocks started),
    state ERR_STATE where a code was bad. With write = (cnt, flag, diff,
    outs): cnt (blocks of the segment started before the state, absolute)
    per lane; each DC difference goes to diff[image, block], each AC
    coefficient to its block in outs; the decode stops at the segment's
    last block (or, where the lane is not the segment's last, at its end);
    flag[i] is set where the decode of a real block fails. Returns the
    (state, blocks started) where each lane stopped, and whether it
    stopped at its end (not at its segment's last block or an error)."""
    n = len(idx)
    pos, blk, k = _unpack(state)
    guess = state == ERR_STATE
    pos[guess] = lanes.start[idx[guess]]
    blk[guess] = 0
    k[guess] = 0
    nblocks = np.zeros(n, np.int64)
    bad = np.zeros(n, bool)
    at_end = np.zeros(n, bool)
    sched_c = np.array([c for c, _, _ in geom.sched], np.int64)
    ncomp, bpm = geom.ncomp, geom.bpm
    end = lanes.end[idx]
    seg_bits = lanes.seg_bits[idx]
    img = lanes.img[idx]
    word0 = lanes.word0[idx]
    if write is not None:
        cnt, flag, diff, outs = write
        cnt = cnt.copy()
        last = lanes.last[idx]
        nblk = lanes.blk0[idx] + lanes.nblk[idx]
        dx = np.array([d for _, d, _ in geom.sched], np.int64)
        dy = np.array([d for _, _, d in geom.sched], np.int64)
    active = np.ones(n, bool)
    while True:
        a = np.flatnonzero(active)
        if write is not None and len(a):
            done = (k[a] == 0) & (cnt[a] == nblk[a])
            over = done & (pos[a] > seg_bits[a])
            flag[img[a[over]]] = 1
            stop = done | (~last[a] & (pos[a] >= end[a]))
            at_end[a[stop & ~done]] = True
            active[a[stop]] = False
            a = a[~stop]
        elif len(a):
            stop = pos[a] >= end[a]
            at_end[a[stop]] = True
            active[a[stop]] = False
            a = a[~stop]
        if not len(a):
            break
        p = pos[a]
        w = word0[a] + (p >> 5)
        hi = (words[w].astype(np.uint64) << np.uint64(32)) | words[w + 1]
        bits = ((hi << (p & 31).astype(np.uint64)) >> np.uint64(32)) \
            .astype(np.int64)
        ka = k[a]
        tab = (img[a] * ncomp + sched_c[blk[a]]) * 2 + (ka > 0)
        e = tabs.lut[tab, bits >> 23]
        ln = e >> 8
        sym = e & 0xFF
        err = np.zeros(len(a), bool)
        miss = np.flatnonzero(e == 0)
        if len(miss):
            tm = tab[miss]
            found = np.zeros(len(miss), bool)
            for ll in range(10, 17):
                code = bits[miss] >> (32 - ll)
                hit = ~found & (code <= tabs.maxcode[tm, ll])
                vi = code + tabs.valoff[tm, ll]
                okv = hit & (vi >= 0) & (vi <= 255)
                sym[miss[okv]] = tabs.vals[tm[okv], vi[okv]]
                ln[miss[hit]] = ll
                err[miss[hit & ~okv]] = True
                found |= hit
            err[miss[~found]] = True
        dc = ka == 0
        s = np.where(dc, sym, sym & 15)
        r = np.where(dc, 0, sym >> 4)
        err |= dc & (s > 15)
        lit = ((bits << ln) & 0xFFFFFFFF) >> (32 - s)
        lit = np.where(s > 0, lit, 0)
        half = np.where(s > 0, 1 << np.maximum(s - 1, 0), 0)
        val = np.where(lit < half, lit - (1 << s) + 1, lit)
        newk = np.where(dc, 1, np.where(s > 0, ka + r, ka + 16))
        eob = ~dc & (s == 0) & (r != 15)
        err |= ~dc & (s > 0) & (newk > 63)
        newp = p + ln + s
        if write is not None:
            err |= newp > seg_bits[a]
        ok = ~err
        if write is not None:
            ai = a[ok]
            cur = cnt[ai] - (~dc[ok])  # block of this symbol
            bl = blk[ai]
            i_img = img[ai]
            is_dc = dc[ok]
            diff[i_img[is_dc], cur[is_dc]] = val[ok][is_dc]
            st = ~is_dc & (s[ok] > 0)
            if st.any():
                m = cur[st] // bpm
                b = bl[st]
                c = sched_c[b]
                bx = (m % geom.mcus_x) * np.array(geom.h)[c] + dx[b]
                by = (m // geom.mcus_x) * np.array(geom.v)[c] + dy[b]
                nat = ZIGZAG_NATURAL[newk[ok][st]]
                v = val[ok][st]
                ii = i_img[st]
                for comp in range(ncomp):
                    wy0, wx0, wh, ww = geom.win[comp]
                    sel = ((c == comp) & (bx >= wx0) & (bx < wx0 + ww)
                           & (by >= wy0) & (by < wy0 + wh)
                           & (bx < geom.bw[comp]) & (by < geom.bh[comp]))
                    outs[comp][ii[sel], by[sel] - wy0, bx[sel] - wx0,
                               nat[sel]] = v[sel]
            cnt[a[ok & dc]] += 1
            flag[img[a[err]]] = 1
        nblocks[a[ok & dc]] += 1
        newk = np.where(s > 0, newk + ~dc, newk)  # past the stored value
        ends = ~dc & (eob | (newk >= 64))
        k[a] = np.where(ends, 0, newk)
        blk[a] = np.where(ends, (blk[a] + 1) % bpm, blk[a])
        pos[a] = newp
        bad[a[err]] = True
        active[a[err]] = False
    out = _pack(pos, blk, k)
    out[bad] = ERR_STATE
    return out, nblocks, at_end & ~bad


def huffman_decode_plain(scan: np.ndarray, segs: SegmentTable,
                         tables: np.ndarray, geom: ScanGeometry,
                         outs: List[np.ndarray], status: np.ndarray) -> None:
    """The plain version of huffman_decode (the same arguments as host
    arrays; outs zero-filled): phases 2-5 in NumPy."""
    nsub = segs.nsub
    if nsub == 0:
        return
    words = np.ascontiguousarray(scan).view(">u4").astype(np.uint64)
    lanes = _lanes(segs)
    tabs = _tables(tables)
    # phase 2: sync, every lane from its guess, then from its
    # predecessor's state until nothing changes (the last lane of a
    # segment is never read)
    state_in = np.full(nsub, ERR_STATE, np.uint64)
    state_in[lanes.first] = 0
    live = np.flatnonzero(~lanes.last)
    out = np.full(nsub, ERR_STATE, np.uint64)
    cnt = np.zeros(nsub, np.int64)
    todo = live
    while len(todo):
        o, c, _ = _decode(words, lanes, tabs, geom, todo, state_in[todo])
        changed = todo[(o != out[todo]) | (c != cnt[todo])]
        out[todo], cnt[todo] = o, c
        nxt = changed + 1
        nxt = nxt[(nxt < nsub)]
        nxt = nxt[~lanes.first[nxt] & ~lanes.last[nxt]]
        state_in[nxt] = out[nxt - 1]
        todo = nxt
    # phase 3: each lane's first block
    first = np.zeros(nsub, np.int64)
    np.cumsum(cnt[:-1], out=first[1:])
    start_cnt = lanes.blk0 + first - first[lanes.seg_first_sub]
    # phase 4: write
    b = len(segs.img_ri)
    diff = np.zeros((b, geom.nmcu * geom.bpm), np.int32)
    st_in = np.where(lanes.first, np.uint64(0),
                     np.roll(out, 1)).astype(np.uint64)
    _, _, kin = _unpack(st_in)
    cur = start_cnt - (kin > 0)
    err_in = (st_in == ERR_STATE) & ~lanes.first
    real = cur < lanes.blk0 + lanes.nblk
    status[np.unique(lanes.img[err_in & real])] = 1
    go = np.flatnonzero(~err_in & real)
    o, c, at_end = _decode(words, lanes, tabs, geom, go, st_in[go],
                           (start_cnt[go], status, diff, outs))
    wrong = at_end & ((o != out[go]) | (c != cnt[go]))
    status[np.unique(lanes.img[go[wrong]])] = 1
    # phase 5: DC
    _dc_scan(diff, segs.img_ri, geom, outs)


def _dc_scan(diff: np.ndarray, img_ri: np.ndarray, geom: ScanGeometry,
             outs: List[np.ndarray]) -> None:
    bpm = geom.bpm
    m = np.arange(geom.nmcu)
    off = 0
    for comp in range(geom.ncomp):
        hv = geom.h[comp] * geom.v[comp]
        js = np.arange(hv)
        cols = m[:, None] * bpm + off + js[None, :]        # (nmcu, hv)
        dx, dy = js % geom.h[comp], js // geom.h[comp]
        bx = (m % geom.mcus_x)[:, None] * geom.h[comp] + dx[None, :]
        by = (m // geom.mcus_x)[:, None] * geom.v[comp] + dy[None, :]
        wy0, wx0, wh, ww = geom.win[comp]
        keep = ((bx >= wx0) & (bx < wx0 + ww) & (by >= wy0)
                & (by < wy0 + wh) & (bx < geom.bw[comp])
                & (by < geom.bh[comp])).ravel()
        for i in np.flatnonzero(img_ri >= 0):
            d = diff[i, cols.ravel()].astype(np.int64)
            run = np.cumsum(d)
            ri = int(img_ri[i])
            if ri > 0:
                # reset at every restart segment's first block
                seg_first = (m // ri) * ri * hv            # per MCU
                base = np.concatenate([[0], run])[np.repeat(seg_first, hv)]
                run = run - base
            dc = (run & 0xFFFF).astype(np.uint16).view(np.int16)
            outs[comp][i, by.ravel()[keep] - wy0, bx.ravel()[keep] - wx0,
                       0] = dc[keep]
        off += hv
