// From-scratch JPEG Huffman coefficient decoder (host hot path).
//
// decode_entropy is the serving e2e wall (BENCH_r03: 211 imgs/s/core vs
// 17k+ device). Profiling (tools/profile_host.py) put 3.2 ms of the
// 4.7 ms/image inside libjpeg's jpeg_read_coefficients — which entropy-
// decodes into a freshly allocated whole-image virtual coefficient array
// (fresh ~6 MB + page faults per 1080p image) that we then memcpy out
// (another 0.5 ms). This decoder removes both: the scan is destuffed once
// (memchr over the 0xFF bytes), then a 64-bit bit reader entropy-decodes
// blocks DIRECTLY into the caller's destination slice.
//
// Scope: 8-bit Huffman JPEG, both profiles that exist on the web —
//   * baseline/extended sequential (SOF0/SOF1), single interleaved scan:
//     the original fast path, window-direct, restart-threaded;
//   * progressive (SOF2), any spectral-selection / successive-
//     approximation scan script: multi-scan state machine below, decoding
//     the same four scan types libjpeg's jdphuff.c does (DC first/refine,
//     AC first/refine with EOB runs and correction bits, ITU T.81 §G.1.2)
//     into full-geometry planes, bit-identically.
// Anything else — arithmetic coding, hierarchical, lossless, 12-bit, or
// any structural anomaly — returns LP_HUFF_DECLINE and the caller falls
// back to the libjpeg path (lp_jpeg_decode_coefs), so hostile/exotic
// inputs keep byte-for-byte the behavior they had before. Valid files
// decode BIT-IDENTICALLY to libjpeg (gated in tests/test_jpeg_huff.py
// against the full corpus plus synthetic scan-script matrices).
//
// Restart intervals double as the parallelism seam: RSTn resets the bit
// buffer and DC predictors (and the EOB run, in progressive scans), so
// segments decode independently — threads take contiguous segment ranges
// and write into disjoint MCU rows of the same destination (any DRI, not
// just the row-aligned ones the synthetic slice splitter
// lp_jpeg_decode_coefs_parallel requires).
//
// Reference analog: /root/reference/opencv.cpp:93-188 decodes JPEGs through
// OpenCV's libjpeg wrapper (full IDCT on CPU); here the host touches only
// the bitstream and the TPU does everything dense (SURVEY.md §7 step 3).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>

#include <thread>
#include <vector>

#if defined(__SSE2__)
#include <emmintrin.h>
#endif
#if defined(__BMI2__)
#include <immintrin.h>
#endif

namespace {

constexpr int kDecline = -10;  // caller falls back to libjpeg

// zigzag position -> natural (row-major) position, ISO/IEC 10918-1 fig A.6.
// Padded to 80 entries with 63 exactly like libjpeg's jpeg_natural_order:
// progressive AC scans index it at k = Se + run (≤ 78) on corrupt-ish
// streams, and bit-identity with libjpeg requires landing on coef 63.
const uint8_t kNat[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

inline int32_t huff_extend(int32_t v, int s) {
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// Write one decoded 128-byte block to its (cold) destination. The batch
// coefficient arrays are written once and never read by the CPU, so
// non-temporal stores skip the read-for-ownership of each destination
// line — halving DRAM traffic on the composed path, where every image
// lands in a cold slice of a ~6 MB/image batch array (the ~0.9 ms/image
// gap tools/profile_host.py measured between the isolated hot-dst call
// and decode_entropy). Callers issue one _mm_sfence after the segment.
inline void store_block(int16_t* dst, const int16_t* src, bool aligned) {
#if defined(__SSE2__)
    if (aligned) {
        const __m128i* s = reinterpret_cast<const __m128i*>(src);
        __m128i* d = reinterpret_cast<__m128i*>(dst);
        for (int i = 0; i < 8; i++)
            _mm_stream_si128(d + i, _mm_load_si128(s + i));
        return;
    }
#else
    (void)aligned;
#endif
    std::memcpy(dst, src, 64 * sizeof(int16_t));
}

struct HuffTable {
    // first level: 8-bit lookahead -> (code_len << 8) | symbol; 0 = longer
    uint16_t lookup[256];
    // lengths 9..16: canonical mincode/maxcode walk (same as libjpeg's)
    int32_t maxcode[18];
    int32_t valoffset[17];
    uint8_t vals[256];
    // AC tables only: fused (code, literal) decode for short pairs —
    // 9-bit lookahead -> (coef_value:int8 << 8) | (run << 4) | total_bits,
    // 0 = not covered (fall through to the two-step path). One table load
    // replaces code-lookup + literal-extract on the serial critical path;
    // at web qualities the vast majority of AC coefficients hit it.
    int16_t fast_ac[512];
    bool present = false;
};

bool build_huff(const uint8_t counts[16], const uint8_t* vals, int nvals,
                HuffTable* t, bool is_ac) {
    if (nvals < 1 || nvals > 256) return false;
    uint32_t codes[256];
    uint8_t sizes[256];
    uint32_t code = 0;
    int k = 0;
    for (int l = 1; l <= 16; l++) {
        for (int i = 0; i < counts[l - 1]; i++) {
            if (k >= nvals || code >= (1u << l)) return false;  // overfull
            codes[k] = code;
            sizes[k] = static_cast<uint8_t>(l);
            code++;
            k++;
        }
        code <<= 1;
    }
    if (k != nvals) return false;
    std::memset(t->fast_ac, 0, sizeof(t->fast_ac));
    for (int i = 0; i < nvals; i++) {
        const int l = sizes[i];
        if (l > 9) continue;
        const int r = is_ac ? vals[i] >> 4 : 0;
        const int s = is_ac ? vals[i] & 15 : vals[i];
        const int lo = static_cast<int>(codes[i]) << (9 - l);
        const int hi = lo + (1 << (9 - l));
        if (s == 0) {
            // AC: EOB (r=0) / ZRL (r=15), encoded with value byte 0 —
            // unambiguous because a real literal of s>0 bits is never 0.
            // DC: zero diff. Entry is just (run << 4) | code_len, nonzero
            // because l >= 1.
            if (is_ac && r != 0 && r != 15) continue;  // EOBn: two-step path
            for (int w = lo; w < hi; w++)
                t->fast_ac[w] = static_cast<int16_t>((r << 4) | l);
            continue;
        }
        if (s > 7 || l + s > 9) continue;  // literal must fit int8
        for (int w = lo; w < hi; w++) {
            const int32_t bits = (w >> (9 - l - s)) & ((1 << s) - 1);
            const int32_t val = huff_extend(bits, s);
            t->fast_ac[w] = static_cast<int16_t>(
                ((val & 0xFF) << 8) | (r << 4) | (l + s));
        }
    }
    std::memcpy(t->vals, vals, nvals);
    int p = 0;
    for (int l = 1; l <= 16; l++) {
        if (counts[l - 1]) {
            t->valoffset[l] = p - static_cast<int32_t>(codes[p]);
            p += counts[l - 1];
            t->maxcode[l] = static_cast<int32_t>(codes[p - 1]);
        } else {
            t->maxcode[l] = -1;
        }
    }
    t->maxcode[17] = 0xFFFFF;
    std::memset(t->lookup, 0, sizeof(t->lookup));
    p = 0;
    for (int l = 1; l <= 8; l++) {
        for (int i = 0; i < counts[l - 1]; i++, p++) {
            uint32_t c = codes[p] << (8 - l);
            for (uint32_t j = 0; j < (1u << (8 - l)); j++)
                t->lookup[c + j] = static_cast<uint16_t>((l << 8) | vals[p]);
        }
    }
    t->present = true;
    return true;
}

struct Comp {
    int id = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
    int bw = 0, bh = 0;  // true (unpadded) block geometry
    // store window (block units): dst is a (wh, ww, 64) array holding
    // blocks [wy0, wy0+wh) x [wx0, wx0+ww); defaults to the full plane
    int wy0 = 0, wx0 = 0, wh = 0, ww = 0;
};

struct Frame {
    int width = 0, height = 0, ncomp = 0;
    bool progressive = false;
    Comp comp[4];
    int hmax = 1, vmax = 1;
    int mcus_x = 0, mcus_y = 0, nmcu = 0;
    int restart_interval = 0;
    HuffTable dc[4], ac[4];
    uint16_t qt[4][64] = {};
    bool qt_seen[4] = {};
};

// One SOS header (scan order preserved; ci = frame component indices).
struct Scan {
    int ns = 0;
    int ci[4] = {};
    int td[4] = {}, ta[4] = {};
    int Ss = 0, Se = 63, Ah = 0, Al = 0;
};

// ---------------------------------------------------------------------------
// marker segment parsers shared by the pre-scan loop and the progressive
// inter-scan loop (DHT/DQT/DRI may legally appear between scans and
// redefine tables mid-file)
// ---------------------------------------------------------------------------

bool parse_dht(Frame& f, const uint8_t* seg, size_t slen) {
    size_t q = 0;
    while (q + 17 <= slen) {
        const int tc = seg[q] >> 4, th = seg[q] & 15;
        if (tc > 1 || th > 3) return false;
        int nv = 0;
        for (int i = 0; i < 16; i++) nv += seg[q + 1 + i];
        if (q + 17 + static_cast<size_t>(nv) > slen) return false;
        HuffTable* t = tc ? &f.ac[th] : &f.dc[th];
        if (!build_huff(seg + q + 1, seg + q + 17, nv, t, tc == 1))
            return false;
        q += 17 + nv;
    }
    return q == slen;
}

bool parse_dqt(Frame& f, const uint8_t* seg, size_t slen) {
    size_t q = 0;
    while (q < slen) {
        const int pq = seg[q] >> 4, tq = seg[q] & 15;
        if (pq > 1 || tq > 3) return false;
        const size_t n = 1 + (pq ? 128 : 64);
        if (q + n > slen) return false;
        for (int i = 0; i < 64; i++) {
            const uint16_t v =
                pq ? static_cast<uint16_t>((seg[q + 1 + 2 * i] << 8) |
                                           seg[q + 2 + 2 * i])
                   : seg[q + 1 + i];
            f.qt[tq][kNat[i]] = v;  // store natural order
        }
        f.qt_seen[tq] = true;
        q += n;
    }
    return true;
}

bool parse_sos(const Frame& f, const uint8_t* seg, size_t slen, Scan* sc) {
    if (slen < 6) return false;
    const int ns = seg[0];
    if (ns < 1 || ns > 4) return false;
    if (slen != 1 + 2 * static_cast<size_t>(ns) + 3) return false;
    sc->ns = ns;
    for (int i = 0; i < ns; i++) {
        const int id = seg[1 + 2 * i];
        int c = -1;
        for (int j = 0; j < f.ncomp; j++)
            if (f.comp[j].id == id) {
                c = j;
                break;
            }
        if (c < 0) return false;
        for (int j = 0; j < i; j++)
            if (sc->ci[j] == c) return false;  // duplicate component
        sc->ci[i] = c;
        sc->td[i] = seg[2 + 2 * i] >> 4;
        sc->ta[i] = seg[2 + 2 * i] & 15;
        if (sc->td[i] > 3 || sc->ta[i] > 3) return false;
    }
    const uint8_t* tail = seg + 1 + 2 * ns;
    sc->Ss = tail[0];
    sc->Se = tail[1];
    sc->Ah = tail[2] >> 4;
    sc->Al = tail[2] & 15;
    return true;
}

// Destuff one scan's entropy data starting at buf[start]: strip 0xFF00
// stuffing, record restart boundaries (RSTn must cycle in order), stop at
// the first non-RST marker, reported via *end_marker with *next_pos at its
// 0xFF byte. Returns 0 or kDecline.
int destuff_scan(const uint8_t* buf, size_t len, size_t start,
                 std::vector<uint8_t>& clean, std::vector<size_t>& segs,
                 uint8_t* end_marker, size_t* next_pos) {
    const uint8_t* q = buf + start;
    const uint8_t* bend = buf + len;
    int next_rst = 0;
    while (q < bend) {
        const uint8_t* ff =
            static_cast<const uint8_t*>(std::memchr(q, 0xFF, bend - q));
        if (!ff) return kDecline;  // no terminating marker
        clean.insert(clean.end(), q, ff);
        if (ff + 1 >= bend) return kDecline;
        const uint8_t m = ff[1];
        if (m == 0x00) {
            clean.push_back(0xFF);
            q = ff + 2;
        } else if (m == 0xFF) {
            q = ff + 1;  // fill byte
        } else if (m >= 0xD0 && m <= 0xD7) {
            if (m != 0xD0 + next_rst) return kDecline;  // out of sync
            next_rst = (next_rst + 1) & 7;
            segs.push_back(clean.size());
            q = ff + 2;
        } else {
            *end_marker = m;
            *next_pos = static_cast<size_t>(ff - buf);
            return 0;
        }
    }
    return kDecline;
}

// ---------------------------------------------------------------------------
// baseline path: single interleaved scan, window-direct, restart-threaded
// ---------------------------------------------------------------------------

// Decode MCUs [m0, m1) of one restart segment into dst. Returns 0 or <0.
//
// The bit reader lives in LOCALS (bb/bc/bp), refilled on demand with one
// unconditional 8-byte big-endian lookahead load (Giesen's variant-4
// refill; safe because destuffing removed every 0xFF marker hazard, and
// idempotent because re-ORing the same stream bits is a no-op). One
// refill covers a full (16-bit code + 15-bit literal) pair, so the hot
// loop refills only when below 32 valid bits.
int decode_mcus(const Frame& f, const uint8_t* seg_start,
                const uint8_t* seg_end, int16_t** dst, int m0, int m1) {
    // per-MCU block schedule, precomputed (≤ 4*16 blocks per MCU);
    // mulx/muly: MCU -> block coordinate scale (1 for a single-component
    // scan, whose MCU is one data unit over the component's own grid)
    struct BlockSpec {
        uint8_t c, dx, dy, mulx, muly;
    };
    BlockSpec sched[64];
    int nsched = 0;
    if (f.ncomp == 1) {
        sched[nsched++] = {0, 0, 0, 1, 1};
    } else {
        for (int c = 0; c < f.ncomp; c++)
            for (int i = 0; i < f.comp[c].v; i++)
                for (int j = 0; j < f.comp[c].h; j++)
                    sched[nsched++] = {static_cast<uint8_t>(c),
                                       static_cast<uint8_t>(j),
                                       static_cast<uint8_t>(i),
                                       static_cast<uint8_t>(f.comp[c].h),
                                       static_cast<uint8_t>(f.comp[c].v)};
    }

    const uint8_t* bp = seg_start;
    uint64_t bb = 0;
    int bc = 0;
    int64_t used = 0;

#define LP_REFILL()                                        \
    do {                                                   \
        if (seg_end - bp >= 8) {                           \
            uint64_t v_;                                   \
            std::memcpy(&v_, bp, 8);                       \
            bb |= __builtin_bswap64(v_) >> bc;             \
            bp += (63 - bc) >> 3;                          \
            bc |= 56;                                      \
        } else {                                           \
            while (bc <= 56) {                             \
                uint64_t b_ = (bp < seg_end) ? *bp++ : 0;  \
                bb |= b_ << (56 - bc);                     \
                bc += 8;                                   \
            }                                              \
        }                                                  \
    } while (0)
#define LP_SKIP(n)   \
    do {             \
        bb <<= (n);  \
        bc -= (n);   \
        used += (n); \
    } while (0)
// decode one Huffman symbol from table t into `sym` (int); -1 = bad code
#define LP_DECODE(t, sym)                                        \
    do {                                                         \
        uint16_t e_ = (t).lookup[static_cast<uint32_t>(bb >> 56)]; \
        if (e_) {                                                \
            LP_SKIP(e_ >> 8);                                    \
            (sym) = e_ & 0xFF;                                   \
        } else {                                                 \
            int l_ = 9;                                          \
            int32_t code_ = static_cast<int32_t>(bb >> (64 - 9)); \
            for (;;) {                                           \
                if (code_ <= (t).maxcode[l_]) break;             \
                if (++l_ > 16) {                                 \
                    (sym) = -1;                                  \
                    break;                                       \
                }                                                \
                code_ = static_cast<int32_t>(bb >> (64 - l_));   \
            }                                                    \
            if (l_ <= 16) {                                      \
                LP_SKIP(l_);                                     \
                int idx_ = code_ + (t).valoffset[l_];            \
                (sym) = (idx_ < 0 || idx_ > 255)                 \
                            ? -1                                 \
                            : (t).vals[idx_];                    \
            }                                                    \
        }                                                        \
    } while (0)

    // non-temporal stores are weakly ordered: fence on EVERY exit so the
    // caller (or the libjpeg fallback after an error) never races them
    struct SFence {
        ~SFence() {
#if defined(__SSE2__)
            _mm_sfence();
#endif
        }
    } fence_on_exit;

    // blocks decode into a cache-hot local buffer, then stream out once
    bool aligned = true;
    for (int c = 0; c < f.ncomp; c++)
        aligned &= (reinterpret_cast<uintptr_t>(dst[c]) & 15) == 0;
    alignas(16) int16_t blk[64];
    int16_t* const out = blk;

    int32_t pred[4] = {0, 0, 0, 0};
    for (int m = m0; m < m1; m++) {
        const int mx = m % f.mcus_x;
        const int my = m / f.mcus_x;
        for (int b = 0; b < nsched; b++) {
            const BlockSpec bs = sched[b];
            const Comp& cc = f.comp[bs.c];
            const HuffTable& dt = f.dc[cc.td];
            const HuffTable& at = f.ac[cc.ta];
            const int bx = mx * bs.mulx + bs.dx;
            const int by = my * bs.muly + bs.dy;
            std::memset(out, 0, 64 * sizeof(int16_t));
            if (bc < 32) LP_REFILL();
            const int16_t fd = dt.fast_ac[static_cast<uint32_t>(bb >> 55)];
            if (fd) {
                LP_SKIP(fd & 15);
                pred[bs.c] += fd >> 8;
            } else {
                int s;
                LP_DECODE(dt, s);
                if (s < 0 || s > 15) return -21;
                if (s) {
                    pred[bs.c] += huff_extend(
                        static_cast<int32_t>(bb >> (64 - s)), s);
                    LP_SKIP(s);
                }
            }
            out[0] = static_cast<int16_t>(pred[bs.c]);
            int k = 1;
            while (k < 64) {
                if (bc < 32) LP_REFILL();
                const int16_t fa =
                    at.fast_ac[static_cast<uint32_t>(bb >> 55)];
                if (fa) {
                    LP_SKIP(fa & 15);
                    const int v = fa >> 8;
                    const int r = (fa >> 4) & 15;
                    if (v) {
                        k += r;
                        if (k > 63) return -23;
                        out[kNat[k]] = static_cast<int16_t>(v);
                        k++;
                        continue;
                    }
                    if (r != 15) break;  // EOB
                    k += 16;
                    continue;
                }
                int rs;
                LP_DECODE(at, rs);
                if (rs < 0) return -22;
                const int r = rs >> 4, sz = rs & 15;
                if (sz == 0) {
                    if (r != 15) break;  // EOB
                    k += 16;
                    continue;
                }
                k += r;
                if (k > 63) return -23;
                out[kNat[k]] = static_cast<int16_t>(
                    huff_extend(static_cast<int32_t>(bb >> (64 - sz)), sz));
                LP_SKIP(sz);
                k++;
            }
            // store only real in-window blocks (dummy MCU-pad blocks and
            // out-of-window blocks are entropy-decoded but dropped; the
            // window's own pad rows are zero-filled by the caller)
            if (bx >= cc.wx0 && bx < cc.wx0 + cc.ww && by >= cc.wy0 &&
                by < cc.wy0 + cc.wh && bx < cc.bw && by < cc.bh)
                store_block(dst[bs.c] +
                                (static_cast<size_t>(by - cc.wy0) * cc.ww +
                                 (bx - cc.wx0)) *
                                    64,
                            blk, aligned);
        }
    }
#undef LP_REFILL
#undef LP_SKIP
#undef LP_DECODE
    return used > 8 * (seg_end - seg_start) ? -24 : 0;
}

// ---------------------------------------------------------------------------
// progressive path (SOF2): the four scan types of ITU T.81 §G.1.2,
// bit-identical to libjpeg's jdphuff.c over full-geometry planes
// ---------------------------------------------------------------------------

// Struct-based reader for the (colder) progressive scan decoders; same
// Giesen-variant-4 refill as the baseline macros. Runs past the segment
// end read as zero bits, exactly like libjpeg's marker-hit padding; the
// caller checks overrun() and declines, so truncated segments route to
// libjpeg rather than silently diverging.
struct BitReader {
    const uint8_t* bp;
    const uint8_t* const start;
    const uint8_t* const end;
    uint64_t bb = 0;
    int bc = 0;
    int64_t used = 0;
    BitReader(const uint8_t* s, const uint8_t* e) : bp(s), start(s), end(e) {}
    inline void refill() {
        if (end - bp >= 8) {
            uint64_t v;
            std::memcpy(&v, bp, 8);
            bb |= __builtin_bswap64(v) >> bc;
            bp += (63 - bc) >> 3;
            bc |= 56;
        } else {
            while (bc <= 56) {
                const uint64_t b = (bp < end) ? *bp++ : 0;
                bb |= b << (56 - bc);
                bc += 8;
            }
        }
    }
    inline void skip(int n) {
        bb <<= n;
        bc -= n;
        used += n;
    }
    inline int32_t bits(int n) {  // n in [1, 16]
        if (bc < n) refill();
        const int32_t v = static_cast<int32_t>(bb >> (64 - n));
        skip(n);
        return v;
    }
    inline int decode(const HuffTable& t) {  // symbol or -1
        if (bc < 32) refill();
        const uint16_t e = t.lookup[static_cast<uint32_t>(bb >> 56)];
        if (e) {
            skip(e >> 8);
            return e & 0xFF;
        }
        int l = 9;
        int32_t code = static_cast<int32_t>(bb >> (64 - 9));
        for (;;) {
            if (code <= t.maxcode[l]) break;
            if (++l > 16) return -1;
            code = static_cast<int32_t>(bb >> (64 - l));
        }
        skip(l);
        const int idx = code + t.valoffset[l];
        return (idx < 0 || idx > 255) ? -1 : t.vals[idx];
    }
    bool overrun() const { return used > 8 * (end - start); }
};

// Per-scan MCU geometry + interleaved block schedule.
struct ScanGeom {
    int smx = 0, smy = 0, nmcu = 0;
    struct PB {
        uint8_t i, dx, dy;  // i = index into scan comps
    } sched[64];
    int nsched = 0;
};

bool scan_geometry(const Frame& f, const Scan& sc, ScanGeom* g) {
    if (sc.ns == 1) {
        const Comp& cc = f.comp[sc.ci[0]];
        g->smx = cc.bw;
        g->smy = cc.bh;
        g->sched[0] = {0, 0, 0};
        g->nsched = 1;
    } else {
        g->smx = (f.width + 8 * f.hmax - 1) / (8 * f.hmax);
        g->smy = (f.height + 8 * f.vmax - 1) / (8 * f.vmax);
        g->nsched = 0;
        for (int i = 0; i < sc.ns; i++) {
            const Comp& cc = f.comp[sc.ci[i]];
            if (g->nsched + cc.h * cc.v > 64) return false;
            for (int dy = 0; dy < cc.v; dy++)
                for (int dx = 0; dx < cc.h; dx++)
                    g->sched[g->nsched++] = {static_cast<uint8_t>(i),
                                             static_cast<uint8_t>(dx),
                                             static_cast<uint8_t>(dy)};
        }
        // T.81 B.2.3 / libjpeg D_MAX_BLOCKS_IN_MCU: an interleaved scan
        // may carry at most 10 data units per MCU — libjpeg hard-errors
        // (JERR_BAD_MCU_SIZE) on more, so decoding such streams here
        // would diverge from the fallback's error behavior
        if (g->nsched > 10) return false;
    }
    g->nmcu = g->smx * g->smy;
    return g->nmcu > 0;
}

// DC first scans (Ss=0, Ah=0): diff-coded DC, stored << Al. Interleaved
// scans traverse the padded MCU grid; dummy pad blocks update the
// predictor but are not stored (the planes are true-geometry).
int prog_dc_first(const Frame& f, const Scan& sc, const ScanGeom& g,
                  BitReader& br, int16_t** planes, int m0, int m1) {
    int32_t pred[4] = {0, 0, 0, 0};
    for (int m = m0; m < m1; m++) {
        const int mx = m % g.smx;
        const int my = m / g.smx;
        for (int b = 0; b < g.nsched; b++) {
            const ScanGeom::PB pb = g.sched[b];
            const Comp& cc = f.comp[sc.ci[pb.i]];
            const HuffTable& dt = f.dc[sc.td[pb.i]];
            if (br.bc < 32) br.refill();
            const int16_t fd =
                dt.fast_ac[static_cast<uint32_t>(br.bb >> 55)];
            if (fd) {
                br.skip(fd & 15);
                pred[pb.i] += fd >> 8;
            } else {
                const int s = br.decode(dt);
                if (s < 0 || s > 15) return -30;
                if (s) pred[pb.i] += huff_extend(br.bits(s), s);
            }
            const int bx = sc.ns == 1 ? mx : mx * cc.h + pb.dx;
            const int by = sc.ns == 1 ? my : my * cc.v + pb.dy;
            if (bx < cc.bw && by < cc.bh)
                planes[sc.ci[pb.i]]
                      [(static_cast<size_t>(by) * cc.bw + bx) * 64] =
                    static_cast<int16_t>(pred[pb.i] << sc.Al);
        }
    }
    return 0;
}

// DC refinement scans (Ss=0, Ah>0): one appended bit per block, OR-ed at
// position Al. No Huffman decode at all; pad blocks still consume a bit.
int prog_dc_refine(const Frame& f, const Scan& sc, const ScanGeom& g,
                   BitReader& br, int16_t** planes, int m0, int m1) {
    const int16_t p1 = static_cast<int16_t>(1 << sc.Al);
    for (int m = m0; m < m1; m++) {
        const int mx = m % g.smx;
        const int my = m / g.smx;
        for (int b = 0; b < g.nsched; b++) {
            const ScanGeom::PB pb = g.sched[b];
            const Comp& cc = f.comp[sc.ci[pb.i]];
            const int bit = br.bits(1);
            const int bx = sc.ns == 1 ? mx : mx * cc.h + pb.dx;
            const int by = sc.ns == 1 ? my : my * cc.v + pb.dy;
            if (bit && bx < cc.bw && by < cc.bh)
                planes[sc.ci[pb.i]]
                      [(static_cast<size_t>(by) * cc.bw + bx) * 64] |= p1;
        }
    }
    return 0;
}

// AC first scans (Ss>0, Ah=0, ns=1): spectral band [Ss, Se] with EOB runs
// (EOBn symbols cover 2^n..2^(n+1)-1 following all-zero bands).
int prog_ac_first(const Frame& f, const Scan& sc, const ScanGeom& g,
                  BitReader& br, int16_t** planes, int m0, int m1) {
    const Comp& cc = f.comp[sc.ci[0]];
    const HuffTable& at = f.ac[sc.ta[0]];
    int16_t* const plane = planes[sc.ci[0]];
    uint32_t eobrun = 0;
    for (int m = m0; m < m1; m++) {
        if (eobrun) {
            eobrun--;
            continue;
        }
        const int bx = m % g.smx;
        const int by = m / g.smx;
        int16_t* const blk =
            plane + (static_cast<size_t>(by) * cc.bw + bx) * 64;
        for (int k = sc.Ss; k <= sc.Se; k++) {
            if (br.bc < 32) br.refill();
            const int16_t fa =
                at.fast_ac[static_cast<uint32_t>(br.bb >> 55)];
            if (fa) {
                br.skip(fa & 15);
                const int v = fa >> 8;
                const int r = (fa >> 4) & 15;
                if (v) {
                    k += r;
                    blk[kNat[k]] = static_cast<int16_t>(v << sc.Al);
                    continue;
                }
                if (r == 15) {
                    k += 15;  // ZRL
                    continue;
                }
                break;  // EOB0: run of exactly 1, this block done
            }
            const int rs = br.decode(at);
            if (rs < 0) return -31;
            const int r = rs >> 4, s = rs & 15;
            if (s) {
                k += r;
                blk[kNat[k]] = static_cast<int16_t>(
                    huff_extend(br.bits(s), s) << sc.Al);
            } else {
                if (r != 15) {
                    eobrun = 1u << r;
                    if (r) eobrun += static_cast<uint32_t>(br.bits(r));
                    eobrun--;  // this block is the run's first member
                    break;
                }
                k += 15;  // ZRL
            }
        }
    }
    return 0;
}

#if defined(__BMI2__)
// Natural-position byte -> zigzag-index bit permutation tables for the
// nonzero-mask build below (8 x 256 x 8 B = 16 KB, L1/L2-resident).
struct ZigTables {
    uint64_t byte_map[8][256];
    ZigTables() {
        uint8_t zig[64];
        for (int k = 0; k < 64; k++) zig[kNat[k]] = static_cast<uint8_t>(k);
        for (int b = 0; b < 8; b++)
            for (int m = 0; m < 256; m++) {
                uint64_t v = 0;
                for (int j = 0; j < 8; j++)
                    if (m & (1 << j)) v |= 1ull << zig[8 * b + j];
                byte_map[b][m] = v;
            }
    }
};

// Zigzag-ordered nonzero mask of one coefficient block: bit k set iff
// blk[kNat[k]] != 0. SSE compare+movemask builds the natural-order mask
// branch-free; the byte tables permute it to zigzag order.
inline uint64_t zig_nonzero(const int16_t* blk, const ZigTables& zt) {
    uint64_t nat = 0;
    const __m128i z = _mm_setzero_si128();
    for (int i = 0; i < 4; i++) {
        const __m128i a = _mm_loadu_si128(
            reinterpret_cast<const __m128i*>(blk + 16 * i));
        const __m128i b = _mm_loadu_si128(
            reinterpret_cast<const __m128i*>(blk + 16 * i + 8));
        const uint32_t m = static_cast<uint32_t>(_mm_movemask_epi8(
            _mm_packs_epi16(_mm_cmpeq_epi16(a, z), _mm_cmpeq_epi16(b, z))));
        nat |= static_cast<uint64_t>(~m & 0xFFFFu) << (16 * i);
    }
    uint64_t zig = 0;
    for (int b = 0; b < 8; b++)
        zig |= zt.byte_map[b][(nat >> (8 * b)) & 0xFF];
    return zig;
}

inline uint64_t bit_range(int a, int b) {  // bits [a, b] inclusive; 0 if b<a
    if (b < a) return 0;
    return (~0ull >> (63 - b)) & (~0ull << a);
}
#endif  // __BMI2__

// AC refinement scans (Ss>0, Ah>0, ns=1): §G.1.2.3 correction-bit
// algorithm — every already-nonzero coefficient traversed consumes one
// appended bit; runs position new ±1<<Al values over ZERO-history slots
// only. Mirrors jdphuff.c decode_mcu_AC_refine exactly (including the
// padded natural-order landing slot on corrupt-ish streams).
//
// These scans are ~83% of progressive decode time (the final full-
// precision luma refinement alone is ~45%), so on BMI2 hosts the band
// walk is mask-driven instead of positional: a per-block zigzag nonzero
// bitmask lets zero-history runs resolve with one PDEP/TZCNT (the
// (r+1)-th zero bit) and correction bits iterate ONLY the nonzero
// positions (TZCNT loop) instead of touching all 63 band slots with
// data-dependent branches. Within one scan a block's traversal never
// revisits a position at or before a new value's landing slot, so the
// block-entry mask snapshot stays valid for the whole block (newly
// placed values still update it for exactness on corrupt streams).
// The positional form below (#else) is the portable reference.
int prog_ac_refine(const Frame& f, const Scan& sc, const ScanGeom& g,
                   BitReader& br, int16_t** planes, int m0, int m1) {
    const Comp& cc = f.comp[sc.ci[0]];
    const HuffTable& at = f.ac[sc.ta[0]];
    int16_t* const plane = planes[sc.ci[0]];
    const int16_t p1 = static_cast<int16_t>(1 << sc.Al);
    // negated positive shift: `-1 << Al` is UB pre-C++20 (trips UBSan)
    const int16_t n1 = static_cast<int16_t>(-(1 << sc.Al));
    uint32_t eobrun = 0;
#if defined(__BMI2__)
    static const ZigTables zt;
    const uint64_t band = bit_range(sc.Ss, sc.Se);
    for (int m = m0; m < m1; m++) {
        const int bx = m % g.smx;
        const int by = m / g.smx;
        int16_t* const blk =
            plane + (static_cast<size_t>(by) * cc.bw + bx) * 64;
        uint64_t zig = zig_nonzero(blk, zt);

        // correction bits for the nonzero positions in cnz, in order
        // (a ≤32-bit grouped-lookahead variant measured no faster — the
        // serial bb/bc dependency chain, not the refill checks, is the
        // remaining cost)
        auto correct = [&](uint64_t cnz) {
            while (cnz) {
                const int p = __builtin_ctzll(cnz);
                cnz &= cnz - 1;
                int16_t* const cp = blk + kNat[p];
                if (br.bits(1) && (*cp & p1) == 0)
                    *cp += *cp >= 0 ? p1 : n1;
            }
        };

        if (eobrun) {  // whole block inside an EOB run: tail only
            correct(zig & band);
            eobrun--;
            continue;
        }
        int k = sc.Ss;
        while (k <= sc.Se) {
            const int rs = br.decode(at);
            if (rs < 0) return -32;
            const int r = rs >> 4;
            const int s = rs & 15;
            int16_t newval = 0;
            if (s) {
                // s != 1 is corrupt; libjpeg warns and proceeds as if
                // s == 1, so we do the same for bit-identity
                newval = br.bits(1) ? p1 : n1;
            } else if (r != 15) {
                eobrun = 1u << r;
                if (r) eobrun += static_cast<uint32_t>(br.bits(r));
                break;  // correction-bit tail handles [k, Se]
            }
            // land on the (r+1)-th zero-history slot in [k, Se] (band
            // end + 1 when the run outruns the band, = libjpeg's padded
            // natural-order landing), correcting the nonzero positions
            // passed on the way
            const uint64_t range = bit_range(k, sc.Se);
            const uint64_t sel = _pdep_u64(1ull << r, ~zig & range);
            const int stop = sel ? __builtin_ctzll(sel) : sc.Se + 1;
            correct(zig & bit_range(k, stop - 1));
            if (newval) {
                blk[kNat[stop]] = newval;
                if (stop < 64) zig |= 1ull << stop;
            }
            k = stop + 1;
        }
        if (eobrun) {
            correct(zig & bit_range(k, sc.Se));
            eobrun--;
        }
    }
#else
    for (int m = m0; m < m1; m++) {
        const int bx = m % g.smx;
        const int by = m / g.smx;
        int16_t* const blk =
            plane + (static_cast<size_t>(by) * cc.bw + bx) * 64;
        int k = sc.Ss;
        if (eobrun == 0) {
            for (; k <= sc.Se; k++) {
                const int rs = br.decode(at);
                if (rs < 0) return -32;
                int r = rs >> 4;
                const int s = rs & 15;
                int16_t newval = 0;
                if (s) {
                    // s != 1 is corrupt; libjpeg warns and proceeds as if
                    // s == 1, so we do the same for bit-identity
                    newval = br.bits(1) ? p1 : n1;
                } else if (r != 15) {
                    eobrun = 1u << r;
                    if (r) eobrun += static_cast<uint32_t>(br.bits(r));
                    break;  // correction-bit tail handles [k, Se]
                }
                // advance r zero-history positions, emitting correction
                // bits for every nonzero-history coefficient on the way
                while (k <= sc.Se) {
                    int16_t* const cp = blk + kNat[k];
                    if (*cp) {
                        if (br.bits(1) && (*cp & p1) == 0)
                            *cp += *cp >= 0 ? p1 : n1;
                    } else {
                        if (--r < 0) break;
                    }
                    k++;
                }
                if (newval) blk[kNat[k]] = newval;
            }
        }
        if (eobrun) {
            // inside an EOB run only correction bits appear
            for (; k <= sc.Se; k++) {
                int16_t* const cp = blk + kNat[k];
                if (*cp) {
                    if (br.bits(1) && (*cp & p1) == 0)
                        *cp += *cp >= 0 ? p1 : n1;
                }
            }
            eobrun--;
        }
    }
#endif
    return 0;
}

// Progressive multi-scan state machine: decode the already-parsed first
// scan, then keep walking markers (DHT/DQT/DRI may redefine state between
// scans) until EOI. Planes are full geometry: caller arrays directly when
// win == null, else a persistent thread-local scratch with a window
// copy-out — refinement-scan PARSING depends on every traversed block's
// coefficient history, so window-direct storage is structurally
// impossible here (unlike the baseline single pass).
int run_progressive(Frame& f, const Scan& first, size_t first_scan_start,
                    const uint8_t* buf, size_t len, int16_t** coefs,
                    uint16_t* qtables, const int32_t* win) {
    int16_t* planes[4] = {};
    static thread_local std::vector<int16_t> scratch;
    // Bound the retained scratch on EVERY exit path: one oversized
    // progressive input must not pin its full-geometry coefficient
    // arrays (hundreds of MB for very large images) in every pool thread
    // that touched it. 8 MB covers the 1080p serving class; larger
    // decodes give the memory back.
    struct ScratchTrim {
        std::vector<int16_t>& v;
        ~ScratchTrim() {
            constexpr size_t kMaxRetained = (8u << 20) / sizeof(int16_t);
            if (v.capacity() > kMaxRetained) {
                v.clear();
                v.shrink_to_fit();
            }
        }
    } trim{scratch};
    {
        size_t total = 0;
        for (int c = 0; c < f.ncomp; c++)
            total += static_cast<size_t>(f.comp[c].bw) * f.comp[c].bh * 64;
        if (win) {
            if (scratch.size() < total) scratch.resize(total);
            std::memset(scratch.data(), 0, total * sizeof(int16_t));
            size_t off = 0;
            for (int c = 0; c < f.ncomp; c++) {
                planes[c] = scratch.data() + off;
                off += static_cast<size_t>(f.comp[c].bw) * f.comp[c].bh * 64;
            }
        } else {
            for (int c = 0; c < f.ncomp; c++) {
                planes[c] = coefs[c];
                std::memset(planes[c], 0,
                            static_cast<size_t>(f.comp[c].bw) * f.comp[c].bh *
                                64 * sizeof(int16_t));
            }
        }
    }

    Scan sc = first;
    size_t scan_start = first_scan_start;
    std::vector<uint8_t> clean;
    std::vector<size_t> segs;
    bool done = false;
    while (!done) {
        // ---- validate scan parameters (hard libjpeg errors -> decline,
        // so the fallback reproduces libjpeg's rejection behavior)
        if (sc.Al > 13) return kDecline;
        if (sc.Ah != 0 && sc.Ah != sc.Al + 1) return kDecline;
        const bool dc_band = sc.Ss == 0;
        if (dc_band) {
            if (sc.Se != 0) return kDecline;
            if (sc.Ah == 0)
                for (int i = 0; i < sc.ns; i++)
                    if (!f.dc[sc.td[i]].present) return kDecline;
        } else {
            if (sc.ns != 1 || sc.Se < sc.Ss || sc.Se > 63) return kDecline;
            if (!f.ac[sc.ta[0]].present) return kDecline;
        }
        ScanGeom g;
        if (!scan_geometry(f, sc, &g)) return kDecline;

        // ---- destuff this scan's entropy data
        clean.clear();
        segs.clear();
        segs.push_back(0);
        uint8_t endm = 0;
        size_t next_pos = 0;
        int rc = destuff_scan(buf, len, scan_start, clean, segs, &endm,
                              &next_pos);
        if (rc != 0) return rc;
        segs.push_back(clean.size());
        const int ri = f.restart_interval;
        const size_t n_segs = segs.size() - 1;
        const size_t expect =
            ri > 0 ? static_cast<size_t>((g.nmcu + ri - 1) / ri) : 1;
        if (n_segs != expect) return kDecline;

        // ---- decode (restart segments reset DC preds + the EOB run)
        for (size_t s = 0; s < n_segs; s++) {
            const int m0 = static_cast<int>(s) * (ri > 0 ? ri : g.nmcu);
            const int m1 = ri > 0 ? std::min(g.nmcu, m0 + ri) : g.nmcu;
            BitReader br(clean.data() + segs[s], clean.data() + segs[s + 1]);
            if (dc_band)
                rc = sc.Ah == 0
                         ? prog_dc_first(f, sc, g, br, planes, m0, m1)
                         : prog_dc_refine(f, sc, g, br, planes, m0, m1);
            else
                rc = sc.Ah == 0
                         ? prog_ac_first(f, sc, g, br, planes, m0, m1)
                         : prog_ac_refine(f, sc, g, br, planes, m0, m1);
            if (rc != 0) return rc;
            if (br.overrun()) return -34;  // truncated segment -> libjpeg
        }

        // ---- walk markers to the next SOS (or EOI)
        size_t pos = next_pos;
        bool have_next = false;
        while (pos + 2 <= len) {
            if (buf[pos] != 0xFF) return kDecline;
            const uint8_t m = buf[pos + 1];
            if (m == 0xFF) {
                pos++;
                continue;
            }
            if (m == 0xD9) {  // EOI
                done = true;
                break;
            }
            // TEM/RSTn here are stream corruption; a stray SOI mid-stream
            // has no length field either (treating it as length-prefixed
            // would read entropy bytes as a length and could land on a
            // parseable SOS where libjpeg hard-errors) — decline all three
            // so the libjpeg fallback preserves error behavior.
            if (m == 0x01 || m == 0xD8 || (m >= 0xD0 && m <= 0xD7))
                return kDecline;
            if (pos + 4 > len) return kDecline;
            const size_t seglen =
                (static_cast<size_t>(buf[pos + 2]) << 8) | buf[pos + 3];
            if (seglen < 2 || pos + 2 + seglen > len) return kDecline;
            const uint8_t* seg = buf + pos + 4;
            const size_t slen = seglen - 2;
            if (m == 0xC4) {
                if (!parse_dht(f, seg, slen)) return kDecline;
            } else if (m == 0xDB) {
                if (!parse_dqt(f, seg, slen)) return kDecline;
            } else if (m == 0xDD) {
                if (slen != 2) return kDecline;
                f.restart_interval = (seg[0] << 8) | seg[1];
            } else if (m == 0xDA) {
                if (!parse_sos(f, seg, slen, &sc)) return kDecline;
                scan_start = pos + 2 + seglen;
                have_next = true;
            } else if ((m >= 0xC0 && m <= 0xCF) || m == 0xDC || m == 0xDE ||
                       m == 0xDF) {
                return kDecline;  // second SOF / DNL / DHP / EXP
            }
            pos += 2 + seglen;
            if (have_next) break;
        }
        if (!done && !have_next) return kDecline;  // ran off the end
    }

    // ---- outputs: qtables reflect every DQT seen (they may arrive
    // between scans), window copy-out when windowed
    for (int t = 0; t < 4; t++) {
        if (f.qt_seen[t])
            std::memcpy(qtables + t * 64, f.qt[t], 64 * sizeof(uint16_t));
        else
            std::memset(qtables + t * 64, 0, 64 * sizeof(uint16_t));
    }
    if (win) {
        for (int c = 0; c < f.ncomp; c++) {
            const Comp& cc = f.comp[c];
            for (int r = 0; r < cc.wh; r++) {
                int16_t* dst = coefs[c] + static_cast<size_t>(r) * cc.ww * 64;
                const int sy = cc.wy0 + r;
                if (sy >= cc.bh) {  // luma window may cover the MCU pad row
                    std::memset(dst, 0,
                                static_cast<size_t>(cc.ww) * 64 *
                                    sizeof(int16_t));
                    continue;
                }
                std::memcpy(dst,
                            planes[c] +
                                (static_cast<size_t>(sy) * cc.bw + cc.wx0) *
                                    64,
                            static_cast<size_t>(cc.ww) * 64 *
                                sizeof(int16_t));
            }
        }
    }
    return 0;
}

}  // namespace

extern "C" {

// Huffman-profile coefficient decode straight into caller arrays
// (baseline single-scan and progressive multi-scan; see file header).
//   coefs:   per-component int16[bh*bw*64] (true block geometry, natural
//            coefficient order — same layout lp_jpeg_decode_coefs fills)
//   qtables: uint16[4*64] natural order (zeros for absent tables)
//   nthreads: restart-segment threading (<=1 = serial; baseline scans
//            only — progressive files rarely carry restart markers and
//            decode serially regardless)
//   win:     optional per-component block windows, int32[4*4] as
//            {y0, x0, h, w} rows: coefs[c] is then a (h, w, 64) array of
//            blocks [y0, y0+h) x [x0, x0+w) — the serving Fit-crop path
//            (mcu_decode_window) decodes DIRECTLY into the window instead
//            of staging through full-geometry scratch (baseline), or
//            copies the window out of a thread-local full-geometry
//            scratch (progressive, whose refinement parsing needs every
//            block's history). Window rows at or past the component's
//            true block height are zero-filled (the luma window may
//            include the MCU pad row).
// Returns 0 ok; -10 declined (caller MUST fall back to libjpeg); other
// negatives = anomalous stream (caller should also fall back so the
// error behavior stays libjpeg's).
int lp_jpeg_decode_coefs_win(const uint8_t* buf, size_t len,
                             int16_t** coefs, uint16_t* qtables,
                             int32_t nthreads, const int32_t* win) {
    if (len < 4 || buf[0] != 0xFF || buf[1] != 0xD8) return kDecline;
    Frame f;
    Scan scan;
    bool sof_seen = false, sos_seen = false;
    size_t scan_start = 0;

    size_t pos = 2;
    while (pos + 4 <= len) {
        if (buf[pos] != 0xFF) return kDecline;
        uint8_t m = buf[pos + 1];
        if (m == 0xFF) {  // fill byte
            pos++;
            continue;
        }
        if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) {
            pos += 2;
            continue;
        }
        if (m == 0xD9) return kDecline;  // EOI before SOS
        const size_t seglen =
            (static_cast<size_t>(buf[pos + 2]) << 8) | buf[pos + 3];
        if (seglen < 2 || pos + 2 + seglen > len) return kDecline;
        const uint8_t* seg = buf + pos + 4;
        const size_t slen = seglen - 2;
        switch (m) {
            case 0xC2:  // SOF2: progressive, Huffman
                f.progressive = true;
                [[fallthrough]];
            case 0xC0:
            case 0xC1: {  // SOF0/1: baseline (extended) sequential, Huffman
                if (sof_seen || slen < 6) return kDecline;
                if (seg[0] != 8) return kDecline;  // 12-bit: decline
                f.height = (seg[1] << 8) | seg[2];
                f.width = (seg[3] << 8) | seg[4];
                f.ncomp = seg[5];
                if (f.width <= 0 || f.height <= 0 || f.ncomp < 1 ||
                    f.ncomp > 4 || slen < 6 + 3 * static_cast<size_t>(f.ncomp))
                    return kDecline;
                for (int c = 0; c < f.ncomp; c++) {
                    f.comp[c].id = seg[6 + 3 * c];
                    f.comp[c].h = seg[7 + 3 * c] >> 4;
                    f.comp[c].v = seg[7 + 3 * c] & 15;
                    f.comp[c].tq = seg[8 + 3 * c];
                    if (f.comp[c].h < 1 || f.comp[c].h > 4 ||
                        f.comp[c].v < 1 || f.comp[c].v > 4 ||
                        f.comp[c].tq > 3)
                        return kDecline;
                    if (f.comp[c].h > f.hmax) f.hmax = f.comp[c].h;
                    if (f.comp[c].v > f.vmax) f.vmax = f.comp[c].v;
                }
                sof_seen = true;
                break;
            }
            case 0xC3:
            case 0xC5:
            case 0xC6:
            case 0xC7:
            case 0xC9:
            case 0xCA:
            case 0xCB:
            case 0xCD:
            case 0xCE:
            case 0xCF:  // hierarchical / arithmetic / lossless
            case 0xCC:  // DAC
            case 0xDE:  // DHP
            case 0xDF:  // EXP
                return kDecline;
            case 0xC4:
                if (!parse_dht(f, seg, slen)) return kDecline;
                break;
            case 0xDB:
                if (!parse_dqt(f, seg, slen)) return kDecline;
                break;
            case 0xDD: {  // DRI
                if (slen != 2) return kDecline;
                f.restart_interval = (seg[0] << 8) | seg[1];
                break;
            }
            case 0xDA: {  // SOS
                if (!sof_seen) return kDecline;
                if (!parse_sos(f, seg, slen, &scan)) return kDecline;
                if (!f.progressive) {
                    // baseline fast path handles exactly the universal
                    // form: one interleaved scan, components in frame
                    // order, full spectral band
                    if (scan.ns != f.ncomp) return kDecline;
                    for (int c = 0; c < scan.ns; c++) {
                        if (scan.ci[c] != c) return kDecline;
                        f.comp[c].td = scan.td[c];
                        f.comp[c].ta = scan.ta[c];
                    }
                    if (scan.Ss != 0 || scan.Se != 63 || scan.Ah != 0 ||
                        scan.Al != 0)
                        return kDecline;
                }
                scan_start = pos + 2 + seglen;
                sos_seen = true;
                break;
            }
            default:  // APPn, COM, ...: skip
                break;
        }
        if (sos_seen) break;
        pos += 2 + seglen;
    }
    if (!sos_seen) return kDecline;

    // T.81 B.2.3 / libjpeg D_MAX_BLOCKS_IN_MCU: the baseline fast path
    // is one interleaved scan, so the whole frame's blocks/MCU must be
    // <= 10 (libjpeg hard-errors with JERR_BAD_MCU_SIZE on more —
    // decoding such a stream here would diverge from the fallback)
    if (!f.progressive && f.ncomp > 1) {
        int blocks = 0;
        for (int c = 0; c < f.ncomp; c++) blocks += f.comp[c].h * f.comp[c].v;
        if (blocks > 10) return kDecline;
    }

    // geometry + (baseline) table availability + window validation
    for (int c = 0; c < f.ncomp; c++) {
        Comp& cc = f.comp[c];
        cc.bw = static_cast<int>(
            (static_cast<long>(f.width) * cc.h + 8L * f.hmax - 1) /
            (8L * f.hmax));
        cc.bh = static_cast<int>(
            (static_cast<long>(f.height) * cc.v + 8L * f.vmax - 1) /
            (8L * f.vmax));
        // a component whose quant table was never defined decodes with
        // all-zero dequant tables where libjpeg hard-errors
        // (JERR_NO_QUANT_TABLE): decline so the error behavior stays
        // libjpeg's (applies to progressive too)
        if (!f.qt_seen[cc.tq]) return kDecline;
        if (!f.progressive &&
            (!f.dc[cc.td].present || !f.ac[cc.ta].present))
            return kDecline;
        if (win) {
            cc.wy0 = win[4 * c];
            cc.wx0 = win[4 * c + 1];
            cc.wh = win[4 * c + 2];
            cc.ww = win[4 * c + 3];
            if (cc.wy0 < 0 || cc.wx0 < 0 || cc.wh <= 0 || cc.ww <= 0 ||
                cc.wx0 + cc.ww > cc.bw)
                return kDecline;  // col overflow never happens (see caller)
        } else {
            cc.wh = cc.bh;
            cc.ww = cc.bw;
        }
    }

    if (f.progressive)
        return run_progressive(f, scan, scan_start, buf, len, coefs,
                               qtables, win);

    if (f.ncomp == 1) {
        // single-component scan: MCU = one block over the unpadded grid
        f.mcus_x = f.comp[0].bw;
        f.mcus_y = f.comp[0].bh;
    } else {
        f.mcus_x = (f.width + 8 * f.hmax - 1) / (8 * f.hmax);
        f.mcus_y = (f.height + 8 * f.vmax - 1) / (8 * f.vmax);
    }
    f.nmcu = f.mcus_x * f.mcus_y;
    if (f.nmcu <= 0) return kDecline;

    // destuff the scan: strip 0xFF00 stuffing, record restart boundaries
    std::vector<uint8_t> clean;
    clean.reserve(len - scan_start);
    std::vector<size_t> segs;  // start offset of each segment in `clean`
    segs.push_back(0);
    {
        uint8_t endm = 0;
        size_t next_pos = 0;
        int rc = destuff_scan(buf, len, scan_start, clean, segs, &endm,
                              &next_pos);
        if (rc != 0) return rc;
        if (endm != 0xD9) return kDecline;  // DNL / another scan
    }
    segs.push_back(clean.size());

    const int ri = f.restart_interval;
    const size_t n_segs = segs.size() - 1;
    const size_t expect =
        ri > 0 ? static_cast<size_t>((f.nmcu + ri - 1) / ri) : 1;
    if (n_segs != expect) return kDecline;

    // qtables out (all 4 slots, natural order, zeros when absent) — the
    // same contract as lp_jpeg_decode_coefs
    for (int t = 0; t < 4; t++) {
        if (f.qt_seen[t])
            std::memcpy(qtables + t * 64, f.qt[t], 64 * sizeof(uint16_t));
        else
            std::memset(qtables + t * 64, 0, 64 * sizeof(uint16_t));
    }

    // zero window rows at/past the true block height (the luma window may
    // cover the MCU pad row, which full-geometry scratch kept zero)
    for (int c = 0; c < f.ncomp; c++) {
        const Comp& cc = f.comp[c];
        for (int r = std::max(cc.bh - cc.wy0, 0); r < cc.wh; r++)
            std::memset(coefs[c] + static_cast<size_t>(r) * cc.ww * 64, 0,
                        static_cast<size_t>(cc.ww) * 64 * sizeof(int16_t));
    }

    auto run_segs = [&](size_t s0, size_t s1) -> int {
        for (size_t s = s0; s < s1; s++) {
            const int m0 = static_cast<int>(s) * (ri > 0 ? ri : f.nmcu);
            const int m1 =
                ri > 0 ? std::min(f.nmcu, m0 + ri) : f.nmcu;
            int rc = decode_mcus(f, clean.data() + segs[s],
                                 clean.data() + segs[s + 1], coefs, m0, m1);
            if (rc != 0) return rc;
        }
        return 0;
    };

    if (nthreads > 1 && n_segs > 1) {
        const int nt = static_cast<int>(
            std::min<size_t>(static_cast<size_t>(nthreads), n_segs));
        std::vector<int> rcs(nt, 0);
        std::vector<std::thread> workers;
        workers.reserve(nt);
        for (int w = 0; w < nt; w++) {
            const size_t s0 = n_segs * w / nt;
            const size_t s1 = n_segs * (w + 1) / nt;
            workers.emplace_back(
                [&rcs, &run_segs, w, s0, s1]() { rcs[w] = run_segs(s0, s1); });
        }
        for (auto& t : workers) t.join();
        for (int rc : rcs)
            if (rc != 0) return rc;
        return 0;
    }
    return run_segs(0, n_segs);
}

// Full-plane variant (the common non-Fit serving path and the streaming
// decoder): dst layout identical to lp_jpeg_decode_coefs.
int lp_jpeg_decode_coefs_fast(const uint8_t* buf, size_t len,
                              int16_t** coefs, uint16_t* qtables,
                              int32_t nthreads) {
    return lp_jpeg_decode_coefs_win(buf, len, coefs, qtables, nthreads,
                                    nullptr);
}

}  // extern "C"
