// JPEG 2000 Tier-1 (EBCOT) codeblock codec — C++ port of the Python
// reference in lilliput_tpu/codecs/jp2_t1.py (ISO/IEC 15444-1 Annexes
// C/D; the reference codes JP2 via OpenJPEG inside its OpenCV build,
// /root/reference/deps/build-deps-linux.sh:289). Same algorithm, ~100x
// faster than the per-bit Python loop; tests cross-check the two.
//
// Full codeblock-style support (bypass/reset/termall/vsc/segsym) in
// both directions, with codeword segments per the opj maxpasses rule.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct MqState {
    uint16_t qe;
    uint8_t nmps, nlps, sw;
};

static const MqState kStates[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},
    {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0}, {0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0},
    {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0}, {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0},
};

constexpr int kNCtx = 19;
constexpr int kCtxUni = 18;
constexpr int kCtxRl = 17;

// style bits (SPcod Table A.19)
constexpr int kStyLazy = 0x01;
constexpr int kStyReset = 0x02;
constexpr int kStyTermall = 0x04;
constexpr int kStyVsc = 0x08;
constexpr int kStySegsym = 0x20;

struct MqDec {
    const uint8_t* d;
    int n, bp;
    uint32_t c;
    int32_t a, ct;
    uint8_t idx[kNCtx], mps[kNCtx];

    void reset_ctx() {
        std::memset(idx, 0, sizeof(idx));
        std::memset(mps, 0, sizeof(mps));
        idx[kCtxUni] = 46;
        idx[kCtxRl] = 3;
        idx[0] = 4;
    }

    // register (re-)init at a codeword segment boundary; context
    // states persist across segments unless RESET style clears them
    void init_regs(const uint8_t* data, int len) {
        d = data;
        n = len;
        bp = 0;
        uint8_t b0 = n ? d[0] : 0xFF;
        c = static_cast<uint32_t>(b0) << 16;
        bytein();
        c <<= 7;
        ct -= 7;
        a = 0x8000;
    }

    void init(const uint8_t* data, int len) {
        init_regs(data, len);
        reset_ctx();
    }

    void bytein() {
        if (bp < n && d[bp] == 0xFF) {
            if (bp + 1 >= n || d[bp + 1] > 0x8F) {
                c += 0xFF00;
                ct = 8;
            } else {
                bp += 1;
                c += static_cast<uint32_t>(d[bp]) << 9;
                ct = 7;
            }
        } else {
            bp += 1;
            uint8_t nxt = bp < n ? d[bp] : 0xFF;
            c += static_cast<uint32_t>(nxt) << 8;
            ct = 8;
        }
    }

    int decode(int cx) {
        const MqState& st = kStates[idx[cx]];
        int d_;
        a -= st.qe;
        if (((c >> 16) & 0xFFFF) < st.qe) {
            if (a < static_cast<int32_t>(st.qe)) {
                d_ = mps[cx];
                idx[cx] = st.nmps;
            } else {
                d_ = 1 - mps[cx];
                if (st.sw) mps[cx] = 1 - mps[cx];
                idx[cx] = st.nlps;
            }
            a = st.qe;
        } else {
            c -= static_cast<uint32_t>(st.qe) << 16;
            if (a & 0x8000) return mps[cx];
            if (a < static_cast<int32_t>(st.qe)) {
                d_ = 1 - mps[cx];
                if (st.sw) mps[cx] = 1 - mps[cx];
                idx[cx] = st.nlps;
            } else {
                d_ = mps[cx];
                idx[cx] = st.nmps;
            }
        }
        do {
            if (ct == 0) bytein();
            a <<= 1;
            c <<= 1;
            ct -= 1;
        } while (!(a & 0x8000));
        return d_;
    }
};

// Raw (bypass) bit reader, D.6 — port of opj raw decode: MSB-first,
// a byte after 0xFF carries 7 bits, reads past the end feed 0xFF.
struct RawDec {
    const uint8_t* d;
    int n, pos;
    uint32_t c;
    int ct;

    void init(const uint8_t* data, int len) {
        d = data;
        n = len;
        pos = 0;
        c = 0;
        ct = 0;
    }
    int bit() {
        if (ct == 0) {
            ct = 8;
            if (pos >= n) {
                c = 0xFF;
            } else {
                if (c == 0xFF) ct = 7;
                c = d[pos++];
            }
        }
        ct -= 1;
        return (c >> ct) & 1;
    }
};

static int zc_context(int band, int h, int v, int dg) {
    if (band == 1) { int t = h; h = v; v = t; }
    if (band != 2) {
        if (h == 2) return 8;
        if (h == 1) {
            if (v >= 1) return 7;
            return dg >= 1 ? 6 : 5;
        }
        if (v == 2) return 4;
        if (v == 1) return 3;
        return dg < 2 ? dg : 2;
    }
    if (dg >= 3) return 8;
    if (dg == 2) return (h + v >= 1) ? 7 : 6;
    if (dg == 1) {
        if (h + v >= 2) return 5;
        return (h + v == 1) ? 4 : 3;
    }
    if (h + v >= 2) return 2;
    return h + v;
}

static void sc_context(int h0, int h1, int v0, int v1, int* cx, int* xorbit) {
    int hc = h0 + h1;
    if (hc > 1) hc = 1;
    if (hc < -1) hc = -1;
    int vc = v0 + v1;
    if (vc > 1) vc = 1;
    if (vc < -1) vc = -1;
    if (hc == 1) {
        if (vc == 1) { *cx = 13; *xorbit = 0; }
        else if (vc == 0) { *cx = 12; *xorbit = 0; }
        else { *cx = 11; *xorbit = 0; }
    } else if (hc == 0) {
        if (vc == 1) { *cx = 10; *xorbit = 0; }
        else if (vc == 0) { *cx = 9; *xorbit = 0; }
        else { *cx = 10; *xorbit = 1; }
    } else {
        if (vc == 1) { *cx = 11; *xorbit = 1; }
        else if (vc == 0) { *cx = 12; *xorbit = 1; }
        else { *cx = 13; *xorbit = 1; }
    }
}

struct T1 {
    int w, h, band;
    bool vsc;
    std::vector<int32_t> mag;
    std::vector<uint8_t> sig, vis, first_ref;
    std::vector<int8_t> sgn, lastp;
    MqDec mq;
    RawDec raw;

    inline uint8_t s_at(int x, int y) const {
        return (x >= 0 && x < w && y >= 0 && y < h) ? sig[y * w + x] : 0;
    }
    inline int sv(int x, int y) const {
        if (x >= 0 && x < w && y >= 0 && y < h && sig[y * w + x])
            return sgn[y * w + x];
        return 0;
    }
    // VSC: the row below a stripe boundary is treated insignificant
    // for context formation — opj suppresses the north-word flag
    // update entirely, so the mask covers ZC, SC, MR and the cleanup
    // run-length aggregation alike (D.7).
    inline void neigh(int x, int y, int* hn, int* vn, int* dn) const {
        bool s = vsc && (y & 3) == 3;
        *hn = s_at(x - 1, y) + s_at(x + 1, y);
        *vn = s_at(x, y - 1) + (s ? 0 : s_at(x, y + 1));
        *dn = s_at(x - 1, y - 1) + s_at(x + 1, y - 1);
        if (!s) *dn += s_at(x - 1, y + 1) + s_at(x + 1, y + 1);
    }
    void decode_sign(int x, int y) {
        bool s = vsc && (y & 3) == 3;
        int cx, xorbit;
        sc_context(sv(x - 1, y), sv(x + 1, y), sv(x, y - 1),
                   s ? 0 : sv(x, y + 1), &cx, &xorbit);
        int bit = mq.decode(cx) ^ xorbit;
        sgn[y * w + x] = bit ? -1 : 1;
    }

    void spp(int p, bool is_raw) {
        const int32_t bit = 1 << p;
        for (int y0 = 0; y0 < h; y0 += 4) {
            int ylim = y0 + 4 < h ? y0 + 4 : h;
            for (int x = 0; x < w; x++) {
                for (int y = y0; y < ylim; y++) {
                    int i = y * w + x;
                    if (sig[i]) continue;
                    int hn, vn, dn;
                    neigh(x, y, &hn, &vn, &dn);
                    if (hn + vn + dn == 0) continue;
                    vis[i] = 1;
                    if (is_raw) {
                        if (raw.bit()) {
                            sig[i] = 1;
                            mag[i] |= bit;
                            lastp[i] = static_cast<int8_t>(p);
                            sgn[i] = raw.bit() ? -1 : 1;
                        }
                    } else if (mq.decode(zc_context(band, hn, vn, dn))) {
                        sig[i] = 1;
                        mag[i] |= bit;
                        lastp[i] = static_cast<int8_t>(p);
                        decode_sign(x, y);
                    }
                }
            }
        }
    }

    void mrp(int p, bool is_raw) {
        const int32_t bit = 1 << p;
        for (int y0 = 0; y0 < h; y0 += 4) {
            int ylim = y0 + 4 < h ? y0 + 4 : h;
            for (int x = 0; x < w; x++) {
                for (int y = y0; y < ylim; y++) {
                    int i = y * w + x;
                    if (!sig[i] || vis[i]) continue;
                    if (is_raw) {
                        if (raw.bit()) mag[i] |= bit;
                        lastp[i] = static_cast<int8_t>(p);
                        vis[i] = 1;
                        continue;
                    }
                    int cx;
                    if (first_ref[i]) {
                        int hn, vn, dn;
                        neigh(x, y, &hn, &vn, &dn);
                        cx = (hn + vn + dn) ? 15 : 14;
                        first_ref[i] = 0;
                    } else {
                        cx = 16;
                    }
                    if (mq.decode(cx)) mag[i] |= bit;
                    lastp[i] = static_cast<int8_t>(p);
                    vis[i] = 1;
                }
            }
        }
    }

    void cleanup(int p, bool segsym) {
        const int32_t bit = 1 << p;
        for (int y0 = 0; y0 < h; y0 += 4) {
            int ylim = y0 + 4 < h ? y0 + 4 : h;
            for (int x = 0; x < w; x++) {
                int y = y0;
                if (y0 + 4 <= h) {
                    bool rl = true;
                    for (int yy = y0; yy < y0 + 4; yy++) {
                        int i = yy * w + x;
                        if (sig[i] || vis[i]) { rl = false; break; }
                        int hn, vn, dn;
                        neigh(x, yy, &hn, &vn, &dn);
                        if (hn + vn + dn) { rl = false; break; }
                    }
                    if (rl) {
                        if (!mq.decode(kCtxRl)) continue;
                        int r = (mq.decode(kCtxUni) << 1)
                                | mq.decode(kCtxUni);
                        y = y0 + r;
                        int i = y * w + x;
                        sig[i] = 1;
                        mag[i] |= bit;
                        lastp[i] = static_cast<int8_t>(p);
                        decode_sign(x, y);
                        y += 1;
                    }
                }
                for (int yy = y; yy < ylim; yy++) {
                    int i = yy * w + x;
                    if (sig[i] || vis[i]) { vis[i] = 0; continue; }
                    int hn, vn, dn;
                    neigh(x, yy, &hn, &vn, &dn);
                    if (mq.decode(zc_context(band, hn, vn, dn))) {
                        sig[i] = 1;
                        mag[i] |= bit;
                        lastp[i] = static_cast<int8_t>(p);
                        decode_sign(x, yy);
                    }
                }
            }
        }
        std::memset(vis.data(), 0, vis.size());
        if (segsym) {
            // segmentation symbol 1010: decode and discard
            for (int k = 0; k < 4; k++) mq.decode(kCtxUni);
        }
    }
};

// ---------------------------------------------------------------------------
// Tier-1 ENCODER — mirror of jp2_t1.py encode_codeblock_py.
// ---------------------------------------------------------------------------

struct MqEnc {
    std::vector<uint8_t> buf;
    size_t bp;
    uint32_t c;
    int32_t a, ct;
    uint8_t idx[kNCtx], mps[kNCtx];

    void init(uint8_t prev_byte) {
        buf.clear();
        buf.push_back(prev_byte);
        bp = 0;
        c = 0;
        a = 0x8000;
        ct = prev_byte == 0xFF ? 13 : 12;
    }
    void reset_ctx() {
        std::memset(idx, 0, sizeof(idx));
        std::memset(mps, 0, sizeof(mps));
        idx[kCtxUni] = 46;
        idx[kCtxRl] = 3;
        idx[0] = 4;
    }
    void byteout() {
        if (buf[bp] == 0xFF) {
            bp += 1;
            buf.push_back((c >> 20) & 0xFF);
            c &= 0xFFFFF;
            ct = 7;
        } else if ((c & 0x8000000) == 0) {
            bp += 1;
            buf.push_back((c >> 19) & 0xFF);
            c &= 0x7FFFF;
            ct = 8;
        } else {
            buf[bp] += 1;
            if (buf[bp] == 0xFF) {
                c &= 0x7FFFFFF;
                bp += 1;
                buf.push_back((c >> 20) & 0xFF);
                c &= 0xFFFFF;
                ct = 7;
            } else {
                bp += 1;
                buf.push_back((c >> 19) & 0xFF);
                c &= 0x7FFFF;
                ct = 8;
            }
        }
    }
    void renorm() {
        do {
            a = (a << 1) & 0xFFFF;
            c <<= 1;
            ct -= 1;
            if (ct == 0) byteout();
        } while (!(a & 0x8000));
    }
    void encode(int d, int cx) {
        const MqState& st = kStates[idx[cx]];
        a -= st.qe;
        if (d == mps[cx]) {
            if ((a & 0x8000) == 0) {
                if (a < static_cast<int32_t>(st.qe)) a = st.qe;
                else c += st.qe;
                idx[cx] = st.nmps;
                renorm();
            } else {
                c += st.qe;
            }
        } else {
            if (a < static_cast<int32_t>(st.qe)) c += st.qe;
            else a = st.qe;
            if (st.sw) mps[cx] = 1 - mps[cx];
            idx[cx] = st.nlps;
            renorm();
        }
    }
    // Standard Elias termination (C.2.9); returns segment length
    // (sentinel dropped, trailing 0xFF excluded).
    size_t flush() {
        uint32_t tempc = c + static_cast<uint32_t>(a);
        c |= 0xFFFF;
        if (c >= tempc) c -= 0x8000;
        c <<= ct;
        byteout();
        c <<= ct;
        byteout();
        size_t end = buf[bp] != 0xFF ? bp + 1 : bp;
        return end - 1;  // bytes after the sentinel
    }
};

// Raw (bypass) bit writer: mirror of RawDec; flush zero-pads and
// never ends the segment on 0xFF.
struct RawEnc {
    std::vector<uint8_t> out;
    uint32_t acc;
    int nacc;
    uint8_t last;

    void init() {
        out.clear();
        acc = 0;
        nacc = 0;
        last = 0;
    }
    inline int cap() const { return last == 0xFF ? 7 : 8; }
    void bit(int b) {
        acc = (acc << 1) | (b & 1);
        nacc += 1;
        if (nacc == cap()) {
            out.push_back(static_cast<uint8_t>(acc));
            last = static_cast<uint8_t>(acc);
            acc = 0;
            nacc = 0;
        }
    }
    void flush() {
        if (nacc) {
            acc <<= cap() - nacc;
            out.push_back(static_cast<uint8_t>(acc));
            last = static_cast<uint8_t>(acc);
            acc = 0;
            nacc = 0;
        }
        if (last == 0xFF) {
            out.push_back(0);
            last = 0;
        }
    }
};

struct T1Enc {
    int w, h, band;
    bool vsc;
    std::vector<int32_t> mag;
    std::vector<uint8_t> sig, vis, first_ref;
    std::vector<int8_t> sgn_in, sgn_out;
    MqEnc mq;
    RawEnc raw;
    bool use_raw;

    inline uint8_t s_at(int x, int y) const {
        return (x >= 0 && x < w && y >= 0 && y < h) ? sig[y * w + x] : 0;
    }
    inline int sv(int x, int y) const {
        if (x >= 0 && x < w && y >= 0 && y < h && sig[y * w + x])
            return sgn_out[y * w + x];
        return 0;
    }
    inline void neigh(int x, int y, int* hn, int* vn, int* dn) const {
        bool s = vsc && (y & 3) == 3;
        *hn = s_at(x - 1, y) + s_at(x + 1, y);
        *vn = s_at(x, y - 1) + (s ? 0 : s_at(x, y + 1));
        *dn = s_at(x - 1, y - 1) + s_at(x + 1, y - 1);
        if (!s) *dn += s_at(x - 1, y + 1) + s_at(x + 1, y + 1);
    }
    void encode_sign(int x, int y) {
        bool s = vsc && (y & 3) == 3;
        int cx, xorbit;
        sc_context(sv(x - 1, y), sv(x + 1, y), sv(x, y - 1),
                   s ? 0 : sv(x, y + 1), &cx, &xorbit);
        int bit = (sgn_in[y * w + x] < 0 ? 1 : 0) ^ xorbit;
        mq.encode(bit, cx);
        sgn_out[y * w + x] = sgn_in[y * w + x];
    }

    void spp(int p) {
        for (int y0 = 0; y0 < h; y0 += 4) {
            int ylim = y0 + 4 < h ? y0 + 4 : h;
            for (int x = 0; x < w; x++) {
                for (int y = y0; y < ylim; y++) {
                    int i = y * w + x;
                    if (sig[i]) continue;
                    int hn, vn, dn;
                    neigh(x, y, &hn, &vn, &dn);
                    if (hn + vn + dn == 0) continue;
                    vis[i] = 1;
                    int bit = (mag[i] >> p) & 1;
                    if (use_raw) {
                        raw.bit(bit);
                        if (bit) {
                            sig[i] = 1;
                            raw.bit(sgn_in[i] < 0 ? 1 : 0);
                            sgn_out[i] = sgn_in[i];
                        }
                        continue;
                    }
                    mq.encode(bit, zc_context(band, hn, vn, dn));
                    if (bit) {
                        sig[i] = 1;
                        encode_sign(x, y);
                    }
                }
            }
        }
    }

    void mrp(int p) {
        for (int y0 = 0; y0 < h; y0 += 4) {
            int ylim = y0 + 4 < h ? y0 + 4 : h;
            for (int x = 0; x < w; x++) {
                for (int y = y0; y < ylim; y++) {
                    int i = y * w + x;
                    if (!sig[i] || vis[i]) continue;
                    int bit = (mag[i] >> p) & 1;
                    if (use_raw) {
                        raw.bit(bit);
                        vis[i] = 1;
                        continue;
                    }
                    int cx;
                    if (first_ref[i]) {
                        int hn, vn, dn;
                        neigh(x, y, &hn, &vn, &dn);
                        cx = (hn + vn + dn) ? 15 : 14;
                        first_ref[i] = 0;
                    } else {
                        cx = 16;
                    }
                    mq.encode(bit, cx);
                    vis[i] = 1;
                }
            }
        }
    }

    void cleanup(int p, bool segsym) {
        for (int y0 = 0; y0 < h; y0 += 4) {
            int ylim = y0 + 4 < h ? y0 + 4 : h;
            for (int x = 0; x < w; x++) {
                int y = y0;
                if (y0 + 4 <= h) {
                    bool rl = true;
                    for (int yy = y0; yy < y0 + 4; yy++) {
                        int i = yy * w + x;
                        if (sig[i] || vis[i]) { rl = false; break; }
                        int hn, vn, dn;
                        neigh(x, yy, &hn, &vn, &dn);
                        if (hn + vn + dn) { rl = false; break; }
                    }
                    if (rl) {
                        int r = -1;
                        for (int yy = y0; yy < y0 + 4; yy++) {
                            if ((mag[yy * w + x] >> p) & 1) {
                                r = yy - y0;
                                break;
                            }
                        }
                        if (r < 0) {
                            mq.encode(0, kCtxRl);
                            continue;
                        }
                        mq.encode(1, kCtxRl);
                        mq.encode((r >> 1) & 1, kCtxUni);
                        mq.encode(r & 1, kCtxUni);
                        y = y0 + r;
                        int i = y * w + x;
                        sig[i] = 1;
                        encode_sign(x, y);
                        y += 1;
                    }
                }
                for (int yy = y; yy < ylim; yy++) {
                    int i = yy * w + x;
                    if (sig[i] || vis[i]) { vis[i] = 0; continue; }
                    int hn, vn, dn;
                    neigh(x, yy, &hn, &vn, &dn);
                    int bit = (mag[i] >> p) & 1;
                    mq.encode(bit, zc_context(band, hn, vn, dn));
                    if (bit) {
                        sig[i] = 1;
                        encode_sign(x, yy);
                    }
                }
            }
        }
        std::memset(vis.data(), 0, vis.size());
        if (segsym) {
            mq.encode(1, kCtxUni);
            mq.encode(0, kCtxUni);
            mq.encode(1, kCtxUni);
            mq.encode(0, kCtxUni);
        }
    }
};

}  // namespace

// Segment-aware decode: seg_lens/seg_passes describe the codeword
// segments within `data` (bypass/termall layouts). Context states
// persist across MQ segments; raw segments use the D.6 bit reader.
extern "C" int lp_jp2_t1_decode2(const uint8_t* data, int32_t len,
                                 const int32_t* seg_lens,
                                 const int32_t* seg_passes,
                                 int32_t n_segs, int32_t w, int32_t h,
                                 int32_t band, int32_t zero_planes,
                                 int32_t numpasses, int32_t mb,
                                 int32_t style, int32_t* out) {
    if (w <= 0 || h <= 0 || w > 4096 || h > 4096 || len < 0) return -1;
    T1 t1;
    t1.w = w;
    t1.h = h;
    t1.band = band;
    t1.vsc = (style & kStyVsc) != 0;
    const size_t nsamp = static_cast<size_t>(w) * h;
    t1.mag.assign(nsamp, 0);
    t1.sig.assign(nsamp, 0);
    t1.vis.assign(nsamp, 0);
    t1.first_ref.assign(nsamp, 1);
    t1.sgn.assign(nsamp, 0);
    t1.lastp.assign(nsamp, 0);
    int nb = mb - zero_planes;
    if (nb <= 0 || numpasses <= 0 || n_segs <= 0) {
        std::memset(out, 0, nsamp * sizeof(int32_t));
        return 0;
    }
    if (nb > 30) return -2;  // 2x-domain output needs one spare bit
    t1.mq.reset_ctx();
    const bool segsym = (style & kStySegsym) != 0;
    int bpno = nb - 1;
    int passtype = 2;
    int passidx = 0;
    int64_t pos = 0;
    for (int s = 0; s < n_segs && passidx < numpasses && bpno >= 0; s++) {
        int32_t sl = seg_lens[s];
        int32_t sp = seg_passes[s];
        if (sl < 0 || pos + sl > len) return -5;
        bool is_raw = (style & kStyLazy) && passtype < 2 && passidx >= 10;
        if (is_raw) {
            t1.raw.init(data + pos, sl);
        } else {
            t1.mq.init_regs(data + pos, sl);
        }
        pos += sl;
        for (int k = 0; k < sp && passidx < numpasses && bpno >= 0; k++) {
            if (passtype == 0) t1.spp(bpno, is_raw);
            else if (passtype == 1) t1.mrp(bpno, is_raw);
            else t1.cleanup(bpno, segsym);
            if ((style & kStyReset) && !is_raw) t1.mq.reset_ctx();
            passidx += 1;
            passtype += 1;
            if (passtype == 3) {
                passtype = 0;
                bpno -= 1;
            }
        }
    }
    // opj-parity reconstruction domain: 2*mag + 2^(last decoded
    // plane) — the uncertainty midpoint for truncated streams (the
    // caller halves / scales by delta/2)
    for (size_t i = 0; i < nsamp; i++) {
        int32_t m = t1.mag[i];
        int32_t v = m ? 2 * m + (1 << t1.lastp[i]) : 0;
        out[i] = t1.sgn[i] < 0 ? -v : v;
    }
    return 0;
}

extern "C" int lp_jp2_t1_decode(const uint8_t* data, int32_t len,
                                int32_t w, int32_t h, int32_t band,
                                int32_t zero_planes, int32_t numpasses,
                                int32_t mb, int32_t* out) {
    const int32_t sl = len, sp = numpasses;
    return lp_jp2_t1_decode2(data, len, &sl, &sp, 1, w, h, band,
                             zero_planes, numpasses, mb, 0, out);
}

// Encode one codeblock, all passes, with full style support. Fills
// out[0..*out_len) with concatenated codeword segments; seg_lens/
// seg_passes receive the per-segment byte lengths / pass counts.
extern "C" int lp_jp2_t1_encode(const int32_t* coefs, int32_t w, int32_t h,
                                int32_t band, int32_t mb, int32_t style,
                                uint8_t* out, int32_t out_cap,
                                int32_t* out_len, int32_t* out_numpasses,
                                int32_t* out_zero_planes,
                                int32_t* seg_lens, int32_t* seg_passes,
                                int32_t* n_segs, int32_t max_segs) {
    if (w <= 0 || h <= 0 || w > 4096 || h > 4096 || mb < 1 || mb > 31)
        return -1;
    const size_t nsamp = static_cast<size_t>(w) * h;
    T1Enc t1;
    t1.w = w;
    t1.h = h;
    t1.band = band;
    t1.vsc = (style & kStyVsc) != 0;
    t1.mag.resize(nsamp);
    t1.sgn_in.resize(nsamp);
    int32_t maxmag = 0;
    for (size_t i = 0; i < nsamp; i++) {
        int32_t v = coefs[i];
        int32_t m = v < 0 ? -v : v;
        t1.mag[i] = m;
        t1.sgn_in[i] = v < 0 ? -1 : 1;
        if (m > maxmag) maxmag = m;
    }
    int nb = 0;
    while ((maxmag >> nb) != 0) nb++;
    if (nb == 0) {
        *out_len = 0;
        *out_numpasses = 0;
        *out_zero_planes = mb;
        *n_segs = 0;
        return 0;
    }
    if (nb > mb) return -2;
    t1.sig.assign(nsamp, 0);
    t1.vis.assign(nsamp, 0);
    t1.first_ref.assign(nsamp, 1);
    t1.sgn_out.assign(nsamp, 0);
    t1.mq.reset_ctx();

    const bool segsym = (style & kStySegsym) != 0;
    int bpno = nb - 1;
    int passtype = 2;
    int passidx = 0;
    int seg_pass_count = 0;
    uint8_t prev_byte = 0;
    int32_t total = 0;
    int32_t segs = 0;
    uint8_t saved_idx[kNCtx], saved_mps[kNCtx];

    auto want_raw = [&]() {
        return (style & kStyLazy) && passtype < 2 && passidx >= 10;
    };
    auto open_coder = [&]() {
        t1.use_raw = want_raw();
        if (t1.use_raw) {
            t1.raw.init();
        } else {
            // context states persist across segments: save around the
            // register re-init (MqEnc keeps ctx in the same struct)
            std::memcpy(saved_idx, t1.mq.idx, sizeof(saved_idx));
            std::memcpy(saved_mps, t1.mq.mps, sizeof(saved_mps));
            t1.mq.init(prev_byte);
            std::memcpy(t1.mq.idx, saved_idx, sizeof(saved_idx));
            std::memcpy(t1.mq.mps, saved_mps, sizeof(saved_mps));
        }
    };
    auto close_coder = [&]() -> int {
        const uint8_t* src;
        size_t len;
        if (t1.use_raw) {
            t1.raw.flush();
            src = t1.raw.out.data();
            len = t1.raw.out.size();
        } else {
            len = t1.mq.flush();
            src = t1.mq.buf.data() + 1;
        }
        if (total + static_cast<int64_t>(len) > out_cap ||
            segs >= max_segs)
            return -4;
        std::memcpy(out + total, src, len);
        total += static_cast<int32_t>(len);
        seg_lens[segs] = static_cast<int32_t>(len);
        seg_passes[segs] = seg_pass_count;
        segs += 1;
        if (len) prev_byte = src[len - 1];
        seg_pass_count = 0;
        return 0;
    };

    open_coder();
    while (bpno >= 0) {
        if (passtype == 0) t1.spp(bpno);
        else if (passtype == 1) t1.mrp(bpno);
        else t1.cleanup(bpno, segsym);
        if ((style & kStyReset) && !t1.use_raw) t1.mq.reset_ctx();
        seg_pass_count += 1;
        passidx += 1;
        bool last_pass = (passtype == 2 && bpno == 0);
        bool term = false;
        if (style & kStyTermall) {
            term = !last_pass;
        } else if (style & kStyLazy) {
            term = ((bpno < nb - 4 && passtype > 0)
                    || (bpno == nb - 4 && passtype == 2));
        }
        passtype += 1;
        if (passtype == 3) {
            passtype = 0;
            bpno -= 1;
        }
        if (last_pass || term) {
            int rc = close_coder();
            if (rc) return rc;
            if (!last_pass) open_coder();
        }
    }
    *out_len = total;
    *out_numpasses = 3 * nb - 2;
    *out_zero_planes = mb - nb;
    *n_segs = segs;
    return 0;
}
