// Host half of the device Huffman decoder (csrc/huffman_decode.cu): the
// marker parse up to SOS and the destuffing of one baseline JPEG scan, laid
// out for the card. The card decodes the symbols; nothing here decodes one.
//
// A stream is accepted exactly when jpeg_huff.cpp's lp_jpeg_decode_coefs_win
// would reach its symbol decode: SOF0/SOF1, 8-bit, Huffman; one interleaved
// scan over every component in frame order with the full spectral band; at
// most 10 blocks an MCU; every table present; RSTn markers in order; the
// scan ended by EOI; as many restart segments as the restart interval
// gives. Everything else returns kDecline, and the caller takes the host
// route (lp_jpeg_decode_coefs_win, then libjpeg), so a declined stream keeps
// the bytes or the error it has there. This file shares no code with
// jpeg_huff.cpp: the two decoders have nothing of their structure in common.
//
// Layout written for one stream (all offsets relative to `scan`):
//   * each restart segment's destuffed bytes at a 4-byte aligned offset,
//     followed by zero bytes up to the next 4-byte boundary and 8 more, so
//     the card's two-word loads at any bit of the segment (and up to 64
//     bits past its end) read the segment's bits and then zeros: the bits
//     a decoder sees past a segment's end, as jpeg_huff.cpp's reader does;
//   * segs[s] = {byte offset, byte length} of segment s;
//   * tables: per component its DC table, then its AC table, each a
//     DevHuff (a 9-bit lookahead of (length << 8) | symbol, 0 where the
//     code is longer, and the canonical maxcode/valoffset walk for codes
//     of 10 to 16 bits);
//   * qtables: uint16[4*64] in natural order, zeros where absent (the
//     contract of lp_jpeg_decode_coefs_win);
//   * info = {bytes used, segments, restart interval, MCUs, then (h, v) of
//     each of four components, zeros past the frame's}.

#include <cstdint>
#include <cstring>

namespace {

constexpr int kDecline = -10;

// zigzag position -> natural (row-major) position, ISO/IEC 10918-1 fig A.6
const uint8_t kZigzagToNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// One Huffman table as the card reads it (1424 bytes, a multiple of 16).
struct DevHuff {
    uint16_t lut[512];     // 9-bit lookahead -> (len << 8) | symbol; 0 = longer
    int32_t maxcode[18];   // largest code of each length, -1 where none
    int32_t valoffset[18]; // symbol index of a code = code + valoffset[len]
    uint8_t vals[256];
};
static_assert(sizeof(DevHuff) == 1424, "DevHuff layout is the card's");

struct Table {
    DevHuff d;
    bool present = false;
};

// T.81 Annex C canonical codes; the same validity rules as jpeg_huff.cpp's
// build_huff (1..256 symbols, no overfull length, every count used).
bool build_table(const uint8_t counts[16], const uint8_t* vals, int nvals,
                 Table* t) {
    if (nvals < 1 || nvals > 256) return false;
    uint32_t codes[256];
    uint8_t sizes[256];
    uint32_t code = 0;
    int k = 0;
    for (int l = 1; l <= 16; l++) {
        for (int i = 0; i < counts[l - 1]; i++) {
            if (k >= nvals || code >= (1u << l)) return false;
            codes[k] = code;
            sizes[k] = static_cast<uint8_t>(l);
            code++;
            k++;
        }
        code <<= 1;
    }
    if (k != nvals) return false;
    DevHuff& d = t->d;
    std::memset(&d, 0, sizeof(d));
    std::memcpy(d.vals, vals, nvals);
    int p = 0;
    for (int l = 1; l <= 16; l++) {
        if (counts[l - 1]) {
            d.valoffset[l] = p - static_cast<int32_t>(codes[p]);
            p += counts[l - 1];
            d.maxcode[l] = static_cast<int32_t>(codes[p - 1]);
        } else {
            d.maxcode[l] = -1;
        }
    }
    for (int i = 0; i < nvals; i++) {
        const int l = sizes[i];
        if (l > 9) continue;
        const uint32_t lo = codes[i] << (9 - l);
        for (uint32_t j = 0; j < (1u << (9 - l)); j++)
            d.lut[lo + j] = static_cast<uint16_t>((l << 8) | vals[i]);
    }
    t->present = true;
    return true;
}

struct Component {
    int id = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
};

struct Header {
    int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
    int restart_interval = 0;
    Component comp[4];
    Table dc[4], ac[4];
    uint16_t qt[4][64] = {};
    bool qt_seen[4] = {};
};

bool read_dht(Header& hd, const uint8_t* seg, size_t slen) {
    size_t q = 0;
    while (q + 17 <= slen) {
        const int tc = seg[q] >> 4, th = seg[q] & 15;
        if (tc > 1 || th > 3) return false;
        int nv = 0;
        for (int i = 0; i < 16; i++) nv += seg[q + 1 + i];
        if (q + 17 + static_cast<size_t>(nv) > slen) return false;
        if (!build_table(seg + q + 1, seg + q + 17, nv,
                         tc ? &hd.ac[th] : &hd.dc[th]))
            return false;
        q += 17 + nv;
    }
    return q == slen;
}

bool read_dqt(Header& hd, const uint8_t* seg, size_t slen) {
    size_t q = 0;
    while (q < slen) {
        const int pq = seg[q] >> 4, tq = seg[q] & 15;
        if (pq > 1 || tq > 3) return false;
        const size_t n = 1 + (pq ? 128 : 64);
        if (q + n > slen) return false;
        for (int i = 0; i < 64; i++)
            hd.qt[tq][kZigzagToNatural[i]] =
                pq ? static_cast<uint16_t>((seg[q + 1 + 2 * i] << 8) |
                                           seg[q + 2 + 2 * i])
                   : seg[q + 1 + i];
        hd.qt_seen[tq] = true;
        q += n;
    }
    return true;
}

// The baseline scan header: every component once, in frame order, with the
// full spectral band and no successive approximation.
bool read_sos(Header& hd, const uint8_t* seg, size_t slen) {
    if (slen < 6) return false;
    const int ns = seg[0];
    if (ns < 1 || ns > 4) return false;
    if (slen != 1 + 2 * static_cast<size_t>(ns) + 3) return false;
    int ci[4];
    for (int i = 0; i < ns; i++) {
        const int id = seg[1 + 2 * i];
        int c = -1;
        for (int j = 0; j < hd.ncomp; j++)
            if (hd.comp[j].id == id) {
                c = j;
                break;
            }
        if (c < 0) return false;
        for (int j = 0; j < i; j++)
            if (ci[j] == c) return false;
        ci[i] = c;
        if ((seg[2 + 2 * i] >> 4) > 3 || (seg[2 + 2 * i] & 15) > 3)
            return false;
    }
    if (ns != hd.ncomp) return false;
    for (int i = 0; i < ns; i++) {
        if (ci[i] != i) return false;
        hd.comp[i].td = seg[2 + 2 * i] >> 4;
        hd.comp[i].ta = seg[2 + 2 * i] & 15;
    }
    const uint8_t* tail = seg + 1 + 2 * ns;
    return tail[0] == 0 && tail[1] == 63 && tail[2] == 0;
}

}  // namespace

extern "C" {

// See the file header. win: optional int32[4*4] {y0, x0, h, w} block
// windows per component, checked as lp_jpeg_decode_coefs_win checks them.
// Returns 0, or kDecline for every stream the device route does not take.
int lpt_jpeg_scan_prepare(const uint8_t* buf, size_t len, const int32_t* win,
                          uint8_t* scan, int64_t scan_cap, int32_t* segs,
                          int32_t seg_cap, uint8_t* tables, uint16_t* qtables,
                          int32_t* info) {
    if (len < 4 || buf[0] != 0xFF || buf[1] != 0xD8) return kDecline;
    Header hd;
    bool sof_seen = false, sos_seen = false;
    size_t pos = 2;
    while (pos + 4 <= len) {
        if (buf[pos] != 0xFF) return kDecline;
        const uint8_t m = buf[pos + 1];
        if (m == 0xFF) {
            pos++;
            continue;
        }
        if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) {
            pos += 2;
            continue;
        }
        if (m == 0xD9) return kDecline;
        const size_t seglen = (static_cast<size_t>(buf[pos + 2]) << 8) |
                              buf[pos + 3];
        if (seglen < 2 || pos + 2 + seglen > len) return kDecline;
        const uint8_t* seg = buf + pos + 4;
        const size_t slen = seglen - 2;
        switch (m) {
            case 0xC0:
            case 0xC1: {
                if (sof_seen || slen < 6 || seg[0] != 8) return kDecline;
                hd.height = (seg[1] << 8) | seg[2];
                hd.width = (seg[3] << 8) | seg[4];
                hd.ncomp = seg[5];
                if (hd.width <= 0 || hd.height <= 0 || hd.ncomp < 1 ||
                    hd.ncomp > 4 ||
                    slen < 6 + 3 * static_cast<size_t>(hd.ncomp))
                    return kDecline;
                for (int c = 0; c < hd.ncomp; c++) {
                    Component& cc = hd.comp[c];
                    cc.id = seg[6 + 3 * c];
                    cc.h = seg[7 + 3 * c] >> 4;
                    cc.v = seg[7 + 3 * c] & 15;
                    cc.tq = seg[8 + 3 * c];
                    if (cc.h < 1 || cc.h > 4 || cc.v < 1 || cc.v > 4 ||
                        cc.tq > 3)
                        return kDecline;
                    if (cc.h > hd.hmax) hd.hmax = cc.h;
                    if (cc.v > hd.vmax) hd.vmax = cc.v;
                }
                sof_seen = true;
                break;
            }
            // progressive, hierarchical, arithmetic, lossless: host route
            case 0xC2:
            case 0xC3:
            case 0xC5:
            case 0xC6:
            case 0xC7:
            case 0xC9:
            case 0xCA:
            case 0xCB:
            case 0xCD:
            case 0xCE:
            case 0xCF:
            case 0xCC:
            case 0xDE:
            case 0xDF:
                return kDecline;
            case 0xC4:
                if (!read_dht(hd, seg, slen)) return kDecline;
                break;
            case 0xDB:
                if (!read_dqt(hd, seg, slen)) return kDecline;
                break;
            case 0xDD:
                if (slen != 2) return kDecline;
                hd.restart_interval = (seg[0] << 8) | seg[1];
                break;
            case 0xDA:
                if (!sof_seen || !read_sos(hd, seg, slen)) return kDecline;
                sos_seen = true;
                break;
            default:
                break;
        }
        pos += 2 + seglen;
        if (sos_seen) break;
    }
    if (!sos_seen) return kDecline;
    if (hd.ncomp > 1) {
        int blocks = 0;
        for (int c = 0; c < hd.ncomp; c++)
            blocks += hd.comp[c].h * hd.comp[c].v;
        if (blocks > 10) return kDecline;
    }
    for (int c = 0; c < hd.ncomp; c++) {
        const Component& cc = hd.comp[c];
        if (!hd.qt_seen[cc.tq] || !hd.dc[cc.td].present ||
            !hd.ac[cc.ta].present)
            return kDecline;
        if (win) {
            const long bw =
                (static_cast<long>(hd.width) * cc.h + 8L * hd.hmax - 1) /
                (8L * hd.hmax);
            const int32_t* w = win + 4 * c;
            if (w[0] < 0 || w[1] < 0 || w[2] <= 0 || w[3] <= 0 ||
                w[1] + w[3] > bw)
                return kDecline;
        }
    }
    long nmcu;
    if (hd.ncomp == 1) {
        // one component: MCU = one block over the unpadded grid
        nmcu = ((static_cast<long>(hd.width) * hd.comp[0].h + 8L * hd.hmax -
                 1) / (8L * hd.hmax)) *
               ((static_cast<long>(hd.height) * hd.comp[0].v + 8L * hd.vmax -
                 1) / (8L * hd.vmax));
    } else {
        nmcu = static_cast<long>((hd.width + 8 * hd.hmax - 1) /
                                 (8 * hd.hmax)) *
               ((hd.height + 8 * hd.vmax - 1) / (8 * hd.vmax));
    }
    if (nmcu <= 0) return kDecline;
    const int ri = hd.restart_interval;
    const long expect = ri > 0 ? (nmcu + ri - 1) / ri : 1;
    if (expect > seg_cap) return kDecline;

    // destuff segment by segment into the padded layout
    int64_t o = 0;      // write offset in scan
    int64_t seg0 = 0;   // current segment's first byte
    int32_t nsegs = 0;
    int next_rst = 0;
    auto close_segment = [&]() -> bool {
        if (nsegs >= seg_cap) return false;
        segs[2 * nsegs] = static_cast<int32_t>(seg0);
        segs[2 * nsegs + 1] = static_cast<int32_t>(o - seg0);
        nsegs++;
        const int64_t end = ((o + 3) & ~int64_t{3}) + 8;
        if (end > scan_cap) return false;
        std::memset(scan + o, 0, static_cast<size_t>(end - o));
        o = seg0 = end;
        return true;
    };
    const uint8_t* q = buf + pos;
    const uint8_t* bend = buf + len;
    uint8_t end_marker = 0;
    while (q < bend) {
        const uint8_t* ff =
            static_cast<const uint8_t*>(std::memchr(q, 0xFF, bend - q));
        if (!ff) return kDecline;
        const int64_t n = ff - q;
        if (o + n + 1 > scan_cap) return kDecline;
        std::memcpy(scan + o, q, static_cast<size_t>(n));
        o += n;
        if (ff + 1 >= bend) return kDecline;
        const uint8_t m = ff[1];
        if (m == 0x00) {
            scan[o++] = 0xFF;
            q = ff + 2;
        } else if (m == 0xFF) {
            q = ff + 1;
        } else if (m >= 0xD0 && m <= 0xD7) {
            if (m != 0xD0 + next_rst) return kDecline;
            next_rst = (next_rst + 1) & 7;
            if (!close_segment()) return kDecline;
            q = ff + 2;
        } else {
            end_marker = m;
            break;
        }
    }
    if (end_marker != 0xD9) return kDecline;
    if (!close_segment()) return kDecline;
    if (nsegs != expect) return kDecline;

    for (int t = 0; t < 4; t++) {
        if (hd.qt_seen[t])
            std::memcpy(qtables + 64 * t, hd.qt[t], 64 * sizeof(uint16_t));
        else
            std::memset(qtables + 64 * t, 0, 64 * sizeof(uint16_t));
    }
    for (int c = 0; c < hd.ncomp; c++) {
        std::memcpy(tables + (2 * c) * sizeof(DevHuff),
                    &hd.dc[hd.comp[c].td].d, sizeof(DevHuff));
        std::memcpy(tables + (2 * c + 1) * sizeof(DevHuff),
                    &hd.ac[hd.comp[c].ta].d, sizeof(DevHuff));
    }
    info[0] = static_cast<int32_t>(o);
    info[1] = nsegs;
    info[2] = ri;
    info[3] = static_cast<int32_t>(nmcu);
    for (int c = 0; c < 4; c++) {
        info[4 + 2 * c] = c < hd.ncomp ? hd.comp[c].h : 0;
        info[5 + 2 * c] = c < hd.ncomp ? hd.comp[c].v : 0;
    }
    return 0;
}

}  // extern "C"
