// Baseline JPEG entropy encoder for device-quantized coefficients.
//
// The port's counterpart of lp_jpeg_encode_coefs (lilliput_tpu/native/src/
// jpeg_shim.cpp) for machines without libjpeg: with progressive=0,
// optimize=0 and restart_in_rows=0 it writes the same bytes libjpeg writes
// for jpeg_write_coefficients after jpeg_set_defaults:
//
//   SOI, JFIF APP0 (1.01, aspect 1:1), ICC APP2 chunks, DQT per table in
//   first-use order, SOF0 (SOF1 if a table needs 16 bits), DHT per table in
//   first-use order (the ISO/IEC 10918-1 Annex K.3 tables), SOS, one
//   interleaved baseline scan, EOI.
//
// Edge MCUs follow libjpeg's transcoder (jctrans.c compress_output): blocks
// past a component's width/height in blocks are dummies with zero AC and
// the DC of the previous block in the MCU. Plain C ABI for ctypes; no
// globals, so concurrent calls from several threads are safe.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Annex K.3 tables (bits[1..16], values), as in libjpeg's jstdhuff.c.
constexpr uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1,
                                     1, 0, 0, 0, 0, 0, 0, 0};
constexpr uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1,
                                       1, 1, 1, 0, 0, 0, 0, 0};
constexpr uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
constexpr uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3,
                                     5, 5, 4, 4, 0, 0, 1, 0x7d};
constexpr uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
constexpr uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4,
                                       7, 5, 4, 4, 0, 1, 2, 0x77};
constexpr uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffSpec {
    const uint8_t* bits;
    const uint8_t* vals;
    int nvals;
};

constexpr HuffSpec kDcSpec[2] = {{kDcLumaBits, kDcVals, 12},
                                 {kDcChromaBits, kDcVals, 12}};
constexpr HuffSpec kAcSpec[2] = {{kAcLumaBits, kAcLumaVals, 162},
                                 {kAcChromaBits, kAcChromaVals, 162}};

// Derived encoding table (libjpeg jpeg_make_c_derived_tbl): canonical codes
// in order of code length; size 0 marks a symbol the table lacks.
struct HuffTable {
    uint16_t code[256];
    uint8_t size[256];
};

void derive(const HuffSpec& s, HuffTable* t) {
    std::memset(t, 0, sizeof(*t));
    unsigned code = 0;
    int p = 0;
    for (int len = 1; len <= 16; len++) {
        for (int i = 0; i < s.bits[len - 1]; i++, p++) {
            t->code[s.vals[p]] = static_cast<uint16_t>(code++);
            t->size[s.vals[p]] = static_cast<uint8_t>(len);
        }
        code <<= 1;
    }
}

class Writer {
  public:
    std::vector<uint8_t> out;
    bool bad = false;  // a coefficient out of baseline range

    void byte(int b) { out.push_back(static_cast<uint8_t>(b)); }
    void u16(int v) {
        byte((v >> 8) & 0xFF);
        byte(v & 0xFF);
    }
    void marker(int m) {
        byte(0xFF);
        byte(m);
    }
    // Entropy bits MSB first with 0xFF byte stuffing (jchuff.c emit_bits).
    void bits(unsigned value, int size) {
        if (size == 0) {  // symbol missing from the table
            bad = true;
            return;
        }
        acc_ = (acc_ << size) | (value & ((1u << size) - 1));
        nacc_ += size;
        while (nacc_ >= 8) {
            const int b = static_cast<int>((acc_ >> (nacc_ - 8)) & 0xFF);
            byte(b);
            if (b == 0xFF) byte(0);
            nacc_ -= 8;
        }
        acc_ &= (1u << nacc_) - 1;
    }
    // Pad the last byte with 1-bits (jchuff.c flush_bits).
    void flush() {
        if (nacc_ > 0) bits(0x7F, 8 - nacc_);
    }

  private:
    uint32_t acc_ = 0;
    int nacc_ = 0;
};

void encode_block(Writer& w, const int16_t* blk, int* last_dc,
                  const HuffTable& dc, const HuffTable& ac) {
    int t = blk[0] - *last_dc;
    *last_dc = blk[0];
    int t2 = t;
    if (t < 0) {
        t = -t;
        t2--;
    }
    int nbits = 0;
    while (t) {
        nbits++;
        t >>= 1;
    }
    if (nbits > 11) {  // MAX_COEF_BITS + 1
        w.bad = true;
        return;
    }
    w.bits(dc.code[nbits], dc.size[nbits]);
    if (nbits) w.bits(static_cast<unsigned>(t2), nbits);

    int run = 0;
    for (int k = 1; k < 64; k++) {
        int v = blk[kZigzag[k]];
        if (v == 0) {
            run++;
            continue;
        }
        while (run > 15) {
            w.bits(ac.code[0xF0], ac.size[0xF0]);
            run -= 16;
        }
        int v2 = v;
        if (v < 0) {
            v = -v;
            v2--;
        }
        nbits = 1;
        while (v >>= 1) nbits++;
        if (nbits > 10) {  // MAX_COEF_BITS
            w.bad = true;
            return;
        }
        const int sym = (run << 4) + nbits;
        w.bits(ac.code[sym], ac.size[sym]);
        w.bits(static_cast<unsigned>(v2), nbits);
        run = 0;
    }
    if (run > 0) w.bits(ac.code[0], ac.size[0]);
}

void emit_dqt(Writer& w, int index, const uint16_t* q) {
    bool wide = false;
    for (int i = 0; i < 64; i++) wide = wide || q[i] > 255;
    w.marker(0xDB);
    w.u16(wide ? 64 * 2 + 3 : 64 + 3);
    w.byte(index + (wide ? 0x10 : 0));
    for (int i = 0; i < 64; i++) {
        const unsigned v = q[kZigzag[i]];
        if (wide) w.byte(v >> 8);
        w.byte(v & 0xFF);
    }
}

void emit_dht(Writer& w, int index, const HuffSpec& s) {
    w.marker(0xC4);
    w.u16(2 + 1 + 16 + s.nvals);
    w.byte(index);
    for (int i = 0; i < 16; i++) w.byte(s.bits[i]);
    for (int i = 0; i < s.nvals; i++) w.byte(s.vals[i]);
}

}  // namespace

extern "C" {

// Encode quantized coefficients as a baseline JPEG.
//   ncomp 1 (gray) or 3 (YCbCr); h_samp/v_samp per component (1..2).
//   coefs per component: int16[blocks_h*blocks_w*64], natural order, with
//   blocks_w = ceil(width*h/(8*hmax)) and blocks_h likewise.
//   qtable_luma / qtable_chroma: uint16[64] natural order.
//   icc: optional profile, written as APP2 ICC_PROFILE chunks.
// Returns the bytes written into out, -1 for a coefficient outside the
// baseline range or bad arguments, -2 when out_cap is too small.
long lpt_jpeg_encode_baseline(int32_t width, int32_t height, int32_t ncomp,
                              const int32_t* h_samp, const int32_t* v_samp,
                              int16_t** coefs, const uint16_t* qtable_luma,
                              const uint16_t* qtable_chroma,
                              const uint8_t* icc, int32_t icc_len,
                              uint8_t* out, size_t out_cap) {
    if (width <= 0 || height <= 0 || width > 65500 || height > 65500 ||
        (ncomp != 1 && ncomp != 3) || icc_len < 0)
        return -1;
    int hmax = 1, vmax = 1;
    for (int c = 0; c < ncomp; c++) {
        if (h_samp[c] < 1 || h_samp[c] > 2 || v_samp[c] < 1 || v_samp[c] > 2)
            return -1;
        if (h_samp[c] > hmax) hmax = h_samp[c];
        if (v_samp[c] > vmax) vmax = v_samp[c];
    }
    int bw[3], bh[3];
    for (int c = 0; c < ncomp; c++) {
        bw[c] = static_cast<int>(
            (static_cast<long>(width) * h_samp[c] + 8L * hmax - 1) / (8L * hmax));
        bh[c] = static_cast<int>(
            (static_cast<long>(height) * v_samp[c] + 8L * vmax - 1) / (8L * vmax));
    }

    Writer w;
    w.out.reserve(static_cast<size_t>(width) * height / 2 + icc_len + 1024);
    w.marker(0xD8);
    // JFIF APP0: version 1.01, density unit 0, density 1x1, no thumbnail
    w.marker(0xE0);
    w.u16(16);
    for (const char ch : {'J', 'F', 'I', 'F', '\0'}) w.byte(ch);
    w.byte(1);
    w.byte(1);
    w.byte(0);
    w.u16(1);
    w.u16(1);
    w.byte(0);
    w.byte(0);
    // ICC APP2 chunks (libjpeg jpeg_write_icc_profile)
    if (icc && icc_len > 0) {
        constexpr int kMaxData = 65533 - 14;
        const int nmark = (icc_len + kMaxData - 1) / kMaxData;
        int left = icc_len, seq = 1;
        const uint8_t* p = icc;
        while (left > 0) {
            const int n = left < kMaxData ? left : kMaxData;
            w.marker(0xE2);
            w.u16(n + 14 + 2);
            for (const char ch : {'I', 'C', 'C', '_', 'P', 'R', 'O', 'F',
                                  'I', 'L', 'E', '\0'})
                w.byte(ch);
            w.byte(seq++);
            w.byte(nmark);
            w.out.insert(w.out.end(), p, p + n);
            p += n;
            left -= n;
        }
    }
    // frame header: component c uses quant/Huffman table 0 (luma) or 1
    const uint16_t* qt[2] = {qtable_luma, qtable_chroma};
    bool wide = false;
    for (int t = 0; t < (ncomp > 1 ? 2 : 1); t++) {
        emit_dqt(w, t, qt[t]);
        for (int i = 0; i < 64; i++) wide = wide || qt[t][i] > 255;
    }
    w.marker(wide ? 0xC1 : 0xC0);
    w.u16(8 + 3 * ncomp);
    w.byte(8);
    w.u16(height);
    w.u16(width);
    w.byte(ncomp);
    for (int c = 0; c < ncomp; c++) {
        w.byte(c + 1);
        w.byte((h_samp[c] << 4) + v_samp[c]);
        w.byte(c == 0 ? 0 : 1);
    }
    // scan header
    for (int t = 0; t < (ncomp > 1 ? 2 : 1); t++) {
        emit_dht(w, t, kDcSpec[t]);
        emit_dht(w, 0x10 + t, kAcSpec[t]);
    }
    w.marker(0xDA);
    w.u16(6 + 2 * ncomp);
    w.byte(ncomp);
    for (int c = 0; c < ncomp; c++) {
        w.byte(c + 1);
        w.byte(c == 0 ? 0x00 : 0x11);
    }
    w.byte(0);
    w.byte(63);
    w.byte(0);

    HuffTable dc[2], ac[2];
    for (int t = 0; t < 2; t++) {
        derive(kDcSpec[t], &dc[t]);
        derive(kAcSpec[t], &ac[t]);
    }
    int last_dc[3] = {0, 0, 0};
    if (ncomp == 1) {
        // non-interleaved scan: one block per MCU over the true block grid
        for (int r = 0; r < bh[0] && !w.bad; r++)
            for (int x = 0; x < bw[0] && !w.bad; x++)
                encode_block(w, coefs[0] + (static_cast<size_t>(r) * bw[0] + x) * 64,
                             &last_dc[0], dc[0], ac[0]);
    } else {
        const int mcus_x = (width + 8 * hmax - 1) / (8 * hmax);
        const int mcus_y = (height + 8 * vmax - 1) / (8 * vmax);
        int16_t dummy[64];
        std::memset(dummy, 0, sizeof(dummy));
        for (int my = 0; my < mcus_y && !w.bad; my++) {
            for (int mx = 0; mx < mcus_x && !w.bad; mx++) {
                for (int c = 0; c < ncomp; c++) {
                    const int t = c == 0 ? 0 : 1;
                    int prev_dc = 0;  // DC of the previous block in this MCU
                    for (int yi = 0; yi < v_samp[c]; yi++) {
                        for (int xi = 0; xi < h_samp[c]; xi++) {
                            const int by = my * v_samp[c] + yi;
                            const int bx = mx * h_samp[c] + xi;
                            const int16_t* blk;
                            if (by < bh[c] && bx < bw[c]) {
                                blk = coefs[c] +
                                      (static_cast<size_t>(by) * bw[c] + bx) * 64;
                            } else {
                                dummy[0] = static_cast<int16_t>(prev_dc);
                                blk = dummy;
                            }
                            prev_dc = blk[0];
                            encode_block(w, blk, &last_dc[c], dc[t], ac[t]);
                        }
                    }
                }
            }
        }
    }
    if (w.bad) return -1;
    w.flush();
    w.marker(0xD9);
    if (w.out.size() > out_cap) return -2;
    std::memcpy(out, w.out.data(), w.out.size());
    return static_cast<long>(w.out.size());
}

}  // extern "C"
