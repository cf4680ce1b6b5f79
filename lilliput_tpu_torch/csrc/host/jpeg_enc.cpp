// JPEG entropy encoder for device-quantized coefficients.
//
// The port's own counterpart of lp_jpeg_encode_coefs (lilliput_tpu/native/
// src/jpeg_shim.cpp), for machines without libjpeg. For every combination
// of its options (progressive, optimize, restart_in_rows) it writes the
// bytes libjpeg-turbo writes for jpeg_write_coefficients after
// jpeg_set_defaults:
//
//   SOI, JFIF APP0 (1.01, aspect 1:1), ICC APP2 chunks, then for each scan
//   of the script: [first scan: DQT per table in first-use order, then SOF0,
//   SOF1 if a table needs 16 bits, or SOF2 when progressive], DHT for the
//   tables the scan codes with that were not written since they last
//   changed, DRI when the restart interval changes, SOS, entropy data;
//   EOI.
//
// Scan scripts: baseline is one scan (interleaved for YCbCr, the block
// grid for one component); progressive is jpeg_simple_progression's (10
// scans for YCbCr, 6 for one component, ITU T.81 Annex G), which
// libjpeg-turbo always codes with optimized tables. Optimized tables take
// a gather pass over the scan first (the same blocks, dummies and restart
// resets as the output pass) and then Annex K.2's procedure exactly as
// jpeg_gen_optimal_table runs it (reserved code point 256, ties to the
// larger symbol, lengths limited to 16 bits, symbols listed by code
// length). restart_in_rows gives each scan restart_in_rows x its own MCUs
// per row (at most 65535) as its interval.
//
// One input is coded differently: a coefficient outside the range of a
// baseline, non-optimized scan (an AC over 10 bits, a DC difference over
// 11) returns -1, where libjpeg-turbo writes codes its tables lack.
//
// Edge MCUs of interleaved scans follow libjpeg's transcoder (jctrans.c
// compress_output): blocks past a component's width/height in blocks are
// dummies with zero AC and the DC of the previous block in the MCU.
// Non-interleaved scans walk the component's own block grid. The
// coefficient arrays are read in place by every pass. Plain C ABI for
// ctypes; no globals and no threads, so concurrent calls are safe.

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

// One Huffman table as DHT carries it: the number of codes of each length
// (bits[1..16]) and the symbols in code order. `sent`: written since it
// last changed (libjpeg's JHUFF_TBL.sent_table).
struct HuffSpec {
    uint8_t bits[17];
    uint8_t vals[256];
    int nvals;
    bool sent;
};

void set_spec(HuffSpec* s, const uint8_t* bits16, const uint8_t* vals,
              int nvals) {
    s->bits[0] = 0;
    std::memcpy(s->bits + 1, bits16, 16);
    std::memcpy(s->vals, vals, nvals);
    s->nvals = nvals;
    s->sent = false;
}

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
        for (int i = 0; i < s.bits[len]; i++, p++) {
            t->code[s.vals[p]] = static_cast<uint16_t>(code++);
            t->size[s.vals[p]] = static_cast<uint8_t>(len);
        }
        code <<= 1;
    }
}

// Optimal table for the symbol counts freq[0..255] (freq is clobbered), by
// ITU T.81 Annex K.2 as jpeg_gen_optimal_table (jchuff.c) runs it: the
// pseudo-symbol 256 keeps every real code off the all-ones code point, the
// two-smallest search takes the larger symbol on ties, lengths over 16
// are folded by K.2's rule, and the symbols are listed by code length.
// Returns false where a code would exceed 32 bits.
bool gen_optimal_table(long* freq, HuffSpec* htbl) {
    constexpr int kMaxClen = 32;
    uint8_t bits[kMaxClen + 1];
    int codesize[257];
    int others[257];
    std::memset(bits, 0, sizeof(bits));
    std::memset(codesize, 0, sizeof(codesize));
    for (int i = 0; i < 257; i++) others[i] = -1;
    freq[256] = 1;
    for (;;) {
        int c1 = -1;
        long v = 1000000000L;
        for (int i = 0; i <= 256; i++) {
            if (freq[i] && freq[i] <= v) {
                v = freq[i];
                c1 = i;
            }
        }
        int c2 = -1;
        v = 1000000000L;
        for (int i = 0; i <= 256; i++) {
            if (freq[i] && freq[i] <= v && i != c1) {
                v = freq[i];
                c2 = i;
            }
        }
        if (c2 < 0) break;
        freq[c1] += freq[c2];
        freq[c2] = 0;
        codesize[c1]++;
        while (others[c1] >= 0) {
            c1 = others[c1];
            codesize[c1]++;
        }
        others[c1] = c2;
        codesize[c2]++;
        while (others[c2] >= 0) {
            c2 = others[c2];
            codesize[c2]++;
        }
    }
    for (int i = 0; i <= 256; i++) {
        if (codesize[i]) {
            if (codesize[i] > kMaxClen) return false;
            bits[codesize[i]]++;
        }
    }
    int i = kMaxClen;
    for (; i > 16; i--) {
        while (bits[i] > 0) {
            int j = i - 2;
            while (bits[j] == 0) j--;
            bits[i] -= 2;
            bits[i - 1]++;
            bits[j + 1] += 2;
            bits[j]--;
        }
    }
    while (bits[i] == 0) i--;  // the pseudo-symbol leaves the longest length
    bits[i]--;
    std::memcpy(htbl->bits, bits, 17);
    int p = 0;
    for (int len = 1; len <= kMaxClen; len++)
        for (int s = 0; s <= 255; s++)
            if (codesize[s] == len) htbl->vals[p++] = static_cast<uint8_t>(s);
    htbl->nvals = p;
    htbl->sent = false;
    return true;
}

class Writer {
  public:
    std::vector<uint8_t> out;
    bool bad = false;  // a symbol missing from its table

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
        if (size == 0) {
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

struct Frame {
    int width, height;
    int h[3], v[3], bw[3], bh[3];
    int mcus_x, mcus_y;
    int16_t* const* coefs;
};

// One scan of the script: its components (indices into the frame), the
// spectral band Ss..Se and the successive-approximation bits Ah, Al.
struct Scan {
    int ncomp;
    int comp[3];
    int Ss, Se, Ah, Al;
};

inline int table_of(int c) { return c == 0 ? 0 : 1; }

// Call f(blocks, membership, n) for every MCU of the scan in coding order:
// an interleaved scan's MCUs with libjpeg's dummy blocks at the right and
// bottom edges, or one block per MCU over a lone component's block grid.
template <class F>
void for_each_mcu(const Frame& f, const Scan& sc, F&& fn) {
    const int16_t* blocks[10];
    int memb[10];
    if (sc.ncomp == 1) {
        const int c = sc.comp[0];
        memb[0] = 0;
        const int16_t* p = f.coefs[c];
        const size_t n = static_cast<size_t>(f.bh[c]) * f.bw[c];
        for (size_t i = 0; i < n; i++, p += 64) {
            blocks[0] = p;
            fn(blocks, memb, 1);
        }
        return;
    }
    int16_t dummy[10][64];
    std::memset(dummy, 0, sizeof(dummy));
    for (int my = 0; my < f.mcus_y; my++) {
        for (int mx = 0; mx < f.mcus_x; mx++) {
            int n = 0;
            for (int i = 0; i < sc.ncomp; i++) {
                const int c = sc.comp[i];
                for (int yi = 0; yi < f.v[c]; yi++) {
                    for (int xi = 0; xi < f.h[c]; xi++, n++) {
                        const int by = my * f.v[c] + yi;
                        const int bx = mx * f.h[c] + xi;
                        if (by < f.bh[c] && bx < f.bw[c]) {
                            blocks[n] = f.coefs[c] +
                                        (static_cast<size_t>(by) * f.bw[c] + bx) * 64;
                        } else {
                            // the first block of a component's MCU is
                            // always real, so blocks[n - 1] is its own
                            dummy[n][0] = blocks[n - 1][0];
                            blocks[n] = dummy[n];
                        }
                        memb[n] = i;
                    }
                }
            }
            fn(blocks, memb, n);
        }
    }
}

enum class Mode { kSequential, kDcFirst, kDcRefine, kAcFirst, kAcRefine };

// Correction bits an AC refinement scan buffers before it forces its EOB
// run out (jcphuff.c MAX_CORR_BITS).
constexpr unsigned kMaxCorrBits = 1000;

// The entropy coder of one pass over one scan: the gather pass counts the
// symbols the output pass will code (jchuff.c encode_mcu_gather, jcphuff.c
// in gather mode); the output pass writes them (encode_mcu_huff and the
// four jcphuff.c scan types, ITU T.81 Annex F.1.2 and G.1.2).
class ScanCoder {
  public:
    ScanCoder(Writer* w, const Frame& f, const Scan& sc, Mode mode,
              bool gather, unsigned restart_interval, long (*dc_counts)[257],
              long (*ac_counts)[257], const HuffTable* dc,
              const HuffTable* ac)
        : w_(w), f_(f), sc_(sc), mode_(mode), gather_(gather),
          restart_interval_(restart_interval),
          restarts_to_go_(restart_interval), dc_counts_(dc_counts),
          ac_counts_(ac_counts), dc_(dc), ac_(ac),
          ac_tbl_(table_of(sc.comp[0])) {}

    // Codes every MCU and ends the pass; false on a coefficient outside
    // the coding range.
    bool run() {
        for_each_mcu(f_, sc_, [this](const int16_t* const* blocks,
                                     const int* memb, int n) {
            if (restart_interval_ && restarts_to_go_ == 0) restart();
            for (int b = 0; b < n && !bad_; b++) {
                const int c = sc_.comp[memb[b]];
                switch (mode_) {
                    case Mode::kSequential:
                        sequential(blocks[b], memb[b], c);
                        break;
                    case Mode::kDcFirst:
                        dc_first(blocks[b], memb[b], c);
                        break;
                    case Mode::kDcRefine:
                        raw(static_cast<unsigned>(blocks[b][0] >> sc_.Al), 1);
                        break;
                    case Mode::kAcFirst:
                        ac_first(blocks[b]);
                        break;
                    case Mode::kAcRefine:
                        ac_refine(blocks[b]);
                        break;
                }
            }
            if (restart_interval_) {
                if (restarts_to_go_ == 0) {
                    restarts_to_go_ = restart_interval_;
                    next_restart_ = (next_restart_ + 1) & 7;
                }
                restarts_to_go_--;
            }
        });
        emit_eobrun();
        if (!gather_) w_->flush();
        return !bad_;
    }

  private:
    void dc_symbol(int t, int sym) {
        if (gather_)
            dc_counts_[t][sym]++;
        else
            w_->bits(dc_[t].code[sym], dc_[t].size[sym]);
    }
    void ac_symbol(int t, int sym) {
        if (gather_)
            ac_counts_[t][sym]++;
        else
            w_->bits(ac_[t].code[sym], ac_[t].size[sym]);
    }
    void raw(unsigned value, int size) {
        if (!gather_) w_->bits(value, size);
    }

    // The pending EOB run, then the correction bits buffered with it.
    void emit_eobrun() {
        if (eobrun_ == 0) return;
        int nbits = 0;
        for (unsigned t = eobrun_; t >>= 1;) nbits++;
        ac_symbol(ac_tbl_, nbits << 4);
        if (nbits) raw(eobrun_, nbits);
        eobrun_ = 0;
        for (unsigned i = 0; i < be_; i++) raw(corr_[i], 1);
        be_ = 0;
    }

    void restart() {
        emit_eobrun();
        if (!gather_) {
            w_->flush();
            w_->marker(0xD0 + next_restart_);
        }
        if (sc_.Ss == 0) {
            last_dc_[0] = last_dc_[1] = last_dc_[2] = 0;
        } else {
            eobrun_ = 0;
            be_ = 0;
        }
    }

    // Magnitude category of a DC difference, and its extra bits.
    bool dc_diff(int diff, int t) {
        int bits = diff;
        if (diff < 0) {
            diff = -diff;
            bits--;
        }
        int nbits = 0;
        while (diff) {
            nbits++;
            diff >>= 1;
        }
        if (nbits > 11) {  // MAX_COEF_BITS + 1
            bad_ = true;
            return false;
        }
        dc_symbol(t, nbits);
        if (nbits) raw(static_cast<unsigned>(bits), nbits);
        return true;
    }

    void sequential(const int16_t* blk, int ci, int c) {
        const int t = table_of(c);
        const int dc = blk[0];
        const int diff = dc - last_dc_[ci];
        last_dc_[ci] = dc;
        if (!dc_diff(diff, t)) return;
        int run = 0;
        for (int k = 1; k < 64; k++) {
            int v = blk[kZigzag[k]];
            if (v == 0) {
                run++;
                continue;
            }
            while (run > 15) {
                ac_symbol(t, 0xF0);
                run -= 16;
            }
            int v2 = v;
            if (v < 0) {
                v = -v;
                v2--;
            }
            int nbits = 1;
            while (v >>= 1) nbits++;
            if (nbits > 10) {  // MAX_COEF_BITS
                bad_ = true;
                return;
            }
            ac_symbol(t, (run << 4) + nbits);
            raw(static_cast<unsigned>(v2), nbits);
            run = 0;
        }
        if (run > 0) ac_symbol(t, 0);
    }

    void dc_first(const int16_t* blk, int ci, int c) {
        const int v = blk[0] >> sc_.Al;  // the point transform
        const int diff = v - last_dc_[ci];
        last_dc_[ci] = v;
        dc_diff(diff, table_of(c));
    }

    void ac_first(const int16_t* blk) {
        const int al = sc_.Al;
        int r = 0;
        for (int k = sc_.Ss; k <= sc_.Se; k++) {
            int temp = blk[kZigzag[k]];
            if (temp == 0) {
                r++;
                continue;
            }
            int temp2;
            if (temp < 0) {
                temp = (-temp) >> al;
                temp2 = ~temp;
            } else {
                temp >>= al;
                temp2 = temp;
            }
            if (temp == 0) {  // zero after the point transform
                r++;
                continue;
            }
            emit_eobrun();
            while (r > 15) {
                ac_symbol(ac_tbl_, 0xF0);
                r -= 16;
            }
            int nbits = 1;
            while (temp >>= 1) nbits++;
            if (nbits > 10) {
                bad_ = true;
                return;
            }
            ac_symbol(ac_tbl_, (r << 4) + nbits);
            raw(static_cast<unsigned>(temp2), nbits);
            r = 0;
        }
        if (r > 0) {
            eobrun_++;
            if (eobrun_ == 0x7FFF) emit_eobrun();
        }
    }

    void ac_refine(const int16_t* blk) {
        const int al = sc_.Al;
        int absv[64];
        int eob = 0;  // the last coefficient that becomes nonzero here
        for (int k = sc_.Ss; k <= sc_.Se; k++) {
            int temp = blk[kZigzag[k]];
            if (temp < 0) temp = -temp;
            temp >>= al;
            absv[k] = temp;
            if (temp == 1) eob = k;
        }
        int r = 0;
        unsigned br = 0;          // correction bits of this block
        char* br_buf = corr_ + be_;
        for (int k = sc_.Ss; k <= sc_.Se; k++) {
            const int temp = absv[k];
            if (temp == 0) {
                r++;
                continue;
            }
            // ZRLs, unless the EOB run can absorb them
            while (r > 15 && k <= eob) {
                emit_eobrun();
                ac_symbol(ac_tbl_, 0xF0);
                r -= 16;
                for (unsigned i = 0; i < br; i++) raw(br_buf[i], 1);
                br_buf = corr_;
                br = 0;
            }
            if (temp > 1) {  // nonzero before: one correction bit
                br_buf[br++] = static_cast<char>(temp & 1);
                continue;
            }
            emit_eobrun();
            ac_symbol(ac_tbl_, (r << 4) + 1);
            raw(blk[kZigzag[k]] < 0 ? 0 : 1, 1);
            for (unsigned i = 0; i < br; i++) raw(br_buf[i], 1);
            br_buf = corr_;
            br = 0;
            r = 0;
        }
        if (r > 0 || br > 0) {
            eobrun_++;
            be_ += br;
            if (eobrun_ == 0x7FFF || be_ > kMaxCorrBits - 64 + 1)
                emit_eobrun();
        }
    }

    Writer* w_;
    const Frame& f_;
    const Scan& sc_;
    const Mode mode_;
    const bool gather_;
    const unsigned restart_interval_;
    unsigned restarts_to_go_;
    int next_restart_ = 0;
    long (*dc_counts_)[257];
    long (*ac_counts_)[257];
    const HuffTable* dc_;
    const HuffTable* ac_;
    const int ac_tbl_;  // the lone component's AC table (AC scans)
    int last_dc_[3] = {0, 0, 0};
    unsigned eobrun_ = 0;
    unsigned be_ = 0;  // correction bits buffered with the EOB run
    char corr_[kMaxCorrBits];
    bool bad_ = false;
};

Mode mode_of(const Scan& sc, bool progressive) {
    if (!progressive) return Mode::kSequential;
    if (sc.Ss == 0) return sc.Ah == 0 ? Mode::kDcFirst : Mode::kDcRefine;
    return sc.Ah == 0 ? Mode::kAcFirst : Mode::kAcRefine;
}

// jpeg_simple_progression's script (jcparam.c): YCbCr, and one component.
constexpr Scan kScriptYcc[10] = {
    {3, {0, 1, 2}, 0, 0, 0, 1},   // DC, interleaved
    {1, {0}, 1, 5, 0, 2},         // luma AC in a hurry
    {1, {2}, 1, 63, 0, 1},        // chroma AC
    {1, {1}, 1, 63, 0, 1},
    {1, {0}, 6, 63, 0, 2},        // the rest of luma AC
    {1, {0}, 1, 63, 2, 1},        // the next bit of luma AC
    {3, {0, 1, 2}, 0, 0, 1, 0},   // the last DC bit
    {1, {2}, 1, 63, 1, 0},        // the last AC bits
    {1, {1}, 1, 63, 1, 0},
    {1, {0}, 1, 63, 1, 0}};
constexpr Scan kScriptGray[6] = {
    {1, {0}, 0, 0, 0, 1},  {1, {0}, 1, 5, 0, 2},  {1, {0}, 6, 63, 0, 2},
    {1, {0}, 1, 63, 2, 1}, {1, {0}, 0, 0, 1, 0},  {1, {0}, 1, 63, 1, 0}};

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

// DHT for a table not written since it last changed (jcmarker.c emit_dht).
void emit_dht(Writer& w, int index, HuffSpec* s) {
    if (s->sent) return;
    w.marker(0xC4);
    w.u16(2 + 1 + 16 + s->nvals);
    w.byte(index);
    for (int i = 1; i <= 16; i++) w.byte(s->bits[i]);
    for (int i = 0; i < s->nvals; i++) w.byte(s->vals[i]);
    s->sent = true;
}

void emit_icc(Writer& w, const uint8_t* icc, int icc_len) {
    // libjpeg jpeg_write_icc_profile
    constexpr int kMaxData = 65533 - 14;
    const int nmark = (icc_len + kMaxData - 1) / kMaxData;
    int left = icc_len, seq = 1;
    const uint8_t* p = icc;
    while (left > 0) {
        const int n = left < kMaxData ? left : kMaxData;
        w.marker(0xE2);
        w.u16(n + 14 + 2);
        for (const char ch : {'I', 'C', 'C', '_', 'P', 'R', 'O', 'F', 'I', 'L',
                              'E', '\0'})
            w.byte(ch);
        w.byte(seq++);
        w.byte(nmark);
        w.out.insert(w.out.end(), p, p + n);
        p += n;
        left -= n;
    }
}

}  // namespace

extern "C" {

// Encode quantized coefficients as a JPEG, with lp_jpeg_encode_coefs's
// arguments and bytes.
//   ncomp 1 (gray) or 3 (YCbCr); h_samp/v_samp per component (1..2).
//   coefs per component: int16[blocks_h*blocks_w*64], natural order, with
//   blocks_w = ceil(width*h/(8*hmax)) and blocks_h likewise.
//   qtable_luma / qtable_chroma: uint16[64] natural order.
//   progressive: jpeg_simple_progression's scan script (SOF2); optimize:
//   optimal Huffman tables (always on for progressive output);
//   restart_in_rows > 0: a restart marker every that many MCU rows.
//   icc: optional profile, written as APP2 ICC_PROFILE chunks.
// Returns the bytes written into out, -1 for a coefficient outside the
// coding range or bad arguments, -2 when out_cap is too small.
long lpt_jpeg_encode_coefs(int32_t width, int32_t height, int32_t ncomp,
                           const int32_t* h_samp, const int32_t* v_samp,
                           int16_t** coefs, const uint16_t* qtable_luma,
                           const uint16_t* qtable_chroma, int32_t progressive,
                           int32_t optimize, int32_t restart_in_rows,
                           const uint8_t* icc, int32_t icc_len, uint8_t* out,
                           size_t out_cap) {
    if (width <= 0 || height <= 0 || width > 65500 || height > 65500 ||
        (ncomp != 1 && ncomp != 3) || icc_len < 0)
        return -1;
    Frame f;
    f.width = width;
    f.height = height;
    f.coefs = coefs;
    int hmax = 1, vmax = 1, mcu_blocks = 0;
    for (int c = 0; c < ncomp; c++) {
        if (h_samp[c] < 1 || h_samp[c] > 2 || v_samp[c] < 1 || v_samp[c] > 2)
            return -1;
        f.h[c] = h_samp[c];
        f.v[c] = v_samp[c];
        hmax = f.h[c] > hmax ? f.h[c] : hmax;
        vmax = f.v[c] > vmax ? f.v[c] : vmax;
        mcu_blocks += f.h[c] * f.v[c];
    }
    if (ncomp > 1 && mcu_blocks > 10) return -1;  // C_MAX_BLOCKS_IN_MCU
    for (int c = 0; c < ncomp; c++) {
        f.bw[c] = static_cast<int>(
            (static_cast<long>(width) * f.h[c] + 8L * hmax - 1) / (8L * hmax));
        f.bh[c] = static_cast<int>(
            (static_cast<long>(height) * f.v[c] + 8L * vmax - 1) / (8L * vmax));
    }
    f.mcus_x = (width + 8 * hmax - 1) / (8 * hmax);
    f.mcus_y = (height + 8 * vmax - 1) / (8 * vmax);

    // jpeg_add_quant_table at scale 100 keeps each entry, clamped to
    // 1..32767
    uint16_t qt[2][64];
    const uint16_t* qsrc[2] = {qtable_luma, qtable_chroma};
    const int ntables = ncomp > 1 ? 2 : 1;
    for (int t = 0; t < ntables; t++)
        for (int i = 0; i < 64; i++)
            qt[t][i] = qsrc[t][i] == 0 ? 1 : qsrc[t][i] > 32767 ? 32767
                                                                : qsrc[t][i];

    HuffSpec dc_spec[2], ac_spec[2];
    set_spec(&dc_spec[0], kDcLumaBits, kDcVals, 12);
    set_spec(&dc_spec[1], kDcChromaBits, kDcVals, 12);
    set_spec(&ac_spec[0], kAcLumaBits, kAcLumaVals, 162);
    set_spec(&ac_spec[1], kAcChromaBits, kAcChromaVals, 162);

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
    if (icc && icc_len > 0) emit_icc(w, icc, icc_len);

    Scan baseline{ncomp, {0, 1, 2}, 0, 63, 0, 0};
    const Scan* script = &baseline;
    int nscans = 1;
    if (progressive) {
        script = ncomp == 3 ? kScriptYcc : kScriptGray;
        nscans = ncomp == 3 ? 10 : 6;
    }
    // libjpeg-turbo codes progressive Huffman output with optimal tables
    const bool opt = optimize || progressive;
    long dc_counts[2][257], ac_counts[2][257];
    HuffTable dc_tbl[2], ac_tbl[2];
    unsigned last_restart_interval = 0;
    for (int s = 0; s < nscans; s++) {
        const Scan& sc = script[s];
        const Mode mode = mode_of(sc, progressive);
        // jcmaster.c per_scan_setup
        const long mcus_per_row = sc.ncomp == 1 ? f.bw[sc.comp[0]] : f.mcus_x;
        unsigned restart_interval = 0;
        if (restart_in_rows > 0) {
            const long nominal = static_cast<long>(restart_in_rows) * mcus_per_row;
            restart_interval = static_cast<unsigned>(nominal < 65535L ? nominal
                                                                      : 65535L);
        }
        const bool codes_dc = sc.Ss == 0 && sc.Ah == 0;  // DC refinement: no table
        const bool codes_ac = sc.Se != 0;
        if (opt && (codes_dc || codes_ac)) {
            std::memset(dc_counts, 0, sizeof(dc_counts));
            std::memset(ac_counts, 0, sizeof(ac_counts));
            ScanCoder gather(&w, f, sc, mode, true, restart_interval,
                             dc_counts, ac_counts, dc_tbl, ac_tbl);
            if (!gather.run()) return -1;
            bool did_dc[2] = {false, false}, did_ac[2] = {false, false};
            for (int i = 0; i < sc.ncomp; i++) {
                const int t = table_of(sc.comp[i]);
                if (codes_dc && !did_dc[t]) {
                    if (!gen_optimal_table(dc_counts[t], &dc_spec[t])) return -1;
                    did_dc[t] = true;
                }
                if (codes_ac && !did_ac[t]) {
                    if (!gen_optimal_table(ac_counts[t], &ac_spec[t])) return -1;
                    did_ac[t] = true;
                }
            }
        }
        if (s == 0) {
            // frame header: component c uses quant/Huffman table 0 (luma)
            // or 1
            bool wide = false;
            for (int t = 0; t < ntables; t++) {
                emit_dqt(w, t, qt[t]);
                for (int i = 0; i < 64; i++) wide = wide || qt[t][i] > 255;
            }
            w.marker(progressive ? 0xC2 : wide ? 0xC1 : 0xC0);
            w.u16(8 + 3 * ncomp);
            w.byte(8);
            w.u16(height);
            w.u16(width);
            w.byte(ncomp);
            for (int c = 0; c < ncomp; c++) {
                w.byte(c + 1);
                w.byte((f.h[c] << 4) + f.v[c]);
                w.byte(table_of(c));
            }
        }
        // scan header (jcmarker.c write_scan_header, emit_sos)
        for (int i = 0; i < sc.ncomp; i++) {
            const int t = table_of(sc.comp[i]);
            if (codes_dc) emit_dht(w, t, &dc_spec[t]);
            if (codes_ac) emit_dht(w, 0x10 + t, &ac_spec[t]);
        }
        if (restart_interval != last_restart_interval) {
            w.marker(0xDD);
            w.u16(4);
            w.u16(static_cast<int>(restart_interval));
            last_restart_interval = restart_interval;
        }
        w.marker(0xDA);
        w.u16(6 + 2 * sc.ncomp);
        w.byte(sc.ncomp);
        for (int i = 0; i < sc.ncomp; i++) {
            const int t = table_of(sc.comp[i]);
            int td = t, ta = t;
            if (progressive) {
                if (sc.Ss == 0) {
                    ta = 0;
                    if (sc.Ah != 0) td = 0;
                } else {
                    td = 0;
                }
            }
            w.byte(sc.comp[i] + 1);
            w.byte((td << 4) + ta);
        }
        w.byte(sc.Ss);
        w.byte(sc.Se);
        w.byte((sc.Ah << 4) + sc.Al);

        for (int t = 0; t < 2; t++) {
            derive(dc_spec[t], &dc_tbl[t]);
            derive(ac_spec[t], &ac_tbl[t]);
        }
        ScanCoder coder(&w, f, sc, mode, false, restart_interval, dc_counts,
                        ac_counts, dc_tbl, ac_tbl);
        if (!coder.run() || w.bad) return -1;
    }
    w.marker(0xD9);
    if (w.out.size() > out_cap) return -2;
    std::memcpy(out, w.out.data(), w.out.size());
    return static_cast<long>(w.out.size());
}

}  // extern "C"
