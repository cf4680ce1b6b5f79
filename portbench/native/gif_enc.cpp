// Frozen copy of the GIF encoder half of lilliput_tpu_torch/csrc/host/
// gif_codec.cpp (dictionary LZW, GIF89a container), so that the inputs the
// benchmark writes do not move when the program's encoder changes. Copied
// verbatim: the interlace tables, LzwEncoder, GifEnc and the lp_gif_enc_*
// C ABI.

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

namespace {
const int kInterlaceOffset[4] = {0, 4, 2, 1};
const int kInterlaceJump[4] = {8, 8, 4, 2};

// ---------------------------------------------------------------------------
// LZW encode
// ---------------------------------------------------------------------------

class LzwEncoder {
  public:
    explicit LzwEncoder(std::vector<uint8_t>& out, int mcs) : out_(out), mcs_(mcs) {
        out_.push_back(static_cast<uint8_t>(mcs_));
        reset_table();
        emit(clear_);
    }

    void encode(const uint8_t* px, size_t n) {
        for (size_t i = 0; i < n; i++) {
            const int k = px[i];
            if (cur_ < 0) {
                cur_ = k;
                continue;
            }
            const int slot = find(cur_, k);
            if (table_code_[slot] >= 0) {
                cur_ = table_code_[slot];
            } else {
                emit(cur_);
                if (next_code_ >= 4096) {
                    emit(clear_);
                    reset_table();
                } else {
                    table_key_[slot] = key(cur_, k);
                    table_code_[slot] = next_code_++;
                    // decoder bumps its read width when its table hits 1<<bits,
                    // so the encoder must switch at the same boundary
                    if (next_code_ > (1 << bits_) && bits_ < 12) bits_++;
                }
                cur_ = k;
            }
        }
    }

    void finish() {
        if (cur_ >= 0) emit(cur_);
        emit(end_);
        flush_bits();
        flush_block();
        out_.push_back(0);  // block terminator
    }

  private:
    static uint32_t key(int prefix, int k) {
        return (static_cast<uint32_t>(prefix) << 8) | static_cast<uint32_t>(k) | 0x80000000u;
    }

    int find(int prefix, int k) const {
        const uint32_t kk = key(prefix, k);
        uint32_t h = (kk * 2654435761u) & kHashMask;
        while (table_key_[h] != 0 && table_key_[h] != kk)
            h = (h + 1) & kHashMask;
        return static_cast<int>(h);
    }

    void reset_table() {
        clear_ = 1 << mcs_;
        end_ = clear_ + 1;
        next_code_ = end_ + 1;
        bits_ = mcs_ + 1;
        std::memset(table_key_, 0, sizeof(table_key_));
        std::memset(table_code_, -1, sizeof(table_code_));
    }

    void emit(int code) {
        acc_ |= static_cast<uint64_t>(code) << nbits_;
        nbits_ += bits_;
        while (nbits_ >= 8) {
            put_byte(static_cast<uint8_t>(acc_ & 0xFF));
            acc_ >>= 8;
            nbits_ -= 8;
        }
    }

    void flush_bits() {
        if (nbits_ > 0) {
            put_byte(static_cast<uint8_t>(acc_ & 0xFF));
            acc_ = 0;
            nbits_ = 0;
        }
    }

    void put_byte(uint8_t b) {
        block_[block_len_++] = b;
        if (block_len_ == 255) flush_block();
    }

    void flush_block() {
        if (block_len_ > 0) {
            out_.push_back(static_cast<uint8_t>(block_len_));
            out_.insert(out_.end(), block_, block_ + block_len_);
            block_len_ = 0;
        }
    }

    static constexpr uint32_t kHashSize = 1 << 14;
    static constexpr uint32_t kHashMask = kHashSize - 1;
    std::vector<uint8_t>& out_;
    int mcs_;
    int clear_ = 0, end_ = 0, next_code_ = 0, bits_ = 0, cur_ = -1;
    uint64_t acc_ = 0;
    int nbits_ = 0;
    uint8_t block_[256];
    int block_len_ = 0;
    uint32_t table_key_[kHashSize];
    int32_t table_code_[kHashSize];
};

struct GifEnc {
    std::vector<uint8_t> out;
    int32_t width = 0, height = 0;
};

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

void* lp_gif_enc_new(int32_t width, int32_t height, int32_t color_res,
                     int32_t aspect, int32_t bg_index,
                     const uint8_t* global_pal, int32_t global_count) {
    auto* e = new (std::nothrow) GifEnc();
    if (!e) return nullptr;
    e->width = width;
    e->height = height;
    auto& o = e->out;
    o.insert(o.end(), {'G', 'I', 'F', '8', '9', 'a'});
    o.push_back(static_cast<uint8_t>(width & 0xFF));
    o.push_back(static_cast<uint8_t>(width >> 8));
    o.push_back(static_cast<uint8_t>(height & 0xFF));
    o.push_back(static_cast<uint8_t>(height >> 8));
    uint8_t flags = static_cast<uint8_t>(((color_res - 1) & 7) << 4);
    int pal_bits = 0;
    if (global_count > 0) {
        while ((2 << pal_bits) < global_count) pal_bits++;
        flags |= 0x80 | pal_bits;
    }
    o.push_back(flags);
    o.push_back(static_cast<uint8_t>(global_count > 0 ? bg_index : 0));
    o.push_back(static_cast<uint8_t>(aspect));
    if (global_count > 0) {
        const int total = 2 << pal_bits;
        o.insert(o.end(), global_pal, global_pal + global_count * 3);
        for (int i = global_count; i < total; i++)
            o.insert(o.end(), {0, 0, 0});
    }
    return e;
}

// Write one frame. ext_blob: serialized non-GCE extensions to replay.
// desc: left, top, w, h, interlace, trans_idx, delay_cs, disposal.
// palette/pal_count: local palette (0 = use global).
int lp_gif_enc_frame(void* h, const uint8_t* ext_blob, int32_t ext_len,
                     const int32_t* desc, const uint8_t* palette,
                     int32_t pal_count, const uint8_t* indices) {
    auto* e = static_cast<GifEnc*>(h);
    auto& o = e->out;
    // replay captured extensions (NETSCAPE loop count, comments, ...)
    int32_t p = 0;
    while (p < ext_len) {
        o.push_back(0x21);
        o.push_back(ext_blob[p++]);  // function
        while (p < ext_len) {
            uint8_t cnt = ext_blob[p++];
            o.push_back(cnt);
            if (cnt == 0) break;
            if (p + cnt > ext_len) return -1;
            o.insert(o.end(), ext_blob + p, ext_blob + p + cnt);
            p += cnt;
        }
    }
    const int32_t left = desc[0], top = desc[1], w = desc[2], hgt = desc[3];
    const int32_t interlace = desc[4], trans = desc[5], delay = desc[6], disp = desc[7];
    // GCE
    o.push_back(0x21);
    o.push_back(0xF9);
    o.push_back(4);
    uint8_t gflags = static_cast<uint8_t>((disp & 7) << 2);
    if (trans >= 0) gflags |= 1;
    o.push_back(gflags);
    o.push_back(static_cast<uint8_t>(delay & 0xFF));
    o.push_back(static_cast<uint8_t>((delay >> 8) & 0xFF));
    o.push_back(static_cast<uint8_t>(trans >= 0 ? trans : 0));
    o.push_back(0);
    // image descriptor
    o.push_back(0x2C);
    o.push_back(static_cast<uint8_t>(left & 0xFF));
    o.push_back(static_cast<uint8_t>(left >> 8));
    o.push_back(static_cast<uint8_t>(top & 0xFF));
    o.push_back(static_cast<uint8_t>(top >> 8));
    o.push_back(static_cast<uint8_t>(w & 0xFF));
    o.push_back(static_cast<uint8_t>(w >> 8));
    o.push_back(static_cast<uint8_t>(hgt & 0xFF));
    o.push_back(static_cast<uint8_t>(hgt >> 8));
    uint8_t iflags = interlace ? 0x40 : 0;
    int pal_bits = 0;
    if (pal_count > 0) {
        while ((2 << pal_bits) < pal_count) pal_bits++;
        iflags |= 0x80 | pal_bits;
    }
    o.push_back(iflags);
    if (pal_count > 0) {
        const int total = 2 << pal_bits;
        o.insert(o.end(), palette, palette + pal_count * 3);
        for (int i = pal_count; i < total; i++)
            o.insert(o.end(), {0, 0, 0});
    }
    // raster: desc[8] = LZW min code size from caller (bits of the effective
    // palette actually in force — local here, or the file's global one)
    int mcs = desc[8];
    if (pal_count > 0) mcs = pal_bits + 1;
    if (mcs < 2) mcs = 2;
    if (mcs > 11) mcs = 11;
    LzwEncoder enc(o, mcs);
    if (interlace) {
        for (int pass = 0; pass < 4; pass++) {
            for (int y = kInterlaceOffset[pass]; y < hgt; y += kInterlaceJump[pass]) {
                enc.encode(indices + static_cast<size_t>(y) * w, w);
            }
        }
    } else {
        enc.encode(indices, static_cast<size_t>(w) * hgt);
    }
    enc.finish();
    return 0;
}

long lp_gif_enc_size(void* h) {
    return static_cast<long>(static_cast<GifEnc*>(h)->out.size()) + 1;  // + trailer
}

long lp_gif_enc_finish(void* h, uint8_t* out, size_t cap) {
    auto* e = static_cast<GifEnc*>(h);
    e->out.push_back(0x3B);  // trailer
    if (e->out.size() > cap) return -1;
    std::memcpy(out, e->out.data(), e->out.size());
    return static_cast<long>(e->out.size());
}

void lp_gif_enc_free(void* h) { delete static_cast<GifEnc*>(h); }

}  // extern "C"
