// GIF container + LZW codec (host entropy stage), written from the GIF89a
// specification — no giflib dependency.
//
// TPU-native split of the GIF path (SURVEY.md §7 step 6): this file only
// parses/serializes the container and performs the serial LZW entropy
// coding, exchanging palette *indices* with Python. Palette->BGRA expansion,
// frame compositing/disposal, and encode-side nearest-palette quantization
// run on device (lilliput_tpu/codecs/gif.py, ops/palette.py).
//
// Behavioral parity targets (reference: /root/reference/giflib.cpp):
//  * streaming frame-at-a-time decode with extension capture (:290-342)
//  * interlace passes offsets {0,4,2,1} jumps {8,8,4,2} (:587-694)
//  * NETSCAPE2.0 loop count + per-frame delay scan (:1303-1426)
//  * truncated-GCE hardening (CVE-2026-26740 guard, :270-288)
//  * encode: GIF89 output, palette reuse, extension replay (:784-1200)

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

namespace {

struct Reader {
    const uint8_t* p;
    size_t len;
    size_t pos = 0;

    bool read(void* dst, size_t n) {
        if (pos + n > len) return false;
        std::memcpy(dst, p + pos, n);
        pos += n;
        return true;
    }
    int byte() {
        if (pos >= len) return -1;
        return p[pos++];
    }
    bool skip(size_t n) {
        if (pos + n > len) return false;
        pos += n;
        return true;
    }
};

struct FrameMeta {
    int32_t left = 0, top = 0, width = 0, height = 0;
    int32_t interlace = 0;
    int32_t local_count = 0;       // 0 = use global palette
    int32_t trans_idx = -1;
    int32_t delay_cs = 0;          // centiseconds
    int32_t disposal = 0;          // GIF disposal: 0..3
    uint8_t local_pal[256 * 3];
    std::vector<uint8_t> ext_blob; // serialized non-GCE extensions: [func][count][data]*
};

struct GifDec {
    std::vector<uint8_t> data;
    Reader r{nullptr, 0};
    int32_t width = 0, height = 0;
    int32_t global_count = 0;
    int32_t bg_index = 0;
    int32_t color_res = 8;
    int32_t aspect = 0;
    uint8_t global_pal[256 * 3];
    FrameMeta frame;
    bool frame_ready = false;      // header parsed, raster not yet consumed
    size_t raster_pos = 0;         // where the image data (mcs byte) begins
    // lp_gif_scan results: after a scan the handle is read-only and any
    // number of threads may decode scanned frames concurrently (each
    // raster is an independent LZW stream — the intra-animation
    // parallelism seam; giflib's streaming walk is serial here)
    std::vector<FrameMeta> scanned;
    std::vector<size_t> scanned_raster;
};

bool parse_header(GifDec* d) {
    Reader& r = d->r;
    uint8_t magic[6];
    if (!r.read(magic, 6)) return false;
    if (std::memcmp(magic, "GIF87a", 6) != 0 && std::memcmp(magic, "GIF89a", 6) != 0)
        return false;
    uint8_t lsd[7];
    if (!r.read(lsd, 7)) return false;
    d->width = lsd[0] | (lsd[1] << 8);
    d->height = lsd[2] | (lsd[3] << 8);
    const uint8_t flags = lsd[4];
    d->bg_index = lsd[5];
    d->aspect = lsd[6];
    d->color_res = ((flags >> 4) & 7) + 1;
    if (flags & 0x80) {
        d->global_count = 2 << (flags & 7);
        if (!r.read(d->global_pal, static_cast<size_t>(d->global_count) * 3)) return false;
    }
    return true;
}

// Parse records until an image descriptor is ready or trailer/end reached.
// Returns 1 = frame header ready, 0 = eof, -1 = error.
int next_frame_header(GifDec* d) {
    if (d->frame_ready) return 1;
    Reader& r = d->r;
    FrameMeta f;  // fresh per frame (extensions cleared, parity with seek_clear_extensions)
    f.delay_cs = 0;
    f.trans_idx = -1;
    f.disposal = 0;
    while (true) {
        int rec = r.byte();
        if (rec < 0 || rec == 0x3B) return 0;  // EOF / trailer
        if (rec == 0x21) {                      // extension
            int func = r.byte();
            if (func < 0) return 0;
            if (func == 0xF9) {                 // graphics control
                int cnt = r.byte();
                if (cnt < 0) return -1;
                uint8_t gce[255];
                if (!r.read(gce, cnt)) return -1;
                if (cnt >= 4) {                 // truncated-GCE hardening
                    f.disposal = (gce[0] >> 2) & 7;
                    f.delay_cs = gce[1] | (gce[2] << 8);
                    f.trans_idx = (gce[0] & 1) ? gce[3] : -1;
                }
                // swallow remaining sub-blocks
                while (true) {
                    int c2 = r.byte();
                    if (c2 < 0) return -1;
                    if (c2 == 0) break;
                    if (!r.skip(c2)) return -1;
                }
            } else {                             // other extension: capture verbatim
                f.ext_blob.push_back(static_cast<uint8_t>(func));
                while (true) {
                    int cnt = r.byte();
                    if (cnt < 0) return -1;
                    f.ext_blob.push_back(static_cast<uint8_t>(cnt));
                    if (cnt == 0) break;
                    size_t at = f.ext_blob.size();
                    f.ext_blob.resize(at + cnt);
                    if (!r.read(f.ext_blob.data() + at, cnt)) return -1;
                }
            }
        } else if (rec == 0x2C) {               // image descriptor
            uint8_t id[9];
            if (!r.read(id, 9)) return -1;
            f.left = id[0] | (id[1] << 8);
            f.top = id[2] | (id[3] << 8);
            f.width = id[4] | (id[5] << 8);
            f.height = id[6] | (id[7] << 8);
            const uint8_t flags = id[8];
            f.interlace = (flags & 0x40) ? 1 : 0;
            if (flags & 0x80) {
                f.local_count = 2 << (flags & 7);
                if (!r.read(f.local_pal, static_cast<size_t>(f.local_count) * 3)) return -1;
            }
            if (f.width <= 0 || f.height <= 0) return -1;
            if (f.width > 0x7FFFFFFF / f.height) return -1;  // overflow guard
            d->frame = std::move(f);
            d->raster_pos = r.pos;
            d->frame_ready = true;
            return 1;
        }
        // unknown record types are skipped byte-at-a-time via loop
    }
}

// ---------------------------------------------------------------------------
// LZW decode
// ---------------------------------------------------------------------------

class LzwDecoder {
  public:
    LzwDecoder(Reader& r, int mcs) : r_(r), mcs_(mcs) {}

    // Decode exactly n pixels into out. Returns false on malformed data.
    //
    // Two structural speedups over the textbook backwards prefix-chain
    // walk (same-run A/B in tools/profile_anim.py / bench anim_host):
    //  * the data sub-blocks are destuffed ONCE into a flat buffer, so
    //    the bit reader runs 64-bit LSB-first lookahead refills with no
    //    per-byte block accounting on the hot path;
    //  * the dictionary stores each code's string as (position, length)
    //    into the OUTPUT ALREADY EMITTED — LZW emissions are contiguous,
    //    so the entry created after emitting code C at position P is
    //    exactly out[prev_P .. prev_P+prev_len] (prev emission plus the
    //    first byte of C's, which sits at prev_P+prev_len == P). Emitting
    //    any code is then one forward memcpy from earlier output instead
    //    of a data-dependent pointer chase writing backwards.
    // Output bytes and acceptance/failure cases are identical to the old
    // decoder (gated by the giflib-oracle and fuzz tests).
    bool decode(uint8_t* out, size_t n) {
        // destuff all sub-blocks (the reader then sits on the next record,
        // exactly where the old decoder's drain() left it)
        std::vector<uint8_t> data;
        data.reserve(std::min(r_.len - r_.pos, n + n / 4 + 64));
        while (true) {
            int cnt = r_.byte();
            if (cnt < 0) return false;  // EOF before block terminator
            if (cnt == 0) break;
            if (r_.pos + static_cast<size_t>(cnt) > r_.len) {
                r_.pos = r_.len;
                return false;
            }
            const size_t at = data.size();
            data.resize(at + static_cast<size_t>(cnt));
            std::memcpy(data.data() + at, r_.p + r_.pos,
                        static_cast<size_t>(cnt));
            r_.pos += static_cast<size_t>(cnt);
        }

        // root strings live in a static identity table (16-byte slop for
        // the fixed-width copy), so root and dictionary emissions share
        // ONE branch-free source-pointer path. Sized for the LARGEST
        // legal clear code (mcs 11 -> 2048 roots): a hostile stream with
        // mcs 9-11 can emit root codes >= 256, which giflib writes into
        // a GifPixelType, i.e. truncates to the low byte — the wrapped
        // uint8 cast here reproduces that exactly (a 256-entry table
        // read out of bounds for such codes: ASan-confirmed, fixed).
        static const auto kRoots = [] {
            std::array<uint8_t, 2048 + 16> t{};
            for (int i = 0; i < 2048; i++) t[i] = static_cast<uint8_t>(i);
            return t;
        }();

        const uint8_t* dp = data.data();
        const uint8_t* const dend = dp + data.size();
        uint64_t acc = 0;
        int nb = 0;
        const int clear = 1 << mcs_;
        const int end_code = clear + 1;
        int next_index = end_code + 1;
        int bits = mcs_ + 1;
        int prev = -1;
        size_t prev_pos = 0;
        uint16_t prev_len = 0;
        const uint8_t* src[4096];
        uint16_t len[4096];
        for (int i = 0; i < clear; i++) {
            src[i] = kRoots.data() + i;
            len[i] = 1;
        }
        len[clear] = len[end_code] = 0;
        size_t produced = 0;

        while (produced < n) {
            if (nb < 32) {  // one refill covers two 12-bit codes
                if (dend - dp >= 8) {
                    uint64_t v;
                    std::memcpy(&v, dp, 8);
                    acc |= v << nb;            // LSB-first lookahead refill
                    dp += (63 - nb) >> 3;      // whole bytes now counted
                    nb |= 56;
                } else {
                    while (nb <= 56 && dp < dend) {
                        acc |= static_cast<uint64_t>(*dp++) << nb;
                        nb += 8;
                    }
                }
            }
            if (nb < bits) return false;  // ran out of real data
            const int code = static_cast<int>(acc & ((1u << bits) - 1));
            acc >>= bits;
            nb -= bits;
            if (code == clear) {
                next_index = end_code + 1;
                bits = mcs_ + 1;
                prev = -1;
                continue;
            }
            if (code == end_code) break;
            const size_t P = produced;
            if (prev < 0) {  // first code of a run must be a root
                if (code >= clear) return false;
                out[produced++] = static_cast<uint8_t>(code);
                prev = code;
                prev_pos = P;
                prev_len = 1;
                continue;
            }
            if (code < next_index && len[code] > 0) {
                const int elen = len[code];
                if (produced + elen > n) return false;
                const uint8_t* s = src[code];
                if (elen <= 16 && produced + 16 <= n) {
                    // fixed 16-byte move for the dominant short strings:
                    // both words load BEFORE either store (the 16-byte
                    // window may read into the uninitialized slop past the
                    // true string, whose bytes land past elen and are
                    // overwritten by later emissions or gated by the
                    // produced == n check)
                    uint64_t a, b;
                    std::memcpy(&a, s, 8);
                    std::memcpy(&b, s + 8, 8);
                    std::memcpy(out + produced, &a, 8);
                    std::memcpy(out + produced + 8, &b, 8);
                } else {
                    // entry strings always end strictly before P: no overlap
                    std::memcpy(out + produced, s, elen);
                }
                if (next_index < 4096) {  // prev string + first byte of this
                    src[next_index] = out + prev_pos;
                    len[next_index] = static_cast<uint16_t>(prev_len + 1);
                    next_index++;
                    if (next_index == (1 << bits) && bits < 12) bits++;
                }
                produced += elen;
                prev = code;
                prev_pos = P;
                prev_len = static_cast<uint16_t>(elen);
            } else if (code == next_index && next_index < 4096) {
                // KwKwK: string = prev + first(prev); contiguity makes the
                // new entry the same (prev_pos, prev_len + 1) span
                const int elen = prev_len + 1;
                if (produced + elen > n) return false;
                std::memcpy(out + produced, out + prev_pos, prev_len);
                out[produced + prev_len] = out[prev_pos];
                src[next_index] = out + prev_pos;
                len[next_index] = static_cast<uint16_t>(elen);
                next_index++;
                if (next_index == (1 << bits) && bits < 12) bits++;
                produced += elen;
                prev = code;
                prev_pos = P;
                prev_len = static_cast<uint16_t>(elen);
            } else {
                return false;
            }
        }
        // premature end-of-information must FAIL, not succeed with an
        // uninitialized output tail (the caller hands us an np.empty
        // buffer — returning true here would composite heap bytes into
        // served images; giflib's DGifGetLine errors identically)
        return produced == n;
    }

  private:
    Reader& r_;
    int mcs_;
};

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

void* lp_gif_open(const uint8_t* buf, size_t len, int32_t* out6) {
    auto* d = new (std::nothrow) GifDec();
    if (!d) return nullptr;
    d->data.assign(buf, buf + len);
    d->r = Reader{d->data.data(), d->data.size()};
    if (!parse_header(d)) {
        delete d;
        return nullptr;
    }
    out6[0] = d->width;
    out6[1] = d->height;
    out6[2] = d->global_count;
    out6[3] = d->bg_index;
    out6[4] = d->color_res;
    out6[5] = d->aspect;
    return d;
}

void lp_gif_free(void* h) { delete static_cast<GifDec*>(h); }

int lp_gif_global_palette(void* h, uint8_t* out768) {
    auto* d = static_cast<GifDec*>(h);
    std::memcpy(out768, d->global_pal, static_cast<size_t>(d->global_count) * 3);
    return d->global_count;
}

// out10: left, top, w, h, interlace, local_count, trans_idx, delay_cs,
//        disposal, ext_len. Returns 1 frame ready / 0 eof / -1 error.
int lp_gif_next_frame(void* h, int32_t* out10) {
    auto* d = static_cast<GifDec*>(h);
    int st = next_frame_header(d);
    if (st != 1) return st;
    const FrameMeta& f = d->frame;
    out10[0] = f.left;
    out10[1] = f.top;
    out10[2] = f.width;
    out10[3] = f.height;
    out10[4] = f.interlace;
    out10[5] = f.local_count;
    out10[6] = f.trans_idx;
    out10[7] = f.delay_cs;
    out10[8] = f.disposal;
    out10[9] = static_cast<int32_t>(f.ext_blob.size());
    return 1;
}

int lp_gif_frame_palette(void* h, uint8_t* out768) {
    auto* d = static_cast<GifDec*>(h);
    if (d->frame.local_count > 0) {
        std::memcpy(out768, d->frame.local_pal, static_cast<size_t>(d->frame.local_count) * 3);
        return d->frame.local_count;
    }
    std::memcpy(out768, d->global_pal, static_cast<size_t>(d->global_count) * 3);
    return d->global_count;
}

int lp_gif_frame_ext(void* h, uint8_t* out, int32_t cap) {
    auto* d = static_cast<GifDec*>(h);
    const auto& b = d->frame.ext_blob;
    if (static_cast<int32_t>(b.size()) > cap) return -1;
    std::memcpy(out, b.data(), b.size());
    return static_cast<int32_t>(b.size());
}

// Shared raster decode: LZW + deinterlace from an explicit position,
// using a LOCAL reader so concurrent calls never share mutable state.
// ONE raster decode body (LZW + deinterlace) shared by the streaming
// walk (live reader, advances d->r) and the scan-then-parallel path
// (positioned local reader) — any decoder fix lands in both.
static int decode_raster(const FrameMeta& f, Reader& r, uint8_t* out) {
    int mcs = r.byte();
    if (mcs < 2 || mcs > 11) return -1;
    const size_t n = static_cast<size_t>(f.width) * f.height;
    bool ok;
    if (f.interlace) {
        std::vector<uint8_t> seq(n);
        LzwDecoder dec(r, mcs);
        ok = dec.decode(seq.data(), n);
        if (ok) {
            size_t src_row = 0;
            for (int pass = 0; pass < 4; pass++) {
                for (int y = kInterlaceOffset[pass]; y < f.height;
                     y += kInterlaceJump[pass]) {
                    std::memcpy(out + static_cast<size_t>(y) * f.width,
                                seq.data() + (src_row++) * f.width, f.width);
                }
            }
        }
    } else {
        LzwDecoder dec(r, mcs);
        ok = dec.decode(out, n);
    }
    return ok ? 0 : -1;
}

static int decode_raster_at(const GifDec* d, const FrameMeta& f,
                            size_t raster_pos, uint8_t* out) {
    Reader r{d->r.p, d->r.len, raster_pos};
    return decode_raster(f, r, out);
}

// Decode the pending frame's raster into out (w*h bytes, deinterlaced).
int lp_gif_frame_indices(void* h, uint8_t* out) {
    auto* d = static_cast<GifDec*>(h);
    if (!d->frame_ready) return -1;
    d->r.pos = d->raster_pos;
    const int rc = decode_raster(d->frame, d->r, out);
    d->frame_ready = false;
    return rc;
}

int lp_gif_skip_frame(void* h) {
    auto* d = static_cast<GifDec*>(h);
    int st = next_frame_header(d);
    if (st != 1) return st;
    Reader& r = d->r;
    r.pos = d->raster_pos;
    int mcs = r.byte();
    if (mcs < 0) return -1;
    while (true) {  // skip data sub-blocks
        int cnt = r.byte();
        if (cnt < 0) return -1;
        if (cnt == 0) break;
        if (!r.skip(cnt)) return -1;
    }
    d->frame_ready = false;
    return 1;
}

// ---------------------------------------------------------------------------
// Scan-then-parallel-decode API: one cheap serial container walk collects
// every frame header + raster position; the rasters are then independent
// LZW streams, decodable from any number of threads concurrently
// (lp_gif_decode_scanned is const over the handle). This is the seam the
// reference cannot use — giflib's DGifGetLine walk is inherently serial
// (/root/reference/giflib.cpp:290-324) — and what lets ONE viral
// animation spread across host cores instead of pinning one.
// ---------------------------------------------------------------------------

// Walk from the current position to the trailer, recording all frames.
// Returns the frame count (>= 0), or -1 on a corrupt frame header (same
// condition the streaming walk fails on). A truncated raster stops the
// scan after recording its frame; decoding that frame reports the error.
int lp_gif_scan(void* h) {
    auto* d = static_cast<GifDec*>(h);
    d->scanned.clear();
    d->scanned_raster.clear();
    while (true) {
        int st = next_frame_header(d);
        if (st == 0) break;
        if (st < 0) return -1;
        d->scanned.push_back(d->frame);
        d->scanned_raster.push_back(d->raster_pos);
        d->frame_ready = false;
        Reader& r = d->r;
        r.pos = d->raster_pos;
        int mcs = r.byte();
        if (mcs < 0) break;  // truncated raster: frame kept, scan ends
        while (true) {       // skip data sub-blocks
            int cnt = r.byte();
            if (cnt <= 0) {
                if (cnt < 0) r.pos = r.len;
                break;
            }
            if (!r.skip(static_cast<size_t>(cnt))) break;
        }
    }
    return static_cast<int>(d->scanned.size());
}

int lp_gif_scanned_meta(void* h, int32_t i, int32_t* out10) {
    auto* d = static_cast<GifDec*>(h);
    if (i < 0 || static_cast<size_t>(i) >= d->scanned.size()) return -1;
    const FrameMeta& f = d->scanned[i];
    out10[0] = f.left;
    out10[1] = f.top;
    out10[2] = f.width;
    out10[3] = f.height;
    out10[4] = f.interlace;
    out10[5] = f.local_count;
    out10[6] = f.trans_idx;
    out10[7] = f.delay_cs;
    out10[8] = f.disposal;
    out10[9] = static_cast<int32_t>(f.ext_blob.size());
    return 0;
}

int lp_gif_scanned_palette(void* h, int32_t i, uint8_t* out768) {
    auto* d = static_cast<GifDec*>(h);
    if (i < 0 || static_cast<size_t>(i) >= d->scanned.size()) return -1;
    const FrameMeta& f = d->scanned[i];
    if (f.local_count > 0) {
        std::memcpy(out768, f.local_pal,
                    static_cast<size_t>(f.local_count) * 3);
        return f.local_count;
    }
    std::memcpy(out768, d->global_pal,
                static_cast<size_t>(d->global_count) * 3);
    return d->global_count;
}

int lp_gif_scanned_ext(void* h, int32_t i, uint8_t* out, int32_t cap) {
    auto* d = static_cast<GifDec*>(h);
    if (i < 0 || static_cast<size_t>(i) >= d->scanned.size()) return -1;
    const auto& b = d->scanned[i].ext_blob;
    if (static_cast<int32_t>(b.size()) > cap) return -1;
    std::memcpy(out, b.data(), b.size());
    return static_cast<int32_t>(b.size());
}

// Thread-safe: const over the handle; any number of concurrent callers.
int lp_gif_decode_scanned(void* h, int32_t i, uint8_t* out) {
    auto* d = static_cast<GifDec*>(h);
    if (i < 0 || static_cast<size_t>(i) >= d->scanned.size()) return -1;
    return decode_raster_at(d, d->scanned[i], d->scanned_raster[i], out);
}

// Stateless scan: out7 = loop_count, frame_count, duration_ms, bg_r, bg_g, bg_b, bg_a.
// Parity with giflib_decoder_get_animation_info (giflib.cpp:1303-1426).
int lp_gif_anim_info(const uint8_t* buf, size_t len, int32_t* out7) {
    GifDec d;
    d.data.assign(buf, buf + len);
    d.r = Reader{d.data.data(), d.data.size()};
    if (!parse_header(&d)) return -1;
    int32_t loop_count = 1, frame_count = 0, duration_ms = 0;
    bool found_loop = false, found_gcb = false;
    int32_t first_trans = -1;
    Reader& r = d.r;
    while (true) {
        int rec = r.byte();
        if (rec < 0 || rec == 0x3B) break;
        if (rec == 0x21) {
            int func = r.byte();
            if (func < 0) break;
            if (func == 0xF9) {
                int cnt = r.byte();
                if (cnt < 0) break;
                uint8_t gce[255];
                if (!r.read(gce, cnt)) break;
                if (cnt >= 4) {
                    int delay_cs = gce[1] | (gce[2] << 8);
                    int ms = (frame_count > 0 && delay_cs < 2) ? 20 : delay_cs * 10;
                    duration_ms += ms;
                    if (!found_gcb) {
                        found_gcb = true;
                        first_trans = (gce[0] & 1) ? gce[3] : -1;
                    }
                }
                while (true) {
                    int c2 = r.byte();
                    if (c2 <= 0) break;
                    if (!r.skip(c2)) break;
                }
            } else {
                bool is_netscape_probe = (func == 0xFF);
                bool checked_first = false;
                while (true) {
                    int cnt = r.byte();
                    if (cnt < 0) goto done;
                    if (cnt == 0) break;
                    uint8_t tmp[255];
                    if (!r.read(tmp, cnt)) goto done;
                    if (is_netscape_probe && !checked_first) {
                        checked_first = true;
                        if (!found_loop && cnt >= 11 &&
                            std::memcmp(tmp, "NETSCAPE2.0", 11) == 0) {
                            // loop payload is in the following sub-block
                            int c3 = r.byte();
                            if (c3 >= 3) {
                                uint8_t lb[255];
                                if (!r.read(lb, c3)) goto done;
                                if (lb[0] == 1) {
                                    loop_count = lb[1] | (lb[2] << 8);
                                    found_loop = true;
                                }
                            } else if (c3 > 0) {
                                if (!r.skip(c3)) goto done;
                            } else if (c3 == 0) {
                                break;
                            } else {
                                goto done;
                            }
                        }
                    }
                }
            }
        } else if (rec == 0x2C) {
            uint8_t id[9];
            if (!r.read(id, 9)) break;
            frame_count++;
            if (id[8] & 0x80) {
                if (!r.skip(static_cast<size_t>(2 << (id[8] & 7)) * 3)) break;
            }
            int mcs = r.byte();
            if (mcs < 0) break;
            while (true) {
                int cnt = r.byte();
                if (cnt < 0) goto done;
                if (cnt == 0) break;
                if (!r.skip(cnt)) goto done;
            }
        }
    }
done:
    // background color per extract_background_color (giflib.cpp:590-631)
    int32_t bg_r = 255, bg_g = 255, bg_b = 255, bg_a = 255;
    const bool valid_bg = d.global_count > 0 && d.bg_index >= 0 && d.bg_index < d.global_count;
    // no-GCE quirk: the reference's zero-initialized GraphicsControlBlock has
    // TransparentColor==0 != NO_TRANSPARENT_COLOR, so a GIF with no GCE at
    // all reports a TRANSPARENT background (giflib.cpp:1327,1391-1401,597)
    const bool have_transparency = found_gcb ? (first_trans != -1) : true;
    if (have_transparency) {
        if (valid_bg) {
            bg_r = d.global_pal[d.bg_index * 3];
            bg_g = d.global_pal[d.bg_index * 3 + 1];
            bg_b = d.global_pal[d.bg_index * 3 + 2];
        }
        bg_a = 0;
    } else if (valid_bg) {
        bg_r = d.global_pal[d.bg_index * 3];
        bg_g = d.global_pal[d.bg_index * 3 + 1];
        bg_b = d.global_pal[d.bg_index * 3 + 2];
        bg_a = 255;
    }
    out7[0] = loop_count;
    out7[1] = frame_count;
    out7[2] = duration_ms;
    out7[3] = bg_r;
    out7[4] = bg_g;
    out7[5] = bg_b;
    out7[6] = bg_a;
    return 0;
}

// ----------------------------- encoder ------------------------------------

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
