// PNG row unfiltering (host stage of the PNG codec).
//
// PNG's five row filters form a serial recurrence (each reconstructed byte
// depends on the byte to its left and the row above), so this is host-C++
// like the other entropy-ish stages; palette expansion, 16->8 conversion and
// channel swizzles then run on device (lilliput_tpu/codecs/png.py).
// Replaces the libpng row-defilter inside the reference's OpenCV PNG decode
// (/root/reference/opencv.cpp:93-146 via cv::ImageDecoder).

#include <cstdint>
#include <cstdlib>
#include <cstring>

#if defined(__SSE2__)
#include <emmintrin.h>
#endif

// Fast zlib-stream (de)compression via libdeflate when its header is present
// (the Makefile gates -ldeflate the same way). This plays the role zlib-ng
// plays in the reference (/root/reference/deps/build-deps-linux.sh builds
// zlib-ng into libpng for exactly this host-deflate bottleneck); PNG sizes
// are always known exactly on both sides, which is libdeflate's sweet spot.
#if __has_include(<libdeflate.h>)
#include <libdeflate.h>
#define LP_HAVE_LIBDEFLATE 1
#endif

extern "C" {

// 1 when the fast deflate path is compiled in.
int lp_zlib_fast_available(void) {
#ifdef LP_HAVE_LIBDEFLATE
    return 1;
#else
    return 0;
#endif
}

// Compress `n` bytes into a zlib-format stream. Returns the compressed size,
// or 0 if unavailable / the output does not fit in `out_cap` (caller falls
// back to Python zlib). `level` is the zlib 0-9 scale.
int64_t lp_zlib_compress(const uint8_t* in, int64_t n,
                         uint8_t* out, int64_t out_cap, int32_t level) {
#ifdef LP_HAVE_LIBDEFLATE
    if (level < 0) level = 6;
    if (level > 12) level = 12;
    struct libdeflate_compressor* c = libdeflate_alloc_compressor(level);
    if (!c) return 0;
    size_t sz = libdeflate_zlib_compress(c, in, static_cast<size_t>(n),
                                         out, static_cast<size_t>(out_cap));
    libdeflate_free_compressor(c);
    return static_cast<int64_t>(sz);
#else
    (void)in; (void)n; (void)out; (void)out_cap; (void)level;
    return 0;
#endif
}

// Upper bound for lp_zlib_compress output (0 if unavailable).
int64_t lp_zlib_compress_bound(int64_t n) {
#ifdef LP_HAVE_LIBDEFLATE
    struct libdeflate_compressor* c = libdeflate_alloc_compressor(6);
    if (!c) return 0;
    size_t b = libdeflate_zlib_compress_bound(c, static_cast<size_t>(n));
    libdeflate_free_compressor(c);
    return static_cast<int64_t>(b);
#else
    (void)n;
    return 0;
#endif
}

// Decompress a zlib-format stream whose decompressed size is exactly known
// (PNG: sum of per-pass (stride+1)*rows). Returns the number of bytes
// written, or -1 on any mismatch/corruption/unavailability — the caller
// falls back to Python zlib so edge-case semantics (trailing garbage,
// nonstandard padding) stay byte-identical with the historical path.
int64_t lp_zlib_decompress(const uint8_t* in, int64_t n,
                           uint8_t* out, int64_t out_n) {
#ifdef LP_HAVE_LIBDEFLATE
    struct libdeflate_decompressor* d = libdeflate_alloc_decompressor();
    if (!d) return -1;
    size_t actual = 0;
    enum libdeflate_result r = libdeflate_zlib_decompress(
        d, in, static_cast<size_t>(n), out, static_cast<size_t>(out_n),
        &actual);
    libdeflate_free_decompressor(d);
    if (r != LIBDEFLATE_SUCCESS) return -1;
    return static_cast<int64_t>(actual);
#else
    (void)in; (void)n; (void)out; (void)out_n;
    return -1;
#endif
}

#if defined(__SSE2__)
namespace {

// SSE2 row unfilters for the photographic layouts (bpp 3/4, 8-bit).
// The recurrences are pixel-serial, but each pixel's byte math runs as
// one vector op chain instead of 3-4 branchy scalar byte updates —
// photo PNGs are almost entirely Paeth/Sub rows (the 1080p bench
// fixture: 936 Paeth + 144 Sub of 1080), and the scalar walk measured
// 24 ms/1080p (~260 MB/s) on the serving still host path. All lanes
// compute exact integer math (epi16 sums ≤ 510), so output is
// bit-identical to the scalar reference below, which remains both the
// non-SSE2 build and the odd-bpp (gray, 16-bit, palette<8bpp) path.
// Vector loops stop one pixel early: the 4-byte loads/stores of a
// 3-byte pixel may touch the neighbor byte, which is fine mid-row but
// would over-run the buffers at the row end.

inline void sub_row_sse(const uint8_t* src, uint8_t* dst, int64_t stride,
                        int bpp) {
    __m128i a = _mm_setzero_si128();
    int64_t x = 0;
    for (; x + 4 <= stride; x += bpp) {
        const __m128i v = _mm_cvtsi32_si128(
            *reinterpret_cast<const int32_t*>(src + x));
        a = _mm_add_epi8(v, a);
        *reinterpret_cast<int32_t*>(dst + x) = _mm_cvtsi128_si32(a);
    }
    for (; x < stride; x++)
        dst[x] = static_cast<uint8_t>(src[x] +
                                      (x >= bpp ? dst[x - bpp] : 0));
}

inline void up_row_sse(const uint8_t* src, const uint8_t* prev,
                       uint8_t* dst, int64_t stride) {
    int64_t x = 0;
    for (; x + 16 <= stride; x += 16) {
        const __m128i s = _mm_loadu_si128(
            reinterpret_cast<const __m128i*>(src + x));
        const __m128i p = _mm_loadu_si128(
            reinterpret_cast<const __m128i*>(prev + x));
        _mm_storeu_si128(reinterpret_cast<__m128i*>(dst + x),
                         _mm_add_epi8(s, p));
    }
    for (; x < stride; x++)
        dst[x] = static_cast<uint8_t>(src[x] + prev[x]);
}

inline void avg_row_sse(const uint8_t* src, const uint8_t* prev,
                        uint8_t* dst, int64_t stride, int bpp) {
    const __m128i z = _mm_setzero_si128();
    __m128i a = _mm_setzero_si128();  // previous dst pixel, epi16
    int64_t x = 0;
    for (; x + 4 < stride; x += bpp) {  // strict <: keep 1-pixel tail
        const __m128i b = _mm_unpacklo_epi8(
            _mm_cvtsi32_si128(*reinterpret_cast<const int32_t*>(prev + x)),
            z);
        const __m128i s = _mm_unpacklo_epi8(
            _mm_cvtsi32_si128(*reinterpret_cast<const int32_t*>(src + x)),
            z);
        const __m128i d = _mm_add_epi16(
            s, _mm_srli_epi16(_mm_add_epi16(a, b), 1));
        a = _mm_and_si128(d, _mm_set1_epi16(0xFF));
        *reinterpret_cast<int32_t*>(dst + x) =
            _mm_cvtsi128_si32(_mm_packus_epi16(a, a));
    }
    for (; x < stride; x++) {
        const int pa = x >= bpp ? dst[x - bpp] : 0;
        dst[x] = static_cast<uint8_t>(src[x] + ((pa + prev[x]) >> 1));
    }
}

inline void paeth_row_sse(const uint8_t* src, const uint8_t* prev,
                          uint8_t* dst, int64_t stride, int bpp) {
    const __m128i z = _mm_setzero_si128();
    __m128i a = _mm_setzero_si128();  // left dst pixel, epi16
    __m128i c = _mm_setzero_si128();  // up-left prev pixel, epi16
    int64_t x = 0;
    for (; x + 4 < stride; x += bpp) {  // strict <: keep 1-pixel tail
        const __m128i b = _mm_unpacklo_epi8(
            _mm_cvtsi32_si128(*reinterpret_cast<const int32_t*>(prev + x)),
            z);
        const __m128i s = _mm_unpacklo_epi8(
            _mm_cvtsi32_si128(*reinterpret_cast<const int32_t*>(src + x)),
            z);
        // p - a = b - c ; p - b = a - c ; p - c = (b - c) + (a - c)
        const __m128i bc = _mm_sub_epi16(b, c);
        const __m128i ac = _mm_sub_epi16(a, c);
        const __m128i pa = _mm_max_epi16(bc, _mm_sub_epi16(z, bc));
        const __m128i pb = _mm_max_epi16(ac, _mm_sub_epi16(z, ac));
        const __m128i abc = _mm_add_epi16(bc, ac);
        const __m128i pc = _mm_max_epi16(abc, _mm_sub_epi16(z, abc));
        // pred = (pa<=pb && pa<=pc) ? a : (pb<=pc ? b : c)
        const __m128i sel_a = _mm_andnot_si128(
            _mm_or_si128(_mm_cmpgt_epi16(pa, pb), _mm_cmpgt_epi16(pa, pc)),
            _mm_set1_epi16(-1));
        const __m128i sel_b = _mm_andnot_si128(_mm_cmpgt_epi16(pb, pc),
                                               _mm_set1_epi16(-1));
        const __m128i bc_pick = _mm_or_si128(
            _mm_and_si128(sel_b, b), _mm_andnot_si128(sel_b, c));
        const __m128i pred = _mm_or_si128(
            _mm_and_si128(sel_a, a), _mm_andnot_si128(sel_a, bc_pick));
        const __m128i d = _mm_and_si128(_mm_add_epi16(s, pred),
                                        _mm_set1_epi16(0xFF));
        *reinterpret_cast<int32_t*>(dst + x) =
            _mm_cvtsi128_si32(_mm_packus_epi16(d, d));
        a = d;
        c = b;
    }
    for (; x < stride; x++) {
        const int pa_ = x >= bpp ? dst[x - bpp] : 0;
        const int pb_ = prev[x];
        const int pc_ = x >= bpp ? prev[x - bpp] : 0;
        const int p = pa_ + pb_ - pc_;
        const int da = std::abs(p - pa_), db = std::abs(p - pb_),
                  dc = std::abs(p - pc_);
        const int pred =
            (da <= db && da <= dc) ? pa_ : (db <= dc ? pb_ : pc_);
        dst[x] = static_cast<uint8_t>(src[x] + pred);
    }
}

}  // namespace
#endif  // __SSE2__

// In-place unfilter of `rows` rows of `stride` bytes each, where the input
// layout is (filter_byte || row_bytes) per row, `bpp` = bytes per pixel
// (filter unit). in: rows*(stride+1) bytes; out: rows*stride bytes.
// Returns 0 on success, -1 on bad filter type.
int lp_png_unfilter(const uint8_t* in, uint8_t* out,
                    int64_t rows, int64_t stride, int32_t bpp) {
#if defined(__SSE2__)
    if ((bpp == 3 || bpp == 4) && stride >= 8) {
        const uint8_t* prev = nullptr;
        for (int64_t y = 0; y < rows; y++) {
            const uint8_t* src = in + y * (stride + 1);
            uint8_t* dst = out + y * stride;
            const uint8_t ft = src[0];
            src++;
            switch (ft) {
                case 0:
                    std::memcpy(dst, src, stride);
                    break;
                case 1:
                    sub_row_sse(src, dst, stride, bpp);
                    break;
                case 2:
                    if (prev)
                        up_row_sse(src, prev, dst, stride);
                    else
                        std::memcpy(dst, src, stride);
                    break;
                case 3:
                    if (prev) {
                        avg_row_sse(src, prev, dst, stride, bpp);
                    } else {
                        // first row: avg degrades to a half-sub
                        for (int64_t x = 0; x < stride; x++)
                            dst[x] = static_cast<uint8_t>(
                                src[x] +
                                ((x >= bpp ? dst[x - bpp] : 0) >> 1));
                    }
                    break;
                case 4:
                    if (prev) {
                        paeth_row_sse(src, prev, dst, stride, bpp);
                    } else {
                        // first row: paeth degrades to sub (b = c = 0)
                        sub_row_sse(src, dst, stride, bpp);
                    }
                    break;
                default:
                    return -1;
            }
            prev = dst;
        }
        return 0;
    }
#endif
    const uint8_t* prev = nullptr;
    for (int64_t y = 0; y < rows; y++) {
        const uint8_t* src = in + y * (stride + 1);
        uint8_t* dst = out + y * stride;
        const uint8_t ft = src[0];
        src++;
        switch (ft) {
            case 0:  // None
                std::memcpy(dst, src, stride);
                break;
            case 1:  // Sub
                for (int64_t x = 0; x < bpp && x < stride; x++) dst[x] = src[x];
                for (int64_t x = bpp; x < stride; x++)
                    dst[x] = static_cast<uint8_t>(src[x] + dst[x - bpp]);
                break;
            case 2:  // Up
                if (prev) {
                    for (int64_t x = 0; x < stride; x++)
                        dst[x] = static_cast<uint8_t>(src[x] + prev[x]);
                } else {
                    std::memcpy(dst, src, stride);
                }
                break;
            case 3:  // Average
                for (int64_t x = 0; x < stride; x++) {
                    const int a = x >= bpp ? dst[x - bpp] : 0;
                    const int b = prev ? prev[x] : 0;
                    dst[x] = static_cast<uint8_t>(src[x] + ((a + b) >> 1));
                }
                break;
            case 4:  // Paeth
                for (int64_t x = 0; x < stride; x++) {
                    const int a = x >= bpp ? dst[x - bpp] : 0;
                    const int b = prev ? prev[x] : 0;
                    const int c = (prev && x >= bpp) ? prev[x - bpp] : 0;
                    const int p = a + b - c;
                    const int pa = std::abs(p - a);
                    const int pb = std::abs(p - b);
                    const int pc = std::abs(p - c);
                    const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                    dst[x] = static_cast<uint8_t>(src[x] + pred);
                }
                break;
            default:
                return -1;
        }
        prev = dst;
    }
    return 0;
}

// Encode-side adaptive filtering: picks the minimum-sum-of-abs filter per row
// (libpng's default heuristic) and writes (filter_byte || filtered_row)*rows.
void lp_png_filter(const uint8_t* in, uint8_t* out,
                   int64_t rows, int64_t stride, int32_t bpp) {
    uint8_t* tmp = static_cast<uint8_t*>(std::malloc(stride * 5));
    if (!tmp) {
        // allocation failure: emit filter-0 (None) rows — a valid,
        // merely larger PNG stream instead of a null deref
        for (int64_t y = 0; y < rows; y++) {
            out[y * (stride + 1)] = 0;
            std::memcpy(out + y * (stride + 1) + 1, in + y * stride,
                        static_cast<size_t>(stride));
        }
        return;
    }
    for (int64_t y = 0; y < rows; y++) {
        const uint8_t* src = in + y * stride;
        const uint8_t* prev = y > 0 ? in + (y - 1) * stride : nullptr;
        uint64_t best_sum = UINT64_MAX;
        int best = 0;
        for (int f = 0; f < 5; f++) {
            uint8_t* t = tmp + f * stride;
            uint64_t sum = 0;
            for (int64_t x = 0; x < stride; x++) {
                const int raw = src[x];
                const int a = x >= bpp ? src[x - bpp] : 0;
                const int b = prev ? prev[x] : 0;
                const int c = (prev && x >= bpp) ? prev[x - bpp] : 0;
                int v;
                switch (f) {
                    case 0: v = raw; break;
                    case 1: v = raw - a; break;
                    case 2: v = raw - b; break;
                    case 3: v = raw - ((a + b) >> 1); break;
                    default: {
                        const int p = a + b - c;
                        const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
                        v = raw - ((pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c));
                    }
                }
                const uint8_t u = static_cast<uint8_t>(v);
                t[x] = u;
                sum += u < 128 ? u : 256 - u;  // minimize |signed|
            }
            if (sum < best_sum) {
                best_sum = sum;
                best = f;
            }
        }
        uint8_t* dst = out + y * (stride + 1);
        dst[0] = static_cast<uint8_t>(best);
        std::memcpy(dst + 1, tmp + best * stride, stride);
    }
    std::free(tmp);
}

}  // extern "C"
