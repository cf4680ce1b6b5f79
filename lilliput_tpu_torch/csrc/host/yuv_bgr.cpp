// libyuv-exact 8-bit YUV -> BGR(A) conversion kernel for the own AVIF
// SDR decode path (codecs/yuv_rgb.py holds the bit-identical Python
// reference and the empirical derivation notes; the cross-check test
// enforces C++ == Python). This is the per-image serving host stage —
// the numpy form measured ~150 ms at 1080p from int32 temporaries, this
// single-pass row kernel ~10 ms (autovectorized at -O3).
//
// Kernel (derived empirically against PIL/libavif == libyuv):
//   y32 = (y * 0x0101 * YG) >> 16
//   B = clamp((y32 + UB*u - UB*128 + YGB) >> 6)
//   G = clamp((y32 - UG*u - VG*v + (UG+VG)*128 + YGB) >> 6)
//   R = clamp((y32 + VR*v - VR*128 + YGB) >> 6)
// Chroma upsampling: single-pass bilinear (9*self+3*h+3*v+diag+8)>>4
// with edge replication; odd-width LAST column horizontally unfiltered
// ((3*self+vert+2)>>2 for 4:2:0, raw sample for 4:2:2). 4:2:2 filters
// horizontally only. Monochrome uses u=v=128.

#include <algorithm>
#include <cstdint>
#include <cstring>

namespace {

inline uint8_t clamp8(int32_t v) {
    return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// Upsample one output row of 4:2:0 chroma into row[w] (int16).
// ci = chroma row for this output row, cn = vertical neighbor row
// (already clamped by the caller).
void up420_row(const uint8_t* c, int c_stride, int ci, int cn, int cw,
               int w, int16_t* row) {
    const uint8_t* s = c + static_cast<size_t>(ci) * c_stride;
    const uint8_t* t = c + static_cast<size_t>(cn) * c_stride;
    for (int j = 0; j < cw; j++) {
        const int jl = j > 0 ? j - 1 : 0;
        const int jr = j < cw - 1 ? j + 1 : cw - 1;
        const int c0 = s[j], L = s[jl], R = s[jr];
        const int T = t[j], TL = t[jl], TR = t[jr];
        const int x = 2 * j;
        if (x < w) row[x] = static_cast<int16_t>(
            (9 * c0 + 3 * L + 3 * T + TL + 8) >> 4);
        if (x + 1 < w) row[x + 1] = static_cast<int16_t>(
            (9 * c0 + 3 * R + 3 * T + TR + 8) >> 4);
    }
    if ((w & 1) && w == 2 * cw - 1) {
        // odd-width last column: horizontally unfiltered (measured)
        row[w - 1] = static_cast<int16_t>(
            (3 * s[cw - 1] + t[cw - 1] + 2) >> 2);
    }
}

// Upsample one output row of 4:2:2 chroma (full-height planes).
void up422_row(const uint8_t* c, int c_stride, int ci, int cw, int w,
               int16_t* row) {
    const uint8_t* s = c + static_cast<size_t>(ci) * c_stride;
    for (int j = 0; j < cw; j++) {
        const int jl = j > 0 ? j - 1 : 0;
        const int jr = j < cw - 1 ? j + 1 : cw - 1;
        const int x = 2 * j;
        if (x < w) row[x] = static_cast<int16_t>(
            (3 * s[j] + s[jl] + 2) >> 2);
        if (x + 1 < w) row[x + 1] = static_cast<int16_t>(
            (3 * s[j] + s[jr] + 2) >> 2);
    }
    if ((w & 1) && w == 2 * cw - 1) row[w - 1] = s[cw - 1];
}

}  // namespace

extern "C" {

// subsampling: 0 = 4:4:4, 1 = 4:2:2, 2 = 4:2:0, 3 = monochrome (u/v
// ignored), 4 = identity/GBR (y=G, u=B, v=R verbatim, full dims).
// out: w*h*out_ch bytes, out_ch 3 (BGR) or 4 (BGRA; alpha plane
// required). Returns 0 on success.
int lp_yuv_to_bgr(const uint8_t* y, int32_t y_stride, const uint8_t* u,
                  const uint8_t* v, int32_t c_stride, int32_t cw,
                  int32_t ch, int32_t subsampling, int32_t w, int32_t h,
                  int32_t ub, int32_t ug, int32_t vg, int32_t vr,
                  int32_t yg, int32_t ygb, const uint8_t* alpha,
                  int32_t a_stride, uint8_t* out, int32_t out_ch) {
    if (w <= 0 || h <= 0 || (out_ch != 3 && out_ch != 4)) return -1;
    if (out_ch == 4 && !alpha) return -2;
    if (subsampling == 4) {
        // identity/GBR needs full-resolution planes: subsampled chroma
        // here would read past the plane (caught by the ASan gate)
        if (!u || !v || cw < w || ch < h) return -3;
        for (int i = 0; i < h; i++) {
            const uint8_t* gy = y + static_cast<size_t>(i) * y_stride;
            const uint8_t* bu = u + static_cast<size_t>(i) * c_stride;
            const uint8_t* rv = v + static_cast<size_t>(i) * c_stride;
            uint8_t* o = out + static_cast<size_t>(i) * w * out_ch;
            for (int x = 0; x < w; x++) {
                o[out_ch * x + 0] = bu[x];
                o[out_ch * x + 1] = gy[x];
                o[out_ch * x + 2] = rv[x];
            }
            if (out_ch == 4) {
                const uint8_t* a = alpha + static_cast<size_t>(i) * a_stride;
                for (int x = 0; x < w; x++) o[4 * x + 3] = a[x];
            }
        }
        return 0;
    }
    const int32_t ygm = 0x0101 * yg;
    const int32_t bb = -ub * 128 + ygb;
    const int32_t bg = (ug + vg) * 128 + ygb;
    const int32_t br = -vr * 128 + ygb;
    int16_t* urow = nullptr;
    int16_t* vrow = nullptr;
    if (subsampling == 1 || subsampling == 2) {
        // chroma planes must cover the subsampled grid: undersized
        // dims would read past the plane (4:2:2 needs FULL height)
        if (!u || !v || cw < (w + 1) / 2 ||
            ch < (subsampling == 2 ? (h + 1) / 2 : h))
            return -3;
        urow = new (std::nothrow) int16_t[2 * static_cast<size_t>(w)];
        if (!urow) return -4;
        vrow = urow + w;
    } else if (subsampling == 0) {
        // 4:4:4 needs full-resolution planes, same as the identity path
        // (an undersized plane here walked rows past its end:
        // ASan-confirmed, fixed)
        if (!u || !v || cw < w || ch < h) return -3;
    }
    for (int i = 0; i < h; i++) {
        const uint8_t* yr = y + static_cast<size_t>(i) * y_stride;
        uint8_t* o = out + static_cast<size_t>(i) * w * out_ch;
        const int16_t* up = nullptr;
        const int16_t* vp = nullptr;
        const uint8_t* u8row = nullptr;
        const uint8_t* v8row = nullptr;
        if (subsampling == 2) {
            const int ci = std::min(i >> 1, ch - 1);
            const int cn = (i & 1) ? std::min(ci + 1, ch - 1)
                                   : std::max(ci - 1, 0);
            up420_row(u, c_stride, ci, cn, cw, w, urow);
            up420_row(v, c_stride, ci, cn, cw, w, vrow);
            up = urow;
            vp = vrow;
        } else if (subsampling == 1) {
            const int ci = std::min(i, ch - 1);
            up422_row(u, c_stride, ci, cw, w, urow);
            up422_row(v, c_stride, ci, cw, w, vrow);
            up = urow;
            vp = vrow;
        } else if (subsampling == 0) {
            u8row = u + static_cast<size_t>(i) * c_stride;
            v8row = v + static_cast<size_t>(i) * c_stride;
        }
        for (int x = 0; x < w; x++) {
            const int32_t y32 = (static_cast<int32_t>(yr[x]) * ygm) >> 16;
            const int32_t uu = up ? up[x] : (u8row ? u8row[x] : 128);
            const int32_t vv = vp ? vp[x] : (v8row ? v8row[x] : 128);
            o[out_ch * x + 0] = clamp8((y32 + ub * uu + bb) >> 6);
            o[out_ch * x + 1] = clamp8((y32 - ug * uu - vg * vv + bg) >> 6);
            o[out_ch * x + 2] = clamp8((y32 + vr * vv + br) >> 6);
        }
        if (out_ch == 4) {
            const uint8_t* a = alpha + static_cast<size_t>(i) * a_stride;
            for (int x = 0; x < w; x++) o[4 * x + 3] = a[x];
        }
    }
    delete[] urow;
    return 0;
}

}  // extern "C"
