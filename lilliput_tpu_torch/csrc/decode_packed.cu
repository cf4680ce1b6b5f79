// 4:2:2 JPEG decode kernel for Hopper (sm_90a): int16 DCT coefficients ->
// three raster u8 planes (B, G, R) or packed BGRA int32.
//
// Replaces the Pallas TPU kernel decode422_packed of
// lilliput_tpu/ops/pallas_kernels.py (pl.pallas_call at :563). 4:2:0 is
// decode420.cu's kernel, 4:4:0 decode440.cu's and 4:4:4 decode444.cu's.
// Same arithmetic as those kernels and the split path, per output pixel:
//
//   luma   Y = sum_k f32(coef[k]) * Wqy[k][x*8+y] + 128       (W_q folds the
//   chroma C = sum_k f32(coef[k]) * Wqc[k][x*8+y] + 128        dequant table)
//   horizontal only: u = fma(3, C, C[col-/+1]) * 0.25 (even/odd col),
//   edges replicated at the window's chroma plane edges (cols 0 and
//   8*cbw-1)
//   R = fma(1.402, Cr', Y), G = fma(-0.714136286, Cr', fma(-0.344136286,
//   Cb', Y)), B = fma(1.772, Cb', Y)  with C' = u - 128;
//   then clip(rint(v), 0, 255).
//
// Numerics as in decode420.cu: the fusions XLA makes on the CPU are written
// out (__fmaf_rn), every other step is __fmul_rn/__fadd_rn/__fsub_rn, the
// rounding is rintf, and there is no --use_fast_math. The 64-term IDCT sums
// run in k order with fmaf, so a u8 value may differ by 1 from the plain
// version where a sum lands next to a .5 tie.
//
// Not carried over from the TPU kernel: the pair-packing of two blocks into
// 128 lanes, the even-width pad, the _tile_rows row padding, the selection
// matmuls and the 72/56 lane rolls. The kernel indexes pixels directly and
// masks the ragged right edge (70 chroma blocks are no multiple of a tile).
//
// Bound on an H100 SXM (data sheet figures, not measurements) at the
// serving window, B=128: 1.08 GB of coefficients + planes (~0.32 ms at
// 3.35 TB/s), 39.6 GFLOP of IDCT (~0.59 ms at 67 TFLOP/s f32 non-tensor).
// f32 FMA work bounds it. The design keeps the IDCT on the FMA pipe with
// few loads per FMA:
//   * one thread block per (image, chroma block row, tile of 32 luma
//     blocks, i.e. 16 chroma block columns);
//   * the image's two 64x64 W_q matrices, the tile's coefficients (as f32,
//     block stride 65 so broadcast reads of two blocks never share a bank)
//     and the decoded chroma tile live in shared memory (59,664 bytes);
//   * the IDCT runs as small register-tiled matrix products: each thread
//     owns 2 blocks x 4 pixels, so one k step is one float4 W load, two
//     broadcast coefficient loads and 8 FMAs;
//   * the chroma tile carries one block of halo on each side, so the
//     triangle taps read their neighbours from shared memory; luma stays in
//     registers through the colour conversion, and each thread stores 4
//     adjacent pixels.
// Later work: decode420.cu's k-major 4 blocks x 8 pixels IDCT tile, and a
// tensor-core IDCT.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kStride = 65;                   // f32 per staged block
constexpr int kLumaBlocks = 32;               // luma blocks per thread block
constexpr int kTileC = kLumaBlocks / 2;       // chroma cols
constexpr int kChromaCols = kTileC + 2;       // + one block of halo each side
constexpr int kChromaBlocks = 2 * kChromaCols;   // 1 row, 2 planes
constexpr int kTileH = 8;                     // tile rows (px)
constexpr int kTileW = 8 * kChromaCols;       // tile cols (px)
constexpr size_t kSmemBytes =
    sizeof(float) * (2 * 4096 + kLumaBlocks * kStride +
                     kChromaBlocks * kStride + 2 * kTileH * kTileW);
static_assert(kChromaCols % 2 == 0, "chroma IDCT runs on block pairs");

// One register tile of the IDCT product: blocks a0/a1 (staged f32
// coefficients) against pixel columns 4g..4g+3 of W. acc[j][i] is pixel
// 4g+i of block j, summed in k order with fmaf from 0, then +128.
__device__ __forceinline__ void idct_tile(const float* __restrict__ a0,
                                          const float* __restrict__ a1,
                                          const float* __restrict__ w, int g,
                                          float acc[2][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[0][i] = acc[1][i] = 0.f;
    const float4* wv = reinterpret_cast<const float4*>(w) + g;
#pragma unroll 8
    for (int k = 0; k < 64; ++k) {
        const float4 wk = wv[k * 16];
        const float c0 = a0[k], c1 = a1[k];
        acc[0][0] = fmaf(c0, wk.x, acc[0][0]);
        acc[0][1] = fmaf(c0, wk.y, acc[0][1]);
        acc[0][2] = fmaf(c0, wk.z, acc[0][2]);
        acc[0][3] = fmaf(c0, wk.w, acc[0][3]);
        acc[1][0] = fmaf(c1, wk.x, acc[1][0]);
        acc[1][1] = fmaf(c1, wk.y, acc[1][1]);
        acc[1][2] = fmaf(c1, wk.z, acc[1][2]);
        acc[1][3] = fmaf(c1, wk.w, acc[1][3]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        acc[0][i] = __fadd_rn(acc[0][i], 128.f);
        acc[1][i] = __fadd_rn(acc[1][i], 128.f);
    }
}

// Stage one block's 64 int16 coefficients as f32 (8 per thread step).
__device__ __forceinline__ void stage(const int16_t* __restrict__ src,
                                      float* __restrict__ dst, int part) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(src) + part);
    const int16_t* s = reinterpret_cast<const int16_t*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[part * 8 + i] = static_cast<float>(s[i]);
}

// libjpeg "fancy" triangle tap: (3*c + n) * 0.25, with 3*c + n fused
__device__ __forceinline__ float tri(float c, float n) {
    return __fmul_rn(__fmaf_rn(3.f, c, n), 0.25f);
}

__device__ __forceinline__ uint32_t to_u8(float v) {
    return static_cast<uint32_t>(fminf(fmaxf(rintf(v), 0.f), 255.f));
}

// Luma (B, cbh, 2*cbw, 64), chroma (B, cbh, cbw, 64); output planes or
// packed pixels (B, 8*cbh, 16*cbw).
template <bool kPacked>
__global__ void __launch_bounds__(kThreads)
decode422_kernel(const int16_t* __restrict__ yc,
                 const int16_t* __restrict__ cb,
                 const int16_t* __restrict__ cr,
                 const float* __restrict__ wqy,
                 const float* __restrict__ wqc, uint8_t* __restrict__ ob,
                 uint8_t* __restrict__ og, uint8_t* __restrict__ orr,
                 int32_t* __restrict__ opk, int cbh, int cbw) {
    extern __shared__ __align__(16) float smem[];
    float* wy = smem;                                // [64][64]
    float* wc = wy + 4096;                           // [64][64]
    float* lco = wc + 4096;                          // [32][kStride]
    float* cco = lco + kLumaBlocks * kStride;        // [kChromaBlocks][..]
    float* tile = cco + kChromaBlocks * kStride;     // [2][kTileH][kTileW]

    const int b = blockIdx.z;
    const int row = blockIdx.y;                 // chroma block row
    const int c0 = blockIdx.x * kTileC;         // first chroma block col
    const int tid = threadIdx.x;
    const int lbw = 2 * cbw;                    // luma blocks per row
    const int lx0 = 2 * c0;                     // first luma block col

    // 1. stage this image's W_q matrices and the tile's coefficients
    {
        const float4* wy4 = reinterpret_cast<const float4*>(wqy + size_t(b) * 4096);
        const float4* wc4 = reinterpret_cast<const float4*>(wqc + size_t(b) * 4096);
        for (int i = tid; i < 1024; i += kThreads) {
            reinterpret_cast<float4*>(wy)[i] = __ldg(wy4 + i);
            reinterpret_cast<float4*>(wc)[i] = __ldg(wc4 + i);
        }
        // luma: row `row` x kLumaBlocks block cols, 8 parts of 8 coefs
        for (int i = tid; i < kLumaBlocks * 8; i += kThreads) {
            const int blk = i >> 3, part = i & 7;
            const int bx = lx0 + blk;
            if (bx < lbw)
                stage(yc + ((size_t(b) * cbh + row) * lbw + bx) * 64,
                      lco + blk * kStride, part);
        }
        // chroma: planes x row `row` x cols c0-1..c0+kTileC
        for (int i = tid; i < kChromaBlocks * 8; i += kThreads) {
            const int blk = i >> 3, part = i & 7;
            const int p = blk / kChromaCols, c = blk % kChromaCols;
            const int bx = c0 - 1 + c;
            if (bx >= 0 && bx < cbw)
                stage((p ? cr : cb) + ((size_t(b) * cbh + row) * cbw + bx) * 64,
                      cco + blk * kStride, part);
        }
    }
    __syncthreads();

    const int g = tid & 15;          // pixel group: row g/2, cols 4(g%2)..+3
    const int px = g >> 1, py = 4 * (g & 1);

    // 2. chroma IDCT into the tile (block pairs along a tile row); pairs
    //    wholly past the plane's right edge are never read, so skipped
    for (int q = tid >> 4; q < kChromaBlocks / 2; q += kThreads / 16) {
        const int blk = 2 * q;       // even: both blocks share the plane
        const int p = blk / kChromaCols, c = blk % kChromaCols;
        if (c0 - 1 + c >= cbw) continue;
        float acc[2][4];
        idct_tile(cco + blk * kStride, cco + (blk + 1) * kStride, wc, g, acc);
        float* dst = tile + (p * kTileH + px) * kTileW + 8 * c + py;
        reinterpret_cast<float4*>(dst)[0] =
            make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
        reinterpret_cast<float4*>(dst + 8)[0] =
            make_float4(acc[1][0], acc[1][1], acc[1][2], acc[1][3]);
    }

    // 3. luma IDCT, kept in registers (block pair = 2 adjacent luma blocks)
    const int lx = 2 * (tid >> 4);               // first luma block col
    const bool live = lx0 + lx < lbw;            // at least the first block
    float ya[2][4];
    if (live)
        idct_tile(lco + lx * kStride, lco + (lx + 1) * kStride, wy, g, ya);
    __syncthreads();
    if (!live) return;

    // 4. upsample from the tile, colour, store 4 pixels per block
    const int cw = 8 * cbw;
    const int gy = 8 * row + px;
    const int oh = 8 * cbh, ow = 16 * cbw;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        if (lx0 + lx + j >= lbw) break;          // ragged right edge
        uint32_t bq = 0, gq = 0, rq = 0;
        int32_t pk[4];
        const int ox0 = 8 * (lx + j) + py;       // output col in the tile
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int ox = ox0 + i;
            const int cx = 8 * c0 + (ox >> 1);   // chroma col
            const int cxn = min(max(cx + ((ox & 1) ? 1 : -1), 0), cw - 1);
            const int tx = cx - 8 * (c0 - 1), txn = cxn - 8 * (c0 - 1);
            float cc[2];
#pragma unroll
            for (int p = 0; p < 2; ++p) {
                const float* t = tile + p * kTileH * kTileW;
                cc[p] = __fsub_rn(tri(t[px * kTileW + tx],
                                      t[px * kTileW + txn]), 128.f);
            }
            const float y = ya[j][i];
            const uint32_t rr = to_u8(__fmaf_rn(1.402f, cc[1], y));
            const uint32_t gg = to_u8(__fmaf_rn(
                -0.714136286f, cc[1], __fmaf_rn(-0.344136286f, cc[0], y)));
            const uint32_t bb = to_u8(__fmaf_rn(1.772f, cc[0], y));
            if (kPacked) {
                pk[i] = static_cast<int32_t>(bb | (gg << 8) | (rr << 16) |
                                             0xFF000000u);
            } else {
                bq |= bb << (8 * i);
                gq |= gg << (8 * i);
                rq |= rr << (8 * i);
            }
        }
        const size_t o = (size_t(b) * oh + gy) * ow + 8 * lx0 + ox0;
        if (kPacked) {
            reinterpret_cast<int4*>(opk + o)[0] =
                make_int4(pk[0], pk[1], pk[2], pk[3]);
        } else {
            reinterpret_cast<uint32_t*>(ob + o)[0] = bq;
            reinterpret_cast<uint32_t*>(og + o)[0] = gq;
            reinterpret_cast<uint32_t*>(orr + o)[0] = rq;
        }
    }
}

template <bool kPacked>
cudaError_t launch(const dim3& grid, cudaStream_t s, const int16_t* y,
                   const int16_t* u, const int16_t* v, const float* wy,
                   const float* wc, uint8_t* o0, uint8_t* o1, uint8_t* o2,
                   int32_t* pk, int cbh, int cbw) {
    // above 48 KB, dynamic shared memory must be asked for per kernel
    cudaError_t e = cudaFuncSetAttribute(
        decode422_kernel<kPacked>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(kSmemBytes));
    if (e != cudaSuccess) return e;
    decode422_kernel<kPacked><<<grid, kThreads, kSmemBytes, s>>>(
        y, u, v, wy, wc, o0, o1, o2, pk, cbh, cbw);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// yc (B, cbh, 2*cbw, 64) int16, cb/cr (B, cbh, cbw, 64) int16, wqy/wqc
// (B, 64, 64) f32, all contiguous on the device. packed=0: o0/o1/o2 are
// the B/G/R u8 planes (B, 8*cbh, 16*cbw); packed=1: o0 is int32 BGRA of
// that shape. Launches on `stream` and returns the launch's cudaError_t.
int lpt_decode422(const void* yc, const void* cb, const void* cr,
                  const void* wqy, const void* wqc, void* o0, void* o1,
                  void* o2, int packed, int batch, int cbh, int cbw,
                  void* stream) {
    if (batch <= 0 || cbh <= 0 || cbw <= 0 || batch > 65535 || cbh > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((cbw + kTileC - 1) / kTileC, cbh, batch);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto* y = static_cast<const int16_t*>(yc);
    const auto* u = static_cast<const int16_t*>(cb);
    const auto* v = static_cast<const int16_t*>(cr);
    const auto* wy = static_cast<const float*>(wqy);
    const auto* wc = static_cast<const float*>(wqc);
    const cudaError_t e =
        packed ? launch<true>(grid, s, y, u, v, wy, wc, nullptr, nullptr,
                              nullptr, static_cast<int32_t*>(o0), cbh, cbw)
               : launch<false>(grid, s, y, u, v, wy, wc,
                               static_cast<uint8_t*>(o0),
                               static_cast<uint8_t*>(o1),
                               static_cast<uint8_t*>(o2), nullptr, cbh, cbw);
    return static_cast<int>(e);
}

const char* lpt_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
