// 4:2:2 JPEG decode kernel for Hopper (sm_90a): int16 DCT coefficients ->
// three raster u8 planes (B, G, R) or packed BGRA int32.
//
// Replaces lilliput_tpu/ops/pallas_kernels.py decode422_packed (the Pallas
// TPU megakernel, with its _dec422_kernel_factory body). Same arithmetic,
// per output pixel:
//
//   luma   Y = sum_k f32(coef[k]) * Wqy[k][x*8+y] + 128       (W_q folds the
//   chroma C = sum_k f32(coef[k]) * Wqc[k][x*8+y] + 128        dequant table)
//   horizontal only: u = fma(3, C, C[col-/+1]) * 0.25 (even/odd output col),
//   edges replicated at the window's chroma plane edges (cols 0 and
//   8*cbw-1)
//   R = fma(1.402, Cr', Y), G = fma(-0.714136286, Cr', fma(-0.344136286,
//   Cb', Y)), B = fma(1.772, Cb', Y)  with C' = u - 128;
//   then clip(rint(v), 0, 255).
//
// Chroma keeps its level shift (unlike 4:4:4): the triangle tap sits
// between the + 128 and the - 128, so XLA cannot fold them.
//
// Numerics as in decode420.cu: the fusions XLA makes on the CPU are written
// out (__fmaf_rn), every other step is __fmul_rn/__fadd_rn/__fsub_rn, the
// rounding is rintf, and there is no --use_fast_math. The 64-term IDCT sums
// run in k order with fmaf, so a u8 value may differ by 1 from the plain
// version where a sum lands next to a .5 tie.
//
// Replaces pallas_kernels.py:544 (`pl.pallas_call` at :563).
//
// Bound on an H100 SXM (data-sheet peaks: 3.35 TB/s, 67 TFLOP/s f32 without
// tensor cores), at the serving window, B = 128 (luma 135x140 blocks, chroma
// 2 x 135x70), every input read once and every output written once, against
// 2*64*64 FLOP per 8x8 block IDCT (chip_smoke.bound): 1.08 GB of
// coefficients and planes -> 0.32 ms of bytes, 39.6 GFLOP -> 0.592 ms of
// operations. f32 FMA issue bounds it.
//
// The design is decode420.cu's strip and halo without the vertical ring
// (4:2:2 has no vertical neighbour), with decode444.cu's cp.async staging:
//   * One thread block per (image, strip of 14 MCUs, band of 17 MCU rows)
//     stages both W_q once and walks its band one MCU row at a time. At the
//     serving window (cbw = 70, exactly 5 strips) the grid is 5 x 8 x 128 =
//     5,120 blocks, 12.9 waves of 3 blocks on each of 132 SMs.
//   * An MCU row is one job of 64 block slots: 28 luma blocks (groups 0..6),
//     one idle group (7), and per plane the strip's 14 chroma blocks plus one
//     halo block on each side (groups 8..15). Each chroma block is decoded
//     once per strip, plus the two halo blocks: 60 real IDCTs per 56 owned,
//     64 slots issued. A halo block outside the plane is never read: the
//     clamped neighbour index already points inside it.
//   * The IDCT is fed by few shared-memory loads per FMA: coefficients are
//     staged as f32 in k-major order (cf_index), W_q with the halves of rows
//     4..7 swapped; thread (g, rho) owns pixel row rho of the 4 blocks of
//     group g, so one k step is two float4 W loads, one float4 coefficient
//     load and 32 FMAs: 3 shared-memory wavefronts per 32 warp-FMAs.
//   * While a row computes, the next row's int16 coefficients land in a raw
//     staging area by cp.async (no registers held); after the row's second
//     barrier each thread converts its own copies into the f32 slot.
//   * The chroma groups write their pixel row to a tile of 2 planes x 8 px
//     rows x (16 * 8 + 4) f32 (the + 4 puts rows 4 banks apart). Luma stays
//     in registers; after the barrier the 56 luma threads read the 18 chroma
//     columns they need per plane (4 float4 and 2 clamped neighbours), run
//     the tap and the colour FMAs and store 32 adjacent pixels per plane.
// 128 threads, kSmemBytes = 65,792 bytes of dynamic shared memory (both W_q,
// one coefficient slot, 8 KB of raw staging, the chroma tile): 3 blocks per
// SM (3 x (65,792 + 1,024 reserved) = 200,448 of 233,472 bytes;
// __launch_bounds__ caps registers at 168, 3 x 128 x 168 of 65,536; ptxas,
// sm_90a: 167 registers planes, 121 packed, no spills, with the k steps
// fully unrolled). Every output value comes from one fixed operation
// sequence (fmaf in k order from 0, + 128, the tap, - 128, the colour FMAs,
// rintf and the clip), so the result does not depend on the tiling.
//
// Times at the serving window, B = 128, on "NVIDIA H100 80GB HBM3, 700.00 W"
// (tools/torch_kernel_variants.py, CUDA events): planes 1.511-1.529 ms,
// packed 1.591-1.609 ms; 45.3 GFLOP issued at 29.8 TFLOP/s, 44% of the f32
// peak. k steps unrolled by 4 took 1.578-1.592 ms, bands of 9 and 34 MCU
// rows 1.539 and 1.563 ms.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kStripMcus = 14;                // MCUs (16x8 px) per strip
constexpr int kBandRows = 17;                 // MCU rows per band
constexpr int kThreads = 128;                 // 16 groups x 8 pixel rows
constexpr int kLumaBlocks = 2 * kStripMcus;   // 28: groups 0..6
constexpr int kLumaGroups = kLumaBlocks / 4;
constexpr int kChromaBase = 32;               // first chroma slot: group 8
constexpr int kChromaCols = kStripMcus + 2;   // strip + halo block each side
constexpr int kJobBlocks = kChromaBase + 2 * kChromaCols;   // 64
constexpr int kLoads = kJobBlocks * 8 / kThreads;           // int4 per thread
constexpr int kTileH = 8;                     // tile rows (px)
constexpr int kTileW = kChromaCols * 8 + 4;   // + 4: rows 4 banks apart
constexpr size_t kSmemBytes =
    (3 * 4096 + 2 * kTileH * kTileW) * sizeof(float) +
    kLoads * kThreads * sizeof(int4);
static_assert(kJobBlocks == 64 && kLoads == 4,
              "a job is 16 groups of 4 blocks, 8 loads per block");
static_assert(kLumaBlocks % 4 == 0 && kLumaBlocks <= kChromaBase &&
                  kChromaCols % 4 == 0,
              "no group mixes luma, chroma planes or idle slots");
static_assert(kSmemBytes == 65792, "3 blocks per SM");

// Coefficient staging: (k, block) of a job of 64 blocks at
// cf[k * 64 + 4 * ((block >> 2) ^ (k >> 3)) + (block & 3)]: k-major, so one
// float4 is one k of a group of 4 blocks; the xor spreads the transposing
// stores of one warp over all 32 banks.
__device__ __forceinline__ int cf_index(int k, int blk) {
    return k * 64 + 4 * ((blk >> 2) ^ (k >> 3)) + (blk & 3);
}

// IDCT of 4 blocks (group g of the staged job) at pixel row rho: acc[j][x]
// is pixel (rho, x) of block 4g+j, summed in k order with fmaf from 0, then
// +128. W is staged with the halves of rows 4..7 swapped (stage_w), so the
// warp's two float4 W loads each cover all 32 banks once; the coefficient
// load is one float4 of 4 consecutive groups: 3 wavefronts per 32 FMAs.
__device__ __forceinline__ void idct_rows(const float* __restrict__ cf,
                                          const float* __restrict__ w, int g,
                                          int rho, float acc[4][8]) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int x = 0; x < 8; ++x) acc[j][x] = 0.f;
    const float4* wv = reinterpret_cast<const float4*>(w) + 2 * rho;
    const int s = rho >> 2;
#pragma unroll 1
    for (int kk = 0; kk < 8; ++kk) {
        const float4* cv = reinterpret_cast<const float4*>(cf) + kk * 128 +
                           (g ^ kk);
        const float4* wk = wv + kk * 128;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
            const float4 wa = wk[u * 16 + s], wb = wk[u * 16 + (s ^ 1)];
            const float4 c4 = cv[u * 16];
            const float wr[8] = {wa.x, wa.y, wa.z, wa.w,
                                 wb.x, wb.y, wb.z, wb.w};
            const float c[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int x = 0; x < 8; ++x)
                    acc[j][x] = fmaf(c[j], wr[x], acc[j][x]);
        }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int x = 0; x < 8; ++x) acc[j][x] = __fadd_rn(acc[j][x], 128.f);
}

// Copy a 64x64 W_q into shared memory, the float4 halves of rows 4..7 of
// each k swapped (see idct_rows).
__device__ __forceinline__ void stage_w(const float* __restrict__ src,
                                        float* __restrict__ dst, int tid) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = tid; i < 1024; i += kThreads) {
        const int k = i >> 4, rho = (i >> 1) & 7, h = i & 1;
        d4[k * 16 + 2 * rho + (h ^ (rho >> 2))] = __ldg(s4 + i);
    }
}

// 16 bytes global -> shared without passing through registers; bytes = 0
// reads nothing and fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(int4* dst, const void* src,
                                           int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     static_cast<unsigned>(__cvta_generic_to_shared(dst))),
                 "l"(src), "r"(bytes)
                 : "memory");
}

// The 64 blocks of MCU row `row`'s job, 8 int4 (8 coefficients each) per
// block: thread t copies part t % 8 of block t / 8 + 16m to
// raw[m * kThreads + t]. Blocks 0..27 are luma (col 2c0 + blk), 28..31 idle,
// 32 + 16p + c chroma plane p, col c0 - 1 + c. Idle blocks and blocks
// outside the planes are zeros. The copies land while the block computes,
// and hold no registers meanwhile.
struct Loader {
    const int16_t* yc;
    const int16_t* cb;
    const int16_t* cr;
    int b, cbh, cbw, c0;

    __device__ __forceinline__ const int16_t* src(int blk, int row) const {
        if (blk < kLumaBlocks) {
            const int lbw = 2 * cbw, bx = 2 * c0 + blk;
            return bx < lbw ? yc + ((size_t(b) * cbh + row) * lbw + bx) * 64
                            : nullptr;
        }
        if (blk < kChromaBase) return nullptr;
        const int p = (blk - kChromaBase) / kChromaCols;
        const int bx = c0 - 1 + (blk - kChromaBase) % kChromaCols;
        if (bx < 0 || bx >= cbw) return nullptr;
        return (p ? cr : cb) + ((size_t(b) * cbh + row) * cbw + bx) * 64;
    }
    __device__ __forceinline__ void issue(int4* raw, int row,
                                          int tid) const {
#pragma unroll
        for (int m = 0; m < kLoads; ++m) {
            const int16_t* s = src((tid >> 3) + 16 * m, row);
            cp_async16(raw + m * kThreads + tid, s ? s + 8 * (tid & 7) : yc,
                       s ? 16 : 0);
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
};

// Wait for this thread's copies (no other thread reads them, so no barrier)
// and convert them to f32 into the k-major staging slot.
__device__ __forceinline__ void store_job(const int4* raw,
                                          float* __restrict__ cf, int tid) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    const int part = tid & 7;
#pragma unroll
    for (int m = 0; m < kLoads; ++m) {
        const int4 v = raw[m * kThreads + tid];
        const int blk = (tid >> 3) + 16 * m;
        const int16_t* s = reinterpret_cast<const int16_t*>(&v);
#pragma unroll
        for (int e = 0; e < 8; ++e)
            cf[cf_index(8 * part + e, blk)] = static_cast<float>(s[e]);
    }
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
__global__ void __launch_bounds__(kThreads, 3)
decode422_kernel(const int16_t* __restrict__ yc,
                 const int16_t* __restrict__ cb,
                 const int16_t* __restrict__ cr,
                 const float* __restrict__ wqy,
                 const float* __restrict__ wqc,
                 uint8_t* __restrict__ ob, uint8_t* __restrict__ og,
                 uint8_t* __restrict__ orr, int32_t* __restrict__ opk,
                 int cbh, int cbw) {
    extern __shared__ __align__(16) float smem[];
    float* wy = smem;                                // [64][64], swizzled
    float* wc = wy + 4096;                           // [64][64], swizzled
    float* cf = wc + 4096;                           // [64 k][64 blocks]
    float* tile = cf + 4096;                         // [2][kTileH][kTileW]
    int4* raw = reinterpret_cast<int4*>(tile + 2 * kTileH * kTileW);

    const int b = blockIdx.z;
    const int r0 = blockIdx.y * kBandRows;      // first MCU row of the band
    const int r1 = min(r0 + kBandRows, cbh);
    const int c0 = blockIdx.x * kStripMcus;     // first chroma block col
    const int tid = threadIdx.x;
    const int g = tid >> 3, rho = tid & 7;      // block group, pixel row
    const bool luma = g < kLumaGroups;
    const bool chroma = g >= kChromaBase / 4;
    // luma: blocks of g in the plane (2 or 4 where any, as 2*cbw is even);
    // chroma: plane and first tile block col of g
    const int nb = min(4, 2 * cbw - (2 * c0 + 4 * g));
    const int cp = (g - kChromaBase / 4) / (kChromaCols / 4);
    const int tb = 4 * ((g - kChromaBase / 4) % (kChromaCols / 4));
    const bool live = luma ? nb > 0 : chroma && c0 - 1 + tb < cbw;
    const Loader ld{yc, cb, cr, b, cbh, cbw, c0};
    float acc[4][8];

    // 1. stage this image's W_q matrices once for the band, and the band's
    //    first row into the slot
    ld.issue(raw, r0, tid);
    stage_w(wqy + size_t(b) * 4096, wy, tid);
    stage_w(wqc + size_t(b) * 4096, wc, tid);
    store_job(raw, cf, tid);

    // luma epilogue: chroma cols x0-1..x0+16 (tile cols tl, tc..tc+15, tr),
    // the neighbours clamped to the plane
    const int cw = 8 * cbw;
    const int x0 = 8 * c0 + 16 * g;
    const int tc = x0 - 8 * (c0 - 1);
    const int tl = max(x0 - 1, 0) - 8 * (c0 - 1);
    const int tr = min(x0 + 16, cw - 1) - 8 * (c0 - 1);
    const int oh = 8 * cbh, ow = 16 * cbw;

    // 2. walk the band: MCU row `row` decodes its luma (kept in registers)
    //    and its chroma with the halo (into the tile) while the next row's
    //    coefficients land, then upsamples, colours and stores
    for (int row = r0; row < r1; ++row) {
        __syncthreads();             // cf staged; the tile's reads done
        const bool next = row + 1 < r1;
        if (next) ld.issue(raw, row + 1, tid);
        if (live) idct_rows(cf, luma ? wy : wc, g, rho, acc);
        if (chroma && live) {
            float* dst = tile + (cp * kTileH + rho) * kTileW + 8 * tb;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                reinterpret_cast<float4*>(dst + 8 * j)[0] =
                    make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
                reinterpret_cast<float4*>(dst + 8 * j)[1] =
                    make_float4(acc[j][4], acc[j][5], acc[j][6], acc[j][7]);
            }
        }
        __syncthreads();             // tile written; cf read
        if (luma && live) {
            // c[p][1 + i] is chroma col x0 + i of plane p, i = -1..16
            float c[2][18];
#pragma unroll
            for (int p = 0; p < 2; ++p) {
                const float* t = tile + (p * kTileH + rho) * kTileW;
                c[p][0] = t[tl];
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const float4 v = reinterpret_cast<const float4*>(t + tc)[q];
                    c[p][1 + 4 * q] = v.x;
                    c[p][2 + 4 * q] = v.y;
                    c[p][3 + 4 * q] = v.z;
                    c[p][4 + 4 * q] = v.w;
                }
                c[p][17] = t[tr];
                // the plane ends at col x0 + 7: its right neighbour is itself
                if (nb == 2) c[p][9] = c[p][8];
            }
            const size_t o = (size_t(b) * oh + 8 * row + rho) * ow + 2 * x0;
            uint32_t q[3][8];                   // b, g, r bytes of 32 px
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                int32_t pk[8];
#pragma unroll
                for (int x = 0; x < 8; ++x) {
                    const int m = 4 * j + (x >> 1);    // chroma col - x0
                    float cc[2];
#pragma unroll
                    for (int p = 0; p < 2; ++p)
                        cc[p] = __fsub_rn(
                            tri(c[p][1 + m], c[p][(x & 1) ? 2 + m : m]),
                            128.f);
                    const float y = acc[j][x];
                    const uint32_t rr = to_u8(__fmaf_rn(1.402f, cc[1], y));
                    const uint32_t gg = to_u8(__fmaf_rn(
                        -0.714136286f, cc[1],
                        __fmaf_rn(-0.344136286f, cc[0], y)));
                    const uint32_t bb = to_u8(__fmaf_rn(1.772f, cc[0], y));
                    if (kPacked) {
                        pk[x] = static_cast<int32_t>(bb | (gg << 8) |
                                                     (rr << 16) |
                                                     0xFF000000u);
                    } else {
                        const int wd = 2 * j + (x >> 2), sh = 8 * (x & 3);
                        if ((x & 3) == 0) q[0][wd] = q[1][wd] = q[2][wd] = 0;
                        q[0][wd] |= bb << sh;
                        q[1][wd] |= gg << sh;
                        q[2][wd] |= rr << sh;
                    }
                }
                if (kPacked && j < nb) {
                    int4* d = reinterpret_cast<int4*>(opk + o + 8 * j);
                    d[0] = make_int4(pk[0], pk[1], pk[2], pk[3]);
                    d[1] = make_int4(pk[4], pk[5], pk[6], pk[7]);
                }
            }
            if (!kPacked) {
                // rows are 16*cbw bytes and x0 is even: 16-byte aligned
                uint8_t* planes[3] = {ob, og, orr};
#pragma unroll
                for (int p = 0; p < 3; ++p) {
                    uint4* d = reinterpret_cast<uint4*>(planes[p] + o);
                    d[0] = make_uint4(q[p][0], q[p][1], q[p][2], q[p][3]);
                    if (nb == 4)
                        d[1] = make_uint4(q[p][4], q[p][5], q[p][6], q[p][7]);
                }
            }
        }
        if (next) store_job(raw, cf, tid);
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
    const dim3 grid((cbw + kStripMcus - 1) / kStripMcus,
                    (cbh + kBandRows - 1) / kBandRows, batch);
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
