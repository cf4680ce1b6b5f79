// 4:4:0 JPEG decode kernel for Hopper (sm_90a): int16 DCT coefficients ->
// three raster u8 planes (B, G, R) or packed BGRA int32.
//
// Replaces lilliput_tpu/ops/pallas_kernels.py decode440_packed (the Pallas
// TPU megakernel, with its _dec440_kernel_factory body). Same arithmetic,
// per output pixel:
//
//   luma   Y = sum_k f32(coef[k]) * Wqy[k][x*8+y] + 128       (W_q folds the
//   chroma C = sum_k f32(coef[k]) * Wqc[k][x*8+y] + 128        dequant table)
//   vertical only: u = fma(3, C, C[row-/+1]) * 0.25  (even/odd output row),
//   edges replicated at the window's chroma plane edge (rows 0 and 8*cbh-1)
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
// Replaces pallas_kernels.py:670 (`pl.pallas_call` at :713).
//
// Bound on an H100 SXM (data-sheet peaks: 3.35 TB/s, 67 TFLOP/s f32 without
// tensor cores), at the serving window, B = 128 (luma 136x138 blocks, chroma
// 68x138), every input read once and every output written once, against
// 2*64*64 FLOP per 8x8 block IDCT (chip_smoke.bound): 1.07 GB -> 0.32 ms of
// bytes, 39.4 GFLOP -> 0.587 ms of operations. f32 FMA issue bounds it.
//
// The design is decode420.cu's, without the horizontal halo:
//   * Each chroma block is decoded once. One thread block per (image, strip
//     of 16 MCUs, band of 17 MCU rows) stages both W_q once and walks its
//     band's MCU rows top to bottom. A 3-slot ring holds the decoded chroma
//     block rows row-1, row, row+1 (2 planes x 24 px rows x 128 px cols);
//     each step decodes the 32 luma blocks of MCU row `row` (block rows
//     2row and 2row+1) and the 32 chroma blocks of block row row+1 (16 per
//     plane) as one job of 64 blocks, then upsamples MCU row `row` from the
//     ring. Rows outside the plane are never decoded: the clamped neighbour
//     index already points inside it. Per band: 64 block IDCTs per step for
//     64 owned, plus chroma rows r0-1 and r0 once.
//   * The IDCT is fed by few shared-memory loads per FMA: coefficients are
//     staged as f32 in k-major order (cf_index), W_q with the halves of
//     rows 4..7 swapped; each thread owns 4 blocks x 8 pixels (one pixel
//     row), so one k step is two float4 W loads, one float4 coefficient
//     load and 32 FMAs: 3 shared-memory wavefronts per 32 warp-FMAs.
//   * The next step's coefficients load into registers while this step
//     computes; luma stays in registers through the barrier into the
//     colour conversion, and each of the 64 luma threads stores 32
//     adjacent pixels. The chroma threads wait out the epilogue at the
//     next barrier.
// 128 threads, kSmemBytes = 74,496 bytes of dynamic shared memory:
// 3 blocks per SM (3 x (74,496 + 1,024 reserved) = 226,560 of 233,472
// bytes; __launch_bounds__ caps registers at 168). Every output value comes
// from one fixed operation sequence (fmaf in k order from 0, + 128, tri,
// - 128, the colour FMAs, rintf and the clip), so the result does not
// depend on the tiling.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kStripMcus = 16;                // MCUs (8x16 px) per strip
constexpr int kBandRows = 17;                 // MCU rows per band
constexpr int kThreads = 128;                 // 16 groups x 8 pixel rows
constexpr int kLumaBlocks = 2 * kStripMcus;   // 2 rows x 16 cols
constexpr int kChromaCols = kStripMcus;       // no horizontal halo
constexpr int kJobBlocks = kLumaBlocks + 2 * kChromaCols;  // 64
constexpr int kLumaGroups = kLumaBlocks / 4;  // groups of 4 blocks
constexpr int kLoads = kJobBlocks * 8 / kThreads;   // int4 per thread
constexpr int kRingH = 3 * 8;                 // ring rows (px): 3 block rows
constexpr int kRingW = kChromaCols * 8 + 4;   // + 4: rows 4 banks apart
constexpr size_t kSmemFloats = 3 * 4096 + 2 * kRingH * kRingW;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);
static_assert(kJobBlocks * 8 % kThreads == 0 && kJobBlocks == 64,
              "a job is 16 groups of 4 blocks, 8 loads per block");
static_assert(kSmemBytes == 74496, "3 blocks per SM");

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

// The blocks of one job, 8 int4 (8 coefficients each) per block, thread t
// loading part t % 8 of blocks t / 8 + 16m. A job is either the band's
// prologue (chroma block rows r0-1 and r0: block 32q + 16p + c is plane p,
// row r0-1+q, col c0+c) or MCU row `row` (blocks 16lr + c: luma block row
// 2row+lr, col c0+c; blocks 32 + 16p + c: chroma row row+1, plane p, col
// c0+c). Blocks outside the planes load as zeros.
struct Job {
    const int16_t* yc;
    const int16_t* cb;
    const int16_t* cr;
    int b, cbh, cbw, c0;

    __device__ __forceinline__ const int16_t* chroma(int p, int crow,
                                                     int c) const {
        const int bx = c0 + c;
        if (crow < 0 || crow >= cbh || bx >= cbw) return nullptr;
        return (p ? cr : cb) + ((size_t(b) * cbh + crow) * cbw + bx) * 64;
    }
    __device__ __forceinline__ const int16_t* src(int blk, int row,
                                                  bool prologue) const {
        if (prologue)
            return chroma((blk / kChromaCols) & 1,
                          row - 1 + blk / (2 * kChromaCols),
                          blk % kChromaCols);
        if (blk >= kLumaBlocks)
            return chroma((blk - kLumaBlocks) / kChromaCols, row + 1,
                          (blk - kLumaBlocks) % kChromaCols);
        const int bx = c0 + blk % kStripMcus;
        if (bx >= cbw) return nullptr;
        return yc + ((size_t(b) * 2 * cbh + 2 * row + blk / kStripMcus) *
                     cbw + bx) * 64;
    }
    __device__ __forceinline__ void load(int4 raw[kLoads], int row,
                                         bool prologue, int tid) const {
#pragma unroll
        for (int m = 0; m < kLoads; ++m) {
            const int16_t* s = src((tid >> 3) + 16 * m, row, prologue);
            raw[m] = s ? __ldg(reinterpret_cast<const int4*>(s) + (tid & 7))
                       : make_int4(0, 0, 0, 0);
        }
    }
};

// Convert the loaded coefficients to f32 into the k-major staging area.
__device__ __forceinline__ void store_job(const int4 raw[kLoads],
                                          float* __restrict__ cf, int tid) {
    const int part = tid & 7;
#pragma unroll
    for (int m = 0; m < kLoads; ++m) {
        const int blk = (tid >> 3) + 16 * m;
        const int16_t* s = reinterpret_cast<const int16_t*>(&raw[m]);
#pragma unroll
        for (int e = 0; e < 8; ++e)
            cf[cf_index(8 * part + e, blk)] = static_cast<float>(s[e]);
    }
}

// Pixel row rho of chroma blocks c..c+3 (plane p, block row crow) into the
// ring, whose rows hold chroma px rows (8 * crow + y) mod kRingH.
__device__ __forceinline__ void to_ring(float* __restrict__ ring,
                                        const float acc[4][8], int p,
                                        int crow, int c, int rho) {
    float* dst = ring + (p * kRingH + (8 * crow + rho) % kRingH) * kRingW +
                 8 * c;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        reinterpret_cast<float4*>(dst + 8 * j)[0] =
            make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
        reinterpret_cast<float4*>(dst + 8 * j)[1] =
            make_float4(acc[j][4], acc[j][5], acc[j][6], acc[j][7]);
    }
}

// libjpeg "fancy" triangle tap: (3*c + n) * 0.25, with 3*c + n fused
__device__ __forceinline__ float tri(float c, float n) {
    return __fmul_rn(__fmaf_rn(3.f, c, n), 0.25f);
}

__device__ __forceinline__ uint32_t to_u8(float v) {
    return static_cast<uint32_t>(fminf(fmaxf(rintf(v), 0.f), 255.f));
}

template <bool kPacked>
__global__ void __launch_bounds__(kThreads, 3)
decode440_kernel(const int16_t* __restrict__ yc,
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
    float* ring = cf + 4096;                         // [2][kRingH][kRingW]

    const int b = blockIdx.z;
    const int r0 = blockIdx.y * kBandRows;      // first MCU row of the band
    const int r1 = min(r0 + kBandRows, cbh);
    const int c0 = blockIdx.x * kStripMcus;     // first block col
    const int tid = threadIdx.x;
    const int g = tid >> 3, rho = tid & 7;      // block group, pixel row
    const Job job{yc, cb, cr, b, cbh, cbw, c0};
    int4 raw[kLoads];
    float acc[4][8];

    // 1. stage this image's W_q matrices once for the band, and decode
    //    chroma block rows r0-1 (when inside the plane) and r0 into the ring
    job.load(raw, r0, true, tid);
    stage_w(wqy + size_t(b) * 4096, wy, tid);
    stage_w(wqc + size_t(b) * 4096, wc, tid);
    store_job(raw, cf, tid);
    __syncthreads();
    job.load(raw, r0, false, tid);
    {
        const int q = g / 8, p = (g / 4) & 1;
        idct_rows(cf, wc, g, rho, acc);
        if (r0 - 1 + q >= 0)
            to_ring(ring, acc, p, r0 - 1 + q, 4 * (g % 4), rho);
    }
    __syncthreads();
    store_job(raw, cf, tid);

    const int lr = g / (kLumaGroups / 2);       // luma block row in the job
    const int lbx = 4 * (g % (kLumaGroups / 2));  // first block col
    const int nb = min(4, cbw - (c0 + lbx));    // blocks of g in the plane
    const int ch = 8 * cbh;
    const int oh = 16 * cbh, ow = 8 * cbw;
    const int oy = 8 * lr + rho;                // output row in the MCU row
    const bool rows16 = (ow & 15) == 0;         // output rows 16-byte aligned

    // 2. walk the band: MCU row `row` decodes its luma (kept in registers)
    //    and chroma block row row+1 (into the ring) while the next row's
    //    coefficients load, then upsamples from ring rows row-1..row+1
    for (int row = r0; row < r1; ++row) {
        __syncthreads();             // cf staged; ring rows written
        const bool next = row + 1 < r1;
        if (next) job.load(raw, row + 1, false, tid);
        const bool luma = g < kLumaGroups;
        if (luma || row + 1 < cbh) idct_rows(cf, luma ? wy : wc, g, rho, acc);
        if (!luma && row + 1 < cbh) {
            const int cg = g - kLumaGroups;
            to_ring(ring, acc, cg / 4, row + 1, 4 * (cg % 4), rho);
        }
        __syncthreads();
        if (luma && nb > 0) {
            // vertical triangle tap from the ring, colour, store 32 pixels
            const int gy = 16 * row + oy;
            const int cy = 8 * row + (oy >> 1);  // chroma row (global)
            const int cyn = min(max(cy + ((oy & 1) ? 1 : -1), 0), ch - 1);
            const float* ty = ring + (cy % kRingH) * kRingW + 8 * lbx;
            const float* tyn = ring + (cyn % kRingH) * kRingW + 8 * lbx;
            const size_t o = (size_t(b) * oh + gy) * ow + 8 * (c0 + lbx);
            uint32_t q[3][8];                   // b, g, r bytes of 32 px
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                if (j >= nb) break;
                float cc[2][8];
#pragma unroll
                for (int p = 0; p < 2; ++p) {
                    const float4* a = reinterpret_cast<const float4*>(
                        ty + p * kRingH * kRingW + 8 * j);
                    const float4* n = reinterpret_cast<const float4*>(
                        tyn + p * kRingH * kRingW + 8 * j);
                    const float4 a0 = a[0], a1 = a[1], n0 = n[0], n1 = n[1];
                    const float av[8] = {a0.x, a0.y, a0.z, a0.w,
                                         a1.x, a1.y, a1.z, a1.w};
                    const float nv[8] = {n0.x, n0.y, n0.z, n0.w,
                                         n1.x, n1.y, n1.z, n1.w};
#pragma unroll
                    for (int x = 0; x < 8; ++x)
                        cc[p][x] = __fsub_rn(tri(av[x], nv[x]), 128.f);
                }
                int32_t pk[8];
#pragma unroll
                for (int x = 0; x < 8; ++x) {
                    const float y = acc[j][x];
                    const uint32_t rr = to_u8(__fmaf_rn(1.402f, cc[1][x], y));
                    const uint32_t gg = to_u8(__fmaf_rn(
                        -0.714136286f, cc[1][x],
                        __fmaf_rn(-0.344136286f, cc[0][x], y)));
                    const uint32_t bb = to_u8(__fmaf_rn(1.772f, cc[0][x], y));
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
                if (kPacked) {
                    int4* d = reinterpret_cast<int4*>(opk + o + 8 * j);
                    d[0] = make_int4(pk[0], pk[1], pk[2], pk[3]);
                    d[1] = make_int4(pk[4], pk[5], pk[6], pk[7]);
                }
            }
            if (!kPacked) {
                // an odd cbw leaves rows 8-byte aligned only
                uint8_t* planes[3] = {ob, og, orr};
#pragma unroll
                for (int p = 0; p < 3; ++p) {
                    if (nb == 4 && rows16) {
                        uint4* d = reinterpret_cast<uint4*>(planes[p] + o);
                        d[0] = make_uint4(q[p][0], q[p][1], q[p][2], q[p][3]);
                        d[1] = make_uint4(q[p][4], q[p][5], q[p][6], q[p][7]);
                    } else {
#pragma unroll
                        for (int j = 0; j < 4; ++j)
                            if (j < nb)
                                reinterpret_cast<uint2*>(planes[p] + o)[j] =
                                    make_uint2(q[p][2 * j], q[p][2 * j + 1]);
                    }
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
        decode440_kernel<kPacked>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(kSmemBytes));
    if (e != cudaSuccess) return e;
    decode440_kernel<kPacked><<<grid, kThreads, kSmemBytes, s>>>(
        y, u, v, wy, wc, o0, o1, o2, pk, cbh, cbw);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// yc (B, 2cbh, cbw, 64) int16, cb/cr (B, cbh, cbw, 64) int16, wqy/wqc
// (B, 64, 64) f32, all contiguous on the device. packed=0: o0/o1/o2 are
// the B/G/R u8 planes (B, 16cbh, 8cbw); packed=1: o0 is int32 BGRA of that
// shape. Launches on `stream` and returns the launch's cudaError_t.
int lpt_decode440(const void* yc, const void* cb, const void* cr,
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
