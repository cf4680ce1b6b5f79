// 4:4:4 JPEG decode kernel for Hopper (sm_90a): int16 DCT coefficients ->
// three raster u8 planes (B, G, R) or packed BGRA int32.
//
// Replaces lilliput_tpu/ops/pallas_kernels.py decode444_packed (the Pallas
// TPU megakernel, with its _dec444_kernel_factory body). Same arithmetic,
// per output pixel:
//
//   luma   Y  = sum_k f32(coef[k]) * Wqy[k][x*8+y] + 128      (W_q folds the
//   chroma C' = sum_k f32(coef[k]) * Wqc[k][x*8+y]             dequant table)
//   R = fma(1.402, Cr', Y), G = fma(-0.714136286, Cr', fma(-0.344136286,
//   Cb', Y)), B = fma(1.772, Cb', Y); then clip(rint(v), 0, 255).
//
// Chroma has no level shift: the JAX package adds 128 to the sum and
// subtracts it again (pallas_kernels.py:754-757, and its split path), and
// XLA folds (x + 128) - 128 to x when it compiles either; keeping the round
// trip moves 18 of 2,384,640 u8 values of the 4:4:4 fixture's window by 1
// against the JAX package on the CPU.
//
// Numerics as in decode420.cu: the fusions XLA makes on the CPU are written
// out (__fmaf_rn), every other step is __fadd_rn, the rounding is rintf,
// and there is no --use_fast_math. The 64-term IDCT sums run in k order
// with fmaf, so a u8 value may differ by 1 from the plain version where a
// sum lands next to a .5 tie.
//
// Replaces pallas_kernels.py:771 (`pl.pallas_call` at :792).
//
// Bound on an H100 SXM (data-sheet peaks: 3.35 TB/s, 67 TFLOP/s f32 without
// tensor cores), at the serving window, B = 128 (3 planes of 135x138
// blocks), every input read once and every output written once, against
// 2*64*64 FLOP per 8x8 block IDCT (chip_smoke.bound): 3 x (128, 135, 138,
// 64) int16 plus three u8 planes is 1.37 GB -> 0.41 ms of bytes, 58.6 GFLOP
// -> 0.875 ms of operations. f32 FMA issue bounds it.
//
// The design is decode440.cu's without the ring (4:4:4 has no upsample and
// no halo, so every block is decoded exactly once):
//   * One thread block per (image, strip of 16 MCUs, band of 16 MCU rows)
//     stages both W_q once and walks its band top to bottom, 4 MCU rows per
//     step. At the serving window the grid is 9 x 9 x 128 = 10,368 blocks,
//     26.2 waves of 3 blocks on each of 132 SMs.
//   * A step is one job of 64 blocks (4 rows x 16 columns) per plane. Thread
//     (g, rho) owns pixel row rho of the 4 adjacent blocks of group g in all
//     three planes; warp w holds job row w, so a row below the plane is
//     skipped by whole warps.
//   * The IDCT is fed by few shared-memory loads per FMA: coefficients are
//     staged as f32 in k-major order (cf_index), W_q with the halves of rows
//     4..7 swapped; one k step of a thread is two float4 W loads, one float4
//     coefficient load and 32 FMAs: 3 shared-memory wavefronts per 32
//     warp-FMAs.
//   * The planes go through the IDCT one after the other (Y, Cb, Cr), each
//     from one of two f32 coefficient slots: while one plane computes, the
//     next plane's int16 coefficients land in a raw staging area by
//     cp.async (no registers held), and each thread then converts its own
//     copies into the other slot, so one barrier per plane suffices. Y stays
//     in registers; after Cb the thread finishes B and keeps
//     fma(-0.344136286, Cb', Y) for G in the registers Cb' held; after Cr
//     it finishes R and G. Colour never passes through shared memory, and
//     all 128 threads run the epilogue, each storing 32 adjacent pixels per
//     plane.
// 128 threads, kSmemBytes = 73,728 bytes of dynamic shared memory (both W_q,
// two coefficient slots, 8 KB of raw staging). Planes epilogue: 3 blocks
// per SM (3 x (73,728 + 1,024 reserved) = 224,256 of 233,472 bytes;
// __launch_bounds__ caps registers at 168, 3 x 128 x 168 of 65,536). The
// Cr IDCT runs with 96 floats live (Y, G's inner FMA, the Cr sum), so the
// k steps are unrolled by 4, not 8: hoisting 8 steps' loads spilled at 168.
// Packed epilogue: 2 blocks per SM (see decode444_kernel). Every output
// value comes from one fixed operation sequence (fmaf in k order from 0,
// + 128 for luma, the colour FMAs, rintf and the clip), so the result does
// not depend on the tiling.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kStripMcus = 16;                // MCUs (8x8 px) per strip
constexpr int kJobRows = 4;                   // MCU rows per step
constexpr int kBandRows = 16;                 // MCU rows per band
constexpr int kThreads = 128;                 // 16 groups x 8 pixel rows
constexpr int kJobBlocks = kJobRows * kStripMcus;      // 64 per plane
constexpr int kLoads = kJobBlocks * 8 / kThreads;      // int4 per thread
// 2 W_q + 2 coefficient slots (f32), and the raw int16 staging area
constexpr size_t kSmemBytes =
    4 * 4096 * sizeof(float) + kLoads * kThreads * sizeof(int4);
static_assert(kJobBlocks == 64 && kLoads == kJobRows,
              "a job is 16 groups of 4 blocks, thread t loads job row m");
static_assert(kBandRows % kJobRows == 0, "a band is whole steps");
static_assert(kSmemBytes == 73728, "3 blocks per SM");

// Coefficient staging: (k, block) of a job of 64 blocks at
// cf[k * 64 + 4 * ((block >> 2) ^ (k >> 3)) + (block & 3)]: k-major, so one
// float4 is one k of a group of 4 blocks; the xor spreads the transposing
// stores of one warp over all 32 banks.
__device__ __forceinline__ int cf_index(int k, int blk) {
    return k * 64 + 4 * ((blk >> 2) ^ (k >> 3)) + (blk & 3);
}

// IDCT of 4 blocks (group g of the staged job) at pixel row rho: acc[j][x]
// is pixel (rho, x) of block 4g+j, summed in k order with fmaf from 0, then
// +128 when kShift. W is staged with the halves of rows 4..7 swapped
// (stage_w), so the warp's two float4 W loads each cover all 32 banks once;
// the coefficient load is one float4 of 4 consecutive groups: 3 wavefronts
// per 32 FMAs.
template <bool kShift>
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
#pragma unroll 4
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
    if (!kShift) return;
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

// The 64 blocks of one plane's job at MCU row row0 (block 16m + c: row
// row0+m, col c0+c), 8 int4 (8 coefficients each) per block: thread t
// copies part t % 8 of blocks t / 8 + 16m to raw[m * kThreads + t]. Blocks
// outside the plane or the band are zeros. The copies land while the block
// computes, and hold no registers meanwhile.
struct Loader {
    int b, cbh, cbw, c0, r1;

    __device__ __forceinline__ void issue(int4* raw,
                                          const int16_t* __restrict__ plane,
                                          int row0, int tid) const {
        const int bx = c0 + (tid >> 3);
#pragma unroll
        for (int m = 0; m < kLoads; ++m) {
            const int r = row0 + m;
            const bool in = r < r1 && bx < cbw;
            cp_async16(raw + m * kThreads + tid,
                       in ? plane + ((size_t(b) * cbh + r) * cbw + bx) * 64 +
                                8 * (tid & 7)
                          : plane,
                       in ? 16 : 0);
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
};

// Wait for this thread's copies (no other thread reads them, so no barrier)
// and convert them to f32 into a k-major staging slot.
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

__device__ __forceinline__ uint32_t to_u8(float v) {
    return static_cast<uint32_t>(fminf(fmaxf(rintf(v), 0.f), 255.f));
}

// Byte x of block j in the 32 pixels' words (4 pixels per word).
__device__ __forceinline__ uint32_t byte_of(const uint32_t q[8], int j,
                                            int x) {
    return (q[2 * j + (x >> 2)] >> (8 * (x & 3))) & 255u;
}

// Store 32 u8 pixels (blocks 0..nb-1 of a group) at dst: a uint4 pair
// where the row is 16-byte aligned, a uint2 per block otherwise (an odd
// cbw leaves rows 8-byte aligned only).
__device__ __forceinline__ void store_u8(uint8_t* __restrict__ dst,
                                         const uint32_t q[8], int nb,
                                         bool rows16) {
    if (nb == 4 && rows16) {
        uint4* d = reinterpret_cast<uint4*>(dst);
        d[0] = make_uint4(q[0], q[1], q[2], q[3]);
        d[1] = make_uint4(q[4], q[5], q[6], q[7]);
        return;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
        if (j < nb)
            reinterpret_cast<uint2*>(dst)[j] =
                make_uint2(q[2 * j], q[2 * j + 1]);
}

// 3 blocks per SM cap registers at 168. The packed epilogue also holds the
// B bytes of 32 pixels through the Cr IDCT, which spills at 168, so it runs
// 2 blocks per SM (it serves decode_ycc_packed, no serving path).
template <bool kPacked>
__global__ void __launch_bounds__(kThreads, kPacked ? 2 : 3)
decode444_kernel(const int16_t* __restrict__ yc,
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
    float* cf = wc + 4096;                           // 2 x [64 k][64 blocks]
    int4* raw = reinterpret_cast<int4*>(cf + 2 * 4096);  // [kLoads][128]

    const int b = blockIdx.z;
    const int r0 = blockIdx.y * kBandRows;      // first MCU row of the band
    const int r1 = min(r0 + kBandRows, cbh);
    const int c0 = blockIdx.x * kStripMcus;     // first block col
    const int tid = threadIdx.x;
    const int g = tid >> 3, rho = tid & 7;      // block group, pixel row
    const int jr = g >> 2;                      // job row (= warp)
    const int lbx = 4 * (g & 3);                // first block col of g
    const int nb = min(4, cbw - (c0 + lbx));    // blocks of g in the plane
    const int oh = 8 * cbh, ow = 8 * cbw;
    const bool rows16 = (ow & 15) == 0;         // output rows 16-byte aligned
    const int steps = (r1 - r0 + kJobRows - 1) / kJobRows;
    const Loader ld{b, cbh, cbw, c0, r1};
    // Y; Cb', then G's inner FMA; Cr'
    float y[4][8], t[4][8], c[4][8];

    // 1. stage this image's W_q matrices once for the band, and the first
    //    step's luma into slot 0
    ld.issue(raw, yc, r0, tid);
    stage_w(wqy + size_t(b) * 4096, wy, tid);
    stage_w(wqc + size_t(b) * 4096, wc, tid);
    store_job(raw, cf, tid);

    // 2. walk the band, 4 MCU rows per step, Y, Cb, Cr in turn: plane job
    //    3s+p reads slot (s+p)&1 while the next job's coefficients land in
    //    the raw area, then fill the other slot
    for (int s = 0; s < steps; ++s) {
        const int row0 = r0 + kJobRows * s;
        const bool live = row0 + jr < r1;        // whole warps
        float* cur = cf + 4096 * (s & 1);
        float* nxt = cf + 4096 * ((s + 1) & 1);
        const size_t o =
            (size_t(b) * oh + 8 * (row0 + jr) + rho) * ow + 8 * (c0 + lbx);

        __syncthreads();                         // Y staged in cur
        ld.issue(raw, cb, row0, tid);
        if (live) idct_rows<true>(cur, wy, g, rho, y);
        store_job(raw, nxt, tid);

        __syncthreads();                         // Cb staged in nxt
        ld.issue(raw, cr, row0, tid);
        if (live) idct_rows<false>(nxt, wc, g, rho, t);
        store_job(raw, cur, tid);
        uint32_t qb[8];                          // B bytes of 32 px
        if (live) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int x = 0; x < 8; ++x) {
                    const uint32_t bb =
                        to_u8(__fmaf_rn(1.772f, t[j][x], y[j][x]));
                    const int wd = 2 * j + (x >> 2), sh = 8 * (x & 3);
                    qb[wd] = (x & 3) ? qb[wd] | (bb << sh) : bb;
                    t[j][x] = __fmaf_rn(-0.344136286f, t[j][x], y[j][x]);
                }
            if (!kPacked && nb > 0) store_u8(ob + o, qb, nb, rows16);
        }

        __syncthreads();                         // Cr staged in cur
        const bool more = s + 1 < steps;
        if (more) ld.issue(raw, yc, row0 + kJobRows, tid);
        if (live) idct_rows<false>(cur, wc, g, rho, c);
        if (more) store_job(raw, nxt, tid);
        if (!live || nb <= 0) continue;
        uint32_t qg[8], qr[8];                   // G, R bytes of 32 px
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            int32_t pk[8];
#pragma unroll
            for (int x = 0; x < 8; ++x) {
                const uint32_t rr =
                    to_u8(__fmaf_rn(1.402f, c[j][x], y[j][x]));
                const uint32_t gg =
                    to_u8(__fmaf_rn(-0.714136286f, c[j][x], t[j][x]));
                if (kPacked) {
                    pk[x] = static_cast<int32_t>(byte_of(qb, j, x) |
                                                 (gg << 8) | (rr << 16) |
                                                 0xFF000000u);
                } else {
                    const int wd = 2 * j + (x >> 2), sh = 8 * (x & 3);
                    qg[wd] = (x & 3) ? qg[wd] | (gg << sh) : gg;
                    qr[wd] = (x & 3) ? qr[wd] | (rr << sh) : rr;
                }
            }
            if (kPacked && j < nb) {
                int4* d = reinterpret_cast<int4*>(opk + o + 8 * j);
                d[0] = make_int4(pk[0], pk[1], pk[2], pk[3]);
                d[1] = make_int4(pk[4], pk[5], pk[6], pk[7]);
            }
        }
        if (!kPacked) {
            store_u8(og + o, qg, nb, rows16);
            store_u8(orr + o, qr, nb, rows16);
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
        decode444_kernel<kPacked>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(kSmemBytes));
    if (e != cudaSuccess) return e;
    decode444_kernel<kPacked><<<grid, kThreads, kSmemBytes, s>>>(
        y, u, v, wy, wc, o0, o1, o2, pk, cbh, cbw);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// yc, cb, cr (B, cbh, cbw, 64) int16, wqy/wqc (B, 64, 64) f32, all
// contiguous on the device. packed=0: o0/o1/o2 are the B/G/R u8 planes
// (B, 8cbh, 8cbw); packed=1: o0 is int32 BGRA of that shape. Launches on
// `stream` and returns the launch's cudaError_t.
int lpt_decode444(const void* yc, const void* cb, const void* cr,
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
