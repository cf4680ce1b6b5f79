// Split-path JPEG IDCT kernel for Hopper (sm_90a): int16 DCT coefficients
// with per-image dequant-folded IDCT matrices -> an f32 raster plane, or
// the u8 plane decode_gray makes of it.
//
// Replaces the Pallas TPU kernel dequant_idct_blocks of
// lilliput_tpu/ops/pallas_kernels.py:45 (pl.pallas_call at :63), which
// jpeg_kernels.dequant_idct vmaps over per-image tables. For every 8x8 block
// of image b, per output pixel j = 8 * row + col of the block:
//
//   p[j] = sum_k f32(coef[k]) * Wq[b][k][j] + 128
//
// where Wq = diag(q) . idct_kron folds the dequantization table into the
// IDCT matrix (jpeg_kernels.fold_qtables). The kernel writes the pixels in
// raster order, (B, 8*bh, 8*bw), which is the relayout dequant_idct does
// after the TPU kernel (jpeg_kernels.py:213-215). Wq is (B, 64, 64), or one
// (64, 64) matrix shared by every image (wq_batched=0, the 1-D qtable branch
// of dequant_idct). Two epilogues: f32 p (lpt_dequant_idct_blocks, what the
// TPU kernel computes) and u8 clip(rint(p), 0, 255)
// (lpt_dequant_idct_blocks_u8, decode_gray's round, clamp and cast, which
// the serving path would otherwise run as three passes over the f32 plane).
//
// Not carried over from the TPU kernel: the pairing of two blocks into one
// 128-lane row against block_diag(wq, wq), and the pad of N to whole grid
// steps. Those fill the TPU's 128-wide matrix unit; here each thread indexes
// its blocks directly and the ragged edges are masked.
//
// Numerics: each 64-term sum runs in k order from 0 with fmaf, then the +128
// is one __fadd_rn; the u8 epilogue then takes rintf and the clip to 0..255
// in the order torch.clamp(torch.round(p), 0, 255) does. No
// --use_fast_math. Every value comes from that one operation sequence
// whatever the tiling, so the f32 output is the same bit for bit as the
// earlier design's (256 threads of 4 blocks x 4 pixels), and the u8 output
// equals the rounded f32 output. The plain version (a cuBLAS batched
// matmul, then + 128) sums in cuBLAS's order, so an f32 value may differ by
// a few ulp and a u8 value by 1 where a sum lands next to a .5 tie.
//
// Bound on an H100 SXM (data-sheet peaks: 3.35 TB/s, 67 TFLOP/s f32 without
// tensor cores) at the serving shape, a batch of 128 grayscale 1080p frames
// (4,147,200 blocks), every input read once and every output written once:
// 531 MB of coefficients in; out 1,062 MB f32 (0.476 ms of bytes) or 265 MB
// u8 (0.238 ms); 34.0 GFLOP of multiply-adds (0.507 ms). f32 FMA issue
// bounds both epilogues.
//
// The design is decode444.cu's for a single plane:
//   * One thread block per (image, strip of 16 block columns, band of 16
//     block rows) stages W_q (16 KB) once, with the halves of rows 4..7
//     swapped (stage_w), and walks its band 4 block rows per step. At the
//     serving shape the grid is 15 x 9 x 128 = 17,280 blocks.
//   * A step is one job of 64 blocks (4 rows x 16 columns). Thread (g, rho)
//     owns pixel row rho of the 4 adjacent blocks of group g, 32
//     accumulators; warp w holds job row w, so a row below the plane is
//     skipped by whole warps. Coefficients are staged as f32 in k-major
//     order (cf_index): one k step of a thread is two float4 W loads, one
//     float4 coefficient load and 32 FMAs, 3 shared-memory wavefronts per
//     32 warp-FMAs (the earlier design took 6 per 16).
//   * While a job computes, the next job's int16 coefficients land in an 8
//     KB raw area by cp.async (no registers held), and each thread then
//     converts its own copies into the other f32 slot, so one barrier per
//     job suffices. Columns past bw are zeros (cp.async of 0 bytes), and
//     their stores are masked.
//   * u8 epilogue: each thread rounds, clips and stores the 32 adjacent
//     pixels of its pixel row, two uint4 where the row stride 8*bw is a
//     multiple of 16 and one uint2 per block where it is not. f32
//     epilogue: after a second barrier each warp stages its 8 pixel rows
//     in the slot the job has just read and stores them row by row, 512
//     contiguous bytes per warp store (store_f32).
// 128 threads, kSmemBytes = 57,344 bytes of dynamic shared memory (W_q, two
// coefficient slots, the raw area): 4 blocks per SM (4 x (57,344 + 1,024
// reserved) = 233,472 bytes), so __launch_bounds__ caps registers at 128;
// the k steps unrolled by 8 take 107 (u8) and 117 (f32), no spills.
//
// Measured at the serving shape by tools/torch_kernel_variants.py (NVIDIA
// H100 80GB HBM3, 700.00 W; PERF.md section 6): u8 0.94 ms, f32 0.96 ms,
// against 1.77 ms for the earlier design in the same call (torch.baddbmm,
// the same f32 function: 2.02 ms in chip_smoke.py). Unrolled by 4: u8
// 1.02, f32 1.01; f32 stored straight from the registers: 1.27. Bands of 8
// or 32 rows, a cap of 168 registers and streaming stores moved either
// epilogue by under 2%.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kStripBlocks = 16;              // block columns per strip
constexpr int kJobRows = 4;                   // block rows per step
constexpr int kBandRows = 16;                 // block rows per band
constexpr int kThreads = 128;                 // 16 groups x 8 pixel rows
constexpr int kMinBlocks = 4;                 // blocks per SM
constexpr int kJobBlocks = kJobRows * kStripBlocks;    // 64
constexpr int kLoads = kJobBlocks * 8 / kThreads;      // int4 per thread
// W_q + 2 coefficient slots (f32), and the raw int16 staging area
constexpr size_t kSmemBytes =
    3 * 4096 * sizeof(float) + kLoads * kThreads * sizeof(int4);
static_assert(kJobBlocks == 64 && kLoads == kJobRows,
              "a job is 16 groups of 4 blocks, thread t loads job row m");
static_assert(kBandRows % kJobRows == 0, "a band is whole steps");
static_assert(kSmemBytes == 57344, "4 blocks per SM");

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

// The 64 blocks of the job at block row row0 (block 16m + c: row row0+m,
// col c0+c), 8 int4 (8 coefficients each) per block: thread t copies part
// t % 8 of blocks t / 8 + 16m to raw[m * kThreads + t]. Blocks outside the
// plane or the band are zeros. The copies land while the block computes,
// and hold no registers meanwhile.
struct Loader {
    int b, bh, bw, c0, r1;

    __device__ __forceinline__ void issue(int4* raw,
                                          const int16_t* __restrict__ coefs,
                                          int row0, int tid) const {
        const int bx = c0 + (tid >> 3);
#pragma unroll
        for (int m = 0; m < kLoads; ++m) {
            const int r = row0 + m;
            const bool in = r < r1 && bx < bw;
            cp_async16(raw + m * kThreads + tid,
                       in ? coefs + ((size_t(b) * bh + r) * bw + bx) * 64 +
                                8 * (tid & 7)
                          : coefs,
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

// Store a warp's job row, 8 pixel rows x 16 blocks of f32 pixels, through
// st, 4 KB of the coefficient slot the job has just read: each thread puts
// its 32 pixels there (float4 q of row r at st[r * 32 + (q ^ r)], so no two
// threads of a quarter-warp share a bank), then each warp store is the 512
// contiguous bytes of one row. Stored straight from the registers, a warp's
// float4 store touches 32 lines of 128 bytes, and the L1 traffic made the
// f32 epilogue 1.27 ms against the u8 one's 0.94 (PERF.md).
__device__ __forceinline__ void store_f32(float4* __restrict__ st,
                                          float* __restrict__ dst, size_t ow,
                                          const float acc[4][8], int g,
                                          int rho, int lane, bool in) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int q = 8 * (g & 3) + i, j = i >> 1, h = 4 * (i & 1);
        st[rho * 32 + (q ^ rho)] = make_float4(acc[j][h], acc[j][h + 1],
                                               acc[j][h + 2], acc[j][h + 3]);
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 8; ++r) {
        const float4 v = st[r * 32 + (lane ^ r)];
        if (in) *reinterpret_cast<float4*>(dst + r * ow + 4 * lane) = v;
    }
}

// torch.clamp(torch.round(v), 0, 255) as a byte.
__device__ __forceinline__ uint32_t to_u8(float v) {
    return static_cast<uint32_t>(fminf(fmaxf(rintf(v), 0.f), 255.f));
}

// Round, clip and store the 32 pixels of blocks 0..nb-1 of a group at dst
// as u8: a uint4 pair where the row is 16-byte aligned, a uint2 per block
// otherwise (an odd bw leaves rows 8-byte aligned only).
__device__ __forceinline__ void store_u8(uint8_t* __restrict__ dst,
                                         const float acc[4][8], int nb,
                                         bool rows16) {
    uint32_t q[8];                               // 4 pixels per word
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int x = 0; x < 8; ++x) {
            const uint32_t v = to_u8(acc[j][x]);
            const int wd = 2 * j + (x >> 2), sh = 8 * (x & 3);
            q[wd] = (x & 3) ? q[wd] | (v << sh) : v;
        }
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

// coefs (B, bh*bw, 64) int16, wq (B or 1, 64, 64) f32, out (B, 8*bh, 8*bw)
// f32, or u8 when kU8
template <bool kU8>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
idct_kernel(const int16_t* __restrict__ coefs, const float* __restrict__ wq,
            void* __restrict__ out, int bh, int bw, int wq_batched) {
    extern __shared__ __align__(16) float smem[];
    float* w = smem;                                 // [64][64], swizzled
    float* cf = w + 4096;                            // 2 x [64 k][64 blocks]
    int4* raw = reinterpret_cast<int4*>(cf + 2 * 4096);  // [kLoads][128]

    const int b = blockIdx.z;
    const int r0 = blockIdx.y * kBandRows;      // first block row of the band
    const int r1 = min(r0 + kBandRows, bh);
    const int c0 = blockIdx.x * kStripBlocks;   // first block col
    const int tid = threadIdx.x;
    const int g = tid >> 3, rho = tid & 7;      // block group, pixel row
    const int jr = g >> 2;                      // job row (= warp)
    const int lbx = 4 * (g & 3);                // first block col of g
    const int nb = min(4, bw - (c0 + lbx));     // blocks of g in the plane
    const size_t oh = size_t(8) * bh, ow = size_t(8) * bw;
    const bool rows16 = (ow & 15) == 0;         // u8 rows 16-byte aligned
    const int steps = (r1 - r0 + kJobRows - 1) / kJobRows;
    const Loader ld{b, bh, bw, c0, r1};
    float acc[4][8];

    // 1. stage this image's W_q once for the band, and the first job into
    //    slot 0
    ld.issue(raw, coefs, r0, tid);
    stage_w(wq + (wq_batched ? size_t(b) * 4096 : 0), w, tid);
    store_job(raw, cf, tid);

    // 2. walk the band, 4 block rows per step: job s reads slot s&1 while
    //    the next job's coefficients land in the raw area, then fill the
    //    other slot; the f32 epilogue then stages its rows in slot s&1
    for (int s = 0; s < steps; ++s) {
        const int row0 = r0 + kJobRows * s;
        const bool live = row0 + jr < r1;        // whole warps
        const bool more = s + 1 < steps;
        __syncthreads();                         // job s staged, s-1 done
        if (more) ld.issue(raw, coefs, row0 + kJobRows, tid);
        if (live) idct_rows(cf + 4096 * (s & 1), w, g, rho, acc);
        if (more) store_job(raw, cf + 4096 * ((s + 1) & 1), tid);
        const size_t o = (size_t(b) * oh + 8 * size_t(row0 + jr)) * ow;
        if (kU8) {
            if (live && nb > 0)
                store_u8(static_cast<uint8_t*>(out) + o + rho * ow +
                             8 * size_t(c0 + lbx),
                         acc, nb, rows16);
            continue;
        }
        __syncthreads();                         // slot s&1 read by all
        if (live)
            store_f32(reinterpret_cast<float4*>(cf + 4096 * (s & 1)) +
                          256 * jr,
                      static_cast<float*>(out) + o + 8 * size_t(c0), ow, acc,
                      g, rho, tid & 31, c0 + ((tid & 31) >> 1) < bw);
    }
}

template <bool kU8>
int launch(const void* coefs, const void* wq, void* out, int batch, int bh,
           int bw, int wq_batched, void* stream) {
    if (batch <= 0 || bh <= 0 || bw <= 0 || batch > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    const int grid_x = (bw - 1) / kStripBlocks + 1;
    const int grid_y = (bh - 1) / kBandRows + 1;
    if (grid_y > 65535) return static_cast<int>(cudaErrorInvalidValue);
    // above 48 KB, dynamic shared memory must be asked for per kernel
    cudaError_t e = cudaFuncSetAttribute(
        idct_kernel<kU8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(kSmemBytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    idct_kernel<kU8><<<dim3(grid_x, grid_y, batch),
                       kThreads, kSmemBytes,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int16_t*>(coefs), static_cast<const float*>(wq),
        out, bh, bw, wq_batched);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// coefs (batch, bh, bw, 64) int16, wq (batch, 64, 64) f32 when wq_batched
// else (1, 64, 64), out (batch, 8*bh, 8*bw) f32, all contiguous on the
// device and 16-byte aligned. Launches on `stream` and returns the launch's
// cudaError_t.
int lpt_dequant_idct_blocks(const void* coefs, const void* wq, void* out,
                            int batch, int bh, int bw, int wq_batched,
                            void* stream) {
    return launch<false>(coefs, wq, out, batch, bh, bw, wq_batched, stream);
}

// lpt_dequant_idct_blocks with out (batch, 8*bh, 8*bw) u8: each value
// rounded half to even and clipped to 0..255.
int lpt_dequant_idct_blocks_u8(const void* coefs, const void* wq, void* out,
                               int batch, int bh, int bw, int wq_batched,
                               void* stream) {
    return launch<true>(coefs, wq, out, batch, bh, bw, wq_batched, stream);
}

const char* lpt_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
