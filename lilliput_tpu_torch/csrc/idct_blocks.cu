// Split-path JPEG IDCT kernel for Hopper (sm_90a): int16 DCT coefficients
// with per-image dequant-folded IDCT matrices -> f32 raster planes.
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
// of dequant_idct).
//
// Not carried over from the TPU kernel: the pairing of two blocks into one
// 128-lane row against block_diag(wq, wq), and the pad of N to whole grid
// steps. Those fill the TPU's 128-wide matrix unit; here each thread indexes
// its blocks directly and the ragged last tile is masked.
//
// Numerics: each 64-term sum runs in k order from 0 with fmaf, then the +128
// is one __fadd_rn; no --use_fast_math, and nothing is rounded, since the
// output is f32. The plain version (a cuBLAS batched matmul, then + 128)
// sums in cuBLAS's order, so an f32 value may differ by a few ulp and the u8
// value decode_gray rounds it to by 1 where a sum lands next to a .5 tie.
//
// Bound on an H100 SXM (data sheet figures, not measurements) at the
// serving shape, a batch of 128 grayscale 1080p frames (4,147,200 blocks):
// 531 MB of coefficients in and 1,062 MB of f32 pixels out (~0.48 ms at
// 3.35 TB/s) against 34.0 GFLOP of multiply-adds (~0.51 ms at 67 TFLOP/s
// f32 outside the tensor cores), so operations bound it, barely. The design
// keeps the FMA pipe fed with few shared-memory loads per FMA:
//   * one thread block per (image, run of kTiles tiles of 64 blocks); the
//     image's W_q (16 KB) is staged once in shared memory for the run;
//   * each tile's coefficients are staged as f32 (block stride 65, so the
//     two groups of a warp read different banks);
//   * each thread owns 4 blocks x 4 pixels: one k step is one float4 W load,
//     four broadcast coefficient loads and 16 FMAs;
//   * each thread stores 4 adjacent pixels of a block row as one float4.
// Later work: a tensor-core IDCT (an exact 3-way bf16 split of W_q) once
// the output's 1 GB write, not the FMAs, is the limit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kStride = 65;                     // f32 per staged block
constexpr int kBlocksPerThread = 4;
constexpr int kTileBlocks = kThreads / 16 * kBlocksPerThread;  // 64
constexpr int kTiles = 8;                       // tiles per thread block

// coefs (B, bh*bw, 64) int16, wq (B or 1, 64, 64) f32, out (B, 8*bh, 8*bw)
__global__ void __launch_bounds__(kThreads)
idct_kernel(const int16_t* __restrict__ coefs, const float* __restrict__ wq,
            float* __restrict__ out, int bh, int bw, int wq_batched) {
    __shared__ __align__(16) float w[64 * 64];
    __shared__ __align__(16) float tile[kTileBlocks * kStride];

    const int b = blockIdx.y;
    const int tid = threadIdx.x;
    const long n_blocks = long(bh) * bw;
    const int16_t* src = coefs + size_t(b) * n_blocks * 64;

    {
        const float4* w4 = reinterpret_cast<const float4*>(
            wq + (wq_batched ? size_t(b) * 4096 : 0));
        for (int i = tid; i < 1024; i += kThreads)
            reinterpret_cast<float4*>(w)[i] = __ldg(w4 + i);
    }

    const int g = tid & 15;            // pixel group: row g/2, cols 4(g%2)..+3
    const int px = g >> 1, py = 4 * (g & 1);
    const int blk0 = kBlocksPerThread * (tid >> 4);  // first block in tile
    const size_t row_stride = size_t(8) * bw;
    float* dst_img = out + size_t(b) * 8 * bh * row_stride;

    for (int t = 0; t < kTiles; ++t) {
        const long n0 = (long(blockIdx.x) * kTiles + t) * kTileBlocks;
        if (n0 >= n_blocks) break;     // uniform across the thread block
        __syncthreads();               // W staged / previous tile consumed
        // stage the tile's coefficients as f32, 8 per thread step
        for (int i = tid; i < kTileBlocks * 8; i += kThreads) {
            const int blk = i >> 3, part = i & 7;
            if (n0 + blk < n_blocks) {
                const int4* blk4 =
                    reinterpret_cast<const int4*>(src + (n0 + blk) * 64);
                const int4 v = __ldg(blk4 + part);
                const int16_t* s = reinterpret_cast<const int16_t*>(&v);
                float* d = tile + blk * kStride + part * 8;
#pragma unroll
                for (int e = 0; e < 8; ++e) d[e] = static_cast<float>(s[e]);
            }
        }
        __syncthreads();

        float acc[kBlocksPerThread][4];
#pragma unroll
        for (int j = 0; j < kBlocksPerThread; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
        const float4* wv = reinterpret_cast<const float4*>(w) + g;
        const float* a = tile + blk0 * kStride;
#pragma unroll 8
        for (int k = 0; k < 64; ++k) {
            const float4 wk = wv[k * 16];
#pragma unroll
            for (int j = 0; j < kBlocksPerThread; ++j) {
                const float c = a[j * kStride + k];
                acc[j][0] = fmaf(c, wk.x, acc[j][0]);
                acc[j][1] = fmaf(c, wk.y, acc[j][1]);
                acc[j][2] = fmaf(c, wk.z, acc[j][2]);
                acc[j][3] = fmaf(c, wk.w, acc[j][3]);
            }
        }
#pragma unroll
        for (int j = 0; j < kBlocksPerThread; ++j) {
            const long n = n0 + blk0 + j;
            if (n >= n_blocks) break;  // ragged last tile
            const int by = int(n / bw), bx = int(n % bw);
            float* d = dst_img + (size_t(8) * by + px) * row_stride +
                       8 * size_t(bx) + py;
            reinterpret_cast<float4*>(d)[0] = make_float4(
                __fadd_rn(acc[j][0], 128.f), __fadd_rn(acc[j][1], 128.f),
                __fadd_rn(acc[j][2], 128.f), __fadd_rn(acc[j][3], 128.f));
        }
    }
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
    if (batch <= 0 || bh <= 0 || bw <= 0 || batch > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    const long n_blocks = long(bh) * bw;
    const long per_cta = long(kTiles) * kTileBlocks;
    const long grid_x = (n_blocks + per_cta - 1) / per_cta;
    if (grid_x > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
    idct_kernel<<<dim3(unsigned(grid_x), batch), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int16_t*>(coefs), static_cast<const float*>(wq),
        static_cast<float*>(out), bh, bw, wq_batched);
    return static_cast<int>(cudaGetLastError());
}

const char* lpt_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
