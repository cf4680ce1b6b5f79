// Huffman decode of baseline JPEG scans on Hopper (sm_90a): destuffed
// restart segments (csrc/host/jpeg_scan.cpp) -> int16 DCT coefficients in
// natural order, straight into the batch arrays the decode kernels read.
//
// Replaces no Pallas kernel: the JAX package decodes every scan on the host
// (lilliput_tpu/native/src/jpeg_huff.cpp). This moves that file's baseline
// decode_mcus to the card, with its results bit for bit: the same canonical
// code walk, the same stores (only real in-window blocks), the same DC
// prediction (reset at each restart segment), and a stream flagged in
// `status` wherever decode_mcus returns non-zero (a bad code, k > 63, a DC
// size over 15, bits used past the segment's end), which the caller then
// decodes on the host. Plain version: ops/entropy_kernels.py
// huffman_decode_plain, which runs the same phases in NumPy.
//
// Parallel decode without restart markers (Weissenberger and Schmidt,
// arXiv:2111.09219): each segment is cut into subsequences of N bits, one
// thread each. A state is (bit position in the segment, block of the MCU,
// zigzag index k), packed as pos << 16 | blk << 8 | k; kErr marks a decode
// error, and a thread handed kErr starts from its guess (its first bit,
// block 0, k 0).
//   sync_init  each thread decodes from its guess until it passes its end
//              and records that state and the blocks it started; then the
//              threads of a CUDA block repeat from their predecessor's
//              state (in shared memory) until no state changes;
//   sync_pass  up to `passes` times: a CUDA block whose first thread's
//              start state differs from the previous block's last recorded
//              state decodes again from there and propagates;
//   (the wrapper's exclusive prefix sum of the blocks started)
//   write      each thread decodes from its predecessor's state, writes AC
//              coefficients and DC differences, and checks that it ends in
//              its recorded state with its recorded count (if the sync did
//              not converge, the image is flagged, never written wrongly);
//   dc         per image and component, a segmented scan of the DC
//              differences in decode order writes coefficient 0.
// A segment's first subsequence starts from a known state, so by induction
// the fixed point of the sync is the true decode, however fast it comes.
//
// Bound: a serial chain per thread (table loads, shifts, a branch a
// symbol), so latency and divergence, not bytes: ~36 MB of scans and
// ~1.2 GB of zero-filled coefficient writes a batch of 32 at 12 MP (0.35
// ms at 3.35 TB/s). The design spends threads (one a subsequence, ~280,000
// a batch), reads each segment through a two-word register window and the
// tables through the read-only cache, and decodes every bit about three
// times (guess, sync, write).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr uint64_t kErr = ~0ull;
constexpr int kThreads = 128;
constexpr int kDcThreads = 1024;

struct Geom {
    int ncomp, bpm, mcus_x, nmcu;
    int sched[10];  // block of an MCU: component | dx << 4 | dy << 8
    int h[4], v[4], bw[4], bh[4], wy0[4], wx0[4], wh[4], ww[4];
};

struct DevHuff {
    uint16_t lut[512];
    int32_t maxcode[18];
    int32_t valoffset[18];
    uint8_t vals[256];
};

__device__ uint8_t kNat[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// A subsequence: its segment's row of the segment table (word offset,
// bits, image, first block, blocks, first subsequence, subsequences) and
// its own bit range.
struct Lane {
    int word0, bits, img, blk0, nblk, sub0, start, end;
    bool first, last;
};

__device__ Lane lane_of(const int* seg, const int* sub_start, int nseg,
                        int t, int n_bits) {
    int lo = 0, hi = nseg - 1;
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (__ldg(sub_start + mid) <= t)
            lo = mid;
        else
            hi = mid - 1;
    }
    const int* r = seg + 8 * lo;
    Lane L;
    L.word0 = __ldg(r);
    L.bits = __ldg(r + 1);
    L.img = __ldg(r + 2);
    L.blk0 = __ldg(r + 3);
    L.nblk = __ldg(r + 4);
    L.sub0 = __ldg(r + 5);
    const int j = t - L.sub0;
    L.first = j == 0;
    L.last = j == __ldg(r + 6) - 1;
    L.start = j * n_bits;
    L.end = min(L.start + n_bits, L.bits);
    return L;
}

__device__ __forceinline__ uint64_t pack(int pos, int blk, int k) {
    return (static_cast<uint64_t>(pos) << 16) | (blk << 8) | k;
}

// The bits of a segment from any position, through a window of the two
// words around it; past the segment's end the layout has zeros.
struct Reader {
    const uint32_t* w;
    int cw;
    uint32_t a, b;
    __device__ Reader(const uint32_t* words, int word0, int pos)
        : w(words + word0), cw(pos >> 5) {
        a = __byte_perm(__ldg(w + cw), 0, 0x0123);
        b = __byte_perm(__ldg(w + cw + 1), 0, 0x0123);
    }
    // the 32 bits from pos (pos never moves back, and by at most 31)
    __device__ __forceinline__ uint32_t peek(int pos) {
        const int wi = pos >> 5;
        if (wi != cw) {
            if (wi == cw + 1) {
                a = b;
            } else {
                a = __byte_perm(__ldg(w + wi), 0, 0x0123);
            }
            b = __byte_perm(__ldg(w + wi + 1), 0, 0x0123);
            cw = wi;
        }
        const int sh = pos & 31;
        return sh ? (a << sh) | (b >> (32 - sh)) : a;
    }
};

// One symbol of table t from the 32 bits at the stream position: the
// symbol, or -1 for a bad code; *len its code length.
__device__ __forceinline__ int huff(const DevHuff* t, uint32_t bits,
                                    int* len) {
    const int e = __ldg(&t->lut[bits >> 23]);
    if (e) {
        *len = e >> 8;
        return e & 0xFF;
    }
    for (int l = 10; l <= 16; l++) {
        const int code = static_cast<int>(bits >> (32 - l));
        if (code <= __ldg(&t->maxcode[l])) {
            *len = l;
            const int idx = code + __ldg(&t->valoffset[l]);
            return (idx < 0 || idx > 255) ? -1 : __ldg(&t->vals[idx]);
        }
    }
    return -1;
}

__device__ __forceinline__ int extend(uint32_t bits, int len, int s) {
    if (!s) return 0;
    const int v = static_cast<int>((bits << len) >> (32 - s));
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// Decode from state st (kErr: the guess) until the position reaches the
// lane's end at a codeword boundary: that state, kErr on a decode error;
// *nblocks the blocks started (DC symbols decoded).
__device__ uint64_t sync_decode(const uint32_t* words, const DevHuff* tabs,
                                const Geom& g, const Lane& L, uint64_t st,
                                int* nblocks) {
    int pos = L.start, blk = 0, k = 0;
    if (st != kErr) {
        pos = static_cast<int>(st >> 16);
        blk = static_cast<int>((st >> 8) & 0xFF);
        k = static_cast<int>(st & 0xFF);
    }
    int n = 0;
    bool err = false;
    Reader rd(words, L.word0, pos);
    while (pos < L.end) {
        const uint32_t bits = rd.peek(pos);
        const DevHuff* t = tabs + 2 * (g.sched[blk] & 15) + (k > 0);
        int len;
        const int sym = huff(t, bits, &len);
        if (sym < 0 || (k == 0 && sym > 15)) {
            err = true;
            break;
        }
        if (k == 0) {
            pos += len + sym;
            k = 1;
            n++;
            continue;
        }
        const int r = sym >> 4, s = sym & 15;
        pos += len + s;
        if (s) {
            k += r;
            if (k > 63) {
                err = true;
                break;
            }
            k++;
        } else {
            k = r == 15 ? k + 16 : 64;
        }
        if (k >= 64) {
            k = 0;
            blk = blk + 1 == g.bpm ? 0 : blk + 1;
        }
    }
    *nblocks = n;
    return err ? kErr : pack(pos, blk, k);
}

__device__ __forceinline__ void flag(int* status, int img) {
    status[img] = 1;
}

// The destination of block `cur` (absolute, in decode order) of image img,
// or nullptr where decode_mcus stores nothing (outside the window, or a
// pad block past the component's true size).
__device__ int16_t* block_dst(const Geom& g, int16_t* const* dst, int img,
                              int cur, int blk) {
    const int sc = g.sched[blk];
    const int c = sc & 15;
    const int m = cur / g.bpm;
    const int bx = (m % g.mcus_x) * g.h[c] + ((sc >> 4) & 15);
    const int by = (m / g.mcus_x) * g.v[c] + (sc >> 8);
    if (bx < g.wx0[c] || bx >= g.wx0[c] + g.ww[c] || by < g.wy0[c] ||
        by >= g.wy0[c] + g.wh[c] || bx >= g.bw[c] || by >= g.bh[c])
        return nullptr;
    return dst[c] +
           ((static_cast<int64_t>(img) * g.wh[c] + (by - g.wy0[c])) *
                g.ww[c] +
            (bx - g.wx0[c])) *
               64;
}

__global__ void __launch_bounds__(kThreads)
    sync_init_kernel(const uint32_t* words, const int* seg,
                     const int* sub_start, int nseg, int nsub,
                     const DevHuff* tables, const Geom g, int n_bits,
                     uint64_t* g_out, uint64_t* g_in, int* g_cnt) {
    __shared__ uint64_t s_out[kThreads];
    const int tid = threadIdx.x;
    const int t = blockIdx.x * kThreads + tid;
    const bool active = t < nsub;
    Lane L{};
    if (active) L = lane_of(seg, sub_start, nseg, t, n_bits);
    const bool live = active && !L.last;
    const DevHuff* tabs = tables + 2 * g.ncomp * L.img;
    uint64_t in = L.first ? 0 : kErr, out = kErr;
    int n = 0;
    if (live) out = sync_decode(words, tabs, g, L, in, &n);
    s_out[tid] = out;
    __syncthreads();
    for (;;) {
        bool ch = false;
        if (live && !L.first && tid > 0) {
            const uint64_t nin = s_out[tid - 1];
            if (nin != in) {
                in = nin;
                const uint64_t o = sync_decode(words, tabs, g, L, in, &n);
                ch = o != out;
                out = o;
            }
        }
        __syncthreads();
        s_out[tid] = out;
        if (!__syncthreads_or(ch)) break;
    }
    if (active) {
        g_out[t] = out;
        g_in[t] = in;
        g_cnt[t] = n;
    }
}

__global__ void __launch_bounds__(kThreads)
    sync_pass_kernel(const uint32_t* words, const int* seg,
                     const int* sub_start, int nseg, int nsub,
                     const DevHuff* tables, const Geom g, int n_bits,
                     uint64_t* g_out, uint64_t* g_in, int* g_cnt, int* flags,
                     int pass) {
    __shared__ uint64_t s_out[kThreads];
    __shared__ int s_go;
    if (pass > 0 && *(volatile int*)(flags + pass - 1) == 0) return;
    const int tid = threadIdx.x;
    const int t0 = blockIdx.x * kThreads;
    const int t = t0 + tid;
    const bool active = t < nsub;
    Lane L{};
    if (active) L = lane_of(seg, sub_start, nseg, t, n_bits);
    if (tid == 0) {
        s_go = !L.first && !L.last &&
               *(volatile uint64_t*)(g_out + t0 - 1) != g_in[t0];
    }
    __syncthreads();
    if (!s_go) return;
    const bool live = active && !L.last;
    const DevHuff* tabs = tables + 2 * g.ncomp * L.img;
    uint64_t in = kErr, out = kErr;
    int n = 0;
    if (active) {
        in = g_in[t];
        out = g_out[t];
        n = g_cnt[t];
    }
    const uint64_t out0 = out;
    if (tid == 0) {
        in = *(volatile uint64_t*)(g_out + t0 - 1);
        out = sync_decode(words, tabs, g, L, in, &n);
    }
    s_out[tid] = out;
    __syncthreads();
    for (;;) {
        bool ch = false;
        if (live && !L.first && tid > 0) {
            const uint64_t nin = s_out[tid - 1];
            if (nin != in) {
                in = nin;
                const uint64_t o = sync_decode(words, tabs, g, L, in, &n);
                ch = o != out;
                out = o;
            }
        }
        __syncthreads();
        s_out[tid] = out;
        if (!__syncthreads_or(ch)) break;
    }
    if (active) {
        g_out[t] = out;
        g_in[t] = in;
        g_cnt[t] = n;
        // the next CUDA block starts from this state: look again
        if (tid == kThreads - 1 && live && out != out0) flags[pass] = 1;
    }
}

__global__ void __launch_bounds__(kThreads)
    write_kernel(const uint32_t* words, const int* seg, const int* sub_start,
                 int nseg, int nsub, const DevHuff* tables, const Geom g,
                 int n_bits, const uint64_t* g_out, const int* g_cnt,
                 const int* first, int16_t* diff, int16_t* y, int16_t* cb,
                 int16_t* cr, int* status) {
    const int t = blockIdx.x * kThreads + threadIdx.x;
    if (t >= nsub) return;
    const Lane L = lane_of(seg, sub_start, nseg, t, n_bits);
    const uint64_t st = L.first ? 0 : g_out[t - 1];
    int cnt = L.blk0 + first[t] - first[L.sub0];
    const int nend = L.blk0 + L.nblk;
    const int kin = st == kErr ? 255 : static_cast<int>(st & 0xFF);
    if (cnt - (kin > 0) >= nend) return;  // trailing bits of the segment
    if (st == kErr) {
        flag(status, L.img);
        return;
    }
    int pos = static_cast<int>(st >> 16);
    int blk = static_cast<int>((st >> 8) & 0xFF);
    int k = kin;
    int16_t* const dst[3] = {y, cb, cr};
    const DevHuff* tabs = tables + 2 * g.ncomp * L.img;
    int16_t* dimg = diff + static_cast<int64_t>(L.img) * g.nmcu * g.bpm;
    int16_t* bdst = k ? block_dst(g, dst, L.img, cnt - 1, blk) : nullptr;
    int n = 0;
    Reader rd(words, L.word0, pos);
    for (;;) {
        if (k == 0 && cnt == nend) {
            if (pos > L.bits) flag(status, L.img);
            return;
        }
        if (!L.last && pos >= L.end) {
            if (pack(pos, blk, k) != g_out[t] || n != g_cnt[t])
                flag(status, L.img);
            return;
        }
        const uint32_t bits = rd.peek(pos);
        const DevHuff* tb = tabs + 2 * (g.sched[blk] & 15) + (k > 0);
        int len;
        const int sym = huff(tb, bits, &len);
        if (sym < 0) break;
        if (k == 0) {
            if (sym > 15) break;
            pos += len + sym;
            if (pos > L.bits) break;
            dimg[cnt] = static_cast<int16_t>(extend(bits, len, sym));
            bdst = block_dst(g, dst, L.img, cnt, blk);
            cnt++;
            n++;
            k = 1;
            continue;
        }
        const int r = sym >> 4, s = sym & 15;
        pos += len + s;
        if (pos > L.bits) break;
        if (s) {
            k += r;
            if (k > 63) break;
            if (bdst)
                bdst[__ldg(&kNat[k])] = static_cast<int16_t>(extend(bits, len, s));
            k++;
        } else {
            k = r == 15 ? k + 16 : 64;
        }
        if (k >= 64) {
            k = 0;
            blk = blk + 1 == g.bpm ? 0 : blk + 1;
        }
    }
    flag(status, L.img);  // a real block failed to decode
}

// Segmented inclusive scan of the DC differences: one CUDA block per
// (image, component), each thread a run of the component's blocks in
// decode order; the prediction restarts at every restart segment.
__global__ void __launch_bounds__(kDcThreads)
    dc_kernel(const int16_t* diff, const int* img_ri, const Geom g,
              int16_t* y, int16_t* cb, int16_t* cr) {
    __shared__ int s_sum[kDcThreads];
    __shared__ int s_reset[kDcThreads];
    const int img = blockIdx.x, c = blockIdx.y, tid = threadIdx.x;
    const int ri = img_ri[img];
    if (ri < 0) return;
    int off = 0;
    for (int i = 0; i < c; i++) off += g.h[i] * g.v[i];
    const int hv = g.h[c] * g.v[c];
    const int total = g.nmcu * hv;
    const int chunk = (total + kDcThreads - 1) / kDcThreads;
    const int q0 = min(tid * chunk, total), q1 = min(q0 + chunk, total);
    const int16_t* d = diff + static_cast<int64_t>(img) * g.nmcu * g.bpm;
    int sum = 0, reset = 0;
    for (int q = q0; q < q1; q++) {
        const int m = q / hv, j = q - m * hv;
        if (j == 0 && (ri > 0 ? m % ri == 0 : m == 0)) {
            sum = 0;
            reset = 1;
        }
        sum += d[m * g.bpm + off + j];
    }
    s_sum[tid] = sum;
    s_reset[tid] = reset;
    __syncthreads();
    for (int step = 1; step < kDcThreads; step <<= 1) {
        int ps = 0, pr = 0;
        if (tid >= step) {
            ps = s_sum[tid - step];
            pr = s_reset[tid - step];
        }
        __syncthreads();
        if (tid >= step && !s_reset[tid]) {
            s_sum[tid] += ps;
            s_reset[tid] = pr;
        }
        __syncthreads();
    }
    int run = tid ? s_sum[tid - 1] : 0;
    int16_t* const dst[3] = {y, cb, cr};
    for (int q = q0; q < q1; q++) {
        const int m = q / hv, j = q - m * hv;
        if (j == 0 && (ri > 0 ? m % ri == 0 : m == 0)) run = 0;
        run += d[m * g.bpm + off + j];
        int16_t* b = block_dst(g, dst, img, m * g.bpm + off + j, off + j);
        if (b) b[0] = static_cast<int16_t>(run);
    }
}

}  // namespace

extern "C" {

// geom: a struct Geom (ops/entropy_kernels._Geom), by pointer; the C
// interface names no type of this file.
int lpt_huff_sync(const void* scan, const int* seg, const int* sub_start,
                  int nseg, int nsub, const void* tables, const void* geom,
                  int n_bits, void* out, void* in_used, int* cnt, int* flags,
                  int passes, cudaStream_t s) {
    const Geom* g = static_cast<const Geom*>(geom);
    const int grid = (nsub + kThreads - 1) / kThreads;
    const uint32_t* w = static_cast<const uint32_t*>(scan);
    const DevHuff* tb = static_cast<const DevHuff*>(tables);
    uint64_t* o = static_cast<uint64_t*>(out);
    uint64_t* in = static_cast<uint64_t*>(in_used);
    sync_init_kernel<<<grid, kThreads, 0, s>>>(w, seg, sub_start, nseg, nsub,
                                                tb, *g, n_bits, o, in, cnt);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    for (int p = 0; p < passes; p++) {
        sync_pass_kernel<<<grid, kThreads, 0, s>>>(w, seg, sub_start, nseg,
                                                    nsub, tb, *g, n_bits, o,
                                                    in, cnt, flags, p);
        e = cudaGetLastError();
        if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
}

int lpt_huff_write(const void* scan, const int* seg, const int* sub_start,
                   int nseg, int nsub, const void* tables, const void* geom,
                   int n_bits, const void* out, const int* cnt,
                   const int* first, void* diff, void* y, void* cb, void* cr,
                   int* status, cudaStream_t s) {
    const Geom* g = static_cast<const Geom*>(geom);
    const int grid = (nsub + kThreads - 1) / kThreads;
    write_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const uint32_t*>(scan), seg, sub_start, nseg, nsub,
        static_cast<const DevHuff*>(tables), *g, n_bits,
        static_cast<const uint64_t*>(out), cnt, first,
        static_cast<int16_t*>(diff), static_cast<int16_t*>(y),
        static_cast<int16_t*>(cb), static_cast<int16_t*>(cr), status);
    return cudaGetLastError();
}

int lpt_huff_dc(const void* diff, const int* img_ri, int batch,
                const void* geom, void* y, void* cb, void* cr,
                cudaStream_t s) {
    const Geom* g = static_cast<const Geom*>(geom);
    dc_kernel<<<dim3(batch, g->ncomp), kDcThreads, 0, s>>>(
        static_cast<const int16_t*>(diff), img_ri, *g,
        static_cast<int16_t*>(y), static_cast<int16_t*>(cb),
        static_cast<int16_t*>(cr));
    return cudaGetLastError();
}

const char* lpt_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
