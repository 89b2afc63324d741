// Hopper (sm_90a) counterpart of the fused diagonal-GMM E-step kernel of
// experiments/exp_gmm_estep_pallas.py:
//
//   estep_kernel         replaces  pallas_estep (_kernel; pl.pallas_call :178)
//   estep_tables_kernel  the per-component tables that pallas_estep built
//                        outside its kernel ([b, -a/2] and c1)
//   estep_reduce_kernel  second pass: adds the blocks' tables in block order
//                        (the TPU kernel carried its sums across a sequential
//                        grid; blocks on a GPU share no such carry)
//
// What they compute, for x (n, D), w (n,), shift (D,), means_c and inv_var
// (k, D), log_det and log_weights (k,), all float32, with x_c = x - shift
// formed in registers (no centered copy of the data is made):
//
//   a = inv_var, b = means_c * a,
//   c1_k    = log_weights_k - 0.5 (D log 2pi + log_det_k + sum_d means_c b)
//   logp_ik = [x_c, x_c^2]_i . [b, -a/2]_k + c1_k          (depth 2D)
//   m_i = max_k logp_ik,  s_i = sum_k exp(logp_ik - m_i),  lse_i = m_i + log s_i
//   r_ik    = exp(logp_ik - m_i) w_i / s_i, and 0 for a row of weight 0
//   rsum_k  = sum_i r_ik,  s1_kd = sum_i r_ik x_c,  s2_kd = sum_i r_ik x_c^2
//   ll      = sum over rows with w_i > 0 of w_i lse_i
//
// The (n, k) log-densities and responsibilities never reach device memory.
// Products are plain float32 FMAs (no TF32, no bf16): the M-step's variance
// is S2/R - mu^2, which survives only with full float32 moments.
//
// What bounds the kernel on this card: operations.  Per row and component it
// does a depth-2D product for logp and a depth-2D moment product, 8 n k D
// float32 operations outside the tensor cores (plus the recomputed logp
// tiles, below), against 4 n D bytes of x read: about 500 operations per
// byte at k = 256.
//
// What the design does about it: the same register-tiled float32 product as
// assign_kernels.cu, used for both products.  A block of 256 threads owns a
// tile of 128 rows; each thread keeps an 8 x 8 tile of results in registers,
// and features and coefficients go through shared memory in slices of 16.
// Per row tile:
//
//   1. for every tile of 128 components: the logp tile, then an online max
//      and sum per row (rescaled on a new max), so that the normaliser covers
//      all k components at any k in bounded shared memory;
//   2. for every tile of 128 components: the logp tile is turned into
//      responsibilities in a (128 x 128) tile of shared memory and
//      multiplied into the moments: (components x rows) . (rows x [x_c,
//      x_c^2]), 128 feature columns at a time; rsum is a column sum of the
//      responsibility tile.  The last component tile of step 1 is still in
//      registers and goes first; every other tile is recomputed (the same
//      FMAs in the same order, so the same bits).
//
// Recomputing costs 4 n D (k - 128) operations more than keeping every logp
// tile (half the logp work at k = 256, none at k <= 128); it keeps shared
// memory bounded at every k (k = 3000 needs no other path).
//
// The sums are deterministic.  Every block is persistent, takes the row
// tiles blockIdx, blockIdx + gridDim, ... in order and adds into a table of
// its own, (k, 2D + 1) floats: the s1 columns, the s2 columns and rsum.  One
// thread owns each entry of a (component tile, column tile) pair, so every
// entry is written by one thread in a fixed order.  ll is summed per tile in
// row order and per block in tile order, in double.  estep_reduce_kernel adds
// the tables and the ll partials in block order: two runs give the same bits.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BM = 128;        // rows of a tile; also components of a tile
constexpr int BK = 16;         // depth of a slice
constexpr int THREADS = 256;   // 16 x 16 threads, 8 x 8 results each
constexpr int LDS = BM + 4;    // row stride of a slice / of the resp. tile
constexpr float LOG_2PI = 1.8378770664093453f;
constexpr int RESP_BYTES = BM * LDS * 4;   // dynamic shared memory

// Row (or column) of the tile that result i of a thread stands for.
__device__ __forceinline__ int lane_index(int i, int t) {
    return i < 4 ? t * 4 + i : 64 + t * 4 + (i - 4);
}

// acc[i][j] += sum over one slice of As[kk][row i] * Bs[kk][column j].
__device__ __forceinline__ void mul_slice(const float (*As)[LDS],
                                          const float (*Bs)[LDS],
                                          float acc[8][8]) {
    const int tx = threadIdx.x & 15;
    const int ty = threadIdx.x >> 4;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
}

// logp of rows row0.. against components c0.. (not masked beyond k):
// acc[i][j] for row lane_index(i, ty), component lane_index(j, tx).  c1 is
// added last, after the depth-2D product.
__device__ __forceinline__ void logp_tile(const float* __restrict__ x,
                                          const float* __restrict__ shift,
                                          const float* __restrict__ coef,
                                          const float* __restrict__ c1,
                                          long long row0, long long n,
                                          int c0, int k, int d,
                                          float (*As)[LDS], float (*Bs)[LDS],
                                          float* c1s, float acc[8][8]) {
    const int fd = 2 * d;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    const int slices = (fd + BK - 1) / BK;
    // Thread t fetches feature column f0 + (t & 15) of the rows (and the
    // components) (t >> 4) + 16 i, i = 0 .. 7.
    const int q = threadIdx.x & 15;
    const int r0 = threadIdx.x >> 4;
    float na[8], nb[8];
    auto fetch = [&](int f0) {
        const int f = f0 + q;
        const int col = f < d ? f : f - d;          // column of x
        const bool square = f >= d;
        const bool real = f < fd;
        const float sh = real ? shift[col] : 0.f;
        const float* xp = x + (row0 + r0) * (long long)d + col;
        const float* cp = coef + (size_t)(c0 + r0) * fd + f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const long long row = row0 + r0 + 16 * i;
            float v = (real && row < n) ? xp[(long long)16 * i * d] - sh
                                        : 0.f;
            na[i] = square ? v * v : v;
            const int c = c0 + r0 + 16 * i;
            nb[i] = (real && c < k) ? cp[(size_t)16 * i * fd] : 0.f;
        }
    };
    for (int s = 0; s < slices; ++s) {
        // The loads are issued before the barrier and land while slower
        // threads finish the previous slice; the registers they fill are
        // free again during the product.  (Fetching the next slice across
        // the product instead kept them live there: it spilled registers
        // under the cap of two blocks per SM and ran slower.)
        fetch(s * BK);
        __syncthreads();               // the previous slice has been read
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            As[q][r0 + 16 * i] = na[i];
            Bs[q][r0 + 16 * i] = nb[i];
        }
        // c1s is rewritten only here: every read of the previous tile's
        // came before the barrier above.
        if (s == 0 && threadIdx.x < BM)
            c1s[threadIdx.x] = c0 + threadIdx.x < k ? c1[c0 + threadIdx.x]
                                                    : 0.f;
        __syncthreads();
        mul_slice(As, Bs, acc);
    }
    const int tx = threadIdx.x & 15;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const float cj = c1s[lane_index(j, tx)];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i][j] += cj;
    }
}

// Moments of one (component tile, column tile): acc[i][j] = sum over the
// tile's rows of resp[row][component lane_index(i, ty)] *
// F[row][col0 + lane_index(j, tx)], F = [x_c, x_c^2] and 0 for rows of
// weight 0 (or beyond n), so that they add nothing, not even a NaN.
__device__ __forceinline__ void moment_tile(const float* __restrict__ x,
                                            const float* __restrict__ shift,
                                            const float* ws, long long row0,
                                            int d, int col0,
                                            const float* resp,
                                            float (*Bs)[LDS],
                                            float acc[8][8]) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    // Thread t fetches feature column col0 + (t & 127) of the tile rows
    // s * 16 + (t >> 7) + 2 i, i = 0 .. 7.
    const int j = threadIdx.x & 127;
    const int r0 = threadIdx.x >> 7;
    const int f = col0 + j;
    const int col = f < d ? f : f - d;
    const bool square = f >= d;
    const bool real = f < 2 * d;
    const float sh = real ? shift[col] : 0.f;
    const float* xp = x + row0 * (long long)d + col;
    float nb[8];
    auto fetch = [&](int s) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int r = s * BK + r0 + 2 * i;
            const float v = (real && ws[r] != 0.f)
                ? xp[(long long)r * d] - sh : 0.f;
            nb[i] = square ? v * v : v;
        }
    };
    for (int s = 0; s < BM / BK; ++s) {
        fetch(s);                      // as in logp_tile
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 8; ++i) Bs[r0 + 2 * i][j] = nb[i];
        __syncthreads();
        mul_slice(reinterpret_cast<const float (*)[LDS]>(resp + s * BK * LDS),
                  Bs, acc);
    }
}

// Step 2 for one component tile whose logp is in acc: responsibilities into
// resp, then the moments and rsum into the block's table.
__device__ __forceinline__ void add_moments(const float* __restrict__ x,
                                            const float* __restrict__ shift,
                                            const float* ws,
                                            const float* row_m,
                                            const float* row_scale,
                                            long long row0, int c0, int k,
                                            int d, float* resp,
                                            float (*Bs)[LDS], float* table,
                                            float acc[8][8]) {
    const int tx = threadIdx.x & 15;
    const int ty = threadIdx.x >> 4;
    const int fd = 2 * d;
    const int width = fd + 1;          // table row: s1, s2, rsum
    __syncthreads();                   // resp and Bs have been read
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int r = lane_index(i, ty);
        const bool live = ws[r] != 0.f;
        const float mr = row_m[r];
        const float sc = row_scale[r];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int c = lane_index(j, tx);
            resp[r * LDS + c] = (live && c0 + c < k)
                ? expf(acc[i][j] - mr) * sc : 0.f;
        }
    }
    for (int col0 = 0; col0 < fd; col0 += BM) {
        // moment_tile's first barrier publishes resp.
        moment_tile(x, shift, ws, row0, d, col0, resp, Bs, acc);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int c = c0 + lane_index(i, ty);
            if (c >= k) continue;
            float* out = table + (size_t)c * width;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int col = col0 + lane_index(j, tx);
                if (col < fd) out[col] += acc[i][j];
            }
        }
    }
    // rsum: one thread per component sums its column in row order (resp is
    // complete: moment_tile's barriers came after its writes).
    if (threadIdx.x < BM && c0 + threadIdx.x < k) {
        float s = 0.f;
        for (int r = 0; r < BM; ++r) s += resp[r * LDS + threadIdx.x];
        table[(size_t)(c0 + threadIdx.x) * width + fd] += s;
    }
}

__global__ void __launch_bounds__(THREADS, 2)
estep_kernel(const float* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ shift, const float* __restrict__ coef,
             const float* __restrict__ c1, float* __restrict__ partial,
             double* __restrict__ ll_partial, long long n, int d, int k) {
    __shared__ __align__(16) float As[BK][LDS];
    __shared__ __align__(16) float Bs[BK][LDS];
    __shared__ float c1s[BM];
    __shared__ float ws[BM];
    __shared__ float row_m[BM];        // running max_k logp of each row
    __shared__ float row_s[BM];        // running sum_k exp(logp - max)
    __shared__ float row_scale[BM];    // w / sum
    __shared__ float row_ll[BM];       // w lse, 0 for rows of weight 0
    extern __shared__ __align__(16) float resp[];   // BM x LDS

    const int tx = threadIdx.x & 15;
    const int ty = threadIdx.x >> 4;
    float* table =
        partial + (size_t)blockIdx.x * (size_t)k * (size_t)(2 * d + 1);
    const int last = (k - 1) / BM * BM;    // the last component tile
    double ll = 0.0;

    const long long tiles = (n + BM - 1) / BM;
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
        const long long row0 = t * BM;
        // Safe: every read of ws and row_* by the previous tile came before
        // a barrier that all threads have passed.  Row r's running max and
        // sum belong to the thread with tx == 0 of its row group.
        if (threadIdx.x < BM) {
            const long long row = row0 + threadIdx.x;
            ws[threadIdx.x] = row < n ? w[row] : 0.f;
        }
        if (tx == 0) {
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                row_m[lane_index(i, ty)] = -CUDART_INF_F;
                row_s[lane_index(i, ty)] = 0.f;
            }
        }

        // 1. Online max and sum over all components, tile by tile.
        float acc[8][8];
        for (int c0 = 0; c0 < k; c0 += BM) {
            logp_tile(x, shift, coef, c1, row0, n, c0, k, d, As, Bs, c1s,
                      acc);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                float tm = -CUDART_INF_F;
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    if (c0 + lane_index(j, tx) < k && acc[i][j] > tm)
                        tm = acc[i][j];
#pragma unroll
                for (int off = 8; off >= 1; off >>= 1)
                    tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, off));
                float ts = 0.f;
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    if (c0 + lane_index(j, tx) < k && tm > -CUDART_INF_F)
                        ts += expf(acc[i][j] - tm);
#pragma unroll
                for (int off = 8; off >= 1; off >>= 1)
                    ts += __shfl_xor_sync(0xffffffffu, ts, off);
                if (tx == 0) {
                    const int r = lane_index(i, ty);
                    const float m = row_m[r];
                    if (tm > m) {
                        row_s[r] = row_s[r] * expf(m - tm) + ts;
                        row_m[r] = tm;
                    } else if (tm > -CUDART_INF_F) {
                        row_s[r] += ts * expf(tm - m);
                    }
                }
            }
        }
        if (tx == 0) {
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const int r = lane_index(i, ty);
                const float wr = ws[r];
                const float sr = row_s[r];
                row_scale[r] = wr / sr;
                row_ll[r] = wr > 0.f ? wr * (row_m[r] + logf(sr)) : 0.f;
            }
        }
        __syncthreads();
        if (threadIdx.x == 0) {
            double tile_ll = 0.0;
            for (int r = 0; r < BM; ++r) tile_ll += (double)row_ll[r];
            ll += tile_ll;
        }

        // 2. Responsibilities and moments: the last tile from registers,
        // the others recomputed.
        add_moments(x, shift, ws, row_m, row_scale, row0, last, k, d, resp,
                    Bs, table, acc);
        for (int c0 = 0; c0 < last; c0 += BM) {
            logp_tile(x, shift, coef, c1, row0, n, c0, k, d, As, Bs, c1s,
                      acc);
            add_moments(x, shift, ws, row_m, row_scale, row0, c0, k, d,
                        resp, Bs, table, acc);
        }
        __syncthreads();               // ws, row_* and resp are free again
    }
    if (threadIdx.x == 0) ll_partial[blockIdx.x] = ll;
}

// coef (k, 2D) = [b, -a/2] and c1 (k,), one warp for each component.
__global__ void estep_tables_kernel(const float* __restrict__ means_c,
                                    const float* __restrict__ inv_var,
                                    const float* __restrict__ log_det,
                                    const float* __restrict__ log_weights,
                                    float* __restrict__ coef,
                                    float* __restrict__ c1, int d, int k) {
    const int lane = threadIdx.x & 31;
    const int c = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (c >= k) return;
    const float* mu = means_c + (size_t)c * d;
    const float* a = inv_var + (size_t)c * d;
    float* out = coef + (size_t)c * 2 * d;
    float q = 0.f;
    for (int j = lane; j < d; j += 32) {
        const float b = mu[j] * a[j];
        out[j] = b;
        out[d + j] = -0.5f * a[j];
        q = fmaf(mu[j], b, q);
    }
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
        q += __shfl_xor_sync(0xffffffffu, q, off);
    if (lane == 0)
        c1[c] = log_weights[c] - 0.5f * ((float)d * LOG_2PI + log_det[c] + q);
}

// rsum (k,), s1 and s2 (k, D) and ll () from the blocks' partials, added in
// block order.  The thread after the last table entry sums ll.
__global__ void estep_reduce_kernel(const float* __restrict__ partial,
                                    const double* __restrict__ ll_partial,
                                    float* __restrict__ rsum,
                                    float* __restrict__ s1,
                                    float* __restrict__ s2,
                                    float* __restrict__ ll,
                                    int blocks, int d, int k) {
    const int width = 2 * d + 1;
    const size_t total = (size_t)k * (size_t)width;
    const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (e > total) return;
    if (e == total) {
        double acc = 0.0;
        for (int b = 0; b < blocks; ++b) acc += ll_partial[b];
        *ll = (float)acc;
        return;
    }
    float s = 0.f;
    for (int b = 0; b < blocks; ++b) s += partial[(size_t)b * total + e];
    const size_t c = e / width;
    const int col = (int)(e % width);
    if (col < d) s1[c * d + col] = s;
    else if (col < 2 * d) s2[c * d + (col - d)] = s;
    else rsum[c] = s;
}

}  // namespace

// Enqueues the three kernels on `stream`, does not synchronise, and returns
// the first cudaError_t that a launch reported, 0 if none did.  `coef` is
// scratch of k * 2d floats and `c1` of k floats, `partial` scratch of
// blocks * k * (2d + 1) floats that must be zero, `ll_partial` scratch of
// `blocks` doubles.  `blocks` is the number of persistent blocks, at least 1.
extern "C" int gmm_diag_estep_launch(
        const float* x, const float* w, const float* shift,
        const float* means_c, const float* inv_var, const float* log_det,
        const float* log_weights, float* coef, float* c1, float* partial,
        double* ll_partial, float* rsum, float* s1, float* s2, float* ll,
        long long n, int d, int k, int blocks, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int warps = 8;
    estep_tables_kernel<<<(k + warps - 1) / warps, warps * 32, 0, st>>>(
        means_c, inv_var, log_det, log_weights, coef, c1, d, k);
    int err = (int)cudaGetLastError();
    if (err != 0) return err;
    err = (int)cudaFuncSetAttribute(
        estep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        RESP_BYTES);
    if (err != 0) return err;
    estep_kernel<<<blocks, THREADS, RESP_BYTES, st>>>(
        x, w, shift, coef, c1, partial, ll_partial, n, d, k);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
    const size_t total = (size_t)k * (size_t)(2 * d + 1) + 1;
    const int rt = 256;
    estep_reduce_kernel<<<(unsigned)((total + rt - 1) / rt), rt, 0, st>>>(
        partial, ll_partial, rsum, s1, s2, ll, blocks, d, k);
    return (int)cudaGetLastError();
}
