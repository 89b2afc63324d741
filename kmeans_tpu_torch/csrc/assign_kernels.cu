// Hopper (sm_90a) counterparts of the two TPU kernels of
// kmeans_tpu/ops/pallas_kernels.py:
//
//   assign_kernel               replaces  pallas_assign
//                               (_call(with_stats=False) -> kernel_assign)
//   fused_assign_reduce_kernel  replaces  fused_assign_reduce
//                               (_call(with_stats=True) -> kernel_pipe)
//   reduce_partials_kernel      second pass of the fused kernel (the TPU
//                               kernel carried its sums across a sequential
//                               grid; blocks on a GPU share no such carry);
//                               in assign_common.cuh, shared with the bf16
//                               kernels of assign_bf16.cu
//   half_sqnorm_kernel          h_k = 0.5 * ||c_k||^2, which the JAX package
//                               computed outside its kernel (_pad_inputs)
//
// What they compute, for x (n, D), c (k, D), w (n,), all float32:
//
//   score_ik = h_k - x_i . c_k
//   label_i  = the lowest k among the minima of score_i.  A row that has a
//              NaN score gets label 0 and the minimum +inf, and so does a
//              row whose scores never go below +inf.
//   mind2_i  = max(2 * min_k score_ik + ||x_i||^2, 0), NaN kept   (optional)
//   sums_k   = sum over rows with label k and w_i != 0 of w_i * x_i
//   counts_k = sum over the same rows of w_i
//
// The (n, k) score matrix lives only in registers.
//
// What bounds the kernels on this card: operations.  The distances cost
// 2*n*k*D float32 operations outside the tensor cores (these kernels promise
// float32 products), while every input byte is read from device memory once:
// at D = 128, k = 1024 that is 2048 operations for each byte of x.  The
// scatter is n*D multiply-adds, a k-th of the distance work.
//
// What the design does about it: a register-tiled float32 product.  A block
// of 256 threads owns a tile of 128 rows, walks the centroids in tiles of
// 128 and the features in slices of 16 through shared memory, and each thread
// keeps an 8 x 8 tile of dot products in registers, so one shared-memory read
// feeds eight multiply-adds.  The next slice is fetched into registers while
// the current one is multiplied.  Centroids (k*D*4 bytes) stay in the L2
// cache and x is read from device memory once per tile of rows.
//
// The segmented sum is deterministic.  Every block of the fused kernel is
// persistent, takes the row tiles  blockIdx, blockIdx + gridDim, ...  in
// order, and adds into a table of its own, (k, D + 1) floats, whose last
// column holds the counts.  Inside a block one thread owns each (column,
// label class) pair and walks the rows of the tile in order, so every table
// entry is written by one thread in a fixed order: the additions need no
// locks and give the same bits in every run.  reduce_partials_kernel then
// sums the tables in block order.
//
// Compile-time variants (the variant lab, experiments/exp_pallas_kernel.py,
// builds them with -D): KM_TILE_K, the centroids of a tile (128 or 64), and
// KM_PIPE, 1 to fetch the next slice into registers while the current one is
// multiplied, 0 to fetch it just before it is stored (load, barrier,
// multiply).  KM_TILE_N, the rows of a block's tile, is 128 only.  The
// defaults below are the main path's build.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "assign_common.cuh"

#ifndef KM_TILE_N
#define KM_TILE_N 128
#endif
#ifndef KM_TILE_K
#define KM_TILE_K 128
#endif
#ifndef KM_PIPE
#define KM_PIPE 1
#endif

namespace {

constexpr int BM = KM_TILE_N;  // rows of x in a block's tile
constexpr int BN = KM_TILE_K;  // centroids in a tile
constexpr bool PIPE = KM_PIPE != 0;
constexpr int BK = 16;         // features in a slice
constexpr int THREADS = 256;   // 16 x 16 threads, 8 x CN results each
constexpr int CN = BN / 16;    // centroids of a tile that one thread holds
constexpr int LDX = BM + 4;    // row strides of a slice in shared memory
constexpr int LDC = BN + 4;
static_assert(BM == 128, "KM_TILE_N: the float32 kernels take 128 rows");
static_assert(BN == 128 || BN == 64, "KM_TILE_K: 128 or 64 centroids");
static_assert(KM_PIPE == 0 || KM_PIPE == 1, "KM_PIPE: 0 or 1");

struct Slice {                 // what one thread fetches of one slice
    float4 x[2];
    float4 c[BN / 64];
};

template <bool VEC4>
__device__ __forceinline__ void fetch_slice(Slice& s,
                                            const float* __restrict__ x,
                                            const float* __restrict__ c,
                                            long long row0, long long n,
                                            int c0, int k, int f0, int d) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int f = threadIdx.x + i * THREADS;   // 0 .. 511
        const int r = f >> 2;                      // 0 .. 127
        const int col = f0 + ((f & 3) << 2);
        s.x[i] = load4<VEC4>(x, row0 + r, n, col, d);
        if (i < BN / 64)
            s.c[i] = load4<VEC4>(c, (long long)c0 + r, (long long)k, col, d);
    }
}

__device__ __forceinline__ void store_slice(const Slice& s,
                                            float (*xs)[LDX],
                                            float (*cs)[LDC]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int f = threadIdx.x + i * THREADS;
        const int r = f >> 2;
        const int q = (f & 3) << 2;
        xs[q + 0][r] = s.x[i].x; xs[q + 1][r] = s.x[i].y;
        xs[q + 2][r] = s.x[i].z; xs[q + 3][r] = s.x[i].w;
        if (i < BN / 64) {
            cs[q + 0][r] = s.c[i].x; cs[q + 1][r] = s.c[i].y;
            cs[q + 2][r] = s.c[i].z; cs[q + 3][r] = s.c[i].w;
        }
    }
}

// Labels (and the minimum score) of the rows  row0 .. row0 + BM - 1.
// Thread (tx, ty) holds rows  ty*4 + {0..3}  and  64 + ty*4 + {0..3}  and,
// of every centroid tile, the columns  tx*4 + {0..3}  and (at BN = 128)
// 64 + tx*4 + {0..3}.
// On return best_v/best_i hold the result of the thread's eight rows, the
// same in all sixteen threads that share them.
template <bool VEC4>
__device__ __forceinline__ void assign_tile(const float* __restrict__ x,
                                            const float* __restrict__ c,
                                            const float* __restrict__ h,
                                            long long row0, long long n,
                                            int d, int k,
                                            float (*xs)[LDX], float (*cs)[LDC],
                                            float* hs,
                                            float best_v[8], int best_i[8]) {
    const int tx = threadIdx.x & 15;
    const int ty = threadIdx.x >> 4;
    unsigned bad = 0;                  // bit i: row i met a NaN score
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        best_v[i] = CUDART_INF_F;      // the running pair starts at (+inf, 0)
        best_i[i] = 0;
    }
    const int slices = (d + BK - 1) / BK;

    for (int c0 = 0; c0 < k; c0 += BN) {
        float acc[8][CN];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < CN; ++j) acc[i][j] = 0.f;

        __syncthreads();               // the previous tile is done with hs
        if (threadIdx.x < BN) {
            const int col = c0 + threadIdx.x;
            hs[threadIdx.x] = col < k ? h[col] : CUDART_INF_F;
        }

        Slice next;
        if (PIPE) fetch_slice<VEC4>(next, x, c, row0, n, c0, k, 0, d);
        for (int s = 0; s < slices; ++s) {
            if (!PIPE)
                fetch_slice<VEC4>(next, x, c, row0, n, c0, k, s * BK, d);
            __syncthreads();           // the previous slice has been read
            store_slice(next, xs, cs);
            __syncthreads();
            if (PIPE && s + 1 < slices)
                fetch_slice<VEC4>(next, x, c, row0, n, c0, k,
                                  (s + 1) * BK, d);
#pragma unroll
            for (int kk = 0; kk < BK; ++kk) {
                const float4 a0 =
                    *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
                const float4 a1 =
                    *reinterpret_cast<const float4*>(&xs[kk][64 + ty * 4]);
                const float a[8] = {a0.x, a0.y, a0.z, a0.w,
                                    a1.x, a1.y, a1.z, a1.w};
                float b[CN];
#pragma unroll
                for (int q = 0; q < CN / 4; ++q) {
                    const float4 bq = *reinterpret_cast<const float4*>(
                        &cs[kk][q * 64 + tx * 4]);
                    b[q * 4 + 0] = bq.x; b[q * 4 + 1] = bq.y;
                    b[q * 4 + 2] = bq.z; b[q * 4 + 3] = bq.w;
                }
#pragma unroll
                for (int i = 0; i < 8; ++i)
#pragma unroll
                    for (int j = 0; j < CN; ++j)
                        acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
            }
        }

        // This tile's minimum of each row: first over the thread's own
        // columns in rising order, then over the sixteen threads of the row.
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            float v = CUDART_INF_F;
            int idx = NO_INDEX;
            bool nan = false;
#pragma unroll
            for (int j = 0; j < CN; ++j) {
                const int lc = (j >> 2) * 64 + tx * 4 + (j & 3);
                const float sc = hs[lc] - acc[i][j];
                nan |= (sc != sc);
                if (sc < v) { v = sc; idx = c0 + lc; }
            }
#pragma unroll
            for (int off = 8; off >= 1; off >>= 1) {
                const float ov = __shfl_xor_sync(0xffffffffu, v, off);
                const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
                const int on = __shfl_xor_sync(0xffffffffu, (int)nan, off);
                take_min(v, idx, ov, oi);
                nan |= (on != 0);
            }
            bad |= (unsigned)nan << i;
            // Strict: an earlier tile keeps a tie.
            if (v < best_v[i]) { best_v[i] = v; best_i[i] = idx; }
        }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
        if (bad & (1u << i)) { best_v[i] = CUDART_INF_F; best_i[i] = 0; }
}

// Writes the labels (and mind2) of a tile; with KEEP also leaves the labels
// in lab_s for the scatter.
template <bool KEEP>
__device__ __forceinline__ void write_tile(const float best_v[8],
                                           const int best_i[8],
                                           long long row0, long long n,
                                           const float* x2s,
                                           int* __restrict__ labels,
                                           float* __restrict__ mind2,
                                           int* lab_s) {
    const int tx = threadIdx.x & 15;
    const int ty = threadIdx.x >> 4;
    if (tx != 0) return;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int r = (i < 4) ? ty * 4 + i : 64 + ty * 4 + (i - 4);
        const long long row = row0 + r;
        if (KEEP) lab_s[r] = best_i[i];
        if (row < n) {
            labels[row] = best_i[i];
            if (mind2 != nullptr) {
                float m = 2.f * best_v[i] + x2s[r];
                m = (m < 0.f) ? 0.f : m;       // a NaN stays a NaN
                mind2[row] = m;
            }
        }
    }
}

template <bool VEC4>
__global__ void __launch_bounds__(THREADS, 2)
assign_kernel(const float* __restrict__ x, const float* __restrict__ c,
              const float* __restrict__ h, int* __restrict__ labels,
              float* __restrict__ mind2, long long n, int d, int k) {
    __shared__ __align__(16) float xs[BK][LDX];
    __shared__ __align__(16) float cs[BK][LDC];
    __shared__ float hs[BN];
    __shared__ float x2s[BM];
    const long long tiles = (n + BM - 1) / BM;
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
        const long long row0 = t * BM;
        float best_v[8];
        int best_i[8];
        assign_tile<VEC4>(x, c, h, row0, n, d, k, xs, cs, hs, best_v, best_i);
        if (mind2 != nullptr) {
            row_sqnorms<BM, THREADS>(x, row0, n, d, x2s);
            __syncthreads();
        }
        write_tile<false>(best_v, best_i, row0, n, x2s, labels, mind2,
                          nullptr);
        __syncthreads();               // x2s is free for the next tile
    }
}

template <bool VEC4>
__global__ void __launch_bounds__(THREADS, 2)
fused_assign_reduce_kernel(const float* __restrict__ x,
                           const float* __restrict__ w,
                           const float* __restrict__ c,
                           const float* __restrict__ h,
                           int* __restrict__ labels,
                           float* __restrict__ mind2,
                           float* __restrict__ partial,
                           long long n, int d, int k) {
    __shared__ __align__(16) float xs[BK][LDX];
    __shared__ __align__(16) float cs[BK][LDC];
    __shared__ float hs[BN];
    __shared__ float x2s[BM];
    __shared__ float ws[BM];
    __shared__ int lab_s[BM];

    const int dp = d + 1;              // the last column holds the counts
    float* table = partial + (size_t)blockIdx.x * (size_t)k * (size_t)dp;
    // One thread for each (column, label class) pair: with `groups` classes,
    // class g takes the rows whose label is g modulo `groups`, so no two
    // threads ever add into the same entry of the table.
    const int groups = dp >= THREADS ? 1 : THREADS / dp;
    const int cols = dp >= THREADS ? THREADS : dp;
    const int group = threadIdx.x / cols;
    const int col0 = threadIdx.x % cols;

    const long long tiles = (n + BM - 1) / BM;
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
        const long long row0 = t * BM;
        float best_v[8];
        int best_i[8];
        assign_tile<VEC4>(x, c, h, row0, n, d, k, xs, cs, hs, best_v, best_i);
        if (mind2 != nullptr) row_sqnorms<BM, THREADS>(x, row0, n, d, x2s);
        if (threadIdx.x < BM) {
            const long long row = row0 + threadIdx.x;
            ws[threadIdx.x] = row < n ? w[row] : 0.f;
        }
        __syncthreads();
        write_tile<true>(best_v, best_i, row0, n, x2s, labels, mind2, lab_s);
        __syncthreads();

        if (group < groups) {
            for (int r = 0; r < BM; ++r) {
                const float wr = ws[r];
                if (wr == 0.f) continue;           // zero-weight rows: inert
                const int lab = lab_s[r];
                if (lab % groups != group) continue;
                const float* xr = x + (row0 + r) * (long long)d;
                float* out = table + (size_t)lab * (size_t)dp;
                for (int col = col0; col < dp; col += cols) {
                    const float v = col < d ? wr * xr[col] : wr;
                    // One thread owns this entry, so the additions arrive in
                    // program order; the hardware add spares the round trip
                    // of a load and a store.
                    atomicAdd(out + col, v);
                }
            }
        }
        __syncthreads();               // ws and lab_s are free again
    }
}

// h_k = 0.5 * ||c_k||^2, one warp for each centroid.
__global__ void half_sqnorm_kernel(const float* __restrict__ c,
                                   float* __restrict__ h, int d, int k) {
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (row >= k) return;
    const float* p = c + (size_t)row * (size_t)d;
    float s = 0.f;
    for (int col = lane; col < d; col += 32) s = fmaf(p[col], p[col], s);
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) h[row] = 0.5f * s;
}

int launch_half_sqnorm(const float* c, float* h, int d, int k,
                       cudaStream_t stream) {
    const int warps = 8;
    half_sqnorm_kernel<<<(k + warps - 1) / warps, warps * 32, 0, stream>>>(
        c, h, d, k);
    return (int)cudaGetLastError();
}

}  // namespace

// Rows of a block's tile; the wrapper sizes its grid by it.
extern "C" int kmeans_tile_rows(void) { return BM; }

// Bytes of the launchers' scratch: h, k floats.
extern "C" long long kmeans_scratch_bytes(int d, int k) {
    (void)d;
    return 4LL * k;
}

// Both launchers enqueue on `stream`, do not synchronise, and return the
// first cudaError_t that a launch reported, 0 if none did.  `h` is the
// scratch of kmeans_scratch_bytes.  `mind2` may be null: then no minimum
// distance is computed or written.  `blocks` is the number of persistent
// blocks, at least 1.

extern "C" int kmeans_assign_launch(const float* x, const float* c, float* h,
                                    int* labels, float* mind2, long long n,
                                    int d, int k, int blocks, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    int err = launch_half_sqnorm(c, h, d, k, st);
    if (err != 0) return err;
    const bool vec4 = (d % 4 == 0) && aligned16(x) && aligned16(c);
    if (vec4)
        assign_kernel<true><<<blocks, THREADS, 0, st>>>(x, c, h, labels,
                                                        mind2, n, d, k);
    else
        assign_kernel<false><<<blocks, THREADS, 0, st>>>(x, c, h, labels,
                                                         mind2, n, d, k);
    return (int)cudaGetLastError();
}

// `partial` is scratch of blocks * k * (d + 1) floats and must be zero.
extern "C" int kmeans_fused_assign_reduce_launch(
        const float* x, const float* w, const float* c, float* h, int* labels,
        float* mind2, float* partial, float* sums, float* counts,
        long long n, int d, int k, int blocks, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    int err = launch_half_sqnorm(c, h, d, k, st);
    if (err != 0) return err;
    const bool vec4 = (d % 4 == 0) && aligned16(x) && aligned16(c);
    if (vec4)
        fused_assign_reduce_kernel<true><<<blocks, THREADS, 0, st>>>(
            x, w, c, h, labels, mind2, partial, n, d, k);
    else
        fused_assign_reduce_kernel<false><<<blocks, THREADS, 0, st>>>(
            x, w, c, h, labels, mind2, partial, n, d, k);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
    return launch_reduce_partials(partial, sums, counts, blocks, d, k, st);
}
