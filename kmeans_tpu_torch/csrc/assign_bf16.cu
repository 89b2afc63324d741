// Hopper (sm_90a) counterparts of the bf16 variant of the two TPU kernels of
// kmeans_tpu/ops/pallas_kernels.py (bf16=True, which the JAX package's
// distance_mode='pallas_bf16' selects):
//
//   assign_bf16_kernel               replaces  pallas_assign(..., bf16=True)
//                                              (pallas_kernels.py:542)
//   fused_assign_reduce_bf16_kernel  replaces  fused_assign_reduce(...,
//                                              bf16=True)  (:558)
//   reduce_partials_kernel           second pass of the fused kernel
//                                    (assign_common.cuh)
//   prep_centroids_kernel            h_k = 0.5 * ||c_k||^2 from the unrounded
//                                    centroids, and bf16(c) zero-padded to a
//                                    multiple of 16 features
//
// What they compute, for x (n, D), c (k, D), w (n,), all float32:
//
//   xb = bf16_rn(x), cb = bf16_rn(c)       (round to nearest even)
//   score_ik = h_k - sum_d xb_id * cb_kd   the products are exact, the sum is
//              float32 on the tensor cores, h is subtracted in float32 in the
//              epilogue (it never rides through the product)
//   label_i  = the lowest k among the minima of score_i; a row with a NaN
//              score gets label 0 and the minimum +inf, and so does a row
//              whose scores never go below +inf
//   mind2_i  = max(2 * min_k score_ik + ||x_i||^2, 0), NaN kept, with
//              ||x_i||^2 from the unrounded row                (optional)
//   sums_k   = sum over rows with label k and w_i != 0 of bf16(w_i) * xb_i
//              (an exact product, summed in float32)
//   counts_k = sum over the same rows of w_i, unrounded
//
// What bounds the kernels on this card: operations.  The distances cost
// 2*n*k*D operations, now at the tensor cores' bf16 rate (989 TFLOP/s): at
// n = 2,097,152, D = 128, k = 1024 that is 0.56 ms, beside 0.32 ms to read
// x once and write the labels.  Nothing else comes close: the scatter is
// n*D multiply-adds, a k-th of the product.
//
// What the design does about it, simply, for a first kernel: the products
// run as mma.sync.m16n8k16 bf16 -> float32 (no wgmma, no TMA, no warp
// specialisation).  A block of 2 * TILE_N threads owns a tile of TILE_N rows,
// one warp for every 16 rows; it walks the centroids in tiles of TILE_K and
// the features in slices of 16.  Each slice is loaded as float32 from device
// memory (x) or as bf16 from the rounded copy of the centroids that
// prep_centroids_kernel writes (k x D, in the L2 cache), rounded on the way
// into shared memory, and read back as the tensor cores' fragments.  With
// KM_PIPE the next slice is fetched into registers while the current one is
// multiplied, and shared memory holds two slices, so one barrier per slice
// suffices.  A warp holds all TILE_K centroids of its 16 rows, so a row's
// minimum over a tile needs only the four threads of a quad (two shuffles)
// and never crosses warps; that epilogue (tile_min) lives in
// assign_common.cuh, shared with the float32 kernels, whose accumulators
// have the same layout.  No bf16 copy of x is kept.
//
// The segmented sum is the float32 kernel's: every persistent block adds
// into a (k, D + 1) table of its own, one thread owns each (column, label
// class) pair and walks the rows in order, and reduce_partials_kernel adds
// the tables in block order.  Two runs give the same bits.
//
// Compile-time variants (the variant lab, experiments/exp_pallas_kernel.py,
// builds them with -D): KM_TILE_N, rows of a block's tile (128 or 64);
// KM_TILE_K, centroids of a tile (128 or 64); KM_PIPE, 1 for the register
// prefetch across the product, 0 to fetch each slice just before it is
// stored (load, barrier, multiply).  The defaults are the main path's build.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

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

constexpr int BM = KM_TILE_N;        // rows of x in a block's tile
constexpr int BN = KM_TILE_K;        // centroids in a tile
constexpr bool PIPE = KM_PIPE != 0;
constexpr int BK = 16;               // features in a slice: one mma step
constexpr int THREADS = 2 * BM;      // one warp for every 16 rows
constexpr int NT = BN / 8;           // m16n8 tiles of a warp per centroid tile
constexpr int LDB = BK + 8;          // bf16 row stride of a slice in shared
                                     // memory: 12 words, so the fragment
                                     // loads of a warp hit 32 banks
constexpr int CV = (2 * BN + THREADS - 1) / THREADS;  // 16-byte c loads
static_assert(BM == 128 || BM == 64, "KM_TILE_N: 128 or 64 rows");
static_assert(BN == 128 || BN == 64, "KM_TILE_K: 128 or 64 centroids");
static_assert(KM_PIPE == 0 || KM_PIPE == 1, "KM_PIPE: 0 or 1");

struct Stage {                       // one slice of x and c, as bf16
    __nv_bfloat16 x[BM][LDB];
    __nv_bfloat16 c[BN][LDB];
};

struct Fetch {                       // what one thread fetches of one slice
    float4 x[2];
    uint4 c[CV];
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

// Rows row0 .. row0 + BM - 1 of x at features f0 .. f0 + 15, float32, and
// centroids c0 .. c0 + BN - 1 of the rounded copy cb (k rows of dp bf16).
template <bool VEC4>
__device__ __forceinline__ void fetch_slice(Fetch& f,
                                            const float* __restrict__ x,
                                            const __nv_bfloat16* __restrict__ cb,
                                            long long row0, long long n,
                                            int c0, int k, int f0, int d,
                                            int dp) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int e = threadIdx.x + i * THREADS;   // 0 .. 4 BM - 1
        f.x[i] = load4<VEC4>(x, row0 + (e >> 2), n, f0 + ((e & 3) << 2), d);
    }
#pragma unroll
    for (int i = 0; i < CV; ++i) {
        const int e = threadIdx.x + i * THREADS;   // 0 .. 2 BN - 1
        const int row = c0 + (e >> 1);
        f.c[i] = make_uint4(0u, 0u, 0u, 0u);
        if (e < 2 * BN && row < k)
            f.c[i] = *reinterpret_cast<const uint4*>(
                cb + (size_t)row * dp + f0 + ((e & 1) << 3));
    }
}

__device__ __forceinline__ void store_slice(const Fetch& f, Stage& s) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int e = threadIdx.x + i * THREADS;
        const float4 v = f.x[i];
        *reinterpret_cast<uint2*>(&s.x[e >> 2][(e & 3) << 2]) =
            make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
    }
#pragma unroll
    for (int i = 0; i < CV; ++i) {
        const int e = threadIdx.x + i * THREADS;
        if (e < 2 * BN)
            *reinterpret_cast<uint4*>(&s.c[e >> 1][(e & 1) << 3]) = f.c[i];
    }
}

// acc += A (16 x 16, row-major) . B (16 x 8, column-major), bf16 inputs,
// float32 accumulation on the tensor cores.
__device__ __forceinline__ void mma_bf16(float acc[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One slice into the warp's accumulators: rows warp*16 .. +15 of the tile
// against all BN centroids.  Lane (g = lane / 4, t = lane % 4) holds, of each
// m16n8 tile j, rows g and g + 8 at columns j*8 + 2t and j*8 + 2t + 1.
__device__ __forceinline__ void multiply_slice(const Stage& s,
                                               float acc[NT][4]) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    constexpr int W = LDB / 2;               // words per row of a slice
    const uint32_t* xw = reinterpret_cast<const uint32_t*>(
        &s.x[(threadIdx.x >> 5) * 16][0]);
    const uint32_t a[4] = {xw[g * W + t], xw[(g + 8) * W + t],
                           xw[g * W + t + 4], xw[(g + 8) * W + t + 4]};
    const uint32_t* cw = reinterpret_cast<const uint32_t*>(&s.c[0][0]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
        const uint32_t* b = cw + (j * 8 + g) * W + t;
        mma_bf16(acc[j], a, b[0], b[4]);
    }
}

// The minimum score of each of the rows  row0 .. row0 + BM - 1  over all
// centroids, in the layout of tile_min (assign_common.cuh): on return lane
// (g, t) of warp w holds in best_v/best_i[0] the running pair of row
// w*16 + g and in [1] that of row w*16 + g + 8, the same in the four lanes
// of the quad, and `bad` the rows' NaN flags.
template <bool VEC4>
__device__ __forceinline__ void assign_tile(const float* __restrict__ x,
                                            const __nv_bfloat16* __restrict__ cb,
                                            const float* __restrict__ h,
                                            long long row0, long long n,
                                            int d, int dp, int k,
                                            Stage (&st)[2], unsigned& stage,
                                            float best_v[2], int best_i[2],
                                            unsigned& bad) {
    bad = 0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        best_v[r] = CUDART_INF_F;      // the running pair starts at (+inf, 0)
        best_i[r] = 0;
    }
    const int slices = dp / BK;
    Fetch next;
    if (PIPE) fetch_slice<VEC4>(next, x, cb, row0, n, 0, k, 0, d, dp);

    for (int c0 = 0; c0 < k; c0 += BN) {
        float acc[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

        for (int s = 0; s < slices; ++s) {
            if (!PIPE)
                fetch_slice<VEC4>(next, x, cb, row0, n, c0, k, s * BK, d, dp);
            Stage& buf = st[stage++ & 1u];
            store_slice(next, buf);
            // Two buffers: the one written here was last read two slices
            // ago, before the barrier of the previous slice.
            __syncthreads();
            if (PIPE) {                // the next slice, maybe of the next tile
                const bool last = s + 1 == slices;
                if (!last || c0 + BN < k)
                    fetch_slice<VEC4>(next, x, cb, row0, n,
                                      last ? c0 + BN : c0, k,
                                      last ? 0 : (s + 1) * BK, d, dp);
            }
            multiply_slice(buf, acc);
        }
        tile_min<NT>(acc, c0, k, h, best_v, best_i, bad);
    }
}

// Writes the labels (and mind2) of a tile from lane 0 of each quad, in the
// layout of tile_min (one warp for every 16 rows); with KEEP also leaves the
// labels in lab_s for the scatter.  A row whose scores met a NaN (bit r of `bad`) gets label 0 and
// the minimum +inf.
template <bool KEEP>
__device__ __forceinline__ void write_tile(float best_v[2], int best_i[2],
                                           unsigned bad, long long row0,
                                           long long n, const float* x2s,
                                           int* __restrict__ labels,
                                           float* __restrict__ mind2,
                                           int* lab_s) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int r = 0; r < 2; ++r)
        if (bad & (1u << r)) { best_v[r] = CUDART_INF_F; best_i[r] = 0; }
    if ((lane & 3) != 0) return;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int rr = (threadIdx.x >> 5) * 16 + (lane >> 2) + 8 * r;
        const long long row = row0 + rr;
        if (KEEP) lab_s[rr] = best_i[r];
        if (row < n) {
            labels[row] = best_i[r];
            if (mind2 != nullptr) {
                float m = 2.f * best_v[r] + x2s[rr];
                m = (m < 0.f) ? 0.f : m;       // a NaN stays a NaN
                mind2[row] = m;
            }
        }
    }
}

template <bool VEC4>
__global__ void __launch_bounds__(THREADS, 512 / THREADS)
assign_bf16_kernel(const float* __restrict__ x,
                   const __nv_bfloat16* __restrict__ cb,
                   const float* __restrict__ h, int* __restrict__ labels,
                   float* __restrict__ mind2, long long n, int d, int dp,
                   int k) {
    __shared__ __align__(16) Stage st[2];
    __shared__ float x2s[BM];
    unsigned stage = 0;
    const long long tiles = (n + BM - 1) / BM;
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
        const long long row0 = t * BM;
        float best_v[2];
        int best_i[2];
        unsigned bad;
        assign_tile<VEC4>(x, cb, h, row0, n, d, dp, k, st, stage, best_v,
                          best_i, bad);
        if (mind2 != nullptr) {
            row_sqnorms<BM, THREADS>(x, row0, n, d, x2s);
            __syncthreads();
        }
        write_tile<false>(best_v, best_i, bad, row0, n, x2s, labels, mind2,
                          nullptr);
        __syncthreads();               // x2s and the stages are free again
    }
}

template <bool VEC4>
__global__ void __launch_bounds__(THREADS, 512 / THREADS)
fused_assign_reduce_bf16_kernel(const float* __restrict__ x,
                                const float* __restrict__ w,
                                const __nv_bfloat16* __restrict__ cb,
                                const float* __restrict__ h,
                                int* __restrict__ labels,
                                float* __restrict__ mind2,
                                float* __restrict__ partial,
                                long long n, int d, int dp, int k) {
    __shared__ __align__(16) Stage st[2];
    __shared__ float x2s[BM];
    __shared__ float ws[BM];
    __shared__ int lab_s[BM];
    unsigned stage = 0;

    const int dq = d + 1;              // the last column holds the counts
    float* table = partial + (size_t)blockIdx.x * (size_t)k * (size_t)dq;
    // One thread for each (column, label class) pair: with `groups` classes,
    // class g takes the rows whose label is g modulo `groups`, so no two
    // threads ever add into the same entry of the table.
    const int groups = dq >= THREADS ? 1 : THREADS / dq;
    const int cols = dq >= THREADS ? THREADS : dq;
    const int group = threadIdx.x / cols;
    const int col0 = threadIdx.x % cols;

    const long long tiles = (n + BM - 1) / BM;
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
        const long long row0 = t * BM;
        float best_v[2];
        int best_i[2];
        unsigned bad;
        assign_tile<VEC4>(x, cb, h, row0, n, d, dp, k, st, stage, best_v,
                          best_i, bad);
        if (mind2 != nullptr) row_sqnorms<BM, THREADS>(x, row0, n, d, x2s);
        if (threadIdx.x < BM) {
            const long long row = row0 + threadIdx.x;
            ws[threadIdx.x] = row < n ? w[row] : 0.f;
        }
        __syncthreads();
        write_tile<true>(best_v, best_i, bad, row0, n, x2s, labels, mind2,
                         lab_s);
        __syncthreads();

        if (group < groups) {
            for (int r = 0; r < BM; ++r) {
                const float wr = ws[r];
                if (wr == 0.f) continue;           // zero-weight rows: inert
                const int lab = lab_s[r];
                if (lab % groups != group) continue;
                const float wb = round_bf16(wr);
                const float* xr = x + (row0 + r) * (long long)d;
                float* out = table + (size_t)lab * (size_t)dq;
                for (int col = col0; col < dq; col += cols) {
                    // bf16(w) * bf16(x) is exact in float32; the counts
                    // take w unrounded.
                    const float v = col < d ? wb * round_bf16(xr[col]) : wr;
                    // One thread owns this entry, so the additions arrive in
                    // program order.
                    atomicAdd(out + col, v);
                }
            }
        }
        __syncthreads();               // ws, lab_s and the stages are free
    }
}

// h_k = 0.5 * ||c_k||^2 from the unrounded row, and cb_k = bf16(c_k) with
// zeros from feature d to dp; one warp for each centroid.
__global__ void prep_centroids_kernel(const float* __restrict__ c,
                                      float* __restrict__ h,
                                      __nv_bfloat16* __restrict__ cb, int d,
                                      int dp, int k) {
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (row >= k) return;
    const float* p = c + (size_t)row * (size_t)d;
    __nv_bfloat16* q = cb + (size_t)row * (size_t)dp;
    float s = 0.f;
    for (int col = lane; col < dp; col += 32) {
        const float v = col < d ? p[col] : 0.f;
        s = fmaf(v, v, s);
        q[col] = __float2bfloat16_rn(v);
    }
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) h[row] = 0.5f * s;
}

int padded_width(int d) { return (d + BK - 1) / BK * BK; }

size_t h_bytes(int k) { return ((size_t)k * 4 + 15) / 16 * 16; }

// h and the rounded centroids in the scratch; returns the first error.
int prep_centroids(const float* c, void* scratch, int d, int k,
                   cudaStream_t stream) {
    float* h = static_cast<float*>(scratch);
    __nv_bfloat16* cb = reinterpret_cast<__nv_bfloat16*>(
        static_cast<char*>(scratch) + h_bytes(k));
    const int warps = 8;
    prep_centroids_kernel<<<(k + warps - 1) / warps, warps * 32, 0,
                            stream>>>(c, h, cb, d, padded_width(d), k);
    return (int)cudaGetLastError();
}

}  // namespace

// Rows of a block's tile; the wrapper sizes its grid by it.
extern "C" int kmeans_tile_rows(void) { return BM; }

// Bytes of the launchers' scratch: h (k floats, padded to 16 bytes), then
// the rounded centroids (k rows of D padded to a multiple of 16, bf16).
extern "C" long long kmeans_scratch_bytes(int d, int k) {
    return (long long)(h_bytes(k) + (size_t)k * padded_width(d) * 2);
}

// Both launchers enqueue on `stream`, do not synchronise, and return the
// first cudaError_t that a launch reported, 0 if none did.  `scratch` holds
// kmeans_scratch_bytes(d, k) bytes, 16-byte aligned.  `mind2` may be null:
// then no minimum distance is computed or written.  `blocks` is the number
// of persistent blocks, at least 1.

extern "C" int kmeans_assign_bf16_launch(const float* x, const float* c,
                                         void* scratch, int* labels,
                                         float* mind2, long long n, int d,
                                         int k, int blocks, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    int err = prep_centroids(c, scratch, d, k, st);
    if (err != 0) return err;
    const float* h = static_cast<const float*>(scratch);
    const __nv_bfloat16* cb = reinterpret_cast<const __nv_bfloat16*>(
        static_cast<const char*>(scratch) + h_bytes(k));
    const int dp = padded_width(d);
    if ((d % 4 == 0) && aligned16(x))
        assign_bf16_kernel<true><<<blocks, THREADS, 0, st>>>(
            x, cb, h, labels, mind2, n, d, dp, k);
    else
        assign_bf16_kernel<false><<<blocks, THREADS, 0, st>>>(
            x, cb, h, labels, mind2, n, d, dp, k);
    return (int)cudaGetLastError();
}

// `partial` is scratch of blocks * k * (d + 1) floats and must be zero.
extern "C" int kmeans_fused_assign_reduce_bf16_launch(
        const float* x, const float* w, const float* c, void* scratch,
        int* labels, float* mind2, float* partial, float* sums,
        float* counts, long long n, int d, int k, int blocks, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    int err = prep_centroids(c, scratch, d, k, st);
    if (err != 0) return err;
    const float* h = static_cast<const float*>(scratch);
    const __nv_bfloat16* cb = reinterpret_cast<const __nv_bfloat16*>(
        static_cast<const char*>(scratch) + h_bytes(k));
    const int dp = padded_width(d);
    if ((d % 4 == 0) && aligned16(x))
        fused_assign_reduce_bf16_kernel<true><<<blocks, THREADS, 0, st>>>(
            x, w, cb, h, labels, mind2, partial, n, d, dp, k);
    else
        fused_assign_reduce_bf16_kernel<false><<<blocks, THREADS, 0, st>>>(
            x, w, cb, h, labels, mind2, partial, n, d, dp, k);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
    return launch_reduce_partials(partial, sums, counts, blocks, d, k, st);
}
