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
//   shift_kernel                a shift of the features (below)
//   split_centroids_kernel      h_k = 0.5 * ||c_k - s||^2, which the JAX
//                               package computed outside its kernel (as
//                               0.5 * ||c_k||^2, _pad_inputs), and the shifted
//                               centroids split for the products
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
// (computed in a shifted frame, below: the same argmin and the same mind2).
// The (n, k) score matrix lives only in registers.
//
// What bounds the kernels on this card: operations.  The distances cost
// 2*n*k*D operations, while every input byte is read from device memory
// once: at D = 128, k = 1024 that is 2048 operations for each byte of x.
// These kernels promise float32 products.  Outside the tensor cores the
// card does 67 TFLOP/s of float32; on them, TF32 (a 10-bit mantissa) at
// 495 TFLOP/s.  Three TF32 products per product keep float32's accuracy
// (3xTF32), so the least time is 3 * 2nkD operations at the TF32 rate, less
// than half of 2nkD at the float32 rate.  The scatter is n*D multiply-adds,
// a k-th of the distance work.
//
// What the design does about it: 3xTF32 on mma.sync.m16n8k8 (no wgmma, no
// TMA, no warp specialisation).
//
//   * The split.  A float32 v is hi + lo with hi = tf32_rna(v) and
//     lo = tf32_rna(v - hi); x . c ~ lo_x . hi_c + hi_x . lo_c + hi_x . hi_c,
//     the small terms first (lo . lo, below float32's rounding, is
//     dropped).  Where hi is not finite, lo is 0 and the cross term takes
//     hi_x as 0: a row with one +Inf coordinate then scores +-Inf against
//     every centroid, as in float32, where a naive split would make
//     Inf - Inf = NaN.  (A centroid with a non-finite coordinate is not
//     split that way on its hi side: its scores may be NaN where float32's
//     are +-Inf.  A fit never passes one: it raises on non-finite centroids
//     first.)
//   * The sum.  The tensor cores add into their float32 accumulator without
//     rounding (the addends are truncated to its alignment), so each mma
//     loses up to an ulp of the running dot product: at |x . c| ~ 4e3 and
//     48 mma per dot (D = 128) more than float32's error.  So the three
//     products of an 8-feature group start from zero, and their sum, an
//     eighth of the dot at most, joins the running one by a float32 add
//     that rounds.
//   * The shift.  The kernels compute in a frame shifted by a vector s,
//     x - s and c - s: score - (x . s - 0.5 ||s||^2) has the same argmin, and
//     mind2 = 2 min score + ||x - s||^2 the same value.  Far from the origin
//     (features near 1e3, a mixture's data) the unshifted score, about
//     -0.5 ||x||^2, leaves float32 steps of 4 to 8 for distances of a few
//     units: near-duplicate centroids then tie exactly, and the lowest index
//     takes every tie, which can starve a cluster.  s_f is 0 unless the
//     centroids' column f is finite and of one strict sign; then it is
//     (1 - 2^-8) times the value nearest 0, so that c - s keeps the sign of
//     c in every entry and a row with an infinite coordinate scores +-inf
//     (or NaN) exactly where the unshifted product does.
//   * Centroids are shifted and split once per call by
//     split_centroids_kernel into the scratch: k x D_pad x (hi, lo), D_pad
//     = D rounded up to 16, zeros beyond D, laid out so that one 16-byte
//     shared-memory load gives a lane both of its hi and lo fragment values
//     of one 8-feature group (1 MB at D = 128, k = 1024: it stays in the L2
//     cache).
//   * A block of 128 threads (4 warps) owns a tile of 128 rows.  Each warp
//     holds 32 rows (two m16 tiles) against all TILE_K centroids of a
//     centroid tile (TILE_K / 8 n8 tiles, 128 accumulators a lane), so each
//     B fragment read from shared memory feeds two independent mma chains
//     and a row's minimum never leaves its warp.  (With one m16 tile per
//     warp the B reads alone ran at three quarters of the card's
//     shared-memory rate; 256-thread blocks with two m16 tiles per warp
//     spilled at the 128 registers that two such blocks allow.)  Two blocks
//     share an SM, each lane up to 255 registers.  The epilogue of each
//     centroid tile (tile_min) is shared with the bf16 kernels
//     (assign_common.cuh): h is subtracted in float32 there.
//   * x is copied once per row tile into shared memory (cp.async) and kept
//     there for the whole centroid loop, where it fits beside the centroid
//     buffers (D_pad <= 144 at the defaults: two blocks per SM); each warp
//     shifts and splits its A fragments in registers as it reads them.  At
//     a wider D, x is streamed with the centroids, slice by slice.
//   * The centroids are streamed in slices of 16 features (two mma steps)
//     with cp.async: with KM_PIPE=1 into two buffers, the next slice copied
//     while the current one is multiplied (one barrier per slice); with
//     KM_PIPE=0 into one (copy, wait, barrier, multiply, barrier).
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
// KM_PIPE, 1 for two centroid buffers (the next slice copied during the
// product), 0 for one.  KM_TILE_N, the rows of a block's tile, is 128 only.
// The defaults below are the main path's build.

#include <cuda_runtime.h>
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

constexpr int BM = KM_TILE_N;  // rows of x in a block's tile
constexpr int BN = KM_TILE_K;  // centroids in a tile
constexpr bool PIPE = KM_PIPE != 0;
constexpr int NST = PIPE ? 2 : 1;  // centroid (and streamed x) buffers
constexpr int BK = 16;         // features in a slice: two mma steps of 8
constexpr int THREADS = 128;   // 4 warps of 32 rows
constexpr int MT = 2;          // m16 tiles of a warp
constexpr int NT = BN / 8;     // n8 tiles of a warp per centroid tile
constexpr int GF = 16;         // floats of one centroid's 8-feature group:
                               // lane t's (hi k=t, hi k=t+4, lo k=t, lo k=t+4)
constexpr int LDS = BK + 4;    // row stride of a streamed x slice (floats)
static_assert(BM == 128, "KM_TILE_N: the float32 kernels take 128 rows");
static_assert(BN == 128 || BN == 64, "KM_TILE_K: 128 or 64 centroids");
static_assert(KM_PIPE == 0 || KM_PIPE == 1, "KM_PIPE: 0 or 1");

// Floats of one centroid buffer: two groups of BN centroids x GF.  Group-
// major, so the 16-byte loads of a quarter warp (two centroids, four lanes
// each) fall on 32 distinct banks.
constexpr int C_STAGE = 2 * BN * GF;
// Shared memory (dynamic) that a block may use and still leave room for two
// blocks on an SM beside the static arrays.
constexpr int SMEM_LIMIT = 110 * 1024;

int padded_width(int d) { return (d + BK - 1) / BK * BK; }

// Row stride of the resident x tile: D_pad + 4 floats, so that the A
// fragment loads of a warp (rows g, g + 8; features t, t + 4) hit 32 banks.
__host__ __device__ __forceinline__ int resident_stride(int dp) {
    return dp + 4;
}

size_t smem_bytes(bool resident, int dp) {
    const size_t c = (size_t)NST * C_STAGE * 4;
    return c + (resident ? (size_t)BM * resident_stride(dp) * 4
                         : (size_t)NST * BM * LDS * 4);
}

bool x_resident(int dp) { return smem_bytes(true, dp) <= SMEM_LIMIT; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// Copies 16 (or 4) bytes into shared memory, or zeros where !valid.
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void copy4(void* dst, const void* src,
                                      bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void copy_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void copy_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Features col .. col + 3 of row `row` of x (n x d) into dst, zeros beyond
// the rows or features.
template <bool VEC4>
__device__ __forceinline__ void copy_x4(float* dst,
                                        const float* __restrict__ x,
                                        long long row, long long n, int col,
                                        int d) {
    const bool in = row < n;
    const float* p = x + (in ? row : 0) * (long long)d;
    if (VEC4) {
        copy16(dst, in && col < d ? p + col : x, in && col < d);
    } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
            copy4(dst + e, in && col + e < d ? p + col + e : x,
                  in && col + e < d);
    }
}

__device__ __forceinline__ uint32_t tf32_rna(float v) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
    return r;
}

// v = hi + lo (to TF32 precision twice over).  fin is hi where hi is finite,
// else 0; lo is 0 where hi is not finite.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo,
                                      uint32_t& fin) {
    hi = tf32_rna(v);
    const float hv = __uint_as_float(hi);
    const bool finite = fabsf(hv) < CUDART_INF_F;     // false for NaN
    lo = finite ? tf32_rna(v - hv) : 0u;
    fin = finite ? hi : 0u;
}

// acc += A (16 x 8, row-major) . B (8 x 8, column-major), TF32 inputs,
// float32 accumulation on the tensor cores.
__device__ __forceinline__ void mma_tf32(float acc[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
    asm(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Issues the copies of one step of a row tile: slice s (features s*BK ..
// s*BK + 15) of the centroid tile at c0 into buffer cb, and, where x is not
// resident, the same features of the tile's rows into xb.
template <bool VEC4, bool RESIDENT>
__device__ __forceinline__ void copy_step(float* cb, float* xb,
                                          const float* __restrict__ x,
                                          const float* __restrict__ cs,
                                          long long row0, long long n,
                                          int c0, int k, int s, int d,
                                          int groups) {
    // BN centroids x 2 groups x 4 pieces of 16 bytes.
#pragma unroll
    for (int i = 0; i < (BN * 8) / THREADS; ++i) {
        const int e = threadIdx.x + i * THREADS;
        const int cen = e >> 3, grp = (e >> 2) & 1, part = e & 3;
        const int row = c0 + cen;
        const float* src = cs + ((size_t)(row < k ? row : 0) * groups
                                 + 2 * s + grp) * GF + part * 4;
        copy16(cb + grp * BN * GF + cen * GF + part * 4, src, row < k);
    }
    if (!RESIDENT) {
        // BM rows x 4 pieces of four features.
#pragma unroll
        for (int i = 0; i < (BM * 4) / THREADS; ++i) {
            const int e = threadIdx.x + i * THREADS;
            const int r = e >> 2, q = (e & 3) * 4;
            copy_x4<VEC4>(xb + r * LDS + q, x, row0 + r, n, s * BK + q, d);
        }
    }
}

// One slice into the warp's accumulators: its 32 rows against the BN
// centroids of the buffer, two mma steps of 8 features, three products
// each.  xa points at the warp's first row at the slice's first feature,
// rows `ld` floats apart, and sh at the shift of the slice's first
// feature.  Each group's products start from zero (part) and join acc by a
// rounding float32 add (the header's "The sum").
__device__ __forceinline__ void multiply_slice(const float* xa, int ld,
                                               const float* cb,
                                               const float* __restrict__ sh,
                                               float (&acc)[MT][NT][4]) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll 1
    for (int grp = 0; grp < 2; ++grp) {
        const float s0 = __ldg(sh + grp * 8 + t);
        const float s1 = __ldg(sh + grp * 8 + t + 4);
        uint32_t hi[MT][4], lo[MT][4], fin[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
            const float* xg = xa + m * 16 * ld + grp * 8;
            const float v[4] = {xg[g * ld + t] - s0, xg[(g + 8) * ld + t] - s0,
                                xg[g * ld + t + 4] - s1,
                                xg[(g + 8) * ld + t + 4] - s1};
#pragma unroll
            for (int e = 0; e < 4; ++e)
                split(v[e], hi[m][e], lo[m][e], fin[m][e]);
        }
        const float* cg = cb + grp * BN * GF + g * GF + t * 4;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            const float4 b = *reinterpret_cast<const float4*>(cg + j * 8 * GF);
            const uint32_t bh0 = __float_as_uint(b.x), bh1 = __float_as_uint(b.y);
            const uint32_t bl0 = __float_as_uint(b.z), bl1 = __float_as_uint(b.w);
            float part[MT][4];
#pragma unroll
            for (int m = 0; m < MT; ++m) {
#pragma unroll
                for (int e = 0; e < 4; ++e) part[m][e] = 0.f;
                mma_tf32(part[m], lo[m], bh0, bh1);   // the small terms first
            }
#pragma unroll
            for (int m = 0; m < MT; ++m) mma_tf32(part[m], fin[m], bl0, bl1);
#pragma unroll
            for (int m = 0; m < MT; ++m) mma_tf32(part[m], hi[m], bh0, bh1);
#pragma unroll
            for (int m = 0; m < MT; ++m)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[m][j][e] += part[m][e];
        }
    }
}

// The label and minimum score of each of the rows  row0 .. row0 + BM - 1
// over all centroids, left in lab_s[r] and min_s[r] (r < BM) for every
// thread: label 0 and +inf for a row that met a NaN score or whose scores
// never go below +inf.
template <bool VEC4, bool RESIDENT>
__device__ __forceinline__ void assign_tile(const float* __restrict__ x,
                                            const float* __restrict__ cs,
                                            const float* __restrict__ h,
                                            const float* __restrict__ sh,
                                            long long row0, long long n,
                                            int d, int dp, int k,
                                            float* smem, float* min_s,
                                            int* lab_s) {
    const int warp = threadIdx.x >> 5;
    const int groups = dp / 8;
    const int slices = dp / BK;
    const int steps = (k + BN - 1) / BN * slices;
    float* cbuf = smem;                        // NST x C_STAGE
    float* xbuf = smem + NST * C_STAGE;        // the x tile, or NST slices
    const int ldx = RESIDENT ? resident_stride(dp) : LDS;
    float best_v[MT][2];
    int best_i[MT][2];
    unsigned bad[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
        bad[m] = 0;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            best_v[m][r] = CUDART_INF_F;   // the running pair starts at (+inf, 0)
            best_i[m][r] = 0;
        }
    }

    __syncthreads();                   // the previous tile is done with smem
    if (RESIDENT) {
        const int pieces = BM * (dp / 4);
        for (int e = threadIdx.x; e < pieces; e += THREADS) {
            const int r = e / (dp / 4), q = (e % (dp / 4)) * 4;
            copy_x4<VEC4>(xbuf + r * ldx + q, x, row0 + r, n, q, d);
        }
        copy_commit();
    }
    if (PIPE) {
        copy_step<VEC4, RESIDENT>(cbuf, xbuf, x, cs, row0, n, 0, k, 0, d,
                                  groups);
        copy_commit();
    }

    int step = 0;
    for (int c0 = 0; c0 < k; c0 += BN) {
        float acc[MT][NT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

        for (int s = 0; s < slices; ++s, ++step) {
            const int buf = PIPE ? (step & 1) : 0;
            if (PIPE) {
                copy_wait_all();       // this step's slice has landed ...
                __syncthreads();       // ... for every thread, and the other
                                       // buffer has been read
                const int next = step + 1;
                if (next < steps)
                    copy_step<VEC4, RESIDENT>(
                        cbuf + (next & 1) * C_STAGE,
                        xbuf + (next & 1) * BM * LDS, x, cs, row0, n,
                        next / slices * BN, k, next % slices, d, groups);
                copy_commit();
            } else {
                __syncthreads();       // the buffer has been read
                copy_step<VEC4, RESIDENT>(cbuf, xbuf, x, cs, row0, n, c0, k,
                                          s, d, groups);
                copy_commit();
                copy_wait_all();
                __syncthreads();
            }
            const float* xa = RESIDENT
                ? xbuf + warp * 32 * ldx + s * BK
                : xbuf + buf * BM * LDS + warp * 32 * LDS;
            multiply_slice(xa, ldx, cbuf + buf * C_STAGE, sh + s * BK, acc);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m)
            tile_min<NT>(acc[m], c0, k, h, best_v[m], best_i[m], bad[m]);
    }

    // Lane 0 of each quad leaves its rows' pairs.
    const int lane = threadIdx.x & 31;
    if ((lane & 3) == 0) {
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const int row = warp * 32 + m * 16 + (lane >> 2) + 8 * r;
                const bool nan = (bad[m] >> r) & 1u;
                min_s[row] = nan ? CUDART_INF_F : best_v[m][r];
                lab_s[row] = nan ? 0 : best_i[m][r];
            }
    }
    __syncthreads();
}

// Writes labels and (with mind2) max(2 * min + ||x - s||^2, 0), NaN kept,
// of the tile's rows from the merged results; one thread for each row.
__device__ __forceinline__ void write_rows(long long row0, long long n,
                                           const float* min_s,
                                           const int* lab_s,
                                           const float* x2s,
                                           int* __restrict__ labels,
                                           float* __restrict__ mind2) {
    const int r = threadIdx.x;
    const long long row = row0 + r;
    if (r >= BM || row >= n) return;
    labels[row] = lab_s[r];
    if (mind2 != nullptr) {
        float m = 2.f * min_s[r] + x2s[r];
        m = (m < 0.f) ? 0.f : m;       // a NaN stays a NaN
        mind2[row] = m;
    }
}

template <bool VEC4, bool RESIDENT>
__global__ void __launch_bounds__(THREADS, 2)
assign_kernel(const float* __restrict__ x, const float* __restrict__ cs,
              const float* __restrict__ h, const float* __restrict__ sh,
              int* __restrict__ labels, float* __restrict__ mind2,
              long long n, int d, int dp, int k) {
    extern __shared__ __align__(16) float smem[];
    __shared__ float x2s[BM];
    __shared__ float min_s[BM];
    __shared__ int lab_s[BM];
    const long long tiles = (n + BM - 1) / BM;
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
        const long long row0 = t * BM;
        assign_tile<VEC4, RESIDENT>(x, cs, h, sh, row0, n, d, dp, k, smem,
                                    min_s, lab_s);
        if (mind2 != nullptr) {
            row_sqnorms<BM, THREADS>(x, row0, n, d, x2s, sh);
            __syncthreads();
        }
        write_rows(row0, n, min_s, lab_s, x2s, labels, mind2);
        // The next tile's first barrier keeps min_s, lab_s and x2s until
        // every row is written.
    }
}

template <bool VEC4, bool RESIDENT>
__global__ void __launch_bounds__(THREADS, 2)
fused_assign_reduce_kernel(const float* __restrict__ x,
                           const float* __restrict__ w,
                           const float* __restrict__ cs,
                           const float* __restrict__ h,
                           const float* __restrict__ sh,
                           int* __restrict__ labels,
                           float* __restrict__ mind2,
                           float* __restrict__ partial,
                           long long n, int d, int dp, int k) {
    extern __shared__ __align__(16) float smem[];
    __shared__ float x2s[BM];
    __shared__ float ws[BM];
    __shared__ float min_s[BM];
    __shared__ int lab_s[BM];

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
        assign_tile<VEC4, RESIDENT>(x, cs, h, sh, row0, n, d, dp, k, smem,
                                    min_s, lab_s);
        if (mind2 != nullptr)
            row_sqnorms<BM, THREADS>(x, row0, n, d, x2s, sh);
        if (threadIdx.x < BM) {
            const long long row = row0 + threadIdx.x;
            ws[threadIdx.x] = row < n ? w[row] : 0.f;
        }
        __syncthreads();
        write_rows(row0, n, min_s, lab_s, x2s, labels, mind2);

        if (group < groups) {
            for (int r = 0; r < BM; ++r) {
                const float wr = ws[r];
                if (wr == 0.f) continue;           // zero-weight rows: inert
                const int lab = lab_s[r];
                if (lab % groups != group) continue;
                const float* xr = x + (row0 + r) * (long long)d;
                float* out = table + (size_t)lab * (size_t)dq;
                for (int col = col0; col < dq; col += cols) {
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

// The shift s (dp floats, 0 from feature d on): s_f = (1 - 2^-8) times the
// value nearest 0 of the centroids' column f where that column is finite
// and of one strict sign, else 0.  One block of 8 warps for 32 features:
// lane f of each warp walks every 8th centroid, then the warps merge.
__global__ void shift_kernel(const float* __restrict__ c,
                             float* __restrict__ sh, int d, int dp, int k) {
    __shared__ float lo_s[8][32], hi_s[8][32];
    __shared__ int bad_s[8][32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int f = blockIdx.x * 32 + lane;
    float mn = CUDART_INF_F, mx = -CUDART_INF_F;
    int bad = 0;
    if (f < d)
        for (int j = warp; j < k; j += 8) {
            const float v = c[(size_t)j * d + f];
            bad |= !(fabsf(v) < CUDART_INF_F);
            mn = fminf(mn, v);
            mx = fmaxf(mx, v);
        }
    lo_s[warp][lane] = mn;
    hi_s[warp][lane] = mx;
    bad_s[warp][lane] = bad;
    __syncthreads();
    if (warp != 0 || f >= dp) return;
    for (int w = 1; w < 8; ++w) {
        mn = fminf(mn, lo_s[w][lane]);
        mx = fmaxf(mx, hi_s[w][lane]);
        bad |= bad_s[w][lane];
    }
    const float keep = 1.f - 1.f / 256.f;
    float s = 0.f;
    if (f < d && !bad && mn > 0.f) s = keep * mn;
    if (f < d && !bad && mx < 0.f) s = keep * mx;
    // Strictly nearer 0 than every centroid (not so for a subnormal).
    if (!(fabsf(s) < fminf(fabsf(mn), fabsf(mx)))) s = 0.f;
    sh[f] = s;
}

// h_k = 0.5 * ||c_k - s||^2 from the unrounded shifted row, and c_k - s
// split into the scratch's layout: for each 8-feature group q and lane t,
// the floats (hi c[8q+t], hi c[8q+t+4], lo c[8q+t], lo c[8q+t+4]) of the
// shifted row, zeros from feature d on; one warp for each centroid.
__global__ void split_centroids_kernel(const float* __restrict__ c,
                                       const float* __restrict__ sh,
                                       float* __restrict__ h,
                                       float* __restrict__ cs, int d, int dp,
                                       int k) {
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (row >= k) return;
    const float* p = c + (size_t)row * (size_t)d;
    float s = 0.f;
    for (int col = lane; col < d; col += 32) {
        const float v = p[col] - sh[col];
        s = fmaf(v, v, s);
    }
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) h[row] = 0.5f * s;
    float4* q = reinterpret_cast<float4*>(cs + (size_t)row * dp * 2);
    for (int e = lane; e < dp / 2; e += 32) {   // (group, t) pairs
        const int f = (e >> 2) * 8 + (e & 3);
        uint32_t hi[2], lo[2], fin[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
            const int col = f + 4 * u;
            split(col < d ? p[col] - sh[col] : 0.f, hi[u], lo[u], fin[u]);
        }
        q[e] = make_float4(__uint_as_float(hi[0]), __uint_as_float(hi[1]),
                           __uint_as_float(lo[0]), __uint_as_float(lo[1]));
    }
}

size_t h_bytes(int k) { return ((size_t)k * 4 + 15) / 16 * 16; }

// The scratch: h (k floats, padded to 16 bytes), the split centroids (k
// rows of D_pad hi and lo floats), the shift (D_pad floats).
struct Scratch {
    float* h;
    float* cs;
    float* sh;
    Scratch(void* base, int d, int k) {
        char* p = static_cast<char*>(base);
        h = reinterpret_cast<float*>(p);
        cs = reinterpret_cast<float*>(p + h_bytes(k));
        sh = cs + (size_t)k * padded_width(d) * 2;
    }
};

// The shift, h and the split centroids in the scratch; returns the first
// error.
int split_centroids(const float* c, const Scratch& s, int d, int k,
                    cudaStream_t stream) {
    const int dp = padded_width(d);
    shift_kernel<<<(dp + 31) / 32, 256, 0, stream>>>(c, s.sh, d, dp, k);
    int err = (int)cudaGetLastError();
    if (err != 0) return err;
    const int warps = 8;
    split_centroids_kernel<<<(k + warps - 1) / warps, warps * 32, 0,
                             stream>>>(c, s.sh, s.h, s.cs, d, dp, k);
    return (int)cudaGetLastError();
}

// Launches `kernel` with the dynamic shared memory of its x layout, and the
// largest shared-memory share of the SM, so that two blocks fit.
template <typename Kernel, typename... Args>
int launch_main(Kernel kernel, bool resident, int dp, int blocks,
                cudaStream_t st, Args... args) {
    const size_t bytes = smem_bytes(resident, dp);
    int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err == 0)
        err = (int)cudaFuncSetAttribute(
            kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
            (int)cudaSharedmemCarveoutMaxShared);
    if (err != 0) return err;
    kernel<<<blocks, THREADS, bytes, st>>>(args...);
    return (int)cudaGetLastError();
}

}  // namespace

// Rows of a block's tile; the wrapper sizes its grid by it.
extern "C" int kmeans_tile_rows(void) { return BM; }

// Bytes of the launchers' scratch: h (k floats, padded to 16 bytes), the
// split centroids (k rows of D padded to a multiple of 16, hi and lo), then
// the shift (D padded, floats).
extern "C" long long kmeans_scratch_bytes(int d, int k) {
    return (long long)(h_bytes(k) + ((size_t)k * 2 + 1) * padded_width(d) * 4);
}

// Both launchers enqueue on `stream`, do not synchronise, and return the
// first cudaError_t that a launch reported, 0 if none did.  `scratch` holds
// kmeans_scratch_bytes(d, k) bytes, 16-byte aligned.  `mind2` may be null:
// then no minimum distance is computed or written.  `blocks` is the number
// of persistent blocks, at least 1.

extern "C" int kmeans_assign_launch(const float* x, const float* c,
                                    void* scratch, int* labels, float* mind2,
                                    long long n, int d, int k, int blocks,
                                    void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const Scratch s(scratch, d, k);
    int err = split_centroids(c, s, d, k, st);
    if (err != 0) return err;
    const float* cs = s.cs;
    const float* h = s.h;
    const float* sh = s.sh;
    const int dp = padded_width(d);
    const bool vec4 = (d % 4 == 0) && aligned16(x);
    const bool res = x_resident(dp);
    if (vec4 && res)
        return launch_main(assign_kernel<true, true>, res, dp, blocks, st,
                           x, cs, h, sh, labels, mind2, n, d, dp, k);
    if (vec4)
        return launch_main(assign_kernel<true, false>, res, dp, blocks, st,
                           x, cs, h, sh, labels, mind2, n, d, dp, k);
    if (res)
        return launch_main(assign_kernel<false, true>, res, dp, blocks, st,
                           x, cs, h, sh, labels, mind2, n, d, dp, k);
    return launch_main(assign_kernel<false, false>, res, dp, blocks, st,
                       x, cs, h, sh, labels, mind2, n, d, dp, k);
}

// `partial` is scratch of blocks * k * (d + 1) floats and must be zero.
extern "C" int kmeans_fused_assign_reduce_launch(
        const float* x, const float* w, const float* c, void* scratch,
        int* labels, float* mind2, float* partial, float* sums,
        float* counts, long long n, int d, int k, int blocks, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const Scratch s(scratch, d, k);
    int err = split_centroids(c, s, d, k, st);
    if (err != 0) return err;
    const float* cs = s.cs;
    const float* h = s.h;
    const float* sh = s.sh;
    const int dp = padded_width(d);
    const bool vec4 = (d % 4 == 0) && aligned16(x);
    const bool res = x_resident(dp);
    if (vec4 && res)
        err = launch_main(fused_assign_reduce_kernel<true, true>, res, dp,
                          blocks, st, x, w, cs, h, sh, labels, mind2, partial,
                          n, d, dp, k);
    else if (vec4)
        err = launch_main(fused_assign_reduce_kernel<true, false>, res, dp,
                          blocks, st, x, w, cs, h, sh, labels, mind2, partial,
                          n, d, dp, k);
    else if (res)
        err = launch_main(fused_assign_reduce_kernel<false, true>, res, dp,
                          blocks, st, x, w, cs, h, sh, labels, mind2, partial,
                          n, d, dp, k);
    else
        err = launch_main(fused_assign_reduce_kernel<false, false>, res, dp,
                          blocks, st, x, w, cs, h, sh, labels, mind2, partial,
                          n, d, dp, k);
    if (err != 0) return err;
    return launch_reduce_partials(partial, sums, counts, blocks, d, k, st);
}
