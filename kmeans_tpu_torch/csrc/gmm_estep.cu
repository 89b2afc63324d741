// Hopper (sm_90a) counterpart of the fused diagonal-GMM E-step kernel of
// experiments/exp_gmm_estep_pallas.py:
//
//   estep_kernel         replaces  pallas_estep (_kernel; pl.pallas_call :178)
//   estep_tables_kernel  the per-component tables that pallas_estep built
//                        outside its kernel ([b, -a/2], split for the tensor
//                        cores, and c1)
//   estep_reduce_kernel  second pass: adds the blocks' tables in block order
//                        (the TPU kernel carried its sums across a sequential
//                        grid; blocks on a GPU share no such carry)
//
// What they compute, for x (n, D), w (n,), shift (D,), means_c and inv_var
// (k, D), log_det and log_weights (k,), all float32, with x_c = x - shift
// formed on chip (no centered copy of the data is made):
//
//   a = inv_var, b = means_c * a,
//   c1_k    = log_weights_k - 0.5 (D log 2pi + log_det_k + sum_d means_c b)
//   F_i     = [x_c, x_c^2]_i, and 0 for a row of weight 0 (not even a NaN)
//   logp_ik = F_i . [b, -a/2]_k + c1_k                      (depth 2D)
//   m_i = max_k logp_ik,  s_i = sum_k exp(logp_ik - m_i),  lse_i = m_i + log s_i
//   r_ik    = exp(logp_ik - m_i) w_i / s_i, and 0 for a row of weight 0
//   rsum_k  = sum_i r_ik,  [s1, s2]_k = sum_i r_ik F_i
//   ll      = sum over rows with w_i > 0 of w_i lse_i
//
// The (n, k) log-densities and responsibilities never reach device memory.
//
// What bounds the kernel on this card: operations.  Per row and component
// it does a depth-2D product for logp and a depth-2D moment product, 8 n k D
// operations, against 4 n D bytes of x read: about 500 operations per byte
// at k = 256.  Both products must be float32-accurate: the hard-init tables
// (inv_var = 1e6) make x_c^2 a and 2 x_c b of order 1e8, and they cancel,
// and the M-step's variance S2/R - mu^2 cancels too.  TF32 alone (a 10-bit
// mantissa) leaves errors of order 1e4 in such a logp.  So both run on the
// tensor cores as three TF32 products each (3xTF32): the least time is
// 3 * 8nkD operations at the TF32 rate, less than half of 8nkD at the
// float32 rate outside them.
//
// What the design does about it: 3xTF32 on mma.sync.m16n8k8 in both
// products (no wgmma, no TMA, no warp specialisation), with the recipe of
// assign_kernels.cu (its helpers are copied below):
//
//   * The split.  A float32 v is hi + lo with hi = tf32_rna(v) and
//     lo = tf32_rna(v - hi); u . v ~ lo_u . hi_v + hi_u . lo_v + hi_u . hi_v,
//     the small terms first (lo . lo, below float32's rounding, is
//     dropped).  No Inf guard: rows of weight 0 are zeroed before the
//     split, and a live row with a non-finite coordinate has a NaN (or
//     -inf everywhere) logp in float32 too, which makes its statistics
//     NaN either way.
//   * The sum.  The tensor cores add into their float32 accumulator without
//     rounding, so each 8-deep group's three products start from zero, and
//     their sum joins the running one by a float32 add that rounds.
//   * The tables [b, -a/2] are split once per call by estep_tables_kernel
//     into scratch laid out so that one 16-byte shared-memory load gives a
//     lane both its hi and lo fragment values of one 8-feature group.
//   * F is laid out as [x_c, 0 ..., x_c^2, 0 ...], each half D rounded up to
//     8 (dx) wide, and so are the coefficients and the per-block tables: a
//     group of 8 columns is all x_c or all x_c^2, which a warp knows without
//     a branch.
//
// A block of 256 threads (8 warps, one block per SM, up to 255 registers a
// lane) owns a tile of BM = 128 rows at a time.  Per row tile:
//
//   0. x_c of the tile's rows goes into shared memory once (cp.async, then
//      centered in place), zeros for rows of weight 0 or beyond n (when
//      D <= 168; wider rows are read from device memory, through the
//      caches, wherever they are needed).
//   1. For every tile of TC = 256 components: the logp product, F (rows) .
//      coef (components), depth 2 dx, the coefficients streamed through two
//      shared-memory buffers (cp.async) in slices of BK = 16 features.  Each
//      warp holds 32 rows x 128 components (two m16 tiles: each B fragment
//      feeds two mma chains, and two n8 tiles go together: four chains).
//      The tile is written to shared memory, components beyond k as -inf,
//      and an online max and sum per row (one warp per row, shuffles in a
//      fixed order) cover all k components at any k.
//   2. For every component tile: the logp tile becomes responsibilities in
//      place, then the moment product r^T (components) . F (columns), depth
//      BM rows, 128 columns of F at a time: each warp holds 64 components x
//      64 columns (four mma chains).  F comes from the x_c tile of step 0;
//      rsum is summed from the same r fragments.  The last tile of step 1 is
//      still in shared memory and goes first: at k <= 256 (the mixture
//      path's k) nothing is recomputed, and the max, the sum and the
//      responsibilities come from one pass over the rows; at larger k every
//      other tile is recomputed (the same products in the same order, so
//      the same bits).
//
// The coefficient buffers of step 1 share their memory with the logp tile:
// the tile is written only once the product is done.
//
// The sums are deterministic.  Every block is persistent, takes the row
// tiles blockIdx, blockIdx + gridDim, ... in order and adds into a table of
// its own, k rows of [s1 (dx), s2 (dx), rsum, pad] floats.  One lane owns
// each entry of a (component tile, column pass) pair and adds it once per
// row tile (two neighbours in one float2 atomicAdd, which spares the round
// trip of a load and a store), so every entry is written by one thread in a
// fixed order.  ll is summed per tile in row order and per block in tile
// order, in double.  estep_reduce_kernel adds the tables and the ll partials
// in block order: two runs give the same bits.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;          // rows of a row tile
constexpr int TC = 256;          // components of a component tile
constexpr int THREADS = 256;     // 8 warps
constexpr int BK = 16;           // features of a coefficient slice
constexpr int GPS = BK / 8;      // its mma groups
constexpr int GF = 16;           // floats of one component's 8-feature group:
                                 // lane t's (hi f=t, hi t+4, lo t, lo t+4)
constexpr int LDR = TC + 8;      // row stride of the logp / r tile (floats)
constexpr int STAGE = GPS * TC * GF;      // floats of one coefficient buffer
constexpr int R_FLOATS = BM * LDR;
static_assert(2 * STAGE <= R_FLOATS,
              "the coefficient buffers live in the logp tile's memory");
// Step 1's warps: 4 quarters of the rows x 2 halves of the components.
constexpr int MT1 = 2;           // m16 tiles: 32 rows
constexpr int NT1 = 16;          // n8 tiles: 128 components
// Step 2's warps: 4 quarters of the components x 2 halves of a pass.
constexpr int MT2 = 4;           // m16 tiles: 64 components
constexpr int NT2 = 8;           // n8 tiles: 64 columns
constexpr int PASS = 128;        // columns of F in one moment pass
// Dynamic shared memory a block may use beside its static arrays.
constexpr int SMEM_LIMIT = 227 * 1024 - 4096;
constexpr float LOG_2PI = 1.8378770664093453f;

// D rounded up to 8: the width of each half of F, of the coefficients and
// of a table row.  F is 2 * padded_d(d) wide, whole slices of BK.
__host__ __device__ __forceinline__ int padded_d(int d) {
    return (d + 7) / 8 * 8;
}

// Row stride of the x_c tile: at least padded_d(d), and 8 modulo 32
// floats, so that step 2's F fragment loads (rows t, t + 4; columns g) hit
// 32 banks.
__host__ __device__ __forceinline__ int x_stride(int d) {
    const int dx = padded_d(d);
    return dx + ((8 - dx) % 32 + 32) % 32;
}

// Floats of a row of a block's table: s1 and s2 (padded_d(d) each), rsum,
// and one more so that the rows start 8-byte aligned for the moments'
// float2 additions.
__host__ __device__ __forceinline__ int table_width(int d) {
    return 2 * padded_d(d) + 2;
}

size_t smem_bytes(bool resident, int d) {
    return (size_t)R_FLOATS * 4
        + (resident ? (size_t)BM * x_stride(d) * 4 : 0);
}

bool x_resident(int d) { return smem_bytes(true, d) <= SMEM_LIMIT; }

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

__device__ __forceinline__ uint32_t tf32_rna(float v) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
    return r;
}

// v = hi + lo (to TF32 precision twice over); see the header for why there
// is no guard for a non-finite v.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
    hi = tf32_rna(v);
    lo = tf32_rna(v - __uint_as_float(hi));
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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// The rows of a row tile, as both products read them: x_c(r, c) for
// c < padded_d(d), 0 from column d on.  RESIDENT: from the x_c tile in
// shared memory (xs, rows ldx apart, zeros for rows of weight 0); else from
// device memory, centered on the fly, zero where ws <= 0.
template <bool RESIDENT>
struct Rows {
    const float* xs;
    int ldx;
    const float* x;
    const float* shift;
    const float* ws;
    long long row0;
    int d;

    __device__ __forceinline__ float xc(int r, int c) const {
        if (RESIDENT) return xs[r * ldx + c];
        return (c < d && ws[r] > 0.f)
            ? __ldg(x + (row0 + r) * (long long)d + c) - __ldg(shift + c)
            : 0.f;
    }
};

// The tile's weights, the running max and sum of its rows, and (RESIDENT)
// x_c of its rows into xs: the raw rows by cp.async (16-byte pieces where
// the rows allow), then centered in place, zeros for rows of weight <= 0 or
// beyond n and for the columns from d on.
template <bool RESIDENT>
__device__ __forceinline__ void load_tile(const float* __restrict__ x,
                                          const float* __restrict__ w,
                                          const float* __restrict__ shift,
                                          long long row0, long long n, int d,
                                          int ldx, float* xs, float* ws,
                                          float* row_m, float* row_s) {
    if (threadIdx.x < BM) {
        const long long row = row0 + threadIdx.x;
        ws[threadIdx.x] = row < n ? w[row] : 0.f;
        row_m[threadIdx.x] = -CUDART_INF_F;
        row_s[threadIdx.x] = 0.f;
    }
    if (!RESIDENT) return;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int dx = padded_d(d);
    const bool vec4 = (d & 3) == 0
        && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    for (int r = warp; r < BM; r += THREADS / 32) {
        const long long row = row0 + r;
        const float* xr = x + (row < n ? row : 0) * (long long)d;
        if (vec4) {
            for (int c = lane * 4; c < dx; c += 128)
                copy16(xs + r * ldx + c, row < n && c < d ? xr + c : x,
                       row < n && c < d);
        } else {
            for (int c = lane; c < dx; c += 32)
                copy4(xs + r * ldx + c, row < n && c < d ? xr + c : x,
                      row < n && c < d);
        }
    }
    copy_commit();
    copy_wait_all();
    __syncthreads();                   // every row has landed, ws is set
    for (int r = warp; r < BM; r += THREADS / 32) {
        const bool live = ws[r] > 0.f;
        for (int c = lane; c < dx; c += 32) {
            float* p = xs + r * ldx + c;
            *p = live && c < d ? *p - __ldg(shift + c) : 0.f;
        }
    }
}

// Copies slice s (features BK s .. BK s + BK - 1) of the split
// coefficients of components c0 .. c0 + TC - 1 into buf: group-major, so
// that the 16-byte loads of a quarter warp (two components, four lanes
// each) fall on 32 distinct banks; zeros beyond k.
__device__ __forceinline__ void copy_coef(float* buf,
                                          const float* __restrict__ cs,
                                          int c0, int k, int s, int groups) {
#pragma unroll
    for (int i = 0; i < (TC * GPS * 4) / THREADS; ++i) {
        const int e = threadIdx.x + i * THREADS;
        const int cen = e / (GPS * 4), grp = (e >> 2) % GPS, part = e & 3;
        const int c = c0 + cen;
        const float* src = cs + ((size_t)(c < k ? c : 0) * groups + GPS * s
                                 + grp) * GF + part * 4;
        copy16(buf + grp * TC * GF + cen * GF + part * 4, src, c < k);
    }
}

// One slice of step 1 into the warp's accumulators: its 32 rows (from
// rbase) against the 128 components of cb (the warp's first one; zeros
// beyond k); GPS groups of 8 features from f0, three products each, each
// group's products from zero, joined to acc by a rounding add.  No branch
// inside: the compiler interleaves the mma chains of two n8 tiles.
template <bool RESIDENT>
__device__ __forceinline__ void logp_slice(const Rows<RESIDENT>& rows,
                                           int rbase, int f0, int dx,
                                           const float* cb,
                                           float (&acc)[MT1][NT1][4]) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll 1
    for (int grp = 0; grp < GPS; ++grp) {
        const int f = f0 + grp * 8;
        const bool square = f >= dx;   // the same for the group
        const int c = (square ? f - dx : f) + t;
        uint32_t hi[MT1][4], lo[MT1][4];
#pragma unroll
        for (int m = 0; m < MT1; ++m) {
            const int r = rbase + m * 16 + g;
            float v[4] = {rows.xc(r, c), rows.xc(r + 8, c),
                          rows.xc(r, c + 4), rows.xc(r + 8, c + 4)};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                if (square) v[e] *= v[e];
                split(v[e], hi[m][e], lo[m][e]);
            }
        }
        const float* cg = cb + grp * TC * GF + g * GF + t * 4;
#pragma unroll
        for (int j = 0; j < NT1; j += 2) {
            uint32_t bh[2][2], bl[2][2];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
                const float4 b = *reinterpret_cast<const float4*>(
                    cg + (j + u) * 8 * GF);
                bh[u][0] = __float_as_uint(b.x);
                bh[u][1] = __float_as_uint(b.y);
                bl[u][0] = __float_as_uint(b.z);
                bl[u][1] = __float_as_uint(b.w);
            }
            float part[2][MT1][4];
#pragma unroll
            for (int u = 0; u < 2; ++u)
#pragma unroll
                for (int m = 0; m < MT1; ++m) {
#pragma unroll
                    for (int e = 0; e < 4; ++e) part[u][m][e] = 0.f;
                    mma_tf32(part[u][m], lo[m], bh[u][0], bh[u][1]);
                }
#pragma unroll
            for (int u = 0; u < 2; ++u)
#pragma unroll
                for (int m = 0; m < MT1; ++m)
                    mma_tf32(part[u][m], hi[m], bl[u][0], bl[u][1]);
#pragma unroll
            for (int u = 0; u < 2; ++u)
#pragma unroll
                for (int m = 0; m < MT1; ++m)
                    mma_tf32(part[u][m], hi[m], bh[u][0], bh[u][1]);
#pragma unroll
            for (int u = 0; u < 2; ++u)
#pragma unroll
                for (int m = 0; m < MT1; ++m)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        acc[m][j + u][e] += part[u][m][e];
        }
    }
}

// Step 1's product for the components c0 .. c0 + TC - 1, into acc: the
// coefficients stream through two buffers at rt, the next slice copied
// while the current one is multiplied (one barrier per slice).
template <bool RESIDENT>
__device__ __forceinline__ void logp_tile(const Rows<RESIDENT>& rows,
                                          const float* __restrict__ cs,
                                          int c0, int k, int dx, float* rt,
                                          float (&acc)[MT1][NT1][4]) {
    const int warp = threadIdx.x >> 5;
    const int rbase = (warp & 3) * 32;
    const int cw = (warp >> 2) * (NT1 * 8);
    const int groups = dx / 4;         // 8-feature groups of F
    const int slices = 2 * dx / BK;
#pragma unroll
    for (int m = 0; m < MT1; ++m)
#pragma unroll
        for (int j = 0; j < NT1; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
    __syncthreads();                   // every read of rt's last use is done
    copy_coef(rt, cs, c0, k, 0, groups);
    copy_commit();
    for (int s = 0; s < slices; ++s) {
        copy_wait_all();               // this slice has landed ...
        __syncthreads();               // ... for every thread, and the other
                                       // buffer has been read
        if (s + 1 < slices)
            copy_coef(rt + ((s + 1) & 1) * STAGE, cs, c0, k, s + 1, groups);
        copy_commit();
        if (c0 + cw < k)               // the same for the warp
            logp_slice(rows, rbase, s * BK, dx,
                       rt + (s & 1) * STAGE + cw * GF, acc);
    }
    __syncthreads();                   // the buffers have been read
}

// logp = acc + c1 into rt[row][component], -inf beyond k.
__device__ __forceinline__ void store_logp(const float (&acc)[MT1][NT1][4],
                                           const float* __restrict__ c1,
                                           int c0, int k, float* rt) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int rbase = (warp & 3) * 32;
    const int cw = (warp >> 2) * (NT1 * 8);
#pragma unroll
    for (int j = 0; j < NT1; ++j) {
        const int c = cw + j * 8 + 2 * t;
        const bool va = c0 + c < k, vb = c0 + c + 1 < k;
        const float ca = va ? __ldg(c1 + c0 + c) : 0.f;
        const float cb = vb ? __ldg(c1 + c0 + c + 1) : 0.f;
#pragma unroll
        for (int m = 0; m < MT1; ++m) {
            const int r = rbase + m * 16 + g;
            *reinterpret_cast<float2*>(rt + r * LDR + c) = make_float2(
                va ? acc[m][j][0] + ca : -CUDART_INF_F,
                vb ? acc[m][j][1] + cb : -CUDART_INF_F);
            *reinterpret_cast<float2*>(rt + (r + 8) * LDR + c) = make_float2(
                va ? acc[m][j][2] + ca : -CUDART_INF_F,
                vb ? acc[m][j][3] + cb : -CUDART_INF_F);
        }
    }
}

// The online max and sum of every row over the logp tile in rt, one warp
// for each row, rescaled on a new max.
__device__ __forceinline__ void row_stats(const float* rt, float* row_m,
                                          float* row_s) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll 2
    for (int i = 0; i < BM / 8; ++i) {
        const int r = warp * (BM / 8) + i;
        float v[TC / 32];
        float tm = -CUDART_INF_F;
#pragma unroll
        for (int q = 0; q < TC / 32; ++q) {
            v[q] = rt[r * LDR + lane + 32 * q];
            tm = fmaxf(tm, v[q]);
        }
        tm = warp_max(tm);
        const float mo = row_m[r];
        const float mn = fmaxf(mo, tm);
        float ts = 0.f;
        if (mn > -CUDART_INF_F) {
#pragma unroll
            for (int q = 0; q < TC / 32; ++q) ts += expf(v[q] - mn);
        }
        ts = warp_sum(ts);
        if (lane == 0) {
            row_s[r] = (mo > -CUDART_INF_F ? row_s[r] * expf(mo - mn) : 0.f)
                + ts;
            row_m[r] = mn;
        }
    }
}

// The scale w / s and w lse of every row once its max and sum are final;
// 0 for rows of weight <= 0.  One thread for each row.
__device__ __forceinline__ void finish_rows(const float* ws,
                                            const float* row_m,
                                            const float* row_s,
                                            float* row_scale,
                                            float* row_ll) {
    if (threadIdx.x >= BM) return;
    const int r = threadIdx.x;
    const float wr = ws[r], sr = row_s[r];
    const bool live = wr > 0.f;
    row_scale[r] = live ? wr / sr : 0.f;
    row_ll[r] = live ? wr * (row_m[r] + logf(sr)) : 0.f;
}

// The logp tile in rt becomes responsibilities in place: exp(logp - m) w / s
// for the rows of positive weight, 0 for the others (and beyond k).
__device__ __forceinline__ void to_resp(float* rt, const float* row_m,
                                        const float* row_scale) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll 2
    for (int i = 0; i < BM / 8; ++i) {
        const int r = warp * (BM / 8) + i;
        const float m = row_m[r], sc = row_scale[r];
#pragma unroll
        for (int q = 0; q < TC / 32; ++q) {
            float* p = rt + r * LDR + lane + 32 * q;
            *p = sc != 0.f ? expf(*p - m) * sc : 0.f;
        }
    }
}

// row_stats, finish_rows and to_resp in one pass, where one component tile
// holds all k: the same operations in the same order, so the same bits.
__device__ __forceinline__ void softmax_rows(float* rt, const float* ws,
                                             float* row_m, float* row_s,
                                             float* row_scale,
                                             float* row_ll) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll 2
    for (int i = 0; i < BM / 8; ++i) {
        const int r = warp * (BM / 8) + i;
        float p[TC / 32];
        float m = -CUDART_INF_F;
#pragma unroll
        for (int q = 0; q < TC / 32; ++q) {
            p[q] = rt[r * LDR + lane + 32 * q];
            m = fmaxf(m, p[q]);
        }
        m = warp_max(m);
        float s = 0.f;
        if (m > -CUDART_INF_F) {
#pragma unroll
            for (int q = 0; q < TC / 32; ++q) {
                p[q] = expf(p[q] - m);
                s += p[q];
            }
        }
        s = warp_sum(s);
        const float wr = ws[r];
        const bool live = wr > 0.f;
        const float sc = live ? wr / s : 0.f;
#pragma unroll
        for (int q = 0; q < TC / 32; ++q)
            rt[r * LDR + lane + 32 * q] = sc != 0.f ? p[q] * sc : 0.f;
        if (lane == 0) {
            row_m[r] = m;
            row_s[r] = s;
            row_scale[r] = sc;
            row_ll[r] = live ? wr * (m + logf(s)) : 0.f;
        }
    }
}

// Step 2's product for the components c0 .. c0 + TC - 1 (responsibilities
// in rt) into the block's table, PASS columns of F at a time; rsum from the
// same fragments in the first pass.  Each group of 8 rows: three products
// from zero (four independent chains, one for each m16 tile), joined to acc
// by a rounding add; no branch inside.
template <bool RESIDENT>
__device__ __forceinline__ void moments(const Rows<RESIDENT>& rows,
                                        const float* rt, int c0, int k, int d,
                                        int dx, float* __restrict__ table) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int cw = (warp & 3) * (MT2 * 16);   // the warp's components
    const int nw = (warp >> 2) * (NT2 * 8);   // its columns in a pass
    const int fp = 2 * dx, width = table_width(d);
    if (c0 + cw >= k) return;          // the same for the warp
    for (int col0 = 0; col0 < fp; col0 += PASS) {
        const int cb = col0 + nw;
        if (cb >= fp) continue;        // the same for the warp
        float acc[MT2][NT2][4];
        float rs[MT2][2];
#pragma unroll
        for (int m = 0; m < MT2; ++m) {
            rs[m][0] = rs[m][1] = 0.f;
#pragma unroll
            for (int j = 0; j < NT2; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
        }
#pragma unroll 1
        for (int r0 = 0; r0 < BM; r0 += 8) {
            uint32_t ahi[MT2][4], alo[MT2][4];
#pragma unroll
            for (int m = 0; m < MT2; ++m) {
                const float* p = rt + (r0 + t) * LDR + cw + m * 16 + g;
                const float v[4] = {p[0], p[8], p[4 * LDR], p[4 * LDR + 8]};
                rs[m][0] += v[0] + v[2];
                rs[m][1] += v[1] + v[3];
#pragma unroll
                for (int e = 0; e < 4; ++e) split(v[e], ahi[m][e], alo[m][e]);
            }
#pragma unroll
            for (int j = 0; j < NT2; ++j) {
                const int f = cb + j * 8;
                const bool square = f >= dx;   // the same for the warp
                // Columns from 2 dx on read column g: their sums are not kept.
                const int c = (f >= fp ? 0 : square ? f - dx : f) + g;
                float b0 = rows.xc(r0 + t, c), b1 = rows.xc(r0 + t + 4, c);
                if (square) {
                    b0 *= b0;
                    b1 *= b1;
                }
                uint32_t bh0, bl0, bh1, bl1;
                split(b0, bh0, bl0);
                split(b1, bh1, bl1);
                float prod[MT2][4];
#pragma unroll
                for (int m = 0; m < MT2; ++m) {
#pragma unroll
                    for (int e = 0; e < 4; ++e) prod[m][e] = 0.f;
                    mma_tf32(prod[m], alo[m], bh0, bh1);
                }
#pragma unroll
                for (int m = 0; m < MT2; ++m)
                    mma_tf32(prod[m], ahi[m], bl0, bl1);
#pragma unroll
                for (int m = 0; m < MT2; ++m)
                    mma_tf32(prod[m], ahi[m], bh0, bh1);
#pragma unroll
                for (int m = 0; m < MT2; ++m)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[m][j][e] += prod[m][e];
            }
        }
        // One lane owns each pair of entries: its additions arrive in
        // program order.  Four lanes fill a 32-byte sector of a table row.
#pragma unroll
        for (int m = 0; m < MT2; ++m)
#pragma unroll
            for (int j = 0; j < NT2; ++j)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int comp = c0 + cw + m * 16 + g + h * 8;
                    const int col = cb + j * 8 + 2 * t;   // even
                    const int c = col >= dx ? col - dx : col;
                    if (comp < k && c < d)
                        atomicAdd(reinterpret_cast<float2*>(
                                      table + (size_t)comp * width + col),
                                  make_float2(acc[m][j][2 * h],
                                              acc[m][j][2 * h + 1]));
                }
        if (col0 == 0 && nw == 0) {
#pragma unroll
            for (int m = 0; m < MT2; ++m)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    float s = rs[m][h];
                    s += __shfl_xor_sync(0xffffffffu, s, 1);
                    s += __shfl_xor_sync(0xffffffffu, s, 2);
                    const int comp = c0 + cw + m * 16 + g + 8 * h;
                    if (t == 0 && comp < k)
                        atomicAdd(table + (size_t)comp * width + fp, s);
                }
        }
    }
}

// PART selects what one launch does (the instance PART = WHOLE is the
// whole E-step above; the other two split it for a table whose components
// are spread over the ranks of a model axis, each rank holding a block):
//
//   WHOLE    steps 1 and 2 over all k components, as described at the top;
//   ROWS     step 1 only over the block's components: each row's max m and
//            sum s = sum_k exp(logp - m) go to row_m_io and row_s_io (a
//            block of inert components, every logp -inf, gives m = -inf
//            and s = 0); no table, no ll;
//   MOMENTS  step 2 only, from every row's global max M and sum S read from
//            row_m_io and row_s_io (the ranks' m and s combined by the
//            caller): scale w / S and ll term w (M + log S) per row, then
//            every component tile's logp recomputed, its responsibilities
//            and moments into the block's table.
constexpr int WHOLE = 0;
constexpr int ROWS = 1;
constexpr int MOMENTS = 2;

template <bool RESIDENT, int PART>
__global__ void __launch_bounds__(THREADS, 1)
estep_kernel(const float* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ shift, const float* __restrict__ cs,
             const float* __restrict__ c1, float* __restrict__ partial,
             double* __restrict__ ll_partial, long long n, int d, int k,
             float* __restrict__ row_m_io, float* __restrict__ row_s_io) {
    extern __shared__ __align__(16) float smem[];
    __shared__ float ws[BM];
    __shared__ float row_m[BM];        // running max_k logp of each row
    __shared__ float row_s[BM];        // running sum_k exp(logp - max)
    __shared__ float row_scale[BM];    // w / sum, 0 for rows of weight <= 0
    __shared__ float row_ll[BM];       // w lse, 0 for rows of weight <= 0
    float* rt = smem;                              // BM x LDR
    float* xs = smem + R_FLOATS;                   // BM x ldx (RESIDENT)
    const int ldx = x_stride(d);
    const int dx = padded_d(d);
    float* table =
        partial + (size_t)blockIdx.x * (size_t)k * (size_t)table_width(d);
    const int ctiles = (k + TC - 1) / TC;
    const int last = (ctiles - 1) * TC;
    // One tile holds all k: one pass over the rows gives the max, the sum
    // and the responsibilities.
    const bool fused = ctiles == 1;
    double ll = 0.0;

    const long long tiles = (n + BM - 1) / BM;
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const long long row0 = tile * BM;
        __syncthreads();               // the previous tile is done with smem
        load_tile<RESIDENT>(x, w, shift, row0, n, d, ldx, xs, ws, row_m,
                            row_s);
        const Rows<RESIDENT> rows{xs, ldx, x, shift, ws, row0, d};
        if constexpr (PART == MOMENTS) {
            if (threadIdx.x < BM) {
                const long long row = row0 + threadIdx.x;
                row_m[threadIdx.x] = row < n ? row_m_io[row] : 0.f;
                row_s[threadIdx.x] = row < n ? row_s_io[row] : 1.f;
            }
            finish_rows(ws, row_m, row_s, row_scale, row_ll);
            __syncthreads();
            if (threadIdx.x == 0) {
                double tile_ll = 0.0;
                for (int r = 0; r < BM; ++r) tile_ll += (double)row_ll[r];
                ll += tile_ll;
            }
        }

        // Step 1 (i < ctiles): every component tile's logp, the online max
        // and sum.  Step 2: responsibilities and moments, the last tile
        // first (its logp, or with one tile its responsibilities, are still
        // in rt), the others recomputed.
        // ROWS runs step 1 alone, MOMENTS step 2 alone in component order,
        // every tile recomputed.
        for (int i = PART == MOMENTS ? ctiles : 0;
             i < (PART == ROWS ? ctiles : 2 * ctiles); ++i) {
            const bool second = i >= ctiles;
            const bool first_of_second = PART == WHOLE && i == ctiles;
            const bool kept = first_of_second;
            const int c0 = !second ? i * TC
                         : PART == MOMENTS ? (i - ctiles) * TC
                         : first_of_second ? last : (i - ctiles - 1) * TC;
            if (!kept) {
                float acc[MT1][NT1][4];
                logp_tile(rows, cs, c0, k, dx, rt, acc);
                store_logp(acc, c1, c0, k, rt);
                __syncthreads();
            }
            if (!second) {
                if (fused && PART == WHOLE)
                    softmax_rows(rt, ws, row_m, row_s, row_scale, row_ll);
                else
                    row_stats(rt, row_m, row_s);
                continue;              // the next logp_tile's barrier keeps rt
            }
            if (first_of_second) {
                __syncthreads();       // every row's max and sum are final
                if (!fused) {
                    finish_rows(ws, row_m, row_s, row_scale, row_ll);
                    __syncthreads();
                }
                if (threadIdx.x == 0) {
                    double tile_ll = 0.0;
                    for (int r = 0; r < BM; ++r) tile_ll += (double)row_ll[r];
                    ll += tile_ll;
                }
            }
            if (!(kept && fused)) {
                to_resp(rt, row_m, row_scale);
                __syncthreads();
            }
            moments(rows, rt, c0, k, d, dx, table);
        }
        if constexpr (PART == ROWS) {
            __syncthreads();           // every row's max and sum are final
            if (threadIdx.x < BM && row0 + threadIdx.x < n) {
                row_m_io[row0 + threadIdx.x] = row_m[threadIdx.x];
                row_s_io[row0 + threadIdx.x] = row_s[threadIdx.x];
            }
        }
    }
    if (PART != ROWS && threadIdx.x == 0) ll_partial[blockIdx.x] = ll;
}

// The split coefficients cs (k rows of padded_d(d) / 4 groups x GF floats:
// for group q and lane t, hi and lo of the coefficients at features 8q + t
// and 8q + t + 4, [b, 0 ..., -a/2, 0 ...] each half padded_d(d) wide) and
// c1 (k,); one warp for each component.
__global__ void estep_tables_kernel(const float* __restrict__ means_c,
                                    const float* __restrict__ inv_var,
                                    const float* __restrict__ log_det,
                                    const float* __restrict__ log_weights,
                                    float* __restrict__ cs,
                                    float* __restrict__ c1, int d, int k) {
    const int lane = threadIdx.x & 31;
    const int c = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (c >= k) return;
    const float* mu = means_c + (size_t)c * d;
    const float* a = inv_var + (size_t)c * d;
    float q = 0.f;
    for (int j = lane; j < d; j += 32) q = fmaf(mu[j], mu[j] * a[j], q);
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
        q += __shfl_xor_sync(0xffffffffu, q, off);
    if (lane == 0)
        c1[c] = log_weights[c] - 0.5f * ((float)d * LOG_2PI + log_det[c] + q);
    const int dx = padded_d(d);
    float4* out = reinterpret_cast<float4*>(cs + (size_t)c * dx * 4);
    for (int e = lane; e < dx; e += 32) {          // (group, t) pairs
        const int f = (e >> 2) * 8 + (e & 3);
        uint32_t hi[2], lo[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
            const int col = f + 4 * u;
            const bool square = col >= dx;
            const int j = square ? col - dx : col;
            const float v = j >= d ? 0.f
                          : square ? -0.5f * a[j] : mu[j] * a[j];
            split(v, hi[u], lo[u]);
        }
        out[e] = make_float4(__uint_as_float(hi[0]), __uint_as_float(hi[1]),
                             __uint_as_float(lo[0]), __uint_as_float(lo[1]));
    }
}

// rsum (k,), s1 and s2 (k, D) and ll () from the blocks' partials, added in
// block order.  The thread after the last output sums ll.
__global__ void estep_reduce_kernel(const float* __restrict__ partial,
                                    const double* __restrict__ ll_partial,
                                    float* __restrict__ rsum,
                                    float* __restrict__ s1,
                                    float* __restrict__ s2,
                                    float* __restrict__ ll,
                                    int blocks, int d, int k) {
    const int per = 2 * d + 1;         // the outputs of one component
    const size_t total = (size_t)k * (size_t)per;
    const size_t table = (size_t)k * (size_t)table_width(d);
    const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (e > total) return;
    if (e == total) {
        double acc = 0.0;
        for (int b = 0; b < blocks; ++b) acc += ll_partial[b];
        *ll = (float)acc;
        return;
    }
    const size_t c = e / per;
    const int col = (int)(e % per);
    const int dx = padded_d(d);
    const int at = col < d ? col : col < 2 * d ? dx + (col - d) : 2 * dx;
    const size_t src = c * (size_t)table_width(d) + at;
    float s = 0.f;
    for (int b = 0; b < blocks; ++b) s += partial[(size_t)b * table + src];
    if (col < d) s1[c * d + col] = s;
    else if (col < 2 * d) s2[c * d + (col - d)] = s;
    else rsum[c] = s;
}

// Launches estep_kernel with the dynamic shared memory of its x layout and
// the largest shared-memory share of the SM.
template <bool RESIDENT, int PART>
int launch_estep(const float* x, const float* w, const float* shift,
                 const float* cs, const float* c1, float* partial,
                 double* ll_partial, long long n, int d, int k, int blocks,
                 cudaStream_t st, float* row_m_io = nullptr,
                 float* row_s_io = nullptr) {
    const size_t bytes = smem_bytes(RESIDENT, d);
    int err = (int)cudaFuncSetAttribute(
        estep_kernel<RESIDENT, PART>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err == 0)
        err = (int)cudaFuncSetAttribute(
            estep_kernel<RESIDENT, PART>,
            cudaFuncAttributePreferredSharedMemoryCarveout,
            (int)cudaSharedmemCarveoutMaxShared);
    if (err != 0) return err;
    estep_kernel<RESIDENT, PART><<<blocks, THREADS, bytes, st>>>(
        x, w, shift, cs, c1, partial, ll_partial, n, d, k, row_m_io,
        row_s_io);
    return (int)cudaGetLastError();
}

// The per-component tables of both products (estep_tables_kernel).
int launch_tables(const float* means_c, const float* inv_var,
                  const float* log_det, const float* log_weights, float* coef,
                  float* c1, int d, int k, cudaStream_t st) {
    const int warps = 8;
    estep_tables_kernel<<<(k + warps - 1) / warps, warps * 32, 0, st>>>(
        means_c, inv_var, log_det, log_weights, coef, c1, d, k);
    return (int)cudaGetLastError();
}

// The blocks' tables and ll partials into rsum, s1, s2, ll.
int launch_reduce(const float* partial, const double* ll_partial,
                  float* rsum, float* s1, float* s2, float* ll, int blocks,
                  int d, int k, cudaStream_t st) {
    const size_t total = (size_t)k * (size_t)(2 * d + 1) + 1;
    const int rt = 256;
    estep_reduce_kernel<<<(unsigned)((total + rt - 1) / rt), rt, 0, st>>>(
        partial, ll_partial, rsum, s1, s2, ll, blocks, d, k);
    return (int)cudaGetLastError();
}

}  // namespace

// Rows of a block's tile; the wrapper sizes its grid by it.
extern "C" int gmm_estep_tile_rows(void) { return BM; }

// Floats of the `coef` scratch: the split coefficients, k rows of
// 4 * padded_d(d) floats.
extern "C" long long gmm_estep_coef_floats(int d, int k) {
    return (long long)k * 4 * padded_d(d);
}

// Floats of one block's table in `partial`: k rows of table_width(d).
extern "C" long long gmm_estep_table_floats(int d, int k) {
    return (long long)k * table_width(d);
}

// Enqueues the three kernels on `stream`, does not synchronise, and returns
// the first cudaError_t that a launch reported, 0 if none did.  `coef` is
// scratch of gmm_estep_coef_floats(d, k) floats, 16-byte aligned, and `c1`
// of k floats; `partial` scratch of blocks * gmm_estep_table_floats(d, k)
// floats that must be zero, `ll_partial` scratch of `blocks` doubles.
// `blocks` is the number of persistent blocks, at least 1 (one runs on each
// SM).
extern "C" int gmm_diag_estep_launch(
        const float* x, const float* w, const float* shift,
        const float* means_c, const float* inv_var, const float* log_det,
        const float* log_weights, float* coef, float* c1, float* partial,
        double* ll_partial, float* rsum, float* s1, float* s2, float* ll,
        long long n, int d, int k, int blocks, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    int err = launch_tables(means_c, inv_var, log_det, log_weights, coef, c1,
                            d, k, st);
    if (err != 0) return err;
    err = x_resident(d)
        ? launch_estep<true, WHOLE>(x, w, shift, coef, c1, partial,
                                    ll_partial, n, d, k, blocks, st)
        : launch_estep<false, WHOLE>(x, w, shift, coef, c1, partial,
                                     ll_partial, n, d, k, blocks, st);
    if (err != 0) return err;
    return launch_reduce(partial, ll_partial, rsum, s1, s2, ll, blocks, d, k,
                         st);
}

// Launch (a) of the model axis: the tables and estep_kernel<ROWS> over the
// block's k components, writing every row's max and sum into row_m and
// row_s (n floats each).  Scratch as in gmm_diag_estep_launch.
extern "C" int gmm_diag_estep_rows_launch(
        const float* x, const float* w, const float* shift,
        const float* means_c, const float* inv_var, const float* log_det,
        const float* log_weights, float* coef, float* c1, float* row_m,
        float* row_s, long long n, int d, int k, int blocks, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    int err = launch_tables(means_c, inv_var, log_det, log_weights, coef, c1,
                            d, k, st);
    if (err != 0) return err;
    return x_resident(d)
        ? launch_estep<true, ROWS>(x, w, shift, coef, c1, nullptr, nullptr, n,
                                   d, k, blocks, st, row_m, row_s)
        : launch_estep<false, ROWS>(x, w, shift, coef, c1, nullptr, nullptr,
                                    n, d, k, blocks, st, row_m, row_s);
}

// Launch (b) of the model axis: the tables, estep_kernel<MOMENTS> from every
// row's global max and sum (row_m, row_s: n floats each, read only) and the
// reduction, as gmm_diag_estep_launch.
extern "C" int gmm_diag_estep_moments_launch(
        const float* x, const float* w, const float* shift,
        const float* means_c, const float* inv_var, const float* log_det,
        const float* log_weights, float* row_m, float* row_s, float* coef,
        float* c1, float* partial, double* ll_partial, float* rsum,
        float* s1, float* s2, float* ll, long long n, int d, int k,
        int blocks, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    int err = launch_tables(means_c, inv_var, log_det, log_weights, coef, c1,
                            d, k, st);
    if (err != 0) return err;
    err = x_resident(d)
        ? launch_estep<true, MOMENTS>(x, w, shift, coef, c1, partial,
                                      ll_partial, n, d, k, blocks, st, row_m,
                                      row_s)
        : launch_estep<false, MOMENTS>(x, w, shift, coef, c1, partial,
                                       ll_partial, n, d, k, blocks, st, row_m,
                                       row_s);
    if (err != 0) return err;
    return launch_reduce(partial, ll_partial, rsum, s1, s2, ll, blocks, d, k,
                         st);
}
