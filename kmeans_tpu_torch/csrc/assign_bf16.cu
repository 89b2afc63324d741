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
//                                    centroids, and bf16(c) as tile images
//                                    in the shared-memory layout (below)
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
// 2*n*k*D operations at the tensor cores' bf16 rate (989 TFLOP/s): at
// n = 2,097,152, D = 128, k = 1024 that is 0.56 ms, beside 0.32 ms to read
// x once and write the labels.  The scatter is n*D multiply-adds, a k-th of
// the product, but it goes through per-block tables in device memory.
//
// The design.  One persistent block per SM walks row tiles of TILE_N rows:
//
// * Two consumer warpgroups (one for TILE_N = 64), each owning 64 rows, and
//   a producer warpgroup, of which one thread issues the copies and which
//   hands most of its registers to the consumers (setmaxnreg).  The two
//   consumer warpgroups meet only at the ring (and at the scatter).  The
//   products are wgmma.m64n{TILE_K}k16 bf16 ->
//   float32, both operands read from shared memory by descriptor, in the
//   K-major layout with the 128-byte swizzle: a 64-feature chunk of a row is
//   128 bytes, rows follow at 128 bytes, and the 16-byte unit u of row r
//   sits at unit u ^ (r % 8).  Features are zero-padded to whole chunks,
//   and the product runs all four 16-feature k-steps of each chunk,
//   unrolled: a k-step loop with a bound known only at run time left the
//   wgmma instructions serialized, 13 % slower at D = 128.
// * The x tile is rounded to bf16 once per row tile, by the warp that owns
//   the rows in the accumulator layout, and stays in shared memory while the
//   block walks all centroid tiles; ||x||^2 comes from the unrounded values
//   of the same pass.  While a tile's products run, each warpgroup's rows of
//   the next row tile come into a float32 staging buffer by cp.async, so x
//   is read from device memory once per call.
// * prep_centroids_kernel writes bf16(c) once per call as a sequence of
//   tile images, TILE_K rows each, zero past k and D, already in the
//   swizzled layout; the producer moves one image with one
//   cp.async.bulk (no tensor map), and the tile's h with another, into a
//   ring of tiles with a full and an empty mbarrier for each slot.  At
//   k = 1024, D = 128 all images are 256 KB and stay in the L2 cache.
// * The accumulator of warp w of a warpgroup holds rows 16w + g and
//   16w + g + 8 at columns 8j + 2t and 8j + 2t + 1 (g = lane / 4,
//   t = lane % 4): the m16n8 layout of tile_min in assign_common.cuh, shared
//   with the float32 kernels.  Each centroid tile's epilogue is tile_min_h,
//   a copy of it with the same rules (the h subtraction in float32, the mask
//   by index past k, the lowest index on a tie, the NaN flags) that reads h
//   from the slot and skips the mask on a full tile; the slot goes back to
//   the producer after the epilogue.
// * Wide rows.  Where the x tile, the ring and the staging buffer do not
//   fit in shared memory, the staging buffer goes first (x is then read at
//   the start of each row tile); where the x tile and the ring do not fit,
//   the features are walked in slices of a few chunks, and the x slice is
//   rounded again for every centroid tile (RESIDENT = false).
//
// The segmented sum: every persistent block adds into a (k, D + 1) table of
// its own, one thread owns each (column, label class) pair and walks the
// tile's rows in order, reading bf16(x) from the x tile in shared memory,
// and reduce_partials_kernel adds the tables in block order.  Two runs give
// the same bits.
//
// Compile-time variants (the variant lab, experiments/exp_pallas_kernel.py,
// builds them with -D): KM_TILE_N, rows of a block's tile (128 or 64: two
// consumer warpgroups or one); KM_TILE_K, centroids of a tile (128 or 64,
// the N of the wgmma); KM_PIPE, 1 for a ring of two centroid tiles (the
// next tile's copy runs during the current tile's products and epilogue),
// 0 for one (copy, wait, multiply).  The defaults are the main path's
// build.

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

constexpr int BM = KM_TILE_N;         // rows of x in a block's tile
constexpr int BN = KM_TILE_K;         // centroids in a tile
constexpr int SLOTS = KM_PIPE ? 2 : 1;   // centroid tiles in the ring
constexpr int NT = BN / 8;            // n8 column blocks of an accumulator
constexpr int CONSUMERS = 2 * BM;     // one warpgroup for every 64 rows
constexpr int CWARPS = CONSUMERS / 32;
constexpr int THREADS = CONSUMERS + 128;  // and a producer warpgroup
// Registers a thread holds after the split (setmaxnreg): the producer
// warpgroup gives most of its share to the consumers (at the 168 that a
// block of 9 or 12 warps leaves each thread, the wide-row instances
// spilled).
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int ROW_BYTES = 128;        // a 64-feature chunk of a row, bf16
constexpr int SMEM_LIMIT = 227 * 1024;   // dynamic shared memory of a block
static_assert(BM == 128 || BM == 64, "KM_TILE_N: 128 or 64 rows");
static_assert(BN == 128 || BN == 64, "KM_TILE_K: 128 or 64 centroids");
static_assert(KM_PIPE == 0 || KM_PIPE == 1, "KM_PIPE: 0 or 1");

// How a call lays out shared memory, from D alone (computed on the host).
struct Plan {
    int nch;          // 64-feature chunks of a padded row
    int fsc;          // chunks of a slice (all nch where the x tile stays)
    int nsl;          // slices of a row
    int prefetch;     // 1: the next row tile comes in by cp.async
    unsigned slot_bytes;   // one slot of the ring: BN x fsc chunks, then
                           // the tile's h (BN floats) in 1 KB
    unsigned x_off, stage_off, x2s_off, bar_off;   // from the aligned base
    unsigned smem_bytes;   // dynamic shared memory of the launch
};

Plan make_plan(int d) {
    Plan p{};
    p.nch = (d + 63) / 64;
    const size_t per_chunk = (size_t)(BM + SLOTS * BN) * ROW_BYTES;
    // h of each slot, x2s, ws, lab_s, the barriers
    const size_t tail = SLOTS * 1024 + 3 * BM * 4 + 2 * SLOTS * 8;
    const size_t stage = ((size_t)BM * d * 4 + 15) / 16 * 16;
    const size_t room = SMEM_LIMIT - 1024 - tail;    // 1 KB to align
    if (p.nch * per_chunk + stage <= room) {
        p.fsc = p.nch;
        p.prefetch = 1;
    } else {
        p.fsc = p.nch * per_chunk <= room ? p.nch : (int)(room / per_chunk);
        p.prefetch = 0;
    }
    p.nsl = (p.nch + p.fsc - 1) / p.fsc;
    p.slot_bytes = (unsigned)(BN * p.fsc * ROW_BYTES + 1024);
    p.x_off = SLOTS * p.slot_bytes;
    p.stage_off = p.x_off + BM * p.fsc * ROW_BYTES;
    p.x2s_off = p.stage_off + (p.prefetch ? (unsigned)stage : 0u);
    p.bar_off = p.x2s_off + 3 * BM * 4;
    p.smem_bytes = p.bar_off + 2 * SLOTS * 8 + 1024;
    return p;
}

struct Args {
    const float* x;
    const float* w;              // fused kernel only
    const unsigned char* img;    // bf16(c) as tile images
    const float* h;
    int* labels;
    float* mind2;                // may be null
    float* partial;              // fused kernel only
    long long n;
    int d, k;
    Plan p;
};

// ---------------------------------------------------------------- PTX pieces

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void consumer_sync() {
    asm volatile("bar.sync 1, %0;\n" :: "n"(CONSUMERS) : "memory");
}

// The 128 threads of consumer warpgroup `wg` (named barriers 2 and 3).
__device__ __forceinline__ void warpgroup_sync(int wg) {
    asm volatile("bar.sync %0, 128;\n" :: "r"(2 + wg) : "memory");
}

// Shared-memory writes of this thread become visible to the tensor cores'
// (async proxy) reads after the next barrier.
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

// Until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done = 0;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    } while (!done);
}

// `bytes` bytes from device memory to shared memory; the copy's bytes
// complete the transaction count of `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Shared-memory matrix descriptor of a K-major operand with the 128-byte
// swizzle: 8-row groups 1024 bytes apart (the leading offset is unused in
// this layout).  `addr` is 16-byte aligned inside a 1024-byte aligned group.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFFu) >> 4)
           | ((uint64_t)1 << 16)
           | ((uint64_t)(1024 >> 4) << 32)
           | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous product.
__device__ __forceinline__ void fence_acc(float (&acc)[NT][4]) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(acc[j][e]) :: "memory");
}

// d (+)= A (64 x 16) . B (16 x N), bf16 from shared memory by descriptor,
// float32 accumulators in the m16n8 layout; scale_d = 0 starts from zero.
__device__ __forceinline__ void wgmma_m64n128(float (&d)[16][4], uint64_t a,
                                              uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n64(float (&d)[8][4], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tile(float (&acc)[NT][4], uint64_t a,
                                           uint64_t b, int scale_d) {
#if KM_TILE_K == 128
    wgmma_m64n128(acc, a, b, scale_d);
#else
    wgmma_m64n64(acc, a, b, scale_d);
#endif
}

// ------------------------------------------------------------- the x tile

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

// Byte offset of the 16-byte unit u (features 8u .. 8u + 7 of chunk q) of
// row r, in a tile of `rows` rows laid out chunk after chunk.
__device__ __forceinline__ uint32_t unit_offset(int q, int r, int u,
                                                int rows) {
    return (uint32_t)(q * rows * ROW_BYTES + r * ROW_BYTES
                      + ((u ^ (r & 7)) << 4));
}

// Features col .. col + 7 of one row, zero past d (VEC4: d % 4 == 0 and
// the row 16-byte aligned).
template <bool VEC4>
__device__ __forceinline__ void load8(const float* row, int col, int d,
                                      float v[8]) {
    if (VEC4) {
        const float4 a = col < d ? *reinterpret_cast<const float4*>(row + col)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 b = col + 4 < d
            ? *reinterpret_cast<const float4*>(row + col + 4)
            : make_float4(0.f, 0.f, 0.f, 0.f);
        v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
        v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = col + e < d ? row[col + e] : 0.f;
    }
}

// Chunks q0 .. q0 + nq - 1 of the warp's own 16 rows (16 w .. 16 w + 15,
// its rows in the accumulator layout) into the x tile, bf16, from `src`
// (row 0 of the row tile, float32, rows `d` apart: the staging buffer or
// device memory); rows from `valid` on are zero.  With `norms` also
// ||x_r||^2 of those features from the unrounded values, into x2s[r]
// (added to it unless q0 == 0).  A row takes `lpr` lanes (its units
// rounded up to a power of two, at most 32), so a warp fills 32 / lpr rows
// at a time.
template <bool VEC4>
__device__ __forceinline__ void build_rows(const float* src, int valid,
                                           int d, int q0, int nq,
                                           unsigned char* xt, float* x2s,
                                           bool norms) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int units = nq * 8;
    const int lpr = units > 16 ? 32 : units > 8 ? 16 : 8;
    const int ul = lane & (lpr - 1);
    for (int rr = lane / lpr; rr < 16; rr += 32 / lpr) {
        const int r = warp * 16 + rr;
        const float* row = src + (size_t)r * d;
        float s = 0.f;
        for (int u = ul; u < units; u += lpr) {
            float v[8];
            if (r < valid) {
                load8<VEC4>(row, q0 * 64 + u * 8, d, v);
            } else {
#pragma unroll
                for (int e = 0; e < 8; ++e) v[e] = 0.f;
            }
#pragma unroll
            for (int e = 0; e < 8; ++e) s = fmaf(v[e], v[e], s);
            *reinterpret_cast<uint4*>(xt + unit_offset(u >> 3, r, u & 7, BM)) =
                make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                           pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
        }
        if (norms) {
            for (int off = lpr >> 1; off >= 1; off >>= 1)
                s += __shfl_xor_sync(0xffffffffu, s, off);
            if (ul == 0) x2s[r] = (q0 == 0 ? 0.f : x2s[r]) + s;
        }
    }
}

// The float32 rows of consumer warpgroup `wg` (rows 64 wg .. 64 wg + 63)
// of row tile row0 into its half of the staging buffer, by cp.async (one
// commit group of the warpgroup's threads); rows past n are not copied.
template <bool VEC4>
__device__ __forceinline__ void stage_rows(const float* __restrict__ x,
                                           long long row0, long long n,
                                           int d, uint32_t stage, int wg) {
    const long long first = row0 + 64 * wg;
    const long long left = n - first;
    const int rows = left <= 0 ? 0 : left < 64 ? (int)left : 64;
    const float* src = x + first * (long long)d;
    const uint32_t dst = stage + (uint32_t)(64 * wg * d * 4);
    const int total = rows * d;
    const int tid = threadIdx.x & 127;
    if (VEC4) {
        for (int e = tid; e < total / 4; e += 128)
            cp_async16(dst + 16u * e, src + 4 * e);
    } else {
        for (int e = tid; e < total; e += 128)
            cp_async4(dst + 4u * e, src + e);
    }
    cp_async_commit();
}

// The epilogue of one centroid tile: tile_min of assign_common.cuh in
// another form, with its rules (score = h - acc in float32, columns past k
// masked by index, a lane's columns in rising order with a strict "<" in
// two interleaved chains merged by take_min, then the quad; the NaN flags
// into `bad`; the running pair moves only on a strict "<").  Here h comes
// from the tile's slot in shared memory (hs[c] for column c0 + c), and a
// full tile (FULL) has no column past k to mask.
template <bool FULL>
__device__ __forceinline__ void tile_min_h(const float (&acc)[NT][4],
                                           const float* hs, int c0, int k,
                                           float best_v[2], int best_i[2],
                                           unsigned& bad) {
    const int base = c0 + 2 * (threadIdx.x & 3);
    float2 hv[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j)
        hv[j] = *reinterpret_cast<const float2*>(hs + 8 * j
                                                 + 2 * (threadIdx.x & 3));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        float v[2] = {CUDART_INF_F, CUDART_INF_F};
        int idx[2] = {NO_INDEX, NO_INDEX};
        bool nan = false;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int off = j * 8 + e;
                const float sc = (e ? hv[j].y : hv[j].x) - acc[j][2 * r + e];
                if (FULL || base + off < k) {
                    nan |= (sc != sc);
                    if (sc < v[j & 1]) { v[j & 1] = sc; idx[j & 1] = off; }
                }
            }
#pragma unroll
        for (int c = 0; c < 2; ++c)
            if (idx[c] != NO_INDEX) idx[c] += base;
        take_min(v[0], idx[0], v[1], idx[1]);
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
            const float ov = __shfl_xor_sync(0xffffffffu, v[0], off);
            const int oi = __shfl_xor_sync(0xffffffffu, idx[0], off);
            const int on = __shfl_xor_sync(0xffffffffu, (int)nan, off);
            take_min(v[0], idx[0], ov, oi);
            nan |= (on != 0);
        }
        bad |= (unsigned)nan << r;
        if (v[0] < best_v[r]) { best_v[r] = v[0]; best_i[r] = idx[0]; }
    }
}

// Writes the labels (and mind2) of a tile from lane 0 of each quad, in the
// layout of tile_min (one warp for every 16 rows); with KEEP also leaves the
// labels in lab_s for the scatter.  A row whose scores met a NaN (bit r of
// `bad`) gets label 0 and the minimum +inf.
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

// ------------------------------------------------------------- the kernels

// The producer: one thread walks the consumers' sequence of (row tile,
// centroid tile, slice) and copies each slice's image into the next slot of
// the ring once the consumers have released it.
__device__ __forceinline__ void produce(const Args& a, uint32_t ring,
                                        uint32_t full0, uint32_t empty0) {
    const Plan& p = a.p;
    const long long tiles = (a.n + BM - 1) / BM;
    const int ktiles = (a.k + BN - 1) / BN;
    const size_t image = (size_t)BN * p.nch * ROW_BYTES;
    uint32_t it = 0;
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x)
        for (int j = 0; j < ktiles; ++j)
            for (int f = 0; f < p.nsl; ++f, ++it) {
                const uint32_t s = it % SLOTS;
                mbar_wait(empty0 + 8 * s, ((it / SLOTS) & 1u) ^ 1u);
                const int q0 = f * p.fsc;
                const int nq = min(p.fsc, p.nch - q0);
                const uint32_t bytes = (uint32_t)(BN * nq * ROW_BYTES);
                const uint32_t slot = ring + s * p.slot_bytes;
                mbar_expect_tx(full0 + 8 * s, bytes + BN * 4);
                bulk_copy(slot,
                          a.img + j * image + (size_t)q0 * BN * ROW_BYTES,
                          bytes, full0 + 8 * s);
                // The tile's h; past k it reads on into the scratch, and
                // the epilogue masks those columns by index.
                bulk_copy(slot + BN * p.fsc * ROW_BYTES, a.h + j * BN,
                          BN * 4, full0 + 8 * s);
            }
}

template <bool FUSED, bool VEC4, bool RESIDENT>
__device__ __forceinline__ void kmeans_bf16_body(const Args& a) {
    extern __shared__ unsigned char smem_raw[];
    const Plan& p = a.p;
    const uint32_t raw = smem_u32(smem_raw);
    unsigned char* base = smem_raw + (((raw + 1023u) & ~1023u) - raw);
    const uint32_t ring = smem_u32(base);
    unsigned char* xt = base + p.x_off;
    const uint32_t xt_s = smem_u32(xt);
    float* stage = reinterpret_cast<float*>(base + p.stage_off);
    float* x2s = reinterpret_cast<float*>(base + p.x2s_off);
    float* ws = x2s + BM;
    int* lab_s = reinterpret_cast<int*>(ws + BM);
    const uint32_t full0 = smem_u32(base + p.bar_off);
    const uint32_t empty0 = full0 + 8 * SLOTS;

    if (threadIdx.x == 0) {
        for (int s = 0; s < SLOTS; ++s) {
            mbar_init(full0 + 8 * s, 1);
            mbar_init(empty0 + 8 * s, CWARPS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x >= CONSUMERS) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                     :: "n"(PRODUCER_REGS));
        if (threadIdx.x == CONSUMERS) produce(a, ring, full0, empty0);
        return;
    }
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(CONSUMER_REGS));

    const int lane = threadIdx.x & 31;
    const int wg = threadIdx.x >> 7;              // consumer warpgroup
    const int d = a.d, k = a.k;
    const long long n = a.n;
    const long long tiles = (n + BM - 1) / BM;
    const int ktiles = (k + BN - 1) / BN;
    // The x tile is built once per row tile, or (wide rows) once per
    // centroid tile and slice.
    constexpr bool STREAM_X = !RESIDENT;

    // The scatter: one thread for each (column, label class) pair; with
    // `groups` classes, class g takes the rows whose label is g modulo
    // `groups`, so no two threads ever add into the same entry.
    const int dq = d + 1;              // the last column holds the counts
    const int groups = dq >= CONSUMERS ? 1 : CONSUMERS / dq;
    const int cols = dq >= CONSUMERS ? CONSUMERS : dq;
    const int group = threadIdx.x / cols;
    const int col0 = threadIdx.x % cols;
    float* table = FUSED ? a.partial + (size_t)blockIdx.x * (size_t)k
                                       * (size_t)dq
                         : nullptr;

    // Each warpgroup stages, rounds and multiplies its own 64 rows: the two
    // meet only at the ring (and, in the fused kernel, at the scatter).
    if (RESIDENT && p.prefetch && blockIdx.x < tiles)
        stage_rows<VEC4>(a.x, (long long)blockIdx.x * BM, n, d,
                         smem_u32(stage), wg);
    uint32_t it = 0;
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
        const long long row0 = t * BM;
        const int valid = n - row0 < BM ? (int)(n - row0) : BM;
        const float* rows = a.x + row0 * (long long)d;
        if (FUSED && (threadIdx.x & 127) < 64) {
            const int r = 64 * wg + (threadIdx.x & 127);
            ws[r] = r < valid ? a.w[row0 + r] : 0.f;
        }
        if (RESIDENT) {
            if (p.prefetch) {
                cp_async_wait_all();
                warpgroup_sync(wg);        // its staged rows are all in
            }
            build_rows<VEC4>(p.prefetch ? stage : rows, valid, d, 0, p.nch,
                             xt, x2s, true);
            fence_proxy_async();
            warpgroup_sync(wg);            // its rows of the x tile are in
            if (p.prefetch && t + gridDim.x < tiles)
                stage_rows<VEC4>(a.x, (t + gridDim.x) * BM, n, d,
                                 smem_u32(stage), wg);
        }

        float best_v[2] = {CUDART_INF_F, CUDART_INF_F};
        int best_i[2] = {0, 0};
        unsigned bad = 0;
        float acc[NT][4];
        for (int j = 0; j < ktiles; ++j) {
            uint32_t s = 0;
            for (int f = 0; f < p.nsl; ++f, ++it) {
                const int q0 = f * p.fsc;
                const int nq = min(p.fsc, p.nch - q0);
                if (STREAM_X) {
                    build_rows<VEC4>(rows, valid, d, q0, nq, xt, x2s, j == 0);
                    fence_proxy_async();
                    warpgroup_sync(wg);
                }
                s = it % SLOTS;
                mbar_wait(full0 + 8 * s, (it / SLOTS) & 1u);
                __syncwarp();
                const uint32_t slot = ring + s * p.slot_bytes;
                wgmma_fence();
                fence_acc(acc);
                for (int q = 0; q < nq; ++q) {
#pragma unroll
                    for (int kk = 0; kk < 4; ++kk) {
                        const uint32_t kb = kk * 32;   // 16 bf16 = 32 bytes
                        const uint64_t da = sw128_desc(
                            xt_s + q * BM * ROW_BYTES + wg * 64 * ROW_BYTES + kb);
                        const uint64_t db = sw128_desc(slot + q * BN * ROW_BYTES + kb);
                        wgmma_tile(acc, da, db, f > 0 || q > 0 || kk > 0);
                    }
                }
                wgmma_commit();
                wgmma_wait_all();
                fence_acc(acc);
                if (f + 1 < p.nsl) {       // the last slot goes after the
                    __syncwarp();          // epilogue, which reads its h
                    if (lane == 0) mbar_arrive(empty0 + 8 * s);
                }
            }
            const float* hs = reinterpret_cast<const float*>(
                base + s * p.slot_bytes + BN * p.fsc * ROW_BYTES);
            if ((j + 1) * BN <= k)
                tile_min_h<true>(acc, hs, j * BN, k, best_v, best_i, bad);
            else
                tile_min_h<false>(acc, hs, j * BN, k, best_v, best_i, bad);
            __syncwarp();
            if (lane == 0) mbar_arrive(empty0 + 8 * s);
        }
        write_tile<FUSED>(best_v, best_i, bad, row0, n, x2s, a.labels,
                          a.mind2, lab_s);

        if (FUSED) {
            consumer_sync();               // labels and weights are in
            if (group < groups) {
                // Four rows at a time (loads first, then the adds); for each
                // entry the rows still arrive in order.
                for (int r0 = 0; r0 < BM; r0 += 4) {
                    float wv[4];
                    int lv[4];
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        wv[i] = ws[r0 + i];
                        lv[i] = lab_s[r0 + i];
                    }
                    if (wv[0] == 0.f && wv[1] == 0.f && wv[2] == 0.f
                        && wv[3] == 0.f)
                        continue;                  // zero-weight rows: inert
                    for (int col = col0; col < dq; col += cols) {
                        float v[4];
#pragma unroll
                        for (int i = 0; i < 4; ++i) {
                            // bf16(w) * bf16(x) is exact in float32; the
                            // counts take w unrounded.
                            v[i] = wv[i];
                            if (col < d && wv[i] != 0.f) {   // a row < n
                                const int r = r0 + i;
                                const float xb = RESIDENT
                                    ? __bfloat162float(*reinterpret_cast<
                                          const __nv_bfloat16*>(
                                          xt + unit_offset(col >> 6, r,
                                                           (col & 63) >> 3, BM)
                                          + (col & 7) * 2))
                                    : round_bf16(rows[(size_t)r * d + col]);
                                v[i] = round_bf16(wv[i]) * xb;
                            }
                        }
#pragma unroll
                        for (int i = 0; i < 4; ++i)
                            // One thread owns this entry, so the additions
                            // arrive in program order.
                            if (wv[i] != 0.f
                                && (groups == 1 || lv[i] % groups == group))
                                atomicAdd(table + (size_t)lv[i] * dq + col,
                                          v[i]);
                    }
                }
            }
            consumer_sync();   // x tile, x2s, ws and lab_s are free again
        }
    }
}

template <bool VEC4, bool RESIDENT>
__global__ void __launch_bounds__(THREADS, 1)
assign_bf16_kernel(const Args a) {
    kmeans_bf16_body<false, VEC4, RESIDENT>(a);
}

template <bool VEC4, bool RESIDENT>
__global__ void __launch_bounds__(THREADS, 1)
fused_assign_reduce_bf16_kernel(const Args a) {
    kmeans_bf16_body<true, VEC4, RESIDENT>(a);
}

// h_k = 0.5 * ||c_k||^2 from the unrounded row, and bf16(c) as tile images:
// centroid row `row` of tile j = row / BN at position r = row % BN, 16-byte
// unit u of chunk q at  j * BN * nch * 128 + q * BN * 128 + r * 128 +
// (u ^ (r % 8)) * 16, zero past k and d.  One warp for each row of the
// padded tiles.
__global__ void prep_centroids_kernel(const float* __restrict__ c,
                                      float* __restrict__ h,
                                      unsigned char* __restrict__ img,
                                      int d, int nch, int k, int rows) {
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (row >= rows) return;
    const int r = row % BN;
    unsigned char* tile = img + (size_t)(row / BN) * BN * nch * ROW_BYTES;
    const float* src = c + (size_t)row * (size_t)d;
    float s = 0.f;
    for (int u = lane; u < nch * 8; u += 32) {
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            const int col = u * 8 + e;
            v[e] = (row < k && col < d) ? src[col] : 0.f;
            s = fmaf(v[e], v[e], s);
        }
        *reinterpret_cast<uint4*>(tile + unit_offset(u >> 3, r, u & 7, BN)) =
            make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                       pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
    }
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0 && row < k) h[row] = 0.5f * s;
}

size_t h_bytes(int k) { return ((size_t)k * 4 + 15) / 16 * 16; }

int padded_rows(int k) { return (k + BN - 1) / BN * BN; }

// h and the tile images in the scratch; returns the first error.
int prep_centroids(const float* c, void* scratch, int d, int k,
                   cudaStream_t stream) {
    float* h = static_cast<float*>(scratch);
    unsigned char* img = static_cast<unsigned char*>(scratch) + h_bytes(k);
    const int warps = 8;
    const int rows = padded_rows(k);
    prep_centroids_kernel<<<(rows + warps - 1) / warps, warps * 32, 0,
                            stream>>>(c, h, img, d, (d + 63) / 64, k, rows);
    return (int)cudaGetLastError();
}

Args make_args(const float* x, const float* w, const void* scratch,
               int* labels, float* mind2, float* partial, long long n,
               int d, int k) {
    Args a{};
    a.x = x;
    a.w = w;
    a.h = static_cast<const float*>(scratch);
    a.img = static_cast<const unsigned char*>(scratch) + h_bytes(k);
    a.labels = labels;
    a.mind2 = mind2;
    a.partial = partial;
    a.n = n;
    a.d = d;
    a.k = k;
    a.p = make_plan(d);
    return a;
}

template <typename Kernel>
int launch(Kernel kernel, const Args& a, int blocks, cudaStream_t st) {
    const int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)a.p.smem_bytes);
    if (err != 0) return err;
    kernel<<<blocks, THREADS, a.p.smem_bytes, st>>>(a);
    return (int)cudaGetLastError();
}

// The instance for the call's width and alignment.
template <bool FUSED>
int launch_for(const Args& a, int blocks, cudaStream_t st) {
    const bool vec4 = a.d % 4 == 0 && aligned16(a.x);
    const bool resident = a.p.nsl == 1;
    if (FUSED) {
        if (vec4) return resident
            ? launch(fused_assign_reduce_bf16_kernel<true, true>, a, blocks, st)
            : launch(fused_assign_reduce_bf16_kernel<true, false>, a, blocks, st);
        return resident
            ? launch(fused_assign_reduce_bf16_kernel<false, true>, a, blocks, st)
            : launch(fused_assign_reduce_bf16_kernel<false, false>, a, blocks, st);
    }
    if (vec4) return resident
        ? launch(assign_bf16_kernel<true, true>, a, blocks, st)
        : launch(assign_bf16_kernel<true, false>, a, blocks, st);
    return resident ? launch(assign_bf16_kernel<false, true>, a, blocks, st)
                    : launch(assign_bf16_kernel<false, false>, a, blocks, st);
}

template <typename Kernel>
int occupancy(Kernel kernel, unsigned smem) {
    int blocks = 0;
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem) != cudaSuccess
        || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &blocks, kernel, THREADS, smem) != cudaSuccess)
        return 0;
    return blocks;
}

}  // namespace

// Rows of a block's tile; the wrapper sizes its grid by it.
extern "C" int kmeans_tile_rows(void) { return BM; }

// Centroids of a tile image (KM_TILE_K).
extern "C" int kmeans_tile_centroids(void) { return BN; }

// Blocks of either kernel that one SM holds at width d (0 if none fits):
// the wrapper's grid is this times the SMs, at most one block per row tile.
extern "C" int kmeans_blocks_per_sm(int d) {
    const Plan p = make_plan(d);
    int a, b;
    if (p.nsl == 1) {
        a = occupancy(assign_bf16_kernel<false, true>, p.smem_bytes);
        b = occupancy(fused_assign_reduce_bf16_kernel<false, true>,
                      p.smem_bytes);
    } else {
        a = occupancy(assign_bf16_kernel<false, false>, p.smem_bytes);
        b = occupancy(fused_assign_reduce_bf16_kernel<false, false>,
                      p.smem_bytes);
    }
    return a < b ? a : b;
}

// Bytes of the launchers' scratch: h (k floats, padded to 16 bytes), then
// the tile images of bf16(c) (ceil(k / KM_TILE_K) tiles of KM_TILE_K rows
// of ceil(D / 64) chunks of 128 bytes).
extern "C" long long kmeans_scratch_bytes(int d, int k) {
    return (long long)(h_bytes(k)
                       + (size_t)padded_rows(k) * ((d + 63) / 64) * ROW_BYTES);
}

// Only the first step of both launchers: h and the tile images into
// `scratch` (to check the layout against its mirror in Python).
extern "C" int kmeans_prep_centroids_bf16(const float* c, void* scratch,
                                          int d, int k, void* stream) {
    return prep_centroids(c, scratch, d, k, static_cast<cudaStream_t>(stream));
}

// Both launchers enqueue on `stream`, do not synchronise, and return the
// first cudaError_t that a launch reported, 0 if none did.  `scratch` holds
// kmeans_scratch_bytes(d, k) bytes, 16-byte aligned.  `mind2` may be null:
// then no minimum distance is written.  `blocks` is the number of
// persistent blocks, at least 1 and at most one for each row tile.

extern "C" int kmeans_assign_bf16_launch(const float* x, const float* c,
                                         void* scratch, int* labels,
                                         float* mind2, long long n, int d,
                                         int k, int blocks, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int err = prep_centroids(c, scratch, d, k, st);
    if (err != 0) return err;
    return launch_for<false>(
        make_args(x, nullptr, scratch, labels, mind2, nullptr, n, d, k),
        blocks, st);
}

// `partial` is scratch of blocks * k * (d + 1) floats and must be zero.
extern "C" int kmeans_fused_assign_reduce_bf16_launch(
        const float* x, const float* w, const float* c, void* scratch,
        int* labels, float* mind2, float* partial, float* sums,
        float* counts, long long n, int d, int k, int blocks, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    int err = prep_centroids(c, scratch, d, k, st);
    if (err != 0) return err;
    err = launch_for<true>(
        make_args(x, w, scratch, labels, mind2, partial, n, d, k), blocks, st);
    if (err != 0) return err;
    return launch_reduce_partials(partial, sums, counts, blocks, d, k, st);
}
