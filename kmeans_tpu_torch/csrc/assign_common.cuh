// Pieces shared by the float32 (assign_kernels.cu) and bf16 (assign_bf16.cu)
// K-Means assignment kernels: masked row loads, the (value, index) minimum,
// the epilogue of a centroid tile in m16n8 tensor-core accumulators (each
// row's minimum over the tile), the rows' squared norms and the second pass
// that adds the fused kernels' per-block tables in block order.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int NO_INDEX = 0x7fffffff;

// Four consecutive features of one row, zero beyond the row or feature count.
template <bool VEC4>
__device__ __forceinline__ float4 load4(const float* __restrict__ base,
                                        long long row, long long rows,
                                        int col, int d) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row >= rows) return v;
    const float* p = base + row * (long long)d + col;
    if (VEC4) {
        if (col < d) v = *reinterpret_cast<const float4*>(p);
    } else {
        if (col + 0 < d) v.x = p[0];
        if (col + 1 < d) v.y = p[1];
        if (col + 2 < d) v.z = p[2];
        if (col + 3 < d) v.w = p[3];
    }
    return v;
}

// (v, i) <- the smaller of (v, i) and (ov, oi); equal values keep the lower
// index.  A NaN never wins.
__device__ __forceinline__ void take_min(float& v, int& i, float ov, int oi) {
    if (ov < v || (ov == v && oi < i)) { v = ov; i = oi; }
}

// The epilogue of one centroid tile, for a warp that holds 16 rows against
// the NT * 8 centroids c0 .. c0 + NT*8 - 1 in m16n8 accumulators: lane
// (g = lane / 4, t = lane % 4) holds, of each m16n8 tile j, rows g and g + 8
// at columns j*8 + 2t and j*8 + 2t + 1 (acc[j][0], [1] and [2], [3]).
// score = h - acc, subtracted here in float32; padded centroids (col >= k)
// are masked by index (an infinite h would make Inf * 0 = NaN).  A lane
// scans its columns in rising order with a strict "<" in two interleaved
// chains (even and odd j, so that the compares do not wait on each other),
// merges them and then the quad with take_min (lower index on a tie), and
// ORs the NaN flags into bit r of `bad`; the running pair best_v/best_i[r]
// (row g + 8 r) moves only on a strict "<", so an earlier tile keeps a tie.
template <int NT>
__device__ __forceinline__ void tile_min(const float (&acc)[NT][4], int c0,
                                         int k, const float* __restrict__ h,
                                         float best_v[2], int best_i[2],
                                         unsigned& bad) {
    const int t = threadIdx.x & 3;
    const bool full = c0 + NT * 8 <= k;
    float hv[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int col = c0 + j * 8 + 2 * t + e;
            hv[j][e] = (full || col < k) ? __ldg(h + col) : 0.f;
        }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        float v[2] = {CUDART_INF_F, CUDART_INF_F};
        int idx[2] = {NO_INDEX, NO_INDEX};
        bool nan = false;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int col = c0 + j * 8 + 2 * t + e;
                const float sc = hv[j][e] - acc[j][2 * r + e];
                if (full || col < k) {
                    nan |= (sc != sc);
                    if (sc < v[j & 1]) { v[j & 1] = sc; idx[j & 1] = col; }
                }
            }
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

// ||x_r||^2 of the ROWS rows of a tile into x2s, one warp for each row in
// turn, from the unrounded float32 row; with `shift`, ||x_r - shift||^2.
template <int ROWS, int THREADS>
__device__ __forceinline__ void row_sqnorms(const float* __restrict__ x,
                                            long long row0, long long n,
                                            int d, float* x2s,
                                            const float* __restrict__ shift =
                                                nullptr) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    for (int r = warp; r < ROWS; r += THREADS / 32) {
        const long long row = row0 + r;
        float s = 0.f;
        if (row < n) {
            const float* p = x + row * (long long)d;
            for (int col = lane; col < d; col += 32) {
                const float v = shift ? p[col] - shift[col] : p[col];
                s = fmaf(v, v, s);
            }
        }
#pragma unroll
        for (int off = 16; off >= 1; off >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) x2s[r] = s;
    }
}

// sums (k, D) and counts (k,) from the blocks' tables, added in block order.
__global__ void reduce_partials_kernel(const float* __restrict__ partial,
                                       float* __restrict__ sums,
                                       float* __restrict__ counts,
                                       int blocks, int d, int k) {
    const int dp = d + 1;
    const size_t total = (size_t)k * (size_t)dp;
    const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= total) return;
    float s = 0.f;
    for (int b = 0; b < blocks; ++b) s += partial[(size_t)b * total + e];
    const size_t row = e / dp;
    const int col = (int)(e % dp);
    if (col < d) sums[row * (size_t)d + col] = s;
    else counts[row] = s;
}

int launch_reduce_partials(const float* partial, float* sums, float* counts,
                           int blocks, int d, int k, cudaStream_t stream) {
    const size_t total = (size_t)k * (size_t)(d + 1);
    const int rt = 256;
    reduce_partials_kernel<<<(unsigned)((total + rt - 1) / rt), rt, 0,
                             stream>>>(partial, sums, counts, blocks, d, k);
    return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
    return (reinterpret_cast<size_t>(p) & 15u) == 0;
}

}  // namespace
