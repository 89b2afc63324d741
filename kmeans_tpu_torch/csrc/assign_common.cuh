// Pieces shared by the float32 (assign_kernels.cu) and bf16 (assign_bf16.cu)
// K-Means assignment kernels: masked row loads, the (value, index) minimum,
// the rows' squared norms and the second pass that adds the fused kernels'
// per-block tables in block order.

#pragma once

#include <cuda_runtime.h>

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

// ||x_r||^2 of the ROWS rows of a tile into x2s, one warp for each row in
// turn, from the unrounded float32 row.
template <int ROWS, int THREADS>
__device__ __forceinline__ void row_sqnorms(const float* __restrict__ x,
                                            long long row0, long long n,
                                            int d, float* x2s) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    for (int r = warp; r < ROWS; r += THREADS / 32) {
        const long long row = row0 + r;
        float s = 0.f;
        if (row < n) {
            const float* p = x + row * (long long)d;
            for (int col = lane; col < d; col += 32) s = fmaf(p[col], p[col], s);
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
