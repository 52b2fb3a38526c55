// What K1's forward (angular.cu) and backward (angular_bwd.cu) share: the
// tile shape, the cosine's constants, the shared-memory row layout and the
// float4 tile load and dot product.  Included by both sources, so
// mmtpu_torch/kernels/build.py hashes it with them.
//
// Layout: a block holds BM latent rows and one BV-row vocabulary sub-tile at
// full depth in shared memory, as float4 rows with an odd float4 stride
// (stride4), so 16-byte loads of rows 4 apart fall in distinct banks; the
// depth is zero-padded up to the float4 boundary.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;        // latent rows per block
constexpr int BV = 32;        // vocabulary rows per sub-tile
constexpr int THREADS = 256;  // 8 warps
constexpr int MAX_D = 512;    // depth bound of the shared-memory tiles
constexpr unsigned FULL = 0xffffffffu;

constexpr float COS_EPS = 1e-8f;
constexpr float ACOS_HI = (float)(1.0 - 1e-7);
constexpr float ACOS_LO = (float)(-1.0 + 1e-7);
constexpr float PI_F = 3.14159265358979323846f;

// float4 groups of a row, and the shared row stride in float4s (odd)
__host__ __device__ inline int depth4(int d) { return (d + 3) >> 2; }
__host__ __device__ inline int stride4(int d) { return depth4(d) | 1; }

// Rows [row0, row0 + ROWS) of a (total, d) row-major matrix into shared memory
// with float4 row stride dp4; rows past `total` and columns past d (up to the
// float4 boundary) become zeros.  Four 16-byte loads in flight per thread.
template <int ROWS>
__device__ inline void load_tile(float4* dst, const float* __restrict__ src, int row0,
                                 int total, int d, int d4, int dp4) {
    if ((d & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        const float4* __restrict__ src4 = reinterpret_cast<const float4*>(src);
        const int n = ROWS * d4;
        for (int base = threadIdx.x; base < n; base += 4 * THREADS) {
            float4 v[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                int idx = base + u * THREADS;
                int r = idx / d4;
                v[u] = (idx < n && row0 + r < total)
                           ? src4[(size_t)(row0 + r) * d4 + (idx - r * d4)]
                           : make_float4(0.f, 0.f, 0.f, 0.f);
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                int idx = base + u * THREADS;
                int r = idx / d4;
                if (idx < n) dst[r * dp4 + (idx - r * d4)] = v[u];
            }
        }
        return;
    }
    float* dsts = reinterpret_cast<float*>(dst);
    const int dw = 4 * d4;
#pragma unroll 4
    for (int idx = threadIdx.x; idx < ROWS * dw; idx += THREADS) {
        int r = idx / dw;
        int k = idx - r * dw;
        int row = row0 + r;
        dsts[r * 4 * dp4 + k] = (row < total && k < d) ? src[(size_t)row * d + k] : 0.f;
    }
}

__device__ inline float dot4(float4 a, float4 b, float acc) {
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    return fmaf(a.w, b.w, acc);
}

}  // namespace
