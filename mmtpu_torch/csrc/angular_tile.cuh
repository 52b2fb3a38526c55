// What K1's forward (angular.cu) and backward (angular_bwd.cu) share: the
// tile shape, the cosine's constants, the depth chunks, the shared-memory row
// layout and the float4 tile load and dot product.  Included by both sources,
// so mmtpu_torch/kernels/build.py hashes it with them.
//
// Layout: a block holds BM latent rows and one BV-row vocabulary sub-tile in
// shared memory, one depth chunk at a time: the depth's float4 groups are cut
// into chunks of at most DC float4s each (balanced, so no chunk is much
// narrower than the others).  Rows are float4 rows with an odd
// float4 stride (stride4, the chunk width rounded up to odd), so 16-byte loads
// of rows 4 apart fall in distinct banks; the depth is zero-padded up to the
// float4 boundary.  Where the whole depth is one chunk (D <= 4 DC, the main
// path's D = 300 among them), the kernels keep the latent tile resident for
// the whole vocabulary loop; else each vocabulary sub-tile streams both
// operands chunk by chunk.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;        // latent rows per block
constexpr int BV = 32;        // vocabulary rows per sub-tile
constexpr int THREADS = 256;  // 8 warps
// float4s per depth chunk: two chunks of BM + BV rows (about 100 KB with the
// backward's coefficients) leave room for two blocks per SM at any depth
constexpr int DC = 96;
constexpr unsigned FULL = 0xffffffffu;

constexpr float COS_EPS = 1e-8f;
constexpr float ACOS_HI = (float)(1.0 - 1e-7);
constexpr float ACOS_LO = (float)(-1.0 + 1e-7);
constexpr float PI_F = 3.14159265358979323846f;

// float4 groups of a row
__host__ __device__ inline int depth4(int d) { return (d + 3) >> 2; }
// float4s per depth chunk: depth4(d) cut into ceil(depth4(d) / DC)
// near-equal chunks
__host__ __device__ inline int chunk4(int d) {
    const int n = (depth4(d) + DC - 1) / DC;
    return (depth4(d) + n - 1) / n;
}
// the shared row stride in float4s (odd)
__host__ __device__ inline int stride4(int d) { return chunk4(d) | 1; }

// Rows [row0, row0 + ROWS) and float4 columns [c0, c0 + w) of a (total, d)
// row-major matrix into shared memory with float4 row stride dp4; rows past
// `total` and columns past d (up to the float4 boundary) become zeros.  Four
// 16-byte loads in flight per thread.
template <int ROWS>
__device__ inline void load_tile(float4* dst, const float* __restrict__ src, int row0,
                                 int total, int d, int c0, int w, int dp4) {
    if ((d & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        const float4* __restrict__ src4 = reinterpret_cast<const float4*>(src) + c0;
        const int d4 = d >> 2, n = ROWS * w;
        for (int base = threadIdx.x; base < n; base += 4 * THREADS) {
            float4 v[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                int idx = base + u * THREADS;
                int r = idx / w;
                v[u] = (idx < n && row0 + r < total)
                           ? src4[(size_t)(row0 + r) * d4 + (idx - r * w)]
                           : make_float4(0.f, 0.f, 0.f, 0.f);
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                int idx = base + u * THREADS;
                int r = idx / w;
                if (idx < n) dst[r * dp4 + (idx - r * w)] = v[u];
            }
        }
        return;
    }
    float* dsts = reinterpret_cast<float*>(dst);
    const int dw = 4 * w, k0 = 4 * c0;
#pragma unroll 4
    for (int idx = threadIdx.x; idx < ROWS * dw; idx += THREADS) {
        int r = idx / dw;
        int k = idx - r * dw;
        int row = row0 + r;
        dsts[r * 4 * dp4 + k] =
            (row < total && k0 + k < d) ? src[(size_t)row * d + k0 + k] : 0.f;
    }
}

__device__ inline float dot4(float4 a, float4 b, float acc) {
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    return fmaf(a.w, b.w, acc);
}

// Each row's |l|^2 of the block's BM latent rows into lnsq_s, 8 lanes per
// row, over the depth chunks in order.  Leaves the last chunk of the latent
// tile in lat_s (the whole tile where the depth is one chunk).
__device__ inline void latent_norms(float4* lat_s, float* lnsq_s, const float* __restrict__ lat,
                                    int b0, int B, int D) {
    const int d4 = depth4(D), cw = chunk4(D), dp4 = stride4(D);
    const int row = threadIdx.x >> 3, p = threadIdx.x & 7;
    float s = 0.f;
    for (int k0 = 0; k0 < d4; k0 += cw) {
        const int w = min(cw, d4 - k0);
        if (k0 > 0) __syncthreads();  // the previous chunk consumed
        load_tile<BM>(lat_s, lat, b0, B, D, k0, w, dp4);
        __syncthreads();
        for (int k = p; k < w; k += 8) {
            float4 x = lat_s[row * dp4 + k];
            s = dot4(x, x, s);
        }
    }
    s += __shfl_xor_sync(FULL, s, 1);
    s += __shfl_xor_sync(FULL, s, 2);
    s += __shfl_xor_sync(FULL, s, 4);
    if (p == 0) lnsq_s[row] = s;
}

// The lane's 4 x 4 tile of dot products, latent rows 4 rg + i against
// vocabulary rows 4 cg + j of sub-tile v0, at full depth: the four lanes
// ks = 0..3 of a tile take every fourth float4 of each chunk.  Where the
// depth is one chunk the latent tile is already resident; else both operands
// are loaded chunk by chunk.  vn_s gets the sub-tile's vocabulary norms.
// Starts with a __syncthreads (the previous sub-tile consumed); the caller
// synchronises before it next writes lat_s or voc_s.
__device__ inline void tile_dots(float (&acc)[4][4], float4* lat_s, float4* voc_s, float* vn_s,
                                 const float* __restrict__ lat,
                                 const float* __restrict__ vocab,
                                 const float* __restrict__ vnorm, int b0, int B, int v0, int V,
                                 int D, int rg, int cg, int ks) {
    const int d4 = depth4(D), cw = chunk4(D), dp4 = stride4(D);
    const bool one_chunk = cw == d4;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < d4; k0 += cw) {
        const int w = min(cw, d4 - k0);
        __syncthreads();  // the previous chunk or sub-tile consumed
        if (!one_chunk) load_tile<BM>(lat_s, lat, b0, B, D, k0, w, dp4);
        load_tile<BV>(voc_s, vocab, v0, V, D, k0, w, dp4);
        if (k0 == 0 && threadIdx.x < BV)
            vn_s[threadIdx.x] = v0 + threadIdx.x < V ? vnorm[v0 + threadIdx.x] : 0.f;
        __syncthreads();
        for (int k = ks; k < w; k += 4) {
            float4 a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = lat_s[(4 * rg + i) * dp4 + k];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = voc_s[(4 * cg + j) * dp4 + k];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = dot4(a[i], b[j], acc[i][j]);
        }
    }
}

// The four lanes ks = 0..3 of a tile each hold sums over their quarter of D
// for 4 rows x 4 columns; add them so that lane ks ends with row ks's four
// sums.  Each step keeps half the rows, so no array is indexed at run time.
__device__ inline void reduce_scatter(const float (&acc)[4][4], int ks, float (&dots)[4]) {
    const bool hi1 = ks & 2, hi0 = ks & 1;
    float h[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            float send = hi1 ? acc[i][j] : acc[i + 2][j];
            float keep = hi1 ? acc[i + 2][j] : acc[i][j];
            h[i][j] = keep + __shfl_xor_sync(FULL, send, 2);
        }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        float send = hi0 ? h[0][j] : h[1][j];
        float keep = hi0 ? h[1][j] : h[0][j];
        dots[j] = keep + __shfl_xor_sync(FULL, send, 1);
    }
}

}  // namespace
