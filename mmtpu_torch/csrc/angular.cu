// Angular word-likelihood partition (forward) for Hopper, sm_90a.  Its
// latent gradient is mmtpu_torch/csrc/angular_bwd.cu.
//
// Replaces the Pallas TPU kernel _fwd_kernel of mmtpu/kernels/angular.py
// (pallas_call in _call_fwd):
//
//   Z[b]  = sum_v (1 - acos(clip(cos(l_b, v), +-(1 - 1e-7))) / pi)
//   cos   = l_b . v / max(|l_b| |v|, 1e-8)
//
// What bounds it on an H100: at the training batch (B=64, V=3016, D=300) one
// call is 64*3016*300*2 ~ 116 MFLOP against a 3.6 MB vocabulary read, so it is
// bound by launch latency and by streaming the vocabulary, not by compute.
// The TPU kernel carried each row's sum across *sequential* vocab grid steps;
// here blocks run in parallel and in no order, so the vocabulary is split
// across blocks as well as the rows (enough blocks for 132 SMs even at 64
// rows), each block writes a partial per (vocab chunk, row), and a second
// small pass adds the partials in a fixed order.  No float atomics, so runs
// reproduce bit for bit.
//
// Design (simple first; wgmma/TMA come later): a block holds its BM latent
// rows and one BV-row vocabulary sub-tile at full depth D in shared memory and
// forms the BM x BV dot tile with f32 FMAs.  Rows past B and vocabulary rows
// past V load as zeros and are masked out of every sum.
//
// C interface, loaded with ctypes: every entry point takes device pointers
// and the CUDA stream, launches asynchronously and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;          // latent rows per block
constexpr int BV = 64;          // vocabulary rows per sub-tile
constexpr int THREADS = 256;    // 16 x 16 threads; each owns 2 rows x 4 columns
constexpr int MAX_D = 512;      // depth bound of the shared-memory tiles

constexpr float COS_EPS = 1e-8f;
constexpr float ACOS_HI = (float)(1.0 - 1e-7);
constexpr float ACOS_LO = (float)(-1.0 + 1e-7);
constexpr float PI_F = 3.14159265358979323846f;

__host__ __device__ inline int padded_depth(int d) { return d | 1; }  // odd stride: no bank conflicts

// Load rows [row0, row0 + nrows) of a (total, D) row-major matrix into shared
// memory with row stride dp; rows past `total` become zeros.  With one block
// per SM few warps hide memory latency, so each thread keeps several 16-byte
// loads in flight; rows that are not 16-byte aligned take the scalar path.
__device__ inline void load_rows(float* dst, const float* __restrict__ src,
                                 int row0, int nrows, int total, int d, int dp) {
    if ((d & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        const int d4 = d >> 2;
        const float4* __restrict__ src4 = reinterpret_cast<const float4*>(src);
#pragma unroll 4
        for (int idx = threadIdx.x; idx < nrows * d4; idx += THREADS) {
            int r = idx / d4;
            int k = idx - r * d4;
            int row = row0 + r;
            float4 v = row < total ? src4[(size_t)row * d4 + k]
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
            float* o = dst + r * dp + 4 * k;
            o[0] = v.x;
            o[1] = v.y;
            o[2] = v.z;
            o[3] = v.w;
        }
        return;
    }
#pragma unroll 4
    for (int idx = threadIdx.x; idx < nrows * d; idx += THREADS) {
        int r = idx / d;
        int k = idx - r * d;
        int row = row0 + r;
        dst[r * dp + k] = row < total ? src[(size_t)row * d + k] : 0.f;
    }
}

// acc[i][j] = lat_s[ty + 16 i] . voc_s[tx + 16 j]
__device__ inline void dot_tile(const float* lat_s, const float* voc_s, int d, int dp,
                                int ty, int tx, float acc[2][4]) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    const float* a0 = lat_s + ty * dp;
    const float* a1 = lat_s + (ty + 16) * dp;
    const float* b0 = voc_s + tx * dp;
    for (int k = 0; k < d; ++k) {
        float x0 = a0[k], x1 = a1[k];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            float y = b0[16 * j * dp + k];
            acc[0][j] = fmaf(x0, y, acc[0][j]);
            acc[1][j] = fmaf(x1, y, acc[1][j]);
        }
    }
}

// Sum over the 16 tx lanes that share a row (lanes of one half-warp).
__device__ inline float half_warp_sum(float x) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
}

__device__ inline void row_norms(const float* lat_s, int d, int dp, float* lnorm_sq_s) {
    int r = threadIdx.x;
    if (r < BM) {
        float s = 0.f;
        for (int k = 0; k < d; ++k) s = fmaf(lat_s[r * dp + k], lat_s[r * dp + k], s);
        lnorm_sq_s[r] = s;
    }
}

__device__ inline float clip_cos(float c) { return fminf(fmaxf(c, ACOS_LO), ACOS_HI); }

// grid (ceil(B/BM), n_chunks); chunk c covers vocab sub-tiles
// [c * tiles_per_chunk, (c + 1) * tiles_per_chunk).  partial: (n_chunks, B).
__global__ void __launch_bounds__(THREADS)
angular_fwd_kernel(const float* __restrict__ lat, const float* __restrict__ vocab,
                   const float* __restrict__ vnorm, float* __restrict__ partial,
                   int B, int V, int D, int tiles_per_chunk) {
    extern __shared__ float smem[];
    const int dp = padded_depth(D);
    float* lat_s = smem;                 // BM x dp
    float* voc_s = lat_s + BM * dp;      // BV x dp
    float* lnsq_s = voc_s + BV * dp;     // BM
    float* vn_s = lnsq_s + BM;           // BV

    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    const int b0 = blockIdx.x * BM;
    const int n_sub = (V + BV - 1) / BV;
    const int st0 = blockIdx.y * tiles_per_chunk;
    const int st1 = min(st0 + tiles_per_chunk, n_sub);

    load_rows(lat_s, lat, b0, BM, B, D, dp);
    __syncthreads();
    row_norms(lat_s, D, dp, lnsq_s);

    float rs[2] = {0.f, 0.f};
    for (int st = st0; st < st1; ++st) {
        const int v0 = st * BV;
        __syncthreads();  // previous sub-tile fully consumed
        load_rows(voc_s, vocab, v0, BV, V, D, dp);
        if (threadIdx.x < BV) {
            int v = v0 + threadIdx.x;
            vn_s[threadIdx.x] = v < V ? vnorm[v] : 0.f;
        }
        __syncthreads();
        float acc[2][4];
        dot_tile(lat_s, voc_s, D, dp, ty, tx, acc);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            float ln = sqrtf(lnsq_s[ty + 16 * i]);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                int c = tx + 16 * j;
                if (v0 + c < V) {
                    float cs = clip_cos(acc[i][j] / fmaxf(ln * vn_s[c], COS_EPS));
                    rs[i] += 1.f - acosf(cs) / PI_F;
                }
            }
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        float s = half_warp_sum(rs[i]);
        int b = b0 + ty + 16 * i;
        if (tx == 0 && b < B) partial[(size_t)blockIdx.y * B + b] = s;
    }
}

// out[b] = sum_c partial[c, b], in chunk order.
__global__ void angular_fwd_reduce(const float* __restrict__ partial, float* __restrict__ out,
                                   int B, int n_chunks) {
    int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    float s = 0.f;
    for (int c = 0; c < n_chunks; ++c) s += partial[(size_t)c * B + b];
    out[b] = s;
}

size_t fwd_smem_bytes(int d) {
    return sizeof(float) * ((size_t)(BM + BV) * padded_depth(d) + BM + BV);
}

}  // namespace

extern "C" {

int angular_max_depth() { return MAX_D; }
int angular_row_tile() { return BM; }
int angular_vocab_tile() { return BV; }

// partial: (n_chunks, B) scratch; out: (B,)
int angular_fwd(const void* lat, const void* vocab, const void* vnorm, void* partial,
                void* out, int B, int V, int D, int n_chunks, int tiles_per_chunk,
                void* stream) {
    if (D < 1 || D > MAX_D) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    size_t smem = fwd_smem_bytes(D);
    cudaError_t err = cudaFuncSetAttribute(angular_fwd_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((B + BM - 1) / BM, n_chunks);
    angular_fwd_kernel<<<grid, THREADS, smem, s>>>(
        (const float*)lat, (const float*)vocab, (const float*)vnorm, (float*)partial,
        B, V, D, tiles_per_chunk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    angular_fwd_reduce<<<(B + 255) / 256, 256, 0, s>>>((const float*)partial, (float*)out,
                                                       B, n_chunks);
    return (int)cudaGetLastError();
}

}  // extern "C"
