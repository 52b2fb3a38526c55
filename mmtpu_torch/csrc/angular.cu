// Angular word-likelihood partition (forward) and its latent gradient
// (backward) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernels of mmtpu/kernels/angular.py:
//   forward  _fwd_kernel (pallas_call in _call_fwd)
//   backward _bwd_kernel (pallas_call in _call_bwd)
//
//   Z[b]  = sum_v (1 - acos(clip(cos(l_b, v), +-(1 - 1e-7))) / pi)
//   cos   = l_b . v / max(|l_b| |v|, 1e-8)
//   dl[b] = sum_v g w v / max(|l||v|, 1e-8) - (sum_v g w cos) l / max(|l|^2, 1e-8)
//   w     = (1/pi) / sqrt(max(1 - cos^2, 1e-12))
//
// The vocabulary is a constant here: no vocab gradient.  The backward
// recomputes the cosines tile by tile, so nothing of size (B, V) is ever
// written to device memory.
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
constexpr int T1_PER_THREAD = MAX_D / 8;  // backward: 8 threads per row span D
constexpr int REDUCE_THREADS = 128;

constexpr float COS_EPS = 1e-8f;
constexpr float ACOS_HI = (float)(1.0 - 1e-7);
constexpr float ACOS_LO = (float)(-1.0 + 1e-7);
constexpr float PI_F = 3.14159265358979323846f;
constexpr float W_EPS = 1e-12f;

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

// grid (ceil(B/BM), n_chunks).  partial_dl: (n_chunks, B, D) holds
// sum_v g w v / denom over the chunk; partial_s: (n_chunks, B) holds
// sum_v g w cos.
__global__ void __launch_bounds__(THREADS)
angular_bwd_kernel(const float* __restrict__ lat, const float* __restrict__ vocab,
                   const float* __restrict__ vnorm, const float* __restrict__ g,
                   float* __restrict__ partial_dl, float* __restrict__ partial_s,
                   int B, int V, int D, int tiles_per_chunk) {
    extern __shared__ float smem[];
    const int dp = padded_depth(D);
    float* lat_s = smem;                 // BM x dp
    float* voc_s = lat_s + BM * dp;      // BV x dp
    float* coef_s = voc_s + BV * dp;     // BM x (BV + 1)
    float* lnsq_s = coef_s + BM * (BV + 1);  // BM
    float* vn_s = lnsq_s + BM;           // BV
    float* g_s = vn_s + BV;              // BM

    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    const int rr = threadIdx.x / 8, dd = threadIdx.x % 8;  // term-1 ownership
    const int b0 = blockIdx.x * BM;
    const int n_sub = (V + BV - 1) / BV;
    const int st0 = blockIdx.y * tiles_per_chunk;
    const int st1 = min(st0 + tiles_per_chunk, n_sub);

    load_rows(lat_s, lat, b0, BM, B, D, dp);
    if (threadIdx.x < BM) {
        int b = b0 + threadIdx.x;
        g_s[threadIdx.x] = b < B ? g[b] : 0.f;
    }
    __syncthreads();
    row_norms(lat_s, D, dp, lnsq_s);

    float t1[T1_PER_THREAD];
#pragma unroll
    for (int m = 0; m < T1_PER_THREAD; ++m) t1[m] = 0.f;
    float ss[2] = {0.f, 0.f};

    for (int st = st0; st < st1; ++st) {
        const int v0 = st * BV;
        __syncthreads();
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
            int r = ty + 16 * i;
            float ln = sqrtf(lnsq_s[r]);
            float gr = g_s[r];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                int c = tx + 16 * j;
                float coef = 0.f;
                if (v0 + c < V) {
                    float denom = fmaxf(ln * vn_s[c], COS_EPS);
                    float cs = clip_cos(acc[i][j] / denom);
                    float w = (1.f / PI_F) / sqrtf(fmaxf(1.f - cs * cs, W_EPS));
                    float wg = w * gr;
                    coef = wg / denom;
                    ss[i] += wg * cs;
                }
                coef_s[r * (BV + 1) + c] = coef;
            }
        }
        __syncthreads();
        // term 1: t1[rr, :] += coef[rr, :] @ voc_s
        const float* crow = coef_s + rr * (BV + 1);
        for (int j = 0; j < BV; ++j) {
            float cj = crow[j];
            const float* vrow = voc_s + j * dp + dd;
#pragma unroll
            for (int m = 0; m < T1_PER_THREAD; ++m)
                if (dd + 8 * m < D) t1[m] = fmaf(cj, vrow[8 * m], t1[m]);
        }
    }

    const int b = b0 + rr;
    if (b < B) {
        float* out = partial_dl + ((size_t)blockIdx.y * B + b) * D;
#pragma unroll
        for (int m = 0; m < T1_PER_THREAD; ++m)
            if (dd + 8 * m < D) out[dd + 8 * m] = t1[m];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        float s = half_warp_sum(ss[i]);
        int bi = b0 + ty + 16 * i;
        if (tx == 0 && bi < B) partial_s[(size_t)blockIdx.y * B + bi] = s;
    }
}

// One block per latent row: dl = sum_c partial_dl[c] - s * l / max(|l|^2, 1e-8).
__global__ void __launch_bounds__(REDUCE_THREADS)
angular_bwd_reduce(const float* __restrict__ lat, const float* __restrict__ partial_dl,
                   const float* __restrict__ partial_s, float* __restrict__ dlat,
                   int B, int D, int n_chunks) {
    __shared__ float red[REDUCE_THREADS];
    const int b = blockIdx.x;
    const float* l = lat + (size_t)b * D;
    float sq = 0.f;
    for (int d = threadIdx.x; d < D; d += REDUCE_THREADS) sq = fmaf(l[d], l[d], sq);
    red[threadIdx.x] = sq;
    __syncthreads();
    for (int off = REDUCE_THREADS / 2; off > 0; off >>= 1) {
        if (threadIdx.x < off) red[threadIdx.x] += red[threadIdx.x + off];
        __syncthreads();
    }
    const float lnorm_sq = red[0];
    float s = 0.f;
    for (int c = 0; c < n_chunks; ++c) s += partial_s[(size_t)c * B + b];
    const float denom = fmaxf(lnorm_sq, COS_EPS);
    for (int d = threadIdx.x; d < D; d += REDUCE_THREADS) {
        float acc = 0.f;
        for (int c = 0; c < n_chunks; ++c) acc += partial_dl[((size_t)c * B + b) * D + d];
        dlat[(size_t)b * D + d] = acc - s * l[d] / denom;
    }
}

size_t fwd_smem_bytes(int d) {
    return sizeof(float) * ((size_t)(BM + BV) * padded_depth(d) + BM + BV);
}

size_t bwd_smem_bytes(int d) {
    return sizeof(float) * ((size_t)(BM + BV) * padded_depth(d) + BM * (BV + 1) + 2 * BM + BV);
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

// partial_dl: (n_chunks, B, D) scratch; partial_s: (n_chunks, B) scratch;
// dlat: (B, D)
int angular_bwd(const void* lat, const void* vocab, const void* vnorm, const void* g,
                void* partial_dl, void* partial_s, void* dlat, int B, int V, int D,
                int n_chunks, int tiles_per_chunk, void* stream) {
    if (D < 1 || D > MAX_D) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    size_t smem = bwd_smem_bytes(D);
    cudaError_t err = cudaFuncSetAttribute(angular_bwd_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((B + BM - 1) / BM, n_chunks);
    angular_bwd_kernel<<<grid, THREADS, smem, s>>>(
        (const float*)lat, (const float*)vocab, (const float*)vnorm, (const float*)g,
        (float*)partial_dl, (float*)partial_s, B, V, D, tiles_per_chunk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    angular_bwd_reduce<<<B, REDUCE_THREADS, 0, s>>>((const float*)lat, (const float*)partial_dl,
                                                   (const float*)partial_s, (float*)dlat,
                                                   B, D, n_chunks);
    return (int)cudaGetLastError();
}

}  // extern "C"
