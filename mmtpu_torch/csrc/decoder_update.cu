// Fused decoder update (kernel K2) for Hopper, sm_90a: the weight-gradient
// product, the optimizer step and the latent cotangent of one stacked
// decoder weight leaf in one pass over the weight table.
//
// Replaces the Pallas TPU kernels of mmtpu/kernels/decoder_update.py:
//   Adam  fused_gemm_adam_update (pallas_call in it, body _adam_kernel)
//   SGD   fused_gemm_sgd_update  (pallas_call in it, body _sgd_kernel)
//
// For a weight leaf w (D, F) of the stacked decoder, the (normed) latent batch
// x (B, D) of the forward pass and the cotangent g_z (B, F) of the head
// pre-activations:
//   g_w  = x^T g_z                                         (D, F)
//   Adam m2 = b1 m + (1 - b1) g_w,  v2 = b2 v + (1 - b2) g_w^2,
//        w2 = w - lr (m2 / bc1) / (sqrt(v2 / bc2) + eps)   (torch Adam)
//   SGD  w2 = w - lr g_w
//   flag == 0: w2, m2, v2 = w, m, v bit for bit
//   g_x  = g_z w^T with the PRE-update w, whatever flag     (B, D)
// scalars = (lr, bc1, bc2, flag) is one (4,) float32 device tensor; bc1 and
// bc2 are the bias corrections at the post-increment step count.  Outputs are
// written out of place (w2, m2, v2 are new buffers), so the caller's w, m, v
// stay valid until it drops them.
//
// What bounds it on an H100: at the main path's shape (B, D, F) = (64, 300,
// 1400) the Adam call must move w, m, v in and out (6 x 1.68 MB) plus g_z,
// x and g_x, 10.6 MB in all, 3.2 us at 3.35 TB/s; its two products are
// 2 x 2 x 64 x 300 x 1400 = 108 MFLOP, 1.6 us at the 67 TFLOP/s float32 peak
// outside the tensor cores, so bytes bound it.  The SGD call moves 3.9 MB
// (1.2 us) for the same 108 MFLOP, so operations bound it.  At F = 1536 (the
// width the TPU code padded to) the figures are 11.6 MB / 3.5 us, 118 MFLOP
// / 1.8 us and 4.2 MB / 1.3 us.
//
// Design (simple first: float32 FMA on shared-memory tiles, no wgmma/TMA).
// The TPU kernel walked the F tiles in order and summed g_x across them in
// one resident buffer; GPU blocks run in parallel and in no order.  So the
// grid is 2-D, (D tiles of DT) x (F tiles of FT), about 110 blocks at the
// main path's shape.  Each block reads its w tile once into shared memory and
// uses it for both products before anything is written; it walks the batch
// in chunks of BB rows, accumulates its g_w tile in registers and writes, per
// chunk, a partial g_x (BB x DT) for its F tile.  After the batch it applies
// the Adam or SGD step to its tile.  A second pass adds the partials over the
// F tiles in a fixed order: no float atomics, so runs reproduce bit for bit.
// Every edge is masked: D, F and B need not be multiples of the tiles.
//
// C interface, loaded with ctypes: every entry point takes device pointers
// and the CUDA stream, launches asynchronously and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int DT = 32;       // weight rows (the latent depth D) per block
constexpr int FT = 128;      // weight columns (the stacked head width F) per block
constexpr int BB = 32;       // batch rows per chunk
constexpr int THREADS = 256; // 8 warps
constexpr int FTP = FT + 1;  // odd shared-memory strides: no bank conflicts
constexpr int DTP = DT + 1;
constexpr int REDUCE_THREADS = 256;
static_assert(DT * FT % THREADS == 0 && BB * FT % THREADS == 0 && BB * DT % THREADS == 0,
              "the tile loads give every thread the same count");

// the constants as torch and JAX round them: Python doubles cast to float32
constexpr float B1 = 0.9f;
constexpr float B2 = 0.999f;
constexpr float OMB1 = (float)(1.0 - 0.9);
constexpr float OMB2 = (float)(1.0 - 0.999);
constexpr float EPS = 1e-8f;

// grid (ceil(D / DT), ceil(F / FT)).  partial: (n_ftiles, B, D).
template <bool ADAM>
__global__ void __launch_bounds__(THREADS)
dec_update_kernel(const float* __restrict__ x, const float* __restrict__ gz,
                  const float* __restrict__ w, const float* __restrict__ m,
                  const float* __restrict__ v, const float* __restrict__ scalars,
                  float* __restrict__ w2, float* __restrict__ m2, float* __restrict__ v2,
                  float* __restrict__ partial, int B, int D, int F) {
    __shared__ float w_s[DT * FTP];
    __shared__ float gz_s[BB * FTP];
    __shared__ float x_s[BB * DTP];

    const int d0 = blockIdx.x * DT;
    const int f0 = blockIdx.y * FT;
    const int tid = threadIdx.x;
    // g_w and the update: warp ty owns tile rows ty + 8 i, lane tx columns tx + 32 j
    const int tx = tid % 32, ty = tid / 32;
    // g_x: thread owns batch row gr of the chunk and tile rows gc + 8 k
    const int gr = tid / 8, gc = tid % 8;

    // the pre-update weight tile, read once for both products; the loads of
    // a thread are unrolled so that they are all in flight together
#pragma unroll
    for (int k = 0; k < DT * FT / THREADS; ++k) {
        const int idx = tid + k * THREADS;
        const int r = idx / FT, c = idx - r * FT;
        const int d = d0 + r, f = f0 + c;
        w_s[r * FTP + c] = (d < D && f < F) ? w[(size_t)d * F + f] : 0.f;
    }

    // the tile's moments, fetched now so that their loads overlap the products
    float acc[4][4], mv[4][4], vv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int d = d0 + ty + 8 * i, f = f0 + tx + 32 * j;
            const bool in = ADAM && d < D && f < F;
            acc[i][j] = 0.f;
            mv[i][j] = in ? m[(size_t)d * F + f] : 0.f;
            vv[i][j] = in ? v[(size_t)d * F + f] : 0.f;
        }

    for (int b0 = 0; b0 < B; b0 += BB) {
        __syncthreads();  // the previous chunk is consumed
#pragma unroll
        for (int k = 0; k < BB * FT / THREADS; ++k) {
            const int idx = tid + k * THREADS;
            const int r = idx / FT, c = idx - r * FT;
            const int b = b0 + r, f = f0 + c;
            gz_s[r * FTP + c] = (b < B && f < F) ? gz[(size_t)b * F + f] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < BB * DT / THREADS; ++k) {
            const int idx = tid + k * THREADS;
            const int r = idx / DT, c = idx - r * DT;
            const int b = b0 + r, d = d0 + c;
            x_s[r * DTP + c] = (b < B && d < D) ? x[(size_t)b * D + d] : 0.f;
        }
        __syncthreads();

        // g_w tile += x_chunk^T g_z_chunk
        for (int r = 0; r < BB; ++r) {
            float xv[4], gv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) xv[i] = x_s[r * DTP + ty + 8 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) gv[j] = gz_s[r * FTP + tx + 32 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], gv[j], acc[i][j]);
        }

        // this F tile's share of g_x: g_z_chunk (BB x FT) w_tile^T (FT x DT)
        float gx[4] = {0.f, 0.f, 0.f, 0.f};
        const float* gzr = gz_s + gr * FTP;
        for (int c = 0; c < FT; ++c) {
            const float g = gzr[c];
#pragma unroll
            for (int k = 0; k < 4; ++k) gx[k] = fmaf(g, w_s[(gc + 8 * k) * FTP + c], gx[k]);
        }
        const int b = b0 + gr;
        if (b < B) {
            float* out = partial + ((size_t)blockIdx.y * B + b) * D;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int d = d0 + gc + 8 * k;
                if (d < D) out[d] = gx[k];
            }
        }
    }
    __syncthreads();  // w_s is complete even when B == 0

    const float lr = scalars[0];
    const float bc1 = scalars[1];
    const float bc2 = scalars[2];
    const bool on = scalars[3] > 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int d = d0 + ty + 8 * i;
        if (d >= D) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int f = f0 + tx + 32 * j;
            if (f >= F) continue;
            const size_t o = (size_t)d * F + f;
            const float wv = w_s[(ty + 8 * i) * FTP + tx + 32 * j];
            const float g = acc[i][j];
            if (ADAM) {
                if (on) {
                    const float mn = B1 * mv[i][j] + OMB1 * g;
                    const float vn = B2 * vv[i][j] + OMB2 * (g * g);
                    w2[o] = wv - lr * (mn / bc1) / (sqrtf(vn / bc2) + EPS);
                    m2[o] = mn;
                    v2[o] = vn;
                } else {
                    w2[o] = wv;
                    m2[o] = mv[i][j];
                    v2[o] = vv[i][j];
                }
            } else {
                w2[o] = on ? wv - lr * g : wv;
            }
        }
    }
}

// gx[i] = sum_t partial[t, i] over the F tiles, in tile order; i runs over B * D.
__global__ void __launch_bounds__(REDUCE_THREADS)
dec_update_reduce(const float* __restrict__ partial, float* __restrict__ gx, size_t n,
                  int n_ftiles) {
    const size_t i = (size_t)blockIdx.x * REDUCE_THREADS + threadIdx.x;
    if (i >= n) return;
    float s = 0.f;
    for (int t = 0; t < n_ftiles; ++t) s += partial[(size_t)t * n + i];
    gx[i] = s;
}

template <bool ADAM>
int launch(const void* x, const void* gz, const void* w, const void* m, const void* v,
           const void* scalars, void* w2, void* m2, void* v2, void* partial, void* gx,
           int B, int D, int F, void* stream) {
    if (B < 1 || D < 1 || F < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int n_ftiles = (F + FT - 1) / FT;
    dim3 grid((D + DT - 1) / DT, n_ftiles);
    dec_update_kernel<ADAM><<<grid, THREADS, 0, s>>>(
        (const float*)x, (const float*)gz, (const float*)w, (const float*)m, (const float*)v,
        (const float*)scalars, (float*)w2, (float*)m2, (float*)v2, (float*)partial, B, D, F);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const size_t n = (size_t)B * D;
    dec_update_reduce<<<(unsigned)((n + REDUCE_THREADS - 1) / REDUCE_THREADS), REDUCE_THREADS,
                        0, s>>>((const float*)partial, (float*)gx, n, n_ftiles);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int dec_update_f_tile() { return FT; }

// partial: (ceil(F / FT), B, D) scratch; w2, m2, v2: (D, F); gx: (B, D)
int dec_update_adam(const void* x, const void* gz, const void* w, const void* m, const void* v,
                    const void* scalars, void* w2, void* m2, void* v2, void* partial, void* gx,
                    int B, int D, int F, void* stream) {
    return launch<true>(x, gz, w, m, v, scalars, w2, m2, v2, partial, gx, B, D, F, stream);
}

// partial: (ceil(F / FT), B, D) scratch; w2: (D, F); gx: (B, D)
int dec_update_sgd(const void* x, const void* gz, const void* w, const void* scalars, void* w2,
                   void* partial, void* gx, int B, int D, int F, void* stream) {
    return launch<false>(x, gz, w, nullptr, nullptr, scalars, w2, nullptr, nullptr, partial, gx,
                         B, D, F, stream);
}

}  // extern "C"
