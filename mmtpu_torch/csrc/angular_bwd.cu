// Latent gradient (backward) of the angular word-likelihood partition for
// Hopper, sm_90a.  Its tile shape, row layout and tile load are shared with
// the forward (angular.cu) through angular_tile.cuh.
//
// Replaces the Pallas TPU kernel _bwd_kernel of mmtpu/kernels/angular.py
// (pallas_call in _call_bwd):
//
//   dl[b] = sum_v g w v / max(|l||v|, 1e-8) - (sum_v g w cos) l / max(|l|^2, 1e-8)
//   cos   = clip(l_b . v / max(|l_b| |v|, 1e-8), +-(1 - 1e-7))
//   w     = (1/pi) / sqrt(max(1 - cos^2, 1e-12))
//
// The vocabulary is a constant: no vocab gradient.  The cosines are
// recomputed tile by tile, so nothing of size (B, V) reaches device memory.
//
// What bounds it on an H100: two products of 2 B V D operations each (the
// cosines l v^T and term 1, coef @ v) against one read of the inputs.  At
// (B, V, D) = (64, 3016, 300) that is 232 MFLOP against 3.7 MB, so the
// float32 FMA rate sets the bound (3.5 us at 67 TFLOP/s), not the memory.
// A simple kernel misses it inside the SM: with one shared-memory load per
// FMA the load/store unit sets the pace at a quarter of the FMA rate or less.
//
// What the design does about it:
// - Register tiles for both products.  For the cosines each thread holds a
//   4 latent row x 4 vocab row tile and reads both operands from shared
//   memory as float4 along D: 8 loads for 64 FMAs.  The four lanes that share
//   a tile split D between them and add their sums with two shuffles.  For
//   term 1 the block's BM x D slab of t1 stays in registers: each warp owns
//   4 rows, each lane float4 column groups of D; per vocab row it reads its 4
//   coefficients as one broadcast float4 and one float4 of the row for each
//   column group, 16 FMAs per float4 of the vocabulary.
// - Bank conflicts: shared rows have a stride of 4 x (an odd number) of
//   floats, so 16-byte loads of neighbouring rows fall in distinct banks;
//   the depth is zero-padded to it.
// - Two blocks per SM: BM = 32 latent rows and BV = 32 vocab rows at full
//   depth take about 80 KB at D = 300, so one block's tile loads overlap the
//   other's products.  Up to MAX_D = 512 every depth works; above D = 384 a
//   block holds one more column group and the SM takes one block.
// - The TPU carried each row's sum across sequential vocab grid steps; here
//   blocks run in any order, so the vocabulary is split into chunks of whole
//   sub-tiles across blocks (grid: mmtpu_torch/kernels/angular.py::bwd_grid),
//   each block writes a partial per (chunk, row), and a second pass with one
//   thread per (row, float4 of D) adds the partials in chunk order.  No float
//   atomics, so runs reproduce bit for bit.  As in the TPU kernel, each
//   vocabulary chunk's partial holds both terms (t1 - s l / max(|l|^2,
//   1e-8) over the chunk), so the second pass only adds.
//
// C interface, loaded with ctypes: the entry point takes device pointers and
// the CUDA stream, launches asynchronously and returns cudaGetLastError().

#include "angular_tile.cuh"

namespace {

constexpr int REDUCE_THREADS = 256;
constexpr float W_EPS = 1e-12f;

__device__ inline void axpy4(float c, float4 v, float4& acc) {
    acc.x = fmaf(c, v.x, acc.x);
    acc.y = fmaf(c, v.y, acc.y);
    acc.z = fmaf(c, v.z, acc.z);
    acc.w = fmaf(c, v.w, acc.w);
}

// grid (ceil(B / BM), n_chunks); chunk c covers vocab sub-tiles
// [c * tiles_per_chunk, (c + 1) * tiles_per_chunk).  partial_dl:
// (n_chunks, B, 4 * depth4(D)) gets the chunk's part of dl,
// sum_v g w v / denom - (sum_v g w cos) l / max(|l|^2, 1e-8).
// NF4 = float4 column groups per lane in term 1, ceil(depth4(D) / 32).
template <int NF4>
__global__ void __launch_bounds__(THREADS, NF4 <= 3 ? 2 : 1)
angular_bwd_kernel(const float* __restrict__ lat, const float* __restrict__ vocab,
                   const float* __restrict__ vnorm, const float* __restrict__ g,
                   float* __restrict__ partial_dl, int B, int V, int D,
                   int tiles_per_chunk) {
    extern __shared__ float4 smem[];
    const int d4 = depth4(D), dp4 = stride4(D);
    float4* lat_s = smem;                                         // BM x dp4
    float4* voc_s = lat_s + BM * dp4;                             // BV x dp4
    float* coef_s = reinterpret_cast<float*>(voc_s + BV * dp4);   // [BV][BM]
    float* lnsq_s = coef_s + BV * BM;                             // BM
    float* g_s = lnsq_s + BM;                                     // BM
    float* vn_s = g_s + BM;                                       // BV
    float* ss_s = vn_s + BV;                                      // [2][BM]

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    // cosine tile of a lane: latent rows 4 rg + i, vocab rows 4 cg + j; the
    // four lanes ks = 0..3 of a tile split D, and lane ks ends with row 4 rg + ks
    const int ks = lane & 3;
    const int cg = 4 * (warp & 1) + ((lane >> 2) & 3);
    const int rg = 2 * (warp >> 1) + (lane >> 4);
    const int b0 = blockIdx.x * BM;
    const int n_sub = (V + BV - 1) / BV;
    const int st0 = blockIdx.y * tiles_per_chunk;
    const int st1 = min(st0 + tiles_per_chunk, n_sub);

    load_tile<BM>(lat_s, lat, b0, B, D, d4, dp4);
    if (tid < BM) g_s[tid] = b0 + tid < B ? g[b0 + tid] : 0.f;
    __syncthreads();
    {  // |l|^2, 8 lanes per row
        const int r = tid >> 3, p = tid & 7;
        float s = 0.f;
        for (int k = p; k < d4; k += 8) {
            float4 x = lat_s[r * dp4 + k];
            s = dot4(x, x, s);
        }
        s += __shfl_xor_sync(FULL, s, 1);
        s += __shfl_xor_sync(FULL, s, 2);
        s += __shfl_xor_sync(FULL, s, 4);
        if (p == 0) lnsq_s[r] = s;
    }

    float4 t1[4][NF4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int m = 0; m < NF4; ++m) t1[i][m] = make_float4(0.f, 0.f, 0.f, 0.f);
    float ss = 0.f;

    for (int st = st0; st < st1; ++st) {
        const int v0 = st * BV;
        __syncthreads();  // previous sub-tile and its coefficients consumed
        load_tile<BV>(voc_s, vocab, v0, V, D, d4, dp4);
        if (tid < BV) vn_s[tid] = v0 + tid < V ? vnorm[v0 + tid] : 0.f;
        __syncthreads();

        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
        for (int k = ks; k < d4; k += 4) {
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
        // add the four lanes' sums, halving the rows kept at each step
        const bool hi1 = ks & 2, hi0 = ks & 1;
        float h[2][4], dots[4];
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

        const int r = 4 * rg + ks;
        const float ln = sqrtf(lnsq_s[r]), gr = g_s[r];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int c = 4 * cg + j;
            float coef = 0.f;
            if (v0 + c < V) {
                float denom = fmaxf(ln * vn_s[c], COS_EPS);
                float cs = fminf(fmaxf(dots[j] / denom, ACOS_LO), ACOS_HI);
                float w = (1.f / PI_F) / sqrtf(fmaxf(1.f - cs * cs, W_EPS));
                float wg = w * gr;
                coef = wg / denom;
                ss += wg * cs;
            }
            coef_s[c * BM + r] = coef;
        }
        __syncthreads();

        // term 1: t1[4 warp + i, :] += coef[4 warp + i, :] @ voc_s
        const float4* coef4 = reinterpret_cast<const float4*>(coef_s) + warp;
#pragma unroll 2
        for (int j = 0; j < BV; ++j) {
            const float4 c = coef4[j * (BM / 4)];
#pragma unroll
            for (int m = 0; m < NF4; ++m) {
                const int k = lane + 32 * m;
                if (k < d4) {
                    const float4 v = voc_s[j * dp4 + k];
                    axpy4(c.x, v, t1[0][m]);
                    axpy4(c.y, v, t1[1][m]);
                    axpy4(c.z, v, t1[2][m]);
                    axpy4(c.w, v, t1[3][m]);
                }
            }
        }
    }

    // sum_v g w cos: over the four tiles of the warp's half (lane bits 2-3),
    // then over the two warps that share a row group
    ss += __shfl_xor_sync(FULL, ss, 4);
    ss += __shfl_xor_sync(FULL, ss, 8);
    if (((lane >> 2) & 3) == 0) ss_s[(warp & 1) * BM + 4 * rg + ks] = ss;
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = 4 * warp + i;
        if (b0 + r < B) {
            const float s = ss_s[r] + ss_s[BM + r];
            const float denom = fmaxf(lnsq_s[r], COS_EPS);
            float4* out = reinterpret_cast<float4*>(partial_dl) +
                          ((size_t)blockIdx.y * B + b0 + r) * d4;
#pragma unroll
            for (int m = 0; m < NF4; ++m) {
                const int k = lane + 32 * m;
                if (k < d4) {
                    const float4 l = lat_s[r * dp4 + k];
                    float4 o = t1[i][m];
                    o.x -= s * l.x / denom;
                    o.y -= s * l.y / denom;
                    o.z -= s * l.z / denom;
                    o.w -= s * l.w / denom;
                    out[k] = o;
                }
            }
        }
    }
}

// One thread per (row, float4 of D): dl = sum_c partial_dl[c], in chunk order.
__global__ void __launch_bounds__(REDUCE_THREADS)
angular_bwd_reduce(const float* __restrict__ partial_dl, float* __restrict__ dlat, int B,
                   int D, int n_chunks) {
    const int d4 = depth4(D);
    const int idx = blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= B * d4) return;
    const int b = idx / d4, k = idx - b * d4;
    const float4* __restrict__ p = reinterpret_cast<const float4*>(partial_dl) + idx;
    const size_t step = (size_t)B * d4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    int c = 0;
    for (; c + 16 <= n_chunks; c += 16) {  // sixteen loads in flight, added in order
        float4 v[16];
#pragma unroll
        for (int u = 0; u < 16; ++u) v[u] = p[(c + u) * step];
#pragma unroll
        for (int u = 0; u < 16; ++u) {
            acc.x += v[u].x;
            acc.y += v[u].y;
            acc.z += v[u].z;
            acc.w += v[u].w;
        }
    }
    for (; c < n_chunks; ++c) {
        float4 v = p[c * step];
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
    }
    float* out = dlat + (size_t)b * D;
    const float a[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
        if (4 * k + e < D) out[4 * k + e] = a[e];
}

size_t bwd_smem_bytes(int d) {
    return sizeof(float4) * (size_t)(BM + BV) * stride4(d) +
           sizeof(float) * (size_t)(BV * BM + 2 * BM + BV + 2 * BM);
}

template <int NF4>
cudaError_t configure(int D) {
    auto kern = angular_bwd_kernel<NF4>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bwd_smem_bytes(D));
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared);
}

template <int NF4>
cudaError_t launch(const float* lat, const float* vocab, const float* vnorm, const float* g,
                   float* partial_dl, int B, int V, int D, int n_chunks, int tiles_per_chunk,
                   cudaStream_t s) {
    cudaError_t err = configure<NF4>(D);
    if (err != cudaSuccess) return err;
    dim3 grid((B + BM - 1) / BM, n_chunks);
    angular_bwd_kernel<NF4><<<grid, THREADS, bwd_smem_bytes(D), s>>>(
        lat, vocab, vnorm, g, partial_dl, B, V, D, tiles_per_chunk);
    return cudaGetLastError();
}

template <int NF4>
int occupancy(int D) {
    int n = 0;
    if (configure<NF4>(D) != cudaSuccess) return -1;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, angular_bwd_kernel<NF4>, THREADS,
                                                      bwd_smem_bytes(D)) != cudaSuccess)
        return -1;
    return n;
}

int column_groups(int D) { return (depth4(D) + 31) / 32; }

}  // namespace

extern "C" {

// Resident blocks per SM of the main kernel at depth D (-1 on error).
int angular_bwd_blocks_per_sm(int D) {
    if (D < 1 || D > MAX_D) return -1;
    switch (column_groups(D)) {
        case 1: return occupancy<1>(D);
        case 2: return occupancy<2>(D);
        case 3: return occupancy<3>(D);
        default: return occupancy<4>(D);
    }
}

// partial_dl: (n_chunks, B, 4 * ceil(D / 4)) scratch; dlat: (B, D)
int angular_bwd(const void* lat, const void* vocab, const void* vnorm, const void* g,
                void* partial_dl, void* dlat, int B, int V, int D, int n_chunks,
                int tiles_per_chunk, void* stream) {
    if (D < 1 || D > MAX_D) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const float *l = (const float*)lat, *v = (const float*)vocab, *vn = (const float*)vnorm,
                *gg = (const float*)g;
    float* pdl = (float*)partial_dl;
    cudaError_t err;
    switch (column_groups(D)) {
        case 1: err = launch<1>(l, v, vn, gg, pdl, B, V, D, n_chunks, tiles_per_chunk, s); break;
        case 2: err = launch<2>(l, v, vn, gg, pdl, B, V, D, n_chunks, tiles_per_chunk, s); break;
        case 3: err = launch<3>(l, v, vn, gg, pdl, B, V, D, n_chunks, tiles_per_chunk, s); break;
        default: err = launch<4>(l, v, vn, gg, pdl, B, V, D, n_chunks, tiles_per_chunk, s);
    }
    if (err != cudaSuccess) return (int)err;
    const int n = B * depth4(D);
    angular_bwd_reduce<<<(n + REDUCE_THREADS - 1) / REDUCE_THREADS, REDUCE_THREADS, 0, s>>>(
        pdl, (float*)dlat, B, D, n_chunks);
    return (int)cudaGetLastError();
}

}  // extern "C"
