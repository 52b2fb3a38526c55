// Angular word-likelihood partition (forward) for Hopper, sm_90a.  Its
// latent gradient is angular_bwd.cu; both take their tile shape, row layout
// and tile load from angular_tile.cuh.
//
// Replaces the Pallas TPU kernel _fwd_kernel of mmtpu/kernels/angular.py
// (pallas_call in _call_fwd):
//
//   Z[b]  = sum_v (1 - acos(clip(cos(l_b, v), +-(1 - 1e-7))) / pi)
//   cos   = l_b . v / max(|l_b| |v|, 1e-8)
//
// What bounds it on an H100: one product of 2 B V D operations against one
// read of the inputs.  At (B, V, D) = (64, 3016, 300) that is 116 MFLOP
// against 3.7 MB, so the float32 FMA rate sets the bound (1.7 us at 67
// TFLOP/s; 13.8 us at 512 rows), not the memory.  A kernel that reads its
// operands from shared memory as scalars misses it inside the SM: at 0.75
// loads per FMA the load/store unit sets the pace.
//
// What the design does about it:
// - Register tiles.  Each lane holds a 4 latent row x 4 vocab row tile and
//   reads both operands from shared memory as float4 along D: 8 loads for 64
//   FMAs.  The four lanes of a tile take every fourth float4 of D and add
//   their sums with two shuffle steps that each keep half the rows, so each
//   lane ends with one row's four dot products.  The cosine, clip, acosf and
//   vocabulary mask follow in registers, into the lane's running row sum.
// - Two blocks per SM: BM = BV = 32 rows at full depth take about 77 KB of
//   shared memory at D = 300, so one block's tile loads overlap the other's
//   products.  At D = 512 (130 KB) the SM takes one block; the grid asks the
//   runtime how many fit (angular_fwd_blocks_per_sm).
// - |l|^2 with 8 lanes per row and shuffles.
// - The TPU carried each row's sum across sequential vocab grid steps; here
//   blocks run in any order, so the vocabulary is split into chunks of whole
//   sub-tiles across blocks (grid: mmtpu_torch/kernels/angular.py::fwd_grid)
//   and each block writes one partial per (chunk, row).  The last block of
//   each row tile to finish (found through a __threadfence and a ticket per
//   row tile, which that block resets) adds the row tile's partials in a
//   fixed order: no second kernel, and no float atomics, so runs reproduce
//   bit for bit.
//
// C interface, loaded with ctypes: every entry point takes device pointers
// and the CUDA stream, launches asynchronously and returns cudaGetLastError().

#include "angular_tile.cuh"

namespace {

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

// grid (ceil(B / BM), n_chunks); chunk c covers vocab sub-tiles
// [c * tiles_per_chunk, (c + 1) * tiles_per_chunk).  partial: (n_chunks, B);
// tickets: one per row tile, all 0.  The last block of a row tile adds its
// partials into out (B,) and sets its ticket back to 0.
__global__ void __launch_bounds__(THREADS, 2)
angular_fwd_kernel(const float* __restrict__ lat, const float* __restrict__ vocab,
                   const float* __restrict__ vnorm, float* __restrict__ partial,
                   unsigned* __restrict__ tickets, float* __restrict__ out, int B, int V,
                   int D, int tiles_per_chunk) {
    extern __shared__ float4 smem[];
    __shared__ bool last;
    const int d4 = depth4(D), dp4 = stride4(D);
    float4* lat_s = smem;                                         // BM x dp4
    float4* voc_s = lat_s + BM * dp4;                             // BV x dp4
    float* lnsq_s = reinterpret_cast<float*>(voc_s + BV * dp4);   // BM
    float* vn_s = lnsq_s + BM;                                    // BV
    float* rs_s = vn_s + BV;                                      // [2][BM]

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    // tile of a lane: latent rows 4 rg + i, vocab rows 4 cg + j; the four
    // lanes ks = 0..3 of a tile split D, and lane ks ends with row 4 rg + ks
    const int ks = lane & 3;
    const int cg = 4 * (warp & 1) + ((lane >> 2) & 3);
    const int rg = 2 * (warp >> 1) + (lane >> 4);
    const int r = 4 * rg + ks;
    const int b0 = blockIdx.x * BM;
    const int n_sub = (V + BV - 1) / BV;
    const int st0 = blockIdx.y * tiles_per_chunk;
    const int st1 = min(st0 + tiles_per_chunk, n_sub);

    load_tile<BM>(lat_s, lat, b0, B, D, d4, dp4);
    __syncthreads();
    {  // |l|^2, 8 lanes per row
        const int row = tid >> 3, p = tid & 7;
        float s = 0.f;
        for (int k = p; k < d4; k += 8) {
            float4 x = lat_s[row * dp4 + k];
            s = dot4(x, x, s);
        }
        s += __shfl_xor_sync(FULL, s, 1);
        s += __shfl_xor_sync(FULL, s, 2);
        s += __shfl_xor_sync(FULL, s, 4);
        if (p == 0) lnsq_s[row] = s;
    }

    float rs = 0.f;  // sum over this lane's vocab columns for row r
    for (int st = st0; st < st1; ++st) {
        const int v0 = st * BV;
        __syncthreads();  // previous sub-tile consumed
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
        float dots[4];
        reduce_scatter(acc, ks, dots);

        const float ln = sqrtf(lnsq_s[r]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int c = 4 * cg + j;
            if (v0 + c < V) {
                float cs = dots[j] / fmaxf(ln * vn_s[c], COS_EPS);
                cs = fminf(fmaxf(cs, ACOS_LO), ACOS_HI);
                rs += 1.f - acosf(cs) / PI_F;
            }
        }
    }

    // over the four tiles of the warp's half (lane bits 2-3), then over the
    // two warps that share a row group, in that order
    rs += __shfl_xor_sync(FULL, rs, 4);
    rs += __shfl_xor_sync(FULL, rs, 8);
    if (((lane >> 2) & 3) == 0) rs_s[(warp & 1) * BM + r] = rs;
    __syncthreads();
    if (tid < BM && b0 + tid < B) {
        partial[(size_t)blockIdx.y * B + b0 + tid] = rs_s[tid] + rs_s[BM + tid];
        __threadfence();  // the partial is visible to every block before the ticket
    }
    __syncthreads();
    if (tid == 0) last = atomicAdd(&tickets[blockIdx.x], 1u) == gridDim.y - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    // the row tile's partials, 8 lanes per row: lane p adds chunks p, p + 8,
    // ... in order, then the lanes add by a fixed xor tree
    const int row = tid >> 3, p = tid & 7, b = b0 + row;
    float s = 0.f;
    if (b < B)
        for (int c = p; c < (int)gridDim.y; c += 8) s += __ldcg(&partial[(size_t)c * B + b]);
    s += __shfl_xor_sync(FULL, s, 1);
    s += __shfl_xor_sync(FULL, s, 2);
    s += __shfl_xor_sync(FULL, s, 4);
    if (p == 0 && b < B) out[b] = s;
    if (tid == 0) tickets[blockIdx.x] = 0u;
}

size_t fwd_smem_bytes(int d) {
    return sizeof(float4) * (size_t)(BM + BV) * stride4(d) + sizeof(float) * (BM + BV + 2 * BM);
}

cudaError_t configure(int D) {
    cudaError_t err = cudaFuncSetAttribute(angular_fwd_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)fwd_smem_bytes(D));
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(angular_fwd_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared);
}

}  // namespace

extern "C" {

// K1's tile shape and depth bound, forward and backward alike
int angular_max_depth() { return MAX_D; }
int angular_row_tile() { return BM; }
int angular_vocab_tile() { return BV; }

// Resident blocks per SM of the main kernel at depth D (-1 on error).
int angular_fwd_blocks_per_sm(int D) {
    if (D < 1 || D > MAX_D || configure(D) != cudaSuccess) return -1;
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, angular_fwd_kernel, THREADS,
                                                      fwd_smem_bytes(D)) != cudaSuccess)
        return -1;
    return n;
}

// partial: (n_chunks, B) scratch; tickets: one per row tile, all 0 (and left
// 0 when the kernel ends); out: (B,)
int angular_fwd(const void* lat, const void* vocab, const void* vnorm, void* partial,
                void* tickets, void* out, int B, int V, int D, int n_chunks,
                int tiles_per_chunk, void* stream) {
    if (D < 1 || D > MAX_D) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = configure(D);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((B + BM - 1) / BM, n_chunks);
    angular_fwd_kernel<<<grid, THREADS, fwd_smem_bytes(D), s>>>(
        (const float*)lat, (const float*)vocab, (const float*)vnorm, (float*)partial,
        (unsigned*)tickets, (float*)out, B, V, D, tiles_per_chunk);
    return (int)cudaGetLastError();
}

}  // extern "C"
