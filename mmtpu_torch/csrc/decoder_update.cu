// Fused decoder update (kernel K2) for Hopper, sm_90a: the weight-gradient
// product, the optimizer step and the latent cotangent of one stacked
// decoder weight leaf in one kernel.
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
//   flag <= 0: w2, m2, v2 = w, m, v bit for bit
//   g_x  = g_z w^T with the PRE-update w, whatever flag     (B, D)
// bc1 and bc2 are the bias corrections at the post-increment step count.
// Each of lr, bc1, bc2 and flag comes either as a device pointer to float32
// or, where that pointer is null, by value, so a caller that keeps them on
// the device never waits for the host.  Outputs are written out of place
// (w2, m2, v2 are new buffers).
//
// The config axis: a call may carry K independent problems, (K, D, F)
// tables, x (K, B, D), g_z (K, B, F), g_x (K, B, D), as the sweep trains K
// configs as one program (mmtpu vmaps the Pallas kernel there, which adds a
// grid dimension).  Config k is blockIdx.z: each block offsets its pointers
// by k, reads each scalar at ptr[k * stride] (stride 1 for a per-config
// scalar, 0 for a shared one), and owns its own tickets and g_x slabs, so no
// value crosses configs and a config at flag 0 passes its tables through.
// One call is one launch whatever K; the 2-D call is K = 1.
//
// What bounds it on an H100: at the main path's shape (B, D, F) = (64, 300,
// 1400) the Adam call must move w, m, v in and out (6 x 1.68 MB) plus g_z,
// x and g_x, 10.6 MB in all, 3.2 us at 3.35 TB/s; its two products are
// 2 x 2 x 64 x 300 x 1400 = 108 MFLOP, 1.6 us at the 67 TFLOP/s float32 peak
// outside the tensor cores, so bytes bound it.  The SGD call moves 3.9 MB
// (1.2 us) for the same 108 MFLOP, so operations bound it.  Float32 FMAs
// throughout: plain TF32 misses the 1e-5 gates.  At the sweep's fused shape
// (K, B, D, F) = (32, 64, 300, 1400) the Adam call moves 32 x 10.6 MB (0.101
// ms), bytes-bound; the SGD call does 32 x 108 MFLOP (0.052 ms),
// operations-bound.
//
// Design:
// - One launch per call.  A block owns one D tile of DT rows and a chunk of
//   whole F sub-tiles of FT columns of one config (grid: mmtpu_torch/kernels/
//   angular.py::fwd_grid fed 1/K of the occupancy query's slots, so the grid
//   stays near one wave: at the main path's shape 19 D tiles x 11 chunks of 2
//   sub-tiles, 209 blocks; at K = 32 one chunk per D tile, 608).  It walks its
//   sub-tiles and, inside each, the batch in chunks of BB rows: a "stage" is
//   one (sub-tile, batch chunk).  Per stage it stages g_z (BB x FT) and the
//   x chunk (BB x DT; once per block when B <= BB) and, at a new sub-tile,
//   the tiles of w, m and v (DT x FT) into shared memory with 16-byte
//   cp.async in two groups, double buffered: stage k + 1's copies are in
//   flight while stage k's products run, and g_w starts before stage k's
//   tiles of w, m and v have landed.  w2, m2 and v2 leave as 16-byte
//   stores.  F not a multiple of 4 or a table not 16-byte aligned takes
//   4-byte copies and scalar stores (likewise D, x and g_x); every edge is
//   zero-filled or masked.
// - Register tiles.  Four quarters of 64 threads split each product's sum.
//   g_w: each thread holds a 4 (d) x 4 (f) tile over its quarter's batch
//   rows and reads, per row, one float4 of x (two addresses per warp,
//   broadcast) and one float4 of g_z (16 consecutive): 3 shared wavefronts
//   per 16 warp FMAs, 0.19 per FMA (the SM serves one wavefront while it
//   issues four warp FMAs, so the FMAs set the pace; one scalar load per
//   FMA pair would give 0.5).  g_x: each thread holds 4 (b) x 4 (d) dot
//   products over its quarter's columns, reading float4s along F from rows
//   at an odd float4 stride (rows bg + 16 i and dg + 4 j: consecutive rows
//   per warp, distinct banks): 8 wavefronts per 64 warp FMAs, 0.125 per FMA
//   (scalar loads, one of g_z and four of w per four FMAs, would give
//   1.25).  The quarters add through shared memory in quarter order; each
//   thread keeps one row of each tile: one float4 of the step and one batch
//   row of g_x.
// - g_x across blocks without a second kernel or float atomics.  Where B <=
//   BB the block keeps its g_x partial in registers across its sub-tiles and
//   writes it once; otherwise it writes (or, after its first sub-tile, adds
//   into) its partial per batch chunk: a BB x DT slab, laid side by side
//   with the other chunks' slabs of the same (D tile, batch chunk) region.
//   After its last sub-tile, past a barrier, one thread fences the slab and
//   takes the region's ticket; the block then does its step, and the block
//   that drew the last ticket adds the region's slabs in chunk order
//   (16-byte loads from L2, eight chunks in flight) and sets the ticket back
//   to 0.  The order is fixed: two calls give equal bits.
// - Two blocks of 256 threads per SM (103,936 B of shared memory each, at
//   most 128 registers; dec_update_blocks_per_sm asks the runtime).
//
// C interface, loaded with ctypes: every entry point takes device pointers
// and the CUDA stream, launches asynchronously and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int DT = 16;        // weight rows (the latent depth D) per D tile
constexpr int FT = 64;        // weight columns (the stacked head width F) per sub-tile
constexpr int BB = 64;        // batch rows per chunk
constexpr int THREADS = 256;  // 8 warps; four quarters of 64 split each product's sum
constexpr int QT = THREADS / 4;
constexpr int FT4 = FT / 4, DT4 = DT / 4;
constexpr int FS4 = FT4 + 1;  // odd float4 row strides: rows 1 apart in distinct banks
constexpr int DS4 = DT4 + 1;
static_assert(DT4 * FT4 == QT, "g_w: one 4 x 4 tile per thread of a quarter");
static_assert((BB / 4) * DT4 == QT, "g_x: one 4 x 4 tile per thread of a quarter");
static_assert(BB == 64 && DT == 16 && FT == 64, "the lane maps below assume these");

// the constants as torch and JAX round them: Python doubles cast to float32
constexpr float B1 = 0.9f;
constexpr float B2 = 0.999f;
constexpr float OMB1 = (float)(1.0 - 0.9);
constexpr float OMB2 = (float)(1.0 - 0.999);
constexpr float EPS = 1e-8f;

struct Smem {
    float4 gz[2][BB * FS4];   // g_z chunk, BB x FT
    float4 x[2][BB * DS4];    // x chunk, BB x DT
    float4 w[2][DT * FS4];    // pre-update w tile, DT x FT
    float4 m[2][DT * FS4];    // its moments (Adam)
    float4 v[2][DT * FS4];
    float4 xgw[4 * THREADS];  // the quarters' exchanges of g_w and g_x
    float4 xgx[4 * THREADS];
};

// A scalar argument: config k's value at p[k * stride] where p is not
// null, else v.
struct Scalar {
    const float* p;
    float v;
    int stride;
};

__device__ inline float get(Scalar s, int k) { return s.p ? s.p[(size_t)k * s.stride] : s.v; }

__device__ inline void cp16(void* dst, const void* src, bool in) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(in ? 16 : 0));
}

__device__ inline void cp4(void* dst, const void* src, bool in) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
                 "r"(in ? 4 : 0));
}

__device__ inline void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ inline void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Rows [r0, r0 + ROWS) and columns [c0, c0 + 4 COLS4) of a (total, width)
// row-major matrix into shared float4 rows of stride S4, by cp.async; what
// lies outside the matrix becomes zeros.  vec: width % 4 == 0 and src is
// 16-byte aligned (16-byte copies), else 4-byte copies.
template <int ROWS, int COLS4, int S4>
__device__ inline void stage_tile(float4* dst, const float* __restrict__ src, int r0, int total,
                                  int c0, int width, bool vec) {
    if (vec) {
        constexpr int N = ROWS * COLS4;
#pragma unroll
        for (int u = 0; u < (N + THREADS - 1) / THREADS; ++u) {
            const int idx = threadIdx.x + u * THREADS;
            if (N % THREADS != 0 && idx >= N) break;
            const int r = idx / COLS4, k = idx - r * COLS4;
            const int row = r0 + r, col = c0 + 4 * k;
            const bool in = row < total && col < width;
            cp16(dst + r * S4 + k, in ? src + (size_t)row * width + col : src, in);
        }
        return;
    }
    float* d = reinterpret_cast<float*>(dst);
#pragma unroll 4
    for (int idx = threadIdx.x; idx < ROWS * COLS4 * 4; idx += THREADS) {
        const int r = idx / (COLS4 * 4), k = idx - r * (COLS4 * 4);
        const int row = r0 + r, col = c0 + k;
        const bool in = row < total && col < width;
        cp4(d + r * S4 * 4 + k, in ? src + (size_t)row * width + col : src, in);
    }
}

__device__ inline float at(float4 a, int i) {
    return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

__device__ inline float4 row4(const float (&a)[4]) {
    return make_float4(a[0], a[1], a[2], a[3]);
}

__device__ inline float4 add4(float4 a, float4 b) {
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// one element of the torch-Adam step, in place
__device__ inline void adam1(float& w, float& m, float& v, float g, float lr, float bc1,
                             float bc2) {
    m = B1 * m + OMB1 * g;
    v = B2 * v + OMB2 * (g * g);
    w = w - lr * (m / bc1) / (sqrtf(v / bc2) + EPS);
}

__device__ inline float dot4(float4 a, float4 b, float acc) {
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    return fmaf(a.w, b.w, acc);
}

// Four floats of row `row` from column f of a (D, F) table: one 16-byte
// store where vec, else masked scalars.
__device__ inline void store4(float* __restrict__ t, int row, int f, int D, int F, bool vec,
                              float4 a) {
    if (row >= D || f >= F) return;
    const size_t o = (size_t)row * F + f;
    if (vec) {
        *reinterpret_cast<float4*>(t + o) = a;
        return;
    }
    t[o] = a.x;
    if (f + 1 < F) t[o + 1] = a.y;
    if (f + 2 < F) t[o + 2] = a.z;
    if (f + 3 < F) t[o + 3] = a.w;
}

constexpr int SLAB4 = BB * DT / 4;      // float4s of one g_x slab
constexpr int E4 = SLAB4 / THREADS;     // of them per thread
static_assert(SLAB4 % THREADS == 0, "a slab is whole float4s per thread");

// The 4-way exchange of the quarters: quarter q sends rows i != q of its
// 4 x 4 tile ...
__device__ inline void send_rows(float4* xch, const float (&a)[4][4], int q, int t) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
        if (i != q) xch[(i * 4 + q) * QT + t] = row4(a[i]);
}

// ... and adds row q over the quarters, in quarter order.
__device__ inline float4 add_rows(const float4* xch, const float (&a)[4][4], int q, int t) {
    float4 own = row4(a[0]);
#pragma unroll
    for (int i = 1; i < 4; ++i) own = q == i ? row4(a[i]) : own;
    float4 s[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i] = i == q ? own : xch[(q * 4 + i) * QT + t];
    return add4(add4(add4(s[0], s[1]), s[2]), s[3]);
}

// acc = the sum, in order, of the first `count` slabs, read from L2; eight
// slabs' loads in flight per thread.
__device__ inline void sum_slabs(const float4* slabs, int count, float4 (&acc)[E4]) {
    constexpr int U = 8;
#pragma unroll
    for (int e = 0; e < E4; ++e) acc[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i0 = 0; i0 < count; i0 += U) {
        float4 ld[U][E4];
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
            for (int e = 0; e < E4; ++e)
                ld[u][e] = i0 + u < count
                               ? __ldcg(slabs + (size_t)(i0 + u) * SLAB4 + threadIdx.x +
                                        e * THREADS)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
            for (int e = 0; e < E4; ++e)
                if (i0 + u < count) acc[e] = add4(acc[e], ld[u][e]);
    }
}

// grid (ceil(D / DT), n_chunks, K); chunk c covers F sub-tiles [c tpc,
// (c + 1) tpc) of config blockIdx.z.  partial: per config, one BB x DT slab
// per (D tile, batch chunk, chunk), in that order (a region's slabs side by
// side); tickets: one per (config, region), all 0, and left 0.  vec_f: F % 4
// == 0 and g_z and the tables 16-byte aligned; vec_d: D % 4 == 0 and x and gx
// 16-byte aligned (then every config's slice is aligned too).
template <bool ADAM>
__global__ void __launch_bounds__(THREADS, 2)
dec_update_kernel(const float* __restrict__ x, const float* __restrict__ gz,
                  const float* __restrict__ w, const float* __restrict__ m,
                  const float* __restrict__ v, Scalar lr_a, Scalar bc1_a, Scalar bc2_a,
                  Scalar flag_a, float* __restrict__ w2, float* __restrict__ m2,
                  float* __restrict__ v2, float* __restrict__ partial,
                  unsigned* __restrict__ tickets, float* __restrict__ gx, int B, int D, int F,
                  int tpc, bool vec_f, bool vec_d) {
    extern __shared__ float4 smem_raw[];
    Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
    __shared__ bool last;

    // this block's config: its slices of every array
    const int kc = blockIdx.z;
    const size_t bd = (size_t)B * D, df = (size_t)D * F;
    x += kc * bd;
    gx += kc * bd;
    gz += kc * (size_t)B * F;
    w += kc * df;
    w2 += kc * df;
    if (ADAM) {
        m += kc * df;
        v += kc * df;
        m2 += kc * df;
        v2 += kc * df;
    }
    {
        const size_t regions = (size_t)gridDim.x * ((B + BB - 1) / BB);
        partial += kc * regions * gridDim.y * (size_t)(BB * DT);
        tickets += kc * regions;
    }

    const int tid = threadIdx.x;
    const int q = tid / QT, t = tid % QT;  // the quarter splits each product's sum
    // g_w over the quarter's batch rows 16 q ..: rows 4 td + i, columns
    // 4 tf + j; after the quarters add, the thread keeps row 4 td + q
    const int td = 2 * (t / 32) + (t % 32) / 16, tf = t % 16;
    // g_x over the quarter's four float4 columns: batch rows bg + 16 i,
    // weight rows dg + 4 j; after the quarters add, it keeps batch row bg + 16 q
    const int bg = 8 * (t / 32) + (t % 32) / 4, dg = t % 4;

    const int d0 = blockIdx.x * DT;
    const int n_sub = (F + FT - 1) / FT;
    const int st0 = blockIdx.y * tpc;
    const int st1 = min(st0 + tpc, n_sub);
    const int nbc = (B + BB - 1) / BB;
    const int n_stages = (st1 - st0) * nbc;
    const int n_chunks = gridDim.y;

    const float lr = get(lr_a, kc);
    const bool on = get(flag_a, kc) > 0.f;
    const float bc1 = ADAM ? get(bc1_a, kc) : 1.f;
    const float bc2 = ADAM ? get(bc2_a, kc) : 1.f;

    // a stage's copies in two groups: g_z and x (for g_w), then the sub-tile
    // of w (and of m and v) for g_x and the step, at its first batch chunk
    auto stage_loads = [&](int k) {
        const int st = st0 + k / nbc, c = k % nbc, sb = (st - st0) & 1;
        stage_tile<BB, FT4, FS4>(sm.gz[k & 1], gz, c * BB, B, st * FT, F, vec_f);
        if (nbc > 1 || k == 0)
            stage_tile<BB, DT4, DS4>(sm.x[nbc > 1 ? k & 1 : 0], x, c * BB, B, d0, D, vec_d);
        cp_commit();
        if (c == 0) {
            stage_tile<DT, FT4, FS4>(sm.w[sb], w, d0, D, st * FT, F, vec_f);
            if (ADAM) {
                stage_tile<DT, FT4, FS4>(sm.m[sb], m, d0, D, st * FT, F, vec_f);
                stage_tile<DT, FT4, FS4>(sm.v[sb], v, d0, D, st * FT, F, vec_f);
            }
        }
        cp_commit();
    };

    float gxa[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) gxa[i][j] = 0.f;
    float gwa[4][4];

    stage_loads(0);
    for (int k = 0; k < n_stages; ++k) {
        const int st = st0 + k / nbc, c = k % nbc, sb = (st - st0) & 1;
        const int f0 = st * FT;
        const float4* gz_s = sm.gz[k & 1];
        const float4* x_s = sm.x[nbc > 1 ? k & 1 : 0];
        const float4* w_s = sm.w[sb];
        if (k + 1 < n_stages) stage_loads(k + 1);
        if (c == 0) {
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) gwa[i][j] = 0.f;
        }
        if (k + 1 < n_stages)  // this stage's g_z and x have landed
            cp_wait<3>();
        else
            cp_wait<1>();
        __syncthreads();

        // g_w tile += x_chunk^T g_z_chunk over this quarter's rows
#pragma unroll 4
        for (int r = q * (BB / 4); r < (q + 1) * (BB / 4); ++r) {
            const float4 xv = x_s[r * DS4 + td];
            const float4 gv = gz_s[r * FS4 + tf];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float a = at(xv, i);
                gwa[i][0] = fmaf(a, gv.x, gwa[i][0]);
                gwa[i][1] = fmaf(a, gv.y, gwa[i][1]);
                gwa[i][2] = fmaf(a, gv.z, gwa[i][2]);
                gwa[i][3] = fmaf(a, gv.w, gwa[i][3]);
            }
        }
        if (k + 1 < n_stages)  // the sub-tile's w (m, v) has landed
            cp_wait<2>();
        else
            cp_wait<0>();
        if (c == nbc - 1) send_rows(sm.xgw, gwa, q, t);  // the sub-tile's g_w is complete
        __syncthreads();

        // g_x partial += g_z_chunk w_tile^T over this quarter's columns
#pragma unroll 1
        for (int qc = q * (FT4 / 4); qc < (q + 1) * (FT4 / 4); ++qc) {
            float4 a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = gz_s[(bg + 16 * i) * FS4 + qc];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = w_s[(dg + 4 * j) * FS4 + qc];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) gxa[i][j] = dot4(a[i], b[j], gxa[i][j]);
        }

        const bool last_st = st == st1 - 1;
        const size_t region = (size_t)blockIdx.x * nbc + c;  // (D tile, batch chunk)
        float4* slabs = reinterpret_cast<float4*>(partial) + region * n_chunks * SLAB4;
        if (nbc > 1 || last_st) {
            // g_x of this batch chunk: add the quarters, then write or add
            // into the block's slab of the (D tile, batch chunk) region
            send_rows(sm.xgx, gxa, q, t);
            __syncthreads();
            const float4 s = add_rows(sm.xgx, gxa, q, t);
            float* p = reinterpret_cast<float*>(slabs + (size_t)blockIdx.y * SLAB4) +
                       (bg + 16 * q) * DT + dg;
            const bool first = nbc == 1 || st == st0;
#pragma unroll
            for (int j = 0; j < 4; ++j)
                p[4 * j] = first ? at(s, j) : __ldcg(p + 4 * j) + at(s, j);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) gxa[i][j] = 0.f;

            if (last_st) {
                // every thread's slab stores precede the barrier; one thread
                // publishes them with a fence and takes the region's ticket
                __syncthreads();
                if (tid == 0) {
                    __threadfence();
                    last = atomicAdd(tickets + region, 1u) == (unsigned)(n_chunks - 1);
                    if (last) __threadfence();
                }
            }
        }
        if (c == nbc - 1) {
            // the step; its stores are the block's last work, so they drain
            // while later blocks compute and the last ones add g_x
            const float4 g = add_rows(sm.xgw, gwa, q, t);
            const int dl = 4 * td + q, d = d0 + dl, f = f0 + 4 * tf;
            const float4 wv = w_s[dl * FS4 + tf];
            if (ADAM) {
                float4 wn = wv, mn = sm.m[sb][dl * FS4 + tf], vn = sm.v[sb][dl * FS4 + tf];
                if (on) {
                    adam1(wn.x, mn.x, vn.x, g.x, lr, bc1, bc2);
                    adam1(wn.y, mn.y, vn.y, g.y, lr, bc1, bc2);
                    adam1(wn.z, mn.z, vn.z, g.z, lr, bc1, bc2);
                    adam1(wn.w, mn.w, vn.w, g.w, lr, bc1, bc2);
                }
                store4(w2, d, f, D, F, vec_f, wn);
                store4(m2, d, f, D, F, vec_f, mn);
                store4(v2, d, f, D, F, vec_f, vn);
            } else {
                float4 wn = wv;
                if (on) {
                    wn.x = wv.x - lr * g.x;
                    wn.y = wv.y - lr * g.y;
                    wn.z = wv.z - lr * g.z;
                    wn.w = wv.w - lr * g.w;
                }
                store4(w2, d, f, D, F, vec_f, wn);
            }
        }

        // this stage's buffers are consumed before stage k + 2 is staged, and
        // the ticket's draw (taken before the step, so that its round trip
        // overlaps the step) is visible
        __syncthreads();
        if (last_st && last) {
            // the region's slabs, each element's sum in chunk order
            float4 acc[E4];
            sum_slabs(slabs, n_chunks, acc);
#pragma unroll
            for (int e = 0; e < E4; ++e) {
                const int e4 = tid + e * THREADS;
                const int b = c * BB + e4 / DT4, d = d0 + 4 * (e4 % DT4);
                if (b < B) store4(gx, b, d, B, D, vec_d, acc[e]);
            }
            if (tid == 0) tickets[region] = 0u;
        }
    }
}

template <bool ADAM>
cudaError_t configure() {
    cudaError_t err = cudaFuncSetAttribute(dec_update_kernel<ADAM>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)sizeof(Smem));
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(dec_update_kernel<ADAM>,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared);
}

bool aligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <bool ADAM>
int launch(const void* x, const void* gz, const void* w, const void* m, const void* v,
           Scalar lr, Scalar bc1, Scalar bc2, Scalar flag, void* w2, void* m2, void* v2,
           void* partial, void* tickets, void* gx, int K, int B, int D, int F, int n_chunks,
           int tpc, void* stream) {
    const int n_sub = (F + FT - 1) / FT;
    if (K < 1 || K > 65535 || B < 1 || D < 1 || F < 1 || tpc < 1 ||
        n_chunks != (n_sub + tpc - 1) / tpc)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = configure<ADAM>();
    if (err != cudaSuccess) return (int)err;
    bool vec_f = F % 4 == 0 && aligned(gz) && aligned(w) && aligned(w2);
    if (ADAM) vec_f = vec_f && aligned(m) && aligned(v) && aligned(m2) && aligned(v2);
    const bool vec_d = D % 4 == 0 && aligned(x) && aligned(gx);
    dim3 grid((D + DT - 1) / DT, n_chunks, K);
    dec_update_kernel<ADAM><<<grid, THREADS, sizeof(Smem), (cudaStream_t)stream>>>(
        (const float*)x, (const float*)gz, (const float*)w, (const float*)m, (const float*)v, lr,
        bc1, bc2, flag, (float*)w2, (float*)m2, (float*)v2, (float*)partial, (unsigned*)tickets,
        (float*)gx, B, D, F, tpc, vec_f, vec_d);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K2's tile shape: weight rows per D tile, columns per F sub-tile, batch
// rows per chunk (the tickets are one per D tile and batch chunk)
int dec_update_d_tile() { return DT; }
int dec_update_f_tile() { return FT; }
int dec_update_batch_chunk() { return BB; }

// Resident blocks per SM of the Adam (adam != 0) or SGD kernel (-1 on error).
int dec_update_blocks_per_sm(int adam) {
    int n = 0;
    cudaError_t err;
    if (adam) {
        err = configure<true>();
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, dec_update_kernel<true>,
                                                                THREADS, sizeof(Smem));
    } else {
        err = configure<false>();
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, dec_update_kernel<false>,
                                                                THREADS, sizeof(Smem));
    }
    return err == cudaSuccess ? n : -1;
}

// K configs (K = 1 for one problem): x (K, B, D), gz (K, B, F), the tables
// (K, D, F), gx (K, B, D), contiguous.  Each scalar is (pointer, value,
// stride): a float32 device pointer, config k's value at pointer[k * stride]
// (stride 0: one value for all), or null and the value.  partial: K x ceil(D
// / DT) x ceil(B / BB) x n_chunks slabs of BB x DT floats, scratch; tickets:
// K x ceil(D / DT) x ceil(B / BB) uint32, all 0 (and left 0).
int dec_update_adam(const void* x, const void* gz, const void* w, const void* m, const void* v,
                    const float* lr_p, float lr_v, int lr_s, const float* bc1_p, float bc1_v,
                    int bc1_s, const float* bc2_p, float bc2_v, int bc2_s, const float* flag_p,
                    float flag_v, int flag_s, void* w2, void* m2, void* v2, void* partial,
                    void* tickets, void* gx, int K, int B, int D, int F, int n_chunks, int tpc,
                    void* stream) {
    return launch<true>(x, gz, w, m, v, Scalar{lr_p, lr_v, lr_s}, Scalar{bc1_p, bc1_v, bc1_s},
                        Scalar{bc2_p, bc2_v, bc2_s}, Scalar{flag_p, flag_v, flag_s}, w2, m2, v2,
                        partial, tickets, gx, K, B, D, F, n_chunks, tpc, stream);
}

int dec_update_sgd(const void* x, const void* gz, const void* w, const float* lr_p, float lr_v,
                   int lr_s, const float* flag_p, float flag_v, int flag_s, void* w2,
                   void* partial, void* tickets, void* gx, int K, int B, int D, int F,
                   int n_chunks, int tpc, void* stream) {
    return launch<false>(x, gz, w, nullptr, nullptr, Scalar{lr_p, lr_v, lr_s},
                         Scalar{nullptr, 1.f, 0}, Scalar{nullptr, 1.f, 0},
                         Scalar{flag_p, flag_v, flag_s}, w2, nullptr, nullptr, partial, tickets,
                         gx, K, B, D, F, n_chunks, tpc, stream);
}

}  // extern "C"
