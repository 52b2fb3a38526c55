// The per-token term of the word likelihood, each token's word vector read by
// id, for Hopper, sm_90a: the dots (forward) and their latent gradient
// (backward).
//
//   out[r, m, l]  = lat[r, m, :] . vocab[ids[r, l], :]
//   glat[r, m, :] = sum_l g[r, m, l] vocab[ids[r, l], :]
//
// Replaces no Pallas kernel: mmtpu leaves this term to XLA, which fuses the
// gather of the word vectors into the product (mmtpu/ops/wordprob.py).  The
// plain twin (mmtpu_torch/ops/wordprob.py::token_dots_plain) gathers blocks
// of (R, L_block, D) word vectors into device memory and reads them back with
// a batched product, forward and backward: at POM's 1357-token rows a
// width-32 chunk's training step writes and reads 3.3 GB of gathered vectors
// each way.
//
// What bounds it on an H100: the reads of the tokens' word vectors.  With one
// latent per row (M = 1, the training steps) each float read feeds one FMA,
// far below the FMA rate.  The vocabulary is small (POM: 9206 x 300 floats,
// 11 MB), so the 50 MB L2 holds it and L2's read rate is the bound; device
// memory sees the ids, the dots or their cotangent, and the latents.  With
// M = 32 latents per row (the sweep's inference fits, K configs sharing each
// row's tokens) each vector feeds 32 dots and the float32 FMA rate bounds it.
//
// What the design does about it:
// - No (R, L, D) intermediate: each token's row is read by id from the table
//   where it stays, in 16-byte units (floats where D % 4 != 0 or a pointer is
//   not 16-byte aligned), straight into float32 FMAs (no TF32).
// - Forward: a block takes one row r, up to MT of its latents (staged in
//   shared memory a depth chunk at a time) and `passes` passes of tokens.
//   The ks lanes of a token take every ks-th unit of its depth, so one load
//   instruction reads ks contiguous units of a row (8 lanes: 128 bytes).
//   Each thread keeps a register tile of TM latents x TT tokens; an xor
//   butterfly over the ks lanes adds the tile (the same sum in every lane),
//   and each lane writes its share.  M = 1: one dot per thread, a gathered
//   matrix-vector product bound by L2; M = 32: 8 latents x 4 tokens, so each
//   unit loaded from L2 feeds 8 dots and each staged latent unit 4.
// - Backward: a block takes one row r, a chunk of cw units of the depth and
//   up to MT latents.  Thread (s, q, c) adds TM latents' unit c over the
//   tokens of its slice s, in order, from the ids and cotangents that the
//   block stages in shared memory a tile of tokens at a time (the
//   cotangents token-major, so a thread reads its 8 latents' as two 16-byte
//   loads); then the ts slices are added in shared memory in slice order.
//   Every sum has one fixed order, with no atomics and no second kernel, so
//   two calls and a CUDA graph replay give the same bits.
// - The tiles follow the shape alone: MT = 1 or 32 latents per block and
//   the register tile by M; the lanes per token by M and L; token passes,
//   depth chunks and token slices by L and the block count
//   (mmtpu_torch/kernels/token_dots.py::fwd_tiles and bwd_tiles).
//
// C interface, loaded with ctypes: every entry point takes device pointers,
// strides in floats and the CUDA stream, launches asynchronously and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cassert>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
// floats of each latent's depth chunk that the forward stages: 32 latents x
// 320 floats are 40 KB of shared memory, so several blocks share an SM
constexpr int CHUNK_FLOATS = 320;
// tokens whose ids and cotangents the backward stages at a time
constexpr int TOK_TILE = 128;

// the unit of a row that one lane loads: 4 floats, or 1
template <bool V4> struct Unit;

template <> struct Unit<true> {
    using T = float4;
    static constexpr int W = 4;
    __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
    __device__ static T load(const float* __restrict__ row, int u) {
        return __ldg(reinterpret_cast<const float4*>(row) + u);
    }
    __device__ static void store(float* row, int u, T v) { reinterpret_cast<float4*>(row)[u] = v; }
    __device__ static float dot(T a, T b, float acc) {
        acc = fmaf(a.x, b.x, acc);
        acc = fmaf(a.y, b.y, acc);
        acc = fmaf(a.z, b.z, acc);
        return fmaf(a.w, b.w, acc);
    }
    __device__ static void axpy(T& acc, float s, T v) {
        acc.x = fmaf(s, v.x, acc.x);
        acc.y = fmaf(s, v.y, acc.y);
        acc.z = fmaf(s, v.z, acc.z);
        acc.w = fmaf(s, v.w, acc.w);
    }
    __device__ static void add(T& a, T b) {
        a.x += b.x;
        a.y += b.y;
        a.z += b.z;
        a.w += b.w;
    }
};

template <> struct Unit<false> {
    using T = float;
    static constexpr int W = 1;
    __device__ static T zero() { return 0.f; }
    __device__ static T load(const float* __restrict__ row, int u) { return __ldg(row + u); }
    __device__ static void store(float* row, int u, T v) { row[u] = v; }
    __device__ static float dot(T a, T b, float acc) { return fmaf(a, b, acc); }
    __device__ static void axpy(T& acc, float s, T v) { acc = fmaf(s, v, acc); }
    __device__ static void add(T& a, T b) { a += b; }
};

// The register tiles by latents per block MT: the forward's latents and
// tokens per thread, the backward's latents per thread.  MT = 1 (a training
// step): one dot or one unit each, and L2 sets the pace; MT = 32 (inference
// fits, and any M > 1, whose latents past M are masked): 8 latents x 4
// tokens, 8 latents, so each value loaded feeds several FMAs.
__host__ __device__ constexpr int fwd_tile_m(int mt) { return mt == 1 ? 1 : 8; }
__host__ __device__ constexpr int fwd_tile_tokens(int mt) { return mt == 1 ? 1 : 4; }
__host__ __device__ constexpr int bwd_tile_m(int mt) { return mt == 1 ? 1 : 8; }

// grid (R, token tiles of passes x tpp tokens, ceil(M / MT)), THREADS
// threads: thread tid = (t MG + q) ks + k is token group t < THREADS / (MG
// ks), latent group q < MG = MT / TM and lane k < ks = 1 << ks_log2.  Group
// t takes TT tokens of each pass (tpp = TT THREADS / (MG ks)), group q the
// latents i MG + q (i < TM), lane k every ks-th unit of the depth.  Latent m
// of row r starts at lat + r lat_sr + m lat_sm (D floats), its dots at out +
// r out_sr + m out_sm (L floats); ids is (R, L).
template <int MT, typename Idx, bool V4>
__global__ void __launch_bounds__(THREADS)
token_dots_fwd_kernel(const float* __restrict__ lat, long long lat_sr, long long lat_sm,
                      const float* __restrict__ vocab, const Idx* __restrict__ ids,
                      float* __restrict__ out, long long out_sr, long long out_sm, int M, int L,
                      int D, int V, int ks_log2, int passes) {
    using U = Unit<V4>;
    using T = typename U::T;
    constexpr int TM = fwd_tile_m(MT), TT = fwd_tile_tokens(MT), MG = MT / TM;
    constexpr int CW_MAX = CHUNK_FLOATS / U::W, UNROLL = TT == 1 ? 4 : 1;
    // latent m's chunk at lat_s + m ws, ws = 4 (mod 8): the lanes of two
    // latent groups in a quarter-warp read distinct banks
    __shared__ T lat_s[MT * (CW_MAX + 8)];

    const int ks = 1 << ks_log2, tpp = TT * (THREADS / (MG << ks_log2));
    const int tid = threadIdx.x, k = tid & (ks - 1);
    const int q = (tid >> ks_log2) % MG, t = (tid >> ks_log2) / MG;
    const int r = blockIdx.x, m0 = blockIdx.z * MT, mt = min(MT, M - m0);
    const int du = D / U::W;                      // units of the depth
    const int n_ch = (du + CW_MAX - 1) / CW_MAX;  // depth chunks, of near-equal width
    const int cw = (du + n_ch - 1) / n_ch;
    const float* lat_r = lat + r * lat_sr + m0 * lat_sm;
    const Idx* ids_r = ids + (size_t)r * L;

    for (int p = 0; p < passes; ++p) {
        const int pass0 = (blockIdx.y * passes + p) * tpp, l0 = pass0 + t * TT;
        if (pass0 >= L) break;  // the same in every thread
        const float* vrow[TT];  // a token past the row reads row 0, and writes nothing
#pragma unroll
        for (int j = 0; j < TT; ++j) {
            const long long id = l0 + j < L ? (long long)ids_r[l0 + j] : 0;
            assert(id >= 0 && id < V);
            vrow[j] = vocab + (size_t)id * D;
        }
        float acc[TT][TM];
#pragma unroll
        for (int j = 0; j < TT; ++j)
#pragma unroll
            for (int i = 0; i < TM; ++i) acc[j][i] = 0.f;
        for (int c0 = 0; c0 < du; c0 += cw) {
            const int w = min(cw, du - c0), ws = w + (12 - w % 8) % 8;
            if (n_ch > 1 || p == 0) {
                __syncthreads();  // the previous chunk consumed
                for (int i = tid; i < MT * w; i += THREADS) {
                    const int m = i / w, c = i - m * w;
                    lat_s[m * ws + c] = m < mt ? U::load(lat_r + m * lat_sm, c0 + c) : U::zero();
                }
                __syncthreads();
            }
#pragma unroll UNROLL
            for (int c = k; c < w; c += ks) {
                T v[TT];
#pragma unroll
                for (int j = 0; j < TT; ++j) v[j] = U::load(vrow[j], c0 + c);
#pragma unroll
                for (int i = 0; i < TM; ++i) {
                    const T a = lat_s[(i * MG + q) * ws + c];
#pragma unroll
                    for (int j = 0; j < TT; ++j) acc[j][i] = U::dot(a, v[j], acc[j][i]);
                }
            }
        }
        for (int o = 1; o < ks; o <<= 1)
#pragma unroll
            for (int j = 0; j < TT; ++j)
#pragma unroll
                for (int i = 0; i < TM; ++i) acc[j][i] += __shfl_xor_sync(FULL, acc[j][i], o);
        // lane k writes the sums e = j TM + i with e = k (mod ks)
#pragma unroll
        for (int j = 0; j < TT; ++j)
#pragma unroll
            for (int i = 0; i < TM; ++i)
                if (((j * TM + i) & (ks - 1)) == k && l0 + j < L && i * MG + q < mt)
                    out[r * out_sr + (m0 + i * MG + q) * out_sm + l0 + j] = acc[j][i];
    }
}

// grid (R, depth chunks of cw units, ceil(M / MT)), THREADS threads: thread
// tid = (s MG + q) cw + c is token slice s < ts, latent group q < MG = MT /
// TM (latents q TM + i, i < TM) and unit c of the chunk.  The cotangent of
// latent m of row r starts at g + r g_sr + m g_sm (L floats), its gradient
// at glat + r gl_sr + m gl_sm (D floats).
template <int MT, typename Idx, bool V4>
__global__ void __launch_bounds__(THREADS)
token_dots_bwd_kernel(const float* __restrict__ g, long long g_sr, long long g_sm,
                      const float* __restrict__ vocab, const Idx* __restrict__ ids,
                      float* __restrict__ glat, long long gl_sr, long long gl_sm, int M, int L,
                      int D, int V, int cw, int ts) {
    using U = Unit<V4>;
    using T = typename U::T;
    constexpr int TM = bwd_tile_m(MT), MG = MT / TM;
    // the staged cotangents, [token][latent] in rows of GS floats (16-byte
    // rows above one latent); then one slice's sums at a time (ts >= 2 leaves
    // at most THREADS / 2 threads to a slice)
    constexpr int GS = MT == 1 ? 1 : MT + 4;
    constexpr int G_FLOATS = TOK_TILE * GS, PART_FLOATS = THREADS / 2 * TM * U::W;
    __shared__ int id_s[TOK_TILE];
    __shared__ __align__(16) float buf[G_FLOATS > PART_FLOATS ? G_FLOATS : PART_FLOATS];
    float* g_s = buf;
    T* part_s = reinterpret_cast<T*>(buf);

    const int tid = threadIdx.x, c = tid % cw, q = (tid / cw) % MG, s = tid / (cw * MG);
    const int r = blockIdx.x, c0 = blockIdx.y * cw, m0 = blockIdx.z * MT;
    const int mt = min(MT, M - m0);
    const bool live = s < ts && c0 + c < D / U::W;
    const float* g_r = g + r * g_sr + m0 * g_sm;
    const Idx* ids_r = ids + (size_t)r * L;

    T acc[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) acc[i] = U::zero();
    for (int l0 = 0; l0 < L; l0 += TOK_TILE) {
        const int n = min(TOK_TILE, L - l0);
        __syncthreads();  // the previous tile consumed
        for (int i = tid; i < n; i += THREADS) {
            const long long id = ids_r[l0 + i];
            assert(id >= 0 && id < V);
            id_s[i] = (int)id;
        }
        for (int i = tid; i < MT * n; i += THREADS) {
            const int m = i / n, j = i - m * n;
            g_s[j * GS + m] = m < mt ? g_r[m * g_sm + l0 + j] : 0.f;
        }
        __syncthreads();
        if (live) {
#pragma unroll 4
            for (int j = s; j < n; j += ts) {
                const T v = U::load(vocab + (size_t)id_s[j] * D, c0 + c);
                float gv[TM];
                if constexpr (TM % 4 == 0) {
                    const float4* g4 = reinterpret_cast<const float4*>(g_s + j * GS + q * TM);
#pragma unroll
                    for (int i = 0; i < TM / 4; ++i) {
                        const float4 x = g4[i];
                        gv[4 * i] = x.x;
                        gv[4 * i + 1] = x.y;
                        gv[4 * i + 2] = x.z;
                        gv[4 * i + 3] = x.w;
                    }
                } else {
#pragma unroll
                    for (int i = 0; i < TM; ++i) gv[i] = g_s[j * GS + q * TM + i];
                }
#pragma unroll
                for (int i = 0; i < TM; ++i) U::axpy(acc[i], gv[i], v);
            }
        }
    }
    // slices 1 .. ts - 1 added to slice 0 in order, one at a time
    for (int s2 = 1; s2 < ts; ++s2) {
        __syncthreads();  // the cotangents, or the slice before, consumed
        if (live && s == s2)
#pragma unroll
            for (int i = 0; i < TM; ++i) part_s[(q * cw + c) * TM + i] = acc[i];
        __syncthreads();
        if (live && s == 0)
#pragma unroll
            for (int i = 0; i < TM; ++i) U::add(acc[i], part_s[(q * cw + c) * TM + i]);
    }
    if (live && s == 0) {
        float* gl_r = glat + r * gl_sr + m0 * gl_sm;
#pragma unroll
        for (int i = 0; i < TM; ++i)
            if (q * TM + i < mt) U::store(gl_r + (q * TM + i) * gl_sm, c0 + c, acc[i]);
    }
}

template <typename Idx, bool V4>
cudaError_t launch_fwd(int mt, dim3 grid, cudaStream_t s, const float* lat, long long lat_sr,
                       long long lat_sm, const float* vocab, const void* ids, float* out,
                       long long out_sr, long long out_sm, int M, int L, int D, int V,
                       int ks_log2, int passes) {
    const Idx* id = (const Idx*)ids;
    switch (mt) {
        case 1:
            token_dots_fwd_kernel<1, Idx, V4><<<grid, THREADS, 0, s>>>(
                lat, lat_sr, lat_sm, vocab, id, out, out_sr, out_sm, M, L, D, V, ks_log2, passes);
            break;
        case 32:
            token_dots_fwd_kernel<32, Idx, V4><<<grid, THREADS, 0, s>>>(
                lat, lat_sr, lat_sm, vocab, id, out, out_sr, out_sm, M, L, D, V, ks_log2, passes);
            break;
        default:
            return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
}

template <typename Idx, bool V4>
cudaError_t launch_bwd(int mt, dim3 grid, cudaStream_t s, const float* g, long long g_sr,
                       long long g_sm, const float* vocab, const void* ids, float* glat,
                       long long gl_sr, long long gl_sm, int M, int L, int D, int V, int cw,
                       int ts) {
    const Idx* id = (const Idx*)ids;
    switch (mt) {
        case 1:
            token_dots_bwd_kernel<1, Idx, V4><<<grid, THREADS, 0, s>>>(
                g, g_sr, g_sm, vocab, id, glat, gl_sr, gl_sm, M, L, D, V, cw, ts);
            break;
        case 32:
            token_dots_bwd_kernel<32, Idx, V4><<<grid, THREADS, 0, s>>>(
                g, g_sr, g_sm, vocab, id, glat, gl_sr, gl_sm, M, L, D, V, cw, ts);
            break;
        default:
            return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
}

bool known_tile(int mt) { return mt == 1 || mt == 32; }

}  // namespace

extern "C" {

int token_dots_threads() { return THREADS; }

// ids: (R, L) int64 (ids64) or int32, each in [0, V) (a device-side assert
// stops the kernel at one outside); out: see the kernel.
// v4: D % 4 == 0 and vocab, lat and the latent strides 16-byte aligned.
int token_dots_fwd(const void* lat, long long lat_sr, long long lat_sm, const void* vocab,
                   const void* ids, int ids64, void* out, long long out_sr, long long out_sm,
                   int R, int M, int L, int D, int V, int v4, int mt, int ks_log2, int passes,
                   void* stream) {
    if (R < 1 || M < 1 || L < 1 || D < 1 || V < 1 || mt < 1 || ks_log2 < 0 || ks_log2 > 5 ||
        passes < 1 || (v4 && D % 4 != 0))
        return (int)cudaErrorInvalidValue;
    if (!known_tile(mt) || (mt / fwd_tile_m(mt) << ks_log2) > THREADS)
        return (int)cudaErrorInvalidValue;
    const long long tokens =
        (long long)fwd_tile_tokens(mt) * (THREADS / (mt / fwd_tile_m(mt) << ks_log2)) * passes;
    const long long tiles = (L + tokens - 1) / tokens, m_tiles = (M + mt - 1) / mt;
    if (tiles > 65535 || m_tiles > 65535) return (int)cudaErrorInvalidValue;
    dim3 grid(R, (unsigned)tiles, (unsigned)m_tiles);
    cudaStream_t s = (cudaStream_t)stream;
    const float *l = (const float*)lat, *v = (const float*)vocab;
    float* o = (float*)out;
    cudaError_t err;
    if (ids64)
        err = v4 ? launch_fwd<long long, true>(mt, grid, s, l, lat_sr, lat_sm, v, ids, o, out_sr,
                                               out_sm, M, L, D, V, ks_log2, passes)
                 : launch_fwd<long long, false>(mt, grid, s, l, lat_sr, lat_sm, v, ids, o, out_sr,
                                                out_sm, M, L, D, V, ks_log2, passes);
    else
        err = v4 ? launch_fwd<int, true>(mt, grid, s, l, lat_sr, lat_sm, v, ids, o, out_sr,
                                         out_sm, M, L, D, V, ks_log2, passes)
                 : launch_fwd<int, false>(mt, grid, s, l, lat_sr, lat_sm, v, ids, o, out_sr,
                                          out_sm, M, L, D, V, ks_log2, passes);
    return (int)err;
}

// g: the (R, M, L) cotangent of out; glat: the (R, M, D) gradient; cw units
// of the depth per block (units of 4 floats where v4), ts token slices:
// ts (MT / TM) cw <= THREADS.
int token_dots_bwd(const void* g, long long g_sr, long long g_sm, const void* vocab,
                   const void* ids, int ids64, void* glat, long long gl_sr, long long gl_sm,
                   int R, int M, int L, int D, int V, int v4, int mt, int cw, int ts,
                   void* stream) {
    if (R < 1 || M < 1 || L < 1 || D < 1 || V < 1 || !known_tile(mt) || cw < 1 || ts < 1 ||
        (v4 && D % 4 != 0) ||
        (long long)ts * (mt / bwd_tile_m(mt)) * cw > THREADS)
        return (int)cudaErrorInvalidValue;
    const long long du = v4 ? D / 4 : D;
    const long long chunks = (du + cw - 1) / cw, m_tiles = (M + mt - 1) / mt;
    if (chunks > 65535 || m_tiles > 65535) return (int)cudaErrorInvalidValue;
    dim3 grid(R, (unsigned)chunks, (unsigned)m_tiles);
    cudaStream_t s = (cudaStream_t)stream;
    const float *gp = (const float*)g, *v = (const float*)vocab;
    float* o = (float*)glat;
    cudaError_t err;
    if (ids64)
        err = v4 ? launch_bwd<long long, true>(mt, grid, s, gp, g_sr, g_sm, v, ids, o, gl_sr,
                                               gl_sm, M, L, D, V, cw, ts)
                 : launch_bwd<long long, false>(mt, grid, s, gp, g_sr, g_sm, v, ids, o, gl_sr,
                                                gl_sm, M, L, D, V, cw, ts);
    else
        err = v4 ? launch_bwd<int, true>(mt, grid, s, gp, g_sr, g_sm, v, ids, o, gl_sr, gl_sm,
                                         M, L, D, V, cw, ts)
                 : launch_bwd<int, false>(mt, grid, s, gp, g_sr, g_sm, v, ids, o, gl_sr, gl_sm,
                                          M, L, D, V, cw, ts);
    return (int)err;
}

}  // extern "C"
