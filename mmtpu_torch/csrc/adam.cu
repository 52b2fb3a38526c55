// Adam over every leaf of a parameter tree in one launch, for Hopper, sm_90a:
//
//   m2 = b1 m + (1 - b1) g
//   v2 = b2 v + (1 - b2) g^2
//   p2 = p - lr_k (m2 / bc1_k) / (sqrt(v2 / bc2_k) + eps)
//
// and p, m and v each take the new value where active_k && gate_k > 0, and
// keep the old one elsewhere.  k is the element's config: the sweep's leading
// (K,) axis of every leaf (none for one config).
//
// Replaces no Pallas kernel: mmtpu leaves its optimizer to XLA, which fuses
// each leaf's update into one loop (mmtpu/train/optim.py).  The plain twin
// (mmtpu_torch/train/optim.py::adam_plain, opt_update's law) runs it as about
// 18 elementwise kernels a leaf, each a pass over device memory: at MOSI's
// width-32 grid step (the decoder's 26 leaves, 26.7 M floats) about 164 bytes
// a float, 4.4 GB a step.
//
// What bounds it on an H100: device memory.  Each float is read four times
// (p, g, m, v) and written three times (p, m, v), 28 bytes for about a dozen
// operations, far under the line: at MOSI's decoder tree 0.75 GB, 0.22 ms at
// 3.35 TB/s.
//
// What the design does about it:
// - One pass: each operand read once and each result written once, with the
//   arithmetic in registers between; one launch for all leaves of a tree, in
//   the manner of a multi-tensor apply.  The leaves' pointers, sizes and
//   config strides travel in the by-value argument struct (under the 4 KB
//   parameter limit; mmtpu_torch/kernels/adam.py splits a larger tree), with
//   each leaf's first block, so that a block finds its leaf by a scan of at
//   most MAX_LEAVES block starts, fixed at launch and so under capture.
// - 16-byte float4 loads and stores where a leaf's per-config size and
//   config strides are multiples of 4 and its pointers 16-byte aligned (every
//   (K, 300, F) weight); single floats elsewhere.  Each thread issues all its
//   loads (UNROLL units of each operand) before its arithmetic.
// - Inputs may be strided between configs (lazy Adam's block of a permuted
//   table: each config's rows contiguous, the configs a table apart); the
//   outputs are new contiguous tensors from the wrapper's torch.empty, as the
//   twin's are, and inactive configs copy the old values through.
// - Per-config values (lr, the bias corrections, active, each leaf's gate)
//   are read on the device from vectors at k * stride, or passed by value:
//   nothing is read on the host, so a captured epoch may call it.
// - The arithmetic is the twin's, operation by operation, each rounded once
//   (__fmul_rn and its kin: nothing contracted into an FMA), with the float32
//   constants that PyTorch gives the twin's Python scalars, so that the kernel
//   equals the twin run on the card bit for bit.
//
// C interface, loaded with ctypes: adam_apply takes the argument struct by
// pointer, the block count and the CUDA stream, launches asynchronously and
// returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;
constexpr int TILE = THREADS * UNROLL;  // units (float4s or floats) a block
constexpr int MAX_LEAVES = 32;

// the twin's Python scalars as PyTorch passes them to a float32 kernel
constexpr float B1 = (float)0.9;
constexpr float OMB1 = (float)(1.0 - 0.9);
constexpr float B2 = (float)0.999;
constexpr float OMB2 = (float)(1.0 - 0.999);
constexpr float EPS = (float)1e-8;

// a per-config value: a float32 or bool device vector read at k * stride (a
// stride of 0: one value for every config), or `value` where ptr is null
struct Scalar {
    const void* ptr;
    float value;
    int stride;
    int is_bool;
};

struct Leaf {
    const float* src[4];  // p, g, m, v
    float* dst[3];        // p, m, v: contiguous
    int n;                // elements
    int inner;            // elements a config (n without a config axis)
    int cs[4];            // the config strides of src, in elements
    Scalar gate;
    int vec;              // float4 units
    int first_block;
};

struct Args {
    Scalar lr, bc1, bc2, active;
    Leaf leaf[MAX_LEAVES];
    int n_leaves;
};

static_assert(sizeof(Args) <= 4096, "the argument struct exceeds the 4 KB parameter limit");

__device__ __forceinline__ float scalar_at(const Scalar& s, int k) {
    if (s.ptr == nullptr) return s.value;
    const long long i = (long long)k * s.stride;
    if (s.is_bool) return static_cast<const unsigned char*>(s.ptr)[i] ? 1.f : 0.f;
    return static_cast<const float*>(s.ptr)[i];
}

struct Step {
    float lr, bc1, bc2;
    bool on;
};

__device__ __forceinline__ Step step_of(const Args& a, const Leaf& leaf, int k) {
    Step s;
    s.lr = scalar_at(a.lr, k);
    s.bc1 = scalar_at(a.bc1, k);
    s.bc2 = scalar_at(a.bc2, k);
    s.on = scalar_at(a.active, k) != 0.f && scalar_at(leaf.gate, k) > 0.f;
    return s;
}

// one element, in the twin's order of operations
__device__ __forceinline__ void adam(float p, float g, float m, float v, const Step& s,
                                     float& po, float& mo, float& vo) {
    const float m2 = __fadd_rn(__fmul_rn(B1, m), __fmul_rn(OMB1, g));
    const float v2 = __fadd_rn(__fmul_rn(B2, v), __fmul_rn(OMB2, __fmul_rn(g, g)));
    const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v2, s.bc2)), EPS);
    const float p2 = __fsub_rn(p, __fdiv_rn(__fmul_rn(s.lr, __fdiv_rn(m2, s.bc1)), den));
    po = s.on ? p2 : p;
    mo = s.on ? m2 : m;
    vo = s.on ? v2 : v;
}

// unit u of the leaf: where it lies in each input, and its config
struct Place {
    int k;
    int r;  // element offset within the config
};

__device__ __forceinline__ Place place_of(const Leaf& leaf, int e) {
    const int k = (int)((unsigned)e / (unsigned)leaf.inner);
    return {k, e - k * leaf.inner};
}

__device__ __forceinline__ const float* at(const Leaf& leaf, int j, Place pl) {
    return leaf.src[j] + (long long)pl.k * leaf.cs[j] + pl.r;
}

__device__ void vec_tile(const Args& a, const Leaf& leaf, int tile) {
    const int units = leaf.n >> 2;
    const int first = tile * TILE + (int)threadIdx.x;
    float4 x[4][UNROLL];
    int k[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
        const int q = first + u * THREADS;
        if (q < units) {
            const Place pl = place_of(leaf, q << 2);
            k[u] = pl.k;
#pragma unroll
            for (int j = 0; j < 4; ++j)
                x[j][u] = *reinterpret_cast<const float4*>(at(leaf, j, pl));
        }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
        const int q = first + u * THREADS;
        if (q < units) {
            const Step s = step_of(a, leaf, k[u]);
            float4 po, mo, vo;
            adam(x[0][u].x, x[1][u].x, x[2][u].x, x[3][u].x, s, po.x, mo.x, vo.x);
            adam(x[0][u].y, x[1][u].y, x[2][u].y, x[3][u].y, s, po.y, mo.y, vo.y);
            adam(x[0][u].z, x[1][u].z, x[2][u].z, x[3][u].z, s, po.z, mo.z, vo.z);
            adam(x[0][u].w, x[1][u].w, x[2][u].w, x[3][u].w, s, po.w, mo.w, vo.w);
            reinterpret_cast<float4*>(leaf.dst[0])[q] = po;
            reinterpret_cast<float4*>(leaf.dst[1])[q] = mo;
            reinterpret_cast<float4*>(leaf.dst[2])[q] = vo;
        }
    }
}

__device__ void scalar_tile(const Args& a, const Leaf& leaf, int tile) {
    const int first = tile * TILE + (int)threadIdx.x;
    float x[4][UNROLL];
    int k[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
        const int e = first + u * THREADS;
        if (e < leaf.n) {
            const Place pl = place_of(leaf, e);
            k[u] = pl.k;
#pragma unroll
            for (int j = 0; j < 4; ++j) x[j][u] = *at(leaf, j, pl);
        }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
        const int e = first + u * THREADS;
        if (e < leaf.n) {
            adam(x[0][u], x[1][u], x[2][u], x[3][u], step_of(a, leaf, k[u]), leaf.dst[0][e],
                 leaf.dst[1][e], leaf.dst[2][e]);
        }
    }
}

__global__ void __launch_bounds__(THREADS) adam_kernel(const __grid_constant__ Args a) {
    int i = 0;
    while (i + 1 < a.n_leaves && (int)blockIdx.x >= a.leaf[i + 1].first_block) ++i;
    const Leaf& leaf = a.leaf[i];
    const int tile = (int)blockIdx.x - leaf.first_block;
    if (leaf.vec)
        vec_tile(a, leaf, tile);
    else
        scalar_tile(a, leaf, tile);
}

}  // namespace

extern "C" {

int adam_args_size() { return (int)sizeof(Args); }
int adam_max_leaves() { return MAX_LEAVES; }
int adam_tile() { return TILE; }

// `packed` points to an Args: a type of this file's unnamed namespace in the
// signature would keep the symbol out of the library's exports
int adam_apply(const void* packed, int blocks, void* stream) {
    const Args& args = *static_cast<const Args*>(packed);
    if (args.n_leaves < 1 || args.n_leaves > MAX_LEAVES || blocks < 1)
        return (int)cudaErrorInvalidValue;
    adam_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(args);
    return (int)cudaGetLastError();
}

}  // extern "C"
