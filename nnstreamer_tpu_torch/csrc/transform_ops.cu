// arith_chain: typecast to float32 → add/mul/div chain in float32 →
// optional clamp → out dtype, in one read and one write.
//
// Replaces the Pallas kernel nnstreamer_tpu/ops/transform_ops.py::arith_chain
// (:75, inner `kernel`). The Pallas version widens narrow ints through
// int32, tiles (rows, 128) blocks and takes plain jnp when the size is not a
// multiple of 1024; this kernel takes every size.
//
// Bound on the H100: bytes. Each element moves 2 to 8 bytes (uint8 in,
// float32 out: 5) against one to a few float operations, far below the
// card's operations-per-byte balance. The first version (one 16-byte input
// run per thread, the op loop with a switch for every element) reached 40%
// of that bound. Its instruction count was not what held it back: on the
// card, its layout with a table in place of the arithmetic, or with a grid
// of resident CTAs striding over the tensor, stayed far from the bound,
// while the same arithmetic with coalesced stores came within 20% of it.
// With 16 uint8 values per thread, each thread wrote 64 contiguous bytes
// of float32, so one warp-wide 16-byte store touched 16 cache lines; the
// stores are 80% of the bytes. So the layout follows the output:
//   - a group is what one 16-byte store writes (4 float32 or 8 bf16/f16
//     values); thread t of a CTA takes groups t, t + 256, t + 512 and
//     t + 768 of the CTA's tile, so every warp-wide load and store covers
//     contiguous bytes (512 per store), and issues the loads of all four
//     before it converts any;
//   - 8-bit inputs (uint8, int8) take a 256-entry table: each CTA first
//     evaluates the chain on the 256 possible inputs into shared memory
//     (1 KB for float32 out) with the same per-op roundings, so each entry
//     is bit-equal to the chain; an element is then one lookup;
//   - wider inputs (uint16, int16, int32, float32) run the ops outside and
//     the values inside: one uniform branch per op, then the thread's 16
//     or 32 register values in straight-line code;
//   - one CTA per tile over the whole tensor: a grid of resident CTAs that
//     strides over it measured slower. A group that is ragged, or every
//     group when a base is not 16-byte aligned (vec_ok = 0), goes element
//     by element.
//
// Rounding: every op is one IEEE rounding in float32 (__fadd_rn,
// __fmul_rn, __fdiv_rn — never contracted into an FMA, division never
// approximated), which is what numpy and the JAX op do per op. This keeps
// tensor_transform acceleration=device bit-equal to its numpy path.
// --use_fast_math is not used.
#include "common.cuh"

namespace {

constexpr int kMaxOps = 16;
constexpr int kThreads = 256;

enum { OP_ADD = 0, OP_MUL = 1, OP_DIV = 2 };

// The op list, passed by value: it lives in the kernel's parameter space
// and no thread reads it from device memory.
struct ArithChain {
  int n_ops;
  int op[kMaxOps];
  float val[kMaxOps];
  int has_clamp;
  float lo;
  float hi;
};

__device__ __forceinline__ float clamp_keep_nan(float v, const ArithChain& c) {
  // min(max(v, lo), hi) that keeps NaN, as jnp.clip and np.clip do
  return v < c.lo ? c.lo : (v > c.hi ? c.hi : v);
}

// The chain on V values: for each op one uniform branch, then the values.
template <int V>
__device__ __forceinline__ void apply_chain(float (&v)[V],
                                            const ArithChain& c) {
  for (int i = 0; i < c.n_ops; ++i) {
    const float a = c.val[i];
    switch (c.op[i]) {
      case OP_ADD:
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] = __fadd_rn(v[j], a);
        break;
      case OP_MUL:
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] = __fmul_rn(v[j], a);
        break;
      default:
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] = __fdiv_rn(v[j], a);
        break;
    }
  }
  if (c.has_clamp) {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = clamp_keep_nan(v[j], c);
  }
}

template <typename TI, typename TO>
__device__ __forceinline__ TO chain_one(TI x, const ArithChain& c) {
  float v[1] = {to_f32<TI>(x)};
  apply_chain(v, c);
  return from_f32<TO>(v[0]);
}

constexpr int kGroups = 4;  // groups per thread, all loaded before any use

template <typename TI, typename TO>
struct Layout {
  static constexpr int G = 16 / static_cast<int>(sizeof(TO));  // per store
  static constexpr int kInBytes = G * static_cast<int>(sizeof(TI));
  static constexpr int kTile = kThreads * kGroups * G;  // elements per CTA
};

// One group's input, kInBytes (4, 8, 16 or 32) from an aligned address.
template <int BYTES>
__device__ __forceinline__ void load_group(void* dst, const void* src) {
  if constexpr (BYTES == 4) {
    *static_cast<unsigned int*>(dst) =
        __ldcs(static_cast<const unsigned int*>(src));
  } else if constexpr (BYTES == 8) {
    *static_cast<uint2*>(dst) = __ldcs(static_cast<const uint2*>(src));
  } else {
#pragma unroll
    for (int j = 0; j < BYTES / 16; ++j)
      static_cast<uint4*>(dst)[j] = __ldcs(static_cast<const uint4*>(src) + j);
  }
}

// The CTA's tile: load every whole group of the thread, convert them with
// `groups` (in[k] to out[k], kGroups arrays of G values), store them with
// one 16-byte store each; a ragged or unaligned group element by element
// with `one`.
template <typename TI, typename TO, typename Groups, typename One>
__device__ __forceinline__ void tile(const TI* __restrict__ x,
                                     TO* __restrict__ y, long long n,
                                     int vec_ok, const Groups& groups,
                                     const One& one) {
  using L = Layout<TI, TO>;
  constexpr int G = L::G;
  const long long base = static_cast<long long>(blockIdx.x) * L::kTile;
  long long e0[kGroups];
  bool whole[kGroups];
  __align__(16) TI in[kGroups][G];
#pragma unroll
  for (int k = 0; k < kGroups; ++k) {
    e0[k] = base + static_cast<long long>(k * kThreads + threadIdx.x) * G;
    whole[k] = vec_ok && e0[k] + G <= n;
    if (whole[k]) load_group<L::kInBytes>(in[k], x + e0[k]);
  }
  __align__(16) TO out[kGroups][G];
  groups(in, out);
#pragma unroll
  for (int k = 0; k < kGroups; ++k) {
    if (whole[k]) {
      store_vec<TO, G>(y + e0[k], out[k]);
    } else {
      const long long end = e0[k] + G < n ? e0[k] + G : n;
      for (long long i = e0[k]; i < end; ++i) y[i] = one(x[i]);
    }
  }
}

template <typename TI, typename TO>
__global__ void __launch_bounds__(kThreads)
arith_chain_kernel(const TI* __restrict__ x, TO* __restrict__ y, long long n,
                   ArithChain c, int vec_ok) {
  constexpr int G = Layout<TI, TO>::G;
  tile(x, y, n, vec_ok,
       [&](const TI (&in)[kGroups][G], TO (&out)[kGroups][G]) {
         float v[kGroups * G];
#pragma unroll
         for (int k = 0; k < kGroups; ++k)
#pragma unroll
           for (int i = 0; i < G; ++i) v[k * G + i] = to_f32<TI>(in[k][i]);
         apply_chain(v, c);
#pragma unroll
         for (int k = 0; k < kGroups; ++k)
#pragma unroll
           for (int i = 0; i < G; ++i) out[k][i] = from_f32<TO>(v[k * G + i]);
       },
       [&](TI v) { return chain_one<TI, TO>(v, c); });
}

template <typename TI, typename TO>
__global__ void __launch_bounds__(kThreads)
arith_chain_table_kernel(const TI* __restrict__ x, TO* __restrict__ y,
                         long long n, ArithChain c, int vec_ok) {
  static_assert(sizeof(TI) == 1, "a table covers 8-bit inputs");
  constexpr int G = Layout<TI, TO>::G;
  __shared__ __align__(16) unsigned char table_bytes[256 * sizeof(TO)];
  TO* table = reinterpret_cast<TO*>(table_bytes);
  for (int b = static_cast<int>(threadIdx.x); b < 256; b += kThreads)
    table[b] = chain_one<TI, TO>(static_cast<TI>(static_cast<uint8_t>(b)), c);
  __syncthreads();
  tile(x, y, n, vec_ok,
       [&](const TI (&in)[kGroups][G], TO (&out)[kGroups][G]) {
#pragma unroll
         for (int k = 0; k < kGroups; ++k)
#pragma unroll
           for (int i = 0; i < G; ++i)
             out[k][i] = table[static_cast<uint8_t>(in[k][i])];
       },
       [&](TI v) { return table[static_cast<uint8_t>(v)]; });
}

template <typename TI, typename TO>
int launch(const void* x, void* y, long long n, const ArithChain& c,
           int vec_ok, cudaStream_t s) {
  constexpr int kTile = Layout<TI, TO>::kTile;
  const long long tiles = (n + kTile - 1) / kTile;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int blocks = static_cast<unsigned int>(tiles);
  if constexpr (sizeof(TI) == 1)
    arith_chain_table_kernel<TI, TO><<<blocks, kThreads, 0, s>>>(
        static_cast<const TI*>(x), static_cast<TO*>(y), n, c, vec_ok);
  else
    arith_chain_kernel<TI, TO><<<blocks, kThreads, 0, s>>>(
        static_cast<const TI*>(x), static_cast<TO*>(y), n, c, vec_ok);
  return static_cast<int>(cudaGetLastError());
}

template <typename TI>
int launch_out(const void* x, void* y, long long n, const ArithChain& c,
               int out_dtype, int vec_ok, cudaStream_t s) {
  switch (out_dtype) {
    case DT_F32: return launch<TI, float>(x, y, n, c, vec_ok, s);
    case DT_BF16: return launch<TI, __nv_bfloat16>(x, y, n, c, vec_ok, s);
    case DT_F16: return launch<TI, __half>(x, y, n, c, vec_ok, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// ops/vals: host arrays of n_ops opcodes (0 add, 1 mul, 2 div) and values.
NNSTPU_EXPORT int nnstpu_arith_chain(const void* x, void* y, long long n,
                                     int in_dtype, int out_dtype,
                                     const void* ops, const void* vals,
                                     int n_ops, int has_clamp, float lo,
                                     float hi, int vec_ok, void* stream) {
  if (n_ops < 0 || n_ops > kMaxOps) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  ArithChain c{};
  c.n_ops = n_ops;
  for (int i = 0; i < n_ops; ++i) {
    c.op[i] = static_cast<const int*>(ops)[i];
    c.val[i] = static_cast<const float*>(vals)[i];
  }
  c.has_clamp = has_clamp;
  c.lo = lo;
  c.hi = hi;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_dtype) {
    case DT_U8: return launch_out<uint8_t>(x, y, n, c, out_dtype, vec_ok, s);
    case DT_I8: return launch_out<int8_t>(x, y, n, c, out_dtype, vec_ok, s);
    case DT_U16: return launch_out<uint16_t>(x, y, n, c, out_dtype, vec_ok, s);
    case DT_I16: return launch_out<int16_t>(x, y, n, c, out_dtype, vec_ok, s);
    case DT_I32: return launch_out<int32_t>(x, y, n, c, out_dtype, vec_ok, s);
    case DT_F32: return launch_out<float>(x, y, n, c, out_dtype, vec_ok, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
