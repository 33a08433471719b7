// arith_chain: typecast to float32 → add/mul/div chain in float32 →
// optional clamp → out dtype, in one read and one write.
//
// Replaces the Pallas kernel nnstreamer_tpu/ops/transform_ops.py::arith_chain
// (inner `kernel`). The Pallas version widens narrow ints through int32,
// tiles (rows, 128) blocks and takes plain jnp when the size is not a
// multiple of 1024; this kernel takes every size: each thread converts one
// 16-byte run of the input (16 uint8, 8 int16, 4 int32 or float32 values)
// with one vector load, and the last partial run element by element.
//
// Bound on the H100: bytes. Each element costs one to a few float
// operations against 2 to 8 bytes moved. The op list (at most 16 ops) is
// passed by value in a small struct, so it lives in the kernel's parameter
// space and no thread reads it from device memory.
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

struct ArithChain {
  int n_ops;
  int op[kMaxOps];
  float val[kMaxOps];
  int has_clamp;
  float lo;
  float hi;
};

__device__ __forceinline__ float apply_chain(float v, const ArithChain& c) {
  for (int i = 0; i < c.n_ops; ++i) {
    const float a = c.val[i];
    switch (c.op[i]) {
      case OP_ADD: v = __fadd_rn(v, a); break;
      case OP_MUL: v = __fmul_rn(v, a); break;
      default: v = __fdiv_rn(v, a); break;
    }
  }
  if (c.has_clamp) {
    // min(max(v, lo), hi) that keeps NaN, as jnp.clip and np.clip do
    v = v < c.lo ? c.lo : (v > c.hi ? c.hi : v);
  }
  return v;
}

template <typename TI, typename TO>
__global__ void __launch_bounds__(kThreads)
arith_chain_kernel(const TI* __restrict__ x, TO* __restrict__ y, long long n,
                   ArithChain c, int vec_ok) {
  constexpr int V = 16 / static_cast<int>(sizeof(TI));
  const long long base =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * V;
  if (base >= n) return;
  if (vec_ok && base + V <= n) {
    const uint4 raw = *reinterpret_cast<const uint4*>(x + base);
    const TI* xs = reinterpret_cast<const TI*>(&raw);
    __align__(16) TO out[V];
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = from_f32<TO>(apply_chain(to_f32<TI>(xs[i]), c));
    store_vec<TO, V>(y + base, out);
    return;
  }
  const long long end = base + V < n ? base + V : n;
  for (long long i = base; i < end; ++i)
    y[i] = from_f32<TO>(apply_chain(to_f32<TI>(x[i]), c));
}

template <typename TI, typename TO>
int launch(const void* x, void* y, long long n, const ArithChain& c,
           int vec_ok, cudaStream_t s) {
  constexpr int V = 16 / static_cast<int>(sizeof(TI));
  const long long threads = (n + V - 1) / V;
  const unsigned int blocks =
      static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
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
