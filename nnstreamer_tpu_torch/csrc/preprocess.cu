// normalize_u8: y = float(x) * scale + offset, uint8 in, float32 or
// bfloat16 out.
//
// Replaces the Pallas kernel nnstreamer_tpu/ops/preprocess.py::normalize_u8
// (body from _kernel_factory). The Pallas version tiles (rows, 128) blocks
// and takes plain jnp when the size is not a multiple of 1024; this kernel
// takes every size: each thread converts 16 bytes with one 16-byte load and
// vector stores, and the last partial run is done element by element.
//
// Bound on the H100: bytes. One read of n bytes and one write of n*2 (bf16)
// or n*4 (f32) bytes against two float operations per element, far below
// the card's operations-per-byte balance. The design keeps every load and
// store 16 bytes wide and reads the input exactly once.
//
// Rounding: x*scale and (+offset) are two IEEE roundings (__fmul_rn,
// __fadd_rn), never contracted into one FMA, so a float32 output equals
// the plain PyTorch expression x.float() * scale + offset bit for bit.
// --use_fast_math is not used.
#include "common.cuh"

namespace {

constexpr int kVec = 16;
constexpr int kThreads = 256;

template <typename TO>
__global__ void __launch_bounds__(kThreads)
normalize_u8_kernel(const uint8_t* __restrict__ x, TO* __restrict__ y,
                    long long n, float scale, float offset, int vec_ok) {
  const long long base =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * kVec;
  if (base >= n) return;
  if (vec_ok && base + kVec <= n) {
    const uint4 raw = *reinterpret_cast<const uint4*>(x + base);
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
    __align__(16) TO out[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      out[i] = from_f32<TO>(
          __fadd_rn(__fmul_rn(static_cast<float>(b[i]), scale), offset));
    store_vec<TO, kVec>(y + base, out);
    return;
  }
  const long long end = base + kVec < n ? base + kVec : n;
  for (long long i = base; i < end; ++i)
    y[i] = from_f32<TO>(
        __fadd_rn(__fmul_rn(static_cast<float>(x[i]), scale), offset));
}

}  // namespace

NNSTPU_EXPORT int nnstpu_normalize_u8(const void* x, void* y, long long n,
                                      float scale, float offset,
                                      int out_dtype, int vec_ok,
                                      void* stream) {
  if (n <= 0) return 0;
  const long long threads = (n + kVec - 1) / kVec;
  const unsigned int blocks =
      static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* xp = static_cast<const uint8_t*>(x);
  switch (out_dtype) {
    case DT_F32:
      normalize_u8_kernel<float><<<blocks, kThreads, 0, s>>>(
          xp, static_cast<float*>(y), n, scale, offset, vec_ok);
      break;
    case DT_BF16:
      normalize_u8_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
          xp, static_cast<__nv_bfloat16*>(y), n, scale, offset, vec_ok);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
