// Shared helpers for the hand-written Hopper kernels of nnstreamer_tpu_torch.
//
// The kernels are built with nvcc into one shared library with a plain C
// interface (see ops/_cuda.py) and bound with ctypes. Each entry point
// launches on the stream it is given and returns cudaGetLastError().
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NNSTPU_EXPORT extern "C" __attribute__((visibility("default")))

// dtype codes: keep in step with ops/_cuda.py DTYPE_CODES
enum {
  DT_F32 = 0,
  DT_BF16 = 1,
  DT_F16 = 2,
  DT_U8 = 3,
  DT_I8 = 4,
  DT_U16 = 5,
  DT_I16 = 6,
  DT_I32 = 7,
};

template <typename T>
__device__ __forceinline__ float to_f32(T v) {
  return static_cast<float>(v);  // 8- and 16-bit integers convert exactly
}
template <>
__device__ __forceinline__ float to_f32<int32_t>(int32_t v) {
  return __int2float_rn(v);
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float to_f32<__half>(__half v) {
  return __half2float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// Round a float to T and back: the value a T-typed intermediate holds.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}

// Store V consecutive values of T from an aligned register array with
// 16-byte (or, for 8-byte runs, 8-byte) vector stores. dst must be aligned
// to the run's size, which holds for a fresh allocation and an offset that
// is a multiple of V.
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* dst, const T* src) {
  constexpr int BYTES = V * static_cast<int>(sizeof(T));
  if constexpr (BYTES % 16 == 0) {
#pragma unroll
    for (int j = 0; j < BYTES / 16; ++j)
      reinterpret_cast<uint4*>(dst)[j] = reinterpret_cast<const uint4*>(src)[j];
  } else {
    static_assert(BYTES % 8 == 0, "vector run must be a multiple of 8 bytes");
#pragma unroll
    for (int j = 0; j < BYTES / 8; ++j)
      reinterpret_cast<uint2*>(dst)[j] = reinterpret_cast<const uint2*>(src)[j];
  }
}
