// Shared helpers for the port's CUDA kernels: float32 / bfloat16 loads
// and stores, rounding through the storage type, a block-wide sum, and
// the dtype dispatch every C entry point uses (codes match
// kernels/_build.py DTYPE_CODES: 0 float32, 1 bfloat16).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// the float a cast to T and back gives: the cast points of the plain
// PyTorch version (x.to(dtype)), kept exactly
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// sum of v over a block of THREADS threads; every thread gets the total
template <int THREADS>
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float partial[THREADS / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (threadIdx.x % 32 == 0) partial[threadIdx.x / 32] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < THREADS / 32; ++i) total += partial[i];
  return total;
}

#define DISPATCH_DTYPE(code, T, ...)          \
  if ((code) == 0) {                          \
    using T = float;                          \
    __VA_ARGS__;                              \
  } else if ((code) == 1) {                   \
    using T = __nv_bfloat16;                  \
    __VA_ARGS__;                              \
  } else {                                    \
    return (int)cudaErrorInvalidValue;        \
  }

constexpr float NEG_INF = -1e30f;  // finite, as in the reference kernels
