// Shared helpers for the port's CUDA kernels: float32 / bfloat16 loads
// and stores, rounding through the storage type, block-wide sum and max,
// the tensor-core fragments of mma.sync, the quantized KV codes, and the
// dtype dispatch every C entry point uses (codes match kernels/_build.py
// DTYPE_CODES: 0 float32, 1 bfloat16; KV codes match kernels/kv_quant.py
// KV_DTYPE_CODES).
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp8.h>
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

// max of v over a block of THREADS threads; every thread gets it
template <int THREADS>
__device__ __forceinline__ float block_max(float v) {
  __shared__ float partial[THREADS / 32];
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (threadIdx.x % 32 == 0) partial[threadIdx.x / 32] = v;
  __syncthreads();
  float m = partial[0];
#pragma unroll
  for (int i = 1; i < THREADS / 32; ++i) m = fmaxf(m, partial[i]);
  return m;
}

// ---- tensor-core helpers (mma.sync m16n8k16, bf16 in, f32 accumulate)
// Fragment layouts: lane = 4 g + tg holds rows g and g + 8 of A and C;
// A pairs of k at 2 tg (and + 8), B pairs of k at 2 tg for column g, C
// columns 2 tg and 2 tg + 1.
using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two 8x8 b16 matrices, transposed: lanes 0-7 address the rows of the
// first, lanes 8-15 of the second; lane t gets rows 2 (t % 4) and
// 2 (t % 4) + 1 of column t / 4 of each (the B fragment of a [k, n]
// tile stored row-major)
__device__ __forceinline__ void ldsm_x2_trans(uint32_t* r, const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint4 zero4() { return make_uint4(0, 0, 0, 0); }

// ---- quantized KV pools (kernels/kv_quant.py): Q = 0 the pool holds
// the model's T, Q = 1 int8 codes, Q = 2 float8_e4m3fn bit patterns in
// an int8 container; one f32 scale per (block, token) row.  Both code
// sets are exact in f32 (and in bf16).
template <int Q>
__device__ __forceinline__ float decode_code(int8_t c) {
  static_assert(Q == 1 || Q == 2, "a quantized scheme");
  if constexpr (Q == 1) {
    return static_cast<float>(c);
  } else {
    const __half_raw h = __nv_cvt_fp8_to_halfraw(
        static_cast<__nv_fp8_storage_t>(static_cast<uint8_t>(c)), __NV_E4M3);
    return __half2float(__half(h));
  }
}

// the code of y = x / scale: int8 rounds half to even and clips to
// +-127; fp8 clips to +-448 first, then rounds to nearest even e4m3
// (no infinities: 0x7F / 0xFF are NaN, which the clip never produces)
template <int Q>
__device__ __forceinline__ int8_t encode_code(float y) {
  static_assert(Q == 1 || Q == 2, "a quantized scheme");
  if constexpr (Q == 1) {
    return static_cast<int8_t>(
        static_cast<int>(fminf(fmaxf(rintf(y), -127.f), 127.f)));
  } else {
    const __nv_fp8_storage_t c = __nv_cvt_float_to_fp8(
        fminf(fmaxf(y, -448.f), 448.f), __NV_SATFINITE, __NV_E4M3);
    return static_cast<int8_t>(c);
  }
}

// one K or V element of a pool in f32: the stored value (Q == 0), or the
// code times its row's scale, the reference's dequantization
template <typename T, int Q>
__device__ __forceinline__ float load_kv(const void* pool,
                                         const float* scale, size_t off,
                                         size_t row) {
  if constexpr (Q == 0) {
    return to_f32(static_cast<const T*>(pool)[off]);
  } else {
    return decode_code<Q>(static_cast<const int8_t*>(pool)[off]) * scale[row];
  }
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

#define DISPATCH_KV(code, Q, ...)             \
  if ((code) == 0) {                          \
    constexpr int Q = 0;                      \
    __VA_ARGS__;                              \
  } else if ((code) == 1) {                   \
    constexpr int Q = 1;                      \
    __VA_ARGS__;                              \
  } else if ((code) == 2) {                   \
    constexpr int Q = 2;                      \
    __VA_ARGS__;                              \
  } else {                                    \
    return (int)cudaErrorInvalidValue;        \
  }

constexpr float NEG_INF = -1e30f;  // finite, as in the reference kernels
