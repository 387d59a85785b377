// RMSNorm over the last axis: out = (x * rsqrt(mean(x^2) + eps)).to(T) * w.
//
// Replaces paddle_tpu/kernels/rms_norm.py _kernel (pallas_call in
// _rms_fwd_impl).  Cast points follow models/llama.py LlamaRMSNorm (the
// normalized row is rounded to T before the weight multiply), which is
// also the contract fused_norm_linear keeps; the TPU kernel multiplies
// by w in f32 and rounds once, up to one bf16 ulp away.
//
// Bound on the H100: bytes.  Each row is read once and written once;
// one block per row reduces the sum of squares in f32 with warp
// shuffles, then normalizes from the (L1/L2-resident) row.
#include "common.cuh"

constexpr int RN_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(RN_THREADS)
    rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ out, int d, float eps) {
  const T* xr = x + (size_t)blockIdx.x * d;
  T* orow = out + (size_t)blockIdx.x * d;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += RN_THREADS) {
    const float v = to_f32(xr[i]);
    ss = fmaf(v, v, ss);
  }
  const float r = rsqrtf(block_sum<RN_THREADS>(ss) / d + eps);
  for (int i = threadIdx.x; i < d; i += RN_THREADS) {
    const float n = round_to<T>(to_f32(xr[i]) * r);
    orow[i] = from_f32<T>(n * to_f32(w[i]));
  }
}

extern "C" int rms_norm(const void* x, const void* w, void* out, int rows,
                        int d, float eps, int dtype, void* stream) {
  if (rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  DISPATCH_DTYPE(dtype, T,
                 rms_norm_kernel<T><<<rows, RN_THREADS, 0, s>>>(
                     (const T*)x, (const T*)w, (T*)out, d, eps));
  return (int)cudaGetLastError();
}
