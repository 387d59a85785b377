// Rotate-half RoPE of x [B, T, H, D] with tables cos/sin [T, D/2] (the
// caller has sliced them at the position offset):
//   out[..., :D/2] = x1 * c - x2 * s,  out[..., D/2:] = x2 * c + x1 * s
// in f32, rounded once to T.  sign = -1 rotates by the negated angle,
// which is the backward (the rotation is orthogonal).
//
// Replaces paddle_tpu/kernels/rope.py _rope_kernel (pallas_call in
// _rope_fwd; the custom_vjp backward runs it with -sin).  Cast points
// follow _rope_kernel: x, cos and sin raised to f32, one rounding.
//
// Bound on the H100: bytes (one read and one write of x, 6 flops an
// element pair).  One block per token row: the row's D/2 cos/sin values
// are read once and reused by every head; each thread moves VEC
// neighbouring elements of the first half and the matching VEC of the
// second half with 16-byte loads and stores where D/2 allows.
#include <cstdint>

#include "common.cuh"

constexpr int ROPE_THREADS = 128;

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(ROPE_THREADS)
    rope_kernel(const T* __restrict__ x, const T* __restrict__ cos_t,
                const T* __restrict__ sin_t, T* __restrict__ out, int T_len,
                int H, int D, float sign) {
  const int row = blockIdx.x;        // b * T + t
  const int t = row % T_len;
  const int half = D / 2, units_per_head = half / VEC;
  const T* xr = x + (size_t)row * H * D;
  T* orow = out + (size_t)row * H * D;
  const T* cr = cos_t + (size_t)t * half;
  const T* sr = sin_t + (size_t)t * half;
  for (int u = threadIdx.x; u < H * units_per_head; u += ROPE_THREADS) {
    const int h = u / units_per_head, d0 = (u % units_per_head) * VEC;
    const Vec<T, VEC> a = *reinterpret_cast<const Vec<T, VEC>*>(xr + h * D + d0);
    const Vec<T, VEC> b =
        *reinterpret_cast<const Vec<T, VEC>*>(xr + h * D + half + d0);
    const Vec<T, VEC> c = *reinterpret_cast<const Vec<T, VEC>*>(cr + d0);
    const Vec<T, VEC> s = *reinterpret_cast<const Vec<T, VEC>*>(sr + d0);
    Vec<T, VEC> lo, hi;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float x1 = to_f32(a.v[i]), x2 = to_f32(b.v[i]);
      const float cf = to_f32(c.v[i]), sf = sign * to_f32(s.v[i]);
      lo.v[i] = from_f32<T>(x1 * cf - x2 * sf);
      hi.v[i] = from_f32<T>(x2 * cf + x1 * sf);
    }
    *reinterpret_cast<Vec<T, VEC>*>(orow + h * D + d0) = lo;
    *reinterpret_cast<Vec<T, VEC>*>(orow + h * D + half + d0) = hi;
  }
}

// 16-byte vectors when D/2 is a multiple of their width and every base
// pointer is 16-byte aligned, else scalars
template <typename T>
int launch_rope(const T* x, const T* c, const T* s, T* out, int rows,
                int T_len, int H, int D, float sign, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const uintptr_t bases = (uintptr_t)x | (uintptr_t)c | (uintptr_t)s |
                          (uintptr_t)out;
  if ((D / 2) % VEC == 0 && bases % 16 == 0)
    rope_kernel<T, VEC><<<rows, ROPE_THREADS, 0, st>>>(x, c, s, out, T_len, H,
                                                        D, sign);
  else
    rope_kernel<T, 1><<<rows, ROPE_THREADS, 0, st>>>(x, c, s, out, T_len, H,
                                                      D, sign);
  return 0;
}

extern "C" int rope(const void* x, const void* cos_t, const void* sin_t,
                    void* out, int B, int T_len, int H, int D, float sign,
                    int dtype, void* stream) {
  if (B == 0 || T_len == 0 || H == 0) return 0;
  if (D % 2) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  DISPATCH_DTYPE(dtype, T,
                 launch_rope<T>((const T*)x, (const T*)cos_t,
                                (const T*)sin_t, (T*)out, B * T_len, T_len, H,
                                D, sign, st));
  return (int)cudaGetLastError();
}
