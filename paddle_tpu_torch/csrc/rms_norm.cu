// RMSNorm over the last axis, and the row scale it is built on:
//   rms_norm:  out = (x * rs).to(T) * w        (rounded to T once more)
//   rms_scale: rs  = rsqrt(mean(x^2) + eps)    [rows] f32
// with the square, the mean and + eps in f32 before the rsqrt.
//
// Replaces paddle_tpu/kernels/rms_norm.py _kernel (pallas_call in
// _rms_fwd_impl), and the reference's XLA rms_scale
// (paddle_tpu/kernels/fused_norm_linear.py rms_scale), which XLA fuses
// into one pass in front of every fused_norm_linear.  Cast points follow
// models/llama.py LlamaRMSNorm (the normalized row is rounded to T
// before the weight multiply), which is also the contract
// fused_norm_linear keeps; the TPU kernel multiplies by w in f32 and
// rounds once, up to one bf16 ulp away.
//
// Bound on the H100: bytes (each row read once, each output written
// once: 0.04 us for a decode step's [8, 4096] bf16, 40 us for the
// training step's [8192, 4096]).  At a decode step's 8 rows the time is a
// launch and one round trip to memory, so the design keeps that chain
// short: a block a row, each lane of its warps issues all its 16-byte
// loads of x (and of w) at once and keeps them in registers (RN_MAXV
// vectors a lane; a row of 4096 bf16 takes 8 warps, up to RN_MAX_WPR
// warps a row), the sum of squares is a shuffle tree and a fixed-order
// sum over the row's warps in shared memory, and the normalized row is
// written from the registers: x is read once, in one pass.  A row wider
// than the registers hold re-reads its tail in the second pass.  Rows
// that are not 16 bytes' worth of elements, or not 16-byte aligned,
// take the instance of one element a load (VEC = 1).  The predecessor
// (one 256-thread block a row, 2-byte loads, two passes over the row)
// took 3.7 us at [8, 4096] on an H100 at 700 W (PERF.md, row 1); one
// warp a row holding 16 vectors a lane of x and of w took 255
// registers, spilled, and was slower than the predecessor.
#include "common.cuh"

constexpr int RN_MAXV = 2;       // vectors a lane keeps in registers
constexpr int RN_MAX_WPR = 16;   // warps a row
constexpr int RN_THREADS = 32 * RN_MAX_WPR;   // most threads a block

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) RnPack {
  T v[VEC];
};

// a block a row, its blockDim.x / 32 warps (a power of two, at most
// RN_MAX_WPR).  NORM writes the normalized row to out, else the row
// scale to rs.
template <typename T, int VEC, bool NORM>
__global__ void __launch_bounds__(RN_THREADS)
    rms_rows(const T* __restrict__ x, const T* __restrict__ w,
             T* __restrict__ out, float* __restrict__ rs, int d, float eps) {
  using P = RnPack<T, VEC>;
  __shared__ float part[RN_MAX_WPR];
  const int tpr = blockDim.x, wpr = tpr / 32;
  const int row = blockIdx.x, tr = threadIdx.x;
  const int nvec = d / VEC;
  const P* xr = reinterpret_cast<const P*>(x + (size_t)row * d);
  const P* wr = reinterpret_cast<const P*>(w);

  // every load of the lane's vectors in flight at once (w's too)
  P xv[RN_MAXV], wv[NORM ? RN_MAXV : 1];
#pragma unroll
  for (int j = 0; j < RN_MAXV; ++j) {
    const int i = tr + j * tpr;
    if (i < nvec) {
      xv[j] = xr[i];
      if constexpr (NORM) wv[j] = wr[i];
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < RN_MAXV; ++j) {
    if (tr + j * tpr < nvec) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float f = to_f32(xv[j].v[e]);
        ss = fmaf(f, f, ss);
      }
    }
  }
  // a row wider than the registers: the rest, read again when written
  for (int i = tr + RN_MAXV * tpr; i < nvec; i += tpr) {
    const P p = xr[i];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float f = to_f32(p.v[e]);
      ss = fmaf(f, f, ss);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (wpr > 1) {   // the row's warps, summed in warp order
    if (tr % 32 == 0) part[tr / 32] = ss;
    __syncthreads();
    ss = 0.f;
    for (int k = 0; k < wpr; ++k) ss += part[k];
  }
  const float r = rsqrtf(ss / d + eps);
  if constexpr (!NORM) {
    if (tr == 0) rs[row] = r;
  } else {
    P* orow = reinterpret_cast<P*>(out + (size_t)row * d);
    auto put = [&](int i, const P& xp, const P& wp) {
      P o;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float n = round_to<T>(to_f32(xp.v[e]) * r);
        o.v[e] = from_f32<T>(n * to_f32(wp.v[e]));
      }
      orow[i] = o;
    };
#pragma unroll
    for (int j = 0; j < RN_MAXV; ++j) {
      const int i = tr + j * tpr;
      if (i < nvec) put(i, xv[j], wv[j]);
    }
    for (int i = tr + RN_MAXV * tpr; i < nvec; i += tpr)
      put(i, xr[i], wr[i]);
  }
}

// warps a row: the fewest (a power of two, at most RN_MAX_WPR) whose
// registers hold the row
static int rn_wpr(int nvec) {
  int wpr = 1;
  while (wpr < RN_MAX_WPR && nvec > 32 * wpr * RN_MAXV) wpr *= 2;
  return wpr;
}

// a block a row: a decode step's 8 rows spread over 8 SMs
template <typename T, bool NORM>
static int launch_rows(const void* x, const void* w, void* out, float* rs,
                       int rows, int d, float eps, int vec,
                       cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const int threads = 32 * rn_wpr(vec ? d / V : d);
  if (vec)
    rms_rows<T, V, NORM><<<rows, threads, 0, s>>>(
        (const T*)x, (const T*)w, (T*)out, rs, d, eps);
  else
    rms_rows<T, 1, NORM><<<rows, threads, 0, s>>>(
        (const T*)x, (const T*)w, (T*)out, rs, d, eps);
  return (int)cudaGetLastError();
}

// x, w, out: [rows, d], [d], [rows, d] of the dtype; vec: d is a
// multiple of 16 bytes' worth of elements and x, w and out are 16-byte
// aligned (the wrapper checks), else one element a load
extern "C" int rms_norm(const void* x, const void* w, void* out, int rows,
                        int d, float eps, int dtype, int vec, void* stream) {
  if (rows == 0 || d == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  int err = 0;
  DISPATCH_DTYPE(dtype, T,
                 err = launch_rows<T, true>(x, w, out, nullptr, rows, d, eps,
                                            vec, s));
  return err;
}

// rs [rows] f32 = rsqrt(mean(x^2) + eps) of x [rows, d]; vec as above
// (x alone)
extern "C" int rms_scale(const void* x, float* rs, int rows, int d,
                         float eps, int dtype, int vec, void* stream) {
  if (rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  int err = 0;
  DISPATCH_DTYPE(dtype, T,
                 err = launch_rows<T, false>(x, nullptr, nullptr, rs, rows,
                                             d, eps, vec, s));
  return err;
}
