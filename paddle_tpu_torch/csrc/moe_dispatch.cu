// MoE token dispatch and combine (GShard capacity-padded routing).
//
//   dispatch: out[e, c] = sum over choices (t, k) with eidx = e and
//             sidx = c < C of w[t, k] * tok[t]          [T, M] -> [E, C, M]
//   combine:  out[t] = sum over k with sidx < C of
//             w[t, k] * eo[eidx, sidx]                  [E, C, M] -> [T, M]
// Both sum in f32 and round once to the tokens' type, as the TPU kernels'
// f32 accumulators do.
//
// Replaces paddle_tpu/kernels/moe_dispatch.py _dispatch_kernel and
// _combine_kernel (pallas_calls in _dispatch_raw and _combine_raw).  The
// TPU kernels build a one-hot [tokens, slots] tile in VMEM and run it
// through the matrix unit, a TPU idiom for a gather that would cost
// E*C*T*K multiply-adds here; both kernels below are gathers instead.
//
// Bound on the H100: bytes.  Combine reads each routed row once and
// writes each token row once: one block per (token, column tile), K
// 16-byte loads a thread.  Dispatch writes every one of the E*C rows
// exactly once (zeros where no choice lands) and reads each routed token
// row once.  A slot can be named by several choices (the backward passes
// clamp dropped choices to slot C-1 with weight 0), so dispatch first
// builds every slot's list of contributors: count (integer atomics),
// exclusive scan (one block), fill; then one block per (slot, column
// tile) sums its list.  No f32 scratch, no memset of the output, and no
// atomics on the data.  A choice of weight 0 contributes exactly 0 to a
// finite sum and is left out of the lists, so every list the model
// builds (forward: running-count slots; backward: dropped choices at
// weight 0) holds at most one choice.  A longer list is summed in
// ascending (t, k) order, found by selection, so the result never depends
// on the fill's atomics (products and sums rounded separately, no fused
// multiply-add).
#include <climits>

#include "common.cuh"

constexpr int MD_THREADS = 256;
constexpr int SCAN_THREADS = 1024;

// VEC elements of T in one aligned load or store (16 bytes when VEC > 1)
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ bool routed(int e, int s, float w, int E, int C) {
  return e >= 0 && e < E && s >= 0 && s < C && w != 0.f;
}

__global__ void moe_slot_count(const int* __restrict__ eidx,
                               const int* __restrict__ sidx,
                               const float* __restrict__ w, int n, int E,
                               int C, int* __restrict__ count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int e = eidx[i], s = sidx[i];
  if (routed(e, s, w[i], E, C)) atomicAdd(&count[e * C + s], 1);
}

// start[j] = sum of count[0..j), start[S] = the total; count[j] becomes
// start[j], the fill's cursor
__global__ void __launch_bounds__(SCAN_THREADS)
    moe_slot_scan(int* __restrict__ count, int* __restrict__ start, int S) {
  __shared__ int warp_total[SCAN_THREADS / 32];
  const int per = (S + SCAN_THREADS - 1) / SCAN_THREADS;
  const int lo = min(S, (int)threadIdx.x * per), hi = min(S, lo + per);
  int local = 0;
  for (int j = lo; j < hi; ++j) local += count[j];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int x = local;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_total[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int v = warp_total[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += y;
    }
    warp_total[lane] = v;
  }
  __syncthreads();
  int base = x - local + (warp ? warp_total[warp - 1] : 0);
  for (int j = lo; j < hi; ++j) {
    const int c = count[j];
    start[j] = base;
    count[j] = base;
    base += c;
  }
  if (threadIdx.x == SCAN_THREADS - 1) start[S] = base;
}

__global__ void moe_slot_fill(const int* __restrict__ eidx,
                              const int* __restrict__ sidx,
                              const float* __restrict__ w, int n, int E,
                              int C, int* __restrict__ cursor,
                              int* __restrict__ list) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int e = eidx[i], s = sidx[i];
  if (routed(e, s, w[i], E, C)) list[atomicAdd(&cursor[e * C + s], 1)] = i;
}

// acc += w * row[col .. col + VEC), product and sum each rounded once
template <typename T, int VEC>
__device__ __forceinline__ void add_row(float (&acc)[VEC], float w,
                                        const T* row) {
  const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(row);
#pragma unroll
  for (int v = 0; v < VEC; ++v)
    acc[v] = __fadd_rn(acc[v], __fmul_rn(w, to_f32(p.v[v])));
}

template <typename T, int VEC>
__device__ __forceinline__ void store_row(T* dst, const float (&acc)[VEC]) {
  Pack<T, VEC> p;
#pragma unroll
  for (int v = 0; v < VEC; ++v) p.v[v] = from_f32<T>(acc[v]);
  *reinterpret_cast<Pack<T, VEC>*>(dst) = p;
}

// one block per (slot, column tile): the f32 sum of the slot's list,
// rounded once; zeros for an empty list
template <typename T, int VEC>
__global__ void __launch_bounds__(MD_THREADS)
    moe_dispatch_rows(const T* __restrict__ tok, const float* __restrict__ w,
                      const int* __restrict__ start,
                      const int* __restrict__ list, T* __restrict__ out,
                      int M, int K) {
  const int j = blockIdx.x;
  const int col = (blockIdx.y * MD_THREADS + threadIdx.x) * VEC;
  if (col >= M) return;
  const int b = start[j], L = start[j + 1] - b;
  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.f;
  // the list in ascending (t, k) order, by selection
  int prev = -1;
  for (int r = 0; r < L; ++r) {
    int next = INT_MAX;
    for (int q = 0; q < L; ++q) {
      const int i = list[b + q];
      if (i > prev && i < next) next = i;
    }
    add_row<T, VEC>(acc, w[next], tok + (size_t)(next / K) * M + col);
    prev = next;
  }
  store_row<T, VEC>(out + (size_t)j * M + col, acc);
}

// one block per (token, column tile)
template <typename T, int VEC>
__global__ void __launch_bounds__(MD_THREADS)
    moe_combine_kernel(const T* __restrict__ eo, const int* __restrict__ eidx,
                       const int* __restrict__ sidx,
                       const float* __restrict__ w, T* __restrict__ out,
                       int M, int K, int E, int C) {
  const int t = blockIdx.x;
  const int col = (blockIdx.y * MD_THREADS + threadIdx.x) * VEC;
  if (col >= M) return;
  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.f;
  for (int k = 0; k < K; ++k) {
    const int i = t * K + k;
    const int e = eidx[i], s = sidx[i];
    const float wk = w[i];
    if (!routed(e, s, wk, E, C)) continue;
    add_row<T, VEC>(acc, wk, eo + ((size_t)e * C + s) * M + col);
  }
  store_row<T, VEC>(out + (size_t)t * M + col, acc);
}

template <int VEC>
static dim3 row_grid(int rows, int M) {
  return dim3(rows, (M + MD_THREADS * VEC - 1) / (MD_THREADS * VEC));
}

template <typename T>
static void launch_rows(const void* tok, const void* w, const void* start,
                        const void* list, void* out, int S, int M, int K,
                        int vec, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    const dim3 grid = row_grid<V>(S, M);
    moe_dispatch_rows<T, V><<<grid, MD_THREADS, 0, st>>>(
        (const T*)tok, (const float*)w, (const int*)start, (const int*)list,
        (T*)out, M, K);
  } else {
    const dim3 grid = row_grid<1>(S, M);
    moe_dispatch_rows<T, 1><<<grid, MD_THREADS, 0, st>>>(
        (const T*)tok, (const float*)w, (const int*)start, (const int*)list,
        (T*)out, M, K);
  }
}

template <typename T>
static void launch_combine(const void* eo, const void* eidx,
                           const void* sidx, const void* w, void* out, int T_,
                           int K, int M, int E, int C, int vec,
                           cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    const dim3 grid = row_grid<V>(T_, M);
    moe_combine_kernel<T, V><<<grid, MD_THREADS, 0, st>>>(
        (const T*)eo, (const int*)eidx, (const int*)sidx, (const float*)w,
        (T*)out, M, K, E, C);
  } else {
    const dim3 grid = row_grid<1>(T_, M);
    moe_combine_kernel<T, 1><<<grid, MD_THREADS, 0, st>>>(
        (const T*)eo, (const int*)eidx, (const int*)sidx, (const float*)w,
        (T*)out, M, K, E, C);
  }
}

// tok [T, M], eidx / sidx int32 [T, K], w f32 [T, K] -> out [E, C, M];
// scratch: count int32 [E*C], start int32 [E*C + 1], list int32 [T*K].
// vec: M is a multiple of 16 bytes' worth of elements and every row
// pointer is 16-byte aligned (the wrapper checks)
extern "C" int moe_dispatch(const void* tok, const void* eidx,
                            const void* sidx, const void* w, void* out,
                            void* count, void* start, void* list, int T,
                            int K, int M, int E, int C, int dtype, int vec,
                            void* stream) {
  const int S = E * C, n = T * K;
  if (S == 0 || M == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemsetAsync(count, 0, sizeof(int) * (size_t)S, st);
  const int blocks = (n + MD_THREADS - 1) / MD_THREADS;
  if (n > 0)
    moe_slot_count<<<blocks, MD_THREADS, 0, st>>>(
        (const int*)eidx, (const int*)sidx, (const float*)w, n, E, C,
        (int*)count);
  moe_slot_scan<<<1, SCAN_THREADS, 0, st>>>((int*)count, (int*)start, S);
  if (n > 0)
    moe_slot_fill<<<blocks, MD_THREADS, 0, st>>>(
        (const int*)eidx, (const int*)sidx, (const float*)w, n, E, C,
        (int*)count, (int*)list);
  DISPATCH_DTYPE(dtype, Tp,
                 launch_rows<Tp>(tok, w, start, list, out, S, M, K, vec, st));
  return (int)cudaGetLastError();
}

// eo [E, C, M], eidx / sidx int32 [T, K], w f32 [T, K] -> out [T, M]
extern "C" int moe_combine(const void* eo, const void* eidx,
                           const void* sidx, const void* w, void* out, int T,
                           int K, int M, int E, int C, int dtype, int vec,
                           void* stream) {
  if (T == 0 || M == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  DISPATCH_DTYPE(dtype, Tp,
                 launch_combine<Tp>(eo, eidx, sidx, w, out, T, K, M, E, C,
                                    vec, st));
  return (int)cudaGetLastError();
}
