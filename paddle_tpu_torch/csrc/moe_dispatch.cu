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
// writes each token row once.  At a decode step's 8 tokens its time is a
// launch and the chain indices -> rows -> store, so a warp owns one
// (token, column chunk): its lanes load the indices and gates of up to
// CB_KB choices at once, the gates as given (f32, or the tokens' type,
// as the model passes them: no cast launch), then every routed row's
// CB_UNROLL 16-byte vectors a lane before the first add, and sum in
// ascending k, each product and sum rounded once (the bits of the
// predecessor, one 256-thread block per (token, column tile) whose
// threads walked the choices one load after another, 0.0049 ms at the
// decode form on an H100 at 700 W, PERF.md row 8b).  The grid is the
// (token, chunk) pairs over CB_WARPS warps a block: 512 blocks at a
// prefill chunk's 256 tokens.  Two choices and two vectors a lane (four
// of each took 235 registers a thread, and the training form's 4096
// tokens ran slower than the predecessor); streaming stores gave
// nothing.
//
// Dispatch writes every one of the E*C rows exactly once (zeros where no
// choice lands) and reads each routed token row, in ONE launch with no
// scratch in device memory, no memset and no global atomics.  The grid
// is persistent (kernels/moe_dispatch.py dispatch_plan: a power of two,
// at most DP_MIN_BLOCKS blocks a SM); of G blocks, block b owns the
// slots b, b + G, b + 2G, ... (the routed slots crowd the front of each
// expert's C, so contiguous ranges would leave a few blocks all the
// loads) and
//   1. streams all n = T*K choices (eidx and sidx; the weight, as given,
//      f32 or the tokens' type, of a choice of its own) and, for each
//      routed choice (e in [0, E), s in [0, C), w != 0) of one of its
//      slots, counts it and keeps the smallest choice index, with
//      shared-memory atomics (both results independent of the atomics'
//      order);
//   2. writes its rows with one warp per (slot, column chunk): first the
//      routed slots, in their tokens' order (so that a token's other
//      rows, which other blocks write at about the same time, find it in
//      the L2), then the empty ones.  A slot with one contributor stores
//      0 + w * tok[t] (the product and the sum each rounded once, as
//      index_add_ into zeros does), DP_UNROLL 16-byte loads a lane in
//      flight; a slot with several sums them in ascending (t, k) order,
//      found by a ballot over the choices from the first one on; an
//      empty slot stores zeros and loads nothing.
// A choice of weight 0 contributes exactly 0 to a finite sum and is left
// out, so every slot the model routes (forward: running-count slots;
// backward: dropped choices at weight 0) has at most one contributor;
// the several-contributor path is the rare one.  The re-read of the
// choices by every block costs blocks x 8 n bytes of L2 traffic (the
// weights only of its own choices), which the plan keeps below the bytes
// each block writes.
#include <climits>

#include "common.cuh"

constexpr int CB_WARPS = 4;        // combine: warps a block
constexpr int CB_UNROLL = 2;       // vectors a lane loads of each row
constexpr int CB_KB = 2;           // choices whose rows are loaded at once
constexpr int DP_THREADS = 512;    // dispatch
constexpr int DP_WARPS = DP_THREADS / 32;
constexpr int DP_MIN_BLOCKS = 2;   // kernels/moe_dispatch.py BLOCKS_PER_SM
constexpr int DP_UNROLL = 4;       // vectors a lane moves per (slot, chunk)
constexpr int DP_INDEX_UNROLL = 8; // choices a thread loads at once

// VEC elements of T in one aligned load or store (16 bytes when VEC > 1)
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ bool routed(int e, int s, float w, int E, int C) {
  return e >= 0 && e < E && s >= 0 && s < C && w != 0.f;
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

// 16 bytes of an output row, stored with the streaming hint
// (st.global.cs): the rows are written once, so their lines need not
// crowd the token rows that other blocks read again out of the L2
// (tools/dispatch_parts.py no_stream: 7 % slower at the training form)
template <typename T, int VEC>
__device__ __forceinline__ void put(T* dst, const Pack<T, VEC>& p) {
  if constexpr (sizeof(Pack<T, VEC>) == 16)
    __stcs(reinterpret_cast<uint4*>(dst),
           *reinterpret_cast<const uint4*>(&p));
  else
    *reinterpret_cast<Pack<T, VEC>*>(dst) = p;
}

// The rows of one (slot, column chunk) for one warp.  Lane l moves the
// vectors at columns col + u * 32 * VEC (u < DP_UNROLL); with VEC > 1, M
// is a multiple of VEC, so a vector is wholly inside the row or past it.
template <typename T, int VEC>
__device__ __forceinline__ void zero_chunk(T* dst, int col, int M) {
  Pack<T, VEC> z;
#pragma unroll
  for (int v = 0; v < VEC; ++v) z.v[v] = from_f32<T>(0.f);
#pragma unroll
  for (int u = 0; u < DP_UNROLL; ++u)
    if (col + u * 32 * VEC < M) put<T, VEC>(dst + u * 32 * VEC, z);
}

// dst = 0 + w * src, every load of the chunk in flight before the first store
template <typename T, int VEC>
__device__ __forceinline__ void scaled_chunk(T* dst, const T* src, float w,
                                             int col, int M) {
  Pack<T, VEC> p[DP_UNROLL];
#pragma unroll
  for (int u = 0; u < DP_UNROLL; ++u)
    if (col + u * 32 * VEC < M)
      p[u] = *reinterpret_cast<const Pack<T, VEC>*>(src + u * 32 * VEC);
#pragma unroll
  for (int u = 0; u < DP_UNROLL; ++u) {
    if (col + u * 32 * VEC >= M) continue;
    Pack<T, VEC> o;
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      o.v[v] = from_f32<T>(__fadd_rn(0.f, __fmul_rn(w, to_f32(p[u].v[v]))));
    put<T, VEC>(dst + u * 32 * VEC, o);
  }
}

// the f32 sum of the c contributors of flat slot `slot` in ascending
// (t, k) order, from choice i0 (the first) on, rounded once.  The warp
// takes 32 choices at a time and the ballot of those that name the slot
// gives their order; every branch but the column bound is warp-uniform.
// Not inlined: the rare path keeps its registers out of the kernel's.
template <typename T, typename WT, int VEC>
__device__ __noinline__ void summed_chunk(
    T* dst, const T* __restrict__ tok, const int* __restrict__ eidx,
    const int* __restrict__ sidx, const WT* __restrict__ w, int i0, int c,
    int slot, int n, int K, int M, int E, int C, int col) {
  const int lane = threadIdx.x % 32;
  for (int u = 0; u < DP_UNROLL; ++u) {
    const int cu = col + u * 32 * VEC;
    float acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = 0.f;
    for (int b = i0, found = 0; found < c; b += 32) {
      const int i = b + lane;
      float wi = 0.f;
      bool hit = false;
      if (i < n) {
        const int e = eidx[i], s = sidx[i];
        wi = to_f32(w[i]);
        hit = routed(e, s, wi, E, C) && e * C + s == slot;
      }
      unsigned m = __ballot_sync(0xffffffffu, hit);
      found += __popc(m);
      while (m) {
        const int l = __ffs(m) - 1;
        m &= m - 1;
        const float wl = __shfl_sync(0xffffffffu, wi, l);
        if (cu < M) add_row<T, VEC>(acc, wl, tok + (size_t)((b + l) / K) * M
                                                 + cu);
      }
    }
    if (cu < M) store_row<T, VEC>(dst + u * 32 * VEC, acc);
  }
}

// One launch: the block's index stage, then its rows (header).  Shared
// memory: [per] counts, [per] first choices,
// [per] slots with contributors, [per] the same in their tokens' order,
// and the length of that list.
template <typename T, typename WT, int VEC>
__global__ void __launch_bounds__(DP_THREADS, DP_MIN_BLOCKS)
    moe_dispatch_kernel(const T* __restrict__ tok,
                        const int* __restrict__ eidx,
                        const int* __restrict__ sidx,
                        const WT* __restrict__ w, T* __restrict__ out, int n,
                        int K, int M, int E, int C, int per) {
  extern __shared__ int count[];
  int* first = count + per;
  int* listed = count + 2 * per;
  int* order = count + 3 * per;
  int* n_listed = count + 4 * per;
  // the block's slots: blockIdx.x + G j, j < len (strided, so that the
  // routed slots, which crowd the front of each expert's C, spread evenly
  // over the blocks)
  const int G = gridDim.x, g_shift = __ffs(G) - 1;   // G: a power of two
  const int len = (E * C - (int)blockIdx.x + G - 1) >> g_shift;
  for (int j = threadIdx.x; j < len; j += DP_THREADS) {
    count[j] = 0;
    first[j] = INT_MAX;
  }
  if (threadIdx.x == 0) *n_listed = 0;
  __syncthreads();
  // index stage: the weight is read only for a choice in the block's range
  for (int base = 0; base < n; base += DP_THREADS * DP_INDEX_UNROLL) {
    int e[DP_INDEX_UNROLL], s[DP_INDEX_UNROLL];
#pragma unroll
    for (int u = 0; u < DP_INDEX_UNROLL; ++u) {
      const int i = base + u * DP_THREADS + threadIdx.x;
      e[u] = i < n ? eidx[i] : -1;
      s[u] = i < n ? sidx[i] : -1;
    }
#pragma unroll
    for (int u = 0; u < DP_INDEX_UNROLL; ++u) {
      const int i = base + u * DP_THREADS + threadIdx.x;
      if (e[u] < 0 || e[u] >= E || s[u] < 0 || s[u] >= C) continue;
      const int slot = e[u] * C + s[u];
      if ((slot & (G - 1)) != (int)blockIdx.x || to_f32(w[i]) == 0.f)
        continue;
      const int j = slot >> g_shift;
      atomicAdd(&count[j], 1);
      atomicMin(&first[j], i);
    }
  }
  __syncthreads();
  // the slots with contributors, in a list
  for (int j = threadIdx.x; j < len; j += DP_THREADS)
    if (count[j]) listed[atomicAdd(n_listed, 1)] = j;
  __syncthreads();
  // the routed slots in the order of their first choices, that is of
  // their tokens: the rows of a token's K choices, which other blocks
  // write, go out at about the same time, so that all but the first read
  // of a token row find it in the L2 (choice indices are distinct, so the
  // ranks are)
  const int nl = *n_listed;
  for (int k = threadIdx.x; k < nl; k += DP_THREADS) {
    const int j = listed[k], key = first[j];
    int rank = 0;
    for (int q = 0; q < nl; ++q) rank += first[listed[q]] < key;
    order[rank] = j;
  }
  __syncthreads();
  constexpr int CHUNK = 32 * VEC * DP_UNROLL;
  const int chunks = (M + CHUNK - 1) / CHUNK;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  auto write = [&](int j, int chunk) {   // one (slot, column chunk)
    const int col = chunk * CHUNK + lane * VEC;
    const int slot = blockIdx.x + G * j;
    T* dst = out + (size_t)slot * M + col;
    const int c = count[j], i = first[j];
    if (c == 0)
      zero_chunk<T, VEC>(dst, col, M);
    else if (c == 1)
      scaled_chunk<T, VEC>(dst, tok + (size_t)(i / K) * M + col,
                           to_f32(w[i]), col, M);
    else
      summed_chunk<T, WT, VEC>(dst, tok, eidx, sidx, w, i, c, slot, n, K, M,
                               E, C, col);
  };
  for (int item = warp; item < nl * chunks; item += DP_WARPS)
    write(order[item / chunks], item % chunks);
  for (int item = warp; item < len * chunks; item += DP_WARPS)
    if (count[item / chunks] == 0) write(item / chunks, item % chunks);
}

// A warp per (token, column chunk of 32 * VEC * CB_UNROLL), CB_WARPS
// warps a block: each lane loads the indices and gates of CB_KB choices
// at once, then issues all their rows' loads (CB_UNROLL vectors a row)
// before the first add, and sums in ascending k
template <typename T, typename WT, int VEC>
__global__ void __launch_bounds__(32 * CB_WARPS)
    moe_combine_kernel(const T* __restrict__ eo, const int* __restrict__ eidx,
                       const int* __restrict__ sidx, const WT* __restrict__ w,
                       T* __restrict__ out, int n_tok, int M, int K, int E,
                       int C) {
  using P = Pack<T, VEC>;
  constexpr int CHUNK = 32 * VEC * CB_UNROLL;
  const int chunks = (M + CHUNK - 1) / CHUNK;
  const int item = blockIdx.x * CB_WARPS + threadIdx.x / 32;
  if (item >= n_tok * chunks) return;
  const int t = item / chunks;
  const int col = (item % chunks) * CHUNK + (threadIdx.x % 32) * VEC;
  float acc[CB_UNROLL][VEC];
#pragma unroll
  for (int u = 0; u < CB_UNROLL; ++u)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[u][v] = 0.f;
  for (int k0 = 0; k0 < K; k0 += CB_KB) {
    int e[CB_KB], s[CB_KB];
    float wk[CB_KB];
#pragma unroll
    for (int j = 0; j < CB_KB; ++j) {
      const int i = t * K + k0 + j;
      const bool in = k0 + j < K;
      e[j] = in ? eidx[i] : -1;
      s[j] = in ? sidx[i] : 0;
      wk[j] = in ? to_f32(w[i]) : 0.f;   // bf16 -> f32 is exact
    }
    P p[CB_KB][CB_UNROLL];
#pragma unroll
    for (int j = 0; j < CB_KB; ++j) {
      if (!routed(e[j], s[j], wk[j], E, C)) continue;
      const T* row = eo + ((size_t)e[j] * C + s[j]) * M + col;
#pragma unroll
      for (int u = 0; u < CB_UNROLL; ++u)
        if (col + u * 32 * VEC < M)
          p[j][u] = *reinterpret_cast<const P*>(row + u * 32 * VEC);
    }
#pragma unroll
    for (int j = 0; j < CB_KB; ++j) {
      if (!routed(e[j], s[j], wk[j], E, C)) continue;
#pragma unroll
      for (int u = 0; u < CB_UNROLL; ++u)
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          acc[u][v] = __fadd_rn(acc[u][v],
                                __fmul_rn(wk[j], to_f32(p[j][u].v[v])));
    }
  }
  T* dst = out + (size_t)t * M + col;
#pragma unroll
  for (int u = 0; u < CB_UNROLL; ++u)
    if (col + u * 32 * VEC < M)
      store_row<T, VEC>(dst + u * 32 * VEC, acc[u]);
}

template <typename T, typename WT>
static void launch_dispatch(const void* tok, const void* eidx,
                            const void* sidx, const void* w, void* out,
                            int n, int K, int M, int E, int C, int vec,
                            int blocks, int per, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const size_t smem = sizeof(int) * (4 * (size_t)per + 1);
  if (vec)
    moe_dispatch_kernel<T, WT, V><<<blocks, DP_THREADS, smem, st>>>(
        (const T*)tok, (const int*)eidx, (const int*)sidx, (const WT*)w,
        (T*)out, n, K, M, E, C, per);
  else
    moe_dispatch_kernel<T, WT, 1><<<blocks, DP_THREADS, smem, st>>>(
        (const T*)tok, (const int*)eidx, (const int*)sidx, (const WT*)w,
        (T*)out, n, K, M, E, C, per);
}

template <typename T, typename WT>
static void launch_combine(const void* eo, const void* eidx,
                           const void* sidx, const void* w, void* out, int T_,
                           int K, int M, int E, int C, int vec,
                           cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const int VEC = vec ? V : 1;
  const long long items =
      (long long)T_ * ((M + 32 * VEC * CB_UNROLL - 1) / (32 * VEC * CB_UNROLL));
  const int blocks = (int)((items + CB_WARPS - 1) / CB_WARPS);
  if (vec)
    moe_combine_kernel<T, WT, V><<<blocks, 32 * CB_WARPS, 0, st>>>(
        (const T*)eo, (const int*)eidx, (const int*)sidx, (const WT*)w,
        (T*)out, T_, M, K, E, C);
  else
    moe_combine_kernel<T, WT, 1><<<blocks, 32 * CB_WARPS, 0, st>>>(
        (const T*)eo, (const int*)eidx, (const int*)sidx, (const WT*)w,
        (T*)out, T_, M, K, E, C);
}

// tok [T, M], eidx / sidx int32 [T, K], w [T, K] f32 (w_f32) or the
// tokens' type -> out [E, C, M], in `blocks` blocks of `per` slots
// (kernels/moe_dispatch.py dispatch_plan: blocks a power of two, at most
// E*C, and blocks * per covers E*C).
// vec: M is a multiple of 16 bytes' worth of elements and tok and out are
// 16-byte aligned (the wrapper checks)
extern "C" int moe_dispatch(const void* tok, const void* eidx,
                            const void* sidx, const void* w, void* out, int T,
                            int K, int M, int E, int C, int dtype, int w_f32,
                            int vec, int blocks, int per, void* stream) {
  if (E * C == 0 || M == 0) return 0;
  if (blocks <= 0 || (blocks & (blocks - 1)) || blocks > E * C || per <= 0 ||
      (long long)blocks * per < (long long)E * C)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  DISPATCH_DTYPE(dtype, Tp, {
    if (w_f32)
      launch_dispatch<Tp, float>(tok, eidx, sidx, w, out, T * K, K, M, E, C,
                                 vec, blocks, per, st);
    else
      launch_dispatch<Tp, Tp>(tok, eidx, sidx, w, out, T * K, K, M, E, C,
                              vec, blocks, per, st);
  });
  return (int)cudaGetLastError();
}

// eo [E, C, M], eidx / sidx int32 [T, K], w [T, K] f32 (w_f32) or the
// tokens' type -> out [T, M]; vec as for dispatch (eo and out)
extern "C" int moe_combine(const void* eo, const void* eidx,
                           const void* sidx, const void* w, void* out, int T,
                           int K, int M, int E, int C, int dtype, int w_f32,
                           int vec, void* stream) {
  if (T == 0 || M == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  DISPATCH_DTYPE(dtype, Tp, {
    if (w_f32)
      launch_combine<Tp, float>(eo, eidx, sidx, w, out, T, K, M, E, C, vec,
                                st);
    else
      launch_combine<Tp, Tp>(eo, eidx, sidx, w, out, T, K, M, E, C, vec, st);
  });
  return (int)cudaGetLastError();
}
