// The paged-KV write: a step's new k and v rows go into the block pools
// at the rows their sequences' block tables give, in one launch that
// also does what surrounded the write before: the row lookup, a decode
// step's RoPE on k, and, for int8 / fp8 pools, the quantization (one f32
// absmax scale per row over kv_heads x head_dim, int8 or fp8 e4m3 codes
// into the int8 pools, the scale into the [nb, bs] sidecar).
//
// Replaces the reference's writes, which are XLA code rather than
// Pallas: paddle_tpu/kernels/paged_attention.py fused_paged_decode's k
// rotation and _scatter_token / _scatter_token_quant (a decode step, one
// token a sequence), and paddle_tpu/models/llama.py _scatter /
// _scatter_q (a prefill chunk, whose k comes rotated).  XLA fuses each
// into the write; in PyTorch the same composition took ~17 launches a
// layer around one kernel at a decode step, ~12 at a chunk.
//
// Token (b, t) is at position p = positions[b] + t and goes to row
// block_table[b, min(p / bs, nbs - 1)] * bs + p % bs (the reference's
// column clamp), or to row 0 (the garbage block) where the chunk's write
// mask leaves it out.  Several tokens can share a row of the garbage
// block (a chunk's padded positions, idle decode slots): only the last
// of them writes it, so that it holds one whole token's row (and its
// scale), as the plain version's index_copy_ leaves it; which one the
// reference leaves there is unspecified.  With c / s (a decode step)
// k is rotated in f32 with the cast points of the plain version,
// cat([x1 c - x2 s, x2 c + x1 s]).to(k's type): every product and sum
// rounded on its own (__fmul_rn / __fadd_rn, so nvcc cannot contract
// them into FMAs), c and s raised to f32 exactly.  Quantization divides
// as the reference does, absmax / qmax and then x / scale, both IEEE
// divisions (no fast math), so the codes are bit-identical to the plain
// version's.
//
// Bound on the H100: bytes (each element read once and written once; a
// decode step moves ~50 KB a layer), so what a call costs is its launch
// and one chain of dependent loads (positions -> block table -> row; the
// rows' own loads do not wait for it).  One block of KW_THREADS per
// (token, side), a 16-byte vector a thread for a row of 1,024 bf16: the
// threads start all their loads of a row (and a rotated vector's partner
// and c / s) at once, keep the values in registers (a row of up to
// KW_THREADS vectors; a longer one is loaded again for its codes) and
// reduce the absmax across the block.  One vector a thread a pass: each
// block runs the kernel's code once, so more vectors a thread (a longer
// unrolled body, each IEEE division with its own slow path) cost more in
// instruction fetches than they save (4 a thread: 2.7x slower at a
// 256-token chunk, PERF.md).
#include "common.cuh"

constexpr int KW_THREADS = 128;  // a block per (token, side)

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) KPack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ KPack<T, VEC> load_pack(const T* p) {
  return *reinterpret_cast<const KPack<T, VEC>*>(p);
}

// k / v [B * T, E] rows of the new tokens, E = KVH * D; c / s [B, D / 2]
// (ROT); mask [B, T] or null; pools [nb * bs, E] of T (Q = 0) or of
// int8 codes with [nb * bs] f32 scales.
template <typename T, typename CT, int Q, int VEC, bool ROT>
__global__ void __launch_bounds__(KW_THREADS) kv_write_kernel(
    const T* __restrict__ k, const T* __restrict__ v,
    const CT* __restrict__ c, const CT* __restrict__ s,
    const int* __restrict__ block_table, const int* __restrict__ positions,
    const uint8_t* __restrict__ mask, void* __restrict__ k_pool,
    void* __restrict__ v_pool, float* __restrict__ k_scale,
    float* __restrict__ v_scale, int N, int Tn, int KVH, int D, int bs,
    int nbs) {
  const int tid = threadIdx.x;
  const int n = blockIdx.x >> 1, side = blockIdx.x & 1;
  const int b = n / Tn;
  const int E = KVH * D, half = D / 2;
  const T* src = (side ? v : k) + (size_t)n * E;
  auto row_of = [&](int m) -> long long {
    if (mask != nullptr && !mask[m]) return 0;
    const int bm = m / Tn, p = positions[bm] + (m - bm * Tn);
    return (long long)block_table[(size_t)bm * nbs + min(p / bs, nbs - 1)]
           * bs + p % bs;
  };
  const long long row = row_of(n);
  if (row < bs) {
    // a row of the garbage block: the block stands down if a later token
    // writes the same row (every thread holds the same row)
    for (int m0 = n + 1; m0 < N; m0 += KW_THREADS) {
      const int m = m0 + tid;
      if (__syncthreads_or(m < N && row_of(m) == row)) return;
    }
  }
  const bool rot = ROT && side == 0;
  const int units = E / VEC;   // vectors of the row
  // the row's vector u as the pool receives it (rounded to T), every load
  // started before any use: a rotated vector also loads its partner in
  // the other half of its head and its c / s
  float x[VEC];
  auto load = [&](int u) {
    const int off = u * VEC;
    const KPack<T, VEC> a = load_pack<T, VEC>(src + off);
    KPack<T, VEC> p;
    KPack<CT, VEC> cv, sv;
    if constexpr (ROT) {
      if (rot) {
        const int d = off % D;
        const int j = d < half ? d : d - half;
        p = load_pack<T, VEC>(src + off + (d < half ? half : -half));
        cv = load_pack<CT, VEC>(c + (size_t)b * half + j);
        sv = load_pack<CT, VEC>(s + (size_t)b * half + j);
      }
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) x[e] = to_f32(a.v[e]);
    if constexpr (ROT) {
      if (!rot) return;
      const bool first = off % D < half;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float me = x[e], other = to_f32(p.v[e]);
        const float x1 = first ? me : other, x2 = first ? other : me;
        const float ce = to_f32(cv.v[e]), se = to_f32(sv.v[e]);
        x[e] = round_to<T>(
            first ? __fsub_rn(__fmul_rn(x1, ce), __fmul_rn(x2, se))
                  : __fadd_rn(__fmul_rn(x2, ce), __fmul_rn(x1, se)));
      }
    }
  };
  if constexpr (Q == 0) {
    T* dst = static_cast<T*>(side ? v_pool : k_pool) + row * E;
    for (int u = tid; u < units; u += KW_THREADS) {
      load(u);
      KPack<T, VEC> o;
#pragma unroll
      for (int e = 0; e < VEC; ++e) o.v[e] = from_f32<T>(x[e]);
      *reinterpret_cast<KPack<T, VEC>*>(dst + u * VEC) = o;
    }
  } else {
    constexpr float qmax = Q == 1 ? 127.f : 448.f;
    float amax = 0.f;
    for (int u = tid; u < units; u += KW_THREADS) {
      load(u);
#pragma unroll
      for (int e = 0; e < VEC; ++e) amax = fmaxf(amax, fabsf(x[e]));
    }
    amax = block_max<KW_THREADS>(amax);
    const float scale = amax > 0.f ? amax / qmax : 1.f;
    int8_t* dst = static_cast<int8_t*>(side ? v_pool : k_pool) + row * E;
    // a row of at most KW_THREADS vectors is still in x; a longer one
    // reloads
    for (int u = tid; u < units; u += KW_THREADS) {
      if (units > KW_THREADS) load(u);
      KPack<int8_t, VEC> o;
#pragma unroll
      for (int e = 0; e < VEC; ++e) o.v[e] = encode_code<Q>(x[e] / scale);
      *reinterpret_cast<KPack<int8_t, VEC>*>(dst + u * VEC) = o;
    }
    if (tid == 0) (side ? v_scale : k_scale)[row] = scale;
  }
}

template <typename T, typename CT, int Q, bool ROT>
static void launch(const void* k, const void* v, const void* c, const void* s,
                   const void* bt, const void* pos, const void* mask,
                   void* k_pool, void* v_pool, void* k_scale, void* v_scale,
                   int N, int Tn, int KVH, int D, int bs, int nbs, int vec,
                   cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  if (vec)
    kv_write_kernel<T, CT, Q, V, ROT><<<2 * N, KW_THREADS, 0, st>>>(
        (const T*)k, (const T*)v, (const CT*)c, (const CT*)s, (const int*)bt,
        (const int*)pos, (const uint8_t*)mask, k_pool, v_pool,
        (float*)k_scale, (float*)v_scale, N, Tn, KVH, D, bs, nbs);
  else
    kv_write_kernel<T, CT, Q, 1, ROT><<<2 * N, KW_THREADS, 0, st>>>(
        (const T*)k, (const T*)v, (const CT*)c, (const CT*)s, (const int*)bt,
        (const int*)pos, (const uint8_t*)mask, k_pool, v_pool,
        (float*)k_scale, (float*)v_scale, N, Tn, KVH, D, bs, nbs);
}

template <typename T, int Q>
static int launch_q(const void* k, const void* v, const void* c,
                    const void* s, const void* bt, const void* pos,
                    const void* mask, void* k_pool, void* v_pool,
                    void* k_scale, void* v_scale, int N, int Tn, int KVH,
                    int D, int bs, int nbs, int c_dtype, int vec,
                    cudaStream_t st) {
  if (c == nullptr) {
    launch<T, T, Q, false>(k, v, c, s, bt, pos, mask, k_pool, v_pool,
                           k_scale, v_scale, N, Tn, KVH, D, bs, nbs, vec, st);
    return 0;
  }
  DISPATCH_DTYPE(c_dtype, CT,
                 launch<T, CT, Q, true>(k, v, c, s, bt, pos, mask, k_pool,
                                        v_pool, k_scale, v_scale, N, Tn, KVH,
                                        D, bs, nbs, vec, st));
  return 0;
}

// k / v [B, T, KVH, D] of `dtype` (0 f32, 1 bf16); c / s [B, D / 2] of
// c_dtype, or null (no rotation; a decode step passes them with T = 1);
// block_table int32 [B, nbs]; positions int32 [B]; mask bool [B, T] or
// null; kv: 0 pools of dtype, 1 int8 codes, 2 fp8 codes (with scales).
// vec: D / 2 is a multiple of 16 bytes' worth of elements and k, v, c,
// s and the pools are 16-byte aligned (the wrapper checks)
extern "C" int kv_write(const void* k, const void* v, const void* c,
                        const void* s, const void* block_table,
                        const void* positions, const void* mask,
                        void* k_pool, void* v_pool, void* k_scale,
                        void* v_scale, int B, int T, int KVH, int D, int bs,
                        int nbs, int dtype, int c_dtype, int kv, int vec,
                        void* stream) {
  const int N = B * T;
  if (N == 0) return 0;
  if ((c == nullptr) != (s == nullptr) || (c != nullptr && T != 1) ||
      D % 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int err = 0;
  DISPATCH_DTYPE(dtype, Tp, {
    DISPATCH_KV(kv, Q,
                err = launch_q<Tp, Q>(k, v, c, s, block_table, positions,
                                      mask, k_pool, v_pool, k_scale, v_scale,
                                      N, T, KVH, D, bs, nbs, c_dtype, vec,
                                      st));
  });
  if (err) return err;
  return (int)cudaGetLastError();
}
