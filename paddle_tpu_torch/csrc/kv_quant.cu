// Quantize-at-write for the paged KV pools: a step's new k and v rows
// are quantized (one f32 absmax scale per row over kv_heads x head_dim,
// int8 or fp8 e4m3 codes) and scattered into the int8 pools and their
// [nb, bs] scale sidecars, k and v in one launch.
//
// Replaces the reference's quantize-and-scatter writes, which are XLA
// code rather than Pallas: paddle_tpu/kernels/paged_attention.py
// _scatter_token_quant (a decode step, one token a sequence) and
// paddle_tpu/models/llama.py _scatter_q (a prefill chunk; its padded
// positions come in already pointed at the garbage block's row 0).  The
// flat destination rows come from the caller (the block-table lookup and
// the column clamp stay in PyTorch, shared with the plain version).
//
// One block per (row, side): it reduces the row's absmax, divides it by
// qmax, divides every element by the scale and writes the codes and the
// scale.  The divisions are IEEE divisions (no fast math), in the
// reference's order, so the codes are bit-identical to the plain
// version's.  Bound on the H100: bytes (each element is read once as T
// and written once as a byte); a decode step moves ~50 KB a layer, so
// the launch, not the bandwidth, is what it costs.
#include "common.cuh"

constexpr int KQ_THREADS = 256;

template <typename T, int Q>
__global__ void __launch_bounds__(KQ_THREADS) kv_quant_scatter_kernel(
    const T* __restrict__ k_new,          // [N, E] new rows, E = KVH * D
    const T* __restrict__ v_new,
    const long long* __restrict__ rows,   // [N] flat pool rows
    int8_t* __restrict__ k_pool,          // [nb * bs, E] codes
    int8_t* __restrict__ v_pool,
    float* __restrict__ k_scale,          // [nb * bs]
    float* __restrict__ v_scale, int E) {
  constexpr float qmax = Q == 1 ? 127.f : 448.f;
  const int n = blockIdx.x, side = blockIdx.y;
  const T* src = (side ? v_new : k_new) + (size_t)n * E;
  const long long row = rows[n];
  int8_t* dst = (side ? v_pool : k_pool) + (size_t)row * E;
  float amax = 0.f;
  for (int i = threadIdx.x; i < E; i += KQ_THREADS)
    amax = fmaxf(amax, fabsf(to_f32(src[i])));
  amax = block_max<KQ_THREADS>(amax);
  const float scale = amax > 0.f ? amax / qmax : 1.f;
  for (int i = threadIdx.x; i < E; i += KQ_THREADS)
    dst[i] = encode_code<Q>(to_f32(src[i]) / scale);
  if (threadIdx.x == 0) (side ? v_scale : k_scale)[row] = scale;
}

template <typename T, int Q>
static void launch(const void* k_new, const void* v_new, const void* rows,
                   void* k_pool, void* v_pool, void* k_scale, void* v_scale,
                   int N, int E, cudaStream_t st) {
  kv_quant_scatter_kernel<T, Q><<<dim3(N, 2), KQ_THREADS, 0, st>>>(
      (const T*)k_new, (const T*)v_new, (const long long*)rows,
      (int8_t*)k_pool, (int8_t*)v_pool, (float*)k_scale, (float*)v_scale,
      E);
}

// dtype: the new rows' type (0 f32, 1 bf16); kv: 1 int8, 2 fp8
extern "C" int kv_quant_scatter(const void* k_new, const void* v_new,
                                const void* rows, void* k_pool, void* v_pool,
                                void* k_scale, void* v_scale, int N, int E,
                                int dtype, int kv, void* stream) {
  if (N == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  DISPATCH_DTYPE(dtype, T, {
    if (kv == 1)
      launch<T, 1>(k_new, v_new, rows, k_pool, v_pool, k_scale, v_scale, N,
                   E, st);
    else if (kv == 2)
      launch<T, 2>(k_new, v_new, rows, k_pool, v_pool, k_scale, v_scale, N,
                   E, st);
    else
      return (int)cudaErrorInvalidValue;
  });
  return (int)cudaGetLastError();
}
