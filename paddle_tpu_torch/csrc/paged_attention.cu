// One decode step of paged attention over the block pool, split-K
// (flash-decoding), with q's RoPE and the 1/sqrt(D) fold inside.
//
// Replaces paddle_tpu/kernels/paged_attention.py _decode_kernel
// (pallas_call in _pallas_partials) and its _combine_splits merge.
// The new token's k/v are rotated and scattered into the pools by the
// caller before this runs.
//
// On the TPU the grid (batch, split, page) walks pages in order and
// carries (acc, m, l) in VMEM from one page to the next.  Here blocks
// run in parallel in no order: a block owns one (batch, kv head, split)
// and walks that split's pages in a loop.  Pages are dealt to splits
// round-robin (page p to split p % S) and the walk stops at the
// sequence's frontier page, so every split gets work however short the
// context is (keys past the frontier would contribute exactly 0).  A
// block stages one page of K and V (bs rows of this kv head) in shared
// memory as f32, scores it against all rep query heads of the group,
// and updates a per-head online softmax; masked keys get weight exactly
// 0, so a split whose keys are all masked emits m = -1e30, l = 0,
// acc = 0 and merges with weight 0.  A second small kernel merges the
// splits with the log-sum-exp combine and writes the output in T.
//
// Bound on the H100: bytes (each live K/V row is read once; the scores
// are 2*D flops per 2*D*sizeof(T) bytes).  This first version keeps
// the page loop serial within a block (load, score, softmax, PV, each
// behind a barrier); overlapping the next page's load is later work.
#include "common.cuh"

constexpr int PD_THREADS = 128;

template <typename T>
__global__ void __launch_bounds__(PD_THREADS) paged_decode_partials(
    const T* __restrict__ q,        // [B, H, D] unrotated, H = KVH * rep
    const float* __restrict__ cs,   // [B, D/2] cos at each frontier
    const float* __restrict__ sn,   // [B, D/2] sin at each frontier
    const T* __restrict__ k_pool,   // [nb, bs, KVH, D]
    const T* __restrict__ v_pool,
    const int* __restrict__ bt,     // [B, nbs]
    const int* __restrict__ pos,    // [B]
    float* __restrict__ acc_out,    // [B, S, H, D]
    float* __restrict__ m_out,      // [B, S, H]
    float* __restrict__ l_out,      // [B, S, H]
    int KVH, int rep, int D, int bs, int nbs, int S, float scale) {
  extern __shared__ float sm[];
  const int b = blockIdx.x, kvh = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, H = KVH * rep, half = D / 2;
  float* q_s = sm;                     // [rep, D]
  float* k_s = q_s + rep * D;          // [bs, D + 1]
  float* v_s = k_s + bs * (D + 1);     // [bs, D]
  float* p_s = v_s + bs * D;           // [rep, bs]
  float* acc_s = p_s + rep * bs;       // [rep, D]
  float* m_s = acc_s + rep * D;        // [rep]
  float* l_s = m_s + rep;              // [rep]
  float* a_s = l_s + rep;              // [rep]
  const int frontier = pos[b];

  // rotate-half RoPE on the group's q heads in f32, then the 1/sqrt(D)
  for (int i = tid; i < rep * D; i += PD_THREADS) {
    const int r = i / D, d = i % D, j = d < half ? d : d - half;
    const T* qr = q + ((size_t)b * H + kvh * rep + r) * D;
    const float x1 = to_f32(qr[j]), x2 = to_f32(qr[j + half]);
    const float c = cs[b * half + j], sv = sn[b * half + j];
    q_s[i] = (d < half ? x1 * c - x2 * sv : x2 * c + x1 * sv) * scale;
    acc_s[i] = 0.f;
  }
  if (tid < rep) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  const int last_page = min(frontier / bs, nbs - 1);
  const size_t row_stride = (size_t)KVH * D;
  for (int page = s; page <= last_page; page += S) {
    const size_t base = ((size_t)bt[b * nbs + page] * bs * KVH + kvh) * D;
    for (int i = tid; i < bs * D; i += PD_THREADS) {
      const int t = i / D, d = i % D;
      const size_t off = base + t * row_stride + d;
      k_s[t * (D + 1) + d] = to_f32(k_pool[off]);
      v_s[i] = to_f32(v_pool[off]);
    }
    __syncthreads();
    for (int i = tid; i < rep * bs; i += PD_THREADS) {
      const int r = i / bs, t = i % bs;
      const float* qr = q_s + r * D;
      const float* kr = k_s + t * (D + 1);
      float sc = 0.f;
      for (int d = 0; d < D; ++d) sc = fmaf(qr[d], kr[d], sc);
      p_s[i] = page * bs + t <= frontier ? sc : NEG_INF;
    }
    __syncthreads();
    if (tid < rep) {
      float* pr = p_s + tid * bs;
      float mc = NEG_INF;
      for (int t = 0; t < bs; ++t) mc = fmaxf(mc, pr[t]);
      const float mn = fmaxf(m_s[tid], mc);
      const float alpha = expf(m_s[tid] - mn);
      float sum = 0.f;
      for (int t = 0; t < bs; ++t) {
        const float e = page * bs + t <= frontier ? expf(pr[t] - mn) : 0.f;
        pr[t] = e;
        sum += e;
      }
      l_s[tid] = l_s[tid] * alpha + sum;
      m_s[tid] = mn;
      a_s[tid] = alpha;
    }
    __syncthreads();
    for (int i = tid; i < rep * D; i += PD_THREADS) {
      const int r = i / D, d = i % D;
      const float* pr = p_s + r * bs;
      float a = acc_s[i] * a_s[r];
      for (int t = 0; t < bs; ++t) a = fmaf(pr[t], v_s[t * D + d], a);
      acc_s[i] = a;
    }
    __syncthreads();
  }

  const size_t head0 = ((size_t)b * S + s) * H + kvh * rep;
  for (int i = tid; i < rep * D; i += PD_THREADS)
    acc_out[head0 * D + i] = acc_s[i];
  if (tid < rep) {
    m_out[head0 + tid] = m_s[tid];
    l_out[head0 + tid] = l_s[tid];
  }
}

// log-sum-exp merge of the S split partials; one block per (b, head)
template <typename T>
__global__ void __launch_bounds__(PD_THREADS) paged_decode_combine(
    const float* __restrict__ acc, const float* __restrict__ m,
    const float* __restrict__ l, T* __restrict__ out, int S, int H, int D) {
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  float mg = NEG_INF;
  for (int s = 0; s < S; ++s) mg = fmaxf(mg, m[((size_t)b * S + s) * H + h]);
  float lg = 0.f;
  for (int s = 0; s < S; ++s) {
    const size_t i = ((size_t)b * S + s) * H + h;
    lg += expf(m[i] - mg) * l[i];
  }
  const float inv_l = 1.f / fmaxf(lg, 1e-30f);
  for (int d = threadIdx.x; d < D; d += PD_THREADS) {
    float o = 0.f;
    for (int s = 0; s < S; ++s) {
      const size_t i = ((size_t)b * S + s) * H + h;
      o += expf(m[i] - mg) * acc[i * D + d];
    }
    out[(size_t)blockIdx.x * D + d] = from_f32<T>(o * inv_l);
  }
}

extern "C" int paged_decode_smem_bytes(int rep, int D, int bs) {
  return (int)sizeof(float) *
         (2 * rep * D + bs * (2 * D + 1) + rep * bs + 3 * rep);
}

extern "C" int paged_decode(const void* q, const void* cs, const void* sn,
                            const void* k_pool, const void* v_pool,
                            const void* bt, const void* pos, void* acc,
                            void* m, void* l, void* out, int B, int KVH,
                            int rep, int D, int bs, int nbs, int S,
                            float scale, int dtype, void* stream) {
  if (B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int smem = paged_decode_smem_bytes(rep, D, bs);
  const int H = KVH * rep;
  DISPATCH_DTYPE(dtype, T, {
    paged_decode_partials<T><<<dim3(B, KVH, S), PD_THREADS, smem, st>>>(
        (const T*)q, (const float*)cs, (const float*)sn, (const T*)k_pool,
        (const T*)v_pool, (const int*)bt, (const int*)pos, (float*)acc,
        (float*)m, (float*)l, KVH, rep, D, bs, nbs, S, scale);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    paged_decode_combine<T><<<B * H, PD_THREADS, 0, st>>>(
        (const float*)acc, (const float*)m, (const float*)l, (T*)out, S, H,
        D);
  });
  return (int)cudaGetLastError();
}
