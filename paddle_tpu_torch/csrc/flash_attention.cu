// FlashAttention forward and backward over [B, H, T, D] views whose last
// axis is contiguous (the strides of the other three are arguments, so
// the model's [B, T, H, D] tensors go in without a transpose), with
// grouped-query attention done in place: query head h reads kv head
// h / (H / KVH), and dK/dV sum over each kv head's group inside the
// kernel.  Causal masking is bottom-right: query i sees key j iff
// j <= i + (Tk - Tq); the wrapper refuses causal Tq > Tk (rows with no
// visible key).
//
// Replaces paddle_tpu/kernels/flash_attention.py:
//   flash_fwd<WRITE_LSE=false>  _fwd_kernel      (pallas_call :216)
//   flash_fwd<WRITE_LSE=true>   _fwd_kernel_lse  (pallas_call :254)
//   flash_bwd_dq                _bwd_dq_kernel   (pallas_call :306)
//   flash_bwd_dkv               _bwd_dkv_kernel  (pallas_call :324)
// The TPU grid carried the softmax state (and the dQ / dK / dV sums)
// from one sequential grid step to the next; here a block owns a tile of
// rows and loops over the other axis itself.  Tiles wholly above the
// causal diagonal are skipped, not masked; ragged tails are masked, so
// any T runs (the TPU version fell back to XLA for untileable T).
// Masked keys get weight exactly 0, and every row sees key 0, so the
// running max is finite after the first tile.  lse/delta are plain
// [B, H, Tq] f32 rows (the TPU's 128-lane broadcast is not carried over).
//
// Bound on the H100: operations (forward 2 products of Tq*Tk*D per head,
// dQ 3, dK/dV 4, halved by the causal mask), at Llama-3-8B's T = 8192.
// - bf16 (the trained model): FlashAttention-2 on the tensor cores with
//   mma.sync m16n8k16 (bf16 in, f32 out), 4 warps a block, 16 rows a
//   warp, operand tiles staged in shared memory without copy/compute
//   overlap.  S, P and dS are f32 in registers; P and dS are rounded to
//   bf16 as the A operand of the second product, as FlashAttention-2
//   does (the plain version keeps them in f32, as the TPU kernels do).
//   Forward and dQ own 64 query rows a block (dQ: keys 32 at a time, to
//   keep S, dP and dQ in registers); dK/dV own 64 key rows of one kv
//   head and walk every query head of its group, 32 query rows at a
//   time, with K and V read from shared memory (dynamic, 52 KB).
// - f32 (the CPU-scale check configuration): CUDA cores, 16 rows and 16
//   columns a tile, 8 threads a row.
#include <cstdint>

#include "common.cuh"

struct FAParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;    // dO (backward)
  void* out;           // O (forward)
  float* lse;          // [B, H, Tq]: written by the forward, read back
  const float* delta;  // [B, H, Tq] rowsum(dO * O) (backward)
  void* dq;
  void* dk;
  void* dv;
  int B, H, KVH, Tq, Tk, D;
  int64_t qsb, qsh, qst;  // strides of q, O, dO, dQ
  int64_t ksb, ksh, kst;  // strides of k, v, dK, dV
  int causal;
  float scale;
};

__device__ __forceinline__ int64_t q_off(const FAParams& p, int b, int h,
                                         int t) {
  return b * p.qsb + h * p.qsh + t * p.qst;
}
__device__ __forceinline__ int64_t k_off(const FAParams& p, int b, int h,
                                         int t) {
  return b * p.ksb + h * p.ksh + t * p.kst;
}
// keys [0, key_limit) are visible to query row i (i < Tq)
__device__ __forceinline__ int key_limit(const FAParams& p, int i) {
  return p.causal ? min(p.Tk, i + (p.Tk - p.Tq) + 1) : p.Tk;
}

// ------------------------------------------------------------- f32 path
constexpr int F_THREADS = 128;
constexpr int F_ROWS = 16;                     // rows a tile
constexpr int F_COLS = 16;                     // columns (keys / queries)
constexpr int F_PARTS = F_THREADS / F_ROWS;    // threads a row
constexpr int F_MAXD = 128;
constexpr int F_DPT = F_MAXD / F_PARTS;        // head-dim columns a thread

template <bool WRITE_LSE>
__global__ void __launch_bounds__(F_THREADS) fa_fwd_f32(FAParams p) {
  extern __shared__ float sm[];
  const int D = p.D, LD = D + 1, tid = threadIdx.x;
  const int b = blockIdx.z, h = blockIdx.y, kh = h / (p.H / p.KVH);
  const int q0 = blockIdx.x * F_ROWS;
  float* q_s = sm;                        // [F_ROWS, LD]
  float* k_s = q_s + F_ROWS * LD;         // [F_COLS, LD]
  float* v_s = k_s + F_COLS * LD;         // [F_COLS, LD]
  float* p_s = v_s + F_COLS * LD;         // [F_ROWS, F_COLS + 1]
  float* m_s = p_s + F_ROWS * (F_COLS + 1);
  float* l_s = m_s + F_ROWS;
  float* a_s = l_s + F_ROWS;
  const float* q = (const float*)p.q;
  const float* k = (const float*)p.k;
  const float* v = (const float*)p.v;

  for (int i = tid; i < F_ROWS * D; i += F_THREADS) {
    const int r = i / D, d = i % D, row = q0 + r;
    q_s[r * LD + d] = row < p.Tq ? q[q_off(p, b, h, row) + d] : 0.f;
  }
  if (tid < F_ROWS) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  const int kend = key_limit(p, min(q0 + F_ROWS, p.Tq) - 1);
  const int my_row = tid / F_PARTS, part = tid % F_PARTS;
  float acc[F_DPT];
#pragma unroll
  for (int j = 0; j < F_DPT; ++j) acc[j] = 0.f;
  __syncthreads();

  for (int kb = 0; kb < kend; kb += F_COLS) {
    for (int i = tid; i < F_COLS * D; i += F_THREADS) {
      const int c = i / D, d = i % D, key = kb + c;
      const bool in = key < p.Tk;
      k_s[c * LD + d] = in ? k[k_off(p, b, kh, key) + d] : 0.f;
      v_s[c * LD + d] = in ? v[k_off(p, b, kh, key) + d] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < F_ROWS * F_COLS; i += F_THREADS) {
      const int r = i / F_COLS, c = i % F_COLS;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(q_s[r * LD + d], k_s[c * LD + d], s);
      p_s[r * (F_COLS + 1) + c] = s * p.scale;
    }
    __syncthreads();
    if (tid < F_ROWS) {
      const int lim = key_limit(p, q0 + tid);
      float* pr = p_s + tid * (F_COLS + 1);
      float mc = m_s[tid];
      for (int c = 0; c < F_COLS; ++c)
        if (kb + c < lim) mc = fmaxf(mc, pr[c]);
      const float alpha = expf(m_s[tid] - mc);
      float sum = 0.f;
      for (int c = 0; c < F_COLS; ++c) {
        const float e = kb + c < lim ? expf(pr[c] - mc) : 0.f;
        pr[c] = e;
        sum += e;
      }
      l_s[tid] = l_s[tid] * alpha + sum;
      m_s[tid] = mc;
      a_s[tid] = alpha;
    }
    __syncthreads();
    const float alpha = a_s[my_row];
    const float* pr = p_s + my_row * (F_COLS + 1);
#pragma unroll
    for (int j = 0; j < F_DPT; ++j) {
      const int d = j * F_PARTS + part;
      if (d < D) {
        float a = acc[j] * alpha;
        for (int c = 0; c < F_COLS; ++c) a = fmaf(pr[c], v_s[c * LD + d], a);
        acc[j] = a;
      }
    }
    __syncthreads();
  }

  const int row = q0 + my_row;
  if (row < p.Tq) {
    const float l = l_s[my_row];
    float* o = (float*)p.out + q_off(p, b, h, row);
#pragma unroll
    for (int j = 0; j < F_DPT; ++j) {
      const int d = j * F_PARTS + part;
      if (d < D) o[d] = acc[j] / fmaxf(l, 1e-30f);
    }
    if (WRITE_LSE && part == 0)
      p.lse[((size_t)b * p.H + h) * p.Tq + row] =
          m_s[my_row] + logf(fmaxf(l, 1e-30f));
  }
}

__global__ void __launch_bounds__(F_THREADS) fa_bwd_dq_f32(FAParams p) {
  extern __shared__ float sm[];
  const int D = p.D, LD = D + 1, tid = threadIdx.x;
  const int b = blockIdx.z, h = blockIdx.y, kh = h / (p.H / p.KVH);
  const int q0 = blockIdx.x * F_ROWS;
  float* q_s = sm;                        // [F_ROWS, LD]
  float* do_s = q_s + F_ROWS * LD;        // [F_ROWS, LD]
  float* k_s = do_s + F_ROWS * LD;        // [F_COLS, LD]
  float* v_s = k_s + F_COLS * LD;         // [F_COLS, LD]
  float* ds_s = v_s + F_COLS * LD;        // [F_ROWS, F_COLS + 1]
  float* lse_s = ds_s + F_ROWS * (F_COLS + 1);
  float* dl_s = lse_s + F_ROWS;
  const float* q = (const float*)p.q;
  const float* k = (const float*)p.k;
  const float* v = (const float*)p.v;
  const float* dout = (const float*)p.dout;

  for (int i = tid; i < F_ROWS * D; i += F_THREADS) {
    const int r = i / D, d = i % D, row = q0 + r;
    const bool in = row < p.Tq;
    q_s[r * LD + d] = in ? q[q_off(p, b, h, row) + d] : 0.f;
    do_s[r * LD + d] = in ? dout[q_off(p, b, h, row) + d] : 0.f;
  }
  if (tid < F_ROWS) {
    const int row = q0 + tid;
    const size_t at = ((size_t)b * p.H + h) * p.Tq + row;
    lse_s[tid] = row < p.Tq ? p.lse[at] : 0.f;
    dl_s[tid] = row < p.Tq ? p.delta[at] : 0.f;
  }
  const int kend = key_limit(p, min(q0 + F_ROWS, p.Tq) - 1);
  const int my_row = tid / F_PARTS, part = tid % F_PARTS;
  float acc[F_DPT];
#pragma unroll
  for (int j = 0; j < F_DPT; ++j) acc[j] = 0.f;
  __syncthreads();

  for (int kb = 0; kb < kend; kb += F_COLS) {
    for (int i = tid; i < F_COLS * D; i += F_THREADS) {
      const int c = i / D, d = i % D, key = kb + c;
      const bool in = key < p.Tk;
      k_s[c * LD + d] = in ? k[k_off(p, b, kh, key) + d] : 0.f;
      v_s[c * LD + d] = in ? v[k_off(p, b, kh, key) + d] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < F_ROWS * F_COLS; i += F_THREADS) {
      const int r = i / F_COLS, c = i % F_COLS, row = q0 + r;
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < D; ++d) {
        s = fmaf(q_s[r * LD + d], k_s[c * LD + d], s);
        dp = fmaf(do_s[r * LD + d], v_s[c * LD + d], dp);
      }
      const bool live = row < p.Tq && kb + c < key_limit(p, row);
      const float pr = live ? expf(s * p.scale - lse_s[r]) : 0.f;
      ds_s[r * (F_COLS + 1) + c] = pr * (dp - dl_s[r]) * p.scale;
    }
    __syncthreads();
    const float* dr = ds_s + my_row * (F_COLS + 1);
#pragma unroll
    for (int j = 0; j < F_DPT; ++j) {
      const int d = j * F_PARTS + part;
      if (d < D) {
        float a = acc[j];
        for (int c = 0; c < F_COLS; ++c) a = fmaf(dr[c], k_s[c * LD + d], a);
        acc[j] = a;
      }
    }
    __syncthreads();
  }
  const int row = q0 + my_row;
  if (row < p.Tq) {
    float* dq = (float*)p.dq + q_off(p, b, h, row);
#pragma unroll
    for (int j = 0; j < F_DPT; ++j) {
      const int d = j * F_PARTS + part;
      if (d < D) dq[d] = acc[j];
    }
  }
}

__global__ void __launch_bounds__(F_THREADS) fa_bwd_dkv_f32(FAParams p) {
  extern __shared__ float sm[];
  const int D = p.D, LD = D + 1, tid = threadIdx.x;
  const int b = blockIdx.z, kh = blockIdx.y, rep = p.H / p.KVH;
  const int k0 = blockIdx.x * F_ROWS, off = p.Tk - p.Tq;
  float* k_s = sm;                        // [F_ROWS, LD] this block's keys
  float* v_s = k_s + F_ROWS * LD;
  float* q_s = v_s + F_ROWS * LD;         // [F_COLS, LD] a query tile
  float* do_s = q_s + F_COLS * LD;
  float* p_s = do_s + F_COLS * LD;        // [F_ROWS, F_COLS + 1] P^T
  float* ds_s = p_s + F_ROWS * (F_COLS + 1);
  float* lse_s = ds_s + F_ROWS * (F_COLS + 1);
  float* dl_s = lse_s + F_COLS;
  const float* q = (const float*)p.q;
  const float* k = (const float*)p.k;
  const float* v = (const float*)p.v;
  const float* dout = (const float*)p.dout;

  for (int i = tid; i < F_ROWS * D; i += F_THREADS) {
    const int r = i / D, d = i % D, key = k0 + r;
    const bool in = key < p.Tk;
    k_s[r * LD + d] = in ? k[k_off(p, b, kh, key) + d] : 0.f;
    v_s[r * LD + d] = in ? v[k_off(p, b, kh, key) + d] : 0.f;
  }
  const int my_row = tid / F_PARTS, part = tid % F_PARTS;
  float dk[F_DPT], dv[F_DPT];
#pragma unroll
  for (int j = 0; j < F_DPT; ++j) dk[j] = dv[j] = 0.f;
  // the first query row that sees any of this block's keys
  const int qstart = p.causal ? max(0, k0 - off) / F_COLS * F_COLS : 0;

  for (int r = 0; r < rep; ++r) {
    const int h = kh * rep + r;
    for (int qb = qstart; qb < p.Tq; qb += F_COLS) {
      __syncthreads();
      for (int i = tid; i < F_COLS * D; i += F_THREADS) {
        const int c = i / D, d = i % D, row = qb + c;
        const bool in = row < p.Tq;
        q_s[c * LD + d] = in ? q[q_off(p, b, h, row) + d] : 0.f;
        do_s[c * LD + d] = in ? dout[q_off(p, b, h, row) + d] : 0.f;
      }
      if (tid < F_COLS) {
        const int row = qb + tid;
        const size_t at = ((size_t)b * p.H + h) * p.Tq + row;
        lse_s[tid] = row < p.Tq ? p.lse[at] : 0.f;
        dl_s[tid] = row < p.Tq ? p.delta[at] : 0.f;
      }
      __syncthreads();
      for (int i = tid; i < F_ROWS * F_COLS; i += F_THREADS) {
        const int kr = i / F_COLS, c = i % F_COLS, key = k0 + kr,
                  row = qb + c;
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < D; ++d) {
          s = fmaf(q_s[c * LD + d], k_s[kr * LD + d], s);
          dp = fmaf(do_s[c * LD + d], v_s[kr * LD + d], dp);
        }
        const bool live =
            row < p.Tq && key < p.Tk && key < key_limit(p, row);
        const float pr = live ? expf(s * p.scale - lse_s[c]) : 0.f;
        p_s[kr * (F_COLS + 1) + c] = pr;
        ds_s[kr * (F_COLS + 1) + c] = pr * (dp - dl_s[c]) * p.scale;
      }
      __syncthreads();
      const float* pr = p_s + my_row * (F_COLS + 1);
      const float* dr = ds_s + my_row * (F_COLS + 1);
#pragma unroll
      for (int j = 0; j < F_DPT; ++j) {
        const int d = j * F_PARTS + part;
        if (d < D) {
          float a = dv[j], c2 = dk[j];
          for (int c = 0; c < F_COLS; ++c) {
            a = fmaf(pr[c], do_s[c * LD + d], a);
            c2 = fmaf(dr[c], q_s[c * LD + d], c2);
          }
          dv[j] = a;
          dk[j] = c2;
        }
      }
    }
  }
  const int key = k0 + my_row;
  if (key < p.Tk) {
    float* dkr = (float*)p.dk + k_off(p, b, kh, key);
    float* dvr = (float*)p.dv + k_off(p, b, kh, key);
#pragma unroll
    for (int j = 0; j < F_DPT; ++j) {
      const int d = j * F_PARTS + part;
      if (d < D) {
        dkr[d] = dk[j];
        dvr[d] = dv[j];
      }
    }
  }
}

// ------------------------------------------------ bf16, tensor cores
constexpr int T_THREADS = 128;   // 4 warps, 16 rows each
constexpr int T_ROWS = 64;       // rows a block
constexpr int FWD_KEYS = 64;     // key tile of the forward
constexpr int DQ_KEYS = 32;      // key tile of dQ
constexpr int DKV_QROWS = 32;    // query tile of dK/dV

// Fragment layouts (m16n8k16): lane = 4 g + tg holds rows g and g + 8;
// A pairs of k at 2 tg (and + 8), B pairs of k at 2 tg for column g, C
// columns 2 tg and 2 tg + 1.  The C fragments of two neighbouring n-tiles
// are the A fragment of one 16-deep k step (P and dS feed the second
// product that way).  Shared rows are padded to D + 8 bf16, which puts
// the 8 rows of a fragment load on distinct banks.

// A fragment of 16 rows x 16 columns at (row0, col0) of a row-major bf16
// array with leading dimension ld (global or shared)
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* base,
                                       int64_t ld, int g, int tg,
                                       bool live0, bool live1) {
  a[0] = live0 ? ld_pair(base + g * ld + 2 * tg) : 0u;
  a[1] = live1 ? ld_pair(base + (g + 8) * ld + 2 * tg) : 0u;
  a[2] = live0 ? ld_pair(base + g * ld + 2 * tg + 8) : 0u;
  a[3] = live1 ? ld_pair(base + (g + 8) * ld + 2 * tg + 8) : 0u;
}

// stage rows [r0, r0 + n) of a [T, D] bf16 operand (row stride st) into
// shared rows of D + 8; rows at or past T are zero
template <int D>
__device__ __forceinline__ void stage(bf16 (*dst)[D + 8], const bf16* src,
                                      int64_t st, int r0, int n, int T) {
  for (int i = threadIdx.x; i < n * (D / 8); i += T_THREADS) {
    const int j = i / (D / 8), d = (i % (D / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + j < T)
      val = *reinterpret_cast<const uint4*>(src + (r0 + j) * st + d);
    *reinterpret_cast<uint4*>(&dst[j][d]) = val;
  }
}

template <int D, bool WRITE_LSE>
__global__ void __launch_bounds__(T_THREADS) fa_fwd_bf16(FAParams p) {
  __shared__ __align__(16) bf16 Ks[FWD_KEYS][D + 8];
  __shared__ __align__(16) bf16 Vs[FWD_KEYS][D + 8];
  const int b = blockIdx.z, h = blockIdx.y, kh = h / (p.H / p.KVH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tg = lane % 4;
  const int q0 = blockIdx.x * T_ROWS, wrow = q0 + warp * 16;
  int row[2], lim[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = wrow + g + 8 * i;
    lim[i] = row[i] < p.Tq ? key_limit(p, row[i]) : 0;
  }
  const bf16* q = (const bf16*)p.q + q_off(p, b, h, wrow);
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    load_a(qf[ks], q + ks * 16, p.qst, g, tg, row[0] < p.Tq, row[1] < p.Tq);
  float o[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[nd][c] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  const bf16* kp = (const bf16*)p.k + k_off(p, b, kh, 0);
  const bf16* vp = (const bf16*)p.v + k_off(p, b, kh, 0);
  const int kend = key_limit(p, min(q0 + T_ROWS, p.Tq) - 1);
  for (int kb = 0; kb < kend; kb += FWD_KEYS) {
    stage<D>(Ks, kp, p.kst, kb, FWD_KEYS, p.Tk);
    stage<D>(Vs, vp, p.kst, kb, FWD_KEYS, p.Tk);
    __syncthreads();

    float s[FWD_KEYS / 8][4];
#pragma unroll
    for (int j = 0; j < FWD_KEYS / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
      for (int j = 0; j < FWD_KEYS / 8; ++j) {
        const uint32_t kf[2] = {ld_pair(&Ks[j * 8 + g][ks * 16 + 2 * tg]),
                                ld_pair(&Ks[j * 8 + g][ks * 16 + 2 * tg + 8])};
        mma_bf16(s[j], qf[ks], kf);
      }
    // scale and mask in f32, then the online softmax of rows g, g + 8
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < FWD_KEYS / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = kb + j * 8 + 2 * tg + (c & 1);
        s[j][c] = key < lim[c / 2] ? s[j][c] * p.scale : NEG_INF;
        mx[c / 2] = fmaxf(mx[c / 2], s[j][c]);
      }
    float alpha[2], lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = expf(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int j = 0; j < FWD_KEYS / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = kb + j * 8 + 2 * tg + (c & 1);
        const float e = key < lim[c / 2] ? expf(s[j][c] - m[c / 2]) : 0.f;
        s[j][c] = e;
        lsum[c / 2] += e;
      }
    // this lane's share of each row sum; the 4 lanes meet at the end
    l[0] = l[0] * alpha[0] + lsum[0];
    l[1] = l[1] * alpha[1] + lsum[1];
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[nd][c] *= alpha[c / 2];
#pragma unroll
    for (int kk = 0; kk < FWD_KEYS / 16; ++kk) {
      const uint32_t pf[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        uint32_t vf[2];
        ldsm_x2_trans(vf, &Vs[kk * 16 + lane % 16][nd * 8]);
        mma_bf16(o[nd], pf, vf);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= p.Tq) continue;
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
    bf16* orow = (bf16*)p.out + q_off(p, b, h, row[i]);
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<__nv_bfloat162*>(orow + nd * 8 + 2 * tg) =
          __floats2bfloat162_rn(o[nd][2 * i] * inv_l,
                                o[nd][2 * i + 1] * inv_l);
    if (WRITE_LSE && tg == 0)
      p.lse[((size_t)b * p.H + h) * p.Tq + row[i]] =
          m[i] + logf(fmaxf(l[i], 1e-30f));
  }
}

template <int D>
__global__ void __launch_bounds__(T_THREADS) fa_bwd_dq_bf16(FAParams p) {
  __shared__ __align__(16) bf16 Ks[DQ_KEYS][D + 8];
  __shared__ __align__(16) bf16 Vs[DQ_KEYS][D + 8];
  const int b = blockIdx.z, h = blockIdx.y, kh = h / (p.H / p.KVH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tg = lane % 4;
  const int q0 = blockIdx.x * T_ROWS, wrow = q0 + warp * 16;
  int row[2], lim[2];
  float lse[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = wrow + g + 8 * i;
    const bool in = row[i] < p.Tq;
    const size_t at = ((size_t)b * p.H + h) * p.Tq + row[i];
    lim[i] = in ? key_limit(p, row[i]) : 0;
    lse[i] = in ? p.lse[at] : 0.f;
    dl[i] = in ? p.delta[at] : 0.f;
  }
  const bool in0 = row[0] < p.Tq, in1 = row[1] < p.Tq;
  const bf16* q = (const bf16*)p.q + q_off(p, b, h, wrow);
  const bf16* dout = (const bf16*)p.dout + q_off(p, b, h, wrow);
  uint32_t qf[D / 16][4], df[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    load_a(qf[ks], q + ks * 16, p.qst, g, tg, in0, in1);
    load_a(df[ks], dout + ks * 16, p.qst, g, tg, in0, in1);
  }
  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nd][c] = 0.f;

  const bf16* kp = (const bf16*)p.k + k_off(p, b, kh, 0);
  const bf16* vp = (const bf16*)p.v + k_off(p, b, kh, 0);
  const int kend = key_limit(p, min(q0 + T_ROWS, p.Tq) - 1);
  for (int kb = 0; kb < kend; kb += DQ_KEYS) {
    stage<D>(Ks, kp, p.kst, kb, DQ_KEYS, p.Tk);
    stage<D>(Vs, vp, p.kst, kb, DQ_KEYS, p.Tk);
    __syncthreads();
    float s[DQ_KEYS / 8][4], dp[DQ_KEYS / 8][4];
#pragma unroll
    for (int j = 0; j < DQ_KEYS / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = dp[j][c] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
      for (int j = 0; j < DQ_KEYS / 8; ++j) {
        const uint32_t kf[2] = {ld_pair(&Ks[j * 8 + g][ks * 16 + 2 * tg]),
                                ld_pair(&Ks[j * 8 + g][ks * 16 + 2 * tg + 8])};
        const uint32_t vf[2] = {ld_pair(&Vs[j * 8 + g][ks * 16 + 2 * tg]),
                                ld_pair(&Vs[j * 8 + g][ks * 16 + 2 * tg + 8])};
        mma_bf16(s[j], qf[ks], kf);
        mma_bf16(dp[j], df[ks], vf);
      }
    // dS = P * (dP - delta) * scale with P = exp(S * scale - lse)
#pragma unroll
    for (int j = 0; j < DQ_KEYS / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = kb + j * 8 + 2 * tg + (c & 1), i = c / 2;
        const float pr = key < lim[i] ? expf(s[j][c] * p.scale - lse[i]) : 0.f;
        s[j][c] = pr * (dp[j][c] - dl[i]) * p.scale;
      }
    // dQ += dS K
#pragma unroll
    for (int kk = 0; kk < DQ_KEYS / 16; ++kk) {
      const uint32_t af[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        uint32_t bfr[2];
        ldsm_x2_trans(bfr, &Ks[kk * 16 + lane % 16][nd * 8]);
        mma_bf16(acc[nd], af, bfr);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= p.Tq) continue;
    bf16* dq = (bf16*)p.dq + q_off(p, b, h, row[i]);
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<__nv_bfloat162*>(dq + nd * 8 + 2 * tg) =
          __floats2bfloat162_rn(acc[nd][2 * i], acc[nd][2 * i + 1]);
  }
}

template <int D>
constexpr int dkv_smem_bytes() {
  return (2 * T_ROWS + 2 * DKV_QROWS) * (D + 8) * 2 + 2 * DKV_QROWS * 4;
}

template <int D>
__global__ void __launch_bounds__(T_THREADS) fa_bwd_dkv_bf16(FAParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  typedef bf16 Row[D + 8];
  Row* Ks = reinterpret_cast<Row*>(smem_raw);     // [T_ROWS] this block's keys
  Row* Vs = Ks + T_ROWS;                          // [T_ROWS]
  Row* Qs = Vs + T_ROWS;                          // [DKV_QROWS] a query tile
  Row* Ds = Qs + DKV_QROWS;                       // [DKV_QROWS] its dO rows
  float* lse_s = reinterpret_cast<float*>(Ds + DKV_QROWS);
  float* dl_s = lse_s + DKV_QROWS;
  const int b = blockIdx.z, kh = blockIdx.y, rep = p.H / p.KVH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tg = lane % 4;
  const int k0 = blockIdx.x * T_ROWS, off = p.Tk - p.Tq;
  const int wkey = warp * 16;           // this warp's keys within the block
  int key[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) key[i] = k0 + wkey + g + 8 * i;

  stage<D>(Ks, (const bf16*)p.k + k_off(p, b, kh, 0), p.kst, k0, T_ROWS,
           p.Tk);
  stage<D>(Vs, (const bf16*)p.v + k_off(p, b, kh, 0), p.kst, k0, T_ROWS,
           p.Tk);
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[nd][c] = dv[nd][c] = 0.f;
  // the first query row that sees any of this block's keys
  const int qstart =
      p.causal ? max(0, k0 - off) / DKV_QROWS * DKV_QROWS : 0;

  for (int r = 0; r < rep; ++r) {
    const int h = kh * rep + r;
    const bf16* qh = (const bf16*)p.q + q_off(p, b, h, 0);
    const bf16* dh = (const bf16*)p.dout + q_off(p, b, h, 0);
    const size_t rows_at = ((size_t)b * p.H + h) * p.Tq;
    for (int qb = qstart; qb < p.Tq; qb += DKV_QROWS) {
      __syncthreads();
      stage<D>(Qs, qh, p.qst, qb, DKV_QROWS, p.Tq);
      stage<D>(Ds, dh, p.qst, qb, DKV_QROWS, p.Tq);
      if (threadIdx.x < DKV_QROWS) {
        const int qr = qb + threadIdx.x;
        lse_s[threadIdx.x] = qr < p.Tq ? p.lse[rows_at + qr] : 0.f;
        dl_s[threadIdx.x] = qr < p.Tq ? p.delta[rows_at + qr] : 0.f;
      }
      __syncthreads();
      // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys
      float st[DKV_QROWS / 8][4], dpt[DKV_QROWS / 8][4];
#pragma unroll
      for (int j = 0; j < DKV_QROWS / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) st[j][c] = dpt[j][c] = 0.f;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        uint32_t kf[4], vf[4];
        load_a(kf, &Ks[wkey][ks * 16], D + 8, g, tg, true, true);
        load_a(vf, &Vs[wkey][ks * 16], D + 8, g, tg, true, true);
#pragma unroll
        for (int j = 0; j < DKV_QROWS / 8; ++j) {
          const uint32_t qf[2] = {ld_pair(&Qs[j * 8 + g][ks * 16 + 2 * tg]),
                                  ld_pair(&Qs[j * 8 + g][ks * 16 + 2 * tg + 8])};
          const uint32_t df[2] = {ld_pair(&Ds[j * 8 + g][ks * 16 + 2 * tg]),
                                  ld_pair(&Ds[j * 8 + g][ks * 16 + 2 * tg + 8])};
          mma_bf16(st[j], kf, qf);
          mma_bf16(dpt[j], vf, df);
        }
      }
      // P^T and dS^T; column c of tile j is query qb + j * 8 + 2 tg + (c & 1)
#pragma unroll
      for (int j = 0; j < DKV_QROWS / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int qc = j * 8 + 2 * tg + (c & 1), qr = qb + qc;
          const int kr = key[c / 2];
          const bool live = qr < p.Tq && kr < p.Tk && kr < key_limit(p, qr);
          const float pr =
              live ? expf(st[j][c] * p.scale - lse_s[qc]) : 0.f;
          st[j][c] = pr;
          dpt[j][c] = pr * (dpt[j][c] - dl_s[qc]) * p.scale;
        }
      // dV += P^T dO and dK += dS^T Q, 16 queries a k step
#pragma unroll
      for (int kk = 0; kk < DKV_QROWS / 16; ++kk) {
        const uint32_t pf[4] = {pack_bf16(st[2 * kk][0], st[2 * kk][1]),
                                pack_bf16(st[2 * kk][2], st[2 * kk][3]),
                                pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                                pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3])};
        const uint32_t sf[4] = {
            pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]),
            pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]),
            pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
            pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd) {
          uint32_t bfr[2];
          ldsm_x2_trans(bfr, &Ds[kk * 16 + lane % 16][nd * 8]);
          mma_bf16(dv[nd], pf, bfr);
          ldsm_x2_trans(bfr, &Qs[kk * 16 + lane % 16][nd * 8]);
          mma_bf16(dk[nd], sf, bfr);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= p.Tk) continue;
    bf16* dkr = (bf16*)p.dk + k_off(p, b, kh, key[i]);
    bf16* dvr = (bf16*)p.dv + k_off(p, b, kh, key[i]);
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      *reinterpret_cast<__nv_bfloat162*>(dkr + nd * 8 + 2 * tg) =
          __floats2bfloat162_rn(dk[nd][2 * i], dk[nd][2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvr + nd * 8 + 2 * tg) =
          __floats2bfloat162_rn(dv[nd][2 * i], dv[nd][2 * i + 1]);
    }
  }
}

// ------------------------------------------------------------ C entry
static int f32_smem(int D, int kind) {
  const int LD = D + 1;
  const int tile = F_ROWS * (F_COLS + 1);
  if (kind == 0) return 4 * ((F_ROWS + 2 * F_COLS) * LD + tile + 3 * F_ROWS);
  if (kind == 1)
    return 4 * ((2 * F_ROWS + 2 * F_COLS) * LD + tile + 2 * F_ROWS);
  return 4 * ((2 * F_ROWS + 2 * F_COLS) * LD + 2 * tile + 2 * F_COLS);
}

static FAParams make_params(const void* q, const void* k, const void* v,
                            int B, int H, int KVH, int Tq, int Tk, int D,
                            int64_t qsb, int64_t qsh, int64_t qst,
                            int64_t ksb, int64_t ksh, int64_t kst,
                            int causal, float scale) {
  FAParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.B = B;
  p.H = H;
  p.KVH = KVH;
  p.Tq = Tq;
  p.Tk = Tk;
  p.D = D;
  p.qsb = qsb;
  p.qsh = qsh;
  p.qst = qst;
  p.ksb = ksb;
  p.ksh = ksh;
  p.kst = kst;
  p.causal = causal;
  p.scale = scale;
  return p;
}

// the operands every entry point refuses: the wrapper checks them too
static bool bad_shape(int H, int KVH, int Tq, int Tk, int D, int causal,
                      int dtype) {
  if (KVH <= 0 || H % KVH || (causal && Tq > Tk)) return true;
  if (dtype != 0 && dtype != 1) return true;
  if (dtype == 0) return D > F_MAXD;
  return !(D == 64 || D == 128);
}

#define FA_ARGS                                                         \
  int B, int H, int KVH, int Tq, int Tk, int D, int64_t qsb, int64_t qsh, \
      int64_t qst, int64_t ksb, int64_t ksh, int64_t kst, int causal,     \
      float scale, int dtype, void* stream

// O (and, with lse != nullptr, the f32 LSE rows)
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, float* lse, FA_ARGS) {
  if (B == 0 || H == 0 || Tq == 0) return 0;
  if (bad_shape(H, KVH, Tq, Tk, D, causal, dtype) || Tk == 0)
    return (int)cudaErrorInvalidValue;
  FAParams p = make_params(q, k, v, B, H, KVH, Tq, Tk, D, qsb, qsh, qst, ksb,
                           ksh, kst, causal, scale);
  p.out = out;
  p.lse = lse;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    const dim3 grid((Tq + F_ROWS - 1) / F_ROWS, H, B);
    const int smem = f32_smem(D, 0);
    if (lse)
      fa_fwd_f32<true><<<grid, F_THREADS, smem, st>>>(p);
    else
      fa_fwd_f32<false><<<grid, F_THREADS, smem, st>>>(p);
  } else {
    const dim3 grid((Tq + T_ROWS - 1) / T_ROWS, H, B);
    auto kernel = D == 64 ? (lse ? fa_fwd_bf16<64, true> : fa_fwd_bf16<64, false>)
                          : (lse ? fa_fwd_bf16<128, true> : fa_fwd_bf16<128, false>);
    kernel<<<grid, T_THREADS, 0, st>>>(p);
  }
  return (int)cudaGetLastError();
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dq, FA_ARGS) {
  if (B == 0 || H == 0 || Tq == 0) return 0;
  if (bad_shape(H, KVH, Tq, Tk, D, causal, dtype) || Tk == 0)
    return (int)cudaErrorInvalidValue;
  FAParams p = make_params(q, k, v, B, H, KVH, Tq, Tk, D, qsb, qsh, qst, ksb,
                           ksh, kst, causal, scale);
  p.dout = dout;
  p.lse = const_cast<float*>(lse);
  p.delta = delta;
  p.dq = dq;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    const dim3 grid((Tq + F_ROWS - 1) / F_ROWS, H, B);
    fa_bwd_dq_f32<<<grid, F_THREADS, f32_smem(D, 1), st>>>(p);
  } else {
    const dim3 grid((Tq + T_ROWS - 1) / T_ROWS, H, B);
    if (D == 64)
      fa_bwd_dq_bf16<64><<<grid, T_THREADS, 0, st>>>(p);
    else
      fa_bwd_dq_bf16<128><<<grid, T_THREADS, 0, st>>>(p);
  }
  return (int)cudaGetLastError();
}

template <int D>
static int launch_dkv_bf16(const FAParams& p, cudaStream_t st) {
  constexpr int smem = dkv_smem_bytes<D>();
  const cudaError_t e = cudaFuncSetAttribute(
      fa_bwd_dkv_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.Tk + T_ROWS - 1) / T_ROWS, p.KVH, p.B);
  fa_bwd_dkv_bf16<D><<<grid, T_THREADS, smem, st>>>(p);
  return 0;
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dk, void* dv,
                             FA_ARGS) {
  if (B == 0 || KVH == 0 || Tk == 0) return 0;
  if (bad_shape(H, KVH, Tq, Tk, D, causal, dtype))
    return (int)cudaErrorInvalidValue;
  FAParams p = make_params(q, k, v, B, H, KVH, Tq, Tk, D, qsb, qsh, qst, ksb,
                           ksh, kst, causal, scale);
  p.dout = dout;
  p.lse = const_cast<float*>(lse);
  p.delta = delta;
  p.dk = dk;
  p.dv = dv;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    const dim3 grid((Tk + F_ROWS - 1) / F_ROWS, KVH, B);
    fa_bwd_dkv_f32<<<grid, F_THREADS, f32_smem(D, 2), st>>>(p);
  } else {
    const int err = D == 64 ? launch_dkv_bf16<64>(p, st)
                            : launch_dkv_bf16<128>(p, st);
    if (err) return err;
  }
  return (int)cudaGetLastError();
}
