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
// (bf16: fa_fwd_wgmma, fa_bwd_dq_wgmma, fa_bwd_dkv_wgmma; f32: fa_*_f32)
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
// - bf16 (the trained model), forward: a warp-specialized Hopper kernel
//   (fa_fwd_wgmma, below: TMA loads of Q once and of K/V tiles of 128
//   keys into a 2-stage mbarrier ring, wgmma for both products, two
//   consumer warpgroups of 64 query rows); at T = 8192, 32/8 heads,
//   D = 128 its bound is 0.556 ms of operations.  The mma.sync kernel it
//   replaces copied each 64-key tile with all threads between two
//   barriers, without overlap, on 4 warps and 64 rows a block, and ran
//   at 9.7 % of that bound (5.7 ms against SDPA's 0.88).  P is rounded
//   to bf16 as the A operand of the second product, as FlashAttention-2
//   does (the plain version keeps it in f32, as the TPU kernels do).
// - bf16 backward, dQ: a warp-specialized Hopper kernel
//   (fa_bwd_dq_wgmma, below: 128 query rows a block with Q and dO held
//   in shared memory, K/V tiles of 64 keys by TMA through a 3-stage
//   ring, wgmma for all three products, dQ in registers to the end, so
//   no atomics).  At T = 8192, 32/8 heads, D = 128 its bound is 0.834
//   ms of operations; the mma.sync kernel it replaces (4 warps, 64 rows
//   a block, Q and dO fragments from device memory, 32-key tiles staged
//   between two barriers) ran at 16 % of it.
// - bf16 backward, dK/dV: a warp-specialized Hopper kernel
//   (fa_bwd_dkv_wgmma, below: 128 keys a block held in shared memory,
//   Q/dO tiles by TMA through a 3-stage ring, wgmma for all four
//   products, dK and dV in registers to the end, so no atomics).  At T =
//   8192, 32/8 heads, D = 128 its bound is 1.112 ms of operations; the
//   mma.sync kernel it replaces (4 warps, 64 keys, 32-query tiles staged
//   between two barriers, the mask on every tile) ran at 14 % of it.
//   In the backward kernels, P and dS are f32 in registers and rounded
//   to bf16 where they feed a second product, as FlashAttention-2 does.
// - f32 (the CPU-scale check configuration): CUDA cores, 16 rows and 16
//   columns a tile, 8 threads a row.
#include <cmath>
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

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

// --------------------------------------- bf16 forward (wgmma + TMA)
// A block owns 128 query rows of one (batch, head): warpgroups 0 and 1
// consume 64 rows each, warpgroup 2 produces.  One producer thread loads
// the Q tile once, then K and V tiles of 128 keys into a 2-stage ring,
// by TMA from 4-D tensor maps over the [B, H, T, D] strides, 128-byte
// swizzled (D / 64 boxes of [128 rows][64] a tile), with a full barrier
// for K and one for V (S can start before V lands) and an empty barrier
// a stage.  A consumer computes S = Q K^T with wgmma m64n128k16 from
// shared memory (both K-major), the online softmax in f32 on its
// registers with exp2 and scale * log2(e) folded into one multiply-add
// (only tiles that reach past the diagonal, a ragged end or rows past Tq
// are masked; tiles above the diagonal are never loaded), rescales O,
// rounds P to bf16 in the A-fragment layout, and issues O += P V with P
// from registers and V, MN-major, from shared memory.  Blocks run the
// longest causal query tiles first, the query heads of one kv head
// adjacent, so their K and V tiles come from L2.
constexpr int FA_BM = 128, FA_BN = 128, FA_THREADS = 384;
constexpr int FA_BOX = 128 * 64 * 2;            // [128 rows][64] bf16

struct FAMaps {
  CUtensorMap q, k, v;   // [B, H, T, D] as (D, T, H, B), box (64, 128, 1, 1)
};

template <int D>
constexpr int fa_fwd_smem() {
  return 5 * (D / 64) * FA_BOX + 1024 + 7 * 8;   // Q, 2 K and 2 V stages
}

template <int D, bool WRITE_LSE>
__global__ void __launch_bounds__(FA_THREADS, 1)
    fa_fwd_wgmma(const __grid_constant__ FAMaps maps, FAParams p) {
  using namespace hopper;
  constexpr int TILE = (D / 64) * FA_BOX;       // one Q, K or V tile
  extern __shared__ uint8_t fwd_smem[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(fwd_smem) + 1023) & ~uintptr_t(1023));
  uint8_t* qs = smem;
  uint8_t* ks = qs + TILE;                      // 2 stages
  uint8_t* vs = ks + 2 * TILE;                  // 2 stages
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + 2 * TILE);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 3;
  uint64_t* empty = bars + 5;

  const int n_qt = (p.Tq + FA_BM - 1) / FA_BM;
  const int h = blockIdx.x % p.H, rest = blockIdx.x / p.H;
  const int b = rest % p.B, rank = rest / p.B;
  const int qt = p.causal ? n_qt - 1 - rank : rank;
  const int kh = h / (p.H / p.KVH), q0 = qt * FA_BM;
  const int kend = key_limit(p, min(q0 + FA_BM, p.Tq) - 1);
  const int n_kt = (kend + FA_BN - 1) / FA_BN;
  // tiles from here on need the mask: keys some row of the block may not
  // see (rows past Tq see none)
  const int mask_from = q0 + FA_BM > p.Tq ? 0 : key_limit(p, q0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 8);   // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ------------------------------------------------------ producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, TILE);
#pragma unroll
      for (int x = 0; x < D / 64; ++x)
        tma_load_4d(qs + x * FA_BOX, &maps.q, q_full, x * 64, q0, h, b);
      for (int it = 0; it < n_kt; ++it) {
        const int s = it & 1;
        if (it >= 2) mbar_wait(&empty[s], ((it >> 1) - 1) & 1);
        mbar_expect_tx(&k_full[s], TILE);
#pragma unroll
        for (int x = 0; x < D / 64; ++x)
          tma_load_4d(ks + s * TILE + x * FA_BOX, &maps.k, &k_full[s],
                      x * 64, it * FA_BN, kh, b);
        mbar_expect_tx(&v_full[s], TILE);
#pragma unroll
        for (int x = 0; x < D / 64; ++x)
          tma_load_4d(vs + s * TILE + x * FA_BOX, &maps.v, &v_full[s],
                      x * 64, it * FA_BN, kh, b);
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    setmaxnreg_inc<232>();
    const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32, g = lane / 4, tg = lane % 4;
    int row[2], lim[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      row[i] = q0 + wg * 64 + warp * 16 + g + 8 * i;
      lim[i] = row[i] < p.Tq ? key_limit(p, row[i]) : 0;
    }
    const float scale_log2 = p.scale * 1.4426950408889634f;
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // m in log2 units
    const uint32_t qa = smem_u32(qs) + wg * 64 * 128;
    mbar_wait(q_full, 0);

    for (int it = 0; it < n_kt; ++it) {
      const int s = it & 1, kb = it * FA_BN;
      const uint32_t parity = (it >> 1) & 1;
      const uint32_t ka = smem_u32(ks + s * TILE);
      const uint32_t va = smem_u32(vs + s * TILE);
      float sc[FA_BN / 2];
#pragma unroll
      for (int i = 0; i < FA_BN / 2; ++i) sc[i] = 0.f;
      mbar_wait(&k_full[s], parity);
      wgmma_fence();
      fence_regs<FA_BN / 2>(sc);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * FA_BOX + (kk % 4) * 32;
        wgmma_ss_n128<0>(sc, desc_sw128(qa + off, 16, 1024),
                         desc_sw128(ka + off, 16, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<FA_BN / 2>(sc);

      // sc[4 j + 2 i + c]: row g + 8 i, key kb + 8 j + 2 tg + c
      if (kb + FA_BN > mask_from) {
#pragma unroll
        for (int j = 0; j < FA_BN / 8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (kb + 8 * j + 2 * tg + (c & 1) >= lim[c >> 1])
              sc[4 * j + c] = -INFINITY;
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < FA_BN / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          mx[c >> 1] = fmaxf(mx[c >> 1], sc[4 * j + c]);
      float alpha[2], lsum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float mn = fmaxf(m[i], mx[i] * scale_log2);
        alpha[i] = exp2f(m[i] - mn);
        m[i] = mn;
      }
#pragma unroll
      for (int j = 0; j < FA_BN / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float e = exp2f(fmaf(sc[4 * j + c], scale_log2, -m[c >> 1]));
          sc[4 * j + c] = e;
          lsum[c >> 1] += e;
        }
      // this lane's share of each row sum; the 4 lanes meet at the end
      l[0] = l[0] * alpha[0] + lsum[0];
      l[1] = l[1] * alpha[1] + lsum[1];
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) o[4 * j + c] *= alpha[c >> 1];
      uint32_t pa[FA_BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < FA_BN / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

      mbar_wait(&v_full[s], parity);
      wgmma_fence();
      fence_regs<D / 2>(o);
#pragma unroll
      for (int kk = 0; kk < FA_BN / 16; ++kk) {
        const uint64_t dv = desc_sw128(va + kk * 16 * 128, FA_BOX, 1024);
        if constexpr (D == 128)
          wgmma_rs_n128<1>(o, pa[kk], dv, 1);
        else
          wgmma_rs_n64<1>(o, pa[kk], dv, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<D / 2>(o);
      if (lane == 0) mbar_arrive(&empty[s]);
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
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * tg) =
            pack_bf16(o[4 * j + 2 * i] * inv_l, o[4 * j + 2 * i + 1] * inv_l);
      if (WRITE_LSE && tg == 0)
        p.lse[((size_t)b * p.H + h) * p.Tq + row[i]] =
            (m[i] + log2f(fmaxf(l[i], 1e-30f))) * 0.6931471805599453f;
    }
  }
}

// --------------------------------------- bf16 dK/dV (wgmma + TMA)
// A block owns 128 keys of one (batch, kv head): warpgroups 0 and 1
// hold 64 keys each and their dK and dV sums in f32 registers to the
// end (no atomics: the result's bits do not depend on timing), and
// warpgroup 2 produces.  One producer thread loads the block's K and V
// once, then, for each query head of the group, 64-row tiles of Q and
// dO into a 3-stage ring, by TMA from 4-D tensor maps over the
// [B, H, T, D] strides (128-byte swizzled, D / 64 boxes a tile); the
// producer warp's lanes copy the tile's lse (times log2 e) and delta
// rows beside them.  A consumer warpgroup computes S^T = K Q^T and
// dP^T = V dO^T by wgmma m64n64k16 from shared memory (all K-major),
// P^T = exp2(S^T scale log2 e - lse log2 e) and dS^T = P^T (dP^T -
// delta) scale in f32 registers (the mask only on tiles that straddle
// the diagonal or the ragged end; tiles wholly above the diagonal are
// skipped), rounds P^T and dS^T to bf16 in the A-fragment layout, and
// issues dV += P^T dO and dK += dS^T Q with Q and dO read MN-major.
// Blocks of the first keys, which see the most queries, launch first.
constexpr int DKV_BN = 128, DKV_BM = 64, DKV_THREADS = 384, DKV_STAGES = 3;
constexpr int DKV_KBOX = 128 * 128;   // [128 rows][64] bf16
constexpr int DKV_QBOX = 64 * 128;    // [64 rows][64] bf16

// the backward's tensor maps (bwd_maps): dK/dV's boxes are (64, 64, 1,
// 1) for q and dO and (64, 128, 1, 1) for k and v; dQ's the other way
struct DKVMaps {
  CUtensorMap q, dout;   // [B, H, Tq, D] as (D, T, H, B)
  CUtensorMap k, v;      // [B, KVH, Tk, D]
};

template <int D>
constexpr int fa_dkv_smem() {
  // alignment; K, V; per stage Q, dO and 64 lse + 64 delta; barriers
  return 1024 + 2 * (D / 64) * DKV_KBOX +
         DKV_STAGES * (2 * (D / 64) * DKV_QBOX + 2 * DKV_BM * 4) +
         (1 + 2 * DKV_STAGES) * 8;
}

template <int D>
__global__ void __launch_bounds__(DKV_THREADS, 1)
    fa_bwd_dkv_wgmma(const __grid_constant__ DKVMaps maps, FAParams p) {
  using namespace hopper;
  constexpr int KT = (D / 64) * DKV_KBOX;       // the K (or V) tile
  constexpr int QT = (D / 64) * DKV_QBOX;       // one Q (or dO) tile
  extern __shared__ uint8_t dkv_smem[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(dkv_smem) + 1023) & ~uintptr_t(1023));
  uint8_t* ks = smem;
  uint8_t* vs = ks + KT;
  uint8_t* qs = vs + KT;                        // DKV_STAGES tiles
  uint8_t* dos = qs + DKV_STAGES * QT;          // DKV_STAGES tiles
  float* rows = reinterpret_cast<float*>(dos + DKV_STAGES * QT);
  uint64_t* bars = reinterpret_cast<uint64_t*>(rows + DKV_STAGES * 2 * DKV_BM);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + DKV_STAGES;

  const int rep = p.H / p.KVH, off = p.Tk - p.Tq;
  const int kb = blockIdx.x / (p.B * p.KVH), rest = blockIdx.x % (p.B * p.KVH);
  const int b = rest / p.KVH, kh = rest % p.KVH, k0 = kb * DKV_BN;
  // the first query tile that sees any of this block's keys
  const int qstart = p.causal ? max(0, k0 - off) / DKV_BM * DKV_BM : 0;
  const int n_qt = (p.Tq - qstart + DKV_BM - 1) / DKV_BM;
  const int n_it = rep * n_qt;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < DKV_STAGES; ++s) {
      mbar_init(&full[s], 33);    // the TMA's expect_tx, then each lane
      mbar_init(&empty[s], 8);    // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ------------------------------------------------------ producer
    setmaxnreg_dec<40>();
    if (threadIdx.x < 288) {
      const int lane = threadIdx.x - 256;
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * KT);
#pragma unroll
        for (int x = 0; x < D / 64; ++x) {
          tma_load_4d(ks + x * DKV_KBOX, &maps.k, kv_full, x * 64, k0, kh, b);
          tma_load_4d(vs + x * DKV_KBOX, &maps.v, kv_full, x * 64, k0, kh, b);
        }
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % DKV_STAGES;
        const int h = kh * rep + it / n_qt;
        const int q0 = qstart + (it % n_qt) * DKV_BM;
        if (it >= DKV_STAGES)
          mbar_wait(&empty[s], ((it / DKV_STAGES) - 1) & 1);
        if (lane == 0) {
          mbar_expect_tx(&full[s], 2 * QT);
#pragma unroll
          for (int x = 0; x < D / 64; ++x) {
            tma_load_4d(qs + s * QT + x * DKV_QBOX, &maps.q, &full[s],
                        x * 64, q0, h, b);
            tma_load_4d(dos + s * QT + x * DKV_QBOX, &maps.dout, &full[s],
                        x * 64, q0, h, b);
          }
        }
        const size_t at = ((size_t)b * p.H + h) * p.Tq;
        float* lse_s = rows + s * 2 * DKV_BM;
#pragma unroll
        for (int i = lane; i < DKV_BM; i += 32) {
          const int qr = q0 + i;
          lse_s[i] = qr < p.Tq ? p.lse[at + qr] * 1.4426950408889634f : 0.f;
          lse_s[DKV_BM + i] = qr < p.Tq ? p.delta[at + qr] : 0.f;
        }
        mbar_arrive(&full[s]);
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    setmaxnreg_inc<232>();
    const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32, g = lane / 4, tg = lane % 4;
    const int kw0 = k0 + wg * 64;                 // this warpgroup's keys
    int key[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) key[i] = kw0 + warp * 16 + g + 8 * i;
    const float scale_log2 = p.scale * 1.4426950408889634f;
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    const uint32_t ka = smem_u32(ks) + wg * 64 * 128;
    const uint32_t va = smem_u32(vs) + wg * 64 * 128;
    mbar_wait(kv_full, 0);

    for (int it = 0; it < n_it; ++it) {
      const int s = it % DKV_STAGES;
      const int q0 = qstart + (it % n_qt) * DKV_BM;
      mbar_wait(&full[s], (it / DKV_STAGES) & 1);
      // tiles whose every query is above this warpgroup's keys add 0
      if (!(p.causal && q0 + DKV_BM - 1 + off < kw0)) {
        const uint32_t qa = smem_u32(qs + s * QT);
        const uint32_t da = smem_u32(dos + s * QT);
        const float* lse_s = rows + s * 2 * DKV_BM;
        const float* dl_s = lse_s + DKV_BM;
        float st[DKV_BM / 2], dpt[DKV_BM / 2];
#pragma unroll
        for (int i = 0; i < DKV_BM / 2; ++i) st[i] = dpt[i] = 0.f;
        wgmma_fence();
        fence_regs<DKV_BM / 2>(st);
        fence_regs<DKV_BM / 2>(dpt);
        // the k step kk: 32 bytes into a box, boxes of 64 columns
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t ko = (kk / 4) * DKV_KBOX + (kk % 4) * 32;
          const uint32_t qo = (kk / 4) * DKV_QBOX + (kk % 4) * 32;
          wgmma_ss_n64<0>(st, desc_sw128(ka + ko, 16, 1024),
                          desc_sw128(qa + qo, 16, 1024), 1);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t ko = (kk / 4) * DKV_KBOX + (kk % 4) * 32;
          const uint32_t qo = (kk / 4) * DKV_QBOX + (kk % 4) * 32;
          wgmma_ss_n64<0>(dpt, desc_sw128(va + ko, 16, 1024),
                          desc_sw128(da + qo, 16, 1024), 1);
        }
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs<DKV_BM / 2>(st);

        // st[4 j + 2 i + c]: key key[i], query q0 + 8 j + 2 tg + c
        const bool masked =
            q0 + DKV_BM > p.Tq || (p.causal && kw0 + 63 > q0 + off);
#pragma unroll
        for (int j = 0; j < DKV_BM / 8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int qc = 8 * j + 2 * tg + (c & 1), qr = q0 + qc;
            float e = exp2f(fmaf(st[4 * j + c], scale_log2, -lse_s[qc]));
            if (masked && (qr >= p.Tq || (p.causal && key[c >> 1] > qr + off)))
              e = 0.f;
            st[4 * j + c] = e;
          }
        wgmma_wait<0>();
        fence_regs<DKV_BM / 2>(dpt);
#pragma unroll
        for (int j = 0; j < DKV_BM / 8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int qc = 8 * j + 2 * tg + (c & 1);
            dpt[4 * j + c] = st[4 * j + c] * (dpt[4 * j + c] - dl_s[qc]) *
                             p.scale;
          }
        uint32_t pa[DKV_BM / 16][4], sa[DKV_BM / 16][4];
#pragma unroll
        for (int kk = 0; kk < DKV_BM / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            pa[kk][r] = pack_bf16(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
            sa[kk][r] =
                pack_bf16(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
          }
        wgmma_fence();
        fence_regs<D / 2>(dv);
        fence_regs<D / 2>(dk);
#pragma unroll
        for (int kk = 0; kk < DKV_BM / 16; ++kk) {
          const uint64_t dd = desc_sw128(da + kk * 16 * 128, DKV_QBOX, 1024);
          const uint64_t dq = desc_sw128(qa + kk * 16 * 128, DKV_QBOX, 1024);
          if constexpr (D == 128) {
            wgmma_rs_n128<1>(dv, pa[kk], dd, 1);
            wgmma_rs_n128<1>(dk, sa[kk], dq, 1);
          } else {
            wgmma_rs_n64<1>(dv, pa[kk], dd, 1);
            wgmma_rs_n64<1>(dk, sa[kk], dq, 1);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<D / 2>(dv);
        fence_regs<D / 2>(dk);
        keep_regs<4 * (DKV_BM / 16)>(&pa[0][0]);
        keep_regs<4 * (DKV_BM / 16)>(&sa[0][0]);
      }
      // every lane's reads of the stage (lse and delta with ld.shared),
      // then lane 0 frees it for the producer's next copy
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (key[i] >= p.Tk) continue;
      bf16* dkr = (bf16*)p.dk + k_off(p, b, kh, key[i]);
      bf16* dvr = (bf16*)p.dv + k_off(p, b, kh, key[i]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dkr + 8 * j + 2 * tg) =
            pack_bf16(dk[4 * j + 2 * i], dk[4 * j + 2 * i + 1]);
        *reinterpret_cast<uint32_t*>(dvr + 8 * j + 2 * tg) =
            pack_bf16(dv[4 * j + 2 * i], dv[4 * j + 2 * i + 1]);
      }
    }
  }
}

// --------------------------------------------- bf16 dQ (wgmma + TMA)
// dK/dV's design with the roles of queries and keys swapped.  A block
// owns 128 query rows of one (batch, head): warpgroups 0 and 1 hold 64
// rows each and their dQ sums in f32 registers to the end (no atomics:
// the result's bits do not depend on timing), and warpgroup 2 produces.
// One producer thread loads the block's Q and dO once, then K and V
// tiles of 64 keys of the head's kv head into a 3-stage ring, by TMA
// from the 4-D tensor maps of dK/dV with the boxes swapped (Q, dO 128
// rows; K, V 64), 128-byte swizzled, D / 64 boxes a tile.  Each thread
// reads its two rows' lse (times log2 e) and delta once into registers.
// A consumer warpgroup computes S = Q K^T and dP = dO V^T by wgmma
// m64n64k16 from shared memory (all K-major), P = exp2(S scale log2 e -
// lse log2 e) and dS = P (dP - delta) scale in f32 registers (the mask
// only on tiles that reach past its first row's diagonal, a ragged end
// or rows past Tq; tiles past its last row's diagonal are skipped, and
// tiles past the block's are never loaded), rounds dS to bf16 in the
// A-fragment layout and issues dQ += dS K with K read MN-major.  Every
// read of a ring stage is the tensor cores' (the async proxy, as TMA's
// writes), so a stage is freed once wgmma_wait has retired its products,
// with no proxy fence.  Blocks run the longest causal query tiles first,
// the query heads of one kv head adjacent, so their K and V tiles come
// from L2.
constexpr int DQ_BM = 128, DQ_BN = 64, DQ_THREADS = 384, DQ_STAGES = 3;
constexpr int DQ_QBOX = 128 * 128;    // [128 rows][64] bf16
constexpr int DQ_KBOX = 64 * 128;     // [64 rows][64] bf16

template <int D>
constexpr int fa_dq_smem() {
  // alignment; Q, dO; per stage K and V; barriers
  return 1024 + 2 * (D / 64) * DQ_QBOX + DQ_STAGES * 2 * (D / 64) * DQ_KBOX +
         (1 + 2 * DQ_STAGES) * 8;
}

template <int D>
__global__ void __launch_bounds__(DQ_THREADS, 1)
    fa_bwd_dq_wgmma(const __grid_constant__ DKVMaps maps, FAParams p) {
  using namespace hopper;
  constexpr int QT = (D / 64) * DQ_QBOX;        // the Q (or dO) tile
  constexpr int KT = (D / 64) * DQ_KBOX;        // one K (or V) tile
  extern __shared__ uint8_t dq_smem[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(dq_smem) + 1023) & ~uintptr_t(1023));
  uint8_t* qs = smem;
  uint8_t* dos = qs + QT;
  uint8_t* ks = dos + QT;                       // DQ_STAGES tiles
  uint8_t* vs = ks + DQ_STAGES * KT;            // DQ_STAGES tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + DQ_STAGES * KT);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + DQ_STAGES;

  const int n_qt = (p.Tq + DQ_BM - 1) / DQ_BM;
  const int h = blockIdx.x % p.H, rest = blockIdx.x / p.H;
  const int b = rest % p.B, rank = rest / p.B;
  const int qt = p.causal ? n_qt - 1 - rank : rank;
  const int kh = h / (p.H / p.KVH), q0 = qt * DQ_BM;
  const int n_kt =
      (key_limit(p, min(q0 + DQ_BM, p.Tq) - 1) + DQ_BN - 1) / DQ_BN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < DQ_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);   // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ------------------------------------------------------ producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, 2 * QT);
#pragma unroll
      for (int x = 0; x < D / 64; ++x) {
        tma_load_4d(qs + x * DQ_QBOX, &maps.q, q_full, x * 64, q0, h, b);
        tma_load_4d(dos + x * DQ_QBOX, &maps.dout, q_full, x * 64, q0, h, b);
      }
      for (int it = 0; it < n_kt; ++it) {
        const int s = it % DQ_STAGES;
        if (it >= DQ_STAGES) mbar_wait(&empty[s], ((it / DQ_STAGES) - 1) & 1);
        mbar_expect_tx(&full[s], 2 * KT);
#pragma unroll
        for (int x = 0; x < D / 64; ++x) {
          tma_load_4d(ks + s * KT + x * DQ_KBOX, &maps.k, &full[s], x * 64,
                      it * DQ_BN, kh, b);
          tma_load_4d(vs + s * KT + x * DQ_KBOX, &maps.v, &full[s], x * 64,
                      it * DQ_BN, kh, b);
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    setmaxnreg_inc<232>();
    const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32, g = lane / 4, tg = lane % 4;
    const int r0 = q0 + wg * 64;                  // this warpgroup's rows
    int row[2], lim[2];
    float lse2[2], dl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      row[i] = r0 + warp * 16 + g + 8 * i;
      const bool in = row[i] < p.Tq;
      const size_t at = ((size_t)b * p.H + h) * p.Tq + row[i];
      lim[i] = in ? key_limit(p, row[i]) : 0;
      lse2[i] = in ? p.lse[at] * 1.4426950408889634f : 0.f;
      dl[i] = in ? p.delta[at] : 0.f;
    }
    // keys this warpgroup's rows see, and the first one some row of it
    // (or a row past Tq) does not
    const int kend = r0 < p.Tq ? key_limit(p, min(r0 + 64, p.Tq) - 1) : 0;
    const int mask_from = r0 + 64 > p.Tq ? 0 : key_limit(p, r0);
    const float scale_log2 = p.scale * 1.4426950408889634f;
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    const uint32_t qa = smem_u32(qs) + wg * 64 * 128;
    const uint32_t da = smem_u32(dos) + wg * 64 * 128;
    mbar_wait(q_full, 0);

    for (int it = 0; it < n_kt; ++it) {
      const int s = it % DQ_STAGES, kb = it * DQ_BN;
      mbar_wait(&full[s], (it / DQ_STAGES) & 1);
      if (kb < kend) {
        const uint32_t ka = smem_u32(ks + s * KT);
        const uint32_t va = smem_u32(vs + s * KT);
        float st[DQ_BN / 2], dpt[DQ_BN / 2];
#pragma unroll
        for (int i = 0; i < DQ_BN / 2; ++i) st[i] = dpt[i] = 0.f;
        wgmma_fence();
        fence_regs<DQ_BN / 2>(st);
        fence_regs<DQ_BN / 2>(dpt);
        // the k step kk: 32 bytes into a box, boxes of 64 columns
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t qo = (kk / 4) * DQ_QBOX + (kk % 4) * 32;
          const uint32_t ko = (kk / 4) * DQ_KBOX + (kk % 4) * 32;
          wgmma_ss_n64<0>(st, desc_sw128(qa + qo, 16, 1024),
                          desc_sw128(ka + ko, 16, 1024), 1);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t qo = (kk / 4) * DQ_QBOX + (kk % 4) * 32;
          const uint32_t ko = (kk / 4) * DQ_KBOX + (kk % 4) * 32;
          wgmma_ss_n64<0>(dpt, desc_sw128(da + qo, 16, 1024),
                          desc_sw128(va + ko, 16, 1024), 1);
        }
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs<DQ_BN / 2>(st);

        // st[4 j + 2 i + c]: row row[i], key kb + 8 j + 2 tg + c; a
        // masked key gets P = 0 exactly (a select, so nothing that is
        // not finite flows into dS K)
        const bool masked = kb + DQ_BN > mask_from;
#pragma unroll
        for (int j = 0; j < DQ_BN / 8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float e =
                exp2f(fmaf(st[4 * j + c], scale_log2, -lse2[c >> 1]));
            st[4 * j + c] =
                masked && kb + 8 * j + 2 * tg + (c & 1) >= lim[c >> 1] ? 0.f
                                                                       : e;
          }
        wgmma_wait<0>();
        fence_regs<DQ_BN / 2>(dpt);
        uint32_t sa[DQ_BN / 16][4];
#pragma unroll
        for (int kk = 0; kk < DQ_BN / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int c0 = 8 * kk + 2 * r, i = r & 1;
            sa[kk][r] = pack_bf16(
                st[c0] * (dpt[c0] - dl[i]) * p.scale,
                st[c0 + 1] * (dpt[c0 + 1] - dl[i]) * p.scale);
          }
        wgmma_fence();
        fence_regs<D / 2>(dq);
#pragma unroll
        for (int kk = 0; kk < DQ_BN / 16; ++kk) {
          const uint64_t dk = desc_sw128(ka + kk * 16 * 128, DQ_KBOX, 1024);
          if constexpr (D == 128)
            wgmma_rs_n128<1>(dq, sa[kk], dk, 1);
          else
            wgmma_rs_n64<1>(dq, sa[kk], dk, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<D / 2>(dq);
        keep_regs<4 * (DQ_BN / 16)>(&sa[0][0]);
      }
      if (lane == 0) mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (row[i] >= p.Tq) continue;
      bf16* dqr = (bf16*)p.dq + q_off(p, b, h, row[i]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(dqr + 8 * j + 2 * tg) =
            pack_bf16(dq[4 * j + 2 * i], dq[4 * j + 2 * i + 1]);
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

// the three tensor maps of q [B, H, Tq, D] and k, v [B, KVH, Tk, D]
// from the strides in p (elements; each a multiple of 8, checked by the
// wrapper and refused here by cuTensorMapEncodeTiled otherwise)
static bool fa_maps(FAMaps* maps, const FAParams& p) {
  const cuuint32_t box[4] = {64, 128, 1, 1};
  const cuuint64_t qd[4] = {(cuuint64_t)p.D, (cuuint64_t)p.Tq,
                            (cuuint64_t)p.H, (cuuint64_t)p.B};
  const cuuint64_t qs[3] = {(cuuint64_t)p.qst * 2, (cuuint64_t)p.qsh * 2,
                            (cuuint64_t)p.qsb * 2};
  const cuuint64_t kd[4] = {(cuuint64_t)p.D, (cuuint64_t)p.Tk,
                            (cuuint64_t)p.KVH, (cuuint64_t)p.B};
  const cuuint64_t ks[3] = {(cuuint64_t)p.kst * 2, (cuuint64_t)p.ksh * 2,
                            (cuuint64_t)p.ksb * 2};
  return hopper::make_map_bf16(&maps->q, p.q, 4, qd, qs, box) &&
         hopper::make_map_bf16(&maps->k, p.k, 4, kd, ks, box) &&
         hopper::make_map_bf16(&maps->v, p.v, 4, kd, ks, box);
}

template <int D, bool WRITE_LSE>
static int launch_fwd_wgmma(const FAParams& p, cudaStream_t st) {
  FAMaps maps;
  if (!fa_maps(&maps, p)) return (int)cudaErrorInvalidValue;
  constexpr int smem = fa_fwd_smem<D>();
  const cudaError_t e = cudaFuncSetAttribute(
      fa_fwd_wgmma<D, WRITE_LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const int n_qt = (p.Tq + FA_BM - 1) / FA_BM;
  fa_fwd_wgmma<D, WRITE_LSE><<<n_qt * p.B * p.H, FA_THREADS, smem, st>>>(
      maps, p);
  return (int)cudaGetLastError();
}

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
  } else if (D == 64) {
    return lse ? launch_fwd_wgmma<64, true>(p, st)
               : launch_fwd_wgmma<64, false>(p, st);
  } else {
    return lse ? launch_fwd_wgmma<128, true>(p, st)
               : launch_fwd_wgmma<128, false>(p, st);
  }
  return (int)cudaGetLastError();
}

// the tensor maps of the backward: q and dO [B, H, Tq, D] with boxes of
// q_rows rows, k and v [B, KVH, Tk, D] with boxes of k_rows (dK/dV: 64
// and 128; dQ: 128 and 64)
static bool bwd_maps(DKVMaps* maps, const FAParams& p, int q_rows,
                     int k_rows) {
  const cuuint32_t qbox[4] = {64, (cuuint32_t)q_rows, 1, 1};
  const cuuint32_t kbox[4] = {64, (cuuint32_t)k_rows, 1, 1};
  const cuuint64_t qd[4] = {(cuuint64_t)p.D, (cuuint64_t)p.Tq,
                            (cuuint64_t)p.H, (cuuint64_t)p.B};
  const cuuint64_t qs[3] = {(cuuint64_t)p.qst * 2, (cuuint64_t)p.qsh * 2,
                            (cuuint64_t)p.qsb * 2};
  const cuuint64_t kd[4] = {(cuuint64_t)p.D, (cuuint64_t)p.Tk,
                            (cuuint64_t)p.KVH, (cuuint64_t)p.B};
  const cuuint64_t ks[3] = {(cuuint64_t)p.kst * 2, (cuuint64_t)p.ksh * 2,
                            (cuuint64_t)p.ksb * 2};
  return hopper::make_map_bf16(&maps->q, p.q, 4, qd, qs, qbox) &&
         hopper::make_map_bf16(&maps->dout, p.dout, 4, qd, qs, qbox) &&
         hopper::make_map_bf16(&maps->k, p.k, 4, kd, ks, kbox) &&
         hopper::make_map_bf16(&maps->v, p.v, 4, kd, ks, kbox);
}

template <int D>
static int launch_dq_wgmma(const FAParams& p, cudaStream_t st) {
  DKVMaps maps;
  if (!bwd_maps(&maps, p, DQ_BM, DQ_BN)) return (int)cudaErrorInvalidValue;
  constexpr int smem = fa_dq_smem<D>();
  const cudaError_t e = cudaFuncSetAttribute(
      fa_bwd_dq_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int n_qt = (p.Tq + DQ_BM - 1) / DQ_BM;
  fa_bwd_dq_wgmma<D><<<n_qt * p.B * p.H, DQ_THREADS, smem, st>>>(maps, p);
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
    return (int)cudaGetLastError();
  }
  return D == 64 ? launch_dq_wgmma<64>(p, st) : launch_dq_wgmma<128>(p, st);
}

template <int D>
static int launch_dkv_wgmma(const FAParams& p, cudaStream_t st) {
  DKVMaps maps;
  if (!bwd_maps(&maps, p, DKV_BM, DKV_BN)) return (int)cudaErrorInvalidValue;
  constexpr int smem = fa_dkv_smem<D>();
  const cudaError_t e = cudaFuncSetAttribute(
      fa_bwd_dkv_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int n_kb = (p.Tk + DKV_BN - 1) / DKV_BN;
  fa_bwd_dkv_wgmma<D><<<n_kb * p.B * p.KVH, DKV_THREADS, smem, st>>>(maps,
                                                                     p);
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
    // no query rows: zero sums (dK, dV are dense, from empty_like(k));
    // the tensor maps take no zero extent
    if (Tq == 0) {
      const size_t bytes = (size_t)B * KVH * Tk * D * 2;
      const cudaError_t e = cudaMemsetAsync(dk, 0, bytes, st);
      return (int)(e != cudaSuccess ? e : cudaMemsetAsync(dv, 0, bytes, st));
    }
    const int err = D == 64 ? launch_dkv_wgmma<64>(p, st)
                            : launch_dkv_wgmma<128>(p, st);
    if (err) return err;
  }
  return (int)cudaGetLastError();
}
