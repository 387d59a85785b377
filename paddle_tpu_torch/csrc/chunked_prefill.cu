// Attention of one prefill chunk (T query tokens per sequence, already
// RoPE-rotated and scattered into the pools by the caller) over each
// sequence's paged KV context, with the causal mask k_pos <= pos[b] + t
// and an online softmax; writes the normalized context in T.
//
// Replaces paddle_tpu/kernels/chunked_prefill.py _chunk_kernel
// (pallas_call in _pallas_chunked).  GQA is packed as there: the rep*T
// query rows of one kv head (row r*T + t is head kvh*rep + r, token t)
// share each K/V page, so the repeat to H heads never exists.
//
// On the TPU one grid cell walked every page in order for all rep*T
// rows, and page 0 anchored the running max.  Here a block owns a tile
// of the rows of one (batch, kv head) and loops over the keys up to the
// tile's last query position; masked keys get weight exactly 0 (not
// exp(-1e30 - m), which is 1 while a row has seen no live key), so the
// result does not depend on which keys are seen first.
//
// Bound on the H100: operations (4*D flops per key per row, rep*T rows
// per K/V row read).  Two kernels:
// - bf16 (the served model): FlashAttention-2 on the tensor cores.  A
//   block of 4 warps owns 64 rows, 16 a warp, with q's fragments held in
//   registers; per 64 keys it stages K and V from their pages in shared
//   memory, S = q k^T runs as mma.sync m16n8k16 (bf16 in, f32 out), the
//   1/sqrt(D) scale and the mask are applied to S in f32, the online
//   softmax keeps each row's max and sum in the 4 lanes that hold it,
//   and P, rounded to bf16 as FlashAttention-2 does, multiplies V (read
//   with ldmatrix.trans) into f32 accumulators.  The plain version keeps
//   P in f32: the two differ by less than one bf16 rounding of the
//   output.
// - f32 (the CPU-scale check configuration): CUDA cores, a block owns 32
//   rows and stages one page at a time; q is scaled by 1/sqrt(D) in f32
//   as it is staged, exactly the multiply the reference's caller does.
#include <cstdint>

#include "common.cuh"

constexpr int CP_THREADS = 128;
constexpr int CP_ROWS = 32;                        // query rows per block
constexpr int CP_PARTS = CP_THREADS / CP_ROWS;     // threads per row
constexpr int CP_MAXD = 128;                      // MAX_HEAD_DIM in the wrapper
constexpr int CP_COLS = CP_MAXD / CP_PARTS;        // columns per thread

template <typename T>
__global__ void __launch_bounds__(CP_THREADS) chunked_prefill_kernel(
    const T* __restrict__ q,        // [B, Tc, H, D] rotated
    const T* __restrict__ k_pool,   // [nb, bs, KVH, D]
    const T* __restrict__ v_pool,
    const int* __restrict__ bt,     // [B, nbs]
    const int* __restrict__ pos,    // [B] chunk-start positions
    T* __restrict__ out,            // [B, Tc, H, D]
    int Tc, int KVH, int rep, int D, int bs, int nbs, float scale) {
  extern __shared__ float sm[];
  const int b = blockIdx.x, kvh = blockIdx.y, tid = threadIdx.x;
  const int H = KVH * rep, RT = rep * Tc;
  const int row0 = blockIdx.z * CP_ROWS;
  float* q_s = sm;                          // [CP_ROWS, D + 1]
  float* k_s = q_s + CP_ROWS * (D + 1);     // [bs, D + 1]
  float* v_s = k_s + bs * (D + 1);          // [bs, D]
  float* p_s = v_s + bs * D;                // [CP_ROWS, bs + 1]
  float* m_s = p_s + CP_ROWS * (bs + 1);    // [CP_ROWS]
  float* l_s = m_s + CP_ROWS;
  float* a_s = l_s + CP_ROWS;
  const int start = pos[b];

  // stage the tile's q rows (pre-scaled f32)
  for (int i = tid; i < CP_ROWS * D; i += CP_THREADS) {
    const int rr = i / D, d = i % D, row = row0 + rr;
    float v = 0.f;
    if (row < RT) {
      const int r = row / Tc, t = row % Tc;
      v = to_f32(q[(((size_t)b * Tc + t) * H + kvh * rep + r) * D + d]) *
          scale;
    }
    q_s[rr * (D + 1) + d] = v;
  }
  if (tid < CP_ROWS) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  // the tile's deepest query position bounds the pages it needs
  const int row_last = min(row0 + CP_ROWS, RT) - 1;
  const int t_max = row0 / Tc == row_last / Tc ? row_last % Tc : Tc - 1;
  const int last_page = min((start + t_max) / bs, nbs - 1);

  const int my_row = tid / CP_PARTS, part = tid % CP_PARTS;
  const int ncols = D / CP_PARTS;
  float acc[CP_COLS];
#pragma unroll
  for (int j = 0; j < CP_COLS; ++j) acc[j] = 0.f;
  __syncthreads();

  const size_t row_stride = (size_t)KVH * D;
  for (int page = 0; page <= last_page; ++page) {
    const size_t base = ((size_t)bt[b * nbs + page] * bs * KVH + kvh) * D;
    for (int i = tid; i < bs * D; i += CP_THREADS) {
      const int t = i / D, d = i % D;
      const size_t off = base + t * row_stride + d;
      k_s[t * (D + 1) + d] = to_f32(k_pool[off]);
      v_s[i] = to_f32(v_pool[off]);
    }
    __syncthreads();
    for (int i = tid; i < CP_ROWS * bs; i += CP_THREADS) {
      const int rr = i / bs, t = i % bs;
      const float* qr = q_s + rr * (D + 1);
      const float* kr = k_s + t * (D + 1);
      float sc = 0.f;
      for (int d = 0; d < D; ++d) sc = fmaf(qr[d], kr[d], sc);
      const int q_pos = start + (row0 + rr) % Tc;
      p_s[rr * (bs + 1) + t] = page * bs + t <= q_pos ? sc : NEG_INF;
    }
    __syncthreads();
    if (tid < CP_ROWS) {
      float* pr = p_s + tid * (bs + 1);
      const int q_pos = start + (row0 + tid) % Tc;
      float mc = NEG_INF;
      for (int t = 0; t < bs; ++t) mc = fmaxf(mc, pr[t]);
      const float mn = fmaxf(m_s[tid], mc);
      const float alpha = expf(m_s[tid] - mn);
      float sum = 0.f;
      for (int t = 0; t < bs; ++t) {
        const float e = page * bs + t <= q_pos ? expf(pr[t] - mn) : 0.f;
        pr[t] = e;
        sum += e;
      }
      l_s[tid] = l_s[tid] * alpha + sum;
      m_s[tid] = mn;
      a_s[tid] = alpha;
    }
    __syncthreads();
    {
      const float alpha = a_s[my_row];
      const float* pr = p_s + my_row * (bs + 1);
#pragma unroll
      for (int j = 0; j < CP_COLS; ++j) {
        if (j < ncols) {
          const int d = j * CP_PARTS + part;
          float a = acc[j] * alpha;
          for (int t = 0; t < bs; ++t) a = fmaf(pr[t], v_s[t * D + d], a);
          acc[j] = a;
        }
      }
    }
    __syncthreads();
  }

  const int row = row0 + my_row;
  if (row < RT) {
    const int r = row / Tc, t = row % Tc;
    const float inv_l = 1.f / fmaxf(l_s[my_row], 1e-30f);
    T* orow = out + (((size_t)b * Tc + t) * H + kvh * rep + r) * D;
#pragma unroll
    for (int j = 0; j < CP_COLS; ++j)
      if (j < ncols) orow[j * CP_PARTS + part] = from_f32<T>(acc[j] * inv_l);
  }
}

// ------------------------------------------------ bf16, tensor cores
constexpr int FA_ROWS = 64, FA_KEYS = 64, FA_THREADS = 128;
using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// see fused_norm_linear.cu: two 8x8 b16 matrices, transposed
__device__ __forceinline__ void ldsm_x2_trans(uint32_t* r, const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Fragment layouts (m16n8k16): lane = 4 g + tg holds rows g and g + 8;
// A pairs of k at 2 tg (and + 8), B pairs of k at 2 tg for column g, C
// columns 2 tg and 2 tg + 1.  K and V rows are padded to D + 8 bf16,
// which puts the 8 rows of a fragment load on distinct banks.
template <int D>
__global__ void __launch_bounds__(FA_THREADS) chunked_prefill_bf16(
    const bf16* __restrict__ q, const bf16* __restrict__ k_pool,
    const bf16* __restrict__ v_pool, const int* __restrict__ bt,
    const int* __restrict__ pos, bf16* __restrict__ out, int Tc, int KVH,
    int rep, int bs, int nbs, float scale) {
  constexpr int LD = D + 8;
  __shared__ __align__(16) bf16 Ks[FA_KEYS][LD];
  __shared__ __align__(16) bf16 Vs[FA_KEYS][LD];
  const int b = blockIdx.x, kvh = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, tg = lane % 4;
  const int H = KVH * rep, RT = rep * Tc;
  const int row0 = blockIdx.z * FA_ROWS;
  const int start = pos[b];

  // this lane's two rows: g and g + 8 of its warp's 16
  bool live[2];
  int qpos[2];
  size_t qoff[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = row0 + warp * 16 + g + 8 * h;
    const int r = rr / Tc, t = rr % Tc;
    live[h] = rr < RT;
    qpos[h] = start + t;
    qoff[h] = (((size_t)b * Tc + t) * H + kvh * rep + r) * D;
  }
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int d = ks * 16 + 2 * tg;
    qf[ks][0] = live[0] ? ld_pair(q + qoff[0] + d) : 0u;
    qf[ks][1] = live[1] ? ld_pair(q + qoff[1] + d) : 0u;
    qf[ks][2] = live[0] ? ld_pair(q + qoff[0] + d + 8) : 0u;
    qf[ks][3] = live[1] ? ld_pair(q + qoff[1] + d + 8) : 0u;
  }
  float o[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[nd][c] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  // the tile's deepest query position bounds the keys it needs
  const int row_last = min(row0 + FA_ROWS, RT) - 1;
  const int t_max = row0 / Tc == row_last / Tc ? row_last % Tc : Tc - 1;
  const int last_key = min(start + t_max, nbs * bs - 1);
  const size_t row_stride = (size_t)KVH * D;

  for (int kbase = 0; kbase <= last_key; kbase += FA_KEYS) {
    for (int i = tid; i < FA_KEYS * (D / 8); i += FA_THREADS) {
      const int j = i / (D / 8), d = (i % (D / 8)) * 8, kp = kbase + j;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = kv;
      if (kp <= last_key) {
        const size_t off =
            ((size_t)bt[b * nbs + kp / bs] * bs + kp % bs) * row_stride +
            (size_t)kvh * D + d;
        kv = *reinterpret_cast<const uint4*>(k_pool + off);
        vv = *reinterpret_cast<const uint4*>(v_pool + off);
      }
      *reinterpret_cast<uint4*>(&Ks[j][d]) = kv;
      *reinterpret_cast<uint4*>(&Vs[j][d]) = vv;
    }
    __syncthreads();

    float s[FA_KEYS / 8][4];
#pragma unroll
    for (int j = 0; j < FA_KEYS / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
      for (int j = 0; j < FA_KEYS / 8; ++j) {
        uint32_t kf[2];
        kf[0] = ld_pair(&Ks[j * 8 + g][ks * 16 + 2 * tg]);
        kf[1] = ld_pair(&Ks[j * 8 + g][ks * 16 + 2 * tg + 8]);
        mma_bf16(s[j], qf[ks], kf);
      }
    }
    // scale and mask in f32, then the online softmax of rows g, g + 8
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < FA_KEYS / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kp = kbase + j * 8 + 2 * tg + (c & 1);
        s[j][c] = kp <= qpos[c / 2] ? s[j][c] * scale : NEG_INF;
        mx[c / 2] = fmaxf(mx[c / 2], s[j][c]);
      }
    float alpha[2], lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = expf(m[h] - mx[h]);
      m[h] = mx[h];
    }
#pragma unroll
    for (int j = 0; j < FA_KEYS / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kp = kbase + j * 8 + 2 * tg + (c & 1);
        const float p = kp <= qpos[c / 2] ? expf(s[j][c] - m[c / 2]) : 0.f;
        s[j][c] = p;
        lsum[c / 2] += p;
      }
    // this lane's share of each row sum; the 4 lanes meet at the end
    l[0] = l[0] * alpha[0] + lsum[0];
    l[1] = l[1] * alpha[1] + lsum[1];
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[nd][c] *= alpha[c / 2];
    // O += P V: the C fragments of two neighbouring key tiles are the A
    // fragment of one 16-key step
#pragma unroll
    for (int kk = 0; kk < FA_KEYS / 16; ++kk) {
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
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!live[h]) continue;
    const float inv_l = 1.f / fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      *reinterpret_cast<__nv_bfloat162*>(out + qoff[h] + nd * 8 + 2 * tg) =
          __floats2bfloat162_rn(o[nd][2 * h] * inv_l,
                                o[nd][2 * h + 1] * inv_l);
    }
  }
}

extern "C" int chunked_prefill_smem_bytes(int D, int bs) {
  return (int)sizeof(float) * (CP_ROWS * (D + 1) + bs * (2 * D + 1) +
                               CP_ROWS * (bs + 1) + 3 * CP_ROWS);
}

// dtype 0 (f32): the CUDA-core kernel, any D <= CP_MAXD with D % 4 == 0;
// dtype 1 (bf16): the tensor-core kernel, D 64 or 128
extern "C" int chunked_prefill(const void* q, const void* k_pool,
                               const void* v_pool, const void* bt,
                               const void* pos, void* out, int B, int Tc,
                               int KVH, int rep, int D, int bs, int nbs,
                               float scale, int dtype, void* stream) {
  if (B == 0 || Tc == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int* btp = (const int*)bt;
  const int* posp = (const int*)pos;
  if (dtype == 0) {
    const int smem = chunked_prefill_smem_bytes(D, bs);
    const dim3 grid(B, KVH, (rep * Tc + CP_ROWS - 1) / CP_ROWS);
    chunked_prefill_kernel<float><<<grid, CP_THREADS, smem, st>>>(
        (const float*)q, (const float*)k_pool, (const float*)v_pool, btp,
        posp, (float*)out, Tc, KVH, rep, D, bs, nbs, scale);
  } else if (dtype == 1 && (D == 64 || D == 128)) {
    const dim3 grid(B, KVH, (rep * Tc + FA_ROWS - 1) / FA_ROWS);
    auto kernel = D == 64 ? chunked_prefill_bf16<64> : chunked_prefill_bf16<128>;
    kernel<<<grid, FA_THREADS, 0, st>>>(
        (const bf16*)q, (const bf16*)k_pool, (const bf16*)v_pool, btp, posp,
        (bf16*)out, Tc, KVH, rep, bs, nbs, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
