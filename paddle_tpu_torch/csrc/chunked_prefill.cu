// Attention of one prefill chunk (T query tokens per sequence, already
// RoPE-rotated and scattered into the pools by the caller) over each
// sequence's paged KV context, with the causal mask k_pos <= pos[b] + t
// and an online softmax; writes the normalized context in T.
//
// Replaces paddle_tpu/kernels/chunked_prefill.py _chunk_kernel
// (pallas_call in _pallas_chunked).  GQA is packed as there: the rep*T
// query rows of one kv head (head kvh*rep + r, token t) share each K/V
// page, so the repeat to H heads never exists.
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
// - bf16 (the served model): chunked_prefill_wgmma, below.  Its
//   mma.sync predecessor ran 128 blocks of 4 warps (one block a SM, no
//   latency hidden), loaded each 64-key tile with all threads between
//   two barriers, re-read K/V once per query head of a group, and ran at
//   4 % of its bound, 2.6x SDPA's time.  Here the rows of a tile are
//   packed over the GQA group, so a K/V tile is read once for all rep
//   heads; a producer warpgroup keeps 4 tiles in flight while a consumer
//   warpgroup runs wgmma.  P is rounded to bf16 as the A operand of the
//   second product, as FlashAttention-2 does; the plain version keeps P
//   in f32, and the two differ by less than one bf16 rounding of the
//   output.
// - the general instance, chunked_prefill_kernel<T, Q, MAXD> (f32, the
//   CPU-scale check configuration; and bf16 where the wgmma kernel does
//   not fit: head_dim not a multiple of 8, up to 256, or unaligned
//   operands): CUDA cores, a block owns 32 rows (r * T + t
//   order) and stages each page's keys CP_KEYS at a time, converted to
//   f32 on load; q is scaled by 1/sqrt(D) in f32 as it is staged,
//   exactly the multiply the reference's caller does, and the output
//   rounded once to T.  A thread keeps MAXD / 4 columns of its row in
//   registers: the instance of MAXD 128 serves D <= 128 with the
//   registers it always had, that of 256 the wider heads.  Simple
//   rather than fast.
//
// Quantized pools (Q = 1 int8, Q = 2 fp8: the kv_dtype variant of
// _chunk_kernel) hold int8 codes with one f32 scale per (block, token)
// row.  The f32 kernel dequantizes as it stages a page, code times scale
// in f32, the reference's math.  The bf16 kernel cannot: the reference
// keeps the dequantized K/V in f32, and code * scale is not a bf16
// value, so staging it as bf16 would add a rounding the reference does
// not have.  It stages the CODES, which int8 and e4m3 both hold exactly
// in bf16, and applies each key's scale as a factor in f32:
//   S = mma(q, codes_k) * k_scale[key] / sqrt(D),
//   O += mma(bf16(P * v_scale[key]), codes_v), l += P (unscaled, f32),
// so the only rounding left is the one of P that FA-2 already has.
//
// Its instances compile as CP_UNITS translation units at once
// (kernels/_build.py SPLIT), linked into one library: unit CP_UNIT = 0
// holds the entry points and the general instances; unit 1 the wgmma
// instances of 64, 128 and 256 columns over bf16 pools (TMA and copy
// producers), unit 2 those over int8 codes and unit 3 over fp8 codes.
// Without CP_UNIT the file is every unit.
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

constexpr int CP_THREADS = 128;
constexpr int CP_ROWS = 32;                        // query rows per block
constexpr int CP_PARTS = CP_THREADS / CP_ROWS;     // threads per row
constexpr int CP_MAXD = 256;                      // MAX_HEAD_DIM in the wrapper
constexpr int CP_KEYS = 32;                        // a page's keys at once

// T: q's, the output's and (Q == 0) the pools' type; every sum in f32,
// one rounding at the store; D <= MAXD
template <typename T, int Q, int MAXD>
__global__ void __launch_bounds__(CP_THREADS) chunked_prefill_kernel(
    const T* __restrict__ q,        // [B, Tc, H, D] rotated
    const void* __restrict__ k_pool,  // [nb, bs, KVH, D] T, or int8 codes
    const void* __restrict__ v_pool,
    const float* __restrict__ k_scale,  // [nb, bs] (Q > 0)
    const float* __restrict__ v_scale,
    const int* __restrict__ bt,     // [B, nbs]
    const int* __restrict__ pos,    // [B] chunk-start positions
    T* __restrict__ out,            // [B, Tc, H, D]
    int Tc, int KVH, int rep, int D, int bs, int nbs, float scale) {
  extern __shared__ float sm[];
  const int b = blockIdx.x, kvh = blockIdx.y, tid = threadIdx.x;
  const int H = KVH * rep, RT = rep * Tc;
  const int row0 = blockIdx.z * CP_ROWS;
  const int kt = min(bs, CP_KEYS);
  float* q_s = sm;                          // [CP_ROWS, D + 1]
  float* k_s = q_s + CP_ROWS * (D + 1);     // [kt, D + 1]
  float* v_s = k_s + kt * (D + 1);          // [kt, D]
  float* p_s = v_s + kt * D;                // [CP_ROWS, kt + 1]
  float* m_s = p_s + CP_ROWS * (kt + 1);    // [CP_ROWS]
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
  // the tile's deepest query position bounds the keys it needs
  const int row_last = min(row0 + CP_ROWS, RT) - 1;
  const int t_max = row0 / Tc == row_last / Tc ? row_last % Tc : Tc - 1;
  const int key_end = min(start + t_max + 1, nbs * bs);
  const int last_page = (key_end - 1) / bs;

  constexpr int CP_COLS = MAXD / CP_PARTS;          // columns per thread
  const int my_row = tid / CP_PARTS, part = tid % CP_PARTS;
  float acc[CP_COLS];
#pragma unroll
  for (int j = 0; j < CP_COLS; ++j) acc[j] = 0.f;
  __syncthreads();

  const size_t row_stride = (size_t)KVH * D;
  for (int page = 0; page <= last_page; ++page) {
    const size_t prow = (size_t)bt[b * nbs + page] * bs;
    const size_t base = (prow * KVH + kvh) * D;
    for (int t0 = 0; t0 < bs && page * bs + t0 < key_end; t0 += kt) {
      const int nt = min(kt, bs - t0), key0 = page * bs + t0;
      for (int i = tid; i < nt * D; i += CP_THREADS) {
        const int t = i / D, d = i % D;
        const size_t off = base + (t0 + t) * row_stride + d;
        k_s[t * (D + 1) + d] =
            load_kv<T, Q>(k_pool, k_scale, off, prow + t0 + t);
        v_s[i] = load_kv<T, Q>(v_pool, v_scale, off, prow + t0 + t);
      }
      __syncthreads();
      for (int i = tid; i < CP_ROWS * nt; i += CP_THREADS) {
        const int rr = i / nt, t = i % nt;
        const float* qr = q_s + rr * (D + 1);
        const float* kr = k_s + t * (D + 1);
        float sc = 0.f;
        for (int d = 0; d < D; ++d) sc = fmaf(qr[d], kr[d], sc);
        const int q_pos = start + (row0 + rr) % Tc;
        p_s[rr * (kt + 1) + t] = key0 + t <= q_pos ? sc : NEG_INF;
      }
      __syncthreads();
      if (tid < CP_ROWS) {
        float* pr = p_s + tid * (kt + 1);
        const int q_pos = start + (row0 + tid) % Tc;
        float mc = NEG_INF;
        for (int t = 0; t < nt; ++t) mc = fmaxf(mc, pr[t]);
        const float mn = fmaxf(m_s[tid], mc);
        const float alpha = expf(m_s[tid] - mn);
        float sum = 0.f;
        for (int t = 0; t < nt; ++t) {
          const float e = key0 + t <= q_pos ? expf(pr[t] - mn) : 0.f;
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
        const float* pr = p_s + my_row * (kt + 1);
#pragma unroll
        for (int j = 0; j < CP_COLS; ++j) {
          const int d = j * CP_PARTS + part;
          if (d < D) {
            float a = acc[j] * alpha;
            for (int t = 0; t < nt; ++t) a = fmaf(pr[t], v_s[t * D + d], a);
            acc[j] = a;
          }
        }
      }
      __syncthreads();
    }
  }

  const int row = row0 + my_row;
  if (row < RT) {
    const int r = row / Tc, t = row % Tc;
    const float inv_l = 1.f / fmaxf(l_s[my_row], 1e-30f);
    T* orow = out + (((size_t)b * Tc + t) * H + kvh * rep + r) * D;
#pragma unroll
    for (int j = 0; j < CP_COLS; ++j) {
      const int d = j * CP_PARTS + part;
      if (d < D) orow[d] = from_f32<T>(acc[j] * inv_l);
    }
  }
}

// ------------------------------------------------ bf16, wgmma
// A block owns a tile of CW_ROWS = 64 consecutive query rows of one
// (batch, kv head) in the packed order row = t * rep + r (token t, query
// head kvh * rep + r), so one K/V tile feeds every head of the group:
// at rep 4 a tile is 16 tokens x 4 heads.  Warpgroup 0 produces the
// next KEYS keys of K and V into a 4-stage ring of 128-byte-swizzled
// bf16 tiles, by one of three producers (CwLoad, below).
// - bf16 pools whose pages are whole boxes (kTma): one thread loads
//   them by TMA, one box of R = min(bs, KEYS) rows a page (the page's
//   block-table entry read by a lane of its warp), from 3-D tensor maps
//   over the pool viewed as (D, KVH, nb * bs) with boxes (64, 1, R):
//   block sizes 8, 16, 32 or a multiple of 64 (whole boxes a tile, each
//   1024-byte aligned in the swizzle).  Copies of 16 bytes a thread
//   (cp.async) were slower for bf16: the loads an SM keeps in flight
//   bound them, and TMA's are not counted there.
// - bf16 pages that are not whole boxes (kCopy, the copy producer:
//   pages below 8 rows, or that neither divide 64 nor are a multiple of
//   it, such as 12): the producer's 128 threads copy each tile row's
//   16-byte chunks by cp.async straight into the stage's swizzled place
//   (the same address the code path stores to, so nothing is staged), a
//   block-table lookup a row made a tile ahead, zeros past the last key,
//   CW_STAGES - 1 tiles in flight; once a tile's copies have landed each
//   thread fences them for wgmma (the async proxy) and arrives on the
//   stage's full barrier.
// - code pools (kCodes, any block size; CHUNK = 16 codes a copy, or 8
//   where a row's codes are 8-byte aligned only, D % 16 == 8): each
//   thread copies
//   its own chunks (and one key's scale) into one of 3 staging buffers by
//   cp.async, and decodes them to bf16 (exactly) into the ring two tiles
//   later, when they have landed; decoding from TMA boxes was slower
//   (every thread waited for a whole tile).
// Warpgroup 1 consumes: S = Q K^T by wgmma from shared memory (both
// K-major), the k scale on S, the online softmax in f32 registers with
// exp2 and log2(e) folded into the scale (the mask only on the tiles
// that reach past the lowest row's frontier), the v scale on P after
// the row sum took the unscaled P, then O += P V with P from registers
// and V read MN-major (bf16: its rows past the last key zeroed first, as
// a page's unwritten slots may hold anything).  Tiles with the most keys
// launch first.
//
// The instance W (64, 128 or 256 columns) takes every head_dim D that is
// a multiple of 8 in (W / 2, W] (any D <= 64 for W = 64).  The columns
// D..W-1 of q, K and V are zeros in shared memory: the TMA maps'
// innermost extent is D, so TMA fills them for every head (a 2-D map
// over [nb * bs, KVH * D] would read the next head's columns there, and
// a page's unwritten slots may hold Inf); the copy producers zero-fill
// the chunks at or past D, and q's staging writes zeros there.  The
// products run at the instance's full width (no run-time guard around
// wgmma), so the padding costs W / D of the true products (1.33x at D =
// 96, 1.6x at 80); O's columns past D come out 0 and are not stored.
// Shared memory at W = 256 (Gemma's heads): 64-key tiles in 4 stages
// take 291 KB for bf16 pools and 389 KB with the code pools' staging; in
// 2 stages 162 KB and 260 KB; so W = 256 takes KEYS = 32 keys a tile
// (wgmma m64n32k16 for S) in 4 stages: 162 KB and 211 KB, under the
// 227 KB a block may have.  Its O is 128 f32 registers a consumer thread.
constexpr int CW_ROWS = 64, CW_THREADS = 256, CW_STAGES = 4;
constexpr int CW_QBOX = 64 * 128;  // [64 rows][64 bf16] swizzled, 8 KB
constexpr int CW_STAGING = 3;      // codes: tiles in flight a thread

template <int W>
__host__ __device__ constexpr int cw_keys() {
  return W == 256 ? 32 : 64;        // keys a K / V tile
}

struct CWMaps {
  CUtensorMap k, v;   // bf16 pools as (D, KVH, nb * bs): box (64, 1, R),
                      // 128-byte swizzle
};

// a staging buffer: K codes [KEYS][W], V codes [KEYS][W], k and v scales
template <int W>
__host__ __device__ constexpr int cw_staging_bytes() {
  return 2 * cw_keys<W>() * W + 2 * cw_keys<W>() * 4;
}

template <int W, int Q>
constexpr int cw_smem_bytes() {
  // alignment, Q, K and V per stage, the stages' key scales, the codes'
  // staging buffers, a full and an empty barrier a stage
  return 1024 + (W / 64) * (CW_QBOX + 2 * CW_STAGES * cw_keys<W>() * 128) +
         CW_STAGES * 2 * cw_keys<W>() * 4 +
         (Q == 0 ? 0 : CW_STAGING * cw_staging_bytes<W>()) +
         2 * CW_STAGES * 8;
}

// eight codes (8 bytes) as eight bf16 values, exactly (the values of
// decode_code): int8 through the f32 magic number 1.5 * 2^23, whose
// unit-spaced mantissa takes the code as an integer add and keeps it
// exact, then the f32's top half (a code has at most 8 significant
// bits); e4m3 two at a time through f16, which holds it exactly
template <int Q>
__device__ __forceinline__ uint4 codes_to_bf16x8(uint2 c) {
  const uint32_t in[2] = {c.x, c.y};
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if constexpr (Q == 1) {
      uint32_t u[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int v = static_cast<int>(in[k] << (24 - 8 * i)) >> 24;
        u[i] = __float_as_uint(__int_as_float(0x4B400000 + v) -
                               12582912.f);
      }
      w[2 * k] = __byte_perm(u[0], u[1], 0x7632);
      w[2 * k + 1] = __byte_perm(u[2], u[3], 0x7632);
    } else {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
            static_cast<__nv_fp8x2_storage_t>(in[k] >> (16 * i)), __NV_E4M3);
        const float2 f = __half22float2(__half2(h));
        w[2 * k + i] = pack_bf16(f.x, f.y);
      }
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The producer of the K / V tiles: bf16 pools by TMA boxes or by 16-byte
// cp.async copies, or code pools (Q != 0) copied CHUNK bytes at a time
// and decoded.  CHUNK is 16 except for code pools at D % 16 == 8, whose
// rows are only 8-byte aligned: the CHUNK = 8 instances exist only so
// that every head_dim that is a multiple of 8 has a wgmma instance (no
// configuration of the repo has such a head_dim), and can go if none
// ever needs them.
enum class CwLoad { kTma, kCopy, kCodes };

template <int W, int Q, CwLoad P, int CHUNK>
__global__ void __launch_bounds__(CW_THREADS, 1) chunked_prefill_wgmma(
    const __grid_constant__ CWMaps maps, const bf16* __restrict__ q,
    const void* __restrict__ k_pool, const void* __restrict__ v_pool,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ bt, const int* __restrict__ pos,
    bf16* __restrict__ out, int B, int Tc, int KVH, int rep, int D, int bs,
    int nbs, float scale) {
  using namespace hopper;
  constexpr int KEYS = cw_keys<W>();
  constexpr int KBOX = KEYS * 128;          // [KEYS rows][64 bf16]
  constexpr int QT = (W / 64) * CW_QBOX;    // the Q tile
  constexpr int KT = (W / 64) * KBOX;       // one K or V tile
  constexpr int STG = cw_staging_bytes<W>();
  extern __shared__ uint8_t cw_smem[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(cw_smem) + 1023) & ~uintptr_t(1023));
  uint8_t* qs = smem;
  uint8_t* ks = qs + QT;                            // CW_STAGES tiles
  uint8_t* vs = ks + CW_STAGES * KT;                // CW_STAGES tiles
  float* ksc = reinterpret_cast<float*>(vs + CW_STAGES * KT);
  float* vsc = ksc + CW_STAGES * KEYS;
  uint8_t* stg = reinterpret_cast<uint8_t*>(vsc + CW_STAGES * KEYS);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      stg + (Q == 0 ? 0 : CW_STAGING * STG));
  uint64_t* empty = full + CW_STAGES;

  const int RT = rep * Tc, H = KVH * rep;
  const int n_rt = (RT + CW_ROWS - 1) / CW_ROWS;
  const int rank = blockIdx.x / (B * KVH), rest = blockIdx.x % (B * KVH);
  const int b = rest / KVH, kvh = rest % KVH;
  const int row0 = (n_rt - 1 - rank) * CW_ROWS;
  const int start = pos[b];
  const int n_keys = nbs * bs;                      // the table's keys
  const int t_last = (min(row0 + CW_ROWS, RT) - 1) / rep;
  const int last_key = min(start + t_last, n_keys - 1);
  const int n_kt = last_key / KEYS + 1;
  // tiles that reach this key need the mask: the lowest row sees fewer
  const int mask_from = min(start + row0 / rep, n_keys - 1) + 1;
  const int R = min(bs, KEYS);                      // rows a box

  if (threadIdx.x == 0) {
    for (int s = 0; s < CW_STAGES; ++s) {
      // bf16 boxes: the TMA's expect_tx; copies, codes: every producer
      // thread
      mbar_init(&full[s], P == CwLoad::kTma ? 1 : 128);
      mbar_init(&empty[s], 4);    // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------------ producer
    const int tid = threadIdx.x, lane = tid % 32;
    const int* btb = bt + (size_t)b * nbs;
    if constexpr (P == CwLoad::kTma) {
      // bf16: warp 0 loads key tile `it` straight into ring stage s, one
      // TMA box a page and 64 columns (lane p reads page p's table entry)
      auto load_tile = [&](int it, int s) {
        const int kbase = it * KEYS;
        const int n_box = min(KEYS / R, (last_key - kbase) / R + 1);
        const int kp = kbase + lane * R;
        const int prow =
            lane < n_box ? __ldg(btb + kp / bs) * bs + kp % bs : 0;
        if (lane == 0) mbar_expect_tx(&full[s], n_box * R * 4 * W);
        for (int p = 0; p < n_box; ++p) {
          const int row = __shfl_sync(0xffffffffu, prow, p);
          if (lane != 0) continue;
#pragma unroll
          for (int x = 0; x < W / 64; ++x) {
            const uint32_t at = s * KT + x * KBOX + p * R * 128;
            tma_load_3d(ks + at, &maps.k, &full[s], x * 64, kvh, row);
            tma_load_3d(vs + at, &maps.v, &full[s], x * 64, kvh, row);
          }
        }
      };
      if (tid < 32)
        for (int it = 0; it < n_kt; ++it) {
          const int s = it % CW_STAGES;
          if (it >= CW_STAGES)
            mbar_wait(&empty[s], ((it / CW_STAGES) - 1) & 1);
          load_tile(it, s);
        }
    } else if constexpr (P == CwLoad::kCopy) {
      // bf16 pages of any size: each thread copies its own 16-byte chunks
      // (8 bf16) of a tile's rows straight into the ring stage, a
      // block-table lookup a row made a tile ahead, zeros past the last
      // key and at or past column D; tile it - (AHEAD - 1) has landed
      // once tile it is issued
      constexpr int CPR = W / 8;                    // 16-byte chunks a row
      constexpr int N = KEYS * CPR / 128;           // a thread's chunks
      constexpr int RSTEP = 128 / CPR;              // rows between them
      constexpr int AHEAD = CW_STAGES - 1;          // tiles in flight
      const int c = tid % CPR, j0 = tid / CPR;
      const bool live = c * 8 < D;
      const uint32_t col = (c / 8) * KBOX;
      const bf16* kpool = static_cast<const bf16*>(k_pool);
      const bf16* vpool = static_cast<const bf16*>(v_pool);
      int pr[N];
      auto rows_of = [&](int kbase) {
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const int kp = kbase + j0 + RSTEP * n;
          pr[n] = kp <= last_key && live
                      ? __ldg(btb + kp / bs) * bs + kp % bs : -1;
        }
      };
      auto land = [&](int i) {   // this thread's copies of tile i landed
        fence_proxy_async();     // before wgmma reads them
        mbar_arrive(&full[i % CW_STAGES]);
      };
      rows_of(0);
      for (int it = 0; it < n_kt; ++it) {
        const int s = it % CW_STAGES;
        if (it >= CW_STAGES) mbar_wait(&empty[s], ((it / CW_STAGES) - 1) & 1);
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const uint32_t at =
              s * KT + col + swz128(j0 + RSTEP * n, c % 8);
          const size_t off =
              ((size_t)max(pr[n], 0) * KVH + kvh) * D + (live ? c * 8 : 0);
          cp_async_16(smem_u32(ks + at), kpool + off, pr[n] >= 0);
          cp_async_16(smem_u32(vs + at), vpool + off, pr[n] >= 0);
        }
        cp_async_commit();
        if (it + 1 < n_kt) rows_of((it + 1) * KEYS);
        if (it >= AHEAD - 1) {
          cp_async_wait<AHEAD - 1>();
          land(it - (AHEAD - 1));
        }
      }
      cp_async_wait<0>();
      for (int i = max(n_kt - (AHEAD - 1), 0); i < n_kt; ++i) land(i);
    } else {
      // codes: each thread copies its own CHUNK-code chunks of a tile's rows
      // (a block-table lookup a row, made a tile ahead) and one key's k
      // or v scale into a staging buffer by cp.async (zeros past the
      // last key and at or past column D), and decodes them to bf16
      // (exactly) into the ring CW_STAGING - 1 tiles later, when they
      // have landed
      constexpr int CPR = W / CHUNK;                // chunks a row
      constexpr int N = KEYS * CPR / 128;           // a thread's chunks
      constexpr int RSTEP = 128 / CPR;              // rows between them
      const int c = tid % CPR, j0 = tid / CPR;
      const bool live = c * CHUNK < D;
      const uint8_t* kpool = static_cast<const uint8_t*>(k_pool);
      const uint8_t* vpool = static_cast<const uint8_t*>(v_pool);
      int pr[N], sr;
      auto rows_of = [&](int kbase) {
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const int kp = kbase + j0 + RSTEP * n;
          pr[n] = kp <= last_key && live
                      ? __ldg(btb + kp / bs) * bs + kp % bs : -1;
        }
        const int kp = kbase + tid % KEYS;
        sr = kp <= last_key ? __ldg(btb + kp / bs) * bs + kp % bs : -1;
      };
      auto decode = [&](int i) {
        const int s = i % CW_STAGES;
        const uint8_t* kc = stg + (i % CW_STAGING) * STG;
        const uint8_t* vc = kc + KEYS * W;
        const float* sc = reinterpret_cast<const float*>(vc + KEYS * W);
        if (i >= CW_STAGES) mbar_wait(&empty[s], ((i / CW_STAGES) - 1) & 1);
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const int j = j0 + RSTEP * n;
          if constexpr (CHUNK == 16) {
            // 16 codes: the 16-byte chunks 2 c and 2 c + 1 of the row
            const int cc = 2 * c;
            const uint32_t at = (cc / 8) * KBOX + swz128(j, cc % 8);
            const uint32_t at1 = (cc / 8) * KBOX + swz128(j, cc % 8 + 1);
            const uint4 kx = *reinterpret_cast<const uint4*>(kc + j * W +
                                                             c * 16);
            const uint4 vx = *reinterpret_cast<const uint4*>(vc + j * W +
                                                             c * 16);
            *reinterpret_cast<uint4*>(ks + s * KT + at) =
                codes_to_bf16x8<Q>(make_uint2(kx.x, kx.y));
            *reinterpret_cast<uint4*>(ks + s * KT + at1) =
                codes_to_bf16x8<Q>(make_uint2(kx.z, kx.w));
            *reinterpret_cast<uint4*>(vs + s * KT + at) =
                codes_to_bf16x8<Q>(make_uint2(vx.x, vx.y));
            *reinterpret_cast<uint4*>(vs + s * KT + at1) =
                codes_to_bf16x8<Q>(make_uint2(vx.z, vx.w));
          } else {
            // 8 codes: the 16-byte chunk c of the row
            const uint32_t at = (c / 8) * KBOX + swz128(j, c % 8);
            *reinterpret_cast<uint4*>(ks + s * KT + at) = codes_to_bf16x8<Q>(
                *reinterpret_cast<const uint2*>(kc + j * W + c * 8));
            *reinterpret_cast<uint4*>(vs + s * KT + at) = codes_to_bf16x8<Q>(
                *reinterpret_cast<const uint2*>(vc + j * W + c * 8));
          }
        }
        if (tid < 2 * KEYS)
          (tid < KEYS ? ksc : vsc)[s * KEYS + tid % KEYS] = sc[tid];
        fence_proxy_async();   // the stores, before wgmma reads them
        mbar_arrive(&full[s]);
      };
      rows_of(0);
      for (int it = 0; it < n_kt; ++it) {
        uint8_t* kd = stg + (it % CW_STAGING) * STG;
        uint8_t* vd = kd + KEYS * W;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const int j = j0 + RSTEP * n;
          const size_t off =
              ((size_t)max(pr[n], 0) * KVH + kvh) * D +
              (live ? c * CHUNK : 0);
          if constexpr (CHUNK == 16) {
            cp_async_16(smem_u32(kd + j * W + c * 16), kpool + off,
                        pr[n] >= 0);
            cp_async_16(smem_u32(vd + j * W + c * 16), vpool + off,
                        pr[n] >= 0);
          } else {
            cp_async_8(smem_u32(kd + j * W + c * 8), kpool + off, pr[n] >= 0);
            cp_async_8(smem_u32(vd + j * W + c * 8), vpool + off, pr[n] >= 0);
          }
        }
        if (tid < 2 * KEYS)
          cp_async_4(smem_u32(vd + KEYS * W + tid * 4),
                     (tid < KEYS ? k_scale : v_scale) + max(sr, 0), sr >= 0);
        cp_async_commit();
        if (it >= CW_STAGING - 1) {   // that tile's copies have landed
          cp_async_wait<CW_STAGING - 1>();
          decode(it - (CW_STAGING - 1));
        }
        if (it + 1 < n_kt) rows_of((it + 1) * KEYS);
      }
      cp_async_wait<0>();
      for (int i = max(n_kt - (CW_STAGING - 1), 0); i < n_kt; ++i) decode(i);
    }
  } else {
    // ------------------------------------------------------ consumer
    const int ct = threadIdx.x - 128;
    const int warp = ct / 32, lane = ct % 32, g = lane / 4, tg = lane % 4;
    // stage the tile's q rows (rows past rep * T and columns past D are
    // zeros)
    {
      constexpr int CPR = W / 8;
#pragma unroll
      for (int n = 0; n < CW_ROWS * CPR / 128; ++n) {
        const int i = ct + 128 * n, j = i / CPR, c = i % CPR;
        const int row = row0 + j;
        uint4 v = zero4();
        if (row < RT && c * 8 < D)
          v = __ldg(reinterpret_cast<const uint4*>(
              q + (((size_t)b * Tc + row / rep) * H + kvh * rep + row % rep) *
                      D + c * 8));
        *reinterpret_cast<uint4*>(qs + (c / 8) * CW_QBOX + swz128(j, c % 8)) =
            v;
      }
      fence_proxy_async();
      named_bar_sync(1, 128);
    }
    int row[2], lim[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      row[i] = row0 + warp * 16 + g + 8 * i;
      lim[i] = min(start + row[i] / rep, n_keys - 1) + 1;
    }
    const float scale_log2 = scale * 1.4426950408889634f;
    float o[W / 2];
#pragma unroll
    for (int i = 0; i < W / 2; ++i) o[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // m in log2 units
    const uint32_t qa = smem_u32(qs);

    for (int it = 0; it < n_kt; ++it) {
      const int s = it % CW_STAGES, kbase = it * KEYS;
      const uint32_t ka = smem_u32(ks + s * KT);
      const uint32_t va = smem_u32(vs + s * KT);
      float sc[KEYS / 2];
#pragma unroll
      for (int i = 0; i < KEYS / 2; ++i) sc[i] = 0.f;
      mbar_wait(&full[s], (it / CW_STAGES) & 1);
      wgmma_fence();
      fence_regs<KEYS / 2>(sc);
#pragma unroll
      for (int kk = 0; kk < W / 16; ++kk) {
        const uint32_t qo = (kk / 4) * CW_QBOX + (kk % 4) * 32;
        const uint32_t ko = (kk / 4) * KBOX + (kk % 4) * 32;
        wgmma_ss_kk<KEYS>(sc, desc_sw128(qa + qo, 16, 1024),
                          desc_sw128(ka + ko, 16, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<KEYS / 2>(sc);

      // sc[4 j + 2 i + c]: row g + 8 i, key kbase + 8 j + 2 tg + c
      if constexpr (Q != 0) {
#pragma unroll
        for (int j = 0; j < KEYS / 8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            sc[4 * j + c] *= ksc[s * KEYS + 8 * j + 2 * tg + (c & 1)];
      }
      if (kbase + KEYS > mask_from) {
#pragma unroll
        for (int j = 0; j < KEYS / 8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (kbase + 8 * j + 2 * tg + (c & 1) >= lim[c >> 1])
              sc[4 * j + c] = -INFINITY;
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < KEYS / 8; ++j)
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
      for (int j = 0; j < KEYS / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float e = exp2f(fmaf(sc[4 * j + c], scale_log2, -m[c >> 1]));
          sc[4 * j + c] = e;
          lsum[c >> 1] += e;
        }
      // this lane's share of each row sum; the 4 lanes meet at the end
      l[0] = l[0] * alpha[0] + lsum[0];
      l[1] = l[1] * alpha[1] + lsum[1];
      if constexpr (Q != 0) {
        // V's scale rides on P, after the sum took the unscaled P
#pragma unroll
        for (int j = 0; j < KEYS / 8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            sc[4 * j + c] *= vsc[s * KEYS + 8 * j + 2 * tg + (c & 1)];
      }
#pragma unroll
      for (int j = 0; j < W / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) o[4 * j + c] *= alpha[c >> 1];
      uint32_t pa[KEYS / 16][4];
#pragma unroll
      for (int kk = 0; kk < KEYS / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
      if (Q == 0 && kbase + KEYS > last_key + 1) {
        // V rows past the last key: whatever the page's unwritten slots
        // (or an earlier tile) left there, zeros, since 0 * NaN is NaN
        const int z0 = last_key + 1 - kbase;
        for (int i = ct; i < (KEYS - z0) * 8 * (W / 64); i += 128) {
          const int j = z0 + i / (8 * (W / 64)), r = i % (8 * (W / 64));
          *reinterpret_cast<uint4*>(vs + s * KT + (r / 8) * KBOX + j * 128 +
                                    (r % 8) * 16) = zero4();
        }
        fence_proxy_async();   // before wgmma reads them
        named_bar_sync(1, 128);
      }

      wgmma_fence();
      fence_regs<W / 2>(o);
#pragma unroll
      for (int kk = 0; kk < KEYS / 16; ++kk)
        wgmma_rs_w<W>(o, pa[kk], desc_sw128(va + kk * 16 * 128, KBOX, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<W / 2>(o);
      keep_regs<4 * (KEYS / 16)>(&pa[0][0]);
      // every lane's reads of the stage (its scales with ld.shared),
      // then lane 0 frees it for the producer's next copy
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (row[i] >= RT) continue;
      const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
      const int t = row[i] / rep, r = row[i] % rep;
      bf16* orow = out + (((size_t)b * Tc + t) * H + kvh * rep + r) * D;
      // columns 8 j .. 8 j + 7 (D is a multiple of 8): past D lie the
      // next head's columns
#pragma unroll
      for (int j = 0; j < W / 8; ++j)
        if (8 * j < D)
          *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * tg) = pack_bf16(
              o[4 * j + 2 * i] * inv_l, o[4 * j + 2 * i + 1] * inv_l);
    }
  }
}

template <int W, int Q, CwLoad P, int CHUNK>
int launch_chunk_wgmma(const bf16* q, const void* k_pool,
                              const void* v_pool, const float* k_scale,
                              const float* v_scale, const int* bt,
                              const int* pos, bf16* out, int B, int Tc,
                              int KVH, int rep, int D, int bs, int nb,
                              int nbs, float scale, cudaStream_t st) {
  // bf16 pools as (D, KVH, nb * bs); a box is R rows of one kv head's 64
  // columns, zeros past D
  CWMaps maps{};
  if (P == CwLoad::kTma) {
    const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)KVH,
                                (cuuint64_t)nb * bs};
    const cuuint64_t strides[2] = {(cuuint64_t)D * 2,
                                   (cuuint64_t)KVH * D * 2};
    const cuuint32_t box[3] = {
        64, 1, (cuuint32_t)(bs < cw_keys<W>() ? bs : cw_keys<W>())};
    if (!(hopper::make_map_bf16(&maps.k, k_pool, 3, dims, strides, box) &&
          hopper::make_map_bf16(&maps.v, v_pool, 3, dims, strides, box)))
      return (int)cudaErrorInvalidValue;
  }
  constexpr int smem = cw_smem_bytes<W, Q>();
  const cudaError_t e = cudaFuncSetAttribute(
      chunked_prefill_wgmma<W, Q, P, CHUNK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int n_rt = (rep * Tc + CW_ROWS - 1) / CW_ROWS;
  chunked_prefill_wgmma<W, Q, P, CHUNK><<<n_rt * B * KVH, CW_THREADS, smem, st>>>(
      maps, q, k_pool, v_pool, k_scale, v_scale, bt, pos, out, B, Tc, KVH,
      rep, D, bs, nbs, scale);
  return (int)cudaGetLastError();
}

// the instances of each unit past 0 (the file's head comment), each
// declaration after X (nothing, or extern in unit 0)
#define CP_INST(X, W, Q, P, C)                                             \
  X template int launch_chunk_wgmma<W, Q, CwLoad::P, C>(                  \
      const bf16*, const void*, const void*, const float*, const float*,   \
      const int*, const int*, bf16*, int, int, int, int, int, int, int, int, \
      float, cudaStream_t);
#define CP_BF16_UNIT(X, W) \
  CP_INST(X, W, 0, kCopy, 16) CP_INST(X, W, 0, kTma, 16)
#define CP_CODE_UNIT(X, W, Q) \
  CP_INST(X, W, Q, kCodes, 8) CP_INST(X, W, Q, kCodes, 16)
#define CP_UNIT_1(X) \
  CP_BF16_UNIT(X, 64) CP_BF16_UNIT(X, 128) CP_BF16_UNIT(X, 256)
#define CP_UNIT_2(X) \
  CP_CODE_UNIT(X, 64, 1) CP_CODE_UNIT(X, 128, 1) CP_CODE_UNIT(X, 256, 1)
#define CP_UNIT_3(X) \
  CP_CODE_UNIT(X, 64, 2) CP_CODE_UNIT(X, 128, 2) CP_CODE_UNIT(X, 256, 2)
#define CP_CAT_(a, b) a##b
#define CP_CAT(a, b) CP_CAT_(a, b)
#if defined(CP_UNIT) && CP_UNIT > 0
CP_CAT(CP_UNIT_, CP_UNIT)()
#else
#if defined(CP_UNIT)
CP_UNIT_1(extern) CP_UNIT_2(extern) CP_UNIT_3(extern)
#endif

// the wgmma instance of width W over pools of Q: bf16 pools by TMA boxes
// or by the copy producer (`copy`), code pools `chunk` codes a copy
template <int W, int Q>
static auto chunk_wgmma_launcher(bool copy, int chunk) {
  if constexpr (Q == 0)
    return copy ? launch_chunk_wgmma<W, 0, CwLoad::kCopy, 16>
                : launch_chunk_wgmma<W, 0, CwLoad::kTma, 16>;
  else
    return chunk == 8 ? launch_chunk_wgmma<W, Q, CwLoad::kCodes, 8>
                      : launch_chunk_wgmma<W, Q, CwLoad::kCodes, 16>;
}

// the block sizes the bf16 kernel loads from bf16 pools by TMA: pages of
// a multiple of CW_PAGE_ROWS rows, or of 8 to CW_PAGE_ROWS rows that
// divide it, so that a key tile (64 keys, 32 at W = 256) is whole boxes
// of one page's rows (the rest take the copy producer)
constexpr int CW_PAGE_ROWS = 64;
static bool cw_block_size_ok(int bs) {
  return bs % CW_PAGE_ROWS == 0 || (bs >= 8 && CW_PAGE_ROWS % bs == 0);
}

extern "C" int chunked_prefill_smem_bytes(int D, int bs) {
  const int kt = bs < CP_KEYS ? bs : CP_KEYS;
  return (int)sizeof(float) * (CP_ROWS * (D + 1) + kt * (2 * D + 1) +
                               CP_ROWS * (kt + 1) + 3 * CP_ROWS);
}

template <typename T, int Q, int MAXD>
static int launch_chunk_general(const void* q, const void* k_pool,
                                const void* v_pool, const float* k_scale,
                                const float* v_scale, const int* bt,
                                const int* pos, void* out, int B, int Tc,
                                int KVH, int rep, int D, int bs, int nbs,
                                float scale, cudaStream_t st) {
  const int smem = chunked_prefill_smem_bytes(D, bs);
  const cudaError_t e = cudaFuncSetAttribute(
      chunked_prefill_kernel<T, Q, MAXD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B, KVH, (rep * Tc + CP_ROWS - 1) / CP_ROWS);
  chunked_prefill_kernel<T, Q, MAXD><<<grid, CP_THREADS, smem, st>>>(
      (const T*)q, k_pool, v_pool, k_scale, v_scale, bt, pos, (T*)out, Tc,
      KVH, rep, D, bs, nbs, scale);
  return (int)cudaGetLastError();
}

// wgmma (the wrapper's route, kernels/chunked_prefill.py wgmma_width):
// the bf16 wgmma kernel, D a multiple of 8 up to 256 on the instance of
// 64, 128 or 256 columns that holds it, over bf16 or code pools of any
// block size, q, the pools and the scales 16-byte aligned; copy (the
// wrapper's copy_producer): bf16 pools whose block size is not whole TMA
// boxes (cw_block_size_ok), loaded by cp.async.  Otherwise the general
// CUDA-core instance of q's type (dtype 0 f32, 1 bf16): any D <= CP_MAXD
// and block size.  kv: what the pools hold (0 q's type, 1 int8 codes, 2
// fp8 codes, with the scales)
extern "C" int chunked_prefill(const void* q, const void* k_pool,
                               const void* v_pool, const void* k_scale,
                               const void* v_scale, const void* bt,
                               const void* pos, void* out, int B, int Tc,
                               int KVH, int rep, int D, int bs, int nb,
                               int nbs, float scale, int dtype, int kv,
                               int wgmma, int copy, void* stream) {
  if (B == 0 || Tc == 0) return 0;
  if (D > CP_MAXD || bs <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int* btp = (const int*)bt;
  const int* posp = (const int*)pos;
  const float* ksp = (const float*)k_scale;
  const float* vsp = (const float*)v_scale;
  int err = 0;
  DISPATCH_KV(kv, Q, {
    if (wgmma) {
      if (dtype != 1 || D <= 0 || D % 8 ||
          copy != (Q == 0 && !cw_block_size_ok(bs)))
        return (int)cudaErrorInvalidValue;
      // code rows are 16-byte aligned where D % 16 == 0, else 8-byte
      const int chunk = D % 16 ? 8 : 16;
      auto launch = D <= 64    ? chunk_wgmma_launcher<64, Q>(copy, chunk)
                    : D <= 128 ? chunk_wgmma_launcher<128, Q>(copy, chunk)
                               : chunk_wgmma_launcher<256, Q>(copy, chunk);
      return launch((const bf16*)q, k_pool, v_pool, ksp, vsp, btp, posp,
                    (bf16*)out, B, Tc, KVH, rep, D, bs, nb, nbs, scale, st);
    }
    DISPATCH_DTYPE(dtype, T, {
      auto launch = D <= 128 ? launch_chunk_general<T, Q, 128>
                             : launch_chunk_general<T, Q, CP_MAXD>;
      err = launch(q, k_pool, v_pool, ksp, vsp, btp, posp, out, B, Tc, KVH,
                   rep, D, bs, nbs, scale, st);
    });
  });
  return err;
}
#endif  // unit 0
