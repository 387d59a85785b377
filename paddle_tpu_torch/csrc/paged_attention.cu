// One decode step of paged attention over the block pool, split-K
// (flash-decoding), with q's RoPE and the 1/sqrt(D) fold inside.
//
// Replaces paddle_tpu/kernels/paged_attention.py _decode_kernel
// (pallas_call in _pallas_partials) and its _combine_splits merge, with
// its kv_dtype variant (quantized pools: Q = 1 int8, Q = 2 fp8 codes
// and one f32 scale per (block, token) row).  The new token's k/v are
// rotated and scattered into the pools by the caller before this runs.
//
// On the TPU the grid (batch, split, page) walks pages in order and
// carries (acc, m, l) in VMEM from one page to the next.  Here blocks
// run in parallel in no order, so a block owns a share of one (batch,
// kv head)'s keys and keeps its own (acc, m, l), and the shares are
// merged with the log-sum-exp combine.
//
// Bound on the H100: bytes in principle (each live K/V row is read
// once; the scores and P.V are 2*D flops per 2*D*sizeof bytes, far
// below the tensor cores' ratio: 5.8 us for a B = 8 step over 4703
// keys in bf16).  In practice a decode step is small enough that the
// instructions each key costs, and the chain pos -> table -> rows ->
// merge, set the time; the design cuts both:
//
// - paged_decode_hopper (bf16 q over bf16, int8 or fp8 pools; the serving
//   path).  The grid is (S, KVH * G, B) and the work follows the live
//   context, on the device: sequence b's len = pos[b] + 1 keys are cut
//   into chunks of PF_CHUNK keys, and block s takes a contiguous run of
//   ceil(chunks / S) of them; a block past the frontier exits at once.
//   S comes from the wrapper (decode_plan: PF_MIN_BLOCKS blocks a SM, as
//   many as the registers let reside, so the live blocks run in one
//   wave), and the scratch of [B, S, H, D] partials is sized without a
//   host sync.  num_splits, which the JAX function and the plain
//   version take, does not shape this partition: the two agree up to
//   the order of f32 sums.  A warp takes PF_STEP keys a step (half as
//   many at 256 columns), the steps of its block dealt round-robin to
//   the 4 warps; a key's row of this kv head (D * 2 bytes in bf16, D
//   bytes of codes) is spread over W / 8 lanes with one load each (16
//   bytes of bf16, 8 of codes), the pages
//   of a step are read two steps ahead and its rows one step ahead (a
//   cp.async ring of 2-4 steps, tried, was no faster: the loads are not
//   what waits).  Codes are decoded in registers, exactly decode_code's
//   values, and the row's scale multiplies the score and the row's
//   weight in P.V rather than each element.  q of the group's rep heads
//   is rotated and scaled once, in f32 with log2(e) folded in, and stays
//   in registers with the partial dot products; the scores are reduced
//   by shuffles, each warp runs an online softmax on ex2.approx (masked
//   keys at weight exactly 0) and accumulates P.V in registers, and the
//   warps meet in shared memory in a fixed order.  The last block of a
//   (batch, kv head) to finish, counted by an atomic ticket, merges the
//   blocks' shares in block order and writes the output: one launch,
//   and two runs give the same bits.
//   Any GQA rep: the kernel is built for REP in {1, 2, 4} q heads a
//   block and takes the true rep at run time.  A kv head's rep heads
//   are cut into G = ceil(rep / 4) sub-groups of ceil(rep / G) heads on
//   the grid's y axis, each run in the smallest REP that holds it (rep 3
//   in REP 4, rep 7 in blocks of 4 and 3 heads, rep 16 in four), each
//   re-reading its kv head's rows (from the L2: a kv head's sub-groups
//   run together); rows past a sub-group's heads load no q, stay out of
//   the merges and write nothing.  An instance of 8 heads a block
//   spilled at the 168 registers of 3 blocks a SM and took 2.1x the
//   time of two blocks of 4 at Qwen2-7B's shape (an H100 80GB HBM3 at
//   700 W, PERF.md).  Any page size: a
//   power of two finds a key's page and row with a shift and a mask
//   (POW2); any other with a division by the page size through a
//   multiplier from the host (__umulhi, exact below 2^31 keys), once a
//   key a step, into the key's pool row, so the loads that follow are
//   the same.
//   Any head_dim D that is a multiple of 8 up to 256: the lanes of a key
//   and the warp's key groups are summed by xor-shuffle trees, which
//   need W / 8 lanes a key to be a power of two.  D = 64 and 128 run on
//   instances of W = D columns with D known at compile time; every other
//   D on the padded instance of the smallest W in {64, 128, 256} that
//   holds it (Phi-2's 80 and Phi-3's 96 on 128 columns, Gemma's 256 on
//   256), with D, and the cos/sin rows' type, read at run time (a
//   run-time shape costs the common path, so 64 and 128 keep theirs).
//   A lane whose 8 columns start at or past D loads nothing (the next kv
//   head's columns follow in the pool row, and an unwritten slot there
//   may hold Inf), holds q = 0 and partial sums of exactly 0, and the
//   stores stop at D: such lanes cost issue slots, not bytes (4 of 16 a
//   key at 96).  The rotation takes the half of D of each dim, since at
//   D % 16 == 8 a lane's 8 dims straddle the halves.  At 256 columns a
//   warp's load is one key, so a step takes 4 keys, not 8: the K/V
//   registers of a step and the next one stay those of 128 columns,
//   within the 168 registers of 3 blocks a SM; a padded instance of 4
//   heads over pages found by division takes half as many keys a step
//   again (it spilled; chip_smoke.py phase 1 fails on any spill of a
//   padded instance).  The instances of 64 and 128 columns keep their
//   instructions, and with them the 16-byte spill that those of 4 heads
//   over pages found by division had before the padded ones.
// - paged_decode_partials<T, CS, Q> and paged_decode_combine<T>, the
//   general instance (every shape the Hopper kernel is not built for:
//   bf16 head_dims that are not a multiple of 8, unaligned pools; f32,
//   which only the tests serve), two launches: a block owns
//   one (batch, kv head, split) of the wrapper's general_plan, takes pages
//   round-robin (page p to split p % S) up to the frontier, stages each
//   page's keys PD_KEYS at a time in shared memory as f32 (converted on
//   load: the staging's size does not depend on T) and scores them
//   against the group's q heads; a second kernel merges the splits and
//   rounds once to T.  Simple rather than fast: it serves the shapes
//   that the fast kernel does not.
#include "common.cuh"

constexpr int PD_THREADS = 128;
constexpr int PD_KEYS = 32;    // keys of a page staged at once

// T: q's, the output's and (Q == 0) the pools' type; CS: cos/sin's.
// Every sum in f32; the partials stay f32 for the combine's one rounding
template <typename T, typename CS, int Q>
__global__ void __launch_bounds__(PD_THREADS) paged_decode_partials(
    const T* __restrict__ q,        // [B, H, D] unrotated, H = KVH * rep
    const CS* __restrict__ cs,      // [B, D/2] cos at each frontier
    const CS* __restrict__ sn,      // [B, D/2] sin at each frontier
    const void* __restrict__ k_pool,  // [nb, bs, KVH, D] T, or int8 codes
    const void* __restrict__ v_pool,
    const float* __restrict__ k_scale,  // [nb, bs] (Q > 0)
    const float* __restrict__ v_scale,
    const int* __restrict__ bt,     // [B, nbs]
    const int* __restrict__ pos,    // [B]
    float* __restrict__ acc_out,    // [B, S, H, D]
    float* __restrict__ m_out,      // [B, S, H]
    float* __restrict__ l_out,      // [B, S, H]
    int KVH, int rep, int D, int bs, int nbs, int S, float scale) {
  extern __shared__ float sm[];
  const int b = blockIdx.x, kvh = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, H = KVH * rep, half = D / 2;
  const int kt = min(bs, PD_KEYS);
  float* q_s = sm;                     // [rep, D]
  float* k_s = q_s + rep * D;          // [kt, D + 1]
  float* v_s = k_s + kt * (D + 1);     // [kt, D]
  float* p_s = v_s + kt * D;           // [rep, kt]
  float* acc_s = p_s + rep * kt;       // [rep, D]
  float* m_s = acc_s + rep * D;        // [rep]
  float* l_s = m_s + rep;              // [rep]
  float* a_s = l_s + rep;              // [rep]
  const int frontier = pos[b];

  // rotate-half RoPE on the group's q heads in f32, then the 1/sqrt(D)
  for (int i = tid; i < rep * D; i += PD_THREADS) {
    const int r = i / D, d = i % D, j = d < half ? d : d - half;
    const T* qr = q + ((size_t)b * H + kvh * rep + r) * D;
    const float x1 = to_f32(qr[j]), x2 = to_f32(qr[j + half]);
    const float c = to_f32(cs[b * half + j]), sv = to_f32(sn[b * half + j]);
    q_s[i] = (d < half ? x1 * c - x2 * sv : x2 * c + x1 * sv) * scale;
    acc_s[i] = 0.f;
  }
  if (tid < rep) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  // pages round-robin (page p to split p % S), each in tiles of kt keys
  // up to the frontier
  const int last_page = min(frontier / bs, nbs - 1);
  const size_t row_stride = (size_t)KVH * D;
  for (int page = s; page <= last_page; page += S) {
    const size_t row0 = (size_t)bt[b * nbs + page] * bs;
    const size_t base = (row0 * KVH + kvh) * D;
    for (int t0 = 0; t0 < bs && page * bs + t0 <= frontier; t0 += kt) {
      const int nt = min(kt, bs - t0);
      for (int i = tid; i < nt * D; i += PD_THREADS) {
        const int t = i / D, d = i % D;
        const size_t off = base + (t0 + t) * row_stride + d;
        k_s[t * (D + 1) + d] =
            load_kv<T, Q>(k_pool, k_scale, off, row0 + t0 + t);
        v_s[i] = load_kv<T, Q>(v_pool, v_scale, off, row0 + t0 + t);
      }
      __syncthreads();
      const int key0 = page * bs + t0;
      for (int i = tid; i < rep * nt; i += PD_THREADS) {
        const int r = i / nt, t = i % nt;
        const float* qr = q_s + r * D;
        const float* kr = k_s + t * (D + 1);
        float sc = 0.f;
        for (int d = 0; d < D; ++d) sc = fmaf(qr[d], kr[d], sc);
        p_s[r * kt + t] = key0 + t <= frontier ? sc : NEG_INF;
      }
      __syncthreads();
      if (tid < rep) {
        float* pr = p_s + tid * kt;
        float mc = NEG_INF;
        for (int t = 0; t < nt; ++t) mc = fmaxf(mc, pr[t]);
        const float mn = fmaxf(m_s[tid], mc);
        const float alpha = expf(m_s[tid] - mn);
        float sum = 0.f;
        for (int t = 0; t < nt; ++t) {
          const float e = key0 + t <= frontier ? expf(pr[t] - mn) : 0.f;
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
        const float* pr = p_s + r * kt;
        float a = acc_s[i] * a_s[r];
        for (int t = 0; t < nt; ++t) a = fmaf(pr[t], v_s[t * D + d], a);
        acc_s[i] = a;
      }
      __syncthreads();
    }
  }

  const size_t head0 = ((size_t)b * S + s) * H + kvh * rep;
  for (int i = tid; i < rep * D; i += PD_THREADS)
    acc_out[head0 * D + i] = acc_s[i];
  if (tid < rep) {
    m_out[head0 + tid] = m_s[tid];
    l_out[head0 + tid] = l_s[tid];
  }
}

// log-sum-exp merge of the S split partials, one rounding to T; one
// block per (b, head)
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

// ------------------------------------------------ bf16 q: the Hopper path
constexpr int PF_WARPS = 4;
constexpr int PF_THREADS = 32 * PF_WARPS;
constexpr int PF_CHUNK = 64;   // keys a chunk (kernels/paged_attention.py)
constexpr int PF_STEP = 8;     // keys a warp takes a step
constexpr int PF_MAX_SPLITS = 64;  // blocks a (b, kv head) (MAX_SPLITS)
constexpr int PF_MIN_BLOCKS = 3;   // resident blocks a SM: the registers

template <int BYTES>
struct RawT;
template <>
struct RawT<16> {
  using type = uint4;
};
template <>
struct RawT<8> {
  using type = uint2;
};

// elements of a key row one lane loads: 8, that is 16 bytes of bf16 or
// 8 bytes of codes (16 codes would double the registers of q and the
// sums, and cost more time in the spills than the wider load saves)
constexpr int PF_EPL = 8;

// EPL elements of a key row in f32: bf16 as stored, or the codes'
// values, decode_code's exactly (int8 through the float 2^23 + 128 + c,
// fp8 two at a time through f16, both exact); the row's scale is applied
// to the score and to the weight of the row's V
template <int Q, int EPL, typename Raw>
__device__ __forceinline__ void unpack(const Raw& raw, float* out) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&raw);
  if constexpr (Q == 0) {
#pragma unroll
    for (int i = 0; i < EPL / 2; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else if constexpr (Q == 1) {
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      const uint32_t biased = w[i / 4] ^ 0x80808080u;   // c + 128 a byte
      out[i] = __uint_as_float(__byte_perm(biased, 0x4B000000u,
                                           0x7440 + i % 4)) -
               8388736.f;
    }
  } else {
#pragma unroll
    for (int i = 0; i < EPL / 2; ++i) {
      const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
          static_cast<__nv_fp8x2_storage_t>(w[i / 2] >> (16 * (i % 2))),
          __NV_E4M3);
      const float2 f = __half22float2(__half2(h));
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
}

// 2^x in one MUFU op (ex2.approx.ftz: relative error 2^-22, 0 for very
// negative x, so a masked or empty share weighs exactly 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// a key's page, n / bs for n < 2^31, from the host's (magic, shift) of
// bs (kernels/paged_attention.py div_magic)
__device__ __forceinline__ int fast_div(int n, uint32_t magic, int shift) {
  return (int)((__umulhi((uint32_t)n, magic) + (uint32_t)n) >> shift);
}

// the cos/sin rows of the padded instances, whose type (f32 or bf16) the
// kernel reads at run time from cs_bf16: their rows are read once a block
struct CSRuntime {};

template <typename CS>
__device__ __forceinline__ float load_cs(const CS* p, int i, int) {
  return to_f32(p[i]);
}
template <>
__device__ __forceinline__ float load_cs<CSRuntime>(const CSRuntime* p,
                                                    int i, int cs_bf16) {
  return cs_bf16 ? to_f32(reinterpret_cast<const bf16*>(p)[i])
                 : reinterpret_cast<const float*>(p)[i];
}

// W: the columns a key row is spread over (W / 8 lanes); PAD: the head
// dim D = d_rt, a multiple of 8 up to W, taken at run time (the lanes
// whose columns start at or past D load nothing, hold q = 0 and partial
// sums of exactly 0 and store nothing), else D = W (the instances of 64
// and 128, whose instructions stay those they had before the padded
// ones); CS: the type of the cos/sin rows (f32, bf16 as the model's
// tables, or CSRuntime); POW2: bs = 1 << bs_shift, else bs with its
// (bs_magic, bs_shift); FULL: rep == REP in one sub-group, every head
// count and index known at compile time (the Llama-3-8B and Mixtral
// shapes keep the instructions they had before the runtime rep: without
// it their decode took 9 % longer on an H100 80GB HBM3 at 700 W,
// PERF.md)
template <int Q, int W, int REP, bool POW2, bool FULL, bool PAD, typename CS>
__global__ void __launch_bounds__(PF_THREADS, PF_MIN_BLOCKS)
    paged_decode_hopper(
    const bf16* __restrict__ q, const CS* __restrict__ cs,
    const CS* __restrict__ sn, const void* __restrict__ k_pool,
    const void* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ bt,
    const int* __restrict__ pos, float* __restrict__ acc_out,
    float* __restrict__ m_out, float* __restrict__ l_out,
    int* __restrict__ tickets, bf16* __restrict__ out, int KVH, int rep,
    int groups, int bs, uint32_t bs_magic, int bs_shift, int nbs,
    float scale, int d_rt, int cs_bf16) {
  static_assert(!PAD || !FULL, "the padded instances take a run-time rep");
  constexpr int EPL = PF_EPL;
  constexpr int ESZ = Q == 0 ? 2 : 1;        // bytes an element
  constexpr int LPK = W / EPL;               // lanes a key row
  constexpr int KPW = 32 / LPK;              // keys a warp's load
  // keys a warp takes a step: at 256 columns a load is one key, and 8
  // of them would double the K/V registers of a step and the next; a
  // padded instance of 4 heads over pages found by division takes half
  // as many again (with PF_STEP it spilled at 128 and 256 columns)
  constexpr int STEP = (W == 256 ? PF_STEP / 2 : PF_STEP) /
                       (PAD && REP == 4 && !POW2 && W >= 128 ? 2 : 1);
  constexpr int U = STEP / KPW;              // loads a step
  static_assert(KPW <= STEP && STEP % KPW == 0, "step of whole loads");
  using Raw = typename RawT<EPL * ESZ>::type;
  __shared__ float wacc[PF_WARPS][REP][W];
  __shared__ float wm[PF_WARPS][REP], wl[PF_WARPS][REP];

  const int D = PAD ? d_rt : W;
  const int s = blockIdx.x, b = blockIdx.z;
  const int kvh = FULL ? blockIdx.y : blockIdx.y / groups;
  const int sub = FULL ? 0 : blockIdx.y % groups;
  // this block's q heads: nr <= REP of the kv head's rep, from hd0 on
  const int gsize = FULL ? REP : (rep + groups - 1) / groups;
  const int nr = FULL ? REP : min(gsize, rep - sub * gsize);
  const int S = gridDim.x, H = KVH * (FULL ? REP : rep);
  const int hd0 = FULL ? kvh * REP : kvh * rep + sub * gsize;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / LPK, d0 = (lane % LPK) * EPL;
  const bool on = !PAD || d0 < D;            // this lane's columns: dims
  const size_t head0 = ((size_t)b * S + s) * H + hd0;

  // the group's q heads rotated (rotate-half RoPE) and scaled, in f32,
  // with log2(e) folded in so that the softmax runs on exp2 (its loads
  // go out before pos[b]'s); at 64 and 128 columns a lane's EPL dims lie
  // in one half of D, a padded instance takes the half of each dim (at
  // D % 16 == 8 a lane's dims straddle the halves)
  float qr[REP][EPL];
  {
    const int half = D / 2;
    const float qscale = scale * 1.4426950408889634f;
    const bool lo = d0 < half;
    const int j0 = lo ? d0 : d0 - half;
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const bf16* qh = q + ((size_t)b * H + hd0 + r) * D;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        if (r >= nr || !on) {   // a padded row or column: no q
          qr[r][e] = 0.f;
          continue;
        }
        const bool lo_e = PAD ? d0 + e < half : lo;
        const int j = PAD ? (lo_e ? d0 + e : d0 + e - half) : j0 + e;
        const float x1 = to_f32(qh[j]), x2 = to_f32(qh[j + half]);
        const float c = load_cs(cs, b * half + j, cs_bf16);
        const float sv = load_cs(sn, b * half + j, cs_bf16);
        qr[r][e] = (lo_e ? x1 * c - x2 * sv : x2 * c + x1 * sv) * qscale;
      }
    }
  }

  // this block's keys: a contiguous run of whole chunks of the live ones
  const int len = min(pos[b] + 1, POW2 ? nbs << bs_shift : nbs * bs);
  const int chunks = (len + PF_CHUNK - 1) / PF_CHUNK;
  const int per = (chunks + S - 1) / S;
  const int live = (chunks + per - 1) / per;   // blocks with keys
  if (s >= live) return;                       // past the frontier
  const int kb = s * per * PF_CHUNK, ke = min(len, kb + per * PF_CHUNK);

  const uint8_t* kp = static_cast<const uint8_t*>(k_pool);
  const uint8_t* vp = static_cast<const uint8_t*>(v_pool);
  const int* btb = bt + (size_t)b * nbs;
  // a lane's keys of the step at k0; a key past the block's end is the
  // last live one (its weight is 0 later)
  auto key_of = [&](int k0, int u) { return min(k0 + u * KPW + grp, ke - 1); };
  // the pool blocks of those keys (read two steps ahead of their rows);
  // other than POW2, at once the keys' pool rows
  auto pages = [&](int k0, int* pg) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int key = key_of(k0, u);
      if constexpr (POW2) {
        pg[u] = __ldg(btb + (key >> bs_shift));
      } else {
        const int p = fast_div(key, bs_magic, bs_shift);
        pg[u] = __ldg(btb + p) * bs + (key - p * bs);
      }
    }
  };
  // their K and V rows (and scales); a pool row of all kv heads is
  // row_bytes, this lane's bytes of it start at lane_off
  const uint32_t row_bytes = KVH * D * ESZ;
  const size_t lane_off = (size_t)(kvh * D + d0) * ESZ;
  auto load = [&](int k0, const int* pg, Raw* kr, Raw* vr, float* ksc,
                  float* vsc) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const uint32_t row =
          POW2 ? ((uint32_t)pg[u] << bs_shift) +
                     (key_of(k0, u) & ((1 << bs_shift) - 1))
               : (uint32_t)pg[u];
      const size_t off = (size_t)row * row_bytes + lane_off;
      if (on) {
        kr[u] = __ldg(reinterpret_cast<const Raw*>(kp + off));
        vr[u] = __ldg(reinterpret_cast<const Raw*>(vp + off));
      } else {   // columns past D: the next kv head's, never read
        kr[u] = vr[u] = Raw{};
      }
      if constexpr (Q != 0) {
        ksc[u] = __ldg(k_scale + row);
        vsc[u] = __ldg(v_scale + row);
      } else {
        ksc[u] = vsc[u] = 1.f;
      }
    }
  };

  float m[REP], l[REP], acc[REP][EPL];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[r][e] = 0.f;
  }

  constexpr int STRIDE = PF_WARPS * STEP;
  Raw kc[U], vc[U];
  float ksc[U], vsc[U];
  int pg1[U], pg2[U];   // pages of the next two steps
  int k0 = kb + warp * STEP;
  if (k0 < ke) pages(k0, pg1);
  if (k0 + STRIDE < ke) pages(k0 + STRIDE, pg2);
  if (k0 < ke) load(k0, pg1, kc, vc, ksc, vsc);
  for (; k0 < ke; k0 += STRIDE) {
    Raw kn[U], vn[U];
    float ksn[U], vsn[U];
    if (k0 + 2 * STRIDE < ke) pages(k0 + 2 * STRIDE, pg1);
    if (k0 + STRIDE < ke) load(k0 + STRIDE, pg2, kn, vn, ksn, vsn);

    // scores: a lane's partial dot products, summed over its key's lanes
    float p[U][REP];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[EPL];
      unpack<Q, EPL>(kc[u], kf);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) a = fmaf(qr[r][e], kf[e], a);
        p[u][r] = Q != 0 ? a * ksc[u] : a;   // q . (code * scale)
      }
    }
#pragma unroll
    for (int o = LPK / 2; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int r = 0; r < REP; ++r)
          p[u][r] += __shfl_xor_sync(0xffffffffu, p[u][r], o);

    // online softmax over the step's live keys; a masked key weighs 0
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float mx = NEG_INF;
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (k0 + u * KPW + grp < ke) mx = fmaxf(mx, p[u][r]);
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mn = fmaxf(m[r], mx);
      const float alpha = fast_exp2(m[r] - mn);
      m[r] = mn;
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u][r] = k0 + u * KPW + grp < ke ? fast_exp2(p[u][r] - mn) : 0.f;
        sum += p[u][r];
      }
      l[r] = l[r] * alpha + sum;
      if (alpha != 1.f) {   // the same in every lane: the max moved
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[r][e] *= alpha;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[EPL];
      unpack<Q, EPL>(vc[u], vf);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float pv = Q != 0 ? p[u][r] * vsc[u] : p[u][r];
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[r][e] = fmaf(pv, vf[e], acc[r][e]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      kc[u] = kn[u];
      vc[u] = vn[u];
      ksc[u] = ksn[u];
      vsc[u] = vsn[u];
      pg2[u] = pg1[u];
    }
  }

  // the warp's keys were spread over KPW lane groups: sum them
#pragma unroll
  for (int o = LPK; o < 32; o <<= 1)
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], o);
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], o);
    }
  if (grp == 0) {
#pragma unroll
    for (int r = 0; r < REP; ++r)
#pragma unroll
      for (int e = 0; e < EPL; ++e) wacc[warp][r][d0 + e] = acc[r][e];
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      wm[warp][r] = m[r];
      wl[warp][r] = l[r];
    }
  }
  __syncthreads();
  // the warps' shares merged in warp order (the block's nr heads)
  for (int i = threadIdx.x; i < nr * D; i += PF_THREADS) {
    const int r = i / D, d = i % D;
    float mg = NEG_INF;
#pragma unroll
    for (int w = 0; w < PF_WARPS; ++w) mg = fmaxf(mg, wm[w][r]);
    float a = 0.f, lg = 0.f;
#pragma unroll
    for (int w = 0; w < PF_WARPS; ++w) {
      const float wt = fast_exp2(wm[w][r] - mg);
      a += wt * wacc[w][r][d];
      lg += wt * wl[w][r];
    }
    acc_out[head0 * D + i] = a;
    if (d == 0) {
      m_out[head0 + r] = mg;
      l_out[head0 + r] = lg;
    }
  }

  // the last block of this (b, kv head, sub-group) to finish merges the
  // live blocks'
  // shares in block order (log-sum-exp) and writes the output; it sets
  // the ticket back to 0 for the next launch
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    int* t = tickets + (size_t)b * gridDim.y + blockIdx.y;
    last = atomicAdd(t, 1) == live - 1;
    if (last) *t = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the live blocks' acc rows (the first JB of them, into registers),
  // m and l (into shared memory) in one round of loads; then their
  // weights 2^(m - max) and the sums, and each output the weighted sum
  // of the acc rows in block order
  constexpr int IT = (REP * W + PF_THREADS - 1) / PF_THREADS;
  constexpr int JB = IT <= 4 ? 8 : 4;
  __shared__ float sm_w[PF_MAX_SPLITS][REP], sm_l[PF_MAX_SPLITS][REP];
  __shared__ float sm_lg[REP];
  const size_t g0 = (size_t)b * S * H + hd0;   // split 0's first head
  const float* a0 = acc_out + g0 * D;
  float av[IT][JB];
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int i = threadIdx.x + it * PF_THREADS;
#pragma unroll
    for (int j = 0; j < JB; ++j)
      av[it][j] = i < nr * D && j < live
                      ? __ldcg(a0 + (size_t)j * H * D + i) : 0.f;
  }
  for (int i = threadIdx.x; i < live * nr; i += PF_THREADS) {
    const size_t h = g0 + (size_t)(i / nr) * H + i % nr;
    sm_w[i / nr][i % nr] = __ldcg(m_out + h);
    sm_l[i / nr][i % nr] = __ldcg(l_out + h);
  }
  __syncthreads();
  if (threadIdx.x < nr) {
    const int r = threadIdx.x;
    float mg = NEG_INF;
    for (int j = 0; j < live; ++j) mg = fmaxf(mg, sm_w[j][r]);
    float lg = 0.f;
    for (int j = 0; j < live; ++j) {
      const float wt = fast_exp2(sm_w[j][r] - mg);
      sm_w[j][r] = wt;
      lg += wt * sm_l[j][r];
    }
    sm_lg[r] = fmaxf(lg, 1e-30f);
  }
  __syncthreads();
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int i = threadIdx.x + it * PF_THREADS;
    if (i >= nr * D) break;
    const int r = i / D;
    float o = 0.f;
#pragma unroll
    for (int j = 0; j < JB; ++j)
      if (j < live) o += sm_w[j][r] * av[it][j];
    for (int j = JB; j < live; ++j)
      o += sm_w[j][r] * __ldcg(a0 + (size_t)j * H * D + i);
    out[((size_t)b * H + hd0) * D + i] =
        __float2bfloat16_rn(o / sm_lg[r]);
  }
}

// the grid and arguments of every paged_decode_hopper launch
#define PF_LAUNCH(...)                                                       \
  __VA_ARGS__<<<dim3(S, KVH * groups, B), PF_THREADS, 0, st>>>(                  \
      (const bf16*)q, (const CSK*)cs, (const CSK*)sn, k_pool, v_pool,       \
      (const float*)k_scale, (const float*)v_scale, (const int*)bt,         \
      (const int*)pos, (float*)acc, (float*)m, (float*)l, (int*)tickets,    \
      (bf16*)out, KVH, rep, groups, bs, magic, shift, nbs, scale, D,        \
      cs_dtype);                                                            \
  return (int)cudaGetLastError();

// D = 64 or 128: the instances of D columns, cos/sin of type CS
template <int Q, typename CS>
static int launch_hopper(const void* q, const void* cs, const void* sn,
                         const void* k_pool, const void* v_pool,
                         const void* k_scale, const void* v_scale,
                         const void* bt, const void* pos, void* acc, void* m,
                         void* l, void* tickets, void* out, int B, int KVH,
                         int rep, int D, int bs, int nbs, int S, float scale,
                         int REP, int groups, uint32_t magic, int shift,
                         int cs_dtype, cudaStream_t st) {
  using CSK = CS;
#define PF_CASE(R, DD, P2, F)                                               \
  if (REP == R && D == DD && (magic == 0) == P2 && full == F) {            \
    PF_LAUNCH(paged_decode_hopper<Q, DD, R, P2, F, false, CS>)              \
  }
#define PF_REPS(DD, P2, F) \
  PF_CASE(1, DD, P2, F) PF_CASE(2, DD, P2, F) PF_CASE(4, DD, P2, F)
  // FULL only with POW2: the shapes whose instructions it keeps
  const bool full = magic == 0 && rep == REP && groups == 1;
  PF_REPS(64, true, true) PF_REPS(128, true, true)
  PF_REPS(64, true, false) PF_REPS(128, true, false)
  PF_REPS(64, false, false) PF_REPS(128, false, false)
#undef PF_REPS
#undef PF_CASE
  return (int)cudaErrorInvalidValue;
}

// every other D that is a multiple of 8 up to 256: the padded instance of
// the smallest width W in {64, 128, 256} that holds it, D and the cos/sin
// rows' type at run time
template <int Q>
static int launch_padded(const void* q, const void* cs, const void* sn,
                         const void* k_pool, const void* v_pool,
                         const void* k_scale, const void* v_scale,
                         const void* bt, const void* pos, void* acc, void* m,
                         void* l, void* tickets, void* out, int B, int KVH,
                         int rep, int D, int bs, int nbs, int S, float scale,
                         int REP, int groups, uint32_t magic, int shift,
                         int W, int cs_dtype, cudaStream_t st) {
  using CSK = CSRuntime;
#define PF_CASE(R, WW, P2)                                                  \
  if (REP == R && W == WW && (magic == 0) == P2) {                         \
    PF_LAUNCH(paged_decode_hopper<Q, WW, R, P2, false, true, CSRuntime>)    \
  }
#define PF_REPS(WW, P2) PF_CASE(1, WW, P2) PF_CASE(2, WW, P2) PF_CASE(4, WW, P2)
  PF_REPS(64, true) PF_REPS(128, true) PF_REPS(256, true)
  PF_REPS(64, false) PF_REPS(128, false) PF_REPS(256, false)
#undef PF_REPS
#undef PF_CASE
  return (int)cudaErrorInvalidValue;
}
#undef PF_LAUNCH

extern "C" int paged_decode_smem_bytes(int rep, int D, int bs) {
  const int kt = bs < PD_KEYS ? bs : PD_KEYS;
  return (int)sizeof(float) *
         (2 * rep * D + kt * (2 * D + 1) + rep * kt + 3 * rep);
}

template <typename T, typename CS>
static int launch_general(const void* q, const void* cs, const void* sn,
                          const void* k_pool, const void* v_pool,
                          const void* k_scale, const void* v_scale,
                          const void* bt, const void* pos, void* acc,
                          void* m, void* l, void* out, int B, int KVH,
                          int rep, int D, int bs, int nbs, int S, float scale,
                          int kv, cudaStream_t st) {
  const int smem = paged_decode_smem_bytes(rep, D, bs);
  DISPATCH_KV(kv, Q, {
    auto kernel = paged_decode_partials<T, CS, Q>;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<dim3(B, KVH, S), PD_THREADS, smem, st>>>(
        (const T*)q, (const CS*)cs, (const CS*)sn, k_pool, v_pool,
        (const float*)k_scale, (const float*)v_scale, (const int*)bt,
        (const int*)pos, (float*)acc, (float*)m, (float*)l, KVH, rep, D, bs,
        nbs, S, scale);
  });
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_decode_combine<T><<<B * KVH * rep, PD_THREADS, 0, st>>>(
      (const float*)acc, (const float*)m, (const float*)l, (T*)out, S,
      KVH * rep, D);
  return (int)cudaGetLastError();
}

// dtype: q's and the output's type (0 f32, 1 bf16); cs_dtype: cs's and
// sn's (the same codes); kv: what the pools hold (0 q's type, 1 int8
// codes, 2 fp8 codes, with the scales).  hopper (the wrapper's route,
// kernels/paged_attention.py hopper_path) takes paged_decode_hopper:
// bf16 q, D a multiple of 8 from 8 to 256, any rep and bs, 16-byte
// aligned pools, 1 <= S <= PF_MAX_SPLITS (the wrapper's decode_plan),
// tickets: B * KVH * groups ints, 0 before the launch and after it, used
// by one stream at a time; width is the instance's columns
// (hopper_width: the smallest of 64, 128 and 256 that holds D; D == width
// at 64 and 128 takes the instance of D columns, every other D the
// padded one), hopper the instance's REP (kernels/paged_attention.py
// hopper_group: 1, 2 or 4, groups sub-groups of ceil(rep / groups) <=
// REP heads a kv head; one sub-group of rep == REP heads over a
// power-of-two bs at D == width takes the FULL instance), magic 0 for a
// power-of-two bs = 1 << shift, else bs's division multiplier
// (div_magic).  hopper 0: the general instance (width 0), any type, rep,
// bs and D (the shared memory of paged_decode_smem_bytes, at most what a
// block can have), any S (the wrapper's general_plan), and the combine
// kernel (tickets unused).
extern "C" int paged_decode(const void* q, const void* cs, const void* sn,
                            const void* k_pool, const void* v_pool,
                            const void* k_scale, const void* v_scale,
                            const void* bt, const void* pos, void* acc,
                            void* m, void* l, void* tickets, void* out,
                            int B, int KVH, int rep, int D, int bs, int nbs,
                            int S, float scale, int dtype, int cs_dtype,
                            int kv, int width, int hopper, int groups,
                            unsigned int magic, int shift, void* stream) {
  if (B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  int err = 0;
  if (hopper) {
    const int per = groups > 0 ? (rep + groups - 1) / groups : 0;
    if (dtype != 1 || tickets == nullptr || bs <= 0 || rep <= 0 ||
        per < 1 || per > hopper || (groups - 1) * per >= rep ||
        (magic == 0 && bs != 1 << shift) || S < 1 || S > PF_MAX_SPLITS ||
        D < 8 || D % 8 || width != (D <= 64 ? 64 : D <= 128 ? 128 : 256) ||
        D > width || (cs_dtype != 0 && cs_dtype != 1))
      return (int)cudaErrorInvalidValue;
    if (D != width || width == 256) {
      DISPATCH_KV(kv, Q, {
        err = launch_padded<Q>(q, cs, sn, k_pool, v_pool, k_scale, v_scale,
                               bt, pos, acc, m, l, tickets, out, B, KVH, rep,
                               D, bs, nbs, S, scale, hopper, groups, magic,
                               shift, width, cs_dtype, st);
      });
      return err;
    }
    DISPATCH_DTYPE(cs_dtype, CS, {
      DISPATCH_KV(kv, Q, {
        err = launch_hopper<Q, CS>(q, cs, sn, k_pool, v_pool, k_scale,
                                   v_scale, bt, pos, acc, m, l, tickets, out,
                                   B, KVH, rep, D, bs, nbs, S, scale, hopper,
                                   groups, magic, shift, cs_dtype, st);
      });
    });
    return err;
  }
  if (bs <= 0 || S < 1) return (int)cudaErrorInvalidValue;
  DISPATCH_DTYPE(dtype, T, {
    DISPATCH_DTYPE(cs_dtype, CS, {
      err = launch_general<T, CS>(q, cs, sn, k_pool, v_pool, k_scale,
                                  v_scale, bt, pos, acc, m, l, out, B, KVH,
                                  rep, D, bs, nbs, S, scale, kv, st);
    });
  });
  return err;
}
