// RMSNorm folded into the prologue of a matmul:
//   xn  = ((x * rs).to(T) * nw).to(T)          per element of the x tile
//   out = act(xn @ w).to(T)                     f32 accumulation
// with rs = rsqrt(mean(x^2) + eps) per row (computed once by the caller
// and shared by every projection of the same activation), nw the norm
// weight [K], w [K, N] row-major, act none or silu (on the f32 sum).
//
// Replaces paddle_tpu/kernels/fused_norm_linear.py _kernel (pallas_call
// in _norm_linear_pallas).  The normalized activation never goes to
// device memory: each block normalizes the x tile it stages in shared
// memory, with the reference's two cast points.
//
// Kernels chosen by the number of rows M and the type:
// - skinny (M <= 8, the decode step): bound by bytes, the one read of w
//   (Llama-3-8B's q/k/v/gate/up: 285 MB, 0.085 ms at 3.35 TB/s).  For
//   bf16, norm_linear_skinny_mma: one launch covers every weight that
//   shares x (q/k/v, or gate/up), a block owns 64 columns of one weight
//   and a 1/S share of K, and the S blocks of one column strip form a
//   thread block cluster.  A producer warp streams the block's w rows by
//   TMA through a ring of SKM_STAGES 8 KB stages (32 KB in flight a
//   block, four blocks a SM); the block normalizes its K range of x once
//   into shared memory, with the reference's two cast points; four warps
//   take 16
//   columns each and run the product on the tensor cores with the
//   operands swapped, out^T = w^T . xn^T: mma.sync m16n8k16 with a
//   16 x 16 tile of w as A (ldmatrix.trans out of the swizzled stage)
//   and the <= 8 rows of xn as the n8 B operand, f32 accumulation.  The
//   S partial tiles are summed through distributed shared memory in rank
//   order, then silu and the cast: no partials in device memory, no
//   second launch, the same bits from run to run.  The split S and the
//   rows a rank takes come from the wrapper (skinny_plan) and depend on
//   K alone, so each output equals its single-weight call bit for bit.
//   f32 keeps norm_linear_skinny on the CUDA cores (the tensor cores
//   would round it to TF32): each lane loads 16 bytes of a row of w at
//   a time (4 columns), a warp streams one contiguous 512-byte row
//   segment, a block's 8 warps take interleaved rows of its K range, a
//   narrow projection is also split along K over the grid (gridDim.y),
//   each split writes an f32 partial and a second pass sums the splits
//   in a fixed order, applies silu and casts.  The warps' sums meet in
//   a fixed tree in shared memory.
// - tiled (M > 8, the prefill chunk).  At Llama-3-8B's q/k/v/gate/up
//   with M = 256 the bytes bound it (w's 285 MB once, x and the outputs:
//   0.091 ms at 3.35 TB/s) just ahead of the operations (0.074 ms at 989
//   TFLOP/s).  For bf16, a warp-specialized Hopper kernel (below): TMA
//   keeps four 64-deep k-tiles of x and w in flight a block, wgmma
//   m64n256k16 (or m64n128k16) takes the normalized x from registers,
//   and one launch covers q/k/v (or gate/up) with the M-tiles of each w
//   tile adjacent, so w leaves HBM once and the narrow k and v ride with
//   q.  The mma.sync kernel it
//   replaces read each w tile up to four times, kept one 32-deep tile in
//   flight and left 100 of 132 SMs idle on k and v: 1.060 ms for the five
//   projections against cuBLAS's 0.139.  A bf16 product is exact in f32,
//   so only the order of the f32 sums differs from the plain version,
//   and it is fixed: the result does not change from run to run.  f32
//   runs on the CUDA cores (64x64 tiles, 4x4 outputs per thread): the
//   tensor cores would round it to TF32.
// - general (norm_linear_tiled<T>, the same CUDA-core tiles): the bf16
//   shapes the Hopper kernels are not built for, at any M: N not a
//   multiple of 8 (their TMA boxes and paired stores), K not a multiple
//   of 8 above SK_MR rows, operands not 16-byte aligned.  Every load is
//   bounds-checked; one launch covers the group.  Simple rather than
//   fast.
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

__device__ __forceinline__ float silu(float z) { return z / (1.f + expf(-z)); }

template <typename T>
__device__ __forceinline__ float norm_elem(const T* x, const float* rs,
                                           const T* nw, int m, int k, int K) {
  const float v = round_to<T>(to_f32(x[(size_t)m * K + k]) * rs[m]);
  return round_to<T>(v * to_f32(nw[k]));
}

// ------------------------------------------------------------- skinny
constexpr int SK_THREADS = 256;
constexpr int SK_WARPS = SK_THREADS / 32;
constexpr int SK_MR = 8;     // most rows (SKINNY_MAX_ROWS in the wrapper)
constexpr int SK_KT = 256;   // x columns staged per pass

template <typename T>
struct Vec {  // one 16-byte load of T
  static constexpr int N = 16 / sizeof(T);
};

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) out[i] = to_f32(e[i]);
}

// grid (ceil(N / strip), splits); strip = 32 * Vec<T>::N columns.
// part: [splits, M, N] f32 when splits > 1, else unused (out written).
template <typename T, bool SILU>
__global__ void __launch_bounds__(SK_THREADS)
    norm_linear_skinny(const T* __restrict__ x, const float* __restrict__ rs,
                       const T* __restrict__ nw, const T* __restrict__ w,
                       T* __restrict__ out, float* __restrict__ part, int M,
                       int N, int K) {
  constexpr int V = Vec<T>::N;
  constexpr int STRIP = 32 * V;
  __shared__ float xs[SK_MR][SK_KT];
  __shared__ float red[SK_WARPS / 2][SK_MR][STRIP];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = blockIdx.x * STRIP + lane * V;   // this lane's V columns
  const bool live = n < N;                        // N % V == 0
  const int per = (K + gridDim.y - 1) / gridDim.y;
  const int kb = blockIdx.y * per, ke = min(K, kb + per);
  float acc[SK_MR][V];
#pragma unroll
  for (int m = 0; m < SK_MR; ++m)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[m][v] = 0.f;

  for (int k0 = kb; k0 < ke; k0 += SK_KT) {
    const int kt = min(SK_KT, ke - k0);
    __syncthreads();  // the previous pass's readers are done
    for (int i = threadIdx.x; i < M * SK_KT; i += SK_THREADS) {
      const int m = i / SK_KT, k = i % SK_KT;
      xs[m][k] = k < kt ? norm_elem(x, rs, nw, m, k0 + k, K) : 0.f;
    }
    __syncthreads();
    if (live) {
#pragma unroll 4
      for (int k = warp; k < kt; k += SK_WARPS) {
        float wv[V];
        load_vec(w + (size_t)(k0 + k) * N + n, wv);
#pragma unroll
        for (int m = 0; m < SK_MR; ++m) {
          if (m < M) {
            const float a = xs[m][k];
#pragma unroll
            for (int v = 0; v < V; ++v) acc[m][v] = fmaf(a, wv[v], acc[m][v]);
          }
        }
      }
    }
  }
  // fixed tree over the 8 warps: 4..7 -> 0..3, 2..3 -> 0..1, 1 -> 0
  for (int half = SK_WARPS / 2; half > 0; half /= 2) {
    __syncthreads();
    if (warp >= half && warp < 2 * half) {
#pragma unroll
      for (int m = 0; m < SK_MR; ++m)
#pragma unroll
        for (int v = 0; v < V; ++v) red[warp - half][m][lane * V + v] = acc[m][v];
    }
    __syncthreads();
    if (warp < half) {
#pragma unroll
      for (int m = 0; m < SK_MR; ++m)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[m][v] += red[warp][m][lane * V + v];
    }
  }
  if (warp != 0 || !live) return;
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const size_t o = (size_t)m * N + n + v;
      if (gridDim.y > 1) {
        part[(size_t)blockIdx.y * M * N + o] = acc[m][v];
      } else {
        const float z = SILU ? silu(acc[m][v]) : acc[m][v];
        out[o] = from_f32<T>(z);
      }
    }
  }
}

// the splits' partials summed in split order, then act and the cast
template <typename T, bool SILU>
__global__ void norm_linear_skinny_sum(const float* __restrict__ part,
                                       T* __restrict__ out, int MN,
                                       int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float z = 0.f;
  for (int s = 0; s < splits; ++s) z += part[(size_t)s * MN + i];
  if (SILU) z = silu(z);
  out[i] = from_f32<T>(z);
}

// ------------------------------- tiled, general (CUDA cores, any shape)
// f32 above SK_MR rows, and every bf16 shape the Hopper kernels are not
// built for (N or, above SK_MR rows, K not a multiple of 8; operands not
// 16-byte aligned): 64 x 64 output tiles, 4 x 4 a thread, x normalized
// and w staged 16 k at a time in shared memory as f32, every load
// bounds-checked, one rounding at the store.  One launch covers every
// weight of a group (blocks walk the weights' N-tiles; grid.y the
// M-tiles), and a weight's outputs do not depend on the group.
constexpr int TB_M = 64, TB_N = 64, TB_K = 16, TB_THREADS = 256;
constexpr int WG_MAX_W = 3;              // weights a launch (q, k, v)

struct TiledGroup {
  const void* x;                 // [M, K]
  const float* rs;
  const void* nw;
  const void* w[WG_MAX_W];       // [K, N_i]
  void* out[WG_MAX_W];
  int n[WG_MAX_W];
  int silu[WG_MAX_W];
  int tiles_end[WG_MAX_W];       // N-tiles of weights 0..i together
  int count, M, K;
};

template <typename T>
__global__ void __launch_bounds__(TB_THREADS)
    norm_linear_tiled(const __grid_constant__ TiledGroup p) {
  __shared__ float As[TB_K][TB_M + 4];
  __shared__ float Bs[TB_K][TB_N + 4];
  int wi = 0;
  while (wi + 1 < p.count && (int)blockIdx.x >= p.tiles_end[wi]) ++wi;
  const T* x = static_cast<const T*>(p.x);
  const T* nw = static_cast<const T*>(p.nw);
  const T* w = static_cast<const T*>(p.w[wi]);
  const int M = p.M, N = p.n[wi], K = p.K;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * TB_M;
  const int n0 = (blockIdx.x - (wi ? p.tiles_end[wi - 1] : 0)) * TB_N;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += TB_K) {
    for (int i = threadIdx.x; i < TB_M * TB_K; i += TB_THREADS) {
      const int mm = i / TB_K, kk = i % TB_K;
      const int m = m0 + mm, k = k0 + kk;
      As[kk][mm] = (m < M && k < K) ? norm_elem(x, p.rs, nw, m, k, K) : 0.f;
    }
    for (int i = threadIdx.x; i < TB_K * TB_N; i += TB_THREADS) {
      const int kk = i / TB_N, nn = i % TB_N;
      const int k = k0 + kk, n = n0 + nn;
      Bs[kk][nn] = (k < K && n < N) ? to_f32(w[(size_t)k * N + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TB_K; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  T* out = static_cast<T*>(p.out[wi]);
  const bool silu_on = p.silu[wi] != 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) continue;
      const float z = silu_on ? silu(acc[i][j]) : acc[i][j];
      out[(size_t)m * N + n] = from_f32<T>(z);
    }
  }
}

// up to WG_MAX_W weights [K, n_i] of T sharing x [M, K], rs and nw
template <typename T>
static int launch_tiled(const void* x, const float* rs, const void* nw,
                        const void* const* w, void* const* out, const int* n,
                        int silu_mask, int count, int M, int K,
                        cudaStream_t s) {
  if (count < 1 || count > WG_MAX_W) return (int)cudaErrorInvalidValue;
  TiledGroup p{};
  int tiles = 0;
  for (int i = 0; i < count; ++i) {
    p.w[i] = w[i];
    p.out[i] = out[i];
    p.n[i] = n[i];
    p.silu[i] = (silu_mask >> i) & 1;
    tiles += (n[i] + TB_N - 1) / TB_N;
    p.tiles_end[i] = tiles;
  }
  p.x = x;
  p.rs = rs;
  p.nw = nw;
  p.count = count;
  p.M = M;
  p.K = K;
  if (tiles == 0) return 0;
  norm_linear_tiled<T><<<dim3(tiles, (M + TB_M - 1) / TB_M), TB_THREADS, 0,
                         s>>>(p);
  return (int)cudaGetLastError();
}

// ------------------------------------------ tiled, bf16 (wgmma + TMA)
// A block owns a 128 x BN output tile of one weight (BN = 256, or 128
// where that fills more SMs).  Warpgroups 0 and 1 consume (64 rows
// each), warpgroup 2 produces: one of its threads keeps a ring of
// WG_STAGES 64-deep k-tiles in flight by TMA, each stage
// the raw x tile [128 rows][64 k] and w's [64 k][BN n] as BN / 64 boxes
// of 64 columns, all 128-byte swizzled, with one full and one empty
// mbarrier a stage.  A consumer takes its x rows out of shared memory
// with ldmatrix in the wgmma A-fragment layout, normalizes them there
// (two rows of rs and four pairs of nw a thread per 16-deep step, the
// reference's two roundings), and issues wgmma m64nBNk16 with A from
// registers and w, MN-major, from shared memory; it normalizes the next
// k-tile while the tensor cores multiply this one.  The normalized tile
// exists only in registers.
//
// One launch covers every weight that shares x and rs (q/k/v, or
// gate/up): blocks walk a tile table, the M-tiles of one N-tile adjacent
// in launch order, so each w tile leaves HBM once and the second M-tile
// reads it from L2; k and v (N = 1024) ride with q.  What bounds it at
// M = 256 is the L2: every block reads its whole x rows again, so the
// 256-wide N tile (half the blocks of a 128-wide one) moves a quarter
// fewer bytes from L2 (0.84 GB against 1.11 for the five projections).
constexpr int WG_BM = 128, WG_BK = 64, WG_STAGES = 4;
constexpr int WG_THREADS = 384;          // 2 consumer warpgroups + producer
constexpr int WG_X_BYTES = WG_BM * WG_BK * 2;     // 16 KB
constexpr int WG_W_BOX = WG_BK * 64 * 2;          // 8 KB: 64 k x 64 n
// a stage and the dynamic shared memory of a BN-wide tile (BN / 64 boxes
// of w; 48 KB a stage at BN = 256)
template <int BN>
__host__ __device__ constexpr int wg_stage() {
  return WG_X_BYTES + BN / 64 * WG_W_BOX;
}
template <int BN>
__host__ __device__ constexpr int wg_smem() {
  return WG_STAGES * wg_stage<BN>() + 1024 + 2 * WG_STAGES * 8;
}

struct NormLinearGroup {
  CUtensorMap x;                 // [M, K], box 64 k x 128 rows
  CUtensorMap w[WG_MAX_W];       // [K, N_i], box 64 n x 64 k
  const float* rs;
  const bf16* nw;
  bf16* out[WG_MAX_W];
  int n[WG_MAX_W];
  int silu[WG_MAX_W];
  int tiles_end[WG_MAX_W];       // N-tiles of weights 0..i together
  int count, M, K, m_tiles;
};

// ((x * rs).to(bf16) * nw).to(bf16) of a packed pair of x: the first
// product in f32 and one rounding of the pair, the second a bf16x2
// multiply (a product of two bf16 is exact in f32, so its one rounding
// is the reference's)
__device__ __forceinline__ uint32_t norm_pair(uint32_t xv, float rs,
                                              uint32_t wv) {
  const float x0 = __uint_as_float(xv << 16);
  const float x1 = __uint_as_float(xv & 0xffff0000u);
  const __nv_bfloat162 v = __floats2bfloat162_rn(x0 * rs, x1 * rs);
  const __nv_bfloat162 y =
      __hmul2(v, *reinterpret_cast<const __nv_bfloat162*>(&wv));
  return *reinterpret_cast<const uint32_t*>(&y);
}

// nw pairs at k = 2 tg and 2 tg + 8 of each 16-deep step of the k-tile
// at k0 (K % 8 == 0, so a pair is all in or all out)
__device__ __forceinline__ void load_nw(uint32_t (*nwp)[2], const bf16* nw,
                                        int k0, int K, int tg) {
#pragma unroll
  for (int ks = 0; ks < WG_BK / 16; ++ks)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = k0 + ks * 16 + 2 * tg + 8 * h;
      nwp[ks][h] = k < K ? ld_pair(nw + k) : 0u;
    }
}

template <int BN>
__global__ void __launch_bounds__(WG_THREADS, 1)
    norm_linear_wgmma(const __grid_constant__ NormLinearGroup p) {
  constexpr int WG_STAGE = wg_stage<BN>();
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + WG_STAGES * WG_STAGE);
  uint64_t* empty = full + WG_STAGES;

  const int mt = blockIdx.x % p.m_tiles, nt_all = blockIdx.x / p.m_tiles;
  int wi = 0;
  while (wi + 1 < p.count && nt_all >= p.tiles_end[wi]) ++wi;
  const int m0 = mt * WG_BM;
  const int n0 = (nt_all - (wi ? p.tiles_end[wi - 1] : 0)) * BN;
  const int N = p.n[wi];
  const int k_tiles = (p.K + WG_BK - 1) / WG_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
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
      const CUtensorMap* wmap = &p.w[wi];
      // a box wholly past N is not loaded: its columns are never stored
      const int boxes = min(BN / 64, (N - n0 + 63) / 64);
      const uint32_t bytes = WG_X_BYTES + boxes * WG_W_BOX;
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % WG_STAGES;
        if (kt >= WG_STAGES) mbar_wait(&empty[s], (kt / WG_STAGES - 1) & 1);
        uint8_t* st = smem + s * WG_STAGE;
        mbar_expect_tx(&full[s], bytes);
        tma_load_2d(st, &p.x, &full[s], kt * WG_BK, m0);
        for (int x = 0; x < boxes; ++x)
          tma_load_2d(st + WG_X_BYTES + x * WG_W_BOX, wmap, &full[s],
                      n0 + 64 * x, kt * WG_BK);
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    setmaxnreg_inc<232>();
    const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32, g = lane / 4, tg = lane % 4;
    const int r0 = wg * 64 + warp * 16;     // this warp's rows in the tile
    float rsv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + r0 + g + 8 * h;
      rsv[h] = m < p.M ? p.rs[m] : 0.f;
    }
    // ldmatrix.x4 addresses: rows r0 + lane % 16, k chunk + lane / 16
    const int lrow = r0 + (lane & 15), lchunk = lane >> 4;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

    // A fragments of one k-tile: wait for its stage, then ldmatrix the
    // raw x rows (rows g / g + 8 by bit 0 of i, k 2 tg / 2 tg + 8 by bit
    // 1) and normalize them in registers
    auto normalize = [&](uint32_t (&a)[WG_BK / 16][4], int kt) {
      uint32_t nwp[WG_BK / 16][2];
      load_nw(nwp, p.nw, kt * WG_BK, p.K, tg);
      const int s = kt % WG_STAGES;
      mbar_wait(&full[s], (kt / WG_STAGES) & 1);
      const uint32_t xs = smem_u32(smem + s * WG_STAGE);
#pragma unroll
      for (int ks = 0; ks < WG_BK / 16; ++ks) {
        uint32_t raw[4];
        ldsm_x4(raw, xs + swz128(lrow, 2 * ks + lchunk));
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[ks][i] = norm_pair(raw[i], rsv[i & 1], nwp[ks][i >> 1]);
      }
    };
    auto issue = [&](uint32_t (&a)[WG_BK / 16][4], int kt) {
      const uint32_t ws =
          smem_u32(smem + (kt % WG_STAGES) * WG_STAGE + WG_X_BYTES);
      wgmma_fence();
      fence_regs<BN / 2>(acc);
#pragma unroll
      for (int ks = 0; ks < WG_BK / 16; ++ks) {
        const uint64_t dw = desc_sw128(ws + ks * 16 * 128, WG_W_BOX, 1024);
        if constexpr (BN == 256)
          wgmma_rs_n256<1>(acc, a[ks], dw, 1);
        else
          wgmma_rs_n128<1>(acc, a[ks], dw, 1);
      }
      wgmma_commit();
    };
    // wait for k-tile kt's products; its A registers stay live until
    // then (the next tile's fragments must not take them while the
    // asynchronous wgmma reads them), and its stage goes back
    auto finish = [&](uint32_t (&a)[WG_BK / 16][4], int kt) {
      wgmma_wait<0>();
      fence_regs<BN / 2>(acc);
#pragma unroll
      for (int ks = 0; ks < WG_BK / 16; ++ks)
        asm volatile("" ::"r"(a[ks][0]), "r"(a[ks][1]), "r"(a[ks][2]),
                     "r"(a[ks][3]));
      // the stage's ldmatrix reads of x (generic proxy) before TMA's
      // next write to it (async proxy), every lane's before lane 0 frees
      // it: as in norm_linear_skinny_mma
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[kt % WG_STAGES]);
    };
    // two k-tiles in registers: the next one is normalized while the
    // tensor cores multiply this one
    uint32_t a0[WG_BK / 16][4], a1[WG_BK / 16][4];
    normalize(a0, 0);
    for (int kt = 0; kt < k_tiles; kt += 2) {
      issue(a0, kt);
      if (kt + 1 < k_tiles) normalize(a1, kt + 1);
      finish(a0, kt);
      if (kt + 1 == k_tiles) break;
      issue(a1, kt + 1);
      if (kt + 2 < k_tiles) normalize(a0, kt + 2);
      finish(a1, kt + 1);
    }

    // epilogue: silu on the f32 sums, one rounding, masked pair stores
    // (N % 8 == 0 keeps a pair inside the row)
    bf16* out = p.out[wi];
    const bool silu_on = p.silu[wi] != 0;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * tg;
      if (n >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + r0 + g + 8 * h;
        if (m >= p.M) continue;
        float z0 = acc[4 * j + 2 * h], z1 = acc[4 * j + 2 * h + 1];
        if (silu_on) {
          z0 = silu(z0);
          z1 = silu(z1);
        }
        *reinterpret_cast<uint32_t*>(out + (size_t)m * N + n) =
            pack_bf16(z0, z1);
      }
    }
  }
}

template <int BN>
static int launch_tiles(NormLinearGroup& p, const int* n, cudaStream_t s) {
  int tiles = 0;
  for (int i = 0; i < p.count; ++i) {
    tiles += (n[i] + BN - 1) / BN;
    p.tiles_end[i] = tiles;
  }
  constexpr int smem = wg_smem<BN>();
  const cudaError_t e = cudaFuncSetAttribute(
      norm_linear_wgmma<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  norm_linear_wgmma<BN><<<tiles * p.m_tiles, WG_THREADS, smem, s>>>(p);
  return (int)cudaGetLastError();
}

// the tile table and tensor maps of up to WG_MAX_W weights [K, n_i]
// sharing x [M, K]; one block per output tile, 256 columns wide, or 128
// where 256-wide tiles would leave SMs idle (q/k/v of a 256-token chunk:
// 48 tiles on 132 SMs)
static int launch_wgmma(const bf16* x, const float* rs, const bf16* nw,
                        const bf16* const* w, bf16* const* out, const int* n,
                        int silu_mask, int count, int M, int K,
                        cudaStream_t s) {
  if (count < 1 || count > WG_MAX_W) return (int)cudaErrorInvalidValue;
  NormLinearGroup p{};
  const cuuint64_t xd[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t xst[1] = {(cuuint64_t)K * 2};
  const cuuint32_t xb[2] = {WG_BK, WG_BM};
  if (!hopper::make_map_bf16(&p.x, x, 2, xd, xst, xb))
    return (int)cudaErrorInvalidValue;
  int wide = 0;
  for (int i = 0; i < count; ++i) {
    const cuuint64_t wd[2] = {(cuuint64_t)n[i], (cuuint64_t)K};
    const cuuint64_t wst[1] = {(cuuint64_t)n[i] * 2};
    const cuuint32_t wb[2] = {64, WG_BK};
    if (!hopper::make_map_bf16(&p.w[i], w[i], 2, wd, wst, wb))
      return (int)cudaErrorInvalidValue;
    p.out[i] = out[i];
    p.n[i] = n[i];
    p.silu[i] = (silu_mask >> i) & 1;
    wide += (n[i] + 255) / 256;
  }
  p.rs = rs;
  p.nw = nw;
  p.count = count;
  p.M = M;
  p.K = K;
  p.m_tiles = (M + WG_BM - 1) / WG_BM;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  return wide * p.m_tiles < sms ? launch_tiles<128>(p, n, s)
                                : launch_tiles<256>(p, n, s);
}

// ------------------------------------------ skinny, bf16 (mma.sync + TMA)
constexpr int SKM_BN = 64;               // columns a block: one TMA box
constexpr int SKM_BK = 64;               // k rows a stage
constexpr int SKM_STAGES = 4;
constexpr int SKM_WARPS = SKM_BN / 16;   // consumer warps, 16 columns each
constexpr int SKM_THREADS = 32 * (SKM_WARPS + 1);   // + the producer warp
constexpr int SKM_BOX = SKM_BK * SKM_BN * 2;        // 8 KB
constexpr int SKM_MAX_SPLIT = 8;         // a portable cluster

struct SkinnyGroup {
  CUtensorMap w[WG_MAX_W];       // [K, N_i], box 64 n x 64 k
  const bf16* x;
  const float* rs;
  const bf16* nw;
  bf16* out[WG_MAX_W];
  int n[WG_MAX_W];
  int silu[WG_MAX_W];
  int tiles_end[WG_MAX_W];       // column strips of weights 0..i together
  int count, M, K, kc;           // kc: k rows a rank, a multiple of SKM_BK
};

__host__ __device__ constexpr int skm_smem(int kc) {
  return 1024 + SKM_STAGES * SKM_BOX + SK_MR * (kc + 8) * 2 +
         SKM_BN * SK_MR * 4 + 2 * SKM_STAGES * 8;
}

__global__ void __launch_bounds__(SKM_THREADS)
    norm_linear_skinny_mma(const __grid_constant__ SkinnyGroup p) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int xstride = p.kc + 8;  // bf16; 8 more keeps the B loads apart
  bf16* xs = reinterpret_cast<bf16*>(smem + SKM_STAGES * SKM_BOX);
  float* part = reinterpret_cast<float*>(xs + SK_MR * xstride);  // [64][8]
  uint64_t* full = reinterpret_cast<uint64_t*>(part + SKM_BN * SK_MR);
  uint64_t* empty = full + SKM_STAGES;

  const int rank = (int)cluster_ctarank(), ranks = (int)cluster_nctarank();
  const int tile = blockIdx.x / ranks;
  int wi = 0;
  while (wi + 1 < p.count && tile >= p.tiles_end[wi]) ++wi;
  const int n0 = (tile - (wi ? p.tiles_end[wi - 1] : 0)) * SKM_BN;
  const int N = p.n[wi];
  const int kb = rank * p.kc, ke = min(p.K, kb + p.kc);
  const int k_tiles = ke > kb ? (ke - kb + SKM_BK - 1) / SKM_BK : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < SKM_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], SKM_WARPS);   // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == SKM_WARPS) {
    // ------------------------------------------------------ producer
    if (lane == 0) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % SKM_STAGES;
        if (kt >= SKM_STAGES) mbar_wait(&empty[s], (kt / SKM_STAGES - 1) & 1);
        mbar_expect_tx(&full[s], SKM_BOX);
        tma_load_2d(smem + s * SKM_BOX, &p.w[wi], &full[s], n0,
                    kb + kt * SKM_BK);
      }
    }
    __syncwarp();
  } else {
    // ------------------------------------------------------ consumers
    // this rank's K range of x, normalized once (zeros past it and past
    // M) while the first stages are in flight: 8 k a vector, each
    // thread's loads issued together (x's rows are 16-byte aligned when
    // K % 8 == 0, else element by element)
    {
      constexpr int NV = 4;
      const int row_vecs = p.kc / 8, vecs = SK_MR * row_vecs;
      const bool vec_rows = p.K % 8 == 0;
      for (int v0 = threadIdx.x; v0 < vecs; v0 += NV * 32 * SKM_WARPS) {
        uint4 xv[NV], wv[NV];
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const int v = v0 + j * 32 * SKM_WARPS;
          const int m = v / row_vecs, k = kb + (v % row_vecs) * 8;
          xv[j] = wv[j] = zero4();
          if (v < vecs && m < p.M && vec_rows && k + 8 <= ke) {
            xv[j] = __ldg(reinterpret_cast<const uint4*>(
                p.x + (size_t)m * p.K + k));
            wv[j] = __ldg(reinterpret_cast<const uint4*>(p.nw + k));
          }
        }
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const int v = v0 + j * 32 * SKM_WARPS;
          if (v >= vecs) break;
          const int m = v / row_vecs, kl = (v % row_vecs) * 8, k = kb + kl;
          uint4 o = zero4();
          if (m < p.M && vec_rows && k + 8 <= ke) {
            const float r = p.rs[m];
            o.x = norm_pair(xv[j].x, r, wv[j].x);
            o.y = norm_pair(xv[j].y, r, wv[j].y);
            o.z = norm_pair(xv[j].z, r, wv[j].z);
            o.w = norm_pair(xv[j].w, r, wv[j].w);
          } else if (m < p.M) {
            bf16* e = reinterpret_cast<bf16*>(&o);
            for (int i = 0; i < 8 && k + i < ke; ++i)
              e[i] = __float2bfloat16_rn(
                  norm_elem(p.x, p.rs, p.nw, m, k + i, p.K));
          }
          *reinterpret_cast<uint4*>(xs + m * xstride + kl) = o;
        }
      }
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(32 * SKM_WARPS) : "memory");

    const int g = lane / 4, tg = lane % 4;
    // ldmatrix.x4.trans row addresses: matrix lane / 8 is (columns 0-7
    // or 8-15 of the warp's 16 by bit 0, k 0-7 or 8-15 by bit 1): a0..a3
    const int lk = ((lane >> 4) & 1) * 8 + (lane & 7);
    const int lchunk = warp * 2 + ((lane >> 3) & 1);
    const bf16* xrow = xs + g * xstride + 2 * tg;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    for (int kt = 0; kt < k_tiles; ++kt) {
      const int s = kt % SKM_STAGES;
      mbar_wait(&full[s], (kt / SKM_STAGES) & 1);
      const uint32_t ws = smem_u32(smem + s * SKM_BOX);
#pragma unroll
      for (int ks = 0; ks < SKM_BK / 16; ++ks) {
        uint32_t a[4], b[2];
        ldsm_x4_trans(a, ws + swz128(ks * 16 + lk, lchunk));
        const int k = kt * SKM_BK + ks * 16;
        b[0] = ld_pair(xrow + k);
        b[1] = ld_pair(xrow + k + 8);
        mma_bf16(c, a, b);
      }
      // the stage's reads (generic proxy) before TMA's next write to it
      // (async proxy), every lane's before lane 0 frees it
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    // C: columns g and g + 8 of the warp's 16, rows 2 tg and 2 tg + 1
    const int nl = warp * 16 + g;
    *reinterpret_cast<float2*>(part + nl * SK_MR + 2 * tg) =
        make_float2(c[0], c[1]);
    *reinterpret_cast<float2*>(part + (nl + 8) * SK_MR + 2 * tg) =
        make_float2(c[2], c[3]);
  }

  // the ranks' partial tiles summed in rank order: rank r finishes the
  // outputs i of the 64 x 8 tile with i % ranks == r
  cluster_sync();
  bf16* out = p.out[wi];
  const bool silu_on = p.silu[wi] != 0;
  const uint32_t part_s = smem_u32(part);
  for (int j = threadIdx.x; j * ranks + rank < SKM_BN * SK_MR;
       j += SKM_THREADS) {
    const int i = j * ranks + rank, nl = i / SK_MR, m = i % SK_MR;
    if (m >= p.M || n0 + nl >= N) continue;
    float v[SKM_MAX_SPLIT];
#pragma unroll
    for (int r = 0; r < SKM_MAX_SPLIT; ++r)
      v[r] = r < ranks ? ld_dsmem_f32(part_s + 4 * i, r) : 0.f;
    float z = 0.f;
#pragma unroll
    for (int r = 0; r < SKM_MAX_SPLIT; ++r) z += v[r];
    if (silu_on) z = silu(z);
    out[(size_t)m * N + n0 + nl] = __float2bfloat16_rn(z);
  }
  cluster_sync();   // no block leaves while another reads its tile
}

// up to WG_MAX_W weights [K, n_i] sharing x [M <= SK_MR, K]: one block
// per 64-column strip of each weight and rank of the K split, the
// `splits` ranks of a strip one cluster
static int launch_skinny_mma(const bf16* x, const float* rs, const bf16* nw,
                             const bf16* const* w, bf16* const* out,
                             const int* n, int silu_mask, int count, int M,
                             int K, int splits, int kc, cudaStream_t s) {
  if (count < 1 || count > WG_MAX_W || M > SK_MR || splits < 1 ||
      splits > SKM_MAX_SPLIT || kc % SKM_BK || (long)splits * kc < K)
    return (int)cudaErrorInvalidValue;
  SkinnyGroup p{};
  int tiles = 0;
  for (int i = 0; i < count; ++i) {
    const cuuint64_t wd[2] = {(cuuint64_t)n[i], (cuuint64_t)K};
    const cuuint64_t wst[1] = {(cuuint64_t)n[i] * 2};
    const cuuint32_t wb[2] = {SKM_BN, SKM_BK};
    if (!hopper::make_map_bf16(&p.w[i], w[i], 2, wd, wst, wb))
      return (int)cudaErrorInvalidValue;
    p.out[i] = out[i];
    p.n[i] = n[i];
    p.silu[i] = (silu_mask >> i) & 1;
    tiles += (n[i] + SKM_BN - 1) / SKM_BN;
    p.tiles_end[i] = tiles;
  }
  p.x = x;
  p.rs = rs;
  p.nw = nw;
  p.count = count;
  p.M = M;
  p.K = K;
  p.kc = kc;
  const int smem = skm_smem(kc);
  cudaError_t e = cudaFuncSetAttribute(
      norm_linear_skinny_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * splits);
  cfg.blockDim = dim3(SKM_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, norm_linear_skinny_mma, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------- C entry
template <bool SILU>
static int launch(const float* x, const float* rs, const float* nw,
                  const float* w, float* out, float* part, int M, int N,
                  int K, int splits, cudaStream_t s) {
  if (M <= SK_MR) {
    constexpr int STRIP = 32 * Vec<float>::N;
    const dim3 grid((N + STRIP - 1) / STRIP, splits);
    norm_linear_skinny<float, SILU><<<grid, SK_THREADS, 0, s>>>(
        x, rs, nw, w, out, part, M, N, K);
    if (splits > 1) {
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      const int MN = M * N;
      norm_linear_skinny_sum<float, SILU><<<(MN + 255) / 256, 256, 0, s>>>(
          part, out, MN, splits);
    }
  } else {
    const void* ws[1] = {w};
    void* outs[1] = {out};
    return launch_tiled<float>(x, rs, nw, ws, outs, &N, SILU ? 1 : 0, 1, M,
                               K, s);
  }
  return (int)cudaGetLastError();
}

// one f32 weight (dtype 0; bf16 goes through fused_norm_linear_group and
// is refused here).  M <= SK_MR takes the skinny kernel
// (kernels/fused_norm_linear.py SKINNY_MAX_ROWS mirrors it, to count the
// launch under the right name), where part is the [splits, M, N] f32
// scratch of a call split along K; larger M the tiled f32 kernel
extern "C" int fused_norm_linear(const void* x, const void* rs,
                                 const void* nw, const void* w, void* out,
                                 void* part, int M, int N, int K, int splits,
                                 int act_silu, int dtype, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* xp = (const float*)x;
  const float* r = (const float*)rs;
  const float* nwp = (const float*)nw;
  const float* wp = (const float*)w;
  float* op = (float*)out;
  float* p = (float*)part;
  return act_silu ? launch<true>(xp, r, nwp, wp, op, p, M, N, K, splits, s)
                  : launch<false>(xp, r, nwp, wp, op, p, M, N, K, splits, s);
}

// up to three bf16 weights [K, n_i] that share x [M, K], rs and nw, in
// one launch: q/k/v, or gate/up; bit i of silu_mask applies silu to
// out_i.  M <= SK_MR takes norm_linear_skinny_mma with the K split
// `splits` and `kc` rows a rank (the wrapper's skinny_plan), larger M the
// wgmma kernel (splits and kc unused)
extern "C" int fused_norm_linear_group(
    const void* x, const void* rs, const void* nw, const void* w0,
    const void* w1, const void* w2, void* out0, void* out1, void* out2,
    int n0, int n1, int n2, int silu_mask, int count, int M, int K,
    int splits, int kc, void* stream) {
  if (M == 0) return 0;
  const bf16* w[3] = {(const bf16*)w0, (const bf16*)w1, (const bf16*)w2};
  bf16* out[3] = {(bf16*)out0, (bf16*)out1, (bf16*)out2};
  const int n[3] = {n0, n1, n2};
  if (M <= SK_MR)
    return launch_skinny_mma((const bf16*)x, (const float*)rs,
                             (const bf16*)nw, w, out, n, silu_mask, count, M,
                             K, splits, kc, (cudaStream_t)stream);
  return launch_wgmma((const bf16*)x, (const float*)rs, (const bf16*)nw, w,
                      out, n, silu_mask, count, M, K, (cudaStream_t)stream);
}

// the same group on the general tiled kernel, of the dtype (0 f32, 1
// bf16), for any M, N and K and any alignment: the bf16 shapes the
// Hopper kernels are not built for (the wrapper's route,
// kernels/fused_norm_linear.py hopper_ok)
extern "C" int fused_norm_linear_general(
    const void* x, const void* rs, const void* nw, const void* w0,
    const void* w1, const void* w2, void* out0, void* out1, void* out2,
    int n0, int n1, int n2, int silu_mask, int count, int M, int K,
    int dtype, void* stream) {
  if (M == 0) return 0;
  const void* w[3] = {w0, w1, w2};
  void* out[3] = {out0, out1, out2};
  const int n[3] = {n0, n1, n2};
  int err = 0;
  DISPATCH_DTYPE(dtype, T, {
    err = launch_tiled<T>(x, (const float*)rs, nw, w, out, n, silu_mask,
                          count, M, K, (cudaStream_t)stream);
  });
  return err;
}
