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
// Two kernels, chosen by the number of rows M:
// - skinny (M <= 8, the decode step): bound by bytes, the one read of w.
//   Each lane loads 16 bytes of a row of w at a time (8 bf16 or 4 f32
//   columns), so a warp streams one contiguous 512-byte row segment; a
//   block's 8 warps take interleaved rows of its K range.  A narrow
//   projection (N = 1024 is only 4 column strips) is also split along K
//   over the grid (gridDim.y), so that enough blocks stream w to fill
//   the card; each split writes an f32 partial and a second pass sums
//   the splits in a fixed order, applies silu and casts.  The warps'
//   sums meet in a fixed tree in shared memory: no atomics, the result
//   does not change from run to run.
// - tiled (M > 8, the prefill chunk): bound by operations.  For bf16 a
//   64x128 block tile runs on the tensor cores (mma.sync m16n8k16,
//   bf16 in, f32 accumulate; a bf16 product is exact in f32, so only
//   the order of the f32 sums differs from the plain version), with the
//   next k-tile's global loads in registers while the current one is
//   multiplied (double-buffered shared memory).  f32 runs on the CUDA
//   cores (64x64 tiles, 4x4 outputs per thread): the tensor cores would
//   round it to TF32.
#include <cstdint>

#include "common.cuh"

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

// ------------------------------------------------- tiled, f32 (CUDA cores)
constexpr int TB_M = 64, TB_N = 64, TB_K = 16, TB_THREADS = 256;

template <bool SILU>
__global__ void __launch_bounds__(TB_THREADS)
    norm_linear_tiled_f32(const float* __restrict__ x,
                          const float* __restrict__ rs,
                          const float* __restrict__ nw,
                          const float* __restrict__ w, float* __restrict__ out,
                          int M, int N, int K) {
  __shared__ float As[TB_K][TB_M + 4];
  __shared__ float Bs[TB_K][TB_N + 4];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * TB_M, n0 = blockIdx.x * TB_N;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += TB_K) {
    for (int i = threadIdx.x; i < TB_M * TB_K; i += TB_THREADS) {
      const int mm = i / TB_K, kk = i % TB_K;
      const int m = m0 + mm, k = k0 + kk;
      As[kk][mm] = (m < M && k < K) ? norm_elem(x, rs, nw, m, k, K) : 0.f;
    }
    for (int i = threadIdx.x; i < TB_K * TB_N; i += TB_THREADS) {
      const int kk = i / TB_N, nn = i % TB_N;
      const int k = k0 + kk, n = n0 + nn;
      Bs[kk][nn] = (k < K && n < N) ? w[(size_t)k * N + n] : 0.f;
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
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) continue;
      float z = acc[i][j];
      if (SILU) z = silu(z);
      out[(size_t)m * N + n] = z;
    }
  }
}

// --------------------------------------------- tiled, bf16 (tensor cores)
// Block tile 64 x 128 x 32, 8 warps as 2 (rows) x 4 (columns), each warp
// 32 x 32 = 2 x 4 mma tiles of 16 x 8.  A (normalized x) is staged
// row-major [m][k], its fragments are pairs of neighbouring k (one
// 32-bit shared load each); the pitch of 40 bf16 (20 words) puts the 8
// row groups x 4 lanes of a fragment load on 32 distinct banks.  B (w)
// is staged as it lies, [k][n], and ldmatrix.trans hands each lane its
// k-pairs; the pitch of 136 bf16 (68 words) puts its 8 rows on distinct
// banks.
constexpr int MM_BM = 64, MM_BN = 128, MM_BK = 32, MM_THREADS = 256;
constexpr int MM_LDA = MM_BK + 8;
constexpr int MM_LDB = MM_BN + 8;

// global -> registers for one k-tile: each thread one 8-wide row piece
// of A (64 x 32 = 256 pieces) and two of B (32 x 128 = 512 pieces);
// needs K % 8 == 0 and N % 8 == 0 (checked by the wrapper)
struct MmaRegs {
  uint4 a, b[2];
};

__device__ __forceinline__ void mma_load(MmaRegs& r, const bf16* x,
                                         const float* rs, const bf16* nw,
                                         const bf16* w, int M, int N, int K,
                                         int m0, int n0, int k0) {
  const int t = threadIdx.x;
  {
    const int mm = t / (MM_BK / 8), kk = (t % (MM_BK / 8)) * 8;
    const int m = m0 + mm, k = k0 + kk;
    r.a = zero4();
    if (m < M && k < K) {
      const uint4 xv = *reinterpret_cast<const uint4*>(x + (size_t)m * K + k);
      const uint4 wv = *reinterpret_cast<const uint4*>(nw + k);
      const bf16* xe = reinterpret_cast<const bf16*>(&xv);
      const bf16* we = reinterpret_cast<const bf16*>(&wv);
      bf16* oe = reinterpret_cast<bf16*>(&r.a);
      const float s = rs[m];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float v = round_to<bf16>(__bfloat162float(xe[i]) * s);
        oe[i] = __float2bfloat16_rn(v * __bfloat162float(we[i]));
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int p = t + j * MM_THREADS;
    const int kk = p / (MM_BN / 8), nn = (p % (MM_BN / 8)) * 8;
    const int k = k0 + kk, n = n0 + nn;
    r.b[j] = (k < K && n < N)
                 ? *reinterpret_cast<const uint4*>(w + (size_t)k * N + n)
                 : zero4();
  }
}

// 16-byte stores: the pitches (80 and 272 bytes) and the piece offsets
// are multiples of 16 bytes
__device__ __forceinline__ void mma_store(const MmaRegs& r,
                                          bf16 (*As)[MM_LDA],
                                          bf16 (*Bs)[MM_LDB]) {
  const int t = threadIdx.x;
  *reinterpret_cast<uint4*>(&As[t / (MM_BK / 8)][(t % (MM_BK / 8)) * 8]) =
      r.a;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int p = t + j * MM_THREADS;
    *reinterpret_cast<uint4*>(&Bs[p / (MM_BN / 8)][(p % (MM_BN / 8)) * 8]) =
        r.b[j];
  }
}

template <bool SILU>
__global__ void __launch_bounds__(MM_THREADS)
    norm_linear_tiled_bf16(const bf16* __restrict__ x,
                           const float* __restrict__ rs,
                           const bf16* __restrict__ nw,
                           const bf16* __restrict__ w, bf16* __restrict__ out,
                           int M, int N, int K) {
  __shared__ __align__(16) bf16 As[2][MM_BM][MM_LDA];
  __shared__ __align__(16) bf16 Bs[2][MM_BK][MM_LDB];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int g = lane / 4, tg = lane % 4;
  const int m0 = blockIdx.y * MM_BM, n0 = blockIdx.x * MM_BN;
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  MmaRegs regs;
  mma_load(regs, x, rs, nw, w, M, N, K, m0, n0, 0);
  mma_store(regs, As[0], Bs[0]);
  __syncthreads();
  const int tiles = (K + MM_BK - 1) / MM_BK;
  for (int kt = 0; kt < tiles; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < tiles)
      mma_load(regs, x, rs, nw, w, M, N, K, m0, n0, (kt + 1) * MM_BK);
#pragma unroll
    for (int ks = 0; ks < MM_BK; ks += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm * 32 + i * 16 + g;
        a[i][0] = ld_pair(&As[cur][r][ks + 2 * tg]);
        a[i][1] = ld_pair(&As[cur][r + 8][ks + 2 * tg]);
        a[i][2] = ld_pair(&As[cur][r][ks + 2 * tg + 8]);
        a[i][3] = ld_pair(&As[cur][r + 8][ks + 2 * tg + 8]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ldsm_x2_trans(b[j], &Bs[cur][ks + lane % 16][wn * 32 + j * 8]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j]);
    }
    // the other buffer was last read in iteration kt - 1, before the
    // barrier that ended it, so it can be refilled without one
    if (kt + 1 < tiles) mma_store(regs, As[cur ^ 1], Bs[cur ^ 1]);
    __syncthreads();
  }
  // c0, c1: row g, columns 2 tg, 2 tg + 1; c2, c3: row g + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + wn * 32 + j * 8 + 2 * tg;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 32 + i * 16 + g + 8 * h;
        if (m >= M || n >= N) continue;   // N % 8 == 0: n + 1 < N too
        float z0 = acc[i][j][2 * h], z1 = acc[i][j][2 * h + 1];
        if (SILU) {
          z0 = silu(z0);
          z1 = silu(z1);
        }
        __nv_bfloat162 o;
        o.x = __float2bfloat16_rn(z0);
        o.y = __float2bfloat16_rn(z1);
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * N + n) = o;
      }
    }
  }
}

// ---------------------------------------------------------- C entry
template <typename T, bool SILU>
static int launch(const T* x, const float* rs, const T* nw, const T* w,
                  T* out, float* part, int M, int N, int K, int splits,
                  cudaStream_t s) {
  if (M <= SK_MR) {
    constexpr int STRIP = 32 * Vec<T>::N;
    const dim3 grid((N + STRIP - 1) / STRIP, splits);
    norm_linear_skinny<T, SILU><<<grid, SK_THREADS, 0, s>>>(
        x, rs, nw, w, out, part, M, N, K);
    if (splits > 1) {
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      const int MN = M * N;
      norm_linear_skinny_sum<T, SILU><<<(MN + 255) / 256, 256, 0, s>>>(
          part, out, MN, splits);
    }
  } else if constexpr (sizeof(T) == 2) {
    const dim3 grid((N + MM_BN - 1) / MM_BN, (M + MM_BM - 1) / MM_BM);
    norm_linear_tiled_bf16<SILU><<<grid, MM_THREADS, 0, s>>>(
        x, rs, nw, w, out, M, N, K);
  } else {
    const dim3 grid((N + TB_N - 1) / TB_N, (M + TB_M - 1) / TB_M);
    norm_linear_tiled_f32<SILU><<<grid, TB_THREADS, 0, s>>>(
        x, rs, nw, w, out, M, N, K);
  }
  return (int)cudaGetLastError();
}

// M <= SK_MR takes the skinny kernel (kernels/fused_norm_linear.py
// SKINNY_MAX_ROWS mirrors it, to count the launch under the right name);
// part is the [splits, M, N] f32 scratch of a skinny call split along K
extern "C" int fused_norm_linear(const void* x, const void* rs,
                                 const void* nw, const void* w, void* out,
                                 void* part, int M, int N, int K, int splits,
                                 int act_silu, int dtype, void* stream) {
  if (M == 0 || N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const float* r = (const float*)rs;
  float* p = (float*)part;
  DISPATCH_DTYPE(dtype, T, {
    const T* xp = (const T*)x;
    const T* nwp = (const T*)nw;
    const T* wp = (const T*)w;
    T* op = (T*)out;
    return act_silu ? launch<T, true>(xp, r, nwp, wp, op, p, M, N, K, splits, s)
                    : launch<T, false>(xp, r, nwp, wp, op, p, M, N, K, splits,
                                       s);
  });
}
