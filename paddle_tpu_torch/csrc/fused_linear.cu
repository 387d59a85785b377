// A matrix product with the bias and the activation in its epilogue:
//   out = act(x @ w^T + b).to(T)
// x [M, K] and w [N, K] row-major (PyTorch's Linear layout: both operands
// K-contiguous, the row.col operand order of mma.sync), b [N] or none,
// act none, relu, exact (erf) gelu, gelu_tanh or silu.  The product
// accumulates in f32; the bias is added and the activation applied to
// the f32 accumulators, and the result is rounded once to T.
//
// Replaces paddle_tpu/kernels/fused_linear.py _kernel (pallas_call in
// _fused_linear_fwd): there the epilogue runs in VMEM on the last K step
// of an (M, N, K)-blocked grid, here on the registers that hold a
// block's accumulators, so the pre-activation never goes to device
// memory either.  The TPU kernel falls back to XLA for shapes its blocks
// do not divide; here every M and N is taken, the tails predicated.
//
// Bound on the H100: at BERT-base's shapes (M = 16384 tokens, K = 768,
// N = 3072 or 768) by operations, 2 M N K of them (0.078 ms for the FFN
// at 989 TFLOP/s in bf16); the bytes (x, w and out once) take a third of
// that.  This first version is right and simple: a 128 x 128 x 32 block
// tile on the tensor cores (mma.sync m16n8k16, bf16 in, f32 out; a bf16
// product is exact in f32, so only the order of the f32 sums differs
// from the plain version), 8 warps as 2 (rows) x 4 (columns), each warp
// 64 x 32 = 4 x 4 mma tiles; the next k-tile's global loads wait in
// registers while the current one is multiplied (double-buffered shared
// memory).  Rows of x and w are loaded 16 bytes at a time where K % 8 == 0
// and both bases are aligned, else element by element with zeros past K
// (a second instance of the kernel), so every K runs.  Both operands are staged as they lie, [row][k], with a pitch
// of 40 bf16 (20 words), which puts the 8 row groups x 4 lanes of a
// fragment load on 32 distinct banks, so every fragment is one 32-bit
// shared load.  wgmma with TMA, and a persistent schedule, are later
// work.  f32 runs on the CUDA cores in exact f32 FMA (64 x 64 tiles,
// 4 x 4 outputs a thread): the tensor cores would round it to TF32.
#include <cstdint>

#include "common.cuh"

// activation codes: kernels/fused_linear.py ACTIVATIONS
template <int ACT>
__device__ __forceinline__ float activate(float z) {
  if constexpr (ACT == 1) {
    return z < 0.f ? 0.f : z;  // NaN stays NaN, as torch.relu
  } else if constexpr (ACT == 2) {
    return 0.5f * z * (1.f + erff(z * 0.70710678118654752f));
  } else if constexpr (ACT == 3) {
    const float u = 0.79788456080286536f * (z + 0.044715f * z * z * z);
    return 0.5f * z * (1.f + tanhf(u));
  } else if constexpr (ACT == 4) {
    return z / (1.f + expf(-z));
  } else {
    return z;
  }
}

// ------------------------------------------------- f32 (CUDA cores)
constexpr int TB_M = 64, TB_N = 64, TB_K = 16, TB_THREADS = 256;

template <int ACT>
__global__ void __launch_bounds__(TB_THREADS)
    fused_linear_f32(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ b, float* __restrict__ out,
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
    // 16 neighbouring threads read 16 neighbouring k of one row
    for (int i = threadIdx.x; i < TB_M * TB_K; i += TB_THREADS) {
      const int r = i / TB_K, kk = i % TB_K;
      const int m = m0 + r, n = n0 + r, k = k0 + kk;
      As[kk][r] = (m < M && k < K) ? x[(size_t)m * K + k] : 0.f;
      Bs[kk][r] = (n < N && k < K) ? w[(size_t)n * K + k] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TB_K; ++kk) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx * 4 + j;
    if (n >= N) continue;
    const float bias = b ? b[n] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + ty * 4 + i;
      if (m < M) out[(size_t)m * N + n] = activate<ACT>(acc[i][j] + bias);
    }
  }
}

// --------------------------------------------- bf16 (tensor cores)
constexpr int MM_BM = 128, MM_BN = 128, MM_BK = 32, MM_THREADS = 256;
constexpr int MM_LD = MM_BK + 8;
constexpr int MM_PIECES = MM_BK / 8;                      // 16-byte pieces a row
constexpr int MM_LOADS = MM_BM * MM_PIECES / MM_THREADS;  // per operand, 2

// one k-tile in registers: MM_LOADS 8-wide row pieces of x and of w
struct Tile {
  uint4 a[MM_LOADS], b[MM_LOADS];
};

// 8 neighbouring k of one row from k on, zeros at and past K: one
// 16-byte load where the row is aligned (VEC: K % 8 == 0 and an aligned
// base, so a piece is all in or all out), else 8 predicated loads
template <bool VEC>
__device__ __forceinline__ uint4 load_piece(const bf16* row, int k, int K) {
  if constexpr (VEC) {
    return k < K ? *reinterpret_cast<const uint4*>(row + k) : zero4();
  } else {
    uint4 v = zero4();
    bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (k + i < K) e[i] = row[k + i];
    return v;
  }
}

// rows past M (or N) load zeros
template <bool VEC>
__device__ __forceinline__ void tile_load(Tile& r, const bf16* x,
                                          const bf16* w, int M, int N, int K,
                                          int m0, int n0, int k0) {
#pragma unroll
  for (int j = 0; j < MM_LOADS; ++j) {
    const int p = threadIdx.x + j * MM_THREADS;
    const int row = p / MM_PIECES, k = k0 + (p % MM_PIECES) * 8;
    const int m = m0 + row, n = n0 + row;
    r.a[j] = m < M ? load_piece<VEC>(x + (size_t)m * K, k, K) : zero4();
    r.b[j] = n < N ? load_piece<VEC>(w + (size_t)n * K, k, K) : zero4();
  }
}

// 16-byte stores: the pitch (80 bytes) and the piece offsets are
// multiples of 16 bytes
__device__ __forceinline__ void tile_store(const Tile& r, bf16 (*As)[MM_LD],
                                           bf16 (*Bs)[MM_LD]) {
#pragma unroll
  for (int j = 0; j < MM_LOADS; ++j) {
    const int p = threadIdx.x + j * MM_THREADS;
    const int row = p / MM_PIECES, kk = (p % MM_PIECES) * 8;
    *reinterpret_cast<uint4*>(&As[row][kk]) = r.a[j];
    *reinterpret_cast<uint4*>(&Bs[row][kk]) = r.b[j];
  }
}

template <int ACT, bool VEC>
__global__ void __launch_bounds__(MM_THREADS)
    fused_linear_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w,
                      const bf16* __restrict__ b, bf16* __restrict__ out,
                      int M, int N, int K) {
  __shared__ __align__(16) bf16 As[2][MM_BM][MM_LD];
  __shared__ __align__(16) bf16 Bs[2][MM_BN][MM_LD];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;  // 64-row, 32-column warp tile
  const int g = lane / 4, tg = lane % 4;
  const int m0 = blockIdx.y * MM_BM, n0 = blockIdx.x * MM_BN;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  Tile regs;
  tile_load<VEC>(regs, x, w, M, N, K, m0, n0, 0);
  tile_store(regs, As[0], Bs[0]);
  __syncthreads();
  const int tiles = (K + MM_BK - 1) / MM_BK;
  for (int kt = 0; kt < tiles; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < tiles)
      tile_load<VEC>(regs, x, w, M, N, K, m0, n0, (kt + 1) * MM_BK);
#pragma unroll
    for (int ks = 0; ks < MM_BK; ks += 16) {
      uint32_t a[4][4], c[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm * 64 + i * 16 + g;
        a[i][0] = ld_pair(&As[cur][r][ks + 2 * tg]);
        a[i][1] = ld_pair(&As[cur][r + 8][ks + 2 * tg]);
        a[i][2] = ld_pair(&As[cur][r][ks + 2 * tg + 8]);
        a[i][3] = ld_pair(&As[cur][r + 8][ks + 2 * tg + 8]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn * 32 + j * 8 + g;  // w row = B column
        c[j][0] = ld_pair(&Bs[cur][n][ks + 2 * tg]);
        c[j][1] = ld_pair(&Bs[cur][n][ks + 2 * tg + 8]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], c[j]);
    }
    // the other buffer was last read in iteration kt - 1, before the
    // barrier that ended it, so it can be refilled without one
    if (kt + 1 < tiles) tile_store(regs, As[cur ^ 1], Bs[cur ^ 1]);
    __syncthreads();
  }
  // c0, c1: row g, columns 2 tg and 2 tg + 1; c2, c3: row g + 8.  An
  // even N keeps every column pair inside a row and 4-byte aligned.
  const bool pairs = (N % 2) == 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + wn * 32 + j * 8 + 2 * tg;
    if (n >= N) continue;
    const bool second = n + 1 < N;
    const float b0 = b ? to_f32(b[n]) : 0.f;
    const float b1 = (b && second) ? to_f32(b[n + 1]) : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 64 + i * 16 + g + 8 * h;
        if (m >= M) continue;
        const float z0 = activate<ACT>(acc[i][j][2 * h] + b0);
        const float z1 = activate<ACT>(acc[i][j][2 * h + 1] + b1);
        bf16* o = out + (size_t)m * N + n;
        if (pairs) {
          *reinterpret_cast<uint32_t*>(o) = pack_bf16(z0, z1);
        } else {
          o[0] = __float2bfloat16_rn(z0);
          if (second) o[1] = __float2bfloat16_rn(z1);
        }
      }
    }
  }
}

// ---------------------------------------------------------- C entry
template <typename T, int ACT>
static int launch(const T* x, const T* w, const T* b, T* out, int M, int N,
                  int K, cudaStream_t s) {
  if constexpr (sizeof(T) == 2) {
    const dim3 grid((N + MM_BN - 1) / MM_BN, (M + MM_BM - 1) / MM_BM);
    const bool vec = K % 8 == 0 &&
                     (reinterpret_cast<uintptr_t>(x) |
                      reinterpret_cast<uintptr_t>(w)) % 16 == 0;
    if (vec)
      fused_linear_bf16<ACT, true><<<grid, MM_THREADS, 0, s>>>(x, w, b, out,
                                                                M, N, K);
    else
      fused_linear_bf16<ACT, false><<<grid, MM_THREADS, 0, s>>>(x, w, b, out,
                                                                 M, N, K);
  } else {
    const dim3 grid((N + TB_N - 1) / TB_N, (M + TB_M - 1) / TB_M);
    fused_linear_f32<ACT><<<grid, TB_THREADS, 0, s>>>(x, w, b, out, M, N, K);
  }
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_act(int act, const T* x, const T* w, const T* b, T* out,
                      int M, int N, int K, cudaStream_t s) {
  switch (act) {
    case 0: return launch<T, 0>(x, w, b, out, M, N, K, s);
    case 1: return launch<T, 1>(x, w, b, out, M, N, K, s);
    case 2: return launch<T, 2>(x, w, b, out, M, N, K, s);
    case 3: return launch<T, 3>(x, w, b, out, M, N, K, s);
    case 4: return launch<T, 4>(x, w, b, out, M, N, K, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// b may be null (no bias); any K: rows that are not 16-byte aligned take
// the predicated loads
extern "C" int fused_linear(const void* x, const void* w, const void* b,
                            void* out, int M, int N, int K, int act,
                            int dtype, void* stream) {
  if (M == 0 || N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  DISPATCH_DTYPE(dtype, T, {
    return launch_act<T>(act, (const T*)x, (const T*)w, (const T*)b,
                         (T*)out, M, N, K, s);
  });
}
