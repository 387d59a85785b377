// A matrix product with the bias and the activation in its epilogue:
//   out = act(x @ w^T + b).to(T)
// x [M, K] and w [N, K] row-major (PyTorch's Linear layout: both operands
// K-contiguous), b [N] or none, act none, relu, exact (erf) gelu,
// gelu_tanh or silu.  The product accumulates in f32; the bias is added
// and the activation applied to the f32 accumulators, and the result is
// rounded once to T.
//
// Replaces paddle_tpu/kernels/fused_linear.py _kernel (pallas_call in
// _fused_linear_fwd): there the epilogue runs in VMEM on the last K step
// of an (M, N, K)-blocked grid, here on the registers that hold a
// block's accumulators, so the pre-activation never goes to device
// memory either.  The TPU kernel falls back to XLA for shapes its blocks
// do not divide; here every M, N and K is taken, the tails masked.
//
// Bound on the H100: at BERT-base's shapes (M = 16384 tokens, K = 768,
// N = 3072 or 768) by operations, 2 M N K of them (0.078 ms for the FFN
// at 989 TFLOP/s in bf16); the bytes (x, w and out once) take a third of
// that.  Two bf16 instances, chosen by the wrapper from the shapes and
// addresses before the launch (kernels/fused_linear.py tma_ok):
// - fused_linear_wgmma (K % 8 == 0, N % 8 == 0 and 16-byte aligned x
//   and w, which the tensor maps of x, w and out need): warp-specialized
//   wgmma fed by TMA, its output stored by TMA, below.
// - fused_linear_bf16 (any other K, N or base): mma.sync m16n8k16 on a
//   128 x 128 x 32 block tile, 8 warps as 2 (rows) x 4 (columns), each
//   warp 64 x 32 = 4 x 4 mma tiles, rows of x and w loaded element by
//   element with zeros past K, the next k-tile's loads held in
//   registers while the current one is multiplied (double-buffered
//   shared memory).  Both operands are staged as they lie, [row][k], with
//   a pitch of 40 bf16 (20 words), which puts the 8 row groups x 4 lanes
//   of a fragment load on 32 distinct banks.
// A bf16 product is exact in f32, so only the order of the f32 sums
// differs from the plain version, and it is fixed: the result does not
// change from run to run.  f32 runs on the CUDA cores in exact f32 FMA
// (64 x 64 tiles, 4 x 4 outputs a thread): the tensor cores would round
// it to TF32.
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

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

// ------------------------------------ bf16, any K (mma.sync, predicated)
constexpr int MM_BM = 128, MM_BN = 128, MM_BK = 32, MM_THREADS = 256;
constexpr int MM_LD = MM_BK + 8;
constexpr int MM_PIECES = MM_BK / 8;                      // 16-byte pieces a row
constexpr int MM_LOADS = MM_BM * MM_PIECES / MM_THREADS;  // per operand, 2

// one k-tile in registers: MM_LOADS 8-wide row pieces of x and of w
struct Tile {
  uint4 a[MM_LOADS], b[MM_LOADS];
};

// 8 neighbouring k of one row from k on, zeros at and past K, one
// element at a time (the row need not be 16-byte aligned)
__device__ __forceinline__ uint4 load_piece(const bf16* row, int k, int K) {
  uint4 v = zero4();
  bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (k + i < K) e[i] = row[k + i];
  return v;
}

// rows past M (or N) load zeros
__device__ __forceinline__ void tile_load(Tile& r, const bf16* x,
                                          const bf16* w, int M, int N, int K,
                                          int m0, int n0, int k0) {
#pragma unroll
  for (int j = 0; j < MM_LOADS; ++j) {
    const int p = threadIdx.x + j * MM_THREADS;
    const int row = p / MM_PIECES, k = k0 + (p % MM_PIECES) * 8;
    const int m = m0 + row, n = n0 + row;
    r.a[j] = m < M ? load_piece(x + (size_t)m * K, k, K) : zero4();
    r.b[j] = n < N ? load_piece(w + (size_t)n * K, k, K) : zero4();
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

template <int ACT>
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
  tile_load(regs, x, w, M, N, K, m0, n0, 0);
  tile_store(regs, As[0], Bs[0]);
  __syncthreads();
  const int tiles = (K + MM_BK - 1) / MM_BK;
  for (int kt = 0; kt < tiles; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < tiles)
      tile_load(regs, x, w, M, N, K, m0, n0, (kt + 1) * MM_BK);
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

// ------------------------- bf16, K % 8 == 0 and N % 8 == 0 (wgmma + TMA)
// A block owns 128 x BN output tiles (BN = 256, or 128 where 256-wide
// tiles would leave SMs idle) and walks the tile table with a stride of
// the grid, one block a SM, so the producer loads the next tile's first
// k-tiles while the consumers run this one's epilogue.  Warpgroups 0 and
// 1 consume (64 rows each), warpgroup 2 produces: one of its threads
// keeps a ring of FL_STAGES 64-deep k-tiles in flight by TMA, each stage
// x's [128 rows][64 k] box and w's BN rows as BN / 64 boxes of
// [64 n][64 k], all 128-byte swizzled, with one full and one empty
// mbarrier a stage; a box of w wholly past N is not loaded (its columns
// are never stored), and TMA fills rows past M or N and k past K with
// zeros.  A consumer issues wgmma m64nBNk16 with both operands from
// shared memory, both K-major, and keeps one k-tile's products in flight
// while it waits for the next stage.  Every read of a stage is the
// tensor cores' (the async proxy, as TMA's writes), so a consumer frees
// a stage once wgmma_wait has retired the products that read it, with
// no proxy fence.  The tile table puts the M-tiles of one N-tile next to
// each other, so each w tile leaves HBM once and x (25 MB at the FFN
// shape) stays in the L2.
//
// The epilogue adds the f32 bias, applies the activation to the f32
// sums and rounds once.  The tile's bias comes from shared memory: a
// consumer thread loads one column of it before the tile's products and
// stores it there after them.  Each warp writes its 16 rows 64 columns
// at a time into one of two 2 KB buffers in the TMA box layout (128-byte
// swizzle), and one lane stores the box by TMA, which drops what lies
// past M or N; the warp waits only until the store before last has read
// its buffer, so the stores drain while the block goes on to the next
// tile.  At BERT's FFN shape the epilogue, not the products, sets the
// kernel's time on the H100 (python -m
// paddle_tpu_torch.tools.fused_linear_parts times the parts): the
// fragments' own 4-byte stores (8 rows a store instruction, every
// block's epilogue at once) took as long again as the products, and
// the erf of gelu runs between tiles.  Two designs that hide the
// epilogue behind products on 128 x 128 tiles (warpgroups in ping-pong,
// each on its own tiles; or a tile's epilogue in slices between the
// next tile's k-tiles) were slower as a whole: 128-wide tiles read a
// third more from the L2 for each product.
constexpr int FL_BM = 128, FL_BK = 64, FL_STAGES = 4, FL_THREADS = 384;
constexpr int FL_X_BYTES = FL_BM * FL_BK * 2;   // 16 KB
constexpr int FL_W_BOX = 64 * FL_BK * 2;        // 8 KB: 64 n x 64 k
constexpr int FL_OUT_BOX = 16 * 64 * 2;         // 2 KB: 16 rows x 64 n
constexpr int FL_STAGING = 8 * 2 * FL_OUT_BOX;  // 8 warps, 2 buffers each
constexpr int FL_BIAS = 256 * 4;                // a tile's bias, f32
template <int BN>
__host__ __device__ constexpr int fl_stage() {
  return FL_X_BYTES + BN / 64 * FL_W_BOX;   // 48 KB at BN = 256
}
template <int BN>
__host__ __device__ constexpr int fl_smem() {
  return 1024 + FL_STAGES * fl_stage<BN>() + FL_STAGING + FL_BIAS +
         2 * FL_STAGES * 8;
}

struct FLMaps {
  CUtensorMap x;     // [M, K], box 64 k x 128 rows
  CUtensorMap w;     // [N, K], box 64 k x 64 rows
  CUtensorMap out;   // [M, N], box 64 n x 16 rows
};

// columns [n0, n0 + 64) of a warp's 16 rows (from row m0) of act(acc +
// bias), with bias those 64 columns' f32 bias in shared memory, rounded
// to bf16, through the staging buffer buf (1024-byte aligned): each lane
// writes its fragments' pairs (row g + 8 h, column 8 jj + 2 tg: 16-byte
// chunk jj ^ g of the swizzled row, so the 32 lanes fall on 32 banks),
// then lane 0 stores the box.  Before writing, lane 0 waits until at
// most one earlier store still reads its buffer: the other buffer's.
template <int ACT>
__device__ __forceinline__ void store_chunk(const float* acc, uint8_t* buf,
                                            const CUtensorMap* map,
                                            const float* bias, int m0,
                                            int n0, int lane) {
  using namespace hopper;
  const int g = lane / 4, tg = lane % 4;
  if (lane == 0) bulk_wait_read<1>();
  __syncwarp();
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const float2 bv = *reinterpret_cast<const float2*>(bias + 8 * jj +
                                                       2 * tg);
    const float b0 = bv.x, b1 = bv.y;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(buf + swz128(g + 8 * h, jj) + 4 * tg) =
          pack_bf16(activate<ACT>(acc[4 * jj + 2 * h] + b0),
                    activate<ACT>(acc[4 * jj + 2 * h + 1] + b1));
  }
  fence_proxy_async();   // the writes (generic proxy) before TMA's reads
  __syncwarp();
  if (lane == 0) {
    tma_store_2d(map, buf, n0, m0);
    bulk_commit();
  }
}

template <int BN, int ACT>
__global__ void __launch_bounds__(FL_THREADS, 1)
    fused_linear_wgmma(const __grid_constant__ FLMaps maps,
                       const bf16* __restrict__ b, int M, int N, int K) {
  constexpr int STAGE = fl_stage<BN>();
  using namespace hopper;
  extern __shared__ uint8_t fl_smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(fl_smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* staging = smem + FL_STAGES * STAGE;
  float* bias = reinterpret_cast<float*>(staging + FL_STAGING);
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + FL_STAGING +
                                               FL_BIAS);
  uint64_t* empty = full + FL_STAGES;
  const int m_tiles = (M + FL_BM - 1) / FL_BM;
  const int tiles = m_tiles * ((N + BN - 1) / BN);
  const int k_tiles = (K + FL_BK - 1) / FL_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < FL_STAGES; ++s) {
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
      int it = 0;   // k-tiles loaded so far, over all of this block's tiles
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t % m_tiles) * FL_BM, n0 = (t / m_tiles) * BN;
        const int boxes = min(BN / 64, (N - n0 + 63) / 64);
        const uint32_t bytes = FL_X_BYTES + boxes * FL_W_BOX;
        for (int kt = 0; kt < k_tiles; ++kt, ++it) {
          const int s = it % FL_STAGES;
          if (it >= FL_STAGES) mbar_wait(&empty[s], (it / FL_STAGES - 1) & 1);
          uint8_t* st = smem + s * STAGE;
          mbar_expect_tx(&full[s], bytes);
          tma_load_2d(st, &maps.x, &full[s], kt * FL_BK, m0);
          for (int j = 0; j < boxes; ++j)
            tma_load_2d(st + FL_X_BYTES + j * FL_W_BOX, &maps.w, &full[s],
                        kt * FL_BK, n0 + 64 * j);
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    setmaxnreg_inc<232>();
    const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int r0 = wg * 64 + warp * 16;     // this warp's rows in a tile
    uint8_t* bufs = staging + (threadIdx.x / 32) * 2 * FL_OUT_BOX;
    int it = 0, chunks = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t % m_tiles) * FL_BM, n0 = (t / m_tiles) * BN;
      // the tile's bias, a column a thread: loaded now, so the load's
      // latency hides behind the products, and put in shared memory
      // after them
      const int col = n0 + threadIdx.x;
      const float bias_col =
          (b && threadIdx.x < BN && col < N) ? to_f32(b[col]) : 0.f;
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < k_tiles; ++kt, ++it) {
        const int s = it % FL_STAGES;
        mbar_wait(&full[s], (it / FL_STAGES) & 1);
        const uint32_t xa = smem_u32(smem + s * STAGE) + wg * 64 * 128;
        const uint32_t wa = smem_u32(smem + s * STAGE + FL_X_BYTES);
        wgmma_fence();
        fence_regs<BN / 2>(acc);
        // a 16-deep k step is 32 bytes into each 128-byte swizzled row
#pragma unroll
        for (int kk = 0; kk < FL_BK / 16; ++kk) {
          const uint64_t da = desc_sw128(xa + kk * 32, 16, 1024);
          const uint64_t dw = desc_sw128(wa + kk * 32, 16, 1024);
          if constexpr (BN == 256)
            wgmma_ss_n256<0>(acc, da, dw, 1);
          else
            wgmma_ss_n128<0>(acc, da, dw, 1);
        }
        wgmma_commit();
        // the previous k-tile's products are done: free its stage
        wgmma_wait<1>();
        fence_regs<BN / 2>(acc);
        if (kt > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % FL_STAGES]);
      }
      wgmma_wait<0>();
      fence_regs<BN / 2>(acc);
      if (lane == 0) mbar_arrive(&empty[(it - 1) % FL_STAGES]);
      // both warpgroups are done with the last tile's bias (a warpgroup
      // can be a tile ahead where K is a few k-tiles)
      named_bar_sync(1, 256);
      if (threadIdx.x < BN) bias[threadIdx.x] = bias_col;
      named_bar_sync(1, 256);

      // acc[4 j + 2 h + c]: row r0 + g + 8 h, column 8 j + 2 tg + c
#pragma unroll
      for (int c = 0; c < BN / 64; ++c)
        if (n0 + 64 * c < N)
          store_chunk<ACT>(acc + 32 * c,
                           bufs + (chunks++ & 1) * FL_OUT_BOX, &maps.out,
                           bias + 64 * c, m0 + r0, n0 + 64 * c, lane);
    }
    // the last stores have left shared memory and reached the output
    if (lane == 0) bulk_wait<0>();
  }
}

template <int BN, int ACT>
static int launch_wgmma_tiles(const FLMaps& maps, const bf16* b, int M,
                              int N, int K, int sms, cudaStream_t s) {
  constexpr int smem = fl_smem<BN>();
  const cudaError_t e = cudaFuncSetAttribute(
      fused_linear_wgmma<BN, ACT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = ((M + FL_BM - 1) / FL_BM) * ((N + BN - 1) / BN);
  fused_linear_wgmma<BN, ACT><<<min(tiles, sms), FL_THREADS, smem, s>>>(
      maps, b, M, N, K);
  return (int)cudaGetLastError();
}

// the tensor maps of x [M, K], w [N, K] and out [M, N] (K % 8 == 0,
// N % 8 == 0 and 16-byte aligned bases: the wrapper's tma_ok; a map the
// driver refuses is an error, never a cue to take the other instance),
// 256-wide tiles, or 128-wide where 256-wide ones would leave SMs idle
template <int ACT>
static int launch_wgmma(const bf16* x, const bf16* w, const bf16* b,
                        bf16* out, int M, int N, int K, cudaStream_t s) {
  FLMaps maps;
  const cuuint64_t xd[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t wd[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const cuuint64_t od[2] = {(cuuint64_t)N, (cuuint64_t)M};
  const cuuint64_t st[1] = {(cuuint64_t)K * 2};
  const cuuint64_t ost[1] = {(cuuint64_t)N * 2};
  const cuuint32_t xb[2] = {FL_BK, FL_BM};
  const cuuint32_t wb[2] = {FL_BK, 64};
  const cuuint32_t ob[2] = {64, 16};
  if (!hopper::make_map_bf16(&maps.x, x, 2, xd, st, xb) ||
      !hopper::make_map_bf16(&maps.w, w, 2, wd, st, wb) ||
      !hopper::make_map_bf16(&maps.out, out, 2, od, ost, ob))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int wide = ((M + FL_BM - 1) / FL_BM) * ((N + 255) / 256);
  return wide < sms
             ? launch_wgmma_tiles<128, ACT>(maps, b, M, N, K, sms, s)
             : launch_wgmma_tiles<256, ACT>(maps, b, M, N, K, sms, s);
}

// ---------------------------------------------------------- C entry
template <typename T, int ACT>
static int launch(const T* x, const T* w, const T* b, T* out, int M, int N,
                  int K, int tma, cudaStream_t s) {
  if constexpr (sizeof(T) == 2) {
    if (tma) return launch_wgmma<ACT>(x, w, b, out, M, N, K, s);
    const dim3 grid((N + MM_BN - 1) / MM_BN, (M + MM_BM - 1) / MM_BM);
    fused_linear_bf16<ACT><<<grid, MM_THREADS, 0, s>>>(x, w, b, out, M, N,
                                                      K);
  } else {
    const dim3 grid((N + TB_N - 1) / TB_N, (M + TB_M - 1) / TB_M);
    fused_linear_f32<ACT><<<grid, TB_THREADS, 0, s>>>(x, w, b, out, M, N, K);
  }
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_act(int act, const T* x, const T* w, const T* b, T* out,
                      int M, int N, int K, int tma, cudaStream_t s) {
  switch (act) {
    case 0: return launch<T, 0>(x, w, b, out, M, N, K, tma, s);
    case 1: return launch<T, 1>(x, w, b, out, M, N, K, tma, s);
    case 2: return launch<T, 2>(x, w, b, out, M, N, K, tma, s);
    case 3: return launch<T, 3>(x, w, b, out, M, N, K, tma, s);
    case 4: return launch<T, 4>(x, w, b, out, M, N, K, tma, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// b may be null (no bias); any K.  tma (bf16 only) takes the wgmma
// instance: the wrapper sets it where tma_ok holds (K % 8 == 0,
// N % 8 == 0, x, w and out 16-byte aligned); the predicated instance
// takes every other bf16 call
extern "C" int fused_linear(const void* x, const void* w, const void* b,
                            void* out, int M, int N, int K, int act,
                            int dtype, int tma, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (tma && (dtype != 1 || K <= 0 || K % 8 || N % 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  DISPATCH_DTYPE(dtype, T, {
    return launch_act<T>(act, (const T*)x, (const T*)w, (const T*)b,
                         (T*)out, M, N, K, tma, s);
  });
}
