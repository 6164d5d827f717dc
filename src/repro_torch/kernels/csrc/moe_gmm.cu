// Grouped expert matmul for Hopper (sm_90a): (E, C, D) @ (E, D, F) -> (E, C, F)
// with f32 accumulation and an optional fused epilogue (silu, or gelu in its
// tanh form) on the f32 accumulator before one rounding to x's dtype.
//
// Replaces the Pallas TPU kernel repro/kernels/moe_gmm.py (gmm, _gmm_kernel).
// There the grid is (E, C/bc, F/bf, D/bd) with the contraction innermost and
// a VMEM accumulator carried across the sequential D sweep; here a thread
// block owns an output tile and walks D in a loop inside the block, its
// accumulator in registers.
//
// Layout: x (E, C, D), w (E, D, F), out (E, C, F), all contiguous.  The
// ragged C / F / D edges are masked in the kernel (zero-filled tiles, guarded
// stores), so no padded copy of either operand is made.
//
// What bounds it: bytes.  Every call streams each expert's weights once:
// 6.4 GB at jamba-1.5-large's (16, 80, 8192) @ (16, 8192, 24576), 1.95 ms at
// 3.35 TB/s, against 0.26 ms for its 258 GFLOP at the dense bf16 peak; 369
// MB per call at deepseek-moe-16b's shapes.  So a block must read its weight
// tile from device memory once, keep enough bytes in flight to cover the
// memory's latency (~32 KB per SM for 3.35 TB/s at ~1 us), and keep its
// products off the critical path.
//
// Three instances, chosen by dtype, shape and alignment only (the wrapper,
// kernels/moe_gmm.py, decides; a failed launch raises, nothing falls back):
//
// * gmm_mma (bf16, D and F multiples of 8, 16-byte aligned x and w): one
//   block per (expert, 256-column F tile, all C rows).  The rows are C
//   rounded up to 16, in MT 16-row tiles of mma.sync m16n8k16 (MT <= the
//   plan's cap, 8 by default and up to 10 when asked; a taller C splits into
//   row blocks of equal height), so each weight element crosses device
//   memory once per row block.  The F tile
//   is the fastest grid axis and the expert the slowest, so the blocks in
//   flight share one or two experts' x, re-read from L2.  x and w arrive in
//   64-deep stages of a 4-stage cp.async ring in dynamic shared memory (96
//   KB of weights in flight ahead of the tile being multiplied; 145-222 KB
//   a block, so one block per SM; rows padded by 16 bytes, so the 8 rows an
//   ldmatrix phase reads fall in distinct bank groups).  8 warps split the
//   F columns, 32 each, and every warp holds all MT row tiles: per 16-deep
//   step it reads its two B fragments by ldmatrix.trans (w's rows run along
//   F) and streams the MT A fragments by ldmatrix, each into 4 mmas, so a
//   C = 8 block runs one row tile of mma per warp.  The fragments are
//   fetched three ahead of their use (mma.cuh's pipelined), so no ldmatrix
//   latency sits between two mmas whatever ptxas schedules; row tiles wholly
//   past C (only in the last row block of a C > 128) are multiplied as
//   zeros, not skipped by a branch.  The products then cost ~2 % beyond the
//   stream itself (tools/k4_variants.py).  The epilogue runs on the f32
//   accumulator fragments and stores 2 x bf16, guarded on C and F.  The row
//   tiling is moe_gmm.tile_plan, passed in by the wrapper.
// * gmm_bf16_kernel (bf16 otherwise): one block per (expert, 64-row C tile,
//   128-column F tile); 32-deep tiles staged through registers into a
//   double buffer, one element per thread-load; WMMA 16x16x16 fragments
//   (8 warps, 32 x 32 outputs each), the epilogue from f32 shared memory.
// * gmm_f32_kernel (f32): the same blocking, 16-deep tiles, the products on
//   the CUDA cores in full f32 (4 x 8 outputs a thread), so f32 results
//   match an f32 reference; the f32 end-to-end gates rely on that.  Loads
//   move 16 bytes a thread where D and F are multiples of 4 and the bases
//   16-byte aligned, one element otherwise.
#include <mma.h>

#include <cstdint>
#include <type_traits>

#include "mma.cuh"

namespace {

constexpr int kBC = 64;         // rows (capacity slots) per block
constexpr int kBN = 128;        // output columns per block
constexpr int kThreads = 256;   // 8 warps
enum Epilogue : int { kNone = 0, kSilu = 1, kGelu = 2 };

template <int EPI>
__device__ __forceinline__ float epilogue(float a) {
  if constexpr (EPI == kSilu) {
    return a / (1.f + expf(-a));
  } else if constexpr (EPI == kGelu) {
    const float k = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * a * (1.f + tanhf(k * (a + 0.044715f * a * a * a)));
  } else {
    return a;
  }
}

// A ROWS x COLS tile of a row-major matrix (leading dimension ld), moved by
// the block's threads in chunks of V elements: 16 bytes (uint4) on the
// vector path, one element otherwise.  Elements outside the valid extent
// (rows_ok x cols_ok from the tile origin) read as zero; on the vector path
// D and F are multiples of V, so a chunk is wholly inside or outside.
template <typename T, int ROWS, int COLS, int V>
struct TileCopy {
  static constexpr int kPerRow = COLS / V;
  static constexpr int kChunks = ROWS * kPerRow / kThreads;
  static_assert(ROWS * kPerRow % kThreads == 0, "tile must split over the block");
  static_assert(V == 1 || V * sizeof(T) == 16, "chunks are one element or 16 bytes");
  using Chunk = std::conditional_t<V == 1, T, uint4>;
  Chunk r[kChunks];

  __device__ __forceinline__ void load(const T* g, int ld, int rows_ok, int cols_ok) {
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int row = idx / kPerRow, col = (idx % kPerRow) * V;
      const bool ok = row < rows_ok && col < cols_ok;
      const T* p = g + static_cast<size_t>(row) * ld + col;
      if constexpr (V == 1) {
        r[i] = ok ? *p : from_f32<T>(0.f);
      } else {
        r[i] = ok ? *reinterpret_cast<const uint4*>(p) : make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }

  __device__ __forceinline__ void store(T* s, int lds) const {
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int row = idx / kPerRow, col = (idx % kPerRow) * V;
      if constexpr (V == 1) {
        s[row * lds + col] = r[i];
      } else {
        *reinterpret_cast<uint4*>(s + row * lds + col) = r[i];
      }
    }
  }
};

// bf16 on the tensor cores (WMMA).
template <int EPI, int V>
__global__ void __launch_bounds__(kThreads)
gmm_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                __nv_bfloat16* __restrict__ o, int C, int D, int F) {
  using namespace nvcuda;
  using T = __nv_bfloat16;
  constexpr int BK = 32;
  constexpr int XLD = BK + 8;    // padded rows: 80 B, conflict-free fragment loads
  constexpr int WLD = kBN + 8;   // 272 B
  constexpr int OLD = kBN + 4;   // f32 accumulator rows for the epilogue
  constexpr int kStage = kBC * XLD + BK * WLD;  // elements of one x + w stage
  constexpr int kInBytes = 2 * kStage * static_cast<int>(sizeof(T));
  constexpr int kOutBytes = kBC * OLD * static_cast<int>(sizeof(float));
  __shared__ __align__(128) unsigned char smem[kInBytes > kOutBytes ? kInBytes : kOutBytes];
  T* stage = reinterpret_cast<T*>(smem);

  const int n0 = blockIdx.x * kBN, c0 = blockIdx.y * kBC, e = blockIdx.z;
  const T* xe = x + (static_cast<size_t>(e) * C + c0) * D;
  const T* we = w + static_cast<size_t>(e) * D * F + n0;
  const int warp = threadIdx.x / 32;
  const int wr = (warp / 4) * 32, wc = (warp % 4) * 32;  // the warp's 32 x 32 outputs
  const bool active = c0 + wr < C;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  TileCopy<T, kBC, BK, V> xt;
  TileCopy<T, BK, kBN, V> wt;
  const int nk = (D + BK - 1) / BK;
  xt.load(xe, D, C - c0, D);
  wt.load(we, F, D, F - n0);
  xt.store(stage, XLD);
  wt.store(stage + kBC * XLD, WLD);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const T* xs = stage + (kt & 1) * kStage;
    const T* ws = xs + kBC * XLD;
    const bool more = kt + 1 < nk;
    if (more) {
      const int k0 = (kt + 1) * BK;
      xt.load(xe + k0, D, C - c0, D - k0);
      wt.load(we + static_cast<size_t>(k0) * F, F, D - k0, F - n0);
    }
    if (active) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], xs + (wr + 16 * i) * XLD + kk, XLD);
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], ws + kk * WLD + wc + 16 * j, WLD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
    }
    if (more) {
      T* next = stage + ((kt + 1) & 1) * kStage;
      xt.store(next, XLD);
      wt.store(next + kBC * XLD, WLD);
    }
    __syncthreads();
  }

  // accumulators -> shared memory (over the staging buffers) -> epilogue
  float* os = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(os + (wr + 16 * i) * OLD + wc + 16 * j, acc[i][j], OLD,
                              wmma::mem_row_major);
  __syncthreads();
  const int rows = min(kBC, C - c0);
  for (int idx = threadIdx.x; idx < rows * kBN; idx += kThreads) {
    const int r = idx / kBN, n = idx % kBN;
    if (n0 + n < F)
      o[(static_cast<size_t>(e) * C + c0 + r) * F + n0 + n] =
          from_f32<T>(epilogue<EPI>(os[r * OLD + n]));
  }
}

// f32 on the CUDA cores.
template <int EPI, int V>
__global__ void __launch_bounds__(kThreads)
gmm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ o,
               int C, int D, int F) {
  constexpr int BK = 16;
  constexpr int XLD = BK + 4;    // 16-byte aligned rows; the two rows a warp reads differ in bank
  constexpr int WLD = kBN + 4;
  constexpr int kStage = kBC * XLD + BK * WLD;
  __shared__ __align__(16) float stage[2 * kStage];

  const int n0 = blockIdx.x * kBN, c0 = blockIdx.y * kBC, e = blockIdx.z;
  const float* xe = x + (static_cast<size_t>(e) * C + c0) * D;
  const float* we = w + static_cast<size_t>(e) * D * F + n0;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;  // rows 4*ty.., columns tx + 16*j

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  TileCopy<float, kBC, BK, V> xt;
  TileCopy<float, BK, kBN, V> wt;
  const int nk = (D + BK - 1) / BK;
  xt.load(xe, D, C - c0, D);
  wt.load(we, F, D, F - n0);
  xt.store(stage, XLD);
  wt.store(stage + kBC * XLD, WLD);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const float* xs = stage + (kt & 1) * kStage;
    const float* ws = xs + kBC * XLD;
    const bool more = kt + 1 < nk;
    if (more) {
      const int k0 = (kt + 1) * BK;
      xt.load(xe + k0, D, C - c0, D - k0);
      wt.load(we + static_cast<size_t>(k0) * F, F, D - k0, F - n0);
    }
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[(4 * ty + i) * XLD + k];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = ws[k * WLD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) {
      float* next = stage + ((kt + 1) & 1) * kStage;
      xt.store(next, XLD);
      wt.store(next + kBC * XLD, WLD);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = c0 + 4 * ty + i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tx + 16 * j;
      if (r < C && n < F) o[(static_cast<size_t>(e) * C + r) * F + n] = epilogue<EPI>(acc[i][j]);
    }
  }
}

// gmm_mma: bf16 on mma.sync, one block per (expert, F tile, all C rows).
constexpr int kMmaBN = 256;        // F columns per block
constexpr int kMmaWN = 32;         // F columns per warp: 2 B fragments, 4 n-tiles
constexpr int kMmaWarps = kMmaBN / kMmaWN;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaBK = 64;         // depth of one ring stage along D
constexpr int kMmaStages = 4;      // ring depth: tile k + 3 loads while tile k multiplies
constexpr int kXRow = kMmaBK + 8;  // bf16 per x row in shared memory (+16 bytes)
constexpr int kWRow = kMmaBN + 8;  // bf16 per w row in shared memory (+16 bytes)
constexpr int kMaxRowTiles = 10;   // 16-row mma tiles one block holds, at most
template <int MT> constexpr int kStageElems = 16 * MT * kXRow + kMmaBK * kWRow;
template <int MT> constexpr int kMmaSmemBytes = kMmaStages * kStageElems<MT> * 2;
static_assert(kMmaSmemBytes<kMaxRowTiles> <= 232448, "the ring must fit one block's 227 KB");

template <int MT, int EPI>
__global__ void __launch_bounds__(kMmaThreads)
gmm_mma(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
        __nv_bfloat16* __restrict__ o, int C, int D, int F) {
  using T = __nv_bfloat16;
  constexpr int kT = kMmaThreads, BN = kMmaBN, WN = kMmaWN, NQ = WN / 16;
  constexpr int ROWS = 16 * MT;
  constexpr int kStage = kStageElems<MT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);  // [kMmaStages][x: ROWS x kXRow | w: kMmaBK x kWRow]

  const int n0 = blockIdx.x * BN, c0 = blockIdx.y * ROWS, e = blockIdx.z;
  const int rows = min(ROWS, C - c0);
  const T* xe = x + (static_cast<size_t>(e) * C + c0) * D;
  const T* we = w + static_cast<size_t>(e) * D * F + n0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nk = (D + kMmaBK - 1) / kMmaBK;

  // tile kt of x (rows x 64) and w (64 x BN) into stage kt % kMmaStages; D
  // and F are multiples of 8, so a 16-byte chunk is wholly inside or
  // outside and the outside is zero-filled without a read
  auto load = [&](int kt) {
    T* xs = ring + (kt % kMmaStages) * kStage;
    T* ws = xs + ROWS * kXRow;
    const int k0 = kt * kMmaBK;
    constexpr int kXChunks = ROWS * (kMmaBK / 8), kWChunks = kMmaBK * (BN / 8);
#pragma unroll
    for (int j = 0; j < (kXChunks + kT - 1) / kT; ++j) {
      const int i = tid + j * kT;
      if (kXChunks % kT != 0 && i >= kXChunks) break;
      const int r = i / (kMmaBK / 8), c = (i % (kMmaBK / 8)) * 8;
      const bool ok = r < rows && k0 + c < D;
      cp_async16(smem_addr(xs + r * kXRow + c), ok ? xe + static_cast<size_t>(r) * D + k0 + c : x,
                 ok);
    }
#pragma unroll
    for (int j = 0; j < kWChunks / kT; ++j) {  // 8 a thread
      const int i = tid + j * kT;
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      const bool ok = k0 + r < D && n0 + c < F;
      cp_async16(smem_addr(ws + r * kWRow + c), ok ? we + static_cast<size_t>(k0 + r) * F + c : w,
                 ok);
    }
  };

  float acc[MT][2 * NQ][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 2 * NQ; ++j) acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;

#pragma unroll
  for (int kt = 0; kt < kMmaStages - 1; ++kt) {
    if (kt < nk) load(kt);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kMmaStages - 2>();  // tile kt has landed (this thread's copies)
    __syncthreads();                  // ... and every thread's; all are done with tile kt - 1
    if (kt + kMmaStages - 1 < nk) load(kt + kMmaStages - 1);  // into tile kt - 1's stage
    cp_async_commit();
    const T* xs = ring + (kt % kMmaStages) * kStage;
    const T* ws = xs + ROWS * kXRow;
    // per 16-deep step: the warp's NQ B fragments (w rows kk .. kk + 15,
    // columns WN warp + 16 q .. + 15, by ldmatrix.trans), then the MT A
    // fragments (x rows 16 mt .. + 15), each A fragment into 2 NQ mmas.
    // Fragments are fetched kFetch - 1 ahead of their use (mma.cuh).
    constexpr int kPer = NQ + MT;
    uint32_t b[NQ][4];
    pipelined<(kMmaBK / 16) * kPer>(
        [&](int i, uint32_t (&r)[4]) {
          const int kk = (i / kPer) * 16, f = i % kPer;
          if (f < NQ)
            ldmatrix_x4_trans(r, smem_addr(ws + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kWRow +
                                           warp * WN + f * 16 + (lane >> 4) * 8));
          else
            ldmatrix_x4(r, smem_addr(xs + ((f - NQ) * 16 + (lane & 15)) * kXRow + kk +
                                     (lane >> 4) * 8));
        },
        [&](int i, const uint32_t (&r)[4]) {
          const int f = i % kPer;
          if (f < NQ) {
#pragma unroll
            for (int e = 0; e < 4; ++e) b[f][e] = r[e];
          } else {
#pragma unroll
            for (int q = 0; q < NQ; ++q) {
              mma_bf16(acc[f - NQ][2 * q], r, b[q][0], b[q][1]);
              mma_bf16(acc[f - NQ][2 * q + 1], r, b[q][2], b[q][3]);
            }
          }
        });
  }

  // c0, c1 = (row gr, columns 2 tq, +1), c2, c3 = (row gr + 8, the same)
  const int gr = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mt * 16 + gr + 8 * h;
      if (r >= rows) continue;
      T* orow = o + (static_cast<size_t>(e) * C + c0 + r) * F;
#pragma unroll
      for (int j = 0; j < 2 * NQ; ++j) {
        const int n = n0 + warp * WN + j * 8 + 2 * tq;  // even, and F % 8 == 0: n + 1 < F too
        if (n < F)
          *reinterpret_cast<__nv_bfloat162*>(orow + n) = __floats2bfloat162_rn(
              epilogue<EPI>(acc[mt][j][2 * h]), epilogue<EPI>(acc[mt][j][2 * h + 1]));
      }
    }
}

template <int MT, int EPI>
cudaError_t launch_mma(const void* x, const void* w, void* o, int E, int C, int D, int F,
                       int row_blocks, cudaStream_t st) {
  constexpr int smem = kMmaSmemBytes<MT>;
  const cudaError_t attr = allow_smem<gmm_mma<MT, EPI>>(smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((F + kMmaBN - 1) / kMmaBN, row_blocks, E);
  gmm_mma<MT, EPI><<<grid, kMmaThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(o), C, D, F);
  return cudaGetLastError();
}

template <int MT>
cudaError_t launch_mma_e(int epi, const void* x, const void* w, void* o, int E, int C, int D,
                         int F, int row_blocks, cudaStream_t st) {
  switch (epi) {
    case kNone: return launch_mma<MT, kNone>(x, w, o, E, C, D, F, row_blocks, st);
    case kSilu: return launch_mma<MT, kSilu>(x, w, o, E, C, D, F, row_blocks, st);
    case kGelu: return launch_mma<MT, kGelu>(x, w, o, E, C, D, F, row_blocks, st);
    default: return cudaErrorInvalidValue;
  }
}

// gmm_bf16_kernel / gmm_f32_kernel
template <typename T, int EPI, int V>
cudaError_t launch(const void* x, const void* w, void* o, int E, int C, int D, int F,
                   cudaStream_t st) {
  const dim3 grid((F + kBN - 1) / kBN, (C + kBC - 1) / kBC, E);
  if constexpr (std::is_same_v<T, float>) {
    gmm_f32_kernel<EPI, V><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(o), C, D, F);
  } else {
    gmm_bf16_kernel<EPI, V><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(o), C, D, F);
  }
  return cudaGetLastError();
}

template <typename T, int EPI>
cudaError_t launch_v(const void* x, const void* w, void* o, int E, int C, int D, int F,
                     cudaStream_t st) {
  if constexpr (std::is_same_v<T, float>) {
    constexpr int V = 16 / sizeof(T);
    const bool aligned =
        (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16 == 0;
    if (aligned && D % V == 0 && F % V == 0) return launch<T, EPI, V>(x, w, o, E, C, D, F, st);
  }
  // bf16 with 16-byte rows and bases takes gmm_mma, so bf16 here moves one
  // element a thread-load
  return launch<T, EPI, 1>(x, w, o, E, C, D, F, st);
}

template <typename T>
cudaError_t launch_e(int epi, const void* x, const void* w, void* o, int E, int C, int D, int F,
                     cudaStream_t st) {
  switch (epi) {
    case kNone: return launch_v<T, kNone>(x, w, o, E, C, D, F, st);
    case kSilu: return launch_v<T, kSilu>(x, w, o, E, C, D, F, st);
    case kGelu: return launch_v<T, kGelu>(x, w, o, E, C, D, F, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// gmm_bf16_kernel (bf16) or gmm_f32_kernel (f32).  epilogue: 0 none, 1 silu,
// 2 gelu (tanh form).  E, C, F >= 1.
extern "C" int moe_gmm_fwd(const void* x, const void* w, void* o, int dtype, int epilogue,
                           int E, int C, int D, int F, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E < 1 || C < 1 || D < 0 || F < 1 || E > 65535 || (C + kBC - 1) / kBC > 65535)
    return cudaErrorInvalidValue;
  switch (dtype) {
    case kF32: return launch_e<float>(epilogue, x, w, o, E, C, D, F, st);
    case kBF16: return launch_e<__nv_bfloat16>(epilogue, x, w, o, E, C, D, F, st);
    default: return cudaErrorInvalidValue;
  }
}

// gmm_mma (bf16): the row tiling of moe_gmm.tile_plan.  Row block b covers
// rows [16 row_tiles b, 16 row_tiles (b + 1)) of C, so the row blocks must
// cover C with the last one non-empty.  D and F multiples of 8, x, w and
// out 16-byte aligned; anything else is refused.
extern "C" int moe_gmm_mma_fwd(const void* x, const void* w, void* o, int epilogue, int E,
                               int C, int D, int F, int row_tiles, int row_blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = 16 * row_tiles;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                        reinterpret_cast<uintptr_t>(o)) % 16 == 0;
  if (E < 1 || C < 1 || D < 0 || F < 1 || E > 65535 || D % 8 != 0 || F % 8 != 0 || !aligned ||
      row_tiles < 1 || row_tiles > kMaxRowTiles || row_blocks < 1 || row_blocks > 65535 ||
      (row_blocks - 1) * rows >= C || row_blocks * rows < C)
    return cudaErrorInvalidValue;
  switch (row_tiles) {
#define REPRO_GMM_MT(MT) \
    case MT: return launch_mma_e<MT>(epilogue, x, w, o, E, C, D, F, row_blocks, st);
    REPRO_GMM_MT(1) REPRO_GMM_MT(2) REPRO_GMM_MT(3) REPRO_GMM_MT(4)
    REPRO_GMM_MT(5) REPRO_GMM_MT(6) REPRO_GMM_MT(7) REPRO_GMM_MT(8)
    REPRO_GMM_MT(9) REPRO_GMM_MT(10)
#undef REPRO_GMM_MT
    default: return cudaErrorInvalidValue;
  }
}
