// Grouped expert matmul for Hopper (sm_90a): (E, C, D) @ (E, D, F) -> (E, C, F)
// with f32 accumulation and an optional fused epilogue (silu, or gelu in its
// tanh form) on the f32 accumulator before one rounding to x's dtype.
//
// Replaces the Pallas TPU kernel repro/kernels/moe_gmm.py (gmm, _gmm_kernel).
// There the grid is (E, C/bc, F/bf, D/bd) with the contraction innermost and
// a VMEM accumulator carried across the sequential D sweep; here one thread
// block owns (expert, 64-row C tile, 128-column F tile) and walks D in a loop
// inside the block, its accumulator in registers.
//
// Layout: x (E, C, D), w (E, D, F), out (E, C, F), all contiguous.  The
// ragged C / F / D edges are masked in the kernel (zero-filled tiles, guarded
// stores), so no padded copy of either operand is made.
//
// Tiles are staged in shared memory along D, double-buffered through
// registers: the next tile's global loads are in flight while the block
// multiplies the current one.  Loads move 16 bytes a thread where the rows
// allow it (D and F multiples of 16 bytes, 16-byte aligned bases), one element
// otherwise.
//   bf16: 32-deep tiles; the products run on the tensor cores through WMMA
//         16x16x16 bf16 fragments with f32 accumulators (8 warps, 32 x 32
//         outputs each); a warp whose rows all lie past C skips its products.
//   f32:  16-deep tiles; the products run on the CUDA cores in full f32
//         (4 x 8 outputs a thread), so f32 results match an f32 reference.
//
// What bounds it: at deepseek-moe-16b's serving shapes (E = 64, D = 2048,
// F = 1408, and the w2 product 1408 -> 2048) each call streams every
// expert's weights once, ~369 MB in bf16.  At 3.35 TB/s that is ~0.119 ms
// for a prefill call (C = 64, 397 MB with x and out) and ~0.111 ms for a
// decode call (C = 8); the products (23.6 GFLOP at C = 64) take ~0.024 ms at
// 989 TFLOP/s.  So bytes bound it.  A C tile as tall as the capacity
// (C <= 64 at both shapes) makes each block read its weight tile exactly
// once, so the weights cross from device memory once per call; x, 16.8 MB
// at prefill, is re-read by each of the 11 (or 16) F tiles from L2.
#include <mma.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

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
  constexpr int V = 16 / sizeof(T);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16 == 0;
  if (aligned && D % V == 0 && F % V == 0) return launch<T, EPI, V>(x, w, o, E, C, D, F, st);
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

// epilogue: 0 none, 1 silu, 2 gelu (tanh form).  E, C, F >= 1.
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
