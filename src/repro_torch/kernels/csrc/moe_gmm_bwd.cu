// K4b: the backward of the grouped expert matmul's gated FFN for Hopper
// (sm_90a).  The forward (csrc/moe_gmm.cu, the route of ops.moe_ffn) is
//
//   g = act(x w1) (on the f32 accumulator), a3 = x w3, h = g * a3,
//   y = h w2,    x (E, C, D), w1 / w3 (E, D, F), w2 (E, F, D), per expert
//
// and its backward for dy (E, C, D) is three kernels, after one K4 launch
// that recomputes the pre-activation a1 = x w1 (rounded; the forward saves
// x, a3 and h, and writes nothing serving does not):
//
// * (a), the gated dgrad: dh = dy w2^T (E, C, F), reading w2 (E, F, D) in
//   place as the transposed operand; its epilogue reads a1 and a3 and
//   writes da1 = dh a3 act'(a1) and da3 = dh act(a1), computed in f32
//   from the f32 accumulator and rounded once each (dh itself is never
//   rounded).  silu and the tanh gelu, K4's two epilogues.
// * (b), the dgrad: dx = da1 w1^T + da3 w3^T (E, C, D): both products
//   summed in one f32 accumulator (the second pair's k-tiles follow the
//   first's in the same loop), rounded once.  Also the x-gradient of a
//   bare grouped matmul (one pair).
// * (c), the wgrad: dw = a^T b per expert, a (E, C, P), b (E, C, Q) -> (E,
//   P, Q), contracting over the capacity rows: dw1 = x^T da1, dw3 = x^T
//   da3, dw2 = h^T dy.
//
// Replaces no Pallas kernel: the JAX package differentiates
// repro/kernels/ops.py::moe_ffn (repro/kernels/moe_gmm.py::gmm, the TPU
// kernel K4) with jax.grad through ref.gmm_ref / ref.moe_ffn_ref, which XLA
// lowers to its own matmuls.  On the card these are hand-written kernels.
//
// What bounds them: bytes for (a), operations for (b) and (c).  At
// deepseek-moe-16b's training shape, (64, 960, 2048) with F 1408 per MoE
// layer, (a) moves 1.31 GB for 354 GFLOP (0.392 ms by bytes, just under
// the card's ~295 FLOP a byte), (b) 709 GFLOP (0.717 ms) and each (c) 354
// GFLOP (0.358 ms), well above it.  So the bf16 products
// must run at the tensor cores' rate, and (a)'s epilogue traffic (a1 and
// a3 read, da1 and da3 written: 692 MB there) must overlap them.  The bf16
// instances on aligned operands are two kernels built for that, on wgmma
// fed by TMA, warp-specialised and persistent (their section below):
//
// * gmm_dgrad_sm90<EPI>: (a) and (b), both operands K-major (K
//   contiguous); EPI the gated silu / gelu epilogue of (a), whose a1 and a3
//   arrive by TMA while the tile's products run and whose da1 and da3
//   leave by TMA store, or the plain store of (b).
// * gmm_wgrad_sm90: (c), both operands MN-major (P or Q contiguous), read
//   by wgmma through its transpose bits.
//
// The first design of all three, kept for the other instances and for
// timing, is the plain tensor-core GEMM: one block per (expert, 128 x 128
// output tile), 8 warps of 64 x 32 outputs on mma.sync m16n8k16 with f32
// accumulators, 32-deep stages of both operands through a 4-stage
// cp.async ring in dynamic shared memory (80 KB, two blocks an SM), rows
// padded by 16 bytes so an ldmatrix phase reads distinct bank groups, the
// output written an element at a time from the fragments.
//
// Instances, chosen by dtype, shape and alignment only (the wrapper,
// kernels/moe_gmm.py, mirrors the choice in bwd_instance; a failed launch
// raises, nothing falls back):
//
// * bf16, D and F multiples of 8 and every operand 16-byte aligned (what
//   TMA asks of a tensor map: 16-byte strides and base): the wgmma kernels.
// * bf16 otherwise (a ragged D or F, or a view off 16 bytes): the first
//   design's tiles and mma.sync, each element loaded on its own.
// * f32: the same 128 x 128 tiles on the CUDA cores in full f32 (8 x 8
//   outputs a thread, 8-deep stages staged through registers), so the f32
//   gates hold the port to f32 rounding.
//
// The first design's bf16 cp.async instances (VEC) stay reachable through
// the *_v1 entry points, for timing beside the wgmma kernels only
// (moe_gmm.previous_bwd).  Ragged C / D / F edges are zero-filled on load
// and dropped on store (by the tensor maps, or by masks in the other
// instances); no padded copy is made.  A launch allocates nothing and runs
// on the caller's stream, so a CUDA graph can capture it.
#include <climits>
#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;      // output rows a block
constexpr int kBN = 128;      // output columns a block
constexpr int kBK = 32;       // depth of one ring stage (bf16)
constexpr int kStages = 4;    // ring depth: tile t + 3 loads while tile t multiplies
constexpr int kThreads = 256; // 8 warps: 2 along M x 4 along N, 64 x 32 outputs each
// f32 accumulators a thread, in both paths: mma.sync's 4 x 4 tiles of 4, or
// the CUDA cores' 8 x 8 outputs (element idx at [idx / 4][idx % 4])
using Acc = float[16][4];
enum Act : int { kSilu = 1, kGelu = 2 };  // moe_gmm.EPILOGUE_CODES

// out (M x N) = sum over pairs of A (M x K) B (K x N), per expert.  An
// operand stored "k-major" holds K as its rows (element (i, k) at k ld +
// i), otherwise K is contiguous (element (i, k) at i ld + k), i its M or N
// index.
template <typename T>
struct Gemm {
  const T* a0;
  const T* a1;       // the second pair (pairs == 2)
  const T* b0;
  const T* b1;
  long long sa, sb;  // elements between experts of A and of B
  int lda, ldb;
  int M, N, K;
  int pairs;
};

// The shared-memory tile of one operand: k-major [kBK][ROWS + 8] or
// [ROWS][kBK + 8], padded by 16 bytes a row.
template <bool KMAJOR, int ROWS>
struct Tile {
  static constexpr int kLd = KMAJOR ? ROWS + 8 : kBK + 8;
  static constexpr int kElems = KMAJOR ? kBK * kLd : ROWS * kLd;
  static constexpr int kOuter = KMAJOR ? kBK : ROWS;  // rows in shared memory
  static constexpr int kInner = KMAJOR ? ROWS : kBK;  // contiguous in both memories
};

// rows i0 .. i0 + ROWS and depth k0 .. k0 + kBK of an operand into its
// shared tile; elements past (I, K) read as zero.  VEC: 16-byte cp.async
// chunks (K, or I for a k-major operand, and ld multiples of 8, so a chunk
// is wholly inside or outside); otherwise one element a thread-load.
template <bool KMAJOR, int ROWS, bool VEC>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* p, int ld, int i0, int I, int k0,
                                          int K) {
  using S = Tile<KMAJOR, ROWS>;
  if constexpr (VEC) {
    constexpr int kPer = S::kInner / 8, kChunks = S::kOuter * kPer;
    static_assert(kChunks % kThreads == 0, "the tile must split over the block");
#pragma unroll
    for (int j = 0; j < kChunks / kThreads; ++j) {
      const int idx = threadIdx.x + j * kThreads;
      const int r = idx / kPer, c = (idx % kPer) * 8;
      const int i = i0 + (KMAJOR ? c : r), k = k0 + (KMAJOR ? r : c);
      const bool ok = i < I && k < K;
      const bf16* src = KMAJOR ? p + static_cast<size_t>(k) * ld + i
                               : p + static_cast<size_t>(i) * ld + k;
      cp_async16(smem_addr(s + r * S::kLd + c), ok ? src : p, ok);
    }
  } else {
    constexpr int kN = S::kOuter * S::kInner;
#pragma unroll 4
    for (int idx = threadIdx.x; idx < kN; idx += kThreads) {
      const int r = idx / S::kInner, c = idx % S::kInner;
      const int i = i0 + (KMAJOR ? c : r), k = k0 + (KMAJOR ? r : c);
      s[r * S::kLd + c] = (i < I && k < K) ? p[KMAJOR ? static_cast<size_t>(k) * ld + i
                                                      : static_cast<size_t>(i) * ld + k]
                                           : __float2bfloat16(0.f);
    }
  }
}

// two bf16 blocks an SM (128 registers a thread); the f32 instances, for the
// gates only, take one and the registers their 8 x 8 tiles need
template <typename T>
constexpr int kBlocksPerSm = std::is_same_v<T, bf16> ? 2 : 1;

template <bool AK, bool BK>
constexpr int kMmaStage = Tile<AK, kBM>::kElems + Tile<BK, kBN>::kElems;
template <bool AK, bool BK>
constexpr int kMmaSmem = kStages * kMmaStage<AK, BK> * 2;
static_assert(2 * kMmaSmem<false, false> <= 232448, "two blocks must fit an SM");

// bf16 on mma.sync: the block's output tile (m0, n0) of expert e into acc,
// element idx = (4 i + j) 4 + c at row wm + 16 i + gr + 8 (c / 2), column
// wn + 8 j + 2 tq + c % 2 of the tile (mma_coord).
template <bool AK, bool BK, bool VEC>
__device__ __forceinline__ void mma_tile(const Gemm<bf16>& g, int e, int m0, int n0,
                                         Acc& acc, bf16* ring) {
  using TA = Tile<AK, kBM>;
  using TB = Tile<BK, kBN>;
  constexpr int kStage = kMmaStage<AK, BK>;
  const int nk = (g.K + kBK - 1) / kBK, total = nk * g.pairs;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;

  // k-tile t: pair t / nk, depth (t % nk) kBK
  auto load = [&](int t) {
    bf16* as = ring + (t % kStages) * kStage;
    const bool second = t >= nk;
    const int k0 = (second ? t - nk : t) * kBK;
    load_tile<AK, kBM, VEC>(as, (second ? g.a1 : g.a0) + e * g.sa, g.lda, m0, g.M, k0, g.K);
    load_tile<BK, kBN, VEC>(as + TA::kElems, (second ? g.b1 : g.b0) + e * g.sb, g.ldb, n0, g.N,
                            k0, g.K);
  };

#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < total) load(t);
    cp_async_commit();
  }
  for (int t = 0; t < total; ++t) {
    cp_async_wait<kStages - 2>();  // tile t has landed (this thread's copies)
    __syncthreads();               // ... and every thread's; all are done with tile t - 1
    if (t + kStages - 1 < total) load(t + kStages - 1);  // into tile t - 1's stage
    cp_async_commit();
    const bf16* as = ring + (t % kStages) * kStage;
    const bf16* bs = as + TA::kElems;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      // A fragments of the warp's 4 row tiles; B fragments of its 4 column
      // tiles, two an ldmatrix.x4: (b[q][0], b[q][1]) for column tile 2 q,
      // (b[q][2], b[q][3]) for 2 q + 1
      uint32_t a[4][4], b[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = wm + 16 * i;
        if constexpr (AK)
          ldmatrix_x4_trans(a[i], smem_addr(as + (kk + (lane & 7) + (lane >> 4) * 8) * TA::kLd +
                                            m + ((lane >> 3) & 1) * 8));
        else
          ldmatrix_x4(a[i], smem_addr(as + (m + (lane & 15)) * TA::kLd + kk + (lane >> 4) * 8));
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int n = wn + 16 * q;
        if constexpr (BK)
          ldmatrix_x4_trans(b[q], smem_addr(bs + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                                     TB::kLd + n + (lane >> 4) * 8));
        else
          ldmatrix_x4(b[q], smem_addr(bs + (n + (lane & 7) + (lane >> 4) * 8) * TB::kLd + kk +
                                      ((lane >> 3) & 1) * 8));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[4 * i + j], a[i], b[j / 2][2 * (j % 2)], b[j / 2][2 * (j % 2) + 1]);
    }
  }
  cp_async_wait<0>();
}

__device__ __forceinline__ void mma_coord(int idx, int& r, int& c) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i = idx / 16, j = (idx / 4) % 4, q = idx % 4;
  r = (warp / 4) * 64 + 16 * i + (lane >> 2) + 8 * (q >> 1);
  c = (warp % 4) * 32 + 8 * j + 2 * (lane & 3) + (q & 1);
}

// f32 on the CUDA cores: the same output tile, thread (ty, tx) = (tid / 16,
// tid % 16) holding rows ty + 16 i and columns tx + 16 j (i, j < 8; element
// idx = 8 i + j, simt_coord), 8-deep tiles of both operands k-major in
// shared memory, the next tile staged through registers.
constexpr int kSimtBK = 8;
constexpr int kSimtLd = kBM + 4;

template <bool KMAJOR>
__device__ __forceinline__ void simt_fetch(float (&r)[4], const float* p, int ld, int i0, int I,
                                           int k0, int K) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {  // 128 x 8 elements, 4 a thread, the contiguous dim fastest
    const int idx = threadIdx.x + j * kThreads;
    const int i = i0 + (KMAJOR ? idx % kBM : idx / kSimtBK);
    const int k = k0 + (KMAJOR ? idx / kBM : idx % kSimtBK);
    r[j] = (i < I && k < K) ? p[KMAJOR ? static_cast<size_t>(k) * ld + i
                                       : static_cast<size_t>(i) * ld + k]
                            : 0.f;
  }
}

template <bool KMAJOR>
__device__ __forceinline__ void simt_stash(const float (&r)[4], float* s) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int idx = threadIdx.x + j * kThreads;
    const int i = KMAJOR ? idx % kBM : idx / kSimtBK, k = KMAJOR ? idx / kBM : idx % kSimtBK;
    s[k * kSimtLd + i] = r[j];
  }
}

template <bool AK, bool BK>
__device__ __forceinline__ void simt_tile(const Gemm<float>& g, int e, int m0, int n0,
                                          Acc& acc) {
  __shared__ __align__(16) float sa[2][kSimtBK * kSimtLd];
  __shared__ __align__(16) float sb[2][kSimtBK * kSimtLd];
  const int nk = (g.K + kSimtBK - 1) / kSimtBK, total = nk * g.pairs;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float ra[4], rb[4];
  auto fetch = [&](int t) {
    const bool second = t >= nk;
    const int k0 = (second ? t - nk : t) * kSimtBK;
    simt_fetch<AK>(ra, (second ? g.a1 : g.a0) + e * g.sa, g.lda, m0, g.M, k0, g.K);
    simt_fetch<BK>(rb, (second ? g.b1 : g.b0) + e * g.sb, g.ldb, n0, g.N, k0, g.K);
  };
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  fetch(0);
  simt_stash<AK>(ra, sa[0]);
  simt_stash<BK>(rb, sb[0]);
  __syncthreads();
  for (int t = 0; t < total; ++t) {
    const int buf = t & 1;
    const bool more = t + 1 < total;
    if (more) fetch(t + 1);
#pragma unroll
    for (int k = 0; k < kSimtBK; ++k) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = sa[buf][k * kSimtLd + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = sb[buf][k * kSimtLd + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float& c = acc[2 * i + j / 4][j % 4];
          c = fmaf(a[i], b[j], c);
        }
    }
    if (more) {
      simt_stash<AK>(ra, sa[buf ^ 1]);
      simt_stash<BK>(rb, sb[buf ^ 1]);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void simt_coord(int idx, int& r, int& c) {
  r = threadIdx.x / 16 + 16 * (idx / 8);
  c = threadIdx.x % 16 + 16 * (idx % 8);
}

// The block's accumulators for output tile (blockIdx.y, blockIdx.x) of
// expert blockIdx.z, through the instance of T and VEC.
template <typename T, bool AK, bool BK, bool VEC>
__device__ __forceinline__ void block_tile(const Gemm<T>& g, Acc& acc) {
  const int e = blockIdx.z, m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  if constexpr (std::is_same_v<T, bf16>) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    mma_tile<AK, BK, VEC>(g, e, m0, n0, acc, reinterpret_cast<bf16*>(smem_raw));
  } else {
    simt_tile<AK, BK>(g, e, m0, n0, acc);
  }
}

// Calls f(offset of (row, column) in the (E, M, N) output, accumulator) for
// each of the thread's accumulators inside the output.
template <typename T, typename Fn>
__device__ __forceinline__ void each_output(const Gemm<T>& g, const Acc& acc, Fn f) {
  const int e = blockIdx.z, m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
#pragma unroll
  for (int idx = 0; idx < 64; ++idx) {
    int r, c;
    if constexpr (std::is_same_v<T, bf16>)
      mma_coord(idx, r, c);
    else
      simt_coord(idx, r, c);
    const int m = m0 + r, n = n0 + c;
    if (m < g.M && n < g.N)
      f((static_cast<size_t>(e) * g.M + m) * g.N + n, acc[idx / 4][idx % 4]);
  }
}

template <int ACT>
__device__ __forceinline__ void act_and_grad(float a, float& y, float& dy) {
  if constexpr (ACT == kSilu) {
    const float s = 1.f / (1.f + expf(-a));
    y = a * s;
    dy = s * (1.f + a * (1.f - s));
  } else {
    const float k = 0.7978845608028654f, c = 0.044715f;  // sqrt(2 / pi)
    const float t = tanhf(k * (a + c * a * a * a));
    y = 0.5f * a * (1.f + t);
    dy = 0.5f * (1.f + t) + 0.5f * a * (1.f - t * t) * k * (1.f + 3.f * c * a * a);
  }
}

// (a): dh = dy w2^T, da1 = dh a3 act'(a1), da3 = dh act(a1)
template <typename T, int ACT, bool VEC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm<T>)
gmm_dgrad_gated(Gemm<T> g, const T* __restrict__ a1, const T* __restrict__ a3,
                T* __restrict__ da1, T* __restrict__ da3) {
  Acc acc;
  block_tile<T, false, false, VEC>(g, acc);
  each_output(g, acc, [&](size_t at, float dh) {
    float y, dy;
    act_and_grad<ACT>(to_f32(a1[at]), y, dy);
    da1[at] = from_f32<T>(dh * to_f32(a3[at]) * dy);
    da3[at] = from_f32<T>(dh * y);
  });
}

// (b): dx = da1 w1^T (+ da3 w3^T)
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm<T>)
gmm_dgrad(Gemm<T> g, T* __restrict__ out) {
  Acc acc;
  block_tile<T, false, false, VEC>(g, acc);
  each_output(g, acc, [&](size_t at, float v) { out[at] = from_f32<T>(v); });
}

// (c): dw = a^T b
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm<T>)
gmm_wgrad(Gemm<T> g, T* __restrict__ out) {
  Acc acc;
  block_tile<T, true, true, VEC>(g, acc);
  each_output(g, acc, [&](size_t at, float v) { out[at] = from_f32<T>(v); });
}

template <typename T>
dim3 grid_of(const Gemm<T>& g, int E) {
  return dim3((g.N + kBN - 1) / kBN, (g.M + kBM - 1) / kBM, E);
}

// Launches kernel K with the dynamic shared memory its instance needs
template <typename T, bool AK, bool BK, auto K, typename... Args>
cudaError_t launch(const Gemm<T>& g, int E, cudaStream_t st, Args... args) {
  int smem = 0;
  if constexpr (std::is_same_v<T, bf16>) {
    smem = kMmaSmem<AK, BK>;
    const cudaError_t attr = allow_smem<K>(smem);
    if (attr != cudaSuccess) return attr;
  }
  K<<<grid_of(g, E), kThreads, smem, st>>>(g, args...);
  return cudaGetLastError();
}

template <typename T, int ACT>
cudaError_t launch_gated(const Gemm<T>& g, bool vec, int E, cudaStream_t st, const T* a1,
                         const T* a3, T* da1, T* da3) {
  if constexpr (std::is_same_v<T, bf16>) {
    if (vec)
      return launch<T, false, false, gmm_dgrad_gated<T, ACT, true>>(g, E, st, a1, a3, da1, da3);
  }
  return launch<T, false, false, gmm_dgrad_gated<T, ACT, false>>(g, E, st, a1, a3, da1, da3);
}

template <typename T>
cudaError_t launch_dgrad(const Gemm<T>& g, bool vec, int E, cudaStream_t st, T* out) {
  if constexpr (std::is_same_v<T, bf16>) {
    if (vec) return launch<T, false, false, gmm_dgrad<T, true>>(g, E, st, out);
  }
  return launch<T, false, false, gmm_dgrad<T, false>>(g, E, st, out);
}

template <typename T>
cudaError_t launch_wgrad(const Gemm<T>& g, bool vec, int E, cudaStream_t st, T* out) {
  if constexpr (std::is_same_v<T, bf16>) {
    if (vec) return launch<T, true, true, gmm_wgrad<T, true>>(g, E, st, out);
  }
  return launch<T, true, true, gmm_wgrad<T, false>>(g, E, st, out);
}

// Calls f(TypeTag<T>) for the element type T of dtype
template <typename Fn>
cudaError_t with_dtype(int dtype, Fn f) {
  switch (dtype) {
    case kF32: return f(TypeTag<float>{});
    case kBF16: return f(TypeTag<bf16>{});
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(std::initializer_list<const void*> ps) {
  for (const void* p : ps)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

bool shape_ok(int E, int C, int D, int F) {
  return E >= 1 && C >= 1 && D >= 1 && F >= 1 && E <= 65535 && (C + kBM - 1) / kBM <= 65535 &&
         (D + kBM - 1) / kBM <= 65535;
}

// ---------------------------------------------------------------------------
// bf16 on aligned operands: gmm_dgrad_sm90<EPI> and gmm_wgrad_sm90
// ---------------------------------------------------------------------------
//
// Both compute out = A B^T per expert in output tiles of 64 WG x 128 (A's
// rows the output's rows, B's rows its columns, contracted over K), K in
// 64-deep k-tiles (64 bf16: one 128-byte swizzle row):
//
// * A persistent grid of one block an SM walks the tiles in a fixed order,
//   block b taking tiles b, b + grid, ...: tile t is column tile t % nN of
//   row tile (t / nN) % nM of expert t / (nN nM), so the blocks in flight
//   share A's row blocks and the expert's B in L2 (plan.py's bwd_walk
//   mirrors it).
// * WG + 1 warpgroups.  One thread of the last, the producer, issues every
//   TMA load into a ring of stages, each guarded by a full and an empty
//   mbarrier, and runs into the next tile's k-tiles while the consumers
//   finish the current one.  The others, the consumers, own 64 rows of the
//   tile each and run wgmma.mma_async m64n128k16 (bf16 -> f32) on the
//   ring's stages, one k-tile's products in flight while they wait for the
//   next.  setmaxnreg gives the producer's registers to the consumers; as
//   in K1b, the host side refuses a build whose kernels ptxas gave another
//   entry count than the exchange assumes.
// * Operands arrive through 3-d tensor maps over (E, rows, columns), so
//   that no box straddles two experts, whose bounds zero-fill the ragged
//   C / N / K edges.  dgrad: A (E, C, K) and B (E, N, K) as K-major boxes
//   of 64 WG and of 128 rows x 64.  wgrad: a (E, C, P) and b (E, C, Q) as
//   MN-major panels of 64 capacity rows x 64 columns, WG and two a stage,
//   which wgmma reads through its transpose bits; B's descriptor spans its
//   two panels with LBO the panel stride (8 KB).
// * The epilogue: a consumer writes its 64 x 128 outputs in bf16 into a
//   staging buffer in the 128-byte swizzle (4-byte accesses that meet no
//   bank conflict), and one of its threads stores them by TMA (dropped
//   past the tensor's bounds), waiting for the stores' reads of the buffer
//   only when it is needed again.  The gated epilogue of (a): the producer
//   loads a tile's a1 and a3 into the staging buffer by TMA while the
//   tile's products run, one 8 KB box after each k-tile's loads, as soon
//   as the previous tile's stores have read it (which the consumers report
//   during the next tile's first k-tile);
//   the consumers compute da1 and da3 in f32 from the accumulator and a1,
//   a3 (act_and_grad), write them over a1 and a3, and store both.
// * Three consumers a block: 192-row tiles, so C 960 is five row tiles.
//   The gated instances hold a1 and a3 of a tile beside the ring, so their
//   ring has one stage fewer.
// * No split-K and no atomics: each output is one block's sum in a fixed
//   order, so equal inputs give equal bytes.

#ifndef K4B_GATED_WG
#define K4B_GATED_WG 3
#endif
#ifndef K4B_GATED_STAGES
#define K4B_GATED_STAGES 3
#endif
#ifndef K4B_STORE_WG
#define K4B_STORE_WG 3
#endif
#ifndef K4B_STORE_STAGES
#define K4B_STORE_STAGES 4
#endif

constexpr int kTN = 128;                  // output columns of a tile (m64n128k16)
constexpr int kTK = 64;                   // depth of a k-tile
constexpr int kPanels = kTN / 64;         // 64-column panels of a tile
constexpr int kPanel = 64 * 64;           // a 64 x 64 bf16 panel, 8 KB
constexpr uint32_t kPanelBytes = kPanel * 2;
enum Epi : int { kStore = 0 };            // else an Act: (a)'s gated epilogue

// An instance's design: consumer warpgroups (64 output rows each) and ring
// stages; setmaxnreg's counts (the block holds (WG + 1) x 128 threads x
// its entry registers, the register file over its threads in steps of 8,
// all of which the producer's 40 and the consumers' share add up to)
template <int EPI>
struct Design {
  static constexpr int kWG = EPI == kStore ? K4B_STORE_WG : K4B_GATED_WG;
  static constexpr int kStages = EPI == kStore ? K4B_STORE_STAGES : K4B_GATED_STAGES;
  static constexpr int kTM = 64 * kWG;  // output rows of a tile
  static constexpr int kThreads = (kWG + 1) * 128;
  static constexpr int kProducerRegs = 40;
  static constexpr int kEntryRegs = 65536 / kThreads / 8 * 8;
  static constexpr int kConsumerRegs = ((kWG + 1) * kEntryRegs - kProducerRegs) / kWG / 8 * 8;
  static constexpr uint32_t kStageBytes = (kTM + kTN) * kTK * 2;  // a k-tile of A and of B
};
static_assert(K4B_STORE_WG != 3 ||
                  (Design<kStore>::kEntryRegs == 128 && Design<kStore>::kConsumerRegs == 152),
              "setmaxnreg's counts");

template <int EPI>
struct Sm90Smem {
  using D = Design<EPI>;
  bf16 a[D::kStages][D::kTM * kTK];
  bf16 b[D::kStages][kTN * kTK];
  // the output tile's staging by warpgroup and 64-column panel: the
  // output, or a1 then da1 and a3 then da3
  bf16 out[EPI == kStore ? 1 : 2][D::kWG][kPanels][kPanel];
  uint64_t full[D::kStages], empty[D::kStages], epi_full, epi_empty;
};
template <int EPI>
constexpr int kSm90Smem = sizeof(Sm90Smem<EPI>) + 1024;  // + the 1024-byte alignment
static_assert(kSm90Smem<kSilu> <= 232448 && kSm90Smem<kStore> <= 232448,
              "K4b's wgmma instances must fit 227 KB of shared memory");

struct Maps {
  CUtensorMap a[2], b[2];  // the pairs' operands ([1]: the second pair, if any)
  CUtensorMap out[2];      // the output, or da1 and da3
  CUtensorMap in[2];       // the gated epilogue's a1 and a3
};
struct Sm90Shape {
  int E, M, N;  // experts, output rows, output columns
  int k_tiles;  // k-tiles of one pair
  int pairs;
};

struct TileAt {
  int e, m0, n0;
};
template <int TM>
__device__ __forceinline__ TileAt tile_at(int t, int n_m, int n_n) {
  const int r = t / n_n;
  return {r / n_m, (r % n_m) * TM, (t % n_n) * kTN};
}

// the consumer warpgroup wg's named barrier (1 + wg; 0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// byte offset, in a warpgroup's staging buffer (two 64 x 64 panels in
// TMA's 128-byte swizzle), of the bf16 pair at row r, columns 8 j + 2 tq
// and + 1 of its 64 x 128 outputs
__device__ __forceinline__ uint32_t pair_at(int j, int r, int tq) {
  return (j >> 3) * kPanelBytes + r * 128 + (((j & 7) ^ (r & 7)) << 4) + 4 * tq;
}

// When `on`: waits until this thread's TMA stores have read the staging
// buffer, then arrives on `bar`.  A predicate, not a branch: it runs while
// a k-tile's wgmmas are in flight
__device__ __forceinline__ void stores_read(uint64_t* bar, bool on) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %1, 0;\n"
      " @p cp.async.bulk.wait_group.read 0;\n"
      " @p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(smem_addr(bar)),
      "r"(static_cast<int>(on))
      : "memory");
}

// When `on`: stores X staged tensors of a warpgroup (64 rows x two
// panels each, tensor x's panel p at first + x stride + p kPanel) to
// maps[x] at rows m0, columns n0 of expert e, as one bulk group.  A
// predicate, not a branch, like stores_read
template <int X>
__device__ __forceinline__ void store_rows(const CUtensorMap* maps, const bf16* first, int stride,
                                           int n0, int m0, int e, bool on) {
#pragma unroll
  for (int x = 0; x < X; ++x)
#pragma unroll
    for (int p = 0; p < kPanels; ++p)
      asm volatile(
          "{\n .reg .pred p;\n setp.ne.b32 p, %5, 0;\n"
          " @p cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
          "}\n" ::"l"(reinterpret_cast<uint64_t>(&maps[x])),
          "r"(smem_addr(first + x * stride + p * kPanel)), "r"(n0 + 64 * p), "r"(m0), "r"(e),
          "r"(static_cast<int>(on))
          : "memory");
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %0, 0;\n @p cp.async.bulk.commit_group;\n}\n" ::"r"(
          static_cast<int>(on))
      : "memory");
}

// the consumer warpgroup wg's products of the ring's current k-tile into acc
template <bool MN, int EPI>
__device__ __forceinline__ void ktile(Sm90Smem<EPI>& sm, const Ring<Design<EPI>::kStages>& ring,
                                      float (&acc)[64], int wg) {
  mbar_wait(&sm.full[ring.stage], ring.phase);
  const bf16 *a = sm.a[ring.stage], *b = sm.b[ring.stage];
  wgmma_fence();
  if constexpr (MN) {  // panel wg of A (its 64 rows), both panels of B
    const uint64_t ad = desc_b128(a + wg * kPanel, kPanelBytes), bd = desc_b128(b, kPanelBytes);
#pragma unroll
    for (int kk = 0; kk < kTK / 16; ++kk)
      wgmma_ss128<1, 1>(acc, ad + kk * kMNStep, bd + kk * kMNStep);
  } else {
    const uint64_t ad = desc_b128(a + wg * 64 * kTK, 1024), bd = desc_b128(b, 1024);
#pragma unroll
    for (int kk = 0; kk < kTK / 16; ++kk)
      wgmma_ss128<0, 0>(acc, ad + kk * kKStep, bd + kk * kKStep);
  }
  wgmma_commit();
}

// after a k-tile's issue: the previous k-tile's products are done, and
// (when `has_prev`) its stage is released
template <int ST>
__device__ __forceinline__ void ktile_done(uint64_t* empty, Ring<ST>& ring, int& held, int lane,
                                           bool has_prev) {
  wgmma_wait<1>();
  release(&empty[held], lane, has_prev);
  held = ring.stage;
  ring.next();
}

// the last k-tile's products are done and its stage released
template <int ST>
__device__ __forceinline__ void tile_done(uint64_t* empty, int held, int lane, float (&acc)[64]) {
  wgmma_wait<0>();
  fence_acc(acc);
  release(&empty[held], lane);
}

// A store consumer's epilogue of one tile: its rows m0 + 64 wg .. + 64
// from the accumulator (element 4 j + 2 h + c at row 16 warp + gr + 8 h,
// column 8 j + 2 tq + c) to the output, through the staging buffer
__device__ __forceinline__ void store_epilogue(Sm90Smem<kStore>& sm, const Maps& maps,
                                               const TileAt& at, const float (&acc)[64], int wg,
                                               int warp, int lane, int M) {
  const int tid = threadIdx.x % 128, r = 16 * warp + (lane >> 2), tq = lane & 3;
  unsigned char* o = reinterpret_cast<unsigned char*>(sm.out[0][wg][0]);
  if (tid == 0) bulk_wait_read<0>();  // the previous tile's stores have read the buffer
  wg_sync(wg);
#pragma unroll
  for (int j = 0; j < kTN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(o + pair_at(j, r + 8 * h, tq)) =
          pack2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  fence_async_smem();
  wg_sync(wg);
  store_rows<1>(&maps.out[0], sm.out[0][wg][0], 0, at.n0, at.m0 + 64 * wg, at.e,
                tid == 0 && at.m0 + 64 * wg < M);
}

// A consumer's gated epilogue of the block's tile n: waits for the tile's
// a1 and a3, computes da1 = dh a3 act'(a1) and da3 = dh act(a1) in f32 from
// the accumulator (dh), writes them over a1 and a3 and stores both.  The
// stores' reads of the buffer are waited for during the next tile's first
// k-tile (consumer), or before the block exits
template <int ACT>
__device__ __forceinline__ void gated_epilogue(Sm90Smem<ACT>& sm, const Maps& maps,
                                               const TileAt& at, const float (&acc)[64], int n,
                                               int wg, int warp, int lane, int M) {
  const int tid = threadIdx.x % 128, r = 16 * warp + (lane >> 2), tq = lane & 3;
  unsigned char* o1 = reinterpret_cast<unsigned char*>(sm.out[0][wg][0]);
  unsigned char* o3 = reinterpret_cast<unsigned char*>(sm.out[1][wg][0]);
  mbar_wait(&sm.epi_full, n & 1);
#pragma unroll
  for (int j = 0; j < kTN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t off = pair_at(j, r + 8 * h, tq);
      uint32_t* p1 = reinterpret_cast<uint32_t*>(o1 + off);
      uint32_t* p3 = reinterpret_cast<uint32_t*>(o3 + off);
      const float2 x1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p1));
      const float2 x3 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p3));
      const float dh0 = acc[4 * j + 2 * h], dh1 = acc[4 * j + 2 * h + 1];
      float y0, g0, y1, g1;
      act_and_grad<ACT>(x1.x, y0, g0);
      act_and_grad<ACT>(x1.y, y1, g1);
      *p1 = pack2(dh0 * x3.x * g0, dh1 * x3.y * g1);
      *p3 = pack2(dh0 * y0, dh1 * y1);
    }
  fence_async_smem();
  wg_sync(wg);
  store_rows<2>(&maps.out[0], sm.out[0][wg][0], Design<ACT>::kWG * kPanels * kPanel, at.n0,
                at.m0 + 64 * wg, at.e, tid == 0 && at.m0 + 64 * wg < M);
}

// A consumer warpgroup's walk: the block's tiles, each its products and
// then its epilogue
template <bool MN, int EPI>
__device__ __forceinline__ void consumer(Sm90Smem<EPI>& sm, const Maps& maps, const Sm90Shape& s,
                                         int n_m, int n_n, int wg) {
  using D = Design<EPI>;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int tiles = s.E * n_m * n_n, total = s.k_tiles * s.pairs;
  Ring<D::kStages> ring;
  int n = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++n) {
    const TileAt at = tile_at<D::kTM>(t, n_m, n_n);
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    fence_acc(acc);  // the zeros are set here, not sunk between a fence and a wgmma
    int held = 0;
    for (int kt = 0; kt < total; ++kt) {
      ktile<MN, EPI>(sm, ring, acc, wg);
      // gated: the previous tile's a1 / a3 buffer is free once its stores read it
      if constexpr (EPI != kStore) stores_read(&sm.epi_empty, kt == 0 && n > 0 && tid == 0);
      ktile_done(sm.empty, ring, held, lane, kt > 0);
    }
    tile_done<D::kStages>(sm.empty, held, lane, acc);
    if constexpr (EPI == kStore)
      store_epilogue(sm, maps, at, acc, wg, warp, lane, s.M);
    else
      gated_epilogue<EPI>(sm, maps, at, acc, n, wg, warp, lane, s.M);
  }
  if (tid == 0) bulk_wait<0>();  // the last stores are done before the block exits
}

// The block's walk of the output tiles: MN, both operands MN-major (the
// wgrad), else both K-major; EPI, the epilogue
template <bool MN, int EPI>
__device__ __forceinline__ void sm90_gemm(const Maps& maps, const Sm90Shape& s) {
  using D = Design<EPI>;
  extern __shared__ unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<Sm90Smem<EPI>*>(align1024(smem_raw));
  const int n_m = (s.M + D::kTM - 1) / D::kTM, n_n = (s.N + kTN - 1) / kTN;
  const int tiles = s.E * n_m * n_n, total = s.k_tiles * s.pairs;
  if (threadIdx.x == 0) {
    for (int i = 0; i < D::kStages; ++i) {
      mbar_init(&sm.full[i], 1);
      mbar_init(&sm.empty[i], D::kWG * 4);  // one arrival a consumer warp
    }
    mbar_init(&sm.epi_full, 1);
    mbar_init(&sm.epi_empty, D::kWG);  // one a consumer warpgroup
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == D::kWG) {  // producer warpgroup: one thread issues every load
    regs_dec<D::kProducerRegs>();
    if (threadIdx.x == D::kWG * 128) {
      Ring<D::kStages> ring;
      int n = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++n) {
        const TileAt at = tile_at<D::kTM>(t, n_m, n_n);
        // gated: the tile's a1 / a3 (kEpiBoxes boxes of 64 x 64), one after
        // each k-tile's loads from when the previous tile's stores have read
        // the buffer (polled between k-tiles; at the tile's last k-tile,
        // waited for, and the rest issued), so that they never hold up the
        // ring's loads for long
        constexpr int kEpiBoxes = 2 * D::kWG * kPanels;
        auto epi_box = [&](int i) {
          const int x = i / (D::kWG * kPanels), w = i / kPanels % D::kWG, p = i % kPanels;
          tma_box3(sm.out[x][w][p], &maps.in[x], &sm.epi_full, at.n0 + 64 * p, at.m0 + 64 * w,
                   at.e);
        };
        int epi_sent = EPI != kStore ? 0 : kEpiBoxes;
        for (int kt = 0; kt < total; ++kt) {
          const int pair = kt >= s.k_tiles ? 1 : 0, k0 = (kt - pair * s.k_tiles) * kTK;
          uint64_t* full = &sm.full[ring.stage];
          bf16 *a = sm.a[ring.stage], *b = sm.b[ring.stage];
          mbar_wait(&sm.empty[ring.stage], ring.phase ^ 1);
          mbar_expect_tx(full, D::kStageBytes);
          if constexpr (MN) {  // panels of 64 columns x 64 capacity rows
#pragma unroll
            for (int p = 0; p < D::kWG; ++p)
              tma_box3(a + p * kPanel, &maps.a[pair], full, at.m0 + 64 * p, k0, at.e);
#pragma unroll
            for (int p = 0; p < kPanels; ++p)
              tma_box3(b + p * kPanel, &maps.b[pair], full, at.n0 + 64 * p, k0, at.e);
          } else {  // boxes of kTM (A) and kTN (B) rows x 64 of K
            tma_box3(a, &maps.a[pair], full, k0, at.m0, at.e);
            tma_box3(b, &maps.b[pair], full, k0, at.n0, at.e);
          }
          ring.next();
          if constexpr (EPI != kStore) {
            const uint32_t parity = (n & 1) ^ 1;
            const bool last = kt == total - 1;
            if (epi_sent == 0 && (last || mbar_test(&sm.epi_empty, parity))) {
              mbar_wait(&sm.epi_empty, parity);
              mbar_expect_tx(&sm.epi_full, kEpiBoxes * kPanelBytes);
              epi_box(epi_sent++);
            } else if (epi_sent > 0 && epi_sent < kEpiBoxes) {
              epi_box(epi_sent++);
            }
            while (last && epi_sent < kEpiBoxes) epi_box(epi_sent++);
          }
        }
      }
    }
  } else {  // consumer warpgroup wg: rows m0 + 64 wg .. + 64 of each tile
    regs_inc<D::kConsumerRegs>();
    consumer<MN, EPI>(sm, maps, s, n_m, n_n, wg);
  }
}

template <int EPI>
__global__ void __launch_bounds__(Design<EPI>::kThreads, 1)
gmm_dgrad_sm90(const __grid_constant__ Maps maps, const Sm90Shape s) {
  sm90_gemm<false, EPI>(maps, s);
}

__global__ void __launch_bounds__(Design<kStore>::kThreads, 1)
gmm_wgrad_sm90(const __grid_constant__ Maps maps, const Sm90Shape s) {
  sm90_gemm<true, kStore>(maps, s);
}

// a contiguous (E, rows, cols) bf16 tensor as boxes of box_rows x 64
// columns of one expert, 128-byte swizzled (a box row is one swizzle row);
// what lies past rows or cols reads as zeros and is dropped on a store
cudaError_t expert_map(CUtensorMap* map, const void* base, int E, int rows, int cols,
                       int box_rows) {
  EncodeTiled encode;
  const cudaError_t err = encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t row = static_cast<cuuint64_t>(cols) * 2;  // bytes
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(E)};
  const cuuint64_t strides[2] = {row, static_cast<cuuint64_t>(rows) * row};  // dims 1-2
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the current device's streaming multiprocessors (the persistent grid's
// blocks), queried once per device
cudaError_t sm_count(int* out) {
  constexpr int kMaxDevices = 64;
  static int counts[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && counts[dev] > 0) {
    *out = counts[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(out, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < kMaxDevices) counts[dev] = *out;
  return err;
}

// launches the instance Kernel of epilogue EPI on a persistent grid: one
// block an SM, at most one a tile
template <auto Kernel, int EPI>
cudaError_t launch_sm90(const Maps& maps, const Sm90Shape& s, cudaStream_t st) {
  using D = Design<EPI>;
  cudaError_t err = ready<Kernel>(D::kEntryRegs, kSm90Smem<EPI>);
  int n_sm = 0;
  if (err == cudaSuccess) err = sm_count(&n_sm);
  if (err != cudaSuccess) return err;
  const long long tiles =
      static_cast<long long>(s.E) * ((s.M + D::kTM - 1) / D::kTM) * ((s.N + kTN - 1) / kTN);
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  Kernel<<<static_cast<int>(tiles < n_sm ? tiles : n_sm), D::kThreads, kSm90Smem<EPI>, st>>>(
      maps, s);
  return cudaGetLastError();
}

cudaError_t gated_sm90(const void* dy, const void* w2, const void* a1, const void* a3, void* da1,
                       void* da3, int act, int E, int C, int D, int F, cudaStream_t st) {
  Maps m{};
  cudaError_t err = expert_map(&m.a[0], dy, E, C, D, Design<kSilu>::kTM);
  if (err == cudaSuccess) err = expert_map(&m.b[0], w2, E, F, D, kTN);
  if (err == cudaSuccess) err = expert_map(&m.in[0], a1, E, C, F, 64);
  if (err == cudaSuccess) err = expert_map(&m.in[1], a3, E, C, F, 64);
  if (err == cudaSuccess) err = expert_map(&m.out[0], da1, E, C, F, 64);
  if (err == cudaSuccess) err = expert_map(&m.out[1], da3, E, C, F, 64);
  if (err != cudaSuccess) return err;
  const Sm90Shape s{E, C, F, (D + kTK - 1) / kTK, 1};
  return act == kSilu ? launch_sm90<gmm_dgrad_sm90<kSilu>, kSilu>(m, s, st)
                      : launch_sm90<gmm_dgrad_sm90<kGelu>, kGelu>(m, s, st);
}

cudaError_t dgrad_sm90(const void* g, const void* w, const void* g2, const void* w2, void* dx,
                       int E, int C, int D, int F, cudaStream_t st) {
  Maps m{};
  const int pairs = g2 != nullptr ? 2 : 1;
  cudaError_t err = cudaSuccess;
  for (int p = 0; p < pairs && err == cudaSuccess; ++p) {
    err = expert_map(&m.a[p], p == 0 ? g : g2, E, C, F, Design<kStore>::kTM);
    if (err == cudaSuccess) err = expert_map(&m.b[p], p == 0 ? w : w2, E, D, F, kTN);
  }
  if (err == cudaSuccess) err = expert_map(&m.out[0], dx, E, C, D, 64);
  if (err != cudaSuccess) return err;
  const Sm90Shape s{E, C, D, (F + kTK - 1) / kTK, pairs};
  return launch_sm90<gmm_dgrad_sm90<kStore>, kStore>(m, s, st);
}

cudaError_t wgrad_sm90(const void* a, const void* b, void* dw, int E, int C, int P, int Q,
                       cudaStream_t st) {
  Maps m{};
  cudaError_t err = expert_map(&m.a[0], a, E, C, P, 64);
  if (err == cudaSuccess) err = expert_map(&m.b[0], b, E, C, Q, 64);
  if (err == cudaSuccess) err = expert_map(&m.out[0], dw, E, P, Q, 64);
  if (err != cudaSuccess) return err;
  const Sm90Shape s{E, P, Q, (C + kTK - 1) / kTK, 1};
  return launch_sm90<gmm_wgrad_sm90, kStore>(m, s, st);
}

// which instances an entry point may take: the current rule, or only the
// first design's bf16 cp.async instance (the *_v1 entries, for timing)
enum Route : int { kCurrent = 0, kPrevious = 1 };

int gated_entry(Route route, const void* dy, const void* w2, const void* a1, const void* a3,
                void* da1, void* da3, int dtype, int act, int E, int C, int D, int F,
                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(E, C, D, F) || (act != kSilu && act != kGelu)) return cudaErrorInvalidValue;
  const bool tma = dtype == kBF16 && D % 8 == 0 && F % 8 == 0 &&
                   aligned16({dy, w2, a1, a3, da1, da3});
  if (route == kPrevious && !tma) return cudaErrorInvalidValue;
  if (route == kCurrent && tma) return gated_sm90(dy, w2, a1, a3, da1, da3, act, E, C, D, F, st);
  return with_dtype(dtype, [&](auto tag) -> cudaError_t {
    using T = typename decltype(tag)::type;
    const Gemm<T> g{static_cast<const T*>(dy), nullptr, static_cast<const T*>(w2), nullptr,
                    static_cast<long long>(C) * D, static_cast<long long>(F) * D, D, D, C, F, D,
                    1};
    const T *p1 = static_cast<const T*>(a1), *p3 = static_cast<const T*>(a3);
    T *o1 = static_cast<T*>(da1), *o3 = static_cast<T*>(da3);
    const bool vec = route == kPrevious;
    return act == kSilu ? launch_gated<T, kSilu>(g, vec, E, st, p1, p3, o1, o3)
                        : launch_gated<T, kGelu>(g, vec, E, st, p1, p3, o1, o3);
  });
}

int dgrad_entry(Route route, const void* g, const void* w, const void* g2, const void* w2,
                void* dx, int dtype, int E, int C, int D, int F, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int pairs = g2 != nullptr ? 2 : 1;
  if (!shape_ok(E, C, D, F) || (g2 == nullptr) != (w2 == nullptr)) return cudaErrorInvalidValue;
  const bool tma = dtype == kBF16 && D % 8 == 0 && F % 8 == 0 &&
                   aligned16({g, w, dx, pairs == 2 ? g2 : g, pairs == 2 ? w2 : w});
  if (route == kPrevious && !tma) return cudaErrorInvalidValue;
  if (route == kCurrent && tma) return dgrad_sm90(g, w, g2, w2, dx, E, C, D, F, st);
  return with_dtype(dtype, [&](auto tag) -> cudaError_t {
    using T = typename decltype(tag)::type;
    const Gemm<T> p{static_cast<const T*>(g), static_cast<const T*>(g2),
                    static_cast<const T*>(w), static_cast<const T*>(w2),
                    static_cast<long long>(C) * F, static_cast<long long>(D) * F, F, F, C, D, F,
                    pairs};
    return launch_dgrad<T>(p, route == kPrevious, E, st, static_cast<T*>(dx));
  });
}

int wgrad_entry(Route route, const void* a, const void* b, void* dw, int dtype, int E, int C,
                int P, int Q, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(E, C, P, Q)) return cudaErrorInvalidValue;
  const bool tma = dtype == kBF16 && P % 8 == 0 && Q % 8 == 0 && aligned16({a, b, dw});
  if (route == kPrevious && !tma) return cudaErrorInvalidValue;
  if (route == kCurrent && tma) return wgrad_sm90(a, b, dw, E, C, P, Q, st);
  return with_dtype(dtype, [&](auto tag) -> cudaError_t {
    using T = typename decltype(tag)::type;
    const Gemm<T> p{static_cast<const T*>(a), nullptr, static_cast<const T*>(b), nullptr,
                    static_cast<long long>(C) * P, static_cast<long long>(C) * Q, P, Q, P, Q, C,
                    1};
    return launch_wgrad<T>(p, route == kPrevious, E, st, static_cast<T*>(dw));
  });
}

// an instance's registers (ptxas), blocks an SM at its shared memory
template <auto Kernel, int EPI>
cudaError_t sm90_info(int* regs, int* blocks) {
  *regs = registers<Kernel>();
  cudaError_t err = allow_smem<Kernel>(kSm90Smem<EPI>);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, Kernel, Design<EPI>::kThreads,
                                                        kSm90Smem<EPI>);
  return err;
}

}  // namespace

// The bf16 instances on operands whose D and F (P and Q) are multiples of
// 8 and which are all 16-byte aligned are the wgmma kernels, the other
// bf16 ones load each element on its own (kernels/moe_gmm.py's
// bwd_instance says the same).  The *_v1 entries take the same arguments
// and run the first design's bf16 cp.async instances on such operands
// only (cudaErrorInvalidValue otherwise), for timing.

// (a) the gated dgrad.  dy (E, C, D), w2 (E, F, D), a1 / a3 / da1 / da3
// (E, C, F); act 1 silu, 2 gelu (tanh form).  Contiguous tensors of one
// dtype.
extern "C" int moe_gmm_bwd_gated(const void* dy, const void* w2, const void* a1, const void* a3,
                                 void* da1, void* da3, int dtype, int act, int E, int C, int D,
                                 int F, void* stream) {
  return gated_entry(kCurrent, dy, w2, a1, a3, da1, da3, dtype, act, E, C, D, F, stream);
}
extern "C" int moe_gmm_bwd_gated_v1(const void* dy, const void* w2, const void* a1,
                                    const void* a3, void* da1, void* da3, int dtype, int act,
                                    int E, int C, int D, int F, void* stream) {
  return gated_entry(kPrevious, dy, w2, a1, a3, da1, da3, dtype, act, E, C, D, F, stream);
}

// (b) the dgrad.  dx (E, C, D) = g (E, C, F) w (E, D, F)^T [+ g2 w2^T]: g2
// and w2 both null (one pair) or both given, of g's and w's shapes.
extern "C" int moe_gmm_bwd_dgrad(const void* g, const void* w, const void* g2, const void* w2,
                                 void* dx, int dtype, int E, int C, int D, int F, void* stream) {
  return dgrad_entry(kCurrent, g, w, g2, w2, dx, dtype, E, C, D, F, stream);
}
extern "C" int moe_gmm_bwd_dgrad_v1(const void* g, const void* w, const void* g2, const void* w2,
                                    void* dx, int dtype, int E, int C, int D, int F,
                                    void* stream) {
  return dgrad_entry(kPrevious, g, w, g2, w2, dx, dtype, E, C, D, F, stream);
}

// (c) the wgrad.  dw (E, P, Q) = a (E, C, P)^T b (E, C, Q).
extern "C" int moe_gmm_bwd_wgrad(const void* a, const void* b, void* dw, int dtype, int E, int C,
                                 int P, int Q, void* stream) {
  return wgrad_entry(kCurrent, a, b, dw, dtype, E, C, P, Q, stream);
}
extern "C" int moe_gmm_bwd_wgrad_v1(const void* a, const void* b, void* dw, int dtype, int E,
                                    int C, int P, int Q, void* stream) {
  return wgrad_entry(kPrevious, a, b, dw, dtype, E, C, P, Q, stream);
}

// The wgmma instances as built, on the current device
// (moe_gmm.SM90_CONFIG_KEYS): out[0..1] the entry registers setmaxnreg's
// exchange assumes in the gated and the store instances; out[2..5] the
// registers ptxas gave gmm_dgrad_sm90 at silu, gelu and the store and
// gmm_wgrad_sm90 (-1 if unknown); out[6..7] the gated and the store
// instances' dynamic shared memory; out[8..10] the blocks an SM holds of
// the gated, the dgrad store and the wgrad instances; out[11..12] the
// gated and the store instances' tile rows; out[13..14] a tile's columns
// and k-tile depth; out[15..16] the gated and the store instances' ring
// stages; out[17] the device's SMs (the persistent grid).
extern "C" int moe_gmm_bwd_sm90_config(int* out) {
  using G = Design<kSilu>;
  using S = Design<kStore>;
  out[0] = G::kEntryRegs;
  out[1] = S::kEntryRegs;
  out[6] = kSm90Smem<kSilu>;
  out[7] = kSm90Smem<kStore>;
  out[11] = G::kTM;
  out[12] = S::kTM;
  out[13] = kTN;
  out[14] = kTK;
  out[15] = G::kStages;
  out[16] = S::kStages;
  int gelu_blocks = 0;
  cudaError_t err = sm90_info<gmm_dgrad_sm90<kSilu>, kSilu>(&out[2], &out[8]);
  if (err == cudaSuccess) err = sm90_info<gmm_dgrad_sm90<kGelu>, kGelu>(&out[3], &gelu_blocks);
  if (err == cudaSuccess) err = sm90_info<gmm_dgrad_sm90<kStore>, kStore>(&out[4], &out[9]);
  if (err == cudaSuccess) err = sm90_info<gmm_wgrad_sm90, kStore>(&out[5], &out[10]);
  if (err == cudaSuccess) err = sm_count(&out[17]);
  if (err == cudaSuccess && gelu_blocks != out[8]) err = cudaErrorInvalidConfiguration;
  return err;
}
