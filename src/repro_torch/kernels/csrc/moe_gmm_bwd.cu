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
// * gmm_dgrad_gated (a): dh = dy w2^T (E, C, F), reading w2 (E, F, D) in
//   place as the transposed operand; its epilogue reads a1 and a3 and
//   writes da1 = dh a3 act'(a1) and da3 = dh act(a1), computed in f32
//   from the f32 accumulator and rounded once each (dh itself is never
//   rounded).  silu and the tanh gelu, K4's two epilogues.
// * gmm_dgrad (b): dx = da1 w1^T + da3 w3^T (E, C, D): both products
//   summed in one f32 accumulator (the second pair's k-tiles follow the
//   first's in the same loop), rounded once.  Also the x-gradient of a
//   bare grouped matmul (one pair).
// * gmm_wgrad (c): dw = a^T b per expert, a (E, C, P), b (E, C, Q) -> (E,
//   P, Q), contracting over the capacity rows: dw1 = x^T da1, dw3 = x^T
//   da3, dw2 = h^T dy.  a's tiles are read transposed by ldmatrix.trans.
//
// Replaces no Pallas kernel: the JAX package differentiates
// repro/kernels/ops.py::moe_ffn (repro/kernels/moe_gmm.py::gmm, the TPU
// kernel K4) with jax.grad through ref.gmm_ref / ref.moe_ffn_ref, which XLA
// lowers to its own matmuls.  On the card these are hand-written kernels.
//
// What bounds them: operations.  At deepseek-moe-16b's training shape, (64,
// 960, 2048) with F 1408 per MoE layer, (a) moves 1.31 GB for 354 GFLOP
// (0.392 ms by bytes), (b) 709 GFLOP (0.717 ms) and each (c) 354 GFLOP
// (0.358 ms), all above the card's ~295 FLOP a byte.  This first design is
// the plain tensor-core GEMM: one block per (expert, 128 x 128 output tile),
// 8 warps of 64 x 32 outputs on mma.sync m16n8k16 with f32 accumulators,
// 32-deep stages of both operands through a 4-stage cp.async ring in
// dynamic shared memory (80 KB, two blocks an SM), rows padded by 16 bytes
// so an ldmatrix phase reads distinct bank groups.  The output tile is the
// fastest grid axis within an expert, so the blocks in flight share one
// A row block from L2.  wgmma and TMA are for a later redesign.
//
// Instances, chosen by dtype, shape and alignment only (the wrapper,
// kernels/moe_gmm.py, mirrors the choice in bwd_instance; a failed launch
// raises, nothing falls back):
//
// * bf16, D and F multiples of 8 and every operand 16-byte aligned: the
//   cp.async ring above (VEC).
// * bf16 otherwise (a ragged D or F, or a view off 16 bytes): the same
//   tiles and mma.sync, each element loaded on its own (no cp.async).
// * f32: the same 128 x 128 tiles on the CUDA cores in full f32 (8 x 8
//   outputs a thread, 8-deep stages staged through registers), so the f32
//   gates hold the port to f32 rounding.
//
// Ragged C / D / F edges are masked in the kernels (zero-filled tiles,
// guarded stores); no padded copy is made.  A launch allocates nothing and
// runs on the caller's stream, so a CUDA graph can capture it.
#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "mma.cuh"

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

}  // namespace

// The bf16 instances take 16-byte cp.async chunks (VEC) when D and F are
// multiples of 8 and every operand is 16-byte aligned, element-wise loads
// otherwise (kernels/moe_gmm.py's bwd_instance says the same).

// (a) gmm_dgrad_gated.  dy (E, C, D), w2 (E, F, D), a1 / a3 / da1 / da3 (E,
// C, F); act 1 silu, 2 gelu (tanh form).  Contiguous tensors of one dtype.
extern "C" int moe_gmm_bwd_gated(const void* dy, const void* w2, const void* a1, const void* a3,
                                 void* da1, void* da3, int dtype, int act, int E, int C, int D,
                                 int F, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(E, C, D, F) || (act != kSilu && act != kGelu)) return cudaErrorInvalidValue;
  const bool vec = D % 8 == 0 && F % 8 == 0 && aligned16({dy, w2, a1, a3, da1, da3});
  return with_dtype(dtype, [&](auto tag) -> cudaError_t {
    using T = typename decltype(tag)::type;
    const Gemm<T> g{static_cast<const T*>(dy), nullptr, static_cast<const T*>(w2), nullptr,
                    static_cast<long long>(C) * D, static_cast<long long>(F) * D, D, D, C, F, D,
                    1};
    const T *p1 = static_cast<const T*>(a1), *p3 = static_cast<const T*>(a3);
    T *o1 = static_cast<T*>(da1), *o3 = static_cast<T*>(da3);
    return act == kSilu ? launch_gated<T, kSilu>(g, vec, E, st, p1, p3, o1, o3)
                        : launch_gated<T, kGelu>(g, vec, E, st, p1, p3, o1, o3);
  });
}

// (b) gmm_dgrad.  dx (E, C, D) = g (E, C, F) w (E, D, F)^T [+ g2 w2^T]: g2
// and w2 both null (one pair) or both given, of g's and w's shapes.
extern "C" int moe_gmm_bwd_dgrad(const void* g, const void* w, const void* g2, const void* w2,
                                 void* dx, int dtype, int E, int C, int D, int F, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int pairs = g2 != nullptr ? 2 : 1;
  if (!shape_ok(E, C, D, F) || (g2 == nullptr) != (w2 == nullptr)) return cudaErrorInvalidValue;
  const bool vec = D % 8 == 0 && F % 8 == 0 &&
                   aligned16({g, w, dx, pairs == 2 ? g2 : g, pairs == 2 ? w2 : w});
  return with_dtype(dtype, [&](auto tag) -> cudaError_t {
    using T = typename decltype(tag)::type;
    const Gemm<T> p{static_cast<const T*>(g), static_cast<const T*>(g2),
                    static_cast<const T*>(w), static_cast<const T*>(w2),
                    static_cast<long long>(C) * F, static_cast<long long>(D) * F, F, F, C, D, F,
                    pairs};
    return launch_dgrad<T>(p, vec, E, st, static_cast<T*>(dx));
  });
}

// (c) gmm_wgrad.  dw (E, P, Q) = a (E, C, P)^T b (E, C, Q).
extern "C" int moe_gmm_bwd_wgrad(const void* a, const void* b, void* dw, int dtype, int E, int C,
                                 int P, int Q, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(E, C, P, Q)) return cudaErrorInvalidValue;
  const bool vec = P % 8 == 0 && Q % 8 == 0 && aligned16({a, b, dw});
  return with_dtype(dtype, [&](auto tag) -> cudaError_t {
    using T = typename decltype(tag)::type;
    const Gemm<T> p{static_cast<const T*>(a), nullptr, static_cast<const T*>(b), nullptr,
                    static_cast<long long>(C) * P, static_cast<long long>(C) * Q, P, Q, P, Q, C,
                    1};
    return launch_wgrad<T>(p, vec, E, st, static_cast<T*>(dw));
  });
}
