// Mamba-1 selective scan for Hopper (sm_90a):
//
//   h_t = exp(dt_t ⊙ A) h_{t-1} + (dt_t x_t) ⊗ B_t
//   y_t = C_t · h_t + D ⊙ x_t
//
// x, dt: (B, T, DI) and Bm, C: (B, T, N) in f32 or bf16 (one type for all
// four); A: (DI, N), D: (DI,) and state: (B, DI, N) in f32 -> y (B, T, DI)
// in x's type, final state (B, DI, N) f32.  All arithmetic is f32.
//
// Replaces the Pallas TPU kernel repro/kernels/mamba_scan.py (mamba_scan,
// _mamba_kernel).  There the grid is (B, DI/512, T/L) with the chunks
// innermost and sequential, the (512, N) state in VMEM scratch across the
// sweep.  A CUDA grid has no sequential axis, so time becomes a loop inside
// the block.  Each channel's N state values evolve on their own (channels
// share only B_t and C_t), so one block owns one (batch, channel tile) for
// the whole of T, with its state in registers, and no two blocks share
// anything.
//
// Inside a block, N / 4 lanes share one channel: each lane holds 4 of the
// channel's N state values (n = 4 * g .. 4 * g + 3 for lane group g) for the
// whole sweep.  Per step a lane computes its 4 decays exp2(dt * A log2 e),
// updates its 4 state values with one FMA each, and the channel's lanes sum
// C_t · h_t with log2(N / 4) shuffles.  The recurrence through h is one FMA
// a step; the exponentials, products and the shuffle sum of one step do not
// wait on the next, so steps overlap.
//
// Inputs are read in their (B, T, DI) / (B, T, N) layout (no transposed
// copies): a pass stages TT steps of the tile's x and dt columns and of the
// B_t / C_t rows in shared memory, converted to f32.  The next pass's values
// are loaded into registers while the block walks the current one.  y of a
// pass is gathered in shared memory and written out in rows of the tile's
// contiguous channels.
//
// What bounds it: at the served prefill (B 1, T 512, DI 16384, N 16, bf16
// x / dt / B / C) it must move ~53.5 MB (16.0 us at 3.35 TB/s) and compute
// 134 M exponentials on the special-function units (16 a clock per SM:
// ~32 us at 1.98 GHz on 132 SMs); its f32 FMAs take ~12 us.  So the
// exponentials set the bound, and the design keeps the SFUs fed: 4
// independent exponentials per lane and step, and 4 lanes per channel give
// 65536 threads at batch 1 (16 warps per SM), where one lane per channel
// would leave one warp per scheduler.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kVPL = 4;               // state values per lane
constexpr int kTileElems = 2048;      // TT x CT: the x / dt / y tile of one pass
constexpr float kLog2e = 1.4426950408889634f;

template <int N>
struct Shape {
  static constexpr int NL = N / kVPL;          // lanes per channel
  static constexpr int CT = kThreads / NL;     // channels per block
  static constexpr int TT = kTileElems / CT;   // steps per pass
  static constexpr int kPerX = TT * CT / kThreads;
  static constexpr int kPerB = (TT * N + kThreads - 1) / kThreads;
  static_assert(N % kVPL == 0 && 32 % NL == 0, "N / 4 lanes must divide a warp");
};

// One pass's inputs, staged through registers in their own types.  Steps
// past T and channels past DI read as zero.
template <typename T, int N>
struct Stage {
  using S = Shape<N>;
  T x[S::kPerX], dt[S::kPerX], b[S::kPerB], c[S::kPerB];

  __device__ __forceinline__ void load(const T* xg, const T* dtg, const T* bg, const T* cg,
                                       size_t xbase, size_t bbase, int t0, int T_, int c0,
                                       int DI) {
#pragma unroll
    for (int i = 0; i < S::kPerX; ++i) {
      const int idx = threadIdx.x + i * kThreads, tt = idx / S::CT, ch = idx % S::CT;
      const bool ok = t0 + tt < T_ && c0 + ch < DI;
      const size_t off = xbase + static_cast<size_t>(t0 + tt) * DI + c0 + ch;
      x[i] = ok ? xg[off] : from_f32<T>(0.f);
      dt[i] = ok ? dtg[off] : from_f32<T>(0.f);
    }
#pragma unroll
    for (int i = 0; i < S::kPerB; ++i) {
      const int idx = threadIdx.x + i * kThreads;  // (tt, n) = (idx / N, idx % N)
      const bool ok = idx < S::TT * N && t0 + idx / N < T_;
      const size_t off = bbase + static_cast<size_t>(t0) * N + idx;  // rows are contiguous
      b[i] = ok ? bg[off] : from_f32<T>(0.f);
      c[i] = ok ? cg[off] : from_f32<T>(0.f);
    }
  }

  __device__ __forceinline__ void store(float* x_s, float* dt_s, float* b_s, float* c_s) const {
#pragma unroll
    for (int i = 0; i < S::kPerX; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      x_s[idx] = to_f32(x[i]);
      dt_s[idx] = to_f32(dt[i]);
    }
#pragma unroll
    for (int i = 0; i < S::kPerB; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      if (idx < S::TT * N) {
        b_s[idx] = to_f32(b[i]);
        c_s[idx] = to_f32(c[i]);
      }
    }
  }
};

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
mamba_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt, const float* __restrict__ A,
                  const T* __restrict__ Bm, const T* __restrict__ C, const float* __restrict__ D,
                  const float* __restrict__ s0, T* __restrict__ y, float* __restrict__ sT, int T_,
                  int DI) {
  using S = Shape<N>;
  __shared__ float x_s[S::TT * S::CT], dt_s[S::TT * S::CT], y_s[S::TT * S::CT];
  __shared__ __align__(16) float b_s[S::TT * N];
  __shared__ __align__(16) float c_s[S::TT * N];

  const int bi = blockIdx.y;
  const int c0 = blockIdx.x * S::CT;
  const int cl = threadIdx.x / S::NL;  // channel in the tile
  const int g = threadIdx.x % S::NL;   // which 4 state values of it
  const int ch = c0 + cl;
  const bool live = ch < DI;  // the ragged last tile

  const size_t xbase = static_cast<size_t>(bi) * T_ * DI;
  const size_t bbase = static_cast<size_t>(bi) * T_ * N;
  Stage<T, N> stage;
  stage.load(x, dt, Bm, C, xbase, bbase, 0, T_, c0, DI);

  float h[kVPL], a2[kVPL];
  const size_t sbase = (static_cast<size_t>(bi) * DI + ch) * N + g * kVPL;
#pragma unroll
  for (int j = 0; j < kVPL; ++j) {
    h[j] = live ? s0[sbase + j] : 0.f;
    a2[j] = live ? A[static_cast<size_t>(ch) * N + g * kVPL + j] * kLog2e : 0.f;
  }
  const float dd = live ? D[ch] : 0.f;

  for (int t0 = 0; t0 < T_; t0 += S::TT) {
    __syncthreads();  // the previous pass's tiles are read and its y written out
    stage.store(x_s, dt_s, b_s, c_s);
    __syncthreads();
    // the next pass's loads are in flight while this pass runs
    if (t0 + S::TT < T_) stage.load(x, dt, Bm, C, xbase, bbase, t0 + S::TT, T_, c0, DI);
    const int nt = min(S::TT, T_ - t0);
    for (int tt = 0; tt < nt; ++tt) {
      const float xv = x_s[tt * S::CT + cl], dv = dt_s[tt * S::CT + cl];
      const float4 bv = *reinterpret_cast<const float4*>(&b_s[tt * N + g * kVPL]);
      const float4 cv = *reinterpret_cast<const float4*>(&c_s[tt * N + g * kVPL]);
      const float bj[kVPL] = {bv.x, bv.y, bv.z, bv.w};
      const float cj[kVPL] = {cv.x, cv.y, cv.z, cv.w};
      const float dx = dv * xv;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kVPL; ++j) {
        h[j] = fmaf(exp2f(dv * a2[j]), h[j], dx * bj[j]);
        acc = fmaf(cj[j], h[j], acc);
      }
#pragma unroll
      for (int off = S::NL / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (g == 0) y_s[tt * S::CT + cl] = fmaf(dd, xv, acc);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < S::kPerX; ++i) {  // rows of the tile's contiguous channels
      const int idx = threadIdx.x + i * kThreads, tt = idx / S::CT, cc = idx % S::CT;
      if (tt < nt && c0 + cc < DI)
        y[xbase + static_cast<size_t>(t0 + tt) * DI + c0 + cc] = from_f32<T>(y_s[idx]);
    }
  }

  if (live) {
#pragma unroll
    for (int j = 0; j < kVPL; ++j) sT[sbase + j] = h[j];
  }
}

template <typename T, int N>
cudaError_t launch(const void* x, const void* dt, const float* A, const void* Bm, const void* C,
                   const float* D, const float* s0, void* y, float* sT, int B, int T_, int DI,
                   cudaStream_t st) {
  const dim3 grid((DI + Shape<N>::CT - 1) / Shape<N>::CT, B);
  mamba_scan_kernel<T, N><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), A, static_cast<const T*>(Bm),
      static_cast<const T*>(C), D, s0, static_cast<T*>(y), sT, T_, DI);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_n(const void* x, const void* dt, const float* A, const void* Bm, const void* C,
                     const float* D, const float* s0, void* y, float* sT, int B, int T_, int DI,
                     int N, cudaStream_t st) {
  switch (N) {  // the CPU tests' state sizes, the reduced config's 8 and jamba's 16
    case 4: return launch<T, 4>(x, dt, A, Bm, C, D, s0, y, sT, B, T_, DI, st);
    case 8: return launch<T, 8>(x, dt, A, Bm, C, D, s0, y, sT, B, T_, DI, st);
    case 16: return launch<T, 16>(x, dt, A, Bm, C, D, s0, y, sT, B, T_, DI, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: x / dt / Bm / C / y.  A, D, the state and the final state are f32.
// N in {4, 8, 16}; B, T, DI >= 1; all tensors contiguous.
extern "C" int mamba_scan_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                              const void* C, const void* D, const void* s0, void* y, void* sT,
                              int dtype, int B, int T, int DI, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || T < 1 || DI < 1 || B > 65535) return cudaErrorInvalidValue;
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(D);
  const float* s0f = static_cast<const float*>(s0);
  float* sTf = static_cast<float*>(sT);
  switch (dtype) {
    case kF32: return launch_n<float>(x, dt, Af, Bm, C, Df, s0f, y, sTf, B, T, DI, N, st);
    case kBF16:
      return launch_n<__nv_bfloat16>(x, dt, Af, Bm, C, Df, s0f, y, sTf, B, T, DI, N, st);
    default: return cudaErrorInvalidValue;
  }
}
