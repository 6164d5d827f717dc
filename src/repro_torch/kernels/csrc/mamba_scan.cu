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
// share only B_t and C_t), so one block owns one (batch, tile of CT
// channels) for the whole of T, with its state in registers, and no two
// blocks share anything.  A lane holds VPL = min(N, 8) of a channel's state
// values (n = VPL·g .. VPL·g + VPL - 1 for lane g of the channel) for the
// sweep, so N / VPL lanes share a channel: 2 at jamba's N = 16.
//
// What bounds it: at the served prefill (B 1, T 512, DI 16384, N 16, bf16
// x / dt / B / C) it must move ~53.5 MB (16.0 us at 3.35 TB/s) and compute
// 134 M exponentials on the special-function units (16 a clock per SM:
// ~32 us at 1.98 GHz on 132 SMs); its f32 FMAs take ~12 us.  The
// exponentials set the bound; what holds a serial scan from it is the
// instructions each step issues and the latency of each step's chain
// (tools/k5_variants.py).  So:
//
// * One wave at the served prefill, with few instructions a state value:
//   256 blocks of 128 threads, at most 128 registers a thread
//   (__launch_bounds__(128, 4)) and 24 KB of shared memory a block, so all
//   are resident on 132 SMs.  A lane's 8 values share its loads of x_t and
//   dt_t, its dt·x and its share of the sums' exchange (4 values a lane, 4
//   lanes a channel, issue more instructions a value and were slower at
//   batch 1 and 8 though they run twice the warps).  No staged input lives in
//   registers: x, dt, B and C reach shared memory through a kStages-deep
//   ring of kSteps-step stages filled by cp.async (16-byte copies,
//   zero-filled past T and past DI), in their own type, read in their
//   (B, T, DI) / (B, T, N) layout.  B_t and C_t rows are shared by the
//   block's channels, so a bf16 stage's are converted to f32 once, by the
//   whole block, beside the store of the previous stage's y.
// * Steps in groups of kS, unrolled: a group's VPL·kS exponentials of a
//   lane depend on dt alone, so they issue back to back; only h's one FMA a
//   step is serial.  Exponentials are ex2.approx.ftz of dt·A·log2(e): one
//   special-function instruction, with no range handling around it.
// * C·h of a group reduce-scattered over the channel's lanes (as K6's
//   column sums): at N = 16, kS sums over 2 lanes take kS / 2 shuffles for
//   kS steps, and each lane ends holding the finished sums of its own
//   steps, writes y = D·x + sum over x's slot in the ring, and the block
//   stores each stage's y in rows of the tile's contiguous channels.
// * No branch for the ragged edges: steps past T read dt = x = 0 (decay 1,
//   no input), so the state carries through them, and are not stored;
//   channels past DI are masked at the store.
//
// A view off a 16-byte boundary, or DI or N rows that are not a multiple of
// 16 bytes, takes the same kernel with element-wise loads into the ring and
// element-wise stores (kVec = false).
#include <cstdint>

#include "mma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMinBlocks = 4;         // blocks an SM: at most 65536 / (4 x 128) = 128 registers
constexpr int kMaxVPL = 8;            // state values a lane holds, at most
constexpr int kS = 8;                 // steps per group
constexpr int kStages = 2;            // ring depth
constexpr int kStageBytes = 4096;     // of x (and of dt) in one ring stage

__host__ __device__ constexpr int ilog2(int x) { return x <= 1 ? 0 : 1 + ilog2(x / 2); }

template <typename T, int N>
struct Shape {
  static constexpr int VPL = N < kMaxVPL ? N : kMaxVPL;        // state values per lane
  static constexpr int NL = N / VPL;                            // lanes per channel
  static constexpr int CT = kThreads / NL;                      // channels per block
  static constexpr int kSteps = kStageBytes / (CT * static_cast<int>(sizeof(T)));
  static constexpr int kXB = kSteps * CT * sizeof(T);           // bytes of x (or dt) a slot
  static constexpr int kBB = kSteps * N * sizeof(T);            // bytes of B (or C) a slot
  static constexpr int kSlot = 2 * kXB + 2 * kBB;
  static constexpr int kCvt = sizeof(T) == 4 ? 0 : 2 * kSteps * N * 4;  // a stage's f32 B, C
  static constexpr int kSmem = kStages * kSlot + kCvt;
  static_assert(N % VPL == 0 && VPL % 2 == 0 && 32 % NL == 0, "a channel's lanes");
  static_assert(kSteps % kS == 0 && kXB % 16 == 0 && kBB % 16 == 0, "stage");
};

// M (a multiple of 2) consecutive f32 from shared memory, in 16- or 8-byte loads
template <int M>
__device__ __forceinline__ void load_f32s(const float* p, float (&v)[M]) {
#pragma unroll
  for (int i = 0; i < M; i += M % 4 ? 2 : 4) {
    if constexpr (M % 4 == 0) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      v[i] = q.x, v[i + 1] = q.y, v[i + 2] = q.z, v[i + 3] = q.w;
    } else {
      const float2 q = *reinterpret_cast<const float2*>(p + i);
      v[i] = q.x, v[i + 1] = q.y;
    }
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Level L.. of a reduce-scatter of M values over the lanes g ^ (1 << L):
// the lanes with bit L of g set keep the upper half of the values they
// carry and send the lower half to their partner, which keeps the lower
// half; each adds what it receives.  Returns the index (in the array as it
// was) of the first value the lane ends with.  A template per level, so
// that every index is a constant and the values stay in registers.
template <int M, int L, int kLast>
__device__ __forceinline__ int scatter(float (&a)[M], int g) {
  if constexpr (L == kLast) {
    return 0;
  } else {
    constexpr int kHalf = M >> (L + 1);
    const bool hi = g & (1 << L);
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      const float send = hi ? a[i] : a[i + kHalf];
      const float keep = hi ? a[i + kHalf] : a[i];
      a[i] = keep + __shfl_xor_sync(0xffffffffu, send, 1 << L);
    }
    return (hi ? kHalf : 0) + scatter<M, L + 1, kLast>(a, g);
  }
}

template <typename T, int N, bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
mamba_scan_ring(const T* __restrict__ x, const T* __restrict__ dt, const float* __restrict__ A,
                const T* __restrict__ Bm, const T* __restrict__ C, const float* __restrict__ D,
                const float* __restrict__ s0, T* __restrict__ y, float* __restrict__ sT, int T_,
                int DI) {
  using S = Shape<T, N>;
  constexpr int CT = S::CT, kSteps = S::kSteps, VPL = S::VPL;
  constexpr int kLevels = ilog2(S::NL);                           // butterfly levels
  constexpr int kScatter = ilog2(kS) < kLevels ? ilog2(kS) : kLevels;  // halving levels
  constexpr int kHeld = kS >> kScatter;                           // sums a lane ends with
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int bi = blockIdx.y, c0 = blockIdx.x * CT;
  const int cl = tid / S::NL;  // channel in the tile
  const int g = tid % S::NL;   // which 4 state values of it
  const int ch = c0 + cl;
  const bool live = ch < DI;   // the ragged last tile
  const size_t xbase = static_cast<size_t>(bi) * T_ * DI;
  const size_t bbase = static_cast<size_t>(bi) * T_ * N;

  auto xs = [&](int st) { return reinterpret_cast<T*>(smem + (st % kStages) * S::kSlot); };
  auto dts = [&](int st) { return xs(st) + kSteps * CT; };
  auto bs = [&](int st) { return xs(st) + 2 * kSteps * CT; };
  auto cs = [&](int st) { return xs(st) + 2 * kSteps * CT + kSteps * N; };
  float* const bcf = reinterpret_cast<float*>(smem + kStages * S::kSlot);  // bf16: f32 B, C

  // stage st (steps st * kSteps ..) into ring slot st % kStages; past T and
  // past DI zeros
  auto issue = [&](int st) {
    const int t0 = st * kSteps;
    T *xd = xs(st), *dtd = dts(st), *bd = bs(st), *cd = cs(st);
    if constexpr (kVec) {
      constexpr int kPer = 16 / sizeof(T);  // elements per copy
      constexpr int kRow = CT / kPer;       // copies per step of x or dt
      for (int i = tid; i < kSteps * kRow; i += kThreads) {
        const int tt = i / kRow, col = c0 + i % kRow * kPer, t = t0 + tt;
        const bool ok = t < T_ && col < DI;
        const size_t off = ok ? xbase + static_cast<size_t>(t) * DI + col : 0;
        cp_async16(smem_addr(xd + i * kPer), x + off, ok);
        cp_async16(smem_addr(dtd + i * kPer), dt + off, ok);
      }
      // a stage's B (or C) rows are contiguous in (B, T, N)
      for (int i = tid; i < kSteps * N / kPer; i += kThreads) {
        const int e = t0 * N + i * kPer;
        const bool ok = e < T_ * N;
        cp_async16(smem_addr(bd + i * kPer), Bm + (ok ? bbase + e : 0), ok);
        cp_async16(smem_addr(cd + i * kPer), C + (ok ? bbase + e : 0), ok);
      }
    } else {
      for (int i = tid; i < kSteps * CT; i += kThreads) {
        const int tt = i / CT, col = c0 + i % CT, t = t0 + tt;
        const bool ok = t < T_ && col < DI;
        const size_t off = xbase + static_cast<size_t>(t) * DI + col;
        xd[i] = ok ? x[off] : from_f32<T>(0.f);
        dtd[i] = ok ? dt[off] : from_f32<T>(0.f);
      }
      for (int i = tid; i < kSteps * N; i += kThreads) {
        const bool ok = t0 * N + i < T_ * N;
        bd[i] = ok ? Bm[bbase + t0 * N + i] : from_f32<T>(0.f);
        cd[i] = ok ? C[bbase + t0 * N + i] : from_f32<T>(0.f);
      }
    }
  };
  // a bf16 stage's B and C rows to f32, once for the block
  auto convert = [&](int st) {
    if constexpr (sizeof(T) == 2) {
      const T *bsrc = bs(st), *csrc = cs(st);
      for (int i = tid; i < kSteps * N / 2; i += kThreads) {
        const __nv_bfloat162 b2 = reinterpret_cast<const __nv_bfloat162*>(bsrc)[i];
        const __nv_bfloat162 c2 = reinterpret_cast<const __nv_bfloat162*>(csrc)[i];
        reinterpret_cast<float2*>(bcf)[i] = __bfloat1622float2(b2);
        reinterpret_cast<float2*>(bcf + kSteps * N)[i] = __bfloat1622float2(c2);
      }
    }
  };

  const int n_st = (T_ + kSteps - 1) / kSteps;
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_st) issue(st);
    cp_async_commit();  // one group per stage, empty past the end
  }

  float h[VPL], a2[VPL];
  const size_t sbase = (static_cast<size_t>(bi) * DI + ch) * N + g * VPL;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    h[j] = live ? s0[sbase + j] : 0.f;
    a2[j] = live ? A[static_cast<size_t>(ch) * N + g * VPL + j] * kLog2e : 0.f;
  }
  const float dd = live ? D[ch] : 0.f;

  cp_async_wait<kStages - 2>();  // stage 0 has landed
  __syncthreads();
  convert(0);

  for (int st = 0; st < n_st; ++st) {
    __syncthreads();  // stage st's f32 B / C are written, slot (st - 1)'s y is stored
    if (st + kStages - 1 < n_st) issue(st + kStages - 1);
    cp_async_commit();
    const int t0 = st * kSteps, n = min(kSteps, T_ - t0);
    T* const xsl = xs(st);
    const T* const dsl = dts(st);
    const float* const bsl = sizeof(T) == 4 ? reinterpret_cast<const float*>(bs(st)) : bcf;
    const float* const csl =
        sizeof(T) == 4 ? reinterpret_cast<const float*>(cs(st)) : bcf + kSteps * N;
#pragma unroll 1
    for (int tt = 0; tt < n; tt += kS) {
      float acc[kS];  // this lane's part of C_t · h_t for the group's steps
#pragma unroll
      for (int u = 0; u < kS; ++u) {
        const int t = tt + u;
        const float xv = to_f32(xsl[t * CT + cl]), dv = to_f32(dsl[t * CT + cl]);
        float bv[VPL], cv[VPL];
        load_f32s(bsl + t * N + g * VPL, bv);
        load_f32s(csl + t * N + g * VPL, cv);
        const float dx = dv * xv;
#pragma unroll
        for (int j = 0; j < VPL; ++j) h[j] = fmaf(ex2(dv * a2[j]), h[j], dx * bv[j]);
        acc[u] = cv[0] * h[0];
#pragma unroll
        for (int j = 1; j < VPL; ++j) acc[u] = fmaf(cv[j], h[j], acc[u]);
      }
      // reduce-scatter over the channel's lanes (see scatter); past kScatter
      // levels each lane carries kHeld sums, and the levels left add them whole
      const int q = scatter<kS, 0, kScatter>(acc, g);  // acc[0] is acc[q] of before
#pragma unroll
      for (int l = kScatter; l < kLevels; ++l)
#pragma unroll
        for (int i = 0; i < kHeld; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 1 << l);
#pragma unroll
      for (int i = 0; i < kHeld; ++i) {
        const int t = tt + q + i;  // this lane's step: y over x's slot
        if ((g >> kScatter) == 0 && t < n)
          xsl[t * CT + cl] = from_f32<T>(fmaf(dd, to_f32(xsl[t * CT + cl]), acc[i]));
      }
    }
    cp_async_wait<kStages - 2>();  // stage st + 1 has landed
    __syncthreads();               // and stage st's y is written
    if constexpr (kVec) {  // rows of the tile's contiguous channels
      constexpr int kPer = 16 / sizeof(T), kRow = CT / kPer;
      for (int i = tid; i < n * kRow; i += kThreads) {
        const int tt = i / kRow, col = c0 + i % kRow * kPer;
        if (col < DI)
          *reinterpret_cast<uint4*>(y + xbase + static_cast<size_t>(t0 + tt) * DI + col) =
              *reinterpret_cast<const uint4*>(xsl + i * kPer);
      }
    } else {
      for (int i = tid; i < n * CT; i += kThreads) {
        const int tt = i / CT, col = c0 + i % CT;
        if (col < DI) y[xbase + static_cast<size_t>(t0 + tt) * DI + col] = xsl[i];
      }
    }
    if (st + 1 < n_st) convert(st + 1);
  }

  if (live) {
#pragma unroll
    for (int j = 0; j < VPL; ++j) sT[sbase + j] = h[j];
  }
}

template <typename T, int N, bool kVec>
cudaError_t launch(const void* x, const void* dt, const float* A, const void* Bm, const void* C,
                   const float* D, const float* s0, void* y, float* sT, int B, int T_, int DI,
                   cudaStream_t st) {
  using S = Shape<T, N>;
  cudaError_t err = allow_smem<mamba_scan_ring<T, N, kVec>>(S::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((DI + S::CT - 1) / S::CT, B);
  mamba_scan_ring<T, N, kVec><<<grid, kThreads, S::kSmem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), A, static_cast<const T*>(Bm),
      static_cast<const T*>(C), D, s0, static_cast<T*>(y), sT, T_, DI);
  return cudaGetLastError();
}

template <typename T, int N>
cudaError_t launch_v(const void* x, const void* dt, const float* A, const void* Bm, const void* C,
                     const float* D, const float* s0, void* y, float* sT, int B, int T_, int DI,
                     int ct, int steps, cudaStream_t st) {
  using S = Shape<T, N>;
  if (ct != S::CT || steps != S::kSteps) return cudaErrorInvalidValue;  // mamba_plan's tile
  // 16-byte copies need 16-byte aligned rows: the base pointers, DI's and N's
  const bool vec = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dt) |
                    reinterpret_cast<uintptr_t>(Bm) | reinterpret_cast<uintptr_t>(C) |
                    reinterpret_cast<uintptr_t>(y)) % 16 == 0 &&
                   DI * sizeof(T) % 16 == 0 && N * sizeof(T) % 16 == 0;
  return vec ? launch<T, N, true>(x, dt, A, Bm, C, D, s0, y, sT, B, T_, DI, st)
             : launch<T, N, false>(x, dt, A, Bm, C, D, s0, y, sT, B, T_, DI, st);
}

template <typename T>
cudaError_t launch_n(const void* x, const void* dt, const float* A, const void* Bm, const void* C,
                     const float* D, const float* s0, void* y, float* sT, int B, int T_, int DI,
                     int N, int ct, int steps, cudaStream_t st) {
  switch (N) {  // the CPU tests' state sizes, the reduced config's 8 and jamba's 16
    case 4: return launch_v<T, 4>(x, dt, A, Bm, C, D, s0, y, sT, B, T_, DI, ct, steps, st);
    case 8: return launch_v<T, 8>(x, dt, A, Bm, C, D, s0, y, sT, B, T_, DI, ct, steps, st);
    case 16: return launch_v<T, 16>(x, dt, A, Bm, C, D, s0, y, sT, B, T_, DI, ct, steps, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: x / dt / Bm / C / y.  A, D, the state and the final state are f32.
// N in {4, 8, 16}; B, T, DI >= 1; ct and steps (channels per block and steps
// per ring stage) as mamba_plan gives them; all tensors contiguous.
extern "C" int mamba_scan_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                              const void* C, const void* D, const void* s0, void* y, void* sT,
                              int dtype, int B, int T, int DI, int N, int ct, int steps,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || T < 1 || DI < 1 || B > 65535 || static_cast<long long>(T) * N > 0x7fffffff)
    return cudaErrorInvalidValue;
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(D);
  const float* s0f = static_cast<const float*>(s0);
  float* sTf = static_cast<float*>(sT);
  switch (dtype) {
    case kF32:
      return launch_n<float>(x, dt, Af, Bm, C, Df, s0f, y, sTf, B, T, DI, N, ct, steps, st);
    case kBF16:
      return launch_n<__nv_bfloat16>(x, dt, Af, Bm, C, Df, s0f, y, sTf, B, T, DI, N, ct, steps,
                                     st);
    default: return cudaErrorInvalidValue;
  }
}
