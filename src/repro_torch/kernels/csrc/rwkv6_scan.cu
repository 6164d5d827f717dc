// RWKV6 (Finch) WKV scan for Hopper (sm_90a):
//
//   out_t   = r_t · (S_t + diag(u) k_t v_tᵀ)
//   S_{t+1} = diag(w_t) S_t + k_t v_tᵀ
//
// r, k: (B, T, H, K) and v: (B, T, H, V) in f32 or bf16; w: (B, T, H, K) f32;
// u: (H, K) f32 or bf16; state: (B, H, K, V) f32 -> out (B, T, H, V) in r's
// dtype, final state (B, H, K, V) f32.  All arithmetic is f32.
//
// Replaces the Pallas TPU kernel repro/kernels/rwkv6_scan.py (rwkv6_scan,
// _rwkv6_kernel).  There the grid is (B, H, T/L) with the chunks innermost and
// sequential, the (K, V) state in VMEM scratch across the sweep, and each
// chunk's recurrence re-blocked into (L x L) and (L x K) matrix products for
// the MXU through an (L, L, K) tensor of pairwise decays.  Here time is a
// loop inside the block, and the kernel runs the plain serial recurrence:
// it needs no exponentials, where the closed form spends L²·K of them per
// head and chunk, and it matches the serial oracle to f32 rounding whatever
// `chunk` the caller passes.
//
// What bounds it: at the served prefill (B 1, T 512, H 64, K = V 64; r, k, v
// in bf16, w in f32) the work is ~27 MB (8.1 us at 3.35 TB/s) and ~3 f32
// operations per state element and step (~6 us at 67 TFLOP/s), but a serial
// scan meets neither: it is held by the instructions each step issues, and
// at B = 1 there are only 64 x 4096 state elements, 16 per lane of the card,
// so an SM runs 4 warps (one per scheduler) with no other warp to hide a
// stall behind.  Measured (tools/k6_variants.py): more warps per SM for the
// same work gain at most ~1.2x, and removing a part of the work (the column
// sums, the state update, the ring) removes time roughly in proportion to
// its instructions.  So the design cuts instructions per state element:
//
// * A register tile per thread: thread (kg, cg) holds rows kg*kKT .. +kKT-1
//   and columns cg*kVT .. +kVT-1 of one head's state for the whole sweep.
//   Each step reads kKT values of r, k and w (one 16-byte load of w, one
//   8-byte load each of bf16 r and k) and kVT of v, and each value serves a
//   row or a column of the tile, not one element.
// * The bonus factored out: out_t[v] = Σ_k r_k S[k,v] + v_t[v] Σ_k r_k u_k k_k.
//   A thread starts its column sums at v · (its rows' part of Σ r u k), so
//   the state costs 3 FP operations per element and step (k·v, the decayed
//   update, r·S) instead of 4.
// * The K sum of a column is spread over G = K / kKT lanes of one warp.  The
//   sums of kU steps are reduced together, by a reduce-scatter butterfly
//   (scatter): at K = 64, 32 values over 16 lanes take 30 shuffles, the first
//   16 independent, and leave each lane two finished outputs, where a step
//   at a time takes a chain of 5 shuffles for its 4.  Every index is a compile-time
//   constant (a template per level), so the sums stay in registers, and the
//   block is whole warps, so every shuffle takes the full mask.
// * The inputs go through a kStages-deep ring of kSteps-step stages in
//   shared memory, filled by cp.async (16-byte copies, zero-filled past V
//   and past T, where w is 1 so that a step there leaves the state as it
//   is and needs no branch) kStages - 1 stages ahead of the one in use: no
//   registers hold staged values, and one barrier per stage is all the
//   block waits on.
// * A grid that fills the card: one block per (batch, head, tile of vb
//   columns); scan_plan (kernels/rwkv6_scan.py) takes the widest vb of 64,
//   32 and 16 that gives whole warps and still gives the card's SMs a block
//   each.  r, k and w are read in their (B, T, H, K) layout with its strides
//   (no transposed copies); each column tile of a head stages the head's r,
//   k and w again, from L2 when the tiles run together.
//
// A view off a 16-byte boundary, or a V whose rows are not a multiple of 16
// bytes, takes the same kernel with element-wise loads into the ring
// (kVec = false).
#include <cstdint>

#include "mma.cuh"

namespace {

constexpr int kKT = 4;        // state rows a thread holds
constexpr int kVT = 4;        // state columns a thread holds
constexpr int kU = 8;         // time steps whose column sums are reduced together
constexpr int kSteps = 32;    // time steps per ring stage
constexpr int kStages = 3;    // ring depth
constexpr int kMaxThreads = 256;  // (K / kKT) x (vb / kVT) at K = vb = 64

__host__ __device__ constexpr int ilog2(int x) { return x <= 1 ? 0 : 1 + ilog2(x / 2); }

// N (even) consecutive values in shared memory -> f32, in 16-, 8- or 4-byte loads;
// a bf16 is the top half of the f32 with the same bits
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float (&x)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      x[i] = q.x, x[i + 1] = q.y, x[i + 2] = q.z, x[i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 q = *reinterpret_cast<const float2*>(p + i);
      x[i] = q.x, x[i + 1] = q.y;
    }
  }
}
__device__ __forceinline__ float bf16_lo(uint32_t q) { return __uint_as_float(q << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t q) { return __uint_as_float(q & 0xffff0000u); }
template <int N>
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p, float (&x)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const uint2 q = *reinterpret_cast<const uint2*>(p + i);
      x[i] = bf16_lo(q.x), x[i + 1] = bf16_hi(q.x), x[i + 2] = bf16_lo(q.y),
      x[i + 3] = bf16_hi(q.y);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const uint32_t q = *reinterpret_cast<const uint32_t*>(p + i);
      x[i] = bf16_lo(q), x[i + 1] = bf16_hi(q);
    }
  }
}

// Level L.. of a reduce-scatter of N values over the lanes kg ^ (1 << L):
// the lanes with bit L of kg set keep the upper half of the values they
// carry and send the lower half to their partner, which keeps the lower
// half; each adds what it receives.  Returns the index (in the array as it
// was) of the first value the lane ends with.  A template per level, so
// that every index is a constant and the values stay in registers.
template <int N, int L, int kLast>
__device__ __forceinline__ int scatter(float (&a)[N], int kg) {
  if constexpr (L == kLast) {
    return 0;
  } else {
    constexpr int kHalf = N >> (L + 1);
    const bool hi = kg & (1 << L);
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      const float send = hi ? a[i] : a[i + kHalf];
      const float keep = hi ? a[i + kHalf] : a[i];
      a[i] = keep + __shfl_xor_sync(0xffffffffu, send, 1 << L);
    }
    return (hi ? kHalf : 0) + scatter<N, L + 1, kLast>(a, kg);
  }
}

// One slot of the ring: r, k (kSteps x K of T), w (kSteps x K f32) and the
// block's v columns (kSteps x vb of T), each part a multiple of 16 bytes.
template <typename T>
struct Slot {
  T* r;
  T* k;
  float* w;
  T* v;
};

template <typename T, int K, bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
rwkv6_scan_tiled(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ w, const void* __restrict__ u,
                  const float* __restrict__ s0, T* __restrict__ out, float* __restrict__ sT,
                  int T_, int H, int V, bool u_bf16) {
  constexpr int G = K / kKT;                    // threads that share a column's K sum
  constexpr int kLevels = ilog2(G);             // butterfly levels over them
  constexpr int kN = kU * kVT;                  // column sums reduced together
  constexpr int kScatter = ilog2(kN) < kLevels ? ilog2(kN) : kLevels;  // halving levels
  constexpr int kHeld = kN >> kScatter;         // sums a lane holds after them
  static_assert(K % kKT == 0 && 32 % G == 0 && kKT % 4 == 0 && kVT % 2 == 0, "tile");
  static_assert(kSteps % kU == 0 && (kN & (kN - 1)) == 0, "steps");
  extern __shared__ __align__(16) unsigned char smem[];

  const int nth = blockDim.x;
  const int vb = nth / G * kVT;                 // columns per block
  constexpr int kRK = kSteps * K * sizeof(T);  // bytes of r or k in a slot
  const int slot_bytes = 2 * kRK + kSteps * K * 4 + kSteps * vb * static_cast<int>(sizeof(T));
  auto slot = [&](int st) {
    unsigned char* p = smem + (st % kStages) * slot_bytes;
    return Slot<T>{reinterpret_cast<T*>(p), reinterpret_cast<T*>(p + kRK),
                   reinterpret_cast<float*>(p + 2 * kRK),
                   reinterpret_cast<T*>(p + 2 * kRK + kSteps * K * 4)};
  };
  const int bh = blockIdx.y;                    // b * H + h
  const int b = bh / H, h = bh % H;
  const int v0 = blockIdx.x * vb;
  const int tid = threadIdx.x;
  const int kg = tid % G;                       // rows kg * kKT ..
  const int c0 = tid / G * kVT;                 // columns v0 + c0 ..

  const size_t krow = static_cast<size_t>(H) * K;  // between time steps of r / k / w
  const size_t vrow = static_cast<size_t>(H) * V;  // between time steps of v / out
  const size_t kbase = static_cast<size_t>(b) * T_ * krow + static_cast<size_t>(h) * K;
  const size_t vbase = static_cast<size_t>(b) * T_ * vrow + static_cast<size_t>(h) * V;

  // stage st (steps st * kSteps ..) into ring slot st % kStages
  auto issue = [&](int st) {
    const int t0 = st * kSteps;
    const Slot<T> sl = slot(st);
    T *rs = sl.r, *ks = sl.k, *vs = sl.v;
    float* ws = sl.w;
    if constexpr (kVec) {
      constexpr int kPer = 16 / sizeof(T);       // elements per 16-byte copy
      constexpr int kC = K / kPer, kCW = K / 4;  // copies per row of r / k and of w
      for (int i = tid; i < kSteps * kC; i += nth) {
        const int tt = i / kC, c = i % kC, t = t0 + tt;
        const bool ok = t < T_;
        const size_t off = kbase + (ok ? t : 0) * krow + c * kPer;
        cp_async16(smem_addr(rs + tt * K + c * kPer), r + off, ok);
        cp_async16(smem_addr(ks + tt * K + c * kPer), k + off, ok);
      }
      for (int i = tid; i < kSteps * kCW; i += nth) {
        const int tt = i / kCW, c = i % kCW, t = t0 + tt;
        if (t < T_)
          cp_async16(smem_addr(ws + tt * K + c * 4), w + kbase + t * krow + c * 4, true);
        else
          *reinterpret_cast<float4*>(ws + tt * K + c * 4) = make_float4(1.f, 1.f, 1.f, 1.f);
      }
      const int cv = vb / kPer;
      for (int i = tid; i < kSteps * cv; i += nth) {
        const int tt = i / cv, c = i % cv, t = t0 + tt, col = v0 + c * kPer;
        const bool ok = t < T_ && col < V;
        cp_async16(smem_addr(vs + tt * vb + c * kPer), v + (ok ? vbase + t * vrow + col : 0), ok);
      }
    } else {
      for (int i = tid; i < kSteps * K; i += nth) {
        const int tt = i / K, c = i % K, t = t0 + tt;
        const bool ok = t < T_;
        const size_t off = kbase + static_cast<size_t>(t) * krow + c;
        rs[i] = ok ? r[off] : from_f32<T>(0.f);
        ks[i] = ok ? k[off] : from_f32<T>(0.f);
        ws[i] = ok ? w[off] : 1.f;
      }
      for (int i = tid; i < kSteps * vb; i += nth) {
        const int tt = i / vb, c = i % vb, t = t0 + tt;
        const bool ok = t < T_ && v0 + c < V;
        vs[i] = ok ? v[vbase + static_cast<size_t>(t) * vrow + v0 + c] : from_f32<T>(0.f);
      }
    }
  };

  const int n_st = (T_ + kSteps - 1) / kSteps;
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_st) issue(st);
    cp_async_commit();  // one group per stage, empty past the end
  }

  float s[kKT][kVT], uk[kKT];
  const float* s0p = s0 + static_cast<size_t>(bh) * K * V;
#pragma unroll
  for (int j = 0; j < kKT; ++j) {
    const int row = kg * kKT + j;
    uk[j] = u_bf16 ? to_f32(static_cast<const __nv_bfloat16*>(u)[h * K + row])
                   : static_cast<const float*>(u)[h * K + row];
#pragma unroll
    for (int i = 0; i < kVT; ++i) {
      const int vc = v0 + c0 + i;
      s[j][i] = vc < V ? s0p[static_cast<size_t>(row) * V + vc] : 0.f;
    }
  }

  // kU time steps from ring slot sl, the first at stage step tt0: their
  // state updates, and acc[u * kVT + i], this thread's part of column c0 + i
  // of the u-th one's output.  Past T the ring holds r = k = v = 0 and
  // w = 1, which leave the state as it is, so only the stores look at T.
  auto column_sums = [&](const Slot<T>& sl, int tt0, float (&acc)[kN]) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int tt = tt0 + u;
      float rr[kKT], kk[kKT], ww[kKT], vv[kVT];
      load_f32(sl.r + tt * K + kg * kKT, rr);
      load_f32(sl.k + tt * K + kg * kKT, kk);
      load_f32(sl.w + tt * K + kg * kKT, ww);
      load_f32(sl.v + tt * vb + c0, vv);
      float p = 0.f;  // this thread's rows of Σ_k r_k u_k k_k
#pragma unroll
      for (int j = 0; j < kKT; ++j) p = fmaf(rr[j] * kk[j], uk[j], p);
#pragma unroll
      for (int i = 0; i < kVT; ++i) acc[u * kVT + i] = p * vv[i];
#pragma unroll
      for (int j = 0; j < kKT; ++j)
#pragma unroll
        for (int i = 0; i < kVT; ++i) acc[u * kVT + i] = fmaf(rr[j], s[j][i], acc[u * kVT + i]);
#pragma unroll
      for (int j = 0; j < kKT; ++j)
#pragma unroll
        for (int i = 0; i < kVT; ++i) s[j][i] = fmaf(ww[j], s[j][i], kk[j] * vv[i]);
    }
  };
  // acc of kU steps from time t0 reduced over kg and stored
  auto reduce_store = [&](float (&acc)[kN], int t0) {
    // reduce-scatter over kg (see scatter); past kScatter levels each lane
    // carries kHeld values, and the levels left add them whole
    const int q = scatter<kN, 0, kScatter>(acc, kg);  // acc[0] is acc[q] of before
#pragma unroll
    for (int l = kScatter; l < kLevels; ++l)
#pragma unroll
      for (int i = 0; i < kHeld; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 1 << l);
#pragma unroll
    for (int i = 0; i < kHeld; ++i) {
      const int t = t0 + (q + i) / kVT, vc = v0 + c0 + (q + i) % kVT;
      if ((kg >> kScatter) == 0 && t < T_ && vc < V)
        out[vbase + static_cast<size_t>(t) * vrow + vc] = from_f32<T>(acc[i]);
    }
  };

  for (int st = 0; st < n_st; ++st) {
    cp_async_wait<kStages - 2>();  // this thread's copies of stage st have landed
    __syncthreads();               // everyone's have, and slot (st - 1) is free
    if (st + kStages - 1 < n_st) issue(st + kStages - 1);
    cp_async_commit();
    const int t0 = st * kSteps, n = min(kSteps, T_ - t0);
    const Slot<T> sl = slot(st);
#pragma unroll 1
    for (int tt = 0; tt < n; tt += kU) {
      float acc[kN];
      column_sums(sl, tt, acc);
      reduce_store(acc, t0 + tt);
    }
  }

  float* sTp = sT + static_cast<size_t>(bh) * K * V;
#pragma unroll
  for (int j = 0; j < kKT; ++j)
#pragma unroll
    for (int i = 0; i < kVT; ++i) {
      const int vc = v0 + c0 + i;
      if (vc < V) sTp[static_cast<size_t>(kg * kKT + j) * V + vc] = s[j][i];
    }
}

template <typename T, int K, bool kVec>
cudaError_t launch(const void* r, const void* k, const void* v, const float* w, const void* u,
                   bool u_bf16, const float* s0, void* out, float* sT, int B, int T_, int H, int V,
                   int vb, cudaStream_t st) {
  const int threads = K / kKT * (vb / kVT);
  const int smem = kStages * kSteps * (K * (2 * static_cast<int>(sizeof(T)) + 4) +
                                       vb * static_cast<int>(sizeof(T)));
  // whole warps only: every shuffle takes the full mask (a runtime mask
  // costs a convergence check and a divergent fallback on each)
  if (threads % 32 || threads > kMaxThreads || vb % kVT || vb * sizeof(T) % 16)
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem<rwkv6_scan_tiled<T, K, kVec>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((V + vb - 1) / vb, B * H);
  rwkv6_scan_tiled<T, K, kVec><<<grid, threads, smem, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), w, u, s0,
      static_cast<T*>(out), sT, T_, H, V, u_bf16);
  return cudaGetLastError();
}

template <typename T, bool kVec>
cudaError_t launch_k(const void* r, const void* k, const void* v, const float* w, const void* u,
                     bool u_bf16, const float* s0, void* out, float* sT, int B, int T_, int H,
                     int K, int V, int vb, cudaStream_t st) {
  switch (K) {  // the CPU tests' head sizes and rwkv6-7b's
    case 8: return launch<T, 8, kVec>(r, k, v, w, u, u_bf16, s0, out, sT, B, T_, H, V, vb, st);
    case 16: return launch<T, 16, kVec>(r, k, v, w, u, u_bf16, s0, out, sT, B, T_, H, V, vb, st);
    case 64: return launch<T, 64, kVec>(r, k, v, w, u, u_bf16, s0, out, sT, B, T_, H, V, vb, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_t(const void* r, const void* k, const void* v, const float* w, const void* u,
                     bool u_bf16, const float* s0, void* out, float* sT, int B, int T_, int H,
                     int K, int V, int vb, cudaStream_t st) {
  // 16-byte copies need 16-byte aligned rows: the base pointers, and V's
  // (K's rows are 16 to 256 bytes at every K instance)
  const bool vec = (reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(w)) % 16 == 0 &&
                   V * sizeof(T) % 16 == 0;
  return vec ? launch_k<T, true>(r, k, v, w, u, u_bf16, s0, out, sT, B, T_, H, K, V, vb, st)
             : launch_k<T, false>(r, k, v, w, u, u_bf16, s0, out, sT, B, T_, H, K, V, vb, st);
}

}  // namespace

// dtype: r / k / v / out; u_dtype: u (f32 or bf16, read as it is).  w, the
// state and the final state are f32.  K in {8, 16, 64}; B, T, H, V >= 1; vb
// (columns per block, from scan_plan) a multiple of 4 whose row of T is a
// multiple of 16 bytes and which gives the block a whole number of warps;
// all tensors contiguous.
extern "C" int rwkv6_scan_fwd(const void* r, const void* k, const void* v, const void* w,
                              const void* u, const void* s0, void* out, void* sT, int dtype,
                              int u_dtype, int B, int T, int H, int K, int V, int vb,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || T < 1 || H < 1 || V < 1 || vb < 1 || static_cast<long long>(B) * H > 65535 ||
      (u_dtype != kF32 && u_dtype != kBF16))
    return cudaErrorInvalidValue;
  const bool u_bf16 = u_dtype == kBF16;
  const float* wf = static_cast<const float*>(w);
  const float* s0f = static_cast<const float*>(s0);
  float* sTf = static_cast<float*>(sT);
  switch (dtype) {
    case kF32: return launch_t<float>(r, k, v, wf, u, u_bf16, s0f, out, sTf, B, T, H, K, V, vb, st);
    case kBF16:
      return launch_t<__nv_bfloat16>(r, k, v, wf, u, u_bf16, s0f, out, sTf, B, T, H, K, V, vb,
                                     st);
    default: return cudaErrorInvalidValue;
  }
}
