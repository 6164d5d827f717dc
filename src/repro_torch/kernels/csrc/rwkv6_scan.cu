// RWKV6 (Finch) WKV scan for Hopper (sm_90a):
//
//   out_t   = r_t · (S_t + diag(u) k_t v_tᵀ)
//   S_{t+1} = diag(w_t) S_t + k_t v_tᵀ
//
// r, k: (B, T, H, K) and v: (B, T, H, V) in f32 or bf16; w: (B, T, H, K) f32;
// u: (H, K) f32; state: (B, H, K, V) f32 -> out (B, T, H, V) in r's dtype,
// final state (B, H, K, V) f32.  All arithmetic is f32.
//
// Replaces the Pallas TPU kernel repro/kernels/rwkv6_scan.py (rwkv6_scan,
// _rwkv6_kernel).  There the grid is (B, H, T/L) with the chunks innermost and
// sequential, the (K, V) state in VMEM scratch across the sweep, and each
// chunk's recurrence re-blocked into (L x L) and (L x K) matrix products for
// the MXU through an (L, L, K) tensor of pairwise decays.  A CUDA grid has no
// sequential axis, so time becomes a loop inside the block.  Each value
// column of the state evolves on its own (out_t[v] reads only S[:, v]), so
// one block owns one (batch, head, 16-column V tile) and no two blocks share
// anything: at B = 1 and 64 heads of 64 that is 256 blocks for 132 SMs.
//
// Inside a block, 8 lanes share one column: lane group g holds the state rows
// k = j * 8 + g (j < K / 8) of that column in registers for the whole sweep,
// so the state never goes back to memory until the end.  Per step a lane
// updates its K / 8 state values with one FMA each, and the 8 lanes of the
// column sum r_t · (S + u k v) with three shuffles.  The kernel runs the
// plain serial recurrence, not the chunked closed form: it needs no
// exponentials at all, where the closed form spends L²·K of them per head and
// chunk, and it matches the serial oracle to f32 rounding whatever `chunk`
// the caller passes.
//
// r, k and w are read in their (B, T, H, K) layout with its strides (no
// transposed copies): a pass stages TT time steps of the head's r, k, w rows
// and of the tile's v columns in shared memory, converted to f32, and the
// block then walks those steps.  The next pass's values are loaded into
// registers while the block walks the current one, so the loads' latency
// hides behind the recurrence.  Each V tile of a head re-reads the head's
// r, k and w, from L2 when the tiles run together.
//
// What bounds it: at the served prefill shape (B 1, T 512, H 64, K = V 64;
// r, k, v in bf16, w in f32) it must move ~27.3 MB (8.1 us at 3.35 TB/s) and
// do 4·K·V f32 operations per step and head, 0.54 GFLOP (8.0 us at
// 67 TFLOP/s off the tensor cores).  The serial loop is bound instead by its
// own latency: each step's FMA chain and shuffles wait on the previous
// step's, with two to four warps per scheduler to hide it.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kKG = 8;                        // lanes that split one column's K sum
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kColsPerWarp = 32 / kKG;        // 4
constexpr int kVT = kWarps * kColsPerWarp;    // 16 value columns per block

// One pass's inputs, staged through registers: each thread holds kPer of the
// TT x K values of r, k and w and kPerV of the TT x kVT values of v, in their
// own types.  Steps past T and columns past V read as zero.
template <typename T, int K, int TT>
struct Stage {
  static constexpr int kPer = TT * K / kThreads;
  static constexpr int kPerV = TT * kVT / kThreads;
  static_assert(TT * K % kThreads == 0 && TT * kVT % kThreads == 0, "pass must split");
  T r[kPer], k[kPer], v[kPerV];
  float w[kPer];

  __device__ __forceinline__ void load(const T* rg, const T* kg, const float* wg, const T* vg,
                                       size_t kbase, size_t krow, size_t vbase, size_t vrow,
                                       int t0, int T_, int v0, int V) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = threadIdx.x + i * kThreads, tt = idx / K, kk = idx % K;
      const bool ok = t0 + tt < T_;
      const size_t off = kbase + static_cast<size_t>(t0 + tt) * krow + kk;
      r[i] = ok ? rg[off] : from_f32<T>(0.f);
      k[i] = ok ? kg[off] : from_f32<T>(0.f);
      w[i] = ok ? wg[off] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kPerV; ++i) {
      const int idx = threadIdx.x + i * kThreads, tt = idx / kVT, c = idx % kVT;
      const bool ok = t0 + tt < T_ && v0 + c < V;
      v[i] = ok ? vg[vbase + static_cast<size_t>(t0 + tt) * vrow + v0 + c] : from_f32<T>(0.f);
    }
  }

  __device__ __forceinline__ void store(float (*r_s)[K], float (*k_s)[K], float (*w_s)[K],
                                        float (*v_s)[kVT]) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = threadIdx.x + i * kThreads, tt = idx / K, kk = idx % K;
      r_s[tt][kk] = to_f32(r[i]);
      k_s[tt][kk] = to_f32(k[i]);
      w_s[tt][kk] = w[i];
    }
#pragma unroll
    for (int i = 0; i < kPerV; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      v_s[idx / kVT][idx % kVT] = to_f32(v[i]);
    }
  }
};

template <typename T, int KPT>
__global__ void __launch_bounds__(kThreads)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ w, const float* __restrict__ u,
                  const float* __restrict__ s0, T* __restrict__ out, float* __restrict__ sT,
                  int T_, int H, int V) {
  constexpr int K = KPT * kKG;
  constexpr int TT = 2048 / K > 64 ? 64 : 2048 / K;  // steps per pass: <= 24 KB of r / k / w
  __shared__ float r_s[TT][K], k_s[TT][K], w_s[TT][K], v_s[TT][kVT];

  const int bh = blockIdx.y;  // b * H + h
  const int b = bh / H, h = bh % H;
  const int v0 = blockIdx.x * kVT;
  const int lane = threadIdx.x % 32;
  const int kg = lane % kKG;
  const int col = (threadIdx.x / 32) * kColsPerWarp + lane / kKG;  // column in the tile
  const int vc = v0 + col;
  const bool live = vc < V;  // the ragged last tile

  const size_t krow = static_cast<size_t>(H) * K;  // between time steps of r / k / w
  const size_t vrow = static_cast<size_t>(H) * V;  // between time steps of v / out
  const size_t kbase = static_cast<size_t>(b) * T_ * krow + static_cast<size_t>(h) * K;
  const size_t vbase = static_cast<size_t>(b) * T_ * vrow + static_cast<size_t>(h) * V;
  Stage<T, K, TT> stage;
  stage.load(r, k, w, v, kbase, krow, vbase, vrow, 0, T_, v0, V);

  float s[KPT], uk[KPT];
  const float* s0p = s0 + static_cast<size_t>(bh) * K * V;
#pragma unroll
  for (int j = 0; j < KPT; ++j) {
    const int kk = j * kKG + kg;
    s[j] = live ? s0p[static_cast<size_t>(kk) * V + vc] : 0.f;
    uk[j] = u[h * K + kk];
  }

  for (int t0 = 0; t0 < T_; t0 += TT) {
    __syncthreads();  // every lane is done with the previous pass's tiles
    stage.store(r_s, k_s, w_s, v_s);
    __syncthreads();
    // the next pass's loads are in flight while this pass runs
    if (t0 + TT < T_) stage.load(r, k, w, v, kbase, krow, vbase, vrow, t0 + TT, T_, v0, V);
    const int nt = min(TT, T_ - t0);
    for (int tt = 0; tt < nt; ++tt) {
      const float vt = v_s[tt][col];
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int kk = j * kKG + kg;  // 8 lanes read 8 consecutive words: no bank conflict
        const float kv = k_s[tt][kk] * vt;
        acc = fmaf(r_s[tt][kk], fmaf(uk[j], kv, s[j]), acc);
        s[j] = fmaf(w_s[tt][kk], s[j], kv);
      }
#pragma unroll
      for (int off = kKG / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (kg == 0 && live) out[vbase + static_cast<size_t>(t0 + tt) * vrow + vc] = from_f32<T>(acc);
    }
  }

  if (live) {
    float* sTp = sT + static_cast<size_t>(bh) * K * V;
#pragma unroll
    for (int j = 0; j < KPT; ++j) sTp[static_cast<size_t>(j * kKG + kg) * V + vc] = s[j];
  }
}

template <typename T, int KPT>
cudaError_t launch(const void* r, const void* k, const void* v, const float* w, const float* u,
                   const float* s0, void* out, float* sT, int B, int T_, int H, int V,
                   cudaStream_t st) {
  const dim3 grid((V + kVT - 1) / kVT, B * H);
  rwkv6_scan_kernel<T, KPT><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), w, u, s0,
      static_cast<T*>(out), sT, T_, H, V);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_k(const void* r, const void* k, const void* v, const float* w, const float* u,
                     const float* s0, void* out, float* sT, int B, int T_, int H, int K, int V,
                     cudaStream_t st) {
  switch (K) {  // the CPU tests' head sizes and rwkv6-7b's
    case 8: return launch<T, 1>(r, k, v, w, u, s0, out, sT, B, T_, H, V, st);
    case 16: return launch<T, 2>(r, k, v, w, u, s0, out, sT, B, T_, H, V, st);
    case 64: return launch<T, 8>(r, k, v, w, u, s0, out, sT, B, T_, H, V, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: r / k / v / out.  w, u, state and the final state are f32.
// K in {8, 16, 64}; B, T, H, V >= 1; all tensors contiguous.
extern "C" int rwkv6_scan_fwd(const void* r, const void* k, const void* v, const void* w,
                              const void* u, const void* s0, void* out, void* sT, int dtype,
                              int B, int T, int H, int K, int V, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || T < 1 || H < 1 || V < 1 || static_cast<long long>(B) * H > 65535)
    return cudaErrorInvalidValue;
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  const float* s0f = static_cast<const float*>(s0);
  float* sTf = static_cast<float*>(sT);
  switch (dtype) {
    case kF32: return launch_k<float>(r, k, v, wf, uf, s0f, out, sTf, B, T, H, K, V, st);
    case kBF16: return launch_k<__nv_bfloat16>(r, k, v, wf, uf, s0f, out, sTf, B, T, H, K, V, st);
    default: return cudaErrorInvalidValue;
  }
}
