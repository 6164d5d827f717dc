// Decode attention for Hopper (sm_90a): one new query token per sequence
// against a KV cache whose slots carry absolute positions (full cache or
// sliding-window ring buffer), GQA, tanh softcap, f32 online softmax.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (decode_attention, _decode_kernel).  There a sequential grid axis walks
// cache blocks with m / l / acc in VMEM scratch; here one thread block owns
// (batch row, KV head) and walks the cache in 64-slot tiles in a loop.  All
// G = Hq / Hkv query rows of the KV head share each tile read into shared
// memory (G = 7 for qwen2-0.5b; any G up to kMaxG, not only powers of two).
//
// A slot is live iff 0 <= pos <= cur and (no window or pos > cur - window),
// exactly the Pallas kernel's mask; a tile with no live slot is skipped
// before its K/V are read.
//
// Layout: q (B, Hq, D), k / v cache (B, S, Hkv, D), pos_ids (B, S) int32,
// cur_pos (B,) int32, out (B, Hq, D), all contiguous.
//
// Head dims 8..128.  The tile is 64 slots up to D = 64 and 32 slots at
// D = 128, which keeps q, K, V and the scores under 48 KB of static shared
// memory (42.5 KB at D = 128).
//
// What bounds it: reading the cache (~4 MB at batch 8, 1024 slots, 2 KV
// heads, D = 64, bf16; ~67 MB at 16 KV heads, D = 128) is the whole cost,
// so the card's bound is memory.
// This first version runs B * Hkv blocks (16 at batch 8 on 132 SMs) with
// unpipelined tile loads, so it is bound by the few SMs it occupies and by
// load latency; the split-KV (acc, m, l) combine is the known fix.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;   // query rows per KV head

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const int* __restrict__ pos_ids, const int* __restrict__ cur_pos,
              T* __restrict__ o, int S, int Hq, int Hkv, int window, float softcap, float scale) {
  constexpr int kTile = D <= 64 ? 64 : 32;  // cache slots per tile: <= 48 KB of smem
  constexpr int kPer = kTile / 32;          // slots per lane in the softmax step
  constexpr int kMaxE = (kMaxG * D + kThreads - 1) / kThreads;  // acc elements per thread
  __shared__ float qs[kMaxG][D];
  __shared__ float ks[kTile][D + 1];  // +1: conflict-free column walk in the score step
  __shared__ float vs[kTile][D];
  __shared__ float ps[kMaxG][kTile];  // scores, then probabilities
  __shared__ float m_s[kMaxG], l_s[kMaxG], corr_s[kMaxG];
  __shared__ int live_s[kTile];

  const int hk = blockIdx.x, b = blockIdx.y;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int cur = cur_pos[b];

  for (int idx = tid; idx < G * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    qs[g][d] = to_f32(q[(static_cast<size_t>(b) * Hq + hk * G + g) * D + d]) * scale;
  }
  if (tid < kMaxG) {
    m_s[tid] = REPRO_NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[kMaxE];
#pragma unroll
  for (int u = 0; u < kMaxE; ++u) acc[u] = 0.f;

  for (int s0 = 0; s0 < S; s0 += kTile) {
    const int n = min(kTile, S - s0);
    __syncthreads();  // previous tile consumed (and q / m / l stored on the first)
    int live = 0;
    if (tid < kTile) {
      const int p = tid < n ? pos_ids[static_cast<size_t>(b) * S + s0 + tid] : -1;
      bool ok = p >= 0 && p <= cur;
      if (window >= 0) ok = ok && p > cur - window;
      live_s[tid] = ok;
      live = ok;
    }
    if (!__syncthreads_or(live)) continue;  // block-uniform: no live slot in this tile

    for (int idx = tid; idx < kTile * D; idx += kThreads) {
      const int j = idx / D, d = idx % D;
      float kv = 0.f, vv = 0.f;
      if (j < n) {
        const size_t off = ((static_cast<size_t>(b) * S + s0 + j) * Hkv + hk) * D + d;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    __syncthreads();

    // scores: one (row, slot) pair per thread and step
    for (int idx = tid; idx < G * kTile; idx += kThreads) {
      const int g = idx / kTile, j = idx % kTile;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s += qs[g][d] * ks[j][d];
      if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
      ps[g][j] = live_s[j] ? s : REPRO_NEG_INF;
    }
    __syncthreads();

    // online softmax: one warp per query row
    for (int g = warp; g < G; g += kWarps) {
      float x[kPer];
      float mx = REPRO_NEG_INF;
#pragma unroll
      for (int t = 0; t < kPer; ++t) {
        x[t] = ps[g][lane + 32 * t];
        mx = fmaxf(mx, x[t]);
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < kPer; ++t) {
        const float p = expf(x[t] - m_new);
        ps[g][lane + 32 * t] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        corr_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc (G x D) update: one element per thread and step
#pragma unroll
    for (int u = 0; u < kMaxE; ++u) {
      const int e = tid + u * kThreads;
      if (e < G * D) {
        const int g = e / D, d = e % D;
        float a = acc[u] * corr_s[g];
#pragma unroll 16
        for (int j = 0; j < kTile; ++j) a += ps[g][j] * vs[j][d];
        acc[u] = a;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int u = 0; u < kMaxE; ++u) {
    const int e = tid + u * kThreads;
    if (e < G * D) {
      const int g = e / D, d = e % D;
      o[(static_cast<size_t>(b) * Hq + hk * G + g) * D + d] =
          from_f32<T>(acc[u] / fmaxf(l_s[g], 1e-30f));
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* pos,
                   const void* cur, void* o, int B, int S, int Hq, int Hkv, int window,
                   float softcap, float scale, cudaStream_t stream) {
  decode_kernel<T, D><<<dim3(Hkv, B), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(pos), static_cast<const int*>(cur), static_cast<T*>(o), S, Hq,
      Hkv, window, softcap, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, const void* pos,
                     const void* cur, void* o, int B, int S, int Hq, int Hkv, int window,
                     float softcap, float scale, cudaStream_t st) {
  switch (D) {
    case 8: return launch<T, 8>(q, k, v, pos, cur, o, B, S, Hq, Hkv, window, softcap, scale, st);
    case 16: return launch<T, 16>(q, k, v, pos, cur, o, B, S, Hq, Hkv, window, softcap, scale, st);
    case 32: return launch<T, 32>(q, k, v, pos, cur, o, B, S, Hq, Hkv, window, softcap, scale, st);
    case 64: return launch<T, 64>(q, k, v, pos, cur, o, B, S, Hq, Hkv, window, softcap, scale, st);
    case 128: return launch<T, 128>(q, k, v, pos, cur, o, B, S, Hq, Hkv, window, softcap, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// window < 0: no sliding window.  softcap <= 0: no softcap.
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* pos_ids, const void* cur_pos, void* o, int dtype,
                                    int B, int S, int Hq, int Hkv, int D, int window,
                                    float softcap, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Hq % Hkv != 0 || Hq / Hkv > kMaxG) return cudaErrorInvalidValue;
  switch (dtype) {
    case kF32: return launch_d<float>(D, q, k, v, pos_ids, cur_pos, o, B, S, Hq, Hkv, window, softcap, scale, st);
    case kBF16: return launch_d<__nv_bfloat16>(D, q, k, v, pos_ids, cur_pos, o, B, S, Hq, Hkv, window, softcap, scale, st);
    default: return cudaErrorInvalidValue;
  }
}
