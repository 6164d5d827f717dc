// Flash attention forward for Hopper (sm_90a): causal / sliding window /
// q_offset / tanh softcap / GQA, f32 online softmax.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention, _fa_kernel).  That kernel walks KV blocks along a
// sequential grid axis and carries m / l / acc in VMEM scratch; here one
// thread block owns (batch, q head, q tile of 64 rows, or 32 at D = 128) and
// walks the KV tiles in a loop, carrying m / l / acc in registers.
//
// Layout: q (B, Sq, Hq, D), k / v (B, Sk, Hkv, D), out (B, Sq, Hq, D), all
// contiguous.  Query head h reads KV head h / (Hq / Hkv).
//
// Threads: 256 per block, TPR = 4 per q row up to D = 64 and 8 at D = 128
// (so a thread holds 16 q and 16 acc values, not 32, and nothing spills).
// Thread g of a row owns the dims VW*(g + TPR*i) .. +VW-1, so the threads of
// a row read neighbouring words of a K/V row in shared memory and a warp
// reads TPR vectors at once (no bank conflicts; the rows of a warp share
// them by broadcast).  The row's q.k partial sums meet by xor-shuffles.
//
// Work skipping: the KV range a tile needs is computed from causal, window
// and q_offset (the Pallas kernel's pl.when(any_live) per tile), and ragged
// Sq / Sk edges are masked in the kernel instead of padded copies.
//
// What bounds it: at the serving shapes (S = 512, D = 64 or 128) the work is
// ~0.5-2.2 GFLOP per launch against 2-8 MB of traffic, so the card's bound
// is memory; this first version runs the products on the f32 CUDA cores, not
// the tensor cores, and is bound by those and by shared-memory reads.
//
// Head dims 8..128.  The K/V tile is 64 keys up to D = 64 and 32 keys at
// D = 128, so the two f32 tiles stay at 32 KB of static shared memory.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16;                 // keys scored per online-softmax update

// threads per q row, and so q rows per block
template <int D> constexpr int kTpr = D <= 64 ? 4 : 8;
template <int D> constexpr int kRows = kThreads / kTpr<D>;

template <int VW>
__device__ __forceinline__ void lds(const float* p, float* out) {
  if constexpr (VW == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  } else if constexpr (VW == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x; out[1] = t.y;
  } else {
    out[0] = p[0];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ o, int Sq, int Sk, int Hq, int Hkv, int causal, int window,
              float softcap, float scale, int q_offset) {
  constexpr int TPR = kTpr<D>, ROWS = kRows<D>;
  constexpr int DP = D / TPR;               // dims per thread
  constexpr int VW = DP >= 4 ? 4 : DP;      // vector width of a shared-memory read
  constexpr int NV = DP / VW;               // vectors per thread
  constexpr int BK = D <= 64 ? 64 : 32;     // keys per K/V tile: <= 32 KB of smem
  static_assert(D % (TPR * VW) == 0, "head_dim must split over the row's threads");
  static_assert(BK % kChunk == 0, "tile must hold whole chunks");
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int r = tid / TPR, g = tid % TPR;
  const int row = qt * ROWS + r;
  const bool row_ok = row < Sq;
  const int qpos = q_offset + row;

  float qr[DP], acc[DP];
  {
    const T* qp = q + ((static_cast<size_t>(b) * Sq + (row_ok ? row : 0)) * Hq + h) * D;
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        const int d = VW * (g + TPR * i) + e;
        qr[i * VW + e] = row_ok ? to_f32(qp[d]) * scale : 0.f;
        acc[i * VW + e] = 0.f;
      }
  }
  float m = REPRO_NEG_INF, l = 0.f;

  // KV range any row of this tile can see.
  const int first_row = qt * ROWS;
  const int last_row = min(Sq, first_row + ROWS) - 1;
  const int k_hi = causal ? min(Sk, q_offset + last_row + 1) : Sk;
  const int k_lo = window >= 0 ? max(0, q_offset + first_row - window + 1) : 0;

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    const int nk = min(BK, k_hi - k0);
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = tid; idx < BK * D; idx += kThreads) {
      const int j = idx / D, d = idx % D;
      float kv = 0.f, vv = 0.f;
      if (j < nk) {
        const size_t off = ((static_cast<size_t>(b) * Sk + k0 + j) * Hkv + hk) * D + d;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    __syncthreads();

    for (int c0 = 0; c0 < nk; c0 += kChunk) {
      float s[kChunk];
      float cmax = REPRO_NEG_INF;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          float kk[VW];
          lds<VW>(&ks[c0 + c][VW * (g + TPR * i)], kk);
#pragma unroll
          for (int e = 0; e < VW; ++e) part += qr[i * VW + e] * kk[e];
        }
#pragma unroll
        for (int off = 1; off < TPR; off *= 2) part += __shfl_xor_sync(0xffffffffu, part, off);
        if (softcap > 0.f) part = tanhf(part / softcap) * softcap;
        const int kpos = k0 + c0 + c;
        bool live = kpos < k_hi;
        if (causal) live = live && kpos <= qpos;
        if (window >= 0) live = live && kpos > qpos - window;
        s[c] = live ? part : REPRO_NEG_INF;
        cmax = fmaxf(cmax, s[c]);
      }
      const float m_new = fmaxf(m, cmax);
      const float corr = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        s[c] = expf(s[c] - m_new);
        psum += s[c];
      }
      l = l * corr + psum;
#pragma unroll
      for (int i = 0; i < DP; ++i) acc[i] *= corr;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          float vv[VW];
          lds<VW>(&vs[c0 + c][VW * (g + TPR * i)], vv);
#pragma unroll
          for (int e = 0; e < VW; ++e) acc[i * VW + e] += s[c] * vv[e];
        }
      }
      m = m_new;
    }
  }

  if (row_ok) {
    const float lc = fmaxf(l, 1e-30f);
    T* op = o + ((static_cast<size_t>(b) * Sq + row) * Hq + h) * D;
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int e = 0; e < VW; ++e)
        op[VW * (g + TPR * i) + e] = from_f32<T>(acc[i * VW + e] / lc);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
                   int Hq, int Hkv, int causal, int window, float softcap, float scale,
                   int q_offset, cudaStream_t stream) {
  const dim3 grid((Sq + kRows<D> - 1) / kRows<D>, Hq, B);
  fa_fwd_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Sk, Hq, Hkv, causal, window, softcap, scale, q_offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, void* o, int B, int Sq,
                     int Sk, int Hq, int Hkv, int causal, int window, float softcap, float scale,
                     int q_offset, cudaStream_t st) {
  switch (D) {
    case 8: return launch<T, 8>(q, k, v, o, B, Sq, Sk, Hq, Hkv, causal, window, softcap, scale, q_offset, st);
    case 16: return launch<T, 16>(q, k, v, o, B, Sq, Sk, Hq, Hkv, causal, window, softcap, scale, q_offset, st);
    case 32: return launch<T, 32>(q, k, v, o, B, Sq, Sk, Hq, Hkv, causal, window, softcap, scale, q_offset, st);
    case 64: return launch<T, 64>(q, k, v, o, B, Sq, Sk, Hq, Hkv, causal, window, softcap, scale, q_offset, st);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Sk, Hq, Hkv, causal, window, softcap, scale, q_offset, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// window < 0: no sliding window.  softcap <= 0: no softcap.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int B, int Sq, int Sk, int Hq, int Hkv, int D,
                                   int causal, int window, float softcap, float scale,
                                   int q_offset, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_d<float>(D, q, k, v, o, B, Sq, Sk, Hq, Hkv, causal, window, softcap, scale, q_offset, st);
    case kBF16: return launch_d<__nv_bfloat16>(D, q, k, v, o, B, Sq, Sk, Hq, Hkv, causal, window, softcap, scale, q_offset, st);
    default: return cudaErrorInvalidValue;
  }
}
