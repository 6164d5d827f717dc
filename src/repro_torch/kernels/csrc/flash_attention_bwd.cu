// Flash attention backward (K1b) for Hopper (sm_90a): dq, dk, dv from
// (q, k, v, out, lse, dout), causal / sliding window / q_offset / tanh
// softcap / GQA, f32 math.
//
// Replaces repro/kernels/flash_vjp.py's _bwd_rule, the backward of the
// flash_attention_fused custom_vjp (jnp, not Pallas): it recomputes each
// score from q and k, P = exp(s - lse) from the forward's log-sum-exp
// (flash_attention.cu writes it), and
//
//   delta_i = sum_d dout_i,d out_i,d
//   dv_j   += P_ij dout_i
//   dS_ij   = P_ij (dout_i . v_j - delta_i) (1 - (s_ij / cap)^2 with a softcap)
//   dq_i   += scale dS_ij k_j            dk_j += scale dS_ij q_i
//
// over the live (i, j) pairs; a masked pair has P = 0, so a row without a
// live key gives zero gradients (the _fwd_impl floor keeps its lse finite).
//
// Two passes, no float atomics, so equal inputs give equal gradients bit
// for bit:
//
// * dq: one block per (q tile, q head, batch).  It computes delta for its
//   rows (written for the second pass) and walks the KV tiles the rows can
//   see, accumulating dq.
// * dk / dv: one block per (k tile, KV head, batch).  It loops over the G
//   query heads that read this KV head and over the q tiles that can see
//   its keys, so GQA's sum over the G heads happens inside the block.
//
// What bounds it: at smollm-360m's training shape (4, 2048, 15/5, 64),
// causal, the five products of the backward are ~8.1e10 flops against ~42
// MB of traffic, so the tensor cores set the card's bound (~0.08 ms).  Two
// instances, chosen by dtype and head dim only:
//
// * bf16 at D 16 / 32 / 64: flash_bwd_dq_mma + flash_bwd_dkdv_mma, the
//   products on the tensor cores (mma.sync m16n8k16, P and dS rounded to
//   bf16 as their A operands; below).  S is computed in both passes, so
//   they do 14 D flops a pair where the bound counts 10 D.  (Python routes
//   bf16 D 64, 128 and 256 to the wgmma instances of
//   flash_attention_bwd_sm90.cu.)
// * bf16 at D 128 / 256: flash_bwd_dq_wide + flash_bwd_dkdv_wide, the same
//   products on mma.sync with head_dim split across 8 warps, P and dS
//   passed between the warps through shared memory (the last section).
//   The previous design there: no training path runs it since the wgmma
//   instances replaced it; flash_attention.previous_wide_bwd reaches it,
//   for timing beside them.
// * f32, and bf16 at D 8: flash_bwd_dq + flash_bwd_dkdv, the
//   products on the f32 CUDA cores one (row, key) pair at a time per thread
//   group (the layout of flash_fwd_simt: thread g of a row owns dims
//   VW*(g + TPR*i) .. +VW-1, and the row's partial dot products meet by
//   xor-shuffles), exact to f32 rounding; the f32 end-to-end gate runs it.
#include "mma.cuh"

namespace {

constexpr int kThreads = 256;

template <int D> constexpr int kTpr = D <= 64 ? 4 : D <= 128 ? 8 : 16;  // threads per row
template <int D> constexpr int kRows = kThreads / kTpr<D>;      // rows (or keys) a block
template <int D> constexpr int kTile = D <= 64 ? 64 : 4096 / D; // staged rows: <= 32 KB of f32

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

template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 1; off < TPR; off *= 2) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// the score of one pair after the softcap, and d(score)/d(raw score)
__device__ __forceinline__ float capped(float s, float softcap, float* chain) {
  if (softcap > 0.f) {
    const float t = tanhf(s / softcap);
    *chain = 1.f - t * t;
    return t * softcap;
  }
  *chain = 1.f;
  return s;
}

__device__ __forceinline__ bool live_pair(int kpos, int qpos, int causal, int window) {
  bool live = true;
  if (causal) live = kpos <= qpos;
  if (window >= 0) live = live && kpos > qpos - window;
  return live;
}

// rows [row0, row0 + n) of a (rows, ld) matrix -> an f32 shared tile of
// kTile<D> rows, zeros past n
template <typename T, int D>
__device__ __forceinline__ void stage(float (*dst)[D], const T* src, size_t ld, int row0, int n) {
  for (int idx = threadIdx.x; idx < kTile<D> * D; idx += kThreads) {
    const int j = idx / D, d = idx % D;
    dst[j][d] = j < n ? to_f32(src[static_cast<size_t>(row0 + j) * ld + d]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ o, const float* __restrict__ lse, const T* __restrict__ dout,
             T* __restrict__ dq, float* __restrict__ delta, int Sq, int Sk, int Hq, int Hkv,
             int causal, int window, float softcap, float scale, int q_offset) {
  constexpr int TPR = kTpr<D>, ROWS = kRows<D>, BK = kTile<D>;
  constexpr int DP = D / TPR, VW = DP >= 4 ? 4 : DP, NV = DP / VW;
  static_assert(D % (TPR * VW) == 0, "head_dim must split over the row's threads");
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];

  const int qt = gridDim.x - 1 - blockIdx.x;  // causal: the longest (last) q tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int r = threadIdx.x / TPR, g = threadIdx.x % TPR;
  const int row = qt * ROWS + r;
  const bool row_ok = row < Sq;
  const int qpos = q_offset + row;
  const size_t off = ((static_cast<size_t>(b) * Sq + (row_ok ? row : 0)) * Hq + h) * D;

  float qr[DP], dor[DP], acc[DP];
  float dsum = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int e = 0; e < VW; ++e) {
      const int d = VW * (g + TPR * i) + e, x = i * VW + e;
      qr[x] = row_ok ? to_f32(q[off + d]) * scale : 0.f;
      dor[x] = row_ok ? to_f32(dout[off + d]) : 0.f;
      dsum += dor[x] * (row_ok ? to_f32(o[off + d]) : 0.f);
      acc[x] = 0.f;
    }
  const float dl = row_sum<TPR>(dsum);
  const size_t stat = (static_cast<size_t>(b) * Hq + h) * Sq + row;
  const float m = row_ok ? lse[stat] : 0.f;
  if (row_ok && g == 0) delta[stat] = dl;

  // KV range any row of this tile can see
  const int first_row = qt * ROWS;
  const int last_row = min(Sq, first_row + ROWS) - 1;
  const int k_hi = causal ? min(Sk, q_offset + last_row + 1) : Sk;
  const int k_lo = window >= 0 ? max(0, q_offset + first_row - window + 1) : 0;
  const size_t ldkv = static_cast<size_t>(Hkv) * D;
  const T* kg = k + (static_cast<size_t>(b) * Sk * Hkv + hk) * D;
  const T* vg = v + (static_cast<size_t>(b) * Sk * Hkv + hk) * D;

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    const int nk = min(BK, k_hi - k0);
    __syncthreads();  // every thread is done with the previous tile
    stage<T, D>(ks, kg, ldkv, k0, nk);
    stage<T, D>(vs, vg, ldkv, k0, nk);
    __syncthreads();
    for (int c = 0; c < nk; ++c) {
      float sp = 0.f, dpp = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        float kk[VW], vv[VW];
        lds<VW>(&ks[c][VW * (g + TPR * i)], kk);
        lds<VW>(&vs[c][VW * (g + TPR * i)], vv);
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          sp += qr[i * VW + e] * kk[e];
          dpp += dor[i * VW + e] * vv[e];
        }
      }
      float chain;
      const float s = capped(row_sum<TPR>(sp), softcap, &chain);
      const float dp = row_sum<TPR>(dpp);
      const float p = row_ok && live_pair(k0 + c, qpos, causal, window) ? expf(s - m) : 0.f;
      const float ds = p * (dp - dl) * chain;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        float kk[VW];
        lds<VW>(&ks[c][VW * (g + TPR * i)], kk);
#pragma unroll
        for (int e = 0; e < VW; ++e) acc[i * VW + e] += ds * kk[e];
      }
    }
  }

  if (row_ok) {
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int e = 0; e < VW; ++e)
        dq[off + VW * (g + TPR * i) + e] = from_f32<T>(acc[i * VW + e] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const T* __restrict__ dout, T* __restrict__ dk, T* __restrict__ dv, int Sq,
               int Sk, int Hq, int Hkv, int causal, int window, float softcap, float scale,
               int q_offset) {
  constexpr int TPR = kTpr<D>, ROWS = kRows<D>, BQ = kTile<D>;
  constexpr int DP = D / TPR, VW = DP >= 4 ? 4 : DP, NV = DP / VW;
  static_assert(D % (TPR * VW) == 0, "head_dim must split over the row's threads");
  __shared__ __align__(16) float qs[BQ][D];
  __shared__ __align__(16) float dos[BQ][D];
  __shared__ float lse_s[BQ];
  __shared__ float delta_s[BQ];

  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;  // causal: long tiles first
  const int G = Hq / Hkv;
  const int r = threadIdx.x / TPR, g = threadIdx.x % TPR;
  const int key = kt * ROWS + r;
  const bool key_ok = key < Sk;
  const size_t off = ((static_cast<size_t>(b) * Sk + (key_ok ? key : 0)) * Hkv + hk) * D;

  float kr[DP], vr[DP], dka[DP], dva[DP];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int e = 0; e < VW; ++e) {
      const int d = VW * (g + TPR * i) + e, x = i * VW + e;
      kr[x] = key_ok ? to_f32(k[off + d]) : 0.f;
      vr[x] = key_ok ? to_f32(v[off + d]) : 0.f;
      dka[x] = dva[x] = 0.f;
    }

  // q rows any key of this tile is seen by
  const int first_key = kt * ROWS;
  const int last_key = min(Sk, first_key + ROWS) - 1;
  const int i_lo = causal ? max(0, first_key - q_offset) : 0;
  const int i_hi = window >= 0 ? min(Sq, last_key + window - q_offset) : Sq;
  const size_t ldq = static_cast<size_t>(Hq) * D;

  for (int gh = 0; gh < G; ++gh) {
    const int h = hk * G + gh;
    const T* qg = q + (static_cast<size_t>(b) * Sq * Hq + h) * D;
    const T* dg = dout + (static_cast<size_t>(b) * Sq * Hq + h) * D;
    const float* lg = lse + (static_cast<size_t>(b) * Hq + h) * Sq;
    const float* eg = delta + (static_cast<size_t>(b) * Hq + h) * Sq;
    for (int i0 = i_lo; i0 < i_hi; i0 += BQ) {
      const int nq = min(BQ, i_hi - i0);
      __syncthreads();  // every thread is done with the previous tile
      stage<T, D>(qs, qg, ldq, i0, nq);
      stage<T, D>(dos, dg, ldq, i0, nq);
      for (int j = threadIdx.x; j < BQ; j += kThreads) {
        lse_s[j] = j < nq ? lg[i0 + j] : 0.f;
        delta_s[j] = j < nq ? eg[i0 + j] : 0.f;
      }
      __syncthreads();
      for (int c = 0; c < nq; ++c) {
        float sp = 0.f, dpp = 0.f;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          float qq[VW], dd[VW];
          lds<VW>(&qs[c][VW * (g + TPR * i)], qq);
          lds<VW>(&dos[c][VW * (g + TPR * i)], dd);
#pragma unroll
          for (int e = 0; e < VW; ++e) {
            sp += qq[e] * kr[i * VW + e];
            dpp += dd[e] * vr[i * VW + e];
          }
        }
        float chain;
        const float s = capped(row_sum<TPR>(sp) * scale, softcap, &chain);
        const float dp = row_sum<TPR>(dpp);
        const bool live = key_ok && live_pair(key, q_offset + i0 + c, causal, window);
        const float p = live ? expf(s - lse_s[c]) : 0.f;
        const float ds = p * (dp - delta_s[c]) * chain;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          float qq[VW], dd[VW];
          lds<VW>(&qs[c][VW * (g + TPR * i)], qq);
          lds<VW>(&dos[c][VW * (g + TPR * i)], dd);
#pragma unroll
          for (int e = 0; e < VW; ++e) {
            dva[i * VW + e] += p * dd[e];
            dka[i * VW + e] += ds * qq[e];
          }
        }
      }
    }
  }

  if (key_ok) {
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        const int d = VW * (g + TPR * i) + e, x = i * VW + e;
        dk[off + d] = from_f32<T>(dka[x] * scale);
        dv[off + d] = from_f32<T>(dva[x]);
      }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* lse,
                   const void* dout, void* dq, void* dk, void* dv, void* delta, int B, int Sq,
                   int Sk, int Hq, int Hkv, int causal, int window, float softcap, float scale,
                   int q_offset, cudaStream_t st) {
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v), *dot = static_cast<const T*>(dout);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const dim3 g1((Sq + kRows<D> - 1) / kRows<D>, Hq, B);
  flash_bwd_dq<T, D><<<g1, kThreads, 0, st>>>(qt, kt, vt, static_cast<const T*>(o), l, dot,
                                              static_cast<T*>(dq), dl, Sq, Sk, Hq, Hkv, causal,
                                              window, softcap, scale, q_offset);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 g2((Sk + kRows<D> - 1) / kRows<D>, Hkv, B);
  flash_bwd_dkdv<T, D><<<g2, kThreads, 0, st>>>(qt, kt, vt, l, dl, dot, static_cast<T*>(dk),
                                                static_cast<T*>(dv), Sq, Sk, Hq, Hkv, causal,
                                                window, softcap, scale, q_offset);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16 at D 16 / 32 / 64: the same two passes on the tensor cores
// ---------------------------------------------------------------------------
//
// flash_bwd_dq_mma: 4 warps, 64 q rows a block, each warp 16 rows whose Q
// and dout fragments stay in registers; per 64-key tile (K / V in a 2-stage
// cp.async ring, as flash_fwd_mma stages them) S = Q K^T and dP = dout V^T
// by mma.sync m16n8k16, P and dS per element in f32, then dQ += dS K with dS
// rounded to bf16 as the A operand and K read by ldmatrix.trans.
// flash_bwd_dkdv_mma: 4 warps, 64 keys a block, each warp 16 keys whose K and
// V fragments stay in registers; per 64-row q tile of each of the G heads
// (Q / dout in the ring, lse / delta beside them) S^T = K Q^T and
// dP^T = V dout^T, then dV += P^T dout and dK += dS^T Q with P and dS
// rounded to bf16.  The A-operand fragments of P and dS are the f32 C
// fragments of S repacked in registers, as flash_fwd_mma repacks P.  D 128
// would hold 256 registers of fragments and accumulators a thread: it takes
// the wide pair below.

constexpr int kMmaThreads = 128;  // 4 warps, 16 rows (or keys) each
constexpr int kMB = 64;           // rows a block and rows a staged tile

template <int D> constexpr int kRS = D + 8;          // padded smem row (bf16 elements)
template <int D> constexpr int kTE = kMB * kRS<D>;   // elements of one staged tile
// pass 1: Q, dout, then K and V in 2 stages; pass 2: K, V, then Q and dout
// in 2 stages, + lse and delta (f32) in 2 stages
template <int D> constexpr int kMmaSmem = 6 * kTE<D> * 2 + 2 * 2 * kMB * 4;

using bf16 = __nv_bfloat16;

// rows [row0, row0 + n) of a (rows, ld) bf16 matrix -> a 64-row shared tile
// by 16-byte cp.async; rows past n are zero-filled
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int ld, int row0, int n,
                                          int tid) {
  constexpr int kPerRow = D / 8;
#pragma unroll
  for (int i = tid; i < kMB * kPerRow; i += kMmaThreads) {
    const int r = i / kPerRow, c = i % kPerRow;
    const bool ok = r < n;
    cp_async16(smem_addr(dst + r * kRS<D> + c * 8),
               src + static_cast<size_t>(row0 + (ok ? r : 0)) * ld + c * 8, ok);
  }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// this warp's 16 rows of a staged tile as mma A fragments (KC = D / 16 of them)
template <int D>
__device__ __forceinline__ void a_frags(uint32_t (&f)[D / 16][4], const bf16* tile, int warp,
                                        int lane) {
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc)
    ldmatrix_x4(f[kc], smem_addr(tile + (warp * 16 + (lane & 15)) * kRS<D> + kc * 16 +
                                 (lane >> 4) * 8));
}

// c[16 x 64] = A (16 x D, fragments) times the 64 staged rows of `tile`
// transposed (B[d][j] = tile[j][d]), as flash_fwd_mma's S = Q K^T
template <int D>
__device__ __forceinline__ void mm_rows_t(float (&c)[kMB / 8][4], const uint32_t (&a)[D / 16][4],
                                          const bf16* tile, int lane) {
  constexpr int NT = kMB / 8;
#pragma unroll
  for (int n = 0; n < NT; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
  pipelined<D / 16 * NT / 2>(
      [&](int i, uint32_t (&r)[4]) {
        const int kc = i / (NT / 2), np = i % (NT / 2);
        ldmatrix_x4(r, smem_addr(tile + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kRS<D> +
                                 kc * 16 + ((lane >> 3) & 1) * 8));
      },
      [&](int i, const uint32_t (&r)[4]) {
        const int kc = i / (NT / 2), np = i % (NT / 2);
        mma_bf16(c[2 * np], a[kc], r[0], r[1]);
        mma_bf16(c[2 * np + 1], a[kc], r[2], r[3]);
      });
}

// acc[16 x D] += A (16 x 64, the bf16 repack of c) times the 64 staged rows
// of `tile` (B[j][d] = tile[j][d], read by ldmatrix.trans), as
// flash_fwd_mma's O += P V
template <int D>
__device__ __forceinline__ void mm_rows(float (&acc)[D / 8][4], const float (&c)[kMB / 8][4],
                                        const bf16* tile, int lane) {
  constexpr int NT = kMB / 8, ND = D / 8;
  uint32_t pa[NT / 2][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    pa[n / 2][(n & 1) * 2] = pack2(c[n][0], c[n][1]);
    pa[n / 2][(n & 1) * 2 + 1] = pack2(c[n][2], c[n][3]);
  }
  pipelined<NT / 2 * ND / 2>(
      [&](int i, uint32_t (&r)[4]) {
        const int kc = i / (ND / 2), dp = i % (ND / 2);
        ldmatrix_x4_trans(r, smem_addr(tile + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                                  kRS<D> + dp * 16 + (lane >> 4) * 8));
      },
      [&](int i, const uint32_t (&r)[4]) {
        const int kc = i / (ND / 2), dp = i % (ND / 2);
        mma_bf16(acc[2 * dp], pa[kc], r[0], r[1]);
        mma_bf16(acc[2 * dp + 1], pa[kc], r[2], r[3]);
      });
}

// row `row` (< valid) of a (rows, ld) bf16 matrix gets the two f32 values
// lo, hi at columns 2 tq + 8 n, for the n-tiles of a 16 x D accumulator
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[D / 8][4], int half,
                                           float mul) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
        __floats2bfloat162_rn(acc[n][2 * half] * mul, acc[n][2 * half + 1] * mul);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ o,
                 const float* __restrict__ lse, const bf16* __restrict__ dout,
                 bf16* __restrict__ dq, float* __restrict__ delta, int Sq, int Sk, int Hq,
                 int Hkv, int causal, int window, float softcap, float scale, int q_offset) {
  constexpr int NT = kMB / 8, ND = D / 8, TE = kTE<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + TE;
  bf16* ks = dos + TE;      // [2][64][RS]
  bf16* vs = ks + 2 * TE;   // [2][64][RS]
  float* stat = reinterpret_cast<float*>(vs + 2 * TE);  // lse * log2 e, delta: [2][64]

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // causal: the longest (last) q tiles first
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gr = lane >> 2, tq = lane & 3;
  const int row0 = qt * kMB, n_rows = min(kMB, Sq - row0);
  const int ldq = Hq * D, ldkv = Hkv * D;
  const size_t qoff = (static_cast<size_t>(b) * Sq * Hq + h) * D;
  const bf16* kg = k + (static_cast<size_t>(b) * Sk * Hkv + hk) * D;
  const bf16* vg = v + (static_cast<size_t>(b) * Sk * Hkv + hk) * D;

  const int last_row = row0 + n_rows - 1;
  const int k_hi = causal ? min(Sk, q_offset + last_row + 1) : Sk;
  const int k_lo = window >= 0 ? max(0, q_offset + row0 - window + 1) : 0;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kMB - 1) / kMB : 0;
  auto load_kv = [&](int it) {
    const int k0 = k_lo + it * kMB;
    load_tile<D>(ks + (it & 1) * TE, kg, ldkv, k0, min(kMB, k_hi - k0), tid);
    load_tile<D>(vs + (it & 1) * TE, vg, ldkv, k0, min(kMB, k_hi - k0), tid);
  };
  load_tile<D>(qs, q + qoff, ldq, row0, n_rows, tid);
  load_tile<D>(dos, dout + qoff, ldq, row0, n_rows, tid);
  cp_async_commit();
  if (n_tiles > 0) load_kv(0);
  cp_async_commit();

  // delta = rowsum(dout * out) and lse for the block's rows: two threads a row
  {
    const int r = tid >> 1, half = tid & 1;
    float acc = 0.f;
    if (r < n_rows) {
      const bf16* op = o + qoff + static_cast<size_t>(row0 + r) * ldq + half * (D / 2);
      const bf16* dp = dout + qoff + static_cast<size_t>(row0 + r) * ldq + half * (D / 2);
#pragma unroll
      for (int d = 0; d < D / 2; ++d) acc += __bfloat162float(op[d]) * __bfloat162float(dp[d]);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      const size_t si = (static_cast<size_t>(b) * Hq + h) * Sq + row0 + r;
      stat[r] = r < n_rows ? lse[si] * kLog2e : 0.f;
      stat[kMB + r] = acc;
      if (r < n_rows) delta[si] = acc;
    }
  }
  cp_async_wait<1>();  // Q and dout have landed
  __syncthreads();
  uint32_t qf[D / 16][4], df[D / 16][4];
  a_frags<D>(qf, qs, warp, lane);
  a_frags<D>(df, dos, warp, lane);
  float m2[2], dl[2];
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + gr + i * 8;
    m2[i] = stat[r];
    dl[i] = stat[kMB + r];
    qpos[i] = q_offset + row0 + r;
  }
  const bool capped = softcap > 0.f;

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_lo + it * kMB;
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_tiles) load_kv(it + 1);
    cp_async_commit();
    const bf16* kt = ks + (it & 1) * TE;
    const bf16* vt = vs + (it & 1) * TE;
    float s[NT][4], dp[NT][4];
    mm_rows_t<D>(s, qf, kt, lane);
    mm_rows_t<D>(dp, df, vt, lane);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, key = k0 + n * 8 + 2 * tq + (e & 1);
        float x = s[n][e] * scale, chain = 1.f;
        if (capped) {
          const float t = tanhf(x / softcap);
          x = t * softcap;
          chain = 1.f - t * t;
        }
        bool live = key < k_hi;
        if (causal) live = live && key <= qpos[i];
        if (window >= 0) live = live && key > qpos[i] - window;
        const float p = live ? exp2f(x * kLog2e - m2[i]) : 0.f;
        s[n][e] = p * (dp[n][e] - dl[i]) * chain;  // dS
      }
    mm_rows<D>(acc, s, kt, lane);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + warp * 16 + gr + i * 8;
    if (row < Sq) store_rows<D>(dq + qoff + static_cast<size_t>(row) * ldq + 2 * tq, acc, i, scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkdv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float* __restrict__ lse,
                   const float* __restrict__ delta, const bf16* __restrict__ dout,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk, int Hq, int Hkv,
                   int causal, int window, float softcap, float scale, int q_offset) {
  constexpr int NT = kMB / 8, ND = D / 8, TE = kTE<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + TE;
  bf16* qs = vs + TE;       // [2][64][RS]
  bf16* dos = qs + 2 * TE;  // [2][64][RS]
  float* stat = reinterpret_cast<float*>(dos + 2 * TE);  // [2][lse * log2 e (64), delta (64)]

  const int hk = blockIdx.x, b = blockIdx.y, kt_ = blockIdx.z;  // causal: long tiles first
  const int G = Hq / Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gr = lane >> 2, tq = lane & 3;
  const int key0 = kt_ * kMB, n_keys = min(kMB, Sk - key0);
  const int ldq = Hq * D, ldkv = Hkv * D;
  const size_t kvoff = (static_cast<size_t>(b) * Sk * Hkv + hk) * D;

  const int last_key = key0 + n_keys - 1;
  const int i_lo = causal ? max(0, key0 - q_offset) : 0;
  const int i_hi = window >= 0 ? min(Sq, last_key + window - q_offset) : Sq;
  const int n_qt = i_hi > i_lo ? (i_hi - i_lo + kMB - 1) / kMB : 0;
  const int n_it = G * n_qt;
  auto load_q = [&](int it) {  // q tile it % n_qt of head hk * G + it / n_qt
    const int h = hk * G + it / n_qt, i0 = i_lo + (it % n_qt) * kMB, n = min(kMB, i_hi - i0);
    const size_t qoff = (static_cast<size_t>(b) * Sq * Hq + h) * D;
    load_tile<D>(qs + (it & 1) * TE, q + qoff, ldq, i0, n, tid);
    load_tile<D>(dos + (it & 1) * TE, dout + qoff, ldq, i0, n, tid);
    float* st = stat + (it & 1) * 2 * kMB;
    const size_t si = (static_cast<size_t>(b) * Hq + h) * Sq + i0;
    for (int j = tid; j < kMB; j += kMmaThreads) {
      st[j] = j < n ? lse[si + j] * kLog2e : 0.f;
      st[kMB + j] = j < n ? delta[si + j] : 0.f;
    }
  };
  load_tile<D>(ks, k + kvoff, ldkv, key0, n_keys, tid);
  load_tile<D>(vs, v + kvoff, ldkv, key0, n_keys, tid);
  cp_async_commit();
  if (n_it > 0) load_q(0);
  cp_async_commit();
  cp_async_wait<1>();  // K and V have landed
  __syncthreads();
  uint32_t kf[D / 16][4], vf[D / 16][4];
  a_frags<D>(kf, ks, warp, lane);
  a_frags<D>(vf, vs, warp, lane);
  int kpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) kpos[i] = key0 + warp * 16 + gr + i * 8;
  const bool capped = softcap > 0.f;

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  for (int it = 0; it < n_it; ++it) {
    const int i0 = i_lo + (it % n_qt) * kMB;
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_it) load_q(it + 1);
    cp_async_commit();
    const bf16* qt = qs + (it & 1) * TE;
    const bf16* dt = dos + (it & 1) * TE;
    const float* st = stat + (it & 1) * 2 * kMB;
    float s[NT][4], dp[NT][4];
    mm_rows_t<D>(s, kf, qt, lane);   // S^T: keys x q rows
    mm_rows_t<D>(dp, vf, dt, lane);  // dP^T
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = n * 8 + 2 * tq + (e & 1), row = i0 + j, key = kpos[e >> 1];
        float x = s[n][e] * scale, chain = 1.f;
        if (capped) {
          const float t = tanhf(x / softcap);
          x = t * softcap;
          chain = 1.f - t * t;
        }
        bool live = row < i_hi && key < Sk;
        if (causal) live = live && key <= q_offset + row;
        if (window >= 0) live = live && key > q_offset + row - window;
        const float p = live ? exp2f(x * kLog2e - st[j]) : 0.f;
        s[n][e] = p;                                       // P^T
        dp[n][e] = p * (dp[n][e] - st[kMB + j]) * chain;   // dS^T
      }
    mm_rows<D>(dva, s, dt, lane);   // dV += P^T dout
    mm_rows<D>(dka, dp, qt, lane);  // dK += dS^T Q
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (kpos[i] >= Sk) continue;
    const size_t off = kvoff + static_cast<size_t>(kpos[i]) * ldkv + 2 * tq;
    store_rows<D>(dk + off, dka, i, scale);
    store_rows<D>(dv + off, dva, i, 1.f);
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* o,
                       const void* lse, const void* dout, void* dq, void* dk, void* dv,
                       void* delta, int B, int Sq, int Sk, int Hq, int Hkv, int causal,
                       int window, float softcap, float scale, int q_offset, cudaStream_t st) {
  constexpr int smem = kMmaSmem<D>;
  cudaError_t err = allow_smem<flash_bwd_dq_mma<D>>(smem);
  if (err == cudaSuccess) err = allow_smem<flash_bwd_dkdv_mma<D>>(smem);
  if (err != cudaSuccess) return err;
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v), *db = static_cast<const bf16*>(dout);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  flash_bwd_dq_mma<D><<<dim3(Hq, B, (Sq + kMB - 1) / kMB), kMmaThreads, smem, st>>>(
      qb, kb, vb, static_cast<const bf16*>(o), l, db, static_cast<bf16*>(dq), dl, Sq, Sk, Hq,
      Hkv, causal, window, softcap, scale, q_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_mma<D><<<dim3(Hkv, B, (Sk + kMB - 1) / kMB), kMmaThreads, smem, st>>>(
      qb, kb, vb, l, dl, db, static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq, Sk, Hq, Hkv,
      causal, window, softcap, scale, q_offset);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 at D 128 / 256: the two passes on the tensor cores, D split over warps
// ---------------------------------------------------------------------------
//
// At D 128 and 256 a warp cannot hold a 16-row strip's fragments and a
// 16 x D accumulator (or two, dK and dV) in its 255 registers a thread, so
// each block of 8 warps works in two phases per tile:
//
// * phase A, scores: warp (strip, part) computes S and dP (dq pass: Q K^T
//   and dout V^T; dkdv pass: K Q^T and V dout^T) for its 16 rows (keys) and
//   its part of the tile's keys (rows), A and B fragments both by ldmatrix
//   from shared memory; it turns them into dS (and P) and writes them to
//   shared memory in bf16;
// * phase B, gradients: warp (strip, part) accumulates its 16 rows (keys) of
//   dQ (dK and dV) over its part of D's columns, D / parts of them, reading
//   dS (P) by ldmatrix and K (Q, dout) by ldmatrix.trans.
//
// A barrier separates the phases; the next tile's cp.async loads (2 stages)
// are in flight across both.  Tiles (own rows x the other side's tile):
//
//   dq pass    D 128: 64 rows x 64 keys (warps 4 x 2, 64 columns of dQ each)
//              D 256: 64 rows x 32 keys (warps 4 x 2, 128 columns each)
//   dkdv pass  D 128: 64 keys x 64 rows (warps 4 x 2, 64 columns of dK, dV)
//              D 256: 32 keys x 64 rows (warps 2 x 4, 64 columns each)
//
// so a thread holds at most 64 accumulator registers.  The sums and their
// order are fixed, with no atomics: equal inputs give equal bits.

constexpr int kWideThreads = 256;  // 8 warps
constexpr int kWideWarps = kWideThreads / 32;
template <int D> constexpr int kWideDqKeys = D <= 128 ? 64 : 32;    // keys of a dq tile
template <int D> constexpr int kWideDkdvKeys = D <= 128 ? 64 : 32;  // keys of a dkdv block
constexpr int kWideDqRows = 64;    // rows of a dq block
constexpr int kWideDkdvRows = 64;  // q rows of a dkdv tile

// shared memory (bytes): dq: Q, dout; K, V in 2 stages; dS; lse, delta.
// dkdv: K, V; Q, dout in 2 stages; P^T, dS^T; lse, delta in 2 stages
template <int D> constexpr int kWideDqSmem =
    ((2 * kWideDqRows + 4 * kWideDqKeys<D>) * (D + 8) + kWideDqRows * (kWideDqKeys<D> + 8)) * 2 +
    2 * kWideDqRows * 4;
template <int D> constexpr int kWideDkdvSmem =
    ((2 * kWideDkdvKeys<D> + 4 * kWideDkdvRows) * (D + 8) +
     2 * kWideDkdvKeys<D> * (kWideDkdvRows + 8)) * 2 + 4 * kWideDkdvRows * 4;

// rows [row0, row0 + n) of a (rows, ld) bf16 matrix -> ROWS rows of a shared
// tile with row stride D + 8, by 16-byte cp.async; rows past n zero-filled
template <int D, int ROWS>
__device__ __forceinline__ void load_wide(bf16* dst, const bf16* src, int ld, int row0, int n,
                                          int tid) {
  constexpr int kPerRow = D / 8;
#pragma unroll 4
  for (int i = tid; i < ROWS * kPerRow; i += kWideThreads) {
    const int r = i / kPerRow, c = i % kPerRow;
    const bool ok = r < n;
    cp_async16(smem_addr(dst + r * (D + 8) + c * 8),
               src + static_cast<size_t>(row0 + (ok ? r : 0)) * ld + c * 8, ok);
  }
}

// c[16 x 16 NP] = A B^T: A the 16 rows at `a`, B the 16 NP rows at `b`, both
// 16 KC columns wide in shared memory (row strides lda, ldb)
template <int KC, int NP>
__device__ __forceinline__ void mm_abt(float (&c)[2 * NP][4], const bf16* a, int lda,
                                       const bf16* b, int ldb, int lane) {
#pragma unroll
  for (int n = 0; n < 2 * NP; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
  uint32_t af[4];
  pipelined<KC * (NP + 1)>(
      [&](int i, uint32_t (&r)[4]) {
        const int kc = i / (NP + 1), j = i % (NP + 1);
        if (j == 0)
          ldmatrix_x4(r, smem_addr(a + (lane & 15) * lda + kc * 16 + (lane >> 4) * 8));
        else
          ldmatrix_x4(r, smem_addr(b + ((j - 1) * 16 + (lane & 7) + ((lane >> 4) << 3)) * ldb +
                                   kc * 16 + ((lane >> 3) & 1) * 8));
      },
      [&](int i, const uint32_t (&r)[4]) {
        const int j = i % (NP + 1);
        if (j == 0) {
          af[0] = r[0]; af[1] = r[1]; af[2] = r[2]; af[3] = r[3];
        } else {
          mma_bf16(c[2 * (j - 1)], af, r[0], r[1]);
          mma_bf16(c[2 * (j - 1) + 1], af, r[2], r[3]);
        }
      });
}

// acc[16 x 16 NP] += A B: A the 16 rows at `a` (16 KC columns), B the 16 KC
// rows at `b` (16 NP columns), both in shared memory, B read by ldmatrix.trans
template <int KC, int NP>
__device__ __forceinline__ void mm_ab(float (&acc)[2 * NP][4], const bf16* a, int lda,
                                      const bf16* b, int ldb, int lane) {
  uint32_t af[4];
  pipelined<KC * (NP + 1)>(
      [&](int i, uint32_t (&r)[4]) {
        const int kc = i / (NP + 1), j = i % (NP + 1);
        if (j == 0)
          ldmatrix_x4(r, smem_addr(a + (lane & 15) * lda + kc * 16 + (lane >> 4) * 8));
        else
          ldmatrix_x4_trans(r, smem_addr(b + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldb +
                                         (j - 1) * 16 + (lane >> 4) * 8));
      },
      [&](int i, const uint32_t (&r)[4]) {
        const int j = i % (NP + 1);
        if (j == 0) {
          af[0] = r[0]; af[1] = r[1]; af[2] = r[2]; af[3] = r[3];
        } else {
          mma_bf16(acc[2 * (j - 1)], af, r[0], r[1]);
          mma_bf16(acc[2 * (j - 1) + 1], af, r[2], r[3]);
        }
      });
}

// a 16 x 8 C fragment's two rows (gr, gr + 8) into a bf16 shared tile
__device__ __forceinline__ void put_frag(bf16* dst, int ld, const float (&c)[4], int gr, int tq) {
  *reinterpret_cast<__nv_bfloat162*>(dst + gr * ld + 2 * tq) = __floats2bfloat162_rn(c[0], c[1]);
  *reinterpret_cast<__nv_bfloat162*>(dst + (gr + 8) * ld + 2 * tq) =
      __floats2bfloat162_rn(c[2], c[3]);
}

template <int D>
__global__ void __launch_bounds__(kWideThreads)
flash_bwd_dq_wide(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ o,
                  const float* __restrict__ lse, const bf16* __restrict__ dout,
                  bf16* __restrict__ dq, float* __restrict__ delta, int Sq, int Sk, int Hq,
                  int Hkv, int causal, int window, float softcap, float scale, int q_offset) {
  constexpr int M = kWideDqRows, N = kWideDqKeys<D>, RS = D + 8, PS = N + 8;
  constexpr int STRIPS = M / 16, PARTS = kWideWarps / STRIPS;
  constexpr int NK = N / PARTS, DW = D / PARTS;  // a warp's keys in phase A, columns in B
  static_assert(NK % 16 == 0 && DW % 16 == 0, "a warp's slices are whole 16-wide fragments");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [M][RS]
  bf16* dos = qs + M * RS;                        // [M][RS]
  bf16* ks = dos + M * RS;                        // [2][N][RS]
  bf16* vs = ks + 2 * N * RS;                     // [2][N][RS]
  bf16* dss = vs + 2 * N * RS;                    // [M][PS]
  float* stat = reinterpret_cast<float*>(dss + M * PS);  // lse * log2 e [M], delta [M]

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // causal: the longest (last) q tiles first
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gr = lane >> 2, tq = lane & 3;
  const int strip = warp % STRIPS, part = warp / STRIPS;
  const int row0 = qt * M, n_rows = min(M, Sq - row0);
  const int ldq = Hq * D, ldkv = Hkv * D;
  const size_t qoff = (static_cast<size_t>(b) * Sq * Hq + h) * D;
  const bf16* kg = k + (static_cast<size_t>(b) * Sk * Hkv + hk) * D;
  const bf16* vg = v + (static_cast<size_t>(b) * Sk * Hkv + hk) * D;

  const int last_row = row0 + n_rows - 1;
  const int k_hi = causal ? min(Sk, q_offset + last_row + 1) : Sk;
  const int k_lo = window >= 0 ? max(0, q_offset + row0 - window + 1) : 0;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + N - 1) / N : 0;
  auto load_kv = [&](int it) {
    const int k0 = k_lo + it * N, n = min(N, k_hi - k0);
    load_wide<D, N>(ks + (it & 1) * N * RS, kg, ldkv, k0, n, tid);
    load_wide<D, N>(vs + (it & 1) * N * RS, vg, ldkv, k0, n, tid);
  };
  load_wide<D, M>(qs, q + qoff, ldq, row0, n_rows, tid);
  load_wide<D, M>(dos, dout + qoff, ldq, row0, n_rows, tid);
  cp_async_commit();
  if (n_tiles > 0) load_kv(0);
  cp_async_commit();

  // delta = rowsum(dout * out) and lse for the block's rows: 4 threads a row
  {
    const int r = tid >> 2, quarter = tid & 3;
    float acc = 0.f;
    if (r < n_rows) {
      const size_t at = qoff + static_cast<size_t>(row0 + r) * ldq;
#pragma unroll 8
      for (int d = quarter * 2; d < D; d += 8) {
        const float2 ov = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o + at + d));
        const float2 dv_ =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dout + at + d));
        acc += ov.x * dv_.x + ov.y * dv_.y;
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (quarter == 0) {
      const size_t si = (static_cast<size_t>(b) * Hq + h) * Sq + row0 + r;
      stat[r] = r < n_rows ? lse[si] * kLog2e : 0.f;
      stat[M + r] = acc;
      if (r < n_rows) delta[si] = acc;
    }
  }
  __syncthreads();
  float m2[2], dl[2];
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = strip * 16 + gr + i * 8;
    m2[i] = stat[r];
    dl[i] = stat[M + r];
    qpos[i] = q_offset + row0 + r;
  }
  const bool capped = softcap > 0.f;

  float acc[DW / 8][4];
#pragma unroll
  for (int n = 0; n < DW / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_lo + it * N;
    cp_async_wait<0>();
    __syncthreads();  // this tile landed; every warp is done with the last one and dS
    if (it + 1 < n_tiles) load_kv(it + 1);
    cp_async_commit();
    const bf16* kt = ks + (it & 1) * N * RS;
    const bf16* vt = vs + (it & 1) * N * RS;
    float s[NK / 8][4], dp[NK / 8][4];
    mm_abt<D / 16, NK / 16>(s, qs + strip * 16 * RS, RS, kt + part * NK * RS, RS, lane);
    mm_abt<D / 16, NK / 16>(dp, dos + strip * 16 * RS, RS, vt + part * NK * RS, RS, lane);
#pragma unroll
    for (int n = 0; n < NK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, key = k0 + part * NK + n * 8 + 2 * tq + (e & 1);
        float x = s[n][e] * scale, chain = 1.f;
        if (capped) {
          const float t = tanhf(x / softcap);
          x = t * softcap;
          chain = 1.f - t * t;
        }
        bool live = key < k_hi;
        if (causal) live = live && key <= qpos[i];
        if (window >= 0) live = live && key > qpos[i] - window;
        const float p = live ? exp2f(x * kLog2e - m2[i]) : 0.f;
        s[n][e] = p * (dp[n][e] - dl[i]) * chain;  // dS
      }
      put_frag(dss + strip * 16 * PS + part * NK + n * 8, PS, s[n], gr, tq);
    }
    __syncthreads();  // dS complete
    mm_ab<N / 16, DW / 16>(acc, dss + strip * 16 * PS, PS, kt + part * DW, RS, lane);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + strip * 16 + gr + i * 8;
    if (row < Sq)
      store_rows<DW>(dq + qoff + static_cast<size_t>(row) * ldq + part * DW + 2 * tq, acc, i,
                     scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kWideThreads)
flash_bwd_dkdv_wide(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ lse,
                    const float* __restrict__ delta, const bf16* __restrict__ dout,
                    bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk, int Hq,
                    int Hkv, int causal, int window, float softcap, float scale, int q_offset) {
  constexpr int M = kWideDkdvKeys<D>, N = kWideDkdvRows, RS = D + 8, PS = N + 8;
  constexpr int STRIPS = M / 16, PARTS = kWideWarps / STRIPS;
  constexpr int NR = N / PARTS, DW = D / PARTS;  // a warp's q rows in phase A, columns in B
  static_assert(NR % 16 == 0 && DW % 16 == 0, "a warp's slices are whole 16-wide fragments");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [M][RS]
  bf16* vs = ks + M * RS;                         // [M][RS]
  bf16* qs = vs + M * RS;                         // [2][N][RS]
  bf16* dos = qs + 2 * N * RS;                    // [2][N][RS]
  bf16* pts = dos + 2 * N * RS;                   // P^T [M][PS]
  bf16* dsts = pts + M * PS;                      // dS^T [M][PS]
  float* stat = reinterpret_cast<float*>(dsts + M * PS);  // [2][lse * log2 e (N), delta (N)]

  const int hk = blockIdx.x, b = blockIdx.y, kt_ = blockIdx.z;  // causal: long tiles first
  const int G = Hq / Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gr = lane >> 2, tq = lane & 3;
  const int strip = warp % STRIPS, part = warp / STRIPS;
  const int key0 = kt_ * M, n_keys = min(M, Sk - key0);
  const int ldq = Hq * D, ldkv = Hkv * D;
  const size_t kvoff = (static_cast<size_t>(b) * Sk * Hkv + hk) * D;

  const int last_key = key0 + n_keys - 1;
  const int i_lo = causal ? max(0, key0 - q_offset) : 0;
  const int i_hi = window >= 0 ? min(Sq, last_key + window - q_offset) : Sq;
  const int n_qt = i_hi > i_lo ? (i_hi - i_lo + N - 1) / N : 0;
  const int n_it = G * n_qt;
  auto load_q = [&](int it) {  // q tile it % n_qt of head hk * G + it / n_qt
    const int h = hk * G + it / n_qt, i0 = i_lo + (it % n_qt) * N, n = min(N, i_hi - i0);
    const size_t qoff = (static_cast<size_t>(b) * Sq * Hq + h) * D;
    load_wide<D, N>(qs + (it & 1) * N * RS, q + qoff, ldq, i0, n, tid);
    load_wide<D, N>(dos + (it & 1) * N * RS, dout + qoff, ldq, i0, n, tid);
    float* st = stat + (it & 1) * 2 * N;
    const size_t si = (static_cast<size_t>(b) * Hq + h) * Sq + i0;
    for (int j = tid; j < N; j += kWideThreads) {
      st[j] = j < n ? lse[si + j] * kLog2e : 0.f;
      st[N + j] = j < n ? delta[si + j] : 0.f;
    }
  };
  load_wide<D, M>(ks, k + kvoff, ldkv, key0, n_keys, tid);
  load_wide<D, M>(vs, v + kvoff, ldkv, key0, n_keys, tid);
  cp_async_commit();
  if (n_it > 0) load_q(0);
  cp_async_commit();
  int kpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) kpos[i] = key0 + strip * 16 + gr + i * 8;
  const bool capped = softcap > 0.f;

  float dka[DW / 8][4], dva[DW / 8][4];
#pragma unroll
  for (int n = 0; n < DW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  for (int it = 0; it < n_it; ++it) {
    const int i0 = i_lo + (it % n_qt) * N;
    cp_async_wait<0>();
    __syncthreads();  // this tile landed; every warp is done with the last one and P, dS
    if (it + 1 < n_it) load_q(it + 1);
    cp_async_commit();
    const bf16* qt = qs + (it & 1) * N * RS;
    const bf16* dt = dos + (it & 1) * N * RS;
    const float* st = stat + (it & 1) * 2 * N;
    float s[NR / 8][4], dp[NR / 8][4];
    mm_abt<D / 16, NR / 16>(s, ks + strip * 16 * RS, RS, qt + part * NR * RS, RS, lane);   // S^T
    mm_abt<D / 16, NR / 16>(dp, vs + strip * 16 * RS, RS, dt + part * NR * RS, RS, lane);  // dP^T
#pragma unroll
    for (int n = 0; n < NR / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = part * NR + n * 8 + 2 * tq + (e & 1), row = i0 + j, key = kpos[e >> 1];
        float x = s[n][e] * scale, chain = 1.f;
        if (capped) {
          const float t = tanhf(x / softcap);
          x = t * softcap;
          chain = 1.f - t * t;
        }
        bool live = row < i_hi && key < Sk;
        if (causal) live = live && key <= q_offset + row;
        if (window >= 0) live = live && key > q_offset + row - window;
        const float p = live ? exp2f(x * kLog2e - st[j]) : 0.f;
        s[n][e] = p;                                       // P^T
        dp[n][e] = p * (dp[n][e] - st[N + j]) * chain;     // dS^T
      }
      put_frag(pts + strip * 16 * PS + part * NR + n * 8, PS, s[n], gr, tq);
      put_frag(dsts + strip * 16 * PS + part * NR + n * 8, PS, dp[n], gr, tq);
    }
    __syncthreads();  // P^T and dS^T complete
    // dV += P^T dout, dK += dS^T Q
    mm_ab<N / 16, DW / 16>(dva, pts + strip * 16 * PS, PS, dt + part * DW, RS, lane);
    mm_ab<N / 16, DW / 16>(dka, dsts + strip * 16 * PS, PS, qt + part * DW, RS, lane);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (kpos[i] >= Sk) continue;
    const size_t off = kvoff + static_cast<size_t>(kpos[i]) * ldkv + part * DW + 2 * tq;
    store_rows<DW>(dk + off, dka, i, scale);
    store_rows<DW>(dv + off, dva, i, 1.f);
  }
}

template <int D>
cudaError_t launch_wide(const void* q, const void* k, const void* v, const void* o,
                        const void* lse, const void* dout, void* dq, void* dk, void* dv,
                        void* delta, int B, int Sq, int Sk, int Hq, int Hkv, int causal,
                        int window, float softcap, float scale, int q_offset, cudaStream_t st) {
  cudaError_t err = allow_smem<flash_bwd_dq_wide<D>>(kWideDqSmem<D>);
  if (err == cudaSuccess) err = allow_smem<flash_bwd_dkdv_wide<D>>(kWideDkdvSmem<D>);
  if (err != cudaSuccess) return err;
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v), *db = static_cast<const bf16*>(dout);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  flash_bwd_dq_wide<D><<<dim3(Hq, B, (Sq + kWideDqRows - 1) / kWideDqRows), kWideThreads,
                         kWideDqSmem<D>, st>>>(qb, kb, vb, static_cast<const bf16*>(o), l, db,
                                               static_cast<bf16*>(dq), dl, Sq, Sk, Hq, Hkv,
                                               causal, window, softcap, scale, q_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_wide<D><<<dim3(Hkv, B, (Sk + kWideDkdvKeys<D> - 1) / kWideDkdvKeys<D>),
                           kWideThreads, kWideDkdvSmem<D>, st>>>(
      qb, kb, vb, l, dl, db, static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq, Sk, Hq, Hkv,
      causal, window, softcap, scale, q_offset);
  return cudaGetLastError();
}


#define BWD_ARGS \
  q, k, v, o, lse, dout, dq, dk, dv, delta, B, Sq, Sk, Hq, Hkv, causal, window, softcap, scale, \
      q_offset, st

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, const void* o, const void* lse,
                     const void* dout, void* dq, void* dk, void* dv, void* delta, int B, int Sq,
                     int Sk, int Hq, int Hkv, int D, int causal, int window, float softcap,
                     float scale, int q_offset, cudaStream_t st) {
  switch (D) {
    case 8: return launch<T, 8>(BWD_ARGS);
    case 16: return launch<T, 16>(BWD_ARGS);
    case 32: return launch<T, 32>(BWD_ARGS);
    case 64: return launch<T, 64>(BWD_ARGS);
    case 128: return launch<T, 128>(BWD_ARGS);
    case 256: return launch<T, 256>(BWD_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, dout, dq (B, Sq, Hq, D); k, v, dk, dv (B, Sk, Hkv, D); o the forward's
// output; lse f32 (B, Hq, Sq) from flash_attention_fwd; delta f32 (B, Hq,
// Sq) scratch.  window < 0: no sliding window; softcap <= 0: no softcap.
// Two kernels on ``stream``, one after the other.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* lse, const void* dout, void* dq, void* dk,
                                   void* dv, void* delta, int dtype, int B, int Sq, int Sk,
                                   int Hq, int Hkv, int D, int causal, int window, float softcap,
                                   float scale, int q_offset, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || Hq % Hkv) return cudaErrorInvalidValue;
#define BWD_ARGS_D \
  q, k, v, o, lse, dout, dq, dk, dv, delta, B, Sq, Sk, Hq, Hkv, D, causal, window, softcap, \
      scale, q_offset, st
  switch (dtype) {
    case kF32: return launch_d<float>(BWD_ARGS_D);
    case kBF16:
      switch (D) {
        case 8: return launch<__nv_bfloat16, 8>(BWD_ARGS);
        case 16: return launch_mma<16>(BWD_ARGS);
        case 32: return launch_mma<32>(BWD_ARGS);
        case 64: return launch_mma<64>(BWD_ARGS);
        case 128: return launch_wide<128>(BWD_ARGS);
        case 256: return launch_wide<256>(BWD_ARGS);
        default: return cudaErrorInvalidValue;
      }
    default: return cudaErrorInvalidValue;
  }
}
