// Flash attention forward for Hopper (sm_90a): causal / sliding window /
// q_offset / tanh softcap / GQA, f32 online softmax.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention, _fa_kernel).  That kernel walks KV blocks along a
// sequential grid axis and carries m / l / acc in VMEM scratch; here one
// thread block owns (batch, q head, q tile) and walks the KV tiles in a
// loop, carrying m / l / acc in registers.
//
// Layout: q (B, Sq, Hq, D), k / v (B, Sk, Hkv, D), out (B, Sq, Hq, D), all
// contiguous.  Query head h reads KV head h / (Hq / Hkv).
//
// What bounds it: at the serving shapes (S = 512, D = 64 or 128) a launch
// is 0.2-4.3 GFLOP against 0.5-19 MB of traffic, so the card's bound is
// memory, but only the tensor cores reach it: the f32 CUDA cores' 67
// TFLOP/s alone would take 0.064 ms for jamba-1.5-large's 4.3 GFLOP.
//
// Two instances, chosen by dtype and head dim only:
//
// * flash_fwd_mma (bf16, D 16 / 32 / 64 / 128): FlashAttention-2 on the
//   tensor cores.  A block is 4 warps and 64 q rows; each warp owns 16 rows
//   and keeps their Q fragment in registers.  S = Q K^T and O += P V are
//   mma.sync m16n8k16 (bf16 in, f32 accumulate), K read by ldmatrix and V by
//   ldmatrix.trans.  The scale (folded with log2 e for exp2f), the softcap
//   and the mask are applied to the f32 S fragment per element, from each
//   element's (row, key) coordinates; the online softmax runs in registers,
//   its row max and sum reduced over the 4 lanes that share a row.  P is
//   rounded to bf16 in registers and fed as the A fragment of P V; the row
//   sum l adds the rounded values, so the output is a convex combination of
//   V rows whose weights carry ~2^-9 relative error each, well inside the
//   2e-2 bf16 tolerance against the f32-math plain version.  K / V tiles of
//   64 keys stay bf16 in shared memory (rows padded by 16 bytes, so the 8
//   rows an ldmatrix phase reads fall in distinct banks) and arrive by
//   16-byte cp.async in a 2-stage ring: tile j + 1 loads while tile j
//   computes.  Shared memory is dynamic (87 KB at D = 128).  The q tiles
//   are launched last-first, so the causal triangle's long tiles start
//   first and do not form a tail.
// * flash_fwd_simt (f32 at every head dim, and bf16 at D = 8): the products
//   on the f32 CUDA cores, exact to f32 rounding, which the f32 end-to-end
//   gates hold to 1e-3 on logits.  TPR = 4 threads per q row up to D = 64
//   and 8 at D = 128 (32 rows a block); K / V tiles converted to f32 in
//   static shared memory.
//
// Both write each row's log-sum-exp when the caller passes an lse buffer
// (training): lse = m + log(max(l, 1e-30)) over the scaled, softcapped
// scores, the lse of repro/kernels/flash_vjp.py's _fwd_impl, from the
// m / l the online softmax already holds, so it costs one f32 store a row.
// Serving passes null and writes nothing more.
//
// Work skipping (both): the KV range a q tile needs is computed from causal,
// window and q_offset (the Pallas kernel's pl.when(any_live) per tile), and
// ragged Sq / Sk edges are masked in the kernel (cp.async zero-fills rows
// past the end through its src-size operand) instead of padded copies.
#include "mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// flash_fwd_mma: bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kBM = 16 * kMmaWarps;  // q rows per block
constexpr int kBN = 64;              // keys per K / V tile

// bf16 elements per shared-memory row: +8 (16 bytes) so the 8 rows one
// ldmatrix phase reads start in 8 distinct 4-bank groups
template <int D> constexpr int kRowStride = D + 8;
template <int D> constexpr int kTileElems = kBN * kRowStride<D>;  // == kBM rows too
// K / V tiles in the ring
template <int D> constexpr int kStages = 2;
// Q, then K and V in kStages stages each
template <int D> constexpr int kMmaSmemBytes = (1 + 2 * kStages<D>) * kTileElems<D> * 2;

// rows [row0, row0 + n_valid) of a (rows, ld) bf16 matrix -> a 64-row
// shared tile; rows past n_valid are zero-filled
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int ld,
                                          int row0, int n_valid, int tid) {
  constexpr int kPerRow = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int i = tid; i < kBN * kPerRow; i += kMmaThreads) {
    const int r = i / kPerRow, c = i % kPerRow;
    const bool ok = r < n_valid;
    const __nv_bfloat16* p = src + static_cast<size_t>(row0 + (ok ? r : 0)) * ld + c * 8;
    cp_async16(smem_addr(dst + r * kRowStride<D> + c * 8), p, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
              float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv, int causal, int window,
              float softcap, float scale, int q_offset) {
  static_assert(D % 16 == 0 && D <= 128, "head_dim must be a multiple of the mma depth 16");
  constexpr int RS = kRowStride<D>;
  constexpr int KC = D / 16;  // k-steps of S = Q K^T
  constexpr int ND = D / 8;   // n-tiles of O
  constexpr int NT = kBN / 8; // n-tiles of S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  constexpr int NS = kStages<D>;
  __nv_bfloat16* ks = qs + kTileElems<D>;       // [NS][kBN][RS]
  __nv_bfloat16* vs = ks + NS * kTileElems<D>;  // [NS][kBN][RS]

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // longest (last) q tiles first
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane >> 2, tq = lane & 3;  // fragment row group, thread in group
  const int row0 = qt * kBM;
  const int n_rows = min(kBM, Sq - row0);
  const int ldq = Hq * D, ldkv = Hkv * D;
  const __nv_bfloat16* qg = q + (static_cast<size_t>(b) * Sq * Hq + h) * D;
  const __nv_bfloat16* kg = k + (static_cast<size_t>(b) * Sk * Hkv + hk) * D;
  const __nv_bfloat16* vg = v + (static_cast<size_t>(b) * Sk * Hkv + hk) * D;

  // KV range any row of this tile can see
  const int last_row = row0 + n_rows - 1;
  const int k_hi = causal ? min(Sk, q_offset + last_row + 1) : Sk;
  const int k_lo = window >= 0 ? max(0, q_offset + row0 - window + 1) : 0;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kBN - 1) / kBN : 0;

  auto load_kv = [&](int it) {  // K / V tile it into stage it % NS
    const int k0 = k_lo + it * kBN;
    const int n = min(kBN, k_hi - k0);
    load_tile<D>(ks + (it % NS) * kTileElems<D>, kg, ldkv, k0, n, tid);
    load_tile<D>(vs + (it % NS) * kTileElems<D>, vg, ldkv, k0, n, tid);
  };
  load_tile<D>(qs, qg, ldq, row0, n_rows, tid);
  cp_async_commit();
#pragma unroll
  for (int it = 0; it < NS - 1; ++it) {
    if (it < n_tiles) load_kv(it);
    cp_async_commit();
  }
  cp_async_wait<NS - 1>();  // Q has landed
  __syncthreads();

  uint32_t qf[KC][4];  // this warp's 16 Q rows as mma A fragments
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
    ldmatrix_x4(qf[kc], smem_addr(qs + (warp * 16 + (lane & 15)) * RS + kc * 16 + (lane >> 4) * 8));

  // S in the log2 domain: s * scale * log2 e, or cap * log2 e * tanh(s * scale / cap)
  const bool capped = softcap > 0.f;
  const float s_mul = capped ? scale / softcap : scale * kLog2e;
  const float cap_mul = softcap * kLog2e;
  // absolute positions of this thread's two rows (gr and gr + 8 of the warp's 16)
  const int qpos0 = q_offset + row0 + warp * 16 + gr;

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_r[2] = {REPRO_NEG_INF, REPRO_NEG_INF};
  float l_r[2] = {0.f, 0.f};  // this thread's share of the row sums

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_lo + it * kBN;
    cp_async_wait<NS - 2>();  // tile it has landed (this thread's copies)
    __syncthreads();          // ... and every thread's; all are done with tile it - 1
    if (it + NS - 1 < n_tiles) load_kv(it + NS - 1);  // into tile it - 1's stage
    cp_async_commit();
    const __nv_bfloat16* kt = ks + (it % NS) * kTileElems<D>;
    const __nv_bfloat16* vt = vs + (it % NS) * kTileElems<D>;

    // S = Q K^T: 16 rows x 64 keys per warp; step i reads the K fragment of
    // dims (i / 4) * 16 and keys (i % 4) * 16, fetched kFetch steps ahead
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    pipelined<KC * NT / 2>(
        [&](int i, uint32_t (&r)[4]) {
          const int kc = i / (NT / 2), np = i % (NT / 2);
          ldmatrix_x4(r, smem_addr(kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * RS +
                                   kc * 16 + ((lane >> 3) & 1) * 8));
        },
        [&](int i, const uint32_t (&r)[4]) {
          const int kc = i / (NT / 2), np = i % (NT / 2);
          mma_bf16(s[2 * np], qf[kc], r[0], r[1]);
          mma_bf16(s[2 * np + 1], qf[kc], r[2], r[3]);
        });

    // scale, softcap, and the mask where the tile is not wholly visible
    const bool full = k0 + kBN <= k_hi &&
                      (!causal || k0 + kBN - 1 <= q_offset + row0) &&
                      (window < 0 || k0 > q_offset + last_row - window);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e];
        x = capped ? cap_mul * tanhf(x * s_mul) : x * s_mul;
        if (!full) {
          const int kpos = k0 + n * 8 + 2 * tq + (e & 1);
          const int qpos = qpos0 + (e >> 1) * 8;
          bool live = kpos < k_hi;
          if (causal) live = live && kpos <= qpos;
          if (window >= 0) live = live && kpos > qpos - window;
          if (!live) x = REPRO_NEG_INF;
        }
        s[n][e] = x;
      }

    // online softmax, rows gr (elements 0, 1) and gr + 8 (elements 2, 3)
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = exp2f(m_r[i] - mx[i]);
      m_r[i] = mx[i];
    }
    // P as the A fragments of P V (16 rows x 16 keys each): the S tiles of
    // keys 16j .. +7 and 16j + 8 .. +15 are its left and right halves
    uint32_t pa[NT / 2][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const uint32_t lo = pack_bf16(exp2f(s[n][0] - mx[0]), exp2f(s[n][1] - mx[0]), &psum[0]);
      const uint32_t hi = pack_bf16(exp2f(s[n][2] - mx[1]), exp2f(s[n][3] - mx[1]), &psum[1]);
      pa[n / 2][(n & 1) * 2] = lo;
      pa[n / 2][(n & 1) * 2 + 1] = hi;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_r[i] = l_r[i] * corr[i] + psum[i];
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // O += P V; step i reads the V fragment of keys (i / (ND / 2)) * 16 and
    // dims (i % (ND / 2)) * 16
    pipelined<NT / 2 * ND / 2>(
        [&](int i, uint32_t (&r)[4]) {
          const int kc = i / (ND / 2), dp = i % (ND / 2);
          ldmatrix_x4_trans(r, smem_addr(vt + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS +
                                         dp * 16 + (lane >> 4) * 8));
        },
        [&](int i, const uint32_t (&r)[4]) {
          const int kc = i / (ND / 2), dp = i % (ND / 2);
          mma_bf16(acc[2 * dp], pa[kc], r[0], r[1]);
          mma_bf16(acc[2 * dp + 1], pa[kc], r[2], r[3]);
        });
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    l_r[i] = fmaxf(l_r[i], 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + warp * 16 + gr + i * 8;
    if (row >= Sq) continue;
    // m is in the log2 domain; a row that saw no live key keeps -1e30
    if (lse != nullptr && tq == 0)
      lse[(static_cast<size_t>(b) * Hq + h) * Sq + row] =
          m_r[i] <= REPRO_NEG_INF ? REPRO_NEG_INF : m_r[i] * kLn2 + logf(l_r[i]);
    l_r[i] = 1.f / l_r[i];
    __nv_bfloat16* op = o + (static_cast<size_t>(b) * Sq + row) * ldq + h * D + 2 * tq;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(op + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * i] * l_r[i], acc[n][2 * i + 1] * l_r[i]);
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                       int Sq, int Sk, int Hq, int Hkv, int causal, int window, float softcap,
                       float scale, int q_offset, cudaStream_t stream) {
  constexpr int smem = kMmaSmemBytes<D>;
  const cudaError_t attr = allow_smem<flash_fwd_mma<D>>(smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(Hq, B, (Sq + kBM - 1) / kBM);
  flash_fwd_mma<D><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, Sq, Sk, Hq,
      Hkv, causal, window, softcap, scale, q_offset);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// flash_fwd_simt: f32 (and bf16 at D = 8) on the CUDA cores
// ---------------------------------------------------------------------------
//
// 256 threads, TPR threads per q row.  Thread g of a row owns the dims
// VW*(g + TPR*i) .. +VW-1, so the threads of a row read neighbouring words
// of a K/V row in shared memory and a warp reads TPR vectors at once (no
// bank conflicts; the rows of a warp share them by broadcast).  The row's
// q.k partial sums meet by xor-shuffles.  The K/V tile is 64 keys up to
// D = 64 and 32 keys at D = 128, so the two f32 tiles stay at 32 KB of
// static shared memory.

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
flash_fwd_simt(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               T* __restrict__ o, float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv,
               int causal, int window, float softcap, float scale, int q_offset) {
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
    if (lse != nullptr && g == 0) lse[(static_cast<size_t>(b) * Hq + h) * Sq + row] = m + logf(lc);
    T* op = o + ((static_cast<size_t>(b) * Sq + row) * Hq + h) * D;
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int e = 0; e < VW; ++e)
        op[VW * (g + TPR * i) + e] = from_f32<T>(acc[i * VW + e] / lc);
  }
}

template <typename T, int D>
cudaError_t launch_simt(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                        int Sq, int Sk, int Hq, int Hkv, int causal, int window, float softcap,
                        float scale, int q_offset, cudaStream_t stream) {
  const dim3 grid((Sq + kRows<D> - 1) / kRows<D>, Hq, B);
  flash_fwd_simt<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, Sq, Sk, Hq, Hkv, causal, window, softcap, scale, q_offset);
  return cudaGetLastError();
}

#define FA_ARGS \
  q, k, v, o, static_cast<float*>(lse), B, Sq, Sk, Hq, Hkv, causal, window, softcap, scale, \
      q_offset, st

}  // namespace

// window < 0: no sliding window.  softcap <= 0: no softcap.  lse: null, or
// f32 (B, Hq, Sq) for each row's log-sum-exp of its scaled, softcapped
// scores (what the backward, flash_attention_bwd.cu, recomputes P from).
// The instance depends on dtype and D only; an unsupported pair returns an
// error.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int dtype, int B, int Sq, int Sk, int Hq,
                                   int Hkv, int D, int causal, int window, float softcap,
                                   float scale, int q_offset, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    switch (D) {
      case 8: return launch_simt<__nv_bfloat16, 8>(FA_ARGS);
      case 16: return launch_mma<16>(FA_ARGS);
      case 32: return launch_mma<32>(FA_ARGS);
      case 64: return launch_mma<64>(FA_ARGS);
      case 128: return launch_mma<128>(FA_ARGS);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == kF32) {
    switch (D) {
      case 8: return launch_simt<float, 8>(FA_ARGS);
      case 16: return launch_simt<float, 16>(FA_ARGS);
      case 32: return launch_simt<float, 32>(FA_ARGS);
      case 64: return launch_simt<float, 64>(FA_ARGS);
      case 128: return launch_simt<float, 128>(FA_ARGS);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}
