// Split-KV decode attention for Hopper (sm_90a): one new query token per
// sequence against a KV cache whose slots carry absolute positions (full
// cache or sliding-window ring buffer), GQA, tanh softcap, f32 online
// softmax.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (decode_attention, _decode_kernel).  There a sequential grid axis walks
// cache blocks with m / l / acc in VMEM scratch for one (batch row, KV
// head).  On the card that is B * Hkv blocks (16 at qwen2-0.5b's batch 8),
// far too few for 132 SMs, so the cache is split and one call runs two
// kernels:
//
// * pass 1, the split pass: grid (split, KV head, batch row).  Each block
//   walks one contiguous range of n_chunk slots (a multiple of 32) for all
//   G = Hq / Hkv query rows of its KV head and writes f32 partials
//   acc (G, D), m (G), l (G): exactly decode_attention_ref(return_stats=
//   True) on that range; a range with no live slot writes (0, -1e30, 0).
//   The wrapper picks the split (split_plan) from the shapes and the SM
//   count alone, for >= 2 waves of blocks where S allows, so a call has no
//   host sync and fixed shapes.
// * pass 2, decode_combine_kernel: per (batch row, query head),
//   m = max m_i, out = sum acc_i e^(m_i - m) / max(sum l_i e^(m_i - m),
//   1e-30), in a fixed order: no atomics, so the result is reproducible bit
//   for bit.  A row with no live slot at all returns zeros, as the Pallas
//   kernel does (its pl.when(any(ok)) skips every block); the plain
//   decode_attention_ref returns the mean of V there instead.
//   In its stats mode (decode_attention_fwd_stats) it writes the row's
//   unnormalised f32 partials over all its splits instead of out:
//   acc = sum acc_i e^(m_i - m), m, l = sum l_i e^(m_i - m), i.e.
//   decode_attention_ref(return_stats=True) over the whole cache, which a
//   sequence-sharded decode combines across devices; (0, -1e30, 0) for a
//   row with no live slot.
//
// A slot is live iff 0 <= pos <= cur and (no window or pos > cur - window),
// exactly the Pallas kernel's mask.  A block first marks which of its tiles
// hold a live slot, and only those tiles' K / V are ever read.  Tiles stay
// in the cache dtype in shared memory and arrive by 16-byte cp.async in
// 3-stage rings (two tiles in flight while one computes).
//
// What bounds it: reading the cache once per token is the work (~1 FLOP a
// byte), so the card's bound is memory, and what a kernel needs is blocks
// and bytes in flight, and few enough instructions per byte that the SMs
// keep up.  Two split passes, chosen by dtype and head dim only:
//
// * decode_split_mma (bf16, D 16..256): the G rows, padded to 16, are one
//   mma.sync A operand; the 4 warps of a block take the range's 16-slot
//   tiles in turn, each with its own ring and m / l / acc, and merge at the
//   end.  On the CUDA cores the same pass is compute-bound at jamba-1.5-
//   large's G = 8, D = 128: per slot and row it costs 4 FMAs and 5 shuffles
//   per lane against 8 bytes read.  At D 256 the accumulator is 128
//   registers a thread, so Q's fragments are read from shared memory at
//   each k-step (one step ahead of their mmas) instead of held; the rings
//   take 198 KB, one block an SM.
// * decode_split_kernel (f32 at every D, bf16 at D 8): f32 math on the CUDA
//   cores, exact to f32 rounding for the f32 end-to-end gates.  Every
//   thread works in both steps: in the score step TPS lanes share a slot
//   (EPT = 4 dims each up to D 128, 8 at D 256, so TPS = D / EPT <= 32) and
//   meet by xor-shuffle, for all G rows at once; in the P V step a thread
//   owns EPT dims of one row, and when G * TPS leaves threads over (G = 1)
//   the slots of the tile are dealt out among them and summed at the end of
//   the range.  A thread's dims are runs of 4 at 4 * (part + TPS * c), so
//   the lanes of a slot read neighbouring 16-byte words.
//
// Layout: q (B, Hq, D), k / v cache (B, S, Hkv, D), pos_ids (B, S) int32,
// cur_pos (B,) int32, out (B, Hq, D), all contiguous; partials acc
// (B, Hkv, n_split, G, D), m and l (B, Hkv, n_split, G), f32, from the
// wrapper.  Head dims 8..256, G up to 16.
#include "mma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;   // cache slots per tile: one per lane in the softmax step
constexpr int kStages = 3;  // tiles in the shared-memory ring
constexpr int kMaxG = 16;   // query rows per KV head
constexpr int kEpt = 4;     // dims per thread of the combine

// 4 consecutive elements of shared memory as f32
__device__ __forceinline__ void ld4(const float* p, float (&x)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
}
__device__ __forceinline__ void ld4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  x[0] = a.x; x[1] = a.y; x[2] = c.x; x[3] = c.y;
}

__device__ __forceinline__ bool slot_live(int p, int cur, int window) {
  return p >= 0 && p <= cur && (window < 0 || p > cur - window);
}

// ---------------------------------------------------------------------------
// decode_split_kernel: the split pass on the CUDA cores (f32, and bf16 at D 8)
// ---------------------------------------------------------------------------

template <typename T, int D>
struct Split {
  static constexpr int kEpt = D <= 128 ? 4 : D / 32;  // dims per thread in both steps
  static constexpr int kTps = D / kEpt;               // lanes per slot in the score step
  static constexpr int kSlotsPerStep = kThreads / kTps;
  static constexpr int kTileElems = kTile * D;
  static constexpr int kChunks = kTileElems * static_cast<int>(sizeof(T)) / 16;  // per K or V tile
  // (row, kEpt dims) items of the P V step a thread may own: G * kTps / kThreads, rounded up
  static constexpr int kMaxItems = (kMaxG * kTps + kThreads - 1) / kThreads;
  // shared memory: the K / V ring, the scores, m / l / corr, the P V step's
  // cross-phase sums (G * kTps * n_phase <= kThreads items of kEpt), then
  // one flag per tile of the range
  static constexpr int kRingBytes = 2 * kStages * kTileElems * static_cast<int>(sizeof(T));
  static constexpr int kFixedBytes =
      kRingBytes + (kMaxG * kTile + 3 * kMaxG + kThreads * kEpt) * 4;
  static_assert(kTps >= 2 && kTps <= 32 && 32 % kTps == 0 && kEpt % 4 == 0,
                "head_dim must be 8..256, a power of 2");
  static_assert(D * sizeof(T) % 16 == 0, "a slot's row must split into 16-byte chunks");
  // the dim of a thread's i-th element, for its slot part (lane of the slot) p
  static __device__ __forceinline__ int dim(int p, int i) { return 4 * (p + kTps * (i / 4)) + i % 4; }
};

// kEpt elements of shared memory at the dims of slot part p, as f32
template <typename P, typename T>
__device__ __forceinline__ void ld_part(const T* row, int p, float (&x)[P::kEpt]) {
#pragma unroll
  for (int c = 0; c < P::kEpt / 4; ++c) {
    float y[4];
    ld4(row + P::dim(p, 4 * c), y);
#pragma unroll
    for (int e = 0; e < 4; ++e) x[4 * c + e] = y[e];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ pos_ids, const int* __restrict__ cur_pos,
                    float* __restrict__ acc_out, float* __restrict__ m_out,
                    float* __restrict__ l_out, int S, int Hq, int Hkv, int window, float softcap,
                    float scale, int n_chunk) {
  using P = Split<T, D>;
  constexpr int TPS = P::kTps;
  constexpr int EPT = P::kEpt;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);                 // [kStages][kTile][D]
  T* vs = ks + kStages * P::kTileElems;                   // [kStages][kTile][D]
  float* ps = reinterpret_cast<float*>(smem_raw + P::kRingBytes);  // [kMaxG][kTile]
  float* m_s = ps + kMaxG * kTile;
  float* l_s = m_s + kMaxG;
  float* corr_s = l_s + kMaxG;
  float* red = corr_s + kMaxG;                            // [kThreads][EPT]
  unsigned char* live_tile = reinterpret_cast<unsigned char*>(red + kThreads * EPT);

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int cur = cur_pos[b];
  const int s_begin = split * n_chunk;
  const int s_end = min(S, s_begin + n_chunk);
  const int n_tiles = (s_end - s_begin + kTile - 1) / kTile;
  const int* pos = pos_ids + static_cast<size_t>(b) * S;
  const size_t ld = static_cast<size_t>(Hkv) * D;  // elements from one slot to the next
  const T* kg = k + static_cast<size_t>(b) * S * ld + hk * D;
  const T* vg = v + static_cast<size_t>(b) * S * ld + hk * D;

  // which tiles of the range hold a live slot: one warp per tile
  for (int t = warp; t < n_tiles; t += kWarps) {
    const int s = s_begin + t * kTile + lane;
    const bool ok = s < s_end && slot_live(pos[s], cur, window);
    const unsigned any = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) live_tile[t] = any != 0;
  }
  if (tid < kMaxG) {
    m_s[tid] = REPRO_NEG_INF;
    l_s[tid] = 0.f;
  }

  // score step: slot group sg, the dims of slot part `part` of every row's
  // q (scaled)
  const int part = tid % TPS, sg = tid / TPS;
  float qv[kMaxG][EPT];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
    if (g < G) {
      const T* qp = q + (static_cast<size_t>(b) * Hq + hk * G + g) * D;
#pragma unroll
      for (int e = 0; e < EPT; ++e) qv[g][e] = to_f32(qp[P::dim(part, e)]) * scale;
    }

  // P V step: items (row, slot part); with fewer items than threads,
  // n_phase threads share an item and take every n_phase-th slot of a tile
  const int n_items = G * TPS;
  int n_phase = 1;
  while (2 * n_phase * n_items <= kThreads) n_phase *= 2;
  float acc[P::kMaxItems][EPT];
#pragma unroll
  for (int r = 0; r < P::kMaxItems; ++r)
#pragma unroll
    for (int e = 0; e < EPT; ++e) acc[r][e] = 0.f;

  __syncthreads();  // live_tile, m_s, l_s

  auto next_live = [&](int t) {
    while (t < n_tiles && !live_tile[t]) ++t;
    return t;
  };
  auto load = [&](int t, int stage) {
    const int s0 = s_begin + t * kTile;
    T* kd = ks + stage * P::kTileElems;
    T* vd = vs + stage * P::kTileElems;
    constexpr int kPerRow = D * static_cast<int>(sizeof(T)) / 16;  // 16-byte chunks per slot
    for (int i = tid; i < P::kChunks; i += kThreads) {
      const int j = i / kPerRow, c = i % kPerRow;
      const bool ok = s0 + j < s_end;
      const size_t off = static_cast<size_t>(ok ? s0 + j : s0) * ld + c * (16 / sizeof(T));
      const int so = j * D + c * (16 / static_cast<int>(sizeof(T)));
      cp_async16(smem_addr(kd + so), kg + off, ok);
      cp_async16(smem_addr(vd + so), vg + off, ok);
    }
  };

  int fetch = next_live(0);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (fetch < n_tiles) {
      load(fetch, st);
      fetch = next_live(fetch + 1);
    }
    cp_async_commit();
  }

  int stage = 0;
  for (int t = next_live(0); t < n_tiles; t = next_live(t + 1)) {
    cp_async_wait<kStages - 2>();  // tile t has landed
    __syncthreads();               // ... for every thread; the previous stage is free
    if (fetch < n_tiles) {
      load(fetch, (stage + kStages - 1) % kStages);
      fetch = next_live(fetch + 1);
    }
    cp_async_commit();
    const T* kt = ks + stage * P::kTileElems;
    const T* vt = vs + stage * P::kTileElems;
    const int s0 = s_begin + t * kTile;

    // scores: TPS lanes per slot, all G rows at once
    for (int j = sg; j < kTile; j += P::kSlotsPerStep) {
      float kx[EPT];
      ld_part<P>(kt + j * D, part, kx);
      const int s = s0 + j;
      const bool live = s < s_end && slot_live(pos[s], cur, window);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPT; ++e) dot += qv[g][e] * kx[e];
#pragma unroll
        for (int off = TPS / 2; off > 0; off /= 2) dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (part == 0) {
          if (softcap > 0.f) dot = tanhf(dot / softcap) * softcap;
          ps[g * kTile + j] = live ? dot : REPRO_NEG_INF;
        }
      }
    }
    __syncthreads();

    // online softmax: one warp per row, one lane per slot
    for (int g = warp; g < G; g += kWarps) {
      const float x = ps[g * kTile + lane];
      float mx = x;
#pragma unroll
      for (int off = 16; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float p = expf(x - m_new);
      ps[g * kTile + lane] = p;
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        corr_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
#pragma unroll
    for (int r = 0; r < P::kMaxItems; ++r) {
      const int idx = tid + r * kThreads;
      if (idx < n_items * n_phase) {
        const int item = idx % n_items, phase = idx / n_items;
        const int g = item / TPS, pt = item % TPS;
        const float c = corr_s[g];
#pragma unroll
        for (int e = 0; e < EPT; ++e) acc[r][e] *= c;
        for (int j = phase; j < kTile; j += n_phase) {
          const float p = ps[g * kTile + j];
          float vx[EPT];
          ld_part<P>(vt + j * D, pt, vx);
#pragma unroll
          for (int e = 0; e < EPT; ++e) acc[r][e] += p * vx[e];
        }
      }
    }
    stage = (stage + 1) % kStages;
  }
  cp_async_wait<0>();

  // partials of this range: acc summed over the phases, m, l
  const size_t row0 = (static_cast<size_t>(b) * Hkv + hk) * n_split + split;  // in units of G rows
  if (n_phase > 1) {
    __syncthreads();
    if (tid < n_items * n_phase)
#pragma unroll
      for (int e = 0; e < EPT; ++e) red[tid * EPT + e] = acc[0][e];
    __syncthreads();
    if (tid < n_items) {
      float sum[EPT] = {};
      for (int ph = 0; ph < n_phase; ++ph)
#pragma unroll
        for (int e = 0; e < EPT; ++e) sum[e] += red[(ph * n_items + tid) * EPT + e];
      const int g = tid / TPS, pt = tid % TPS;
      float* out = acc_out + (row0 * G + g) * D;
#pragma unroll
      for (int e = 0; e < EPT; ++e) out[P::dim(pt, e)] = sum[e];
    }
  } else {
#pragma unroll
    for (int r = 0; r < P::kMaxItems; ++r) {
      const int item = tid + r * kThreads;
      if (item < n_items) {
        const int g = item / TPS, pt = item % TPS;
        float* out = acc_out + (row0 * G + g) * D;
#pragma unroll
        for (int e = 0; e < EPT; ++e) out[P::dim(pt, e)] = acc[r][e];
      }
    }
  }
  if (tid < G) {
    m_out[row0 * G + tid] = m_s[tid];
    l_out[row0 * G + tid] = l_s[tid];
  }
}

// ---------------------------------------------------------------------------
// decode_split_mma: the bf16 split pass on the tensor cores
// ---------------------------------------------------------------------------
//
// Same range, mask and partials as decode_split_kernel.  The G query rows,
// padded to the mma's 16, are one A operand for every tile (held in
// registers up to D 128, read from shared memory at each k-step at D 256,
// where the accumulator takes 128 registers a thread); the 4 warps of
// a block take the range's 16-slot tiles in turn (warp w: tiles w, w + 4,
// ...), each with its own 3-stage cp.async ring and its own m / l / acc in
// registers, and merge at the end in warp order.  S = Q K^T and acc += P V
// are mma.sync m16n8k16 as in flash_fwd_mma, P rounded to bf16 (l adds the
// rounded values).  A block marks its live slots once, as one bit each.

constexpr int kMmaTile = 16;   // cache slots per warp tile: one k-step of P V
constexpr int kMmaStages = 3;  // tiles in each warp's ring

template <int D>
struct SplitMma {
  static constexpr bool kQInRegs = D <= 128;  // Q's fragments held for the whole range
  static constexpr int kRS = D + 8;  // bf16 per shared row: ldmatrix phases hit 8 bank groups
  static constexpr int kTileElems = kMmaTile * kRS;
  static constexpr int kQBytes = 16 * kRS * 2;
  static constexpr int kRingBytes = kWarps * kMmaStages * 2 * kTileElems * 2;
  static constexpr int kMergeBytes = kWarps * 16 * D * 4;  // per-warp acc, over the ring
  static constexpr int kBodyBytes = kRingBytes > kMergeBytes ? kRingBytes : kMergeBytes;
  static constexpr int kFixedBytes = kQBytes + kBodyBytes + 2 * kWarps * 16 * 4;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
decode_split_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const int* __restrict__ pos_ids,
                 const int* __restrict__ cur_pos, float* __restrict__ acc_out,
                 float* __restrict__ m_out, float* __restrict__ l_out, int S, int Hq, int Hkv,
                 int window, float softcap, float scale, int n_chunk) {
  using P = SplitMma<D>;
  constexpr int RS = P::kRS;
  constexpr int KC = D / 16;  // k-steps of S = Q K^T
  constexpr int ND = D / 8;   // n-tiles of acc
  static_assert(D % 16 == 0 && D <= 256, "head_dim must be a multiple of the mma depth 16");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [16][RS]
  unsigned char* body = smem_raw + P::kQBytes;
  float* merge = reinterpret_cast<float*>(body);  // [kWarps][16][D], after the ring is done
  float* wm = reinterpret_cast<float*>(body + P::kBodyBytes);  // [kWarps][16]
  float* wl = wm + kWarps * 16;                                 // [kWarps][16]
  uint32_t* live_bits = reinterpret_cast<uint32_t*>(wl + kWarps * 16);  // a bit per slot

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gr = lane >> 2, tq = lane & 3;
  const int cur = cur_pos[b];
  const int s_begin = split * n_chunk;
  const int s_end = min(S, s_begin + n_chunk);
  const int n_words = (s_end - s_begin + 31) / 32;
  const int n_tiles = (s_end - s_begin + kMmaTile - 1) / kMmaTile;
  const int* pos = pos_ids + static_cast<size_t>(b) * S;
  const size_t ld = static_cast<size_t>(Hkv) * D;
  const __nv_bfloat16* kg = k + static_cast<size_t>(b) * S * ld + hk * D;
  const __nv_bfloat16* vg = v + static_cast<size_t>(b) * S * ld + hk * D;

  for (int w = warp; w < n_words; w += kWarps) {
    const int s = s_begin + w * 32 + lane;
    const unsigned bits = __ballot_sync(0xffffffffu, s < s_end && slot_live(pos[s], cur, window));
    if (lane == 0) live_bits[w] = bits;
  }
  for (int i = tid; i < 16 * D / 8; i += kThreads) {  // the G q rows, zero-padded to 16
    const int r = i / (D / 8), c = i % (D / 8);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < G)
      val = *reinterpret_cast<const uint4*>(q + (static_cast<size_t>(b) * Hq + hk * G + r) * D + c * 8);
    *reinterpret_cast<uint4*>(qs + r * RS + c * 8) = val;
  }
  __syncthreads();

  // ldmatrix address of Q's fragment of k-step kc: q_addr + 32 kc bytes
  const uint32_t q_addr = smem_addr(qs + (lane & 15) * RS + (lane >> 4) * 8);
  uint32_t qf[P::kQInRegs ? KC : 1][4];
  if constexpr (P::kQInRegs) {
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) ldmatrix_x4(qf[kc], q_addr + kc * 32);
  }
  const bool capped = softcap > 0.f;
  const float s_mul = capped ? scale / softcap : scale * kLog2e;
  const float cap_mul = softcap * kLog2e;

  auto tile_bits = [&](int t) {  // live bits of tile t's 16 slots
    return (live_bits[t / 2] >> ((t & 1) * 16)) & 0xffffu;
  };
  auto next_tile = [&](int t) {  // this warp's next tile with a live slot, from t
    while (t < n_tiles && tile_bits(t) == 0) t += kWarps;
    return t;
  };
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(body) +
                        warp * kMmaStages * 2 * P::kTileElems;  // [stage][K, V][16][RS]
  auto load = [&](int t, int stage) {
    const int s0 = s_begin + t * kMmaTile;
    __nv_bfloat16* kd = ring + stage * 2 * P::kTileElems;
    __nv_bfloat16* vd = kd + P::kTileElems;
    constexpr int kPerRow = D / 8;  // 16-byte chunks per slot
#pragma unroll
    for (int i = lane; i < kMmaTile * kPerRow; i += 32) {
      const int j = i / kPerRow, c = i % kPerRow;
      const bool ok = s0 + j < s_end;
      const size_t off = static_cast<size_t>(ok ? s0 + j : s0) * ld + c * 8;
      cp_async16(smem_addr(kd + j * RS + c * 8), kg + off, ok);
      cp_async16(smem_addr(vd + j * RS + c * 8), vg + off, ok);
    }
  };

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_r[2] = {REPRO_NEG_INF, REPRO_NEG_INF};  // log2 domain
  float l_r[2] = {0.f, 0.f};

  int fetch = next_tile(warp);
#pragma unroll
  for (int st = 0; st < kMmaStages - 1; ++st) {
    if (fetch < n_tiles) {
      load(fetch, st);
      fetch = next_tile(fetch + kWarps);
    }
    cp_async_commit();
  }
  int stage = 0;
  for (int t = next_tile(warp); t < n_tiles; t = next_tile(t + kWarps)) {
    cp_async_wait<kMmaStages - 2>();  // tile t has landed (this lane's copies)
    __syncwarp();                     // ... and every lane's; the previous stage is free
    if (fetch < n_tiles) {
      load(fetch, (stage + kMmaStages - 1) % kMmaStages);
      fetch = next_tile(fetch + kWarps);
    }
    cp_async_commit();
    const __nv_bfloat16* kt = ring + stage * 2 * P::kTileElems;
    const __nv_bfloat16* vt = kt + P::kTileElems;
    const unsigned bits = tile_bits(t);

    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};  // 16 rows x 16 slots
    auto k_frag = [&](uint32_t (&r)[4], int kc) {  // the tile's K fragment of k-step kc
      ldmatrix_x4(r, smem_addr(kt + ((lane & 7) + ((lane >> 4) << 3)) * RS + kc * 16 +
                               ((lane >> 3) & 1) * 8));
    };
    if constexpr (P::kQInRegs) {
      pipelined<KC>(
          [&](int kc, uint32_t (&r)[4]) { k_frag(r, kc); },
          [&](int kc, const uint32_t (&r)[4]) {
            mma_bf16(s[0], qf[kc], r[0], r[1]);
            mma_bf16(s[1], qf[kc], r[2], r[3]);
          });
    } else {
      pipelined<KC, 8>(  // Q's fragment, then K's
          [&](int kc, uint32_t (&r)[8]) {
            ldmatrix_x4(frag4(r, 0), q_addr + kc * 32);
            k_frag(frag4(r, 4), kc);
          },
          [&](int, const uint32_t (&r)[8]) {
            mma_bf16(s[0], frag4(r, 0), r[4], r[5]);
            mma_bf16(s[1], frag4(r, 0), r[6], r[7]);
          });
    }
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e];
        x = capped ? cap_mul * tanhf(x * s_mul) : x * s_mul;
        if (!((bits >> (n * 8 + 2 * tq + (e & 1))) & 1u)) x = REPRO_NEG_INF;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = exp2f(m_r[i] - mx[i]);
      m_r[i] = mx[i];
    }
    uint32_t pa[4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      pa[2 * n] = pack_bf16(exp2f(s[n][0] - mx[0]), exp2f(s[n][1] - mx[0]), &psum[0]);
      pa[2 * n + 1] = pack_bf16(exp2f(s[n][2] - mx[1]), exp2f(s[n][3] - mx[1]), &psum[1]);
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
    pipelined<ND / 2>(
        [&](int dp, uint32_t (&r)[4]) {
          ldmatrix_x4_trans(r, smem_addr(vt + ((lane & 7) + ((lane >> 3) & 1) * 8) * RS +
                                         dp * 16 + (lane >> 4) * 8));
        },
        [&](int dp, const uint32_t (&r)[4]) {
          mma_bf16(acc[2 * dp], pa, r[0], r[1]);
          mma_bf16(acc[2 * dp + 1], pa, r[2], r[3]);
        });
    stage = (stage + 1) % kMmaStages;
  }
  cp_async_wait<0>();

  // merge the 4 warps in warp order: m = max m_w, acc = sum acc_w 2^(m_w - m)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
  }
  if (tq == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      wm[warp * 16 + gr + 8 * i] = m_r[i];
      wl[warp * 16 + gr + 8 * i] = l_r[i];
    }
  }
  __syncthreads();  // every warp is done with its ring, and wm / wl are in
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = gr + 8 * i;
    float m_all = REPRO_NEG_INF;
    for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, wm[w * 16 + row]);
    const float f = exp2f(m_r[i] - m_all);
    float* mp = merge + (warp * 16 + row) * D + 2 * tq;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      mp[n * 8] = acc[n][2 * i] * f;
      mp[n * 8 + 1] = acc[n][2 * i + 1] * f;
    }
  }
  __syncthreads();
  const size_t row0 = (static_cast<size_t>(b) * Hkv + hk) * n_split + split;  // in units of G rows
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) sum += merge[(w * 16 + g) * D + d];
    acc_out[(row0 * G + g) * D + d] = sum;
  }
  if (tid < G) {
    float m_all = REPRO_NEG_INF, l_all = 0.f;
    for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, wm[w * 16 + tid]);
    for (int w = 0; w < kWarps; ++w) l_all += wl[w * 16 + tid] * exp2f(wm[w * 16 + tid] - m_all);
    // back to the natural-log domain of the partials; (0, -1e30, 0) without a live slot
    m_out[row0 * G + tid] = l_all > 0.f ? m_all / kLog2e : REPRO_NEG_INF;
    l_out[row0 * G + tid] = l_all;
  }
}

// out[b, h] = sum_i acc_i e^(m_i - m) / max(sum_i l_i e^(m_i - m), 1e-30):
// a block per (batch row, query head); the split weights e^(m_i - m) go to
// shared memory first, then D / 4 lanes per split phase sum acc_i, and the
// phases meet in shared memory.  Every sum runs in a fixed order (no
// atomics), so the result is reproducible bit for bit.  kStats: write the
// numerator (B, Hq, D), then m (B, Hq), then the denominator (B, Hq) to
// stats, all f32, and no out.
template <typename T, bool kStats>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ acc, const float* __restrict__ m,
                      const float* __restrict__ l, T* __restrict__ o, float* __restrict__ stats,
                      int Hq, int Hkv, int D, int n_split) {
  extern __shared__ float wts[];  // [n_split] weights, then [kThreads][kEpt] phase sums
  __shared__ float red[kWarps];
  float* part = wts + n_split;
  const int h = blockIdx.x, b = blockIdx.y;
  const int G = Hq / Hkv, hk = h / G, g = h % G;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const size_t row0 = (static_cast<size_t>(b) * Hkv + hk) * n_split;  // in units of G rows

  float mx = REPRO_NEG_INF;
  for (int i = tid; i < n_split; i += kThreads) mx = fmaxf(mx, m[(row0 + i) * G + g]);
#pragma unroll
  for (int off = 16; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  float m_all = red[0];
  for (int w = 1; w < kWarps; ++w) m_all = fmaxf(m_all, red[w]);
  float den = 0.f;
  for (int i = tid; i < n_split; i += kThreads) {
    const size_t r = (row0 + i) * G + g;
    const float w = expf(m[r] - m_all);
    wts[i] = w;
    den += l[r] * w;
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) den += __shfl_xor_sync(0xffffffffu, den, off);
  __syncthreads();  // red is read; the weights are in
  if (lane == 0) red[warp] = den;

  const int lanes = D / kEpt;             // lanes per split phase
  const int n_phase = kThreads / lanes;   // D = 8..128: 64..4 phases
  const int phase = tid / lanes, d0 = (tid % lanes) * kEpt;
  float num[kEpt] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int i = phase; i < n_split; i += n_phase) {
    const float4 a = *reinterpret_cast<const float4*>(acc + ((row0 + i) * G + g) * D + d0);
    const float w = wts[i];
    num[0] += a.x * w; num[1] += a.y * w; num[2] += a.z * w; num[3] += a.w * w;
  }
#pragma unroll
  for (int e = 0; e < kEpt; ++e) part[tid * kEpt + e] = num[e];
  __syncthreads();
  if (tid < lanes) {
    float total = red[0];
    for (int w = 1; w < kWarps; ++w) total += red[w];
    const float inv = 1.f / fmaxf(total, 1e-30f);
    float sum[kEpt] = {0.f, 0.f, 0.f, 0.f};
    for (int ph = 0; ph < n_phase; ++ph)
#pragma unroll
      for (int e = 0; e < kEpt; ++e) sum[e] += part[(ph * lanes + tid) * kEpt + e];
    const size_t row = static_cast<size_t>(b) * Hq + h;
    if constexpr (kStats) {
      const size_t rows = static_cast<size_t>(gridDim.y) * Hq;
      float* sa = stats + row * D + d0;
#pragma unroll
      for (int e = 0; e < kEpt; ++e) sa[e] = sum[e];
      if (tid == 0) {
        stats[rows * D + row] = m_all;
        stats[rows * D + rows + row] = total;
      }
    } else {
      T* op = o + row * D + d0;
#pragma unroll
      for (int e = 0; e < kEpt; ++e) op[e] = from_f32<T>(sum[e] * inv);
    }
  }
}

// a split kernel's shared memory beside its fixed part: a live flag per
// 32-slot tile (or a bit per slot) of an n_chunk range, in 16-byte words
inline int live_flag_bytes(int n_chunk) { return ((n_chunk + 127) / 128) * 16; }

// pass 1 (the split kernel of the instance), then pass 2
// (stats: the combine's stats mode writes there instead of o)
template <auto split_kernel, typename T>
cudaError_t launch_passes(int fixed_smem, const T* q, const T* k, const T* v,
                          const int* pos, const int* cur, T* o, float* stats, float* partials,
                          int B, int S, int Hq, int Hkv, int D, int window, float softcap,
                          float scale, int n_split, int n_chunk, cudaStream_t stream) {
  const int smem = fixed_smem + live_flag_bytes(n_chunk);
  cudaError_t err = allow_smem<split_kernel>(smem);
  if (err != cudaSuccess) return err;
  const size_t rows = static_cast<size_t>(B) * Hq * n_split;
  float* acc = partials;
  float* m = acc + rows * D;
  float* l = m + rows;
  split_kernel<<<dim3(n_split, Hkv, B), kThreads, smem, stream>>>(
      q, k, v, pos, cur, acc, m, l, S, Hq, Hkv, window, softcap, scale, n_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int comb_smem = (n_split + kThreads * kEpt) * 4;
  if (stats != nullptr) {
    err = allow_smem<decode_combine_kernel<T, true>>(comb_smem);
    if (err != cudaSuccess) return err;
    decode_combine_kernel<T, true><<<dim3(Hq, B), kThreads, comb_smem, stream>>>(
        acc, m, l, o, stats, Hq, Hkv, D, n_split);
  } else {
    err = allow_smem<decode_combine_kernel<T, false>>(comb_smem);
    if (err != cudaSuccess) return err;
    decode_combine_kernel<T, false><<<dim3(Hq, B), kThreads, comb_smem, stream>>>(
        acc, m, l, o, stats, Hq, Hkv, D, n_split);
  }
  return cudaGetLastError();
}

// bf16 at D 16..256 splits on the tensor cores; f32, and bf16 at D 8, on the CUDA cores
template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* pos,
                   const void* cur, void* o, float* stats, float* partials, int B, int S,
                   int Hq, int Hkv, int window, float softcap, float scale, int n_split,
                   int n_chunk, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const int* pt = static_cast<const int*>(pos);
  const int* ct = static_cast<const int*>(cur);
  T* ot = static_cast<T*>(o);
  if constexpr (kOnTensorCores<T, D>) {
    return launch_passes<decode_split_mma<D>>(SplitMma<D>::kFixedBytes, qt, kt, vt, pt, ct, ot,
                         stats, partials, B, S, Hq, Hkv, D, window, softcap, scale, n_split,
                         n_chunk, stream);
  } else {
    return launch_passes<decode_split_kernel<T, D>>(Split<T, D>::kFixedBytes, qt, kt, vt, pt, ct,
                         ot, stats, partials, B, S, Hq, Hkv, D, window, softcap, scale, n_split,
                         n_chunk, stream);
  }
}

}  // namespace

// window < 0: no sliding window.  softcap <= 0: no softcap.  partials:
// B * Hkv * n_split * G * (D + 2) floats of scratch; n_chunk: slots per
// split, a multiple of the 32-slot tile, with (n_split - 1) * n_chunk < S
// <= n_split * n_chunk.
namespace {

int fwd(const void* q, const void* k, const void* v, const void* pos_ids, const void* cur_pos,
        void* o, float* stats, void* partials, int dtype, int B, int S, int Hq, int Hkv, int D,
        int window, float softcap, float scale, int n_split, int n_chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Hq % Hkv != 0 || Hq / Hkv > kMaxG || n_chunk % kTile != 0 || n_split < 1 ||
      static_cast<long long>(n_split) * n_chunk < S || (n_split - 1) * n_chunk >= S)
    return cudaErrorInvalidValue;
  float* part = static_cast<float*>(partials);
  return with_instance(dtype, D, [&](auto tag, auto d) {
    return launch<typename decltype(tag)::type, decltype(d)::value>(
        q, k, v, pos_ids, cur_pos, o, stats, part, B, S, Hq, Hkv, window, softcap, scale,
        n_split, n_chunk, st);
  });
}

}  // namespace

extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* pos_ids, const void* cur_pos, void* o,
                                    void* partials, int dtype, int B, int S, int Hq, int Hkv,
                                    int D, int window, float softcap, float scale, int n_split,
                                    int n_chunk, void* stream) {
  return fwd(q, k, v, pos_ids, cur_pos, o, nullptr, partials, dtype, B, S, Hq, Hkv, D, window,
             softcap, scale, n_split, n_chunk, stream);
}

// The stats mode: stats gets B * Hq * (D + 2) floats, acc (B, Hq, D), then
// m (B, Hq), then l (B, Hq), unnormalised, in place of out.
extern "C" int decode_attention_fwd_stats(const void* q, const void* k, const void* v,
                                          const void* pos_ids, const void* cur_pos,
                                          void* stats, void* partials, int dtype, int B, int S,
                                          int Hq, int Hkv, int D, int window, float softcap,
                                          float scale, int n_split, int n_chunk, void* stream) {
  return fwd(q, k, v, pos_ids, cur_pos, nullptr, static_cast<float*>(stats), partials, dtype,
             B, S, Hq, Hkv, D, window, softcap, scale, n_split, n_chunk, stream);
}

// What the card made of the split pass that dtype and D run (common.cuh's
// kernel_info: registers, spilled bytes, static and dynamic shared memory,
// blocks an SM), at ranges of n_chunk slots.
extern "C" int decode_attention_fwd_info(int dtype, int D, int n_chunk, int* out) {
  return with_instance(dtype, D, [&](auto tag, auto d) {
    using T = typename decltype(tag)::type;
    constexpr int kD = decltype(d)::value;
    const int smem = live_flag_bytes(n_chunk);
    if constexpr (kOnTensorCores<T, kD>)
      return kernel_info<decode_split_mma<kD>>(kThreads, SplitMma<kD>::kFixedBytes + smem, out);
    else
      return kernel_info<decode_split_kernel<T, kD>>(kThreads, Split<T, kD>::kFixedBytes + smem,
                                                      out);
  });
}
