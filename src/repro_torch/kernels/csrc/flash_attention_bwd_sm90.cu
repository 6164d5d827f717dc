// Flash attention backward (K1b) in bf16 at head dims 64, 128 and 256,
// designed for Hopper (sm_90a): wgmma products fed by TMA rings,
// warp-specialised, persistent.
//
// Replaces repro/kernels/flash_vjp.py's _bwd_rule (a jnp custom_vjp, not
// Pallas) in bf16 at D 64 (flash_bwd_dq_wgmma / flash_bwd_dkdv_wgmma, the
// design described first below) and at D 128 / 256 (flash_bwd_dq_sm90 /
// flash_bwd_dkdv_sm90<D>, the same design with one 64-row item a block
// whose two warpgroups split each tile by columns: their section); f32
// and bf16 D 8 / 16 / 32 stay in flash_attention_bwd.cu, whose previous
// D 128 / 256 pair is kept there for timing only.  Both compute what that
// file computes (see its header): from (q, k, v, out, lse, dout),
//
//   delta_i = sum_d dout_i,d out_i,d       P_ij = exp(s_ij - lse_i)
//   dv_j   += P_ij dout_i                 dS_ij = P_ij (dout_i . v_j - delta_i) chain_ij
//   dq_i   += scale dS_ij k_j             dk_j += scale dS_ij q_i
//
// over the live (i, j) pairs of causal / sliding window / q_offset / tanh
// softcap GQA attention, with P and dS rounded to bf16 as product operands
// and f32 sums.  Two passes, no float atomics, so equal inputs give equal
// bytes; neither P nor dS ever reaches device memory:
//
// * flash_bwd_dq_wgmma: an item is 64 x WG_DQ q rows of one head.  It
//   computes delta (and writes it, with lse * log2 e, to `stat`, per 64-row
//   tile) and walks the key tiles the rows can see: S = Q K^T, dP = dO V^T,
//   dQ += dS K.
// * flash_bwd_dkdv_wgmma: an item is 64 x WG_DKDV keys of one KV head.  It
//   walks the 64-row q tiles of its G query heads that can see those keys:
//   S^T = K Q^T, dP^T = V dO^T, dV += P^T dO, dK += dS^T Q.
//
// What bounds it: at smollm-360m's training shape (4, 2048, 15/5, 64),
// causal, the five products a fused backward needs are ~8.1e10 flops (10 D
// a live pair) against ~42 MB of traffic, so the tensor cores set the
// card's bound (~0.08 ms).  Two passes do 7 products (S and dP twice), each
// m64 n64 k16: the width at which a thread's accumulators fit (dk / dv
// holds four), and which, measured, sets the time (PERF.md).  What the
// design does about it:
//
// * Products on wgmma.mma_async m64n64k16 (bf16 -> f32), one consumer
//   warpgroup per 64 rows or keys, WG (1 or 2) of them a block.  S and dP
//   (S^T, dP^T) take both operands from shared memory (K-major).  The P / dS
//   products take A from registers (the f32 accumulator repacked to bf16:
//   the accumulator's fragment is the A fragment of the next product) and B
//   as the MN-major tile of dout, Q or K through wgmma's transpose bit, not
//   a copy.
// * Operands arrive by TMA (cp.async.bulk.tensor, 4-d tensor maps over the
//   (B, S, H, 64) tensors, 64-row boxes of one head, 128-byte swizzle: a
//   row of 64 bf16 is one swizzle row).  One producer thread keeps a ring
//   of STAGES stages in flight, each with a full and an empty mbarrier;
//   the tensor map zero-fills the ragged Sq / Sk edge.  A dkdv stage also
//   carries its q tile's lse * log2 e and delta (512 bytes of `stat`, by
//   cp.async.bulk under the same barrier).  An item's own tiles (K / V, or
//   Q / dO / O) are double-buffered, so the next item's load overlaps the
//   current item's products.  setmaxnreg gives the producer warpgroup's
//   registers to the consumers; the exchange balances only at the entry
//   count the constants below assume, so the host side refuses to launch
//   a build whose kernels ptxas gave another count (the consumers'
//   setmaxnreg would wait forever for registers the block does not hold).
// * Software pipelining inside each consumer warpgroup: a step issues the
//   next tile's S (dq: and dP) before this tile's exponentials, and leaves
//   its dQ (dk / dv: dV and dK, then the next tile's dP^T) in flight into
//   the next step, which releases this tile's stage once its wait completes
//   them.  So the tensor cores hold queued products while the warpgroup
//   computes P and dS, and a second warpgroup fills the rest.  Nothing
//   between a wgmma's issue and its wait branches (a branch there makes
//   ptxas serialise the wgmmas): the last step of a run is peeled off at
//   compile time, the softcap is a template parameter, every element is
//   masked by two compares against its row's (or key's) live interval, and
//   a warp's barrier arrival is predicated.  Exponentials run as
//   ex2.approx.ftz, one instruction (exp2f adds a rescale for results below
//   2^-126; such P flush to 0).
// * Balance: a persistent grid, its blocks' item lists computed in Python
//   (flash_attention.bwd_plan: longest first onto the least loaded block)
//   and passed in `plan` ([blocks + 1] offsets, then item ids).  A
//   warpgroup passes the tiles of an item outside its run of tiles with a
//   live pair (waits for them and releases them).
//
// What bounds the D 128 / 256 instances (their section has the design):
// the products, at 7 (S, dP twice) where the bound counts 5, on the tensor
// cores; the load stream where a tile's reuse is low (at D 128, G 8 the
// dk / dv pass streams a 32 KB Q / dO stage for each 64 x 64 tile); and
// with a softcap the special-function unit (two exponentials and a
// reciprocal a score in each pass).  PERF.md has the measured split.
//
// Build-time configuration (defaults below; tools/k1b_variants.py builds
// others): K1B_DQ_WG and K1B_DKDV_WG consumer warpgroups a block at D 64
// (1 or 2; 1 spills), K1B_STAGES its ring stages; at D 128 the dq and dk /
// dv ring stages (K1B_W128_DQ_STAGES, K1B_W128_DKDV_STAGES), item buffers
// (K1B_W128_DQ_BUFS, K1B_W128_DKDV_BUFS) and the lookahead step
// (K1B_W128_AHEAD); at D 256 the ring stages (K1B_W256_STAGES: only 2 fit).
#include "sm90.cuh"

#ifndef K1B_DQ_WG
#define K1B_DQ_WG 2
#endif
#ifndef K1B_DKDV_WG
#define K1B_DKDV_WG 2
#endif
#ifndef K1B_STAGES
#define K1B_STAGES 4
#endif
#ifndef K1B_W128_DQ_STAGES
#define K1B_W128_DQ_STAGES 4
#endif
#ifndef K1B_W128_DKDV_STAGES
#define K1B_W128_DKDV_STAGES 3
#endif
#ifndef K1B_W128_DQ_BUFS
#define K1B_W128_DQ_BUFS 2
#endif
#ifndef K1B_W128_DKDV_BUFS
#define K1B_W128_DKDV_BUFS 2
#endif
#ifndef K1B_W128_AHEAD
#define K1B_W128_AHEAD 1
#endif
#ifndef K1B_W256_STAGES
#define K1B_W256_STAGES 2
#endif

namespace {

using bf16 = __nv_bfloat16;

constexpr int kT = 64;                       // rows (or keys) of a tile and of a warpgroup
constexpr int kTileElems = kT * 64;          // a 64 x 64 bf16 tile: 64 rows of 128 bytes
constexpr uint32_t kTileBytes = kTileElems * 2;
constexpr int kStat = 2 * kT;                // stat floats per q tile: lse * log2 e, delta
constexpr uint32_t kStatBytes = kStat * 4;

// one 64-row box of one head of a (B, S, H, 64) tensor -> shared memory
// (a (B, S, H, D) tensor's box of 64 rows x 64 columns from column `col`
// is sm90.cuh's tma_box(dst, map, bar, col, head, row, batch))
__device__ __forceinline__ void tma_tile(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int head, int row, int batch) {
  tma_box(dst, map, bar, 0, head, row, batch);
}

// Shared-memory matrix descriptor of a 64-row tile of 128-byte rows
// (sm90.cuh's desc_b128): LBO is unused at 64 columns, and holds 1024 bytes
__device__ __forceinline__ uint64_t tile_desc(const bf16* tile) { return desc_b128(tile, 1024); }

// d (64 x 64 f32) = (accumulate ? d : 0) + A (64 x 16, K-major smem) B (16 x 64, K-major smem)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ACC32_STR
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}
// d (64 x 64 f32) = (accumulate ? d : 0) + A (64 x 16, bf16 fragments in
// registers) B (16 x 64 smem, K-major, or MN-major with kTransB)
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ACC32_STR
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(kTransB));
}

// Accumulator fragment of m64nNk16 (f32), thread t of the warpgroup (warp
// w = t / 32, lane = 4 gr + tq): d[4 j + 2 h + c] = D[16 w + gr + 8 h][8 j +
// 2 tq + c].  The A fragment of m64nNk16 from registers, k16 step kk, is
// the same map over columns 16 kk .. 16 kk + 15: a[kk][2 (j & 1) + h] packs
// columns (2 tq, 2 tq + 1) of n-tile j = 2 kk + (j & 1), row half h.

__device__ __forceinline__ void mma64(float (&d)[32], uint64_t a, uint64_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_ss(d, a + kk * kKStep, b + kk * kKStep, kk > 0);
}
// d += A B, A in registers, B's tile MN-major (dQ += dS K)
__device__ __forceinline__ void mma64_rs(float (&d)[32], const uint32_t (&a)[4][4], uint64_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs<1>(d, a[kk], b + kk * kMNStep, 1);
}

// ---------------------------------------------------------------------------
// the walk of an item, shared by the producer and the consumers (and by
// flash_attention.bwd_walk in Python)
// ---------------------------------------------------------------------------

struct Range {
  int start, n;  // first row (or key) of the first 64-tile, number of tiles
};
// the key tiles that rows [row0, row0 + rows) can see
__device__ __forceinline__ Range dq_keys(int row0, int rows, int Sq, int Sk, int causal,
                                         int window, int q_offset) {
  const int last_row = min(Sq, row0 + rows) - 1;
  const int hi = causal ? min(Sk, q_offset + last_row + 1) : Sk;
  const int lo = window >= 0 ? max(0, q_offset + row0 - window + 1) : 0;
  const int start = lo / kT * kT;
  return {start, hi > start ? (hi - start + kT - 1) / kT : 0};
}
// the q tiles (of each head) whose rows can see keys [key0, key0 + keys)
__device__ __forceinline__ Range dkdv_rows(int key0, int keys, int Sq, int Sk, int causal,
                                           int window, int q_offset) {
  const int last_key = min(Sk, key0 + keys) - 1;
  const int lo = causal ? max(0, key0 - q_offset) : 0;
  const int hi = window >= 0 ? min(Sq, last_key + window - q_offset) : Sq;
  const int start = lo / kT * kT;
  return {start, hi > start ? (hi - start + kT - 1) / kT : 0};
}

struct Attn {  // what decides a pair's liveness and its probability
  int Sq, Sk, causal, window, q_offset;
  float scale, scale_log2, softcap;
};
// whether some pair of rows [q0, q0 + 64) and keys [k0, k0 + 64) is live
__device__ __forceinline__ bool tile_live(int q0, int k0, const Attn& a) {
  const int q1 = min(q0 + kT, a.Sq) - 1, k1 = min(k0 + kT, a.Sk) - 1;
  bool any = q0 < a.Sq && k0 < a.Sk;
  if (a.causal) any = any && k0 <= a.q_offset + q1;
  if (a.window >= 0) any = any && k1 > a.q_offset + q0 - a.window;
  return any;
}
// The live keys of row `row` form the interval [lo, hi) (empty past Sq) ...
struct Span {
  int lo, hi;
};
__device__ __forceinline__ Span row_keys(int row, const Attn& a) {
  if (row >= a.Sq) return {1, 0};
  return {a.window >= 0 ? a.q_offset + row - a.window + 1 : 0,
          a.causal ? min(a.Sk, a.q_offset + row + 1) : a.Sk};
}
// ... and the rows that see key `key` form [lo, hi) (empty past Sk)
__device__ __forceinline__ Span key_rows(int key, const Attn& a) {
  if (key >= a.Sk) return {1, 0};
  return {a.causal ? key - a.q_offset : 0,
          a.window >= 0 ? min(a.Sq, key - a.q_offset + a.window) : a.Sq};
}
__device__ __forceinline__ float keep(float p, int x, Span span) {
  return x >= span.lo && x < span.hi ? p : 0.f;
}

// 2^x on the special-function unit alone (exp2f adds a rescale for results
// below 2^-126, which P can spare: they flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// P of the raw score s (Q K^T before the scale) against lse2 = lse log2 e,
// and the softcap's chain factor
template <bool kCap>
__device__ __forceinline__ float prob(float s, float lse2, const Attn& a, float* chain) {
  if constexpr (kCap) {
    // tanh x = 1 - 2 / (e^2x + 1): no branch (tanhf has one), and f32
    // rounding in absolute terms, which is what the capped score needs
    const float t = 1.f - __fdividef(2.f, ex2(s * a.scale / a.softcap * (2 * kLog2e)) + 1.f);
    *chain = 1.f - t * t;
    return ex2(t * a.softcap * kLog2e - lse2);
  }
  *chain = 1.f;
  return ex2(s * a.scale_log2 - lse2);
}
// The elementwise steps have no branch: a branch between a wgmma's issue
// and its wait makes ptxas serialise the wgmmas.  So every element is
// masked (two compares and a select) and the softcap is a template
// parameter of the kernels.

// a dq tile: s (S = Q K^T: rows of spans[h], keys key_a + 8 j + c) <- P chain
template <bool kCap>
__device__ __forceinline__ void dq_probs(float (&s)[32], const float (&lse2)[2],
                                         const Span (&spans)[2], int key_a, const Attn& a) {
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int h = (e >> 1) & 1;
    float chain;
    const float p = keep(prob<kCap>(s[e], lse2[h], a, &chain), key_a + 8 * (e >> 2) + (e & 1),
                         spans[h]);
    s[e] = kCap ? p * chain : p;
  }
}
// a dk / dv tile: s (S^T = K Q^T: keys of spans[h], rows row_a + 8 j + c) <-
// P chain, and pa <- P in bf16 as A fragments; lse2 holds this thread's
// columns' lse log2 e at lse2[8 j], lse2[8 j + 1]
template <bool kCap>
__device__ __forceinline__ void kv_probs(float (&s)[32], uint32_t (&pa)[4][4], const float* lse2,
                                         const Span (&spans)[2], int row_a, const Attn& a) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(lse2 + 8 * j);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = 4 * j + 2 * h, row = row_a + 8 * j;
      float c0, c1;
      const float p0 = keep(prob<kCap>(s[e], l2.x, a, &c0), row, spans[h]);
      const float p1 = keep(prob<kCap>(s[e + 1], l2.y, a, &c1), row + 1, spans[h]);
      pa[j >> 1][2 * (j & 1) + h] = pack2(p0, p1);
      s[e] = kCap ? p0 * c0 : p0;
      s[e + 1] = kCap ? p1 * c1 : p1;
    }
  }
}

// a consumer passes a tile with no live pair: waits for it, releases it
template <int ST>
__device__ __forceinline__ void skip_tile(uint64_t* full, uint64_t* empty, Ring<ST>& ring,
                                          int lane) {
  mbar_wait(&full[ring.stage], ring.phase);
  release(&empty[ring.stage], lane);
  ring.next();
}

// setmaxnreg: the block holds (WG + 1) x 128 threads x its entry registers
// (the register file over the threads an SM holds, in steps of 8: 168 at
// WG 2, one block an SM; 128 at WG 1, two), all of which the producer's 40
// and the consumers' share add up to
constexpr int kProducerRegs = 40;
template <int WG> constexpr int kBlocksPerSm = WG == 1 ? 2 : 1;
template <int WG>
constexpr int kEntryRegs = 65536 / ((WG + 1) * 128 * kBlocksPerSm<WG>) / 8 * 8;
template <int WG>
constexpr int kConsumerRegs = ((WG + 1) * kEntryRegs<WG> - kProducerRegs) / WG / 8 * 8;
static_assert(kEntryRegs<2> == 168 && kConsumerRegs<2> == 232 && kConsumerRegs<1> == 216,
              "setmaxnreg's counts");

// ---------------------------------------------------------------------------
// dq pass
// ---------------------------------------------------------------------------

template <int WG, int ST>
struct DqSmem {
  bf16 item[2][3][WG * kTileElems];  // Q, dO, O of the item's rows, two items
  bf16 ring[ST][2][kTileElems];      // K, V of one key tile a stage
  uint64_t full[ST], empty[ST], item_full[2], item_empty[2];
};

// S = Q K^T and dP = dO V^T of a key tile (K, V) into s, dp, as two groups
__device__ __forceinline__ void dq_products(float (&s)[32], float (&dp)[32],
                                            uint64_t q_desc, uint64_t do_desc,
                                            const bf16 (&kv)[2][kTileElems]) {
  mma64(s, q_desc, tile_desc(kv[0]));
  wgmma_commit();
  mma64(dp, do_desc, tile_desc(kv[1]));
  wgmma_commit();
}

// One step of a dq consumer, on tile t of its run of live tiles (its S and
// dP already issued, into s and dp): first the next tile's S and dP (into
// sn, dpn), so that the tensor cores hold them while this thread computes
// tile t's P and dS; then dQ += dS K, left in flight.  `cur` is tile t's
// stage, `held` the previous tile's, released once the wait completes its
// dQ product.
template <bool kNext, bool kCap, int WG, int ST>
__device__ __forceinline__ void dq_step(DqSmem<WG, ST>& sm, Ring<ST>& ring, int& cur, int& held,
                                        float (&s)[32], float (&dp)[32], float (&sn)[32],
                                        float (&dpn)[32], float (&dqa)[32],
                                        uint64_t q_desc, uint64_t do_desc, int key_a, int lane,
                                        const float (&lse2)[2], const float (&dl)[2],
                                        const Span (&spans)[2], const Attn& a) {
  int nxt = -1;
  if constexpr (kNext) {
    mbar_wait(&sm.full[ring.stage], ring.phase);
    wgmma_fence();
    dq_products(sn, dpn, q_desc, do_desc, sm.ring[ring.stage]);  // tile t + 1
    wgmma_commit();
    nxt = ring.stage;
    ring.next();
    wgmma_wait<2>();  // tile t's S and dP and tile t - 1's dQ product are done
  } else {
    wgmma_wait<0>();
  }
  fence_acc(s);
  fence_acc(dp);
  release(&sm.empty[held >= 0 ? held : 0], lane, held >= 0);
  dq_probs<kCap>(s, lse2, spans, key_a, a);
  uint32_t dsa[4][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = 4 * j + 2 * h;
      dsa[j >> 1][2 * (j & 1) + h] =
          pack2(s[e] * (dp[e] - dl[h]), s[e + 1] * (dp[e + 1] - dl[h]));
    }
  wgmma_fence();
  mma64_rs(dqa, dsa, tile_desc(sm.ring[cur][0]));  // dQ += dS K
  wgmma_commit();
  held = cur;
  cur = nxt;
}

template <int WG, int ST, bool kCap>
__global__ void __launch_bounds__((WG + 1) * 128, kBlocksPerSm<WG>)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_o,
                   const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                   float* __restrict__ stat, bf16* __restrict__ dq, const int* __restrict__ plan,
                   int Sq, int Sk, int Hq, int Hkv, int causal, int window, float softcap,
                   float scale, int q_offset) {
  extern __shared__ unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<DqSmem<WG, ST>*>(align1024(smem_raw));
  const int n_tiles = (Sq + WG * kT - 1) / (WG * kT);  // items per (head, batch)
  const int nqt = (Sq + kT - 1) / kT;                  // stat tiles per (head, batch)
  const int G = Hq / Hkv;
  const int first = plan[blockIdx.x], last = plan[blockIdx.x + 1];
  const int* items = plan + gridDim.x + 1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], WG * 4);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&sm.item_full[b], 1);
      mbar_init(&sm.item_empty[b], WG * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == WG) {  // producer warpgroup: one thread issues every copy
    regs_dec<kProducerRegs>();
    if (threadIdx.x == WG * 128) {
      Ring<ST> ring;
      for (int n = first; n < last; ++n) {
        const int it = items[n], qt = it % n_tiles, h = (it / n_tiles) % Hq,
                  b = it / n_tiles / Hq, hk = h / G, row0 = qt * WG * kT;
        const int buf = (n - first) & 1;
        mbar_wait(&sm.item_empty[buf], (((n - first) >> 1) & 1) ^ 1);
        mbar_expect_tx(&sm.item_full[buf], 3 * WG * kTileBytes);
        for (int w = 0; w < WG; ++w) {
          tma_tile(sm.item[buf][0] + w * kTileElems, &tm_q, &sm.item_full[buf], h, row0 + w * kT, b);
          tma_tile(sm.item[buf][1] + w * kTileElems, &tm_do, &sm.item_full[buf], h, row0 + w * kT, b);
          tma_tile(sm.item[buf][2] + w * kTileElems, &tm_o, &sm.item_full[buf], h, row0 + w * kT, b);
        }
        const Range kr = dq_keys(row0, WG * kT, Sq, Sk, causal, window, q_offset);
        for (int t = 0; t < kr.n; ++t) {
          const int stage = ring.stage;
          mbar_wait(&sm.empty[stage], ring.phase ^ 1);
          mbar_expect_tx(&sm.full[stage], 2 * kTileBytes);
          tma_tile(sm.ring[stage][0], &tm_k, &sm.full[stage], hk, kr.start + t * kT, b);
          tma_tile(sm.ring[stage][1], &tm_v, &sm.full[stage], hk, kr.start + t * kT, b);
          ring.next();
        }
      }
    }
  } else {  // consumer warpgroup wg: rows [row0 + 64 wg, + 64) of each item
    regs_inc<kConsumerRegs<WG>>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int gr = lane >> 2, tq = lane & 3;
    const Attn a = {Sq, Sk, causal, window, q_offset, scale, scale * kLog2e, softcap};
    Ring<ST> ring;
    for (int n = first; n < last; ++n) {
      const int it = items[n], qt = it % n_tiles, h = (it / n_tiles) % Hq,
                b = it / n_tiles / Hq, row0 = qt * WG * kT, r0 = row0 + wg * kT;
      const int buf = (n - first) & 1;
      const Range kr = dq_keys(row0, WG * kT, Sq, Sk, causal, window, q_offset);
      mbar_wait(&sm.item_full[buf], ((n - first) >> 1) & 1);
      const bf16* qs = sm.item[buf][0] + wg * kTileElems;
      const bf16* dos = sm.item[buf][1] + wg * kTileElems;
      const bf16* os = sm.item[buf][2] + wg * kTileElems;

      // delta = rowsum(dout * out) and lse * log2 e of this thread's rows
      // 16 warp + gr + 8 i; the 4 threads of a row sum 16 columns each
      float lse2[2], dl[2];
      const size_t stat_row = static_cast<size_t>(b) * Hq + h;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = warp * 16 + gr + 8 * i, row = r0 + r;
        float acc = 0.f;
#pragma unroll
        for (int c2 = 0; c2 < 2; ++c2) {
          const int chunk = (2 * tq + c2) ^ (r & 7);  // the 128-byte swizzle
          const uint4 ov = *reinterpret_cast<const uint4*>(os + r * 64 + chunk * 8);
          const uint4 dv = *reinterpret_cast<const uint4*>(dos + r * 64 + chunk * 8);
          const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
          const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 of = __bfloat1622float2(o2[e]), df = __bfloat1622float2(d2[e]);
            acc += of.x * df.x + of.y * df.y;
          }
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        dl[i] = acc;
        lse2[i] = row < Sq ? lse[stat_row * Sq + row] * kLog2e : 0.f;
        if (tq == 0 && r0 < Sq) {
          float* st = stat + (stat_row * nqt + r0 / kT) * kStat;
          st[r] = lse2[i];
          st[kT + r] = acc;
        }
      }

      float dqa[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) dqa[e] = 0.f;
      const uint64_t q_desc = tile_desc(qs), do_desc = tile_desc(dos);
      // this warpgroup's key tiles with a live pair form a run [lo, hi) (the
      // keys a range of rows sees are an interval); it only passes the rest
      int lo = 0, hi = kr.n;
      while (lo < hi && !tile_live(r0, kr.start + lo * kT, a)) ++lo;
      while (hi > lo && !tile_live(r0, kr.start + (hi - 1) * kT, a)) --hi;
      for (int t = 0; t < lo; ++t) skip_tile(sm.full, sm.empty, ring, lane);
      if (lo < hi) {
        float s0[32], dp0[32], s1[32], dp1[32];
        mbar_wait(&sm.full[ring.stage], ring.phase);
        wgmma_fence();
        dq_products(s0, dp0, q_desc, do_desc, sm.ring[ring.stage]);
        int cur = ring.stage, held = -1;
        ring.next();
        const Span spans[2] = {row_keys(r0 + warp * 16 + gr, a), row_keys(r0 + warp * 16 + gr + 8, a)};
        // two steps a turn, so the register sets alternate; the last step,
        // with no next tile, apart
#define DQ_STEP(kNext, t, S, DP, SN, DPN)                                                   \
  dq_step<kNext, kCap>(sm, ring, cur, held, S, DP, SN, DPN, dqa, q_desc, do_desc,          \
                       kr.start + (t) * kT + 2 * tq, lane, lse2, dl, spans, a)
        int t = lo;
        for (; t + 2 < hi; t += 2) {
          DQ_STEP(true, t, s0, dp0, s1, dp1);
          DQ_STEP(true, t + 1, s1, dp1, s0, dp0);
        }
        if (t + 1 < hi) {
          DQ_STEP(true, t, s0, dp0, s1, dp1);
          DQ_STEP(false, t + 1, s1, dp1, s0, dp0);
        } else {
          DQ_STEP(false, t, s0, dp0, s1, dp1);
        }
#undef DQ_STEP
        wgmma_wait<0>();
        release(&sm.empty[held], lane);
      }
      fence_acc(dqa);
      for (int t = hi; t < kr.n; ++t) skip_tile(sm.full, sm.empty, ring, lane);
      release(&sm.item_empty[buf], lane);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = r0 + warp * 16 + gr + 8 * hh;
        if (row >= Sq) continue;
        bf16* dst = dq + ((static_cast<size_t>(b) * Sq + row) * Hq + h) * 64 + 2 * tq;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
              __floats2bfloat162_rn(dqa[4 * j + 2 * hh] * scale, dqa[4 * j + 2 * hh + 1] * scale);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dk / dv pass
// ---------------------------------------------------------------------------

template <int WG, int ST>
struct DkdvSmem {
  bf16 kv[2][2][WG * kTileElems];  // K, V of the item's keys, two items
  bf16 ring[ST][2][kTileElems];    // Q, dO of one q tile a stage
  float stat[ST][kStat];           // its lse * log2 e and delta
  uint64_t full[ST], empty[ST], kv_full[2], kv_empty[2];
};

// One step of a dk / dv consumer, on tile t of its run of live tiles (its
// S^T and dP^T already issued, into s and dp): first the next tile's S^T
// (into sn), so that the tensor cores hold it while this thread computes
// tile t's P and dS; then dV += P^T dO and dK += dS^T Q, left in flight,
// and behind them the next tile's dP^T (into dp, free again).  `cur` is
// tile t's stage, `held` the previous tile's, released once the wait
// completes its products.
template <bool kNext, bool kCap, int WG, int ST>
__device__ __forceinline__ void kv_step(DkdvSmem<WG, ST>& sm, Ring<ST>& ring, int& cur, int& held,
                                        float (&s)[32], float (&sn)[32], float (&dp)[32],
                                        float (&dka)[32], float (&dva)[32], uint64_t k_desc,
                                        uint64_t v_desc, int row_a, int tq, int lane,
                                        const Span (&spans)[2], const Attn& a) {
  int nxt = -1;
  if constexpr (kNext) {
    mbar_wait(&sm.full[ring.stage], ring.phase);
    wgmma_fence();
    mma64(sn, k_desc, tile_desc(sm.ring[ring.stage][0]));  // S^T = K Q^T, tile t + 1
    wgmma_commit();
    nxt = ring.stage;
    ring.next();
    wgmma_wait<1>();  // tile t's S^T and dP^T and tile t - 1's dV / dK are done
  } else {
    wgmma_wait<0>();
  }
  fence_acc(s);
  fence_acc(dp);
  release(&sm.empty[held >= 0 ? held : 0], lane, held >= 0);
  const float* st = sm.stat[cur];
  uint32_t pa[4][4], dsa[4][4];
  kv_probs<kCap>(s, pa, st + 2 * tq, spans, row_a, a);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 dl = *reinterpret_cast<const float2*>(st + kT + 8 * j + 2 * tq);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = 4 * j + 2 * h;
      dsa[j >> 1][2 * (j & 1) + h] = pack2(s[e] * (dp[e] - dl.x), s[e + 1] * (dp[e + 1] - dl.y));
    }
  }
  wgmma_fence();
  mma64_rs(dva, pa, tile_desc(sm.ring[cur][1]));   // dV += P^T dO
  mma64_rs(dka, dsa, tile_desc(sm.ring[cur][0]));  // dK += dS^T Q
  wgmma_commit();
  if constexpr (kNext) {
    mma64(dp, v_desc, tile_desc(sm.ring[nxt][1]));  // dP^T = V dO^T, tile t + 1
    wgmma_commit();
  }
  held = cur;
  cur = nxt;
}

template <int WG, int ST, bool kCap>
__global__ void __launch_bounds__((WG + 1) * 128, kBlocksPerSm<WG>)
flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ stat,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, const int* __restrict__ plan,
                     int Sq, int Sk, int Hq, int Hkv, int causal, int window, float softcap,
                     float scale, int q_offset) {
  extern __shared__ unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<DkdvSmem<WG, ST>*>(align1024(smem_raw));
  const int n_tiles = (Sk + WG * kT - 1) / (WG * kT);  // items per (KV head, batch)
  const int nqt = (Sq + kT - 1) / kT;
  const int G = Hq / Hkv;
  const int first = plan[blockIdx.x], last = plan[blockIdx.x + 1];
  const int* items = plan + gridDim.x + 1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], WG * 4);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&sm.kv_full[b], 1);
      mbar_init(&sm.kv_empty[b], WG * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == WG) {  // producer warpgroup
    regs_dec<kProducerRegs>();
    if (threadIdx.x == WG * 128) {
      Ring<ST> ring;
      for (int n = first; n < last; ++n) {
        const int it = items[n], kt = it % n_tiles, hk = (it / n_tiles) % Hkv,
                  b = it / n_tiles / Hkv, key0 = kt * WG * kT;
        const int buf = (n - first) & 1;
        mbar_wait(&sm.kv_empty[buf], (((n - first) >> 1) & 1) ^ 1);
        mbar_expect_tx(&sm.kv_full[buf], 2 * WG * kTileBytes);
        for (int w = 0; w < WG; ++w) {
          tma_tile(sm.kv[buf][0] + w * kTileElems, &tm_k, &sm.kv_full[buf], hk, key0 + w * kT, b);
          tma_tile(sm.kv[buf][1] + w * kTileElems, &tm_v, &sm.kv_full[buf], hk, key0 + w * kT, b);
        }
        const Range qr = dkdv_rows(key0, WG * kT, Sq, Sk, causal, window, q_offset);
        for (int gh = 0; gh < G; ++gh) {
          const int h = hk * G + gh;
          const float* st = stat + (static_cast<size_t>(b) * Hq + h) * nqt * kStat;
          for (int t = 0; t < qr.n; ++t) {
            const int i0 = qr.start + t * kT, stage = ring.stage;
            mbar_wait(&sm.empty[stage], ring.phase ^ 1);
            mbar_expect_tx(&sm.full[stage], 2 * kTileBytes + kStatBytes);
            tma_tile(sm.ring[stage][0], &tm_q, &sm.full[stage], h, i0, b);
            tma_tile(sm.ring[stage][1], &tm_do, &sm.full[stage], h, i0, b);
            bulk_copy(sm.stat[stage], st + (i0 / kT) * kStat, kStatBytes, &sm.full[stage]);
            ring.next();
          }
        }
      }
    }
  } else {  // consumer warpgroup wg: keys [key0 + 64 wg, + 64) of each item
    regs_inc<kConsumerRegs<WG>>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int gr = lane >> 2, tq = lane & 3;
    const Attn a = {Sq, Sk, causal, window, q_offset, scale, scale * kLog2e, softcap};
    Ring<ST> ring;
    for (int n = first; n < last; ++n) {
      const int it = items[n], kt = it % n_tiles, hk = (it / n_tiles) % Hkv,
                b = it / n_tiles / Hkv, key0 = kt * WG * kT, c0 = key0 + wg * kT;
      const int buf = (n - first) & 1;
      const Range qr = dkdv_rows(key0, WG * kT, Sq, Sk, causal, window, q_offset);
      mbar_wait(&sm.kv_full[buf], ((n - first) >> 1) & 1);
      const uint64_t k_desc = tile_desc(sm.kv[buf][0] + wg * kTileElems);
      const uint64_t v_desc = tile_desc(sm.kv[buf][1] + wg * kTileElems);
      const int key_a = c0 + warp * 16 + gr;  // this thread's keys: key_a, key_a + 8
      const Span spans[2] = {key_rows(key_a, a), key_rows(key_a + 8, a)};

      float dka[32], dva[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) dka[e] = dva[e] = 0.f;
      // this warpgroup's q tiles with a live pair form a run [lo, hi) (the
      // rows that see a range of keys are an interval); it only passes the rest
      int lo = 0, hi = qr.n;
      while (lo < hi && !tile_live(qr.start + lo * kT, c0, a)) ++lo;
      while (hi > lo && !tile_live(qr.start + (hi - 1) * kT, c0, a)) --hi;
      for (int gh = 0; gh < G; ++gh) {
        for (int t = 0; t < lo; ++t) skip_tile(sm.full, sm.empty, ring, lane);
        if (lo < hi) {
          float s0[32], s1[32], dp[32];
          mbar_wait(&sm.full[ring.stage], ring.phase);
          wgmma_fence();
          mma64(s0, k_desc, tile_desc(sm.ring[ring.stage][0]));
          wgmma_commit();
          mma64(dp, v_desc, tile_desc(sm.ring[ring.stage][1]));
          wgmma_commit();
          int cur = ring.stage, held = -1;
          ring.next();
          // two steps a turn, so the register sets alternate; the last step,
          // with no next tile, apart
#define KV_STEP(kNext, t, S, SN)                                                              \
  kv_step<kNext, kCap>(sm, ring, cur, held, S, SN, dp, dka, dva, k_desc, v_desc,             \
                       qr.start + (t) * kT + 2 * tq, tq, lane, spans, a)
          int t = lo;
          for (; t + 2 < hi; t += 2) {
            KV_STEP(true, t, s0, s1);
            KV_STEP(true, t + 1, s1, s0);
          }
          if (t + 1 < hi) {
            KV_STEP(true, t, s0, s1);
            KV_STEP(false, t + 1, s1, s0);
          } else {
            KV_STEP(false, t, s0, s1);
          }
#undef KV_STEP
          wgmma_wait<0>();
          release(&sm.empty[held], lane);
        }
        for (int t = hi; t < qr.n; ++t) skip_tile(sm.full, sm.empty, ring, lane);
      }
      fence_acc(dka);
      fence_acc(dva);
      release(&sm.kv_empty[buf], lane);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int key = key_a + 8 * hh;
        if (key >= Sk) continue;
        const size_t off = ((static_cast<size_t>(b) * Sk + key) * Hkv + hk) * 64 + 2 * tq;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * j) =
              __floats2bfloat162_rn(dka[4 * j + 2 * hh] * scale, dka[4 * j + 2 * hh + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * j) =
              __floats2bfloat162_rn(dva[4 * j + 2 * hh], dva[4 * j + 2 * hh + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// head dims 128 and 256: flash_bwd_dq_sm90 / flash_bwd_dkdv_sm90<D, ...>
// ---------------------------------------------------------------------------
//
// At D 128 / 256 a warpgroup cannot hold a 64-key tile's dK and dV (D / 2
// f32 registers a thread each) beside its scores, nor does shared memory
// hold two warpgroups' own 64-row tiles.  So both consumer warpgroups of a
// block work on one item of 64 rows (or keys) and split every 64 x 64 score
// tile by its columns: warpgroup w computes S and dP (S^T and dP^T) for
// columns [32 w, 32 w + 32) with m64n32k16 products over D, writes its half
// of dS (P^T and dS^T) in bf16 to shared memory in the swizzled layout wgmma
// reads, and after a named barrier of the two takes the whole tile as the A
// operand of its half of the gradient's columns, dQ (dK, dV)[:, D/2 w ..],
// m64n(D/2)k16.  No product is done twice; a thread holds D / 4 floats of
// each gradient.  A D-wide tile arrives as D / 64 TMA boxes (panels of 64
// rows x 128 bytes, 8 KB apart): a K-major product steps to the next panel
// every 4 k16 steps, an MN-major B spans them through the descriptor's
// leading byte offset.  At D 128 the steps are pipelined as at D 64 (the
// next tile's S / S^T issued before this tile's exponentials); at D 256
// one 64-row tile is 32 KB, so rings of 2 stages and one item buffer fit
// 227 KB, and a step issues its own scores (the producer loads the next
// tile into the stage the previous step released meanwhile).

constexpr int kWideWG = 2;  // consumer warpgroups of a wide block
static_assert(kEntryRegs<kWideWG> == 168 && kConsumerRegs<kWideWG> == 232, "setmaxnreg's counts");

// the two consumer warpgroups meet (named barrier 1; 0 is __syncthreads)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// k16 step kk of a K-major operand over D / 64 panels (8 KB apart)
__device__ __forceinline__ uint64_t kstep(uint64_t desc, int kk) {
  return desc + static_cast<uint64_t>(kk >> 2) * (kTileBytes >> 4) + (kk & 3) * kKStep;
}
// an MN-major B whose N spans panels: LBO the panel stride, SBO 1024 bytes
__device__ __forceinline__ uint64_t panels_desc(const bf16* tile) {
  return desc_b128(tile, kTileBytes);
}

// d (64 x 32 f32) = (accumulate ? d : 0) + A (64 x 16) B (16 x 32), both
// K-major in shared memory
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t a, uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " ACC16_STR
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : ACC16(d)
      : "l"(a), "l"(b), "r"(accumulate));
}
// d (64 x N f32, N 64 or 128) += A (64 x 16, K-major smem) B (16 x N,
// MN-major smem)
__device__ __forceinline__ void wgmma_tb(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ACC32_STR
      ", %32, %33, p, 1, 1, 0, 1;\n}\n"
      : ACC32(d)
      : "l"(a), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_tb(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " ACC64_STR
      ", %64, %65, p, 1, 1, 0, 1;\n}\n"
      : ACC64(d)
      : "l"(a), "l"(b), "r"(1));
}

// 32 columns of a score tile: A's 64 rows (desc `a`, its panel 0) times B's
// 32 rows (desc `b`) over K = D
template <int D>
__device__ __forceinline__ void scores(float (&d)[16], uint64_t a, uint64_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_n32(d, kstep(a, kk), kstep(b, kk), kk > 0);
}
// d += A B over K = 64: A the 64 x 64 bf16 tile `a` (K-major), B the D / 2
// columns of a D-wide tile from panel `b` on (MN-major)
template <int D>
__device__ __forceinline__ void grads(float (&d)[D / 4], const bf16* a, const bf16* b) {
  const uint64_t ad = tile_desc(a), bd = panels_desc(b);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_tb(d, ad + kk * kKStep, bd + kk * kMNStep);
}
// a bf16 pair into row r, columns c, c + 1 (c even) of a 64 x 64 tile in
// TMA's 128-byte swizzle, the layout the descriptors above read
__device__ __forceinline__ void st_pair(bf16* tile, int r, int c, uint32_t v) {
  *reinterpret_cast<uint32_t*>(reinterpret_cast<unsigned char*>(tile) + r * 128 +
                               (((c >> 3) ^ (r & 7)) << 4) + (c & 7) * 2) = v;
}

template <int D>
using Wide = bf16[D / 64][kTileElems];  // a 64-row tile of D columns: D / 64 panels

// ---------------------------------------------------------------------------
// wide dq pass
// ---------------------------------------------------------------------------

template <int D, int ST, int NB>
struct DqWideSmem {
  Wide<D> item[NB][2];       // Q, dO of the item's 64 rows, NB items
  Wide<D> ring[ST][2];       // K, V of one key tile a stage
  bf16 ds[2][kTileElems];    // dS (64 rows x 64 keys), two steps
  float part[2][kWideWG][kT];  // delta's halves, by warpgroup, two items
  uint64_t full[ST], empty[ST], item_full[NB], item_empty[NB];
};

// this warpgroup's 32 keys of a dq tile: s (S = Q K^T: rows r_a + 8 h with
// the live keys spans[h], keys key_a + 8 j + c) and dp -> dS in bf16 into
// the shared tile ds at columns col_a + 8 j + c
template <bool kCap>
__device__ __forceinline__ void dq_ds(bf16* ds, const float (&s)[16], const float (&dp)[16],
                                      const float (&lse2)[2], const float (&dl)[2],
                                      const Span (&spans)[2], int key_a, int col_a, int r_a,
                                      const Attn& a) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = 4 * j + 2 * h;
      float c0, c1;
      const float p0 = keep(prob<kCap>(s[e], lse2[h], a, &c0), key_a + 8 * j, spans[h]);
      const float p1 = keep(prob<kCap>(s[e + 1], lse2[h], a, &c1), key_a + 8 * j + 1, spans[h]);
      st_pair(ds, r_a + 8 * h, col_a + 8 * j,
              pack2((kCap ? p0 * c0 : p0) * (dp[e] - dl[h]),
                    (kCap ? p1 * c1 : p1) * (dp[e + 1] - dl[h])));
    }
}

// S = Q K^T and dP = dO V^T of this warpgroup's 32 keys of a key tile (K, V)
template <int D>
__device__ __forceinline__ void dq_scores(float (&s)[16], float (&dp)[16], uint64_t q_desc,
                                          uint64_t do_desc, const Wide<D> (&kv)[2], int wg) {
  scores<D>(s, q_desc, tile_desc(kv[0][0] + wg * 32 * 64));
  scores<D>(dp, do_desc, tile_desc(kv[1][0] + wg * 32 * 64));
}

// Where a wide dq step is: its register sets, descriptors and this thread's
// place in the tile
template <int D>
struct DqAt {
  float (&dqa)[D / 4];
  uint64_t q_desc, do_desc;
  int wg, col_a, r_a, lane;
  const float (&lse2)[2];
  const float (&dl)[2];
  const Span (&spans)[2];
  const Attn& a;
};

// One pipelined step (D 128), on tile t of the run (its S and dP already
// issued, into s and dp): the next tile's S and dP (into sn, dpn) first;
// then this tile's dS to shared memory, the barrier, dQ += dS K left in
// flight.  `cur` is tile t's stage, `held` the previous tile's, released
// once the wait completes its dQ products (both warpgroups' arrivals).
template <bool kNext, bool kCap, int D, int ST, int NB>
__device__ __forceinline__ void dq_step_w(DqWideSmem<D, ST, NB>& sm, Ring<ST>& ring, int& cur,
                                          int& held, int& pb, float (&s)[16], float (&dp)[16],
                                          float (&sn)[16], float (&dpn)[16], int key_a,
                                          const DqAt<D>& at) {
  int nxt = -1;
  if constexpr (kNext) {
    mbar_wait(&sm.full[ring.stage], ring.phase);
    wgmma_fence();
    dq_scores<D>(sn, dpn, at.q_desc, at.do_desc, sm.ring[ring.stage], at.wg);  // tile t + 1
    wgmma_commit();
    nxt = ring.stage;
    ring.next();
    wgmma_wait<1>();  // tile t's S and dP and tile t - 1's dQ products are done
  } else {
    wgmma_wait<0>();
  }
  fence_acc(s);
  fence_acc(dp);
  release(&sm.empty[held >= 0 ? held : 0], at.lane, held >= 0);
  dq_ds<kCap>(sm.ds[pb], s, dp, at.lse2, at.dl, at.spans, key_a, at.col_a, at.r_a, at.a);
  fence_async_smem();
  consumers_sync();
  wgmma_fence();
  grads<D>(at.dqa, sm.ds[pb], sm.ring[cur][0][at.wg * D / 128]);  // dQ += dS K
  wgmma_commit();
  held = cur;
  cur = nxt;
  pb ^= 1;
}

// One step without lookahead (D 256): waits for tile t, issues its S and
// dP, then dS, the barrier and dQ += dS K, and waits for those before it
// releases the stage (the producer loads the next tile meanwhile; no
// product is in flight across steps, so the accumulators of one step's
// products are all a thread holds at once)
template <bool kCap, int D, int ST, int NB>
__device__ __forceinline__ void dq_step_n(DqWideSmem<D, ST, NB>& sm, Ring<ST>& ring, int& pb,
                                          float (&s)[16], float (&dp)[16], int key_a,
                                          const DqAt<D>& at) {
  mbar_wait(&sm.full[ring.stage], ring.phase);
  const int cur = ring.stage;
  ring.next();
  wgmma_fence();
  dq_scores<D>(s, dp, at.q_desc, at.do_desc, sm.ring[cur], at.wg);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(s);
  fence_acc(dp);
  dq_ds<kCap>(sm.ds[pb], s, dp, at.lse2, at.dl, at.spans, key_a, at.col_a, at.r_a, at.a);
  fence_async_smem();
  consumers_sync();
  wgmma_fence();
  grads<D>(at.dqa, sm.ds[pb], sm.ring[cur][0][at.wg * D / 128]);  // dQ += dS K
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(at.dqa);
  release(&sm.empty[cur], at.lane);
  pb ^= 1;
}

template <int D, int ST, int NB, bool kAhead, bool kCap>
__global__ void __launch_bounds__((kWideWG + 1) * 128, 1)
flash_bwd_dq_sm90(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ CUtensorMap tm_do, const bf16* __restrict__ o,
                  const bf16* __restrict__ dout, const float* __restrict__ lse,
                  float* __restrict__ stat, bf16* __restrict__ dq, const int* __restrict__ plan,
                  int Sq, int Sk, int Hq, int Hkv, int causal, int window, float softcap,
                  float scale, int q_offset) {
  constexpr int kP = D / 64;
  constexpr uint32_t kWideBytes = kP * kTileBytes;
  extern __shared__ unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<DqWideSmem<D, ST, NB>*>(align1024(smem_raw));
  const int n_tiles = (Sq + kT - 1) / kT;  // items (and stat tiles) per (head, batch)
  const int G = Hq / Hkv;
  const int first = plan[blockIdx.x], last = plan[blockIdx.x + 1];
  const int* items = plan + gridDim.x + 1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kWideWG * 4);
    }
    for (int b = 0; b < NB; ++b) {
      mbar_init(&sm.item_full[b], 1);
      mbar_init(&sm.item_empty[b], kWideWG * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == kWideWG) {  // producer warpgroup: one thread issues every copy
    regs_dec<kProducerRegs>();
    if (threadIdx.x == kWideWG * 128) {
      Ring<ST> ring;
      for (int n = first; n < last; ++n) {
        const int it = items[n], qt = it % n_tiles, h = (it / n_tiles) % Hq,
                  b = it / n_tiles / Hq, hk = h / G, row0 = qt * kT;
        const int i = n - first, buf = i % NB;
        mbar_wait(&sm.item_empty[buf], ((i / NB) & 1) ^ 1);
        mbar_expect_tx(&sm.item_full[buf], 2 * kWideBytes);
        for (int p = 0; p < kP; ++p) {
          tma_box(sm.item[buf][0][p], &tm_q, &sm.item_full[buf], 64 * p, h, row0, b);
          tma_box(sm.item[buf][1][p], &tm_do, &sm.item_full[buf], 64 * p, h, row0, b);
        }
        const Range kr = dq_keys(row0, kT, Sq, Sk, causal, window, q_offset);
        for (int t = 0; t < kr.n; ++t) {
          const int stage = ring.stage;
          mbar_wait(&sm.empty[stage], ring.phase ^ 1);
          mbar_expect_tx(&sm.full[stage], 2 * kWideBytes);
          for (int p = 0; p < kP; ++p) {
            tma_box(sm.ring[stage][0][p], &tm_k, &sm.full[stage], 64 * p, hk, kr.start + t * kT, b);
            tma_box(sm.ring[stage][1][p], &tm_v, &sm.full[stage], 64 * p, hk, kr.start + t * kT, b);
          }
          ring.next();
        }
      }
    }
  } else {  // consumer warpgroup wg: keys [32 wg, + 32) of each tile, dQ's columns [D/2 wg, + D/2)
    regs_inc<kConsumerRegs<kWideWG>>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int gr = lane >> 2, tq = lane & 3, r_a = warp * 16 + gr;
    const Attn a = {Sq, Sk, causal, window, q_offset, scale, scale * kLog2e, softcap};
    Ring<ST> ring;
    int pb = 0;
    for (int n = first; n < last; ++n) {
      const int it = items[n], qt = it % n_tiles, h = (it / n_tiles) % Hq,
                b = it / n_tiles / Hq, r0 = qt * kT;
      const int i = n - first, buf = i % NB;
      const Range kr = dq_keys(r0, kT, Sq, Sk, causal, window, q_offset);

      // delta = rowsum(dout * out) of rows r0 + r_a + 8 ii from device
      // memory: this warpgroup sums its half of the columns (the 4 threads
      // of a row 16-byte chunks tq, tq + 4, ...), the halves meet in `part`;
      // and lse * log2 e
      float lse2[2], dl[2];
      const size_t stat_row = static_cast<size_t>(b) * Hq + h;
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int r = r_a + 8 * ii, row = r0 + r;
        float acc = 0.f;
        if (row < Sq) {
          const size_t off = ((static_cast<size_t>(b) * Sq + row) * Hq + h) * D + wg * (D / 2);
#pragma unroll
          for (int c = 0; c < D / 64; ++c) {
            const int col = (4 * c + tq) * 8;
            const uint4 ov = *reinterpret_cast<const uint4*>(o + off + col);
            const uint4 dv = *reinterpret_cast<const uint4*>(dout + off + col);
            const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
            const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 of = __bfloat1622float2(o2[e]), df = __bfloat1622float2(d2[e]);
              acc += of.x * df.x + of.y * df.y;
            }
          }
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        if (tq == 0) sm.part[i & 1][wg][r] = acc;
        lse2[ii] = row < Sq ? lse[stat_row * Sq + row] * kLog2e : 0.f;
      }
      consumers_sync();
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int r = r_a + 8 * ii;
        dl[ii] = sm.part[i & 1][0][r] + sm.part[i & 1][1][r];
        if (wg == 0 && tq == 0) {  // every row of the tile: rows past Sq get zeros
          float* st = stat + (stat_row * n_tiles + qt) * kStat;
          st[r] = lse2[ii];
          st[kT + r] = dl[ii];
        }
      }

      mbar_wait(&sm.item_full[buf], (i / NB) & 1);
      float dqa[D / 4];
#pragma unroll
      for (int e = 0; e < D / 4; ++e) dqa[e] = 0.f;
      fence_acc(dqa);  // the zeros are set here, not sunk between a fence and a wgmma
      const Span spans[2] = {row_keys(r0 + r_a, a), row_keys(r0 + r_a + 8, a)};
      const DqAt<D> at = {dqa, tile_desc(sm.item[buf][0][0]), tile_desc(sm.item[buf][1][0]),
                          wg, wg * 32 + 2 * tq, r_a, lane, lse2, dl, spans, a};
      // the key tiles with a live pair form a run [lo, hi); the rest are passed
      int lo = 0, hi = kr.n;
      while (lo < hi && !tile_live(r0, kr.start + lo * kT, a)) ++lo;
      while (hi > lo && !tile_live(r0, kr.start + (hi - 1) * kT, a)) --hi;
      for (int t = 0; t < lo; ++t) skip_tile(sm.full, sm.empty, ring, lane);
      const int key_w = kr.start + wg * 32 + 2 * tq;  // + t * kT: this thread's first key
      if (lo < hi) {
        if constexpr (kAhead) {
          int held = -1;
          float s0[16], dp0[16], s1[16], dp1[16];
          mbar_wait(&sm.full[ring.stage], ring.phase);
          wgmma_fence();
          dq_scores<D>(s0, dp0, at.q_desc, at.do_desc, sm.ring[ring.stage], wg);
          wgmma_commit();
          int cur = ring.stage;
          ring.next();
          // two steps a turn, so the register sets alternate; the last step,
          // with no next tile, apart
#define WDQ_STEP(kNext, t, S, DP, SN, DPN) \
  dq_step_w<kNext, kCap>(sm, ring, cur, held, pb, S, DP, SN, DPN, key_w + (t) * kT, at)
          int t = lo;
          for (; t + 2 < hi; t += 2) {
            WDQ_STEP(true, t, s0, dp0, s1, dp1);
            WDQ_STEP(true, t + 1, s1, dp1, s0, dp0);
          }
          if (t + 1 < hi) {
            WDQ_STEP(true, t, s0, dp0, s1, dp1);
            WDQ_STEP(false, t + 1, s1, dp1, s0, dp0);
          } else {
            WDQ_STEP(false, t, s0, dp0, s1, dp1);
          }
#undef WDQ_STEP
          wgmma_wait<0>();
          release(&sm.empty[held], lane);
        } else {
          float s[16], dp[16];
          for (int t = lo; t < hi; ++t) dq_step_n<kCap>(sm, ring, pb, s, dp, key_w + t * kT, at);
        }
      }
      fence_acc(dqa);
      for (int t = hi; t < kr.n; ++t) skip_tile(sm.full, sm.empty, ring, lane);
      release(&sm.item_empty[buf], lane);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = r0 + r_a + 8 * hh;
        if (row >= Sq) continue;
        bf16* dst = dq + ((static_cast<size_t>(b) * Sq + row) * Hq + h) * D + wg * (D / 2) + 2 * tq;
#pragma unroll
        for (int j = 0; j < D / 16; ++j)
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
              __floats2bfloat162_rn(dqa[4 * j + 2 * hh] * scale, dqa[4 * j + 2 * hh + 1] * scale);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// wide dk / dv pass
// ---------------------------------------------------------------------------

template <int D, int ST, int NB>
struct DkdvWideSmem {
  Wide<D> kv[NB][2];            // K, V of the item's 64 keys, NB items
  Wide<D> ring[ST][2];          // Q, dO of one q tile a stage
  bf16 pds[2][2][kTileElems];   // P^T, dS^T (64 keys x 64 rows), two steps
  float stat[ST][kStat];        // the stage's lse * log2 e and delta
  uint64_t full[ST], empty[ST], kv_full[NB], kv_empty[NB];
};

// this warpgroup's 32 rows of a dk / dv tile: s (S^T = K Q^T: keys r_a + 8
// h with the live rows spans[h], rows row_a + 8 j + c) and dp -> P^T and
// dS^T in bf16 into the shared tiles pt, dst at columns col_a + 8 j + c;
// st holds the stage's lse log2 e (st[x]) and delta (st[64 + x]) by row x
template <bool kCap>
__device__ __forceinline__ void kv_pds(bf16* pt, bf16* dst, const float (&s)[16],
                                       const float (&dp)[16], const float* st,
                                       const Span (&spans)[2], int row_a, int col_a, int r_a,
                                       const Attn& a) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(st + col_a + 8 * j);
    const float2 dl = *reinterpret_cast<const float2*>(st + kT + col_a + 8 * j);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = 4 * j + 2 * h, row = row_a + 8 * j;
      float c0, c1;
      const float p0 = keep(prob<kCap>(s[e], l2.x, a, &c0), row, spans[h]);
      const float p1 = keep(prob<kCap>(s[e + 1], l2.y, a, &c1), row + 1, spans[h]);
      st_pair(pt, r_a + 8 * h, col_a + 8 * j, pack2(p0, p1));
      st_pair(dst, r_a + 8 * h, col_a + 8 * j,
              pack2((kCap ? p0 * c0 : p0) * (dp[e] - dl.x),
                    (kCap ? p1 * c1 : p1) * (dp[e + 1] - dl.y)));
    }
  }
}

// Where a wide dk / dv step is
template <int D>
struct KvAt {
  float (&dka)[D / 4];
  float (&dva)[D / 4];
  uint64_t k_desc, v_desc;
  int wg, col_a, r_a, lane;
  const Span (&spans)[2];
  const Attn& a;
};

// dV += P^T dO and dK += dS^T Q over this warpgroup's D / 2 columns of the
// stage's tiles (one commit group)
template <int D>
__device__ __forceinline__ void kv_grads(const KvAt<D>& at, const bf16 (&pds)[2][kTileElems],
                                         const Wide<D> (&qdo)[2]) {
  grads<D>(at.dva, pds[0], qdo[1][at.wg * D / 128]);
  grads<D>(at.dka, pds[1], qdo[0][at.wg * D / 128]);
}

// One pipelined step (D 128), as kv_step at D 64: the next tile's S^T first
// (into sn); this tile's P^T / dS^T to shared memory, the barrier, dV and dK
// left in flight, and behind them the next tile's dP^T (into dp).
template <bool kNext, bool kCap, int D, int ST, int NB>
__device__ __forceinline__ void kv_step_w(DkdvWideSmem<D, ST, NB>& sm, Ring<ST>& ring, int& cur,
                                          int& held, int& pb, float (&s)[16], float (&sn)[16],
                                          float (&dp)[16], int row_a, const KvAt<D>& at) {
  int nxt = -1;
  if constexpr (kNext) {
    mbar_wait(&sm.full[ring.stage], ring.phase);
    wgmma_fence();
    scores<D>(sn, at.k_desc, tile_desc(sm.ring[ring.stage][0][0] + at.wg * 32 * 64));
    wgmma_commit();
    nxt = ring.stage;
    ring.next();
    wgmma_wait<1>();  // tile t's S^T and dP^T and tile t - 1's dV / dK are done
  } else {
    wgmma_wait<0>();
  }
  fence_acc(s);
  fence_acc(dp);
  release(&sm.empty[held >= 0 ? held : 0], at.lane, held >= 0);
  kv_pds<kCap>(sm.pds[pb][0], sm.pds[pb][1], s, dp, sm.stat[cur], at.spans, row_a, at.col_a,
               at.r_a, at.a);
  fence_async_smem();
  consumers_sync();
  wgmma_fence();
  kv_grads<D>(at, sm.pds[pb], sm.ring[cur]);
  wgmma_commit();
  if constexpr (kNext) {
    scores<D>(dp, at.v_desc, tile_desc(sm.ring[nxt][1][0] + at.wg * 32 * 64));  // dP^T, t + 1
    wgmma_commit();
  }
  held = cur;
  cur = nxt;
  pb ^= 1;
}

// One step without lookahead (D 256), as dq_step_n
template <bool kCap, int D, int ST, int NB>
__device__ __forceinline__ void kv_step_n(DkdvWideSmem<D, ST, NB>& sm, Ring<ST>& ring, int& pb,
                                          float (&s)[16], float (&dp)[16], int row_a,
                                          const KvAt<D>& at) {
  mbar_wait(&sm.full[ring.stage], ring.phase);
  const int cur = ring.stage;
  ring.next();
  wgmma_fence();
  scores<D>(s, at.k_desc, tile_desc(sm.ring[cur][0][0] + at.wg * 32 * 64));
  scores<D>(dp, at.v_desc, tile_desc(sm.ring[cur][1][0] + at.wg * 32 * 64));
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(s);
  fence_acc(dp);
  kv_pds<kCap>(sm.pds[pb][0], sm.pds[pb][1], s, dp, sm.stat[cur], at.spans, row_a, at.col_a,
               at.r_a, at.a);
  fence_async_smem();
  consumers_sync();
  wgmma_fence();
  kv_grads<D>(at, sm.pds[pb], sm.ring[cur]);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(at.dka);
  fence_acc(at.dva);
  release(&sm.empty[cur], at.lane);
  pb ^= 1;
}

template <int D, int ST, int NB, bool kAhead, bool kCap>
__global__ void __launch_bounds__((kWideWG + 1) * 128, 1)
flash_bwd_dkdv_sm90(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ stat,
                    bf16* __restrict__ dk, bf16* __restrict__ dv, const int* __restrict__ plan,
                    int Sq, int Sk, int Hq, int Hkv, int causal, int window, float softcap,
                    float scale, int q_offset) {
  constexpr int kP = D / 64;
  constexpr uint32_t kWideBytes = kP * kTileBytes;
  extern __shared__ unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<DkdvWideSmem<D, ST, NB>*>(align1024(smem_raw));
  const int n_tiles = (Sk + kT - 1) / kT;  // items per (KV head, batch)
  const int nqt = (Sq + kT - 1) / kT;
  const int G = Hq / Hkv;
  const int first = plan[blockIdx.x], last = plan[blockIdx.x + 1];
  const int* items = plan + gridDim.x + 1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kWideWG * 4);
    }
    for (int b = 0; b < NB; ++b) {
      mbar_init(&sm.kv_full[b], 1);
      mbar_init(&sm.kv_empty[b], kWideWG * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == kWideWG) {  // producer warpgroup
    regs_dec<kProducerRegs>();
    if (threadIdx.x == kWideWG * 128) {
      Ring<ST> ring;
      for (int n = first; n < last; ++n) {
        const int it = items[n], kt = it % n_tiles, hk = (it / n_tiles) % Hkv,
                  b = it / n_tiles / Hkv, key0 = kt * kT;
        const int i = n - first, buf = i % NB;
        mbar_wait(&sm.kv_empty[buf], ((i / NB) & 1) ^ 1);
        mbar_expect_tx(&sm.kv_full[buf], 2 * kWideBytes);
        for (int p = 0; p < kP; ++p) {
          tma_box(sm.kv[buf][0][p], &tm_k, &sm.kv_full[buf], 64 * p, hk, key0, b);
          tma_box(sm.kv[buf][1][p], &tm_v, &sm.kv_full[buf], 64 * p, hk, key0, b);
        }
        const Range qr = dkdv_rows(key0, kT, Sq, Sk, causal, window, q_offset);
        for (int gh = 0; gh < G; ++gh) {
          const int h = hk * G + gh;
          const float* st = stat + (static_cast<size_t>(b) * Hq + h) * nqt * kStat;
          for (int t = 0; t < qr.n; ++t) {
            const int i0 = qr.start + t * kT, stage = ring.stage;
            mbar_wait(&sm.empty[stage], ring.phase ^ 1);
            mbar_expect_tx(&sm.full[stage], 2 * kWideBytes + kStatBytes);
            for (int p = 0; p < kP; ++p) {
              tma_box(sm.ring[stage][0][p], &tm_q, &sm.full[stage], 64 * p, h, i0, b);
              tma_box(sm.ring[stage][1][p], &tm_do, &sm.full[stage], 64 * p, h, i0, b);
            }
            bulk_copy(sm.stat[stage], st + (i0 / kT) * kStat, kStatBytes, &sm.full[stage]);
            ring.next();
          }
        }
      }
    }
  } else {  // consumer warpgroup wg: rows [32 wg, + 32) of each q tile, dK / dV's columns [D/2 wg, + D/2)
    regs_inc<kConsumerRegs<kWideWG>>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int gr = lane >> 2, tq = lane & 3, r_a = warp * 16 + gr;
    const Attn a = {Sq, Sk, causal, window, q_offset, scale, scale * kLog2e, softcap};
    Ring<ST> ring;
    int pb = 0;
    for (int n = first; n < last; ++n) {
      const int it = items[n], kt = it % n_tiles, hk = (it / n_tiles) % Hkv,
                b = it / n_tiles / Hkv, key0 = kt * kT;
      const int i = n - first, buf = i % NB;
      const Range qr = dkdv_rows(key0, kT, Sq, Sk, causal, window, q_offset);
      mbar_wait(&sm.kv_full[buf], (i / NB) & 1);
      const int key_a = key0 + r_a;  // this thread's keys: key_a, key_a + 8
      const Span spans[2] = {key_rows(key_a, a), key_rows(key_a + 8, a)};
      float dka[D / 4], dva[D / 4];
#pragma unroll
      for (int e = 0; e < D / 4; ++e) dka[e] = dva[e] = 0.f;
      fence_acc(dka);  // the zeros are set here, not sunk between a fence and a wgmma
      fence_acc(dva);
      const KvAt<D> at = {dka, dva, tile_desc(sm.kv[buf][0][0]), tile_desc(sm.kv[buf][1][0]),
                          wg, wg * 32 + 2 * tq, r_a, lane, spans, a};
      // the q tiles with a live pair form a run [lo, hi); the rest are passed
      int lo = 0, hi = qr.n;
      while (lo < hi && !tile_live(qr.start + lo * kT, key0, a)) ++lo;
      while (hi > lo && !tile_live(qr.start + (hi - 1) * kT, key0, a)) --hi;
      const int row_w = qr.start + wg * 32 + 2 * tq;  // + t * kT: this thread's first row
      for (int gh = 0; gh < G; ++gh) {
        for (int t = 0; t < lo; ++t) skip_tile(sm.full, sm.empty, ring, lane);
        if (lo < hi) {
          if constexpr (kAhead) {
            int held = -1;
            float s0[16], s1[16], dp[16];
            mbar_wait(&sm.full[ring.stage], ring.phase);
            wgmma_fence();
            scores<D>(s0, at.k_desc, tile_desc(sm.ring[ring.stage][0][0] + wg * 32 * 64));
            wgmma_commit();
            scores<D>(dp, at.v_desc, tile_desc(sm.ring[ring.stage][1][0] + wg * 32 * 64));
            wgmma_commit();
            int cur = ring.stage;
            ring.next();
#define WKV_STEP(kNext, t, S, SN) \
  kv_step_w<kNext, kCap>(sm, ring, cur, held, pb, S, SN, dp, row_w + (t) * kT, at)
            int t = lo;
            for (; t + 2 < hi; t += 2) {
              WKV_STEP(true, t, s0, s1);
              WKV_STEP(true, t + 1, s1, s0);
            }
            if (t + 1 < hi) {
              WKV_STEP(true, t, s0, s1);
              WKV_STEP(false, t + 1, s1, s0);
            } else {
              WKV_STEP(false, t, s0, s1);
            }
#undef WKV_STEP
            wgmma_wait<0>();
            release(&sm.empty[held], lane);
          } else {
            float s[16], dp[16];
            for (int t = lo; t < hi; ++t) kv_step_n<kCap>(sm, ring, pb, s, dp, row_w + t * kT, at);
          }
        }
        for (int t = hi; t < qr.n; ++t) skip_tile(sm.full, sm.empty, ring, lane);
      }
      fence_acc(dka);
      fence_acc(dva);
      release(&sm.kv_empty[buf], lane);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int key = key_a + 8 * hh;
        if (key >= Sk) continue;
        const size_t off =
            ((static_cast<size_t>(b) * Sk + key) * Hkv + hk) * D + wg * (D / 2) + 2 * tq;
#pragma unroll
        for (int j = 0; j < D / 16; ++j) {
          *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * j) =
              __floats2bfloat162_rn(dka[4 * j + 2 * hh] * scale, dka[4 * j + 2 * hh + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * j) =
              __floats2bfloat162_rn(dva[4 * j + 2 * hh], dva[4 * j + 2 * hh + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

constexpr int kDqWG = K1B_DQ_WG, kDkdvWG = K1B_DKDV_WG, kStages = K1B_STAGES;
static_assert((kDqWG == 1 || kDqWG == 2) && (kDkdvWG == 1 || kDkdvWG == 2), "1 or 2 warpgroups");
static_assert(kStages >= 3 && kStages <= 6,
              "3 to 6 ring stages: a consumer holds one while the next loads");

constexpr int kDqSmem = sizeof(DqSmem<kDqWG, kStages>) + 1024;  // + the 1024-byte alignment
constexpr int kDkdvSmem = sizeof(DkdvSmem<kDkdvWG, kStages>) + 1024;
#define DQ_KERNEL(cap) flash_bwd_dq_wgmma<kDqWG, kStages, cap>
#define DKDV_KERNEL(cap) flash_bwd_dkdv_wgmma<kDkdvWG, kStages, cap>

// the wide instances' rings, item buffers and lookahead, by head dim
template <int D> struct WideBuild;
template <> struct WideBuild<128> {
  static constexpr int kDqStages = K1B_W128_DQ_STAGES, kDkdvStages = K1B_W128_DKDV_STAGES,
                       kDqBufs = K1B_W128_DQ_BUFS, kDkdvBufs = K1B_W128_DKDV_BUFS;
  static constexpr bool kAhead = K1B_W128_AHEAD;
};
template <> struct WideBuild<256> {
  static constexpr int kDqStages = K1B_W256_STAGES, kDkdvStages = K1B_W256_STAGES, kDqBufs = 1,
                       kDkdvBufs = 1;
  static constexpr bool kAhead = false;
};
template <int D>
constexpr int kWideDqSmem =
    sizeof(DqWideSmem<D, WideBuild<D>::kDqStages, WideBuild<D>::kDqBufs>) + 1024;
template <int D>
constexpr int kWideDkdvSmem =
    sizeof(DkdvWideSmem<D, WideBuild<D>::kDkdvStages, WideBuild<D>::kDkdvBufs>) + 1024;
template <int D>
constexpr bool wide_build_ok() {
  using W = WideBuild<D>;
  const int least = W::kAhead ? 3 : 2;  // a pipelined step holds two stages while the next loads
  return W::kDqStages >= least && W::kDkdvStages >= least && W::kDqBufs >= 1 &&
         W::kDqBufs <= 2 && W::kDkdvBufs >= 1 && W::kDkdvBufs <= 2 &&
         kWideDqSmem<D> <= 232448 && kWideDkdvSmem<D> <= 232448;
}
static_assert(wide_build_ok<128>() && wide_build_ok<256>(),
              "wide K1b: too few ring stages for the step, or more than 227 KB of shared memory");
#define WDQ_KERNEL(D, cap)                                                                     \
  flash_bwd_dq_sm90<D, WideBuild<D>::kDqStages, WideBuild<D>::kDqBufs, WideBuild<D>::kAhead, \
                    cap>
#define WDKDV_KERNEL(D, cap)                                                                      \
  flash_bwd_dkdv_sm90<D, WideBuild<D>::kDkdvStages, WideBuild<D>::kDkdvBufs,                    \
                      WideBuild<D>::kAhead, cap>

// a contiguous (B, S, H, D) bf16 tensor as boxes of 64 rows x 64 columns
// of one head, each box 64 rows of 128 bytes, 128-byte swizzled (a row of
// D > 64 arrives as D / 64 boxes); rows past S read as zeros
cudaError_t head_map(CUtensorMap* map, const void* base, int B, int S, int H, int D = 64) {
  EncodeTiled encode;
  const cudaError_t err = encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t row = static_cast<cuuint64_t>(D) * 2;  // bytes
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {row, static_cast<cuuint64_t>(H) * row,
                                 static_cast<cuuint64_t>(S) * H * row};  // bytes, dims 1-3
  const cuuint32_t box[4] = {64, 1, kT, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <bool kCap>
cudaError_t allow_both() {
  const cudaError_t err = ready<DQ_KERNEL(kCap)>(kEntryRegs<kDqWG>, kDqSmem);
  return err == cudaSuccess ? ready<DKDV_KERNEL(kCap)>(kEntryRegs<kDkdvWG>, kDkdvSmem) : err;
}

// the dq pass (which writes stat), then the dk / dv pass
template <bool kCap>
cudaError_t launch(const CUtensorMap& tm_q, const CUtensorMap& tm_k, const CUtensorMap& tm_v,
                   const CUtensorMap& tm_o, const CUtensorMap& tm_do, const void* lse,
                   void* dq, void* dk, void* dv, void* stat, const void* plan_dq, int blocks_dq,
                   const void* plan_dkdv, int blocks_dkdv, int Sq, int Sk, int Hq, int Hkv,
                   int causal, int window, float softcap, float scale, int q_offset,
                   cudaStream_t st) {
  cudaError_t err = allow_both<kCap>();
  if (err != cudaSuccess) return err;
  DQ_KERNEL(kCap)<<<blocks_dq, (kDqWG + 1) * 128, kDqSmem, st>>>(
      tm_q, tm_k, tm_v, tm_o, tm_do, static_cast<const float*>(lse), static_cast<float*>(stat),
      static_cast<bf16*>(dq), static_cast<const int*>(plan_dq), Sq, Sk, Hq, Hkv, causal, window,
      softcap, scale, q_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  DKDV_KERNEL(kCap)<<<blocks_dkdv, (kDkdvWG + 1) * 128, kDkdvSmem, st>>>(
      tm_q, tm_k, tm_v, tm_do, static_cast<const float*>(stat), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), static_cast<const int*>(plan_dkdv), Sq, Sk, Hq, Hkv, causal,
      window, softcap, scale, q_offset);
  return cudaGetLastError();
}

template <int D, bool kCap>
cudaError_t allow_wide() {
  const cudaError_t err = ready<WDQ_KERNEL(D, kCap)>(kEntryRegs<kWideWG>, kWideDqSmem<D>);
  return err == cudaSuccess
             ? ready<WDKDV_KERNEL(D, kCap)>(kEntryRegs<kWideWG>, kWideDkdvSmem<D>)
             : err;
}

// the wide dq pass (which writes stat), then the wide dk / dv pass
template <int D, bool kCap>
cudaError_t launch_wide(const CUtensorMap& tm_q, const CUtensorMap& tm_k, const CUtensorMap& tm_v,
                        const CUtensorMap& tm_do, const void* o, const void* dout,
                        const void* lse, void* dq, void* dk, void* dv, void* stat,
                        const void* plan_dq, int blocks_dq, const void* plan_dkdv,
                        int blocks_dkdv, int Sq, int Sk, int Hq, int Hkv, int causal, int window,
                        float softcap, float scale, int q_offset, cudaStream_t st) {
  cudaError_t err = allow_wide<D, kCap>();
  if (err != cudaSuccess) return err;
  WDQ_KERNEL(D, kCap)<<<blocks_dq, (kWideWG + 1) * 128, kWideDqSmem<D>, st>>>(
      tm_q, tm_k, tm_v, tm_do, static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(stat), static_cast<bf16*>(dq),
      static_cast<const int*>(plan_dq), Sq, Sk, Hq, Hkv, causal, window, softcap, scale,
      q_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  WDKDV_KERNEL(D, kCap)<<<blocks_dkdv, (kWideWG + 1) * 128, kWideDkdvSmem<D>, st>>>(
      tm_q, tm_k, tm_v, tm_do, static_cast<const float*>(stat), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), static_cast<const int*>(plan_dkdv), Sq, Sk, Hq, Hkv, causal,
      window, softcap, scale, q_offset);
  return cudaGetLastError();
}

// the configuration of the wide instances at D (flash_attention_bwd_sm90_config)
template <int D>
cudaError_t wide_config(int* out) {
  using W = WideBuild<D>;
  out[7] = out[8] = kEntryRegs<kWideWG>;
  out[9] = registers<WDQ_KERNEL(D, false)>();
  out[10] = registers<WDKDV_KERNEL(D, false)>();
  out[11] = registers<WDQ_KERNEL(D, true)>();
  out[12] = registers<WDKDV_KERNEL(D, true)>();
  int dq_cap = 0, dkdv_cap = 0;
  cudaError_t err = allow_wide<D, false>();
  if (err == cudaSuccess) err = allow_wide<D, true>();
  constexpr int threads = (kWideWG + 1) * 128;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], WDQ_KERNEL(D, false), threads,
                                                        kWideDqSmem<D>);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], WDKDV_KERNEL(D, false), threads,
                                                        kWideDkdvSmem<D>);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&dq_cap, WDQ_KERNEL(D, true), threads,
                                                        kWideDqSmem<D>);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&dkdv_cap, WDKDV_KERNEL(D, true),
                                                        threads, kWideDkdvSmem<D>);
  if (err == cudaSuccess && (dq_cap != out[3] || dkdv_cap != out[4]))
    err = cudaErrorInvalidConfiguration;
  out[0] = out[1] = kWideWG;
  out[2] = W::kDqStages;
  out[5] = kWideDqSmem<D>;
  out[6] = kWideDkdvSmem<D>;
  out[14] = out[15] = 1;  // an item is one 64-row (64-key) tile
  out[16] = W::kDkdvStages;
  out[17] = W::kDqBufs;
  out[18] = W::kDkdvBufs;
  out[19] = W::kAhead;
  return err;
}

}  // namespace

// The configuration of the build's instances at head dim D (64, 128 or
// 256) and the blocks of each pass an SM holds (the persistent grids'
// slots): out[0..4] = dq warpgroups, dk / dv warpgroups, dq ring stages,
// dq blocks an SM, dk / dv blocks an SM, out[5..6] = the two passes'
// dynamic shared memory in bytes, out[7..8] = the entry registers
// setmaxnreg's counts assume for dq and dk / dv, out[9..12] = the registers
// ptxas gave the dq, dk / dv, softcap dq and softcap dk / dv kernels (-1 if
// unknown), out[13] = D, out[14..15] = the 64-row (64-key) tiles of a dq
// and a dk / dv item, out[16] = dk / dv ring stages, out[17..18] = the dq
// and dk / dv item buffers, out[19] = 1 if a step issues the next tile's
// scores first.
// Fails (cudaErrorInvalidKernelImage) if the registers differ.
extern "C" int flash_attention_bwd_sm90_config(int D, int* out) {
  out[13] = D;
  if (D == 128) return wide_config<128>(out);
  if (D == 256) return wide_config<256>(out);
  if (D != 64) return cudaErrorInvalidValue;
  out[14] = kDqWG;
  out[15] = kDkdvWG;
  out[16] = kStages;
  out[17] = out[18] = 2;
  out[19] = 1;
  out[7] = kEntryRegs<kDqWG>;
  out[8] = kEntryRegs<kDkdvWG>;
  out[9] = registers<DQ_KERNEL(false)>();
  out[10] = registers<DKDV_KERNEL(false)>();
  out[11] = registers<DQ_KERNEL(true)>();
  out[12] = registers<DKDV_KERNEL(true)>();
  int dq_cap = 0, dkdv_cap = 0;  // the softcap instances, which must hold as many
  cudaError_t err = allow_both<false>();
  if (err == cudaSuccess) err = allow_both<true>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], DQ_KERNEL(false),
                                                        (kDqWG + 1) * 128, kDqSmem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], DKDV_KERNEL(false),
                                                        (kDkdvWG + 1) * 128, kDkdvSmem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&dq_cap, DQ_KERNEL(true),
                                                        (kDqWG + 1) * 128, kDqSmem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&dkdv_cap, DKDV_KERNEL(true),
                                                        (kDkdvWG + 1) * 128, kDkdvSmem);
  if (err == cudaSuccess && (dq_cap != out[3] || dkdv_cap != out[4]))
    err = cudaErrorInvalidConfiguration;
  out[0] = kDqWG;
  out[1] = kDkdvWG;
  out[2] = kStages;
  out[5] = kDqSmem;
  out[6] = kDkdvSmem;
  return err;
}

// q, dout, dq (B, Sq, Hq, D) and k, v, dk, dv (B, Sk, Hkv, D) bf16, D 64,
// 128 or 256, contiguous, 16-byte aligned; o the forward's output; lse f32
// (B, Hq, Sq); stat f32 scratch (B, Hq, ceil(Sq / 64), 128); plan_dq /
// plan_dkdv int32 device arrays of blocks_dq / blocks_dkdv blocks
// (flash_attention.bwd_plan).  window < 0: no sliding window; softcap <= 0:
// no softcap.  Two kernels on ``stream``, the dq pass (which writes stat)
// first.
extern "C" int flash_attention_bwd_sm90(const void* q, const void* k, const void* v,
                                        const void* o, const void* lse, const void* dout,
                                        void* dq, void* dk, void* dv, void* stat,
                                        const void* plan_dq, int blocks_dq,
                                        const void* plan_dkdv, int blocks_dkdv, int B, int Sq,
                                        int Sk, int Hq, int Hkv, int D, int causal, int window,
                                        float softcap, float scale, int q_offset, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || Hq % Hkv || blocks_dq < 1 || blocks_dkdv < 1 ||
      (D != 64 && D != 128 && D != 256))
    return cudaErrorInvalidValue;
  CUtensorMap tm_q, tm_k, tm_v, tm_o, tm_do;
  cudaError_t err = head_map(&tm_q, q, B, Sq, Hq, D);
  if (err == cudaSuccess) err = head_map(&tm_k, k, B, Sk, Hkv, D);
  if (err == cudaSuccess) err = head_map(&tm_v, v, B, Sk, Hkv, D);
  if (err == cudaSuccess) err = head_map(&tm_do, dout, B, Sq, Hq, D);
  if (err != cudaSuccess) return err;
  if (D != 64) {
#define WIDE_ARGS                                                                             \
  tm_q, tm_k, tm_v, tm_do, o, dout, lse, dq, dk, dv, stat, plan_dq, blocks_dq, plan_dkdv,    \
      blocks_dkdv, Sq, Sk, Hq, Hkv, causal, window, softcap, scale, q_offset, st
    if (D == 128)
      return softcap > 0.f ? launch_wide<128, true>(WIDE_ARGS) : launch_wide<128, false>(WIDE_ARGS);
    return softcap > 0.f ? launch_wide<256, true>(WIDE_ARGS) : launch_wide<256, false>(WIDE_ARGS);
#undef WIDE_ARGS
  }
  err = head_map(&tm_o, o, B, Sq, Hq);
  if (err != cudaSuccess) return err;
#define LAUNCH_ARGS                                                                            \
  tm_q, tm_k, tm_v, tm_o, tm_do, lse, dq, dk, dv, stat, plan_dq, blocks_dq, plan_dkdv,        \
      blocks_dkdv, Sq, Sk, Hq, Hkv, causal, window, softcap, scale, q_offset, st
  return softcap > 0.f ? launch<true>(LAUNCH_ARGS) : launch<false>(LAUNCH_ARGS);
#undef LAUNCH_ARGS
}
