// (1 + scale) RMSNorm over rows for Hopper (sm_90a):
//
//   y = x * rsqrt(mean(x²) + eps) * (1 + scale)
//
// x: (rows, D) in f32 or bf16, scale: (D,) f32 -> y (rows, D) in x's type.
// All arithmetic is f32.
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm.py (rmsnorm,
// _rmsnorm_kernel).  There a grid step takes a (256, D) tile of rows into
// VMEM and reduces each row in vector registers.  Here a row is spread over
// L lanes (a power of two) and held in their registers from its load to its
// store.
//
// What bounds it: it reads x once and writes y once, with no matrix work, so
// bytes bound it: the served shapes move 14 KB ((8, 896) bf16) to 16.8 MB
// ((512, 8192) bf16), 4 ns to 5.0 us at 3.35 TB/s.  At all of them the
// card's fixed cost of one launch is most of the time (`launch_floor`
// below, timed beside the kernel by chip_smoke.py: 4.6-5.0 us on an NVIDIA
// H100 80GB HBM3 at 700.00 W, against 5.5-12.0 us for the kernel); the rest
// is one round trip to device memory for the row and one for the store.  So
// the design keeps that to one trip and spends no barrier where none is
// needed:
//
// * norm_plan (kernels/rmsnorm.py) gives each row L lanes, so that its
//   16-byte chunks span them: lane i holds chunks i, i + L, .., i + (kC - 1)L
//   (chunk c = elements c·E .. c·E + E - 1, E = 16 / sizeof(T)).  Narrow rows
//   pack several to a warp (D 16 in bf16: 2 lanes, 16 rows a warp); rows of
//   up to 32 lanes reduce their sum of squares by an f32 butterfly of
//   shuffles with no barrier; wider ones (4 chunks a lane, 2 for the few
//   rows of a decode step) take whole warps of one block, and one
//   shared-memory step joins the warps' sums.
// * Every load is issued before any arithmetic: the lane's chunks of x (as
//   raw bits, converted at use) and of the scale (as f32) into registers, so
//   that one trip to device memory serves both; the values stay there until
//   the store.  No shared memory but the wide rows' one step.
// * Rows off 16 bytes (a view off a 16-byte boundary, or D·sizeof(T) not a
//   multiple of 16) take the same kernel with element-wise loads and stores
//   (kVec = false).
#include <cstdint>

#include "mma.cuh"

namespace {

constexpr int kMaxThreads = 256;  // a row's lanes at most: up to 255 registers a thread

// element j of a 16-byte chunk held as 4 words, as f32
template <typename T> __device__ __forceinline__ float word_f32(const uint32_t (&w)[4], int j);
template <> __device__ __forceinline__ float word_f32<float>(const uint32_t (&w)[4], int j) {
  return __uint_as_float(w[j]);
}
template <>
__device__ __forceinline__ float word_f32<__nv_bfloat16>(const uint32_t (&w)[4], int j) {
  return __uint_as_float(j % 2 ? w[j / 2] & 0xffff0000u : w[j / 2] << 16);
}
// the bits of one element
__device__ __forceinline__ uint32_t elem_bits(const float* p) {
  return __float_as_uint(*p);
}
__device__ __forceinline__ uint32_t elem_bits(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned short*>(p);
}
template <typename T> __device__ __forceinline__ uint32_t out_bits(float v);
template <> __device__ __forceinline__ uint32_t out_bits<float>(float v) {
  return __float_as_uint(v);
}
template <> __device__ __forceinline__ uint32_t out_bits<__nv_bfloat16>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16(v));
}

template <typename T, int kC, bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_rows(const T* __restrict__ x, const float* __restrict__ scale, T* __restrict__ out,
             int rows, int D, int L, float eps) {
  constexpr int E = 16 / sizeof(T);  // elements in a 16-byte chunk
  __shared__ float warp_sum[kMaxThreads / 32];

  const int tid = threadIdx.x;
  const int li = tid & (L - 1);                  // lane in the row
  const int row = blockIdx.x * (blockDim.x / L) + tid / L;
  const bool live = row < rows;                  // the ragged last block
  const int C = (D + E - 1) / E;                 // chunks in a row
  const T* xr = x + static_cast<size_t>(live ? row : 0) * D;

  // every load before any arithmetic: the row's chunks as raw bits, the
  // scale's as f32 (zeros past the row)
  uint32_t w[kC][4];
  float s[kC][E];
#pragma unroll
  for (int i = 0; i < kC; ++i) {
    const int c = li + i * L;
    const bool ok = live && c < C;
    if constexpr (kVec) {
      const uint4 q = ok ? *reinterpret_cast<const uint4*>(xr + c * E) : make_uint4(0, 0, 0, 0);
      w[i][0] = q.x, w[i][1] = q.y, w[i][2] = q.z, w[i][3] = q.w;
#pragma unroll
      for (int k = 0; k < E; k += 4) {
        const float4 v = ok ? *reinterpret_cast<const float4*>(scale + c * E + k)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        s[i][k] = v.x, s[i][k + 1] = v.y, s[i][k + 2] = v.z, s[i][k + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) w[i][k] = 0u;
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const int e = c * E + j;
        const bool in = ok && e < D;
        const uint32_t b = in ? elem_bits(xr + e) : 0u;
        if constexpr (sizeof(T) == 4)
          w[i][j] = b;
        else
          w[i][j / 2] |= j % 2 ? b << 16 : b;
        s[i][j] = in ? scale[e] : 0.f;
      }
    }
  }

  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kC; ++i)
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const float v = word_f32<T>(w[i], j);
      ss = fmaf(v, v, ss);
    }
  // the row's lanes are L consecutive lanes of a warp (or whole warps)
  for (int off = (L < 32 ? L : 32) / 2; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (L > 32) {  // one row a block: join the warps' sums
    if ((tid & 31) == 0) warp_sum[tid >> 5] = ss;
    __syncthreads();
    ss = 0.f;
    for (int k = 0; k < L / 32; ++k) ss += warp_sum[k];
  }
  const float rstd = rsqrtf(ss / static_cast<float>(D) + eps);

  if (!live) return;
  T* orow = out + static_cast<size_t>(row) * D;
#pragma unroll
  for (int i = 0; i < kC; ++i) {
    const int c = li + i * L;
    uint32_t o[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const uint32_t b = out_bits<T>(word_f32<T>(w[i], j) * rstd * (1.f + s[i][j]));
      if constexpr (sizeof(T) == 4)
        o[j] = b;
      else
        o[j / 2] |= j % 2 ? b << 16 : b;
    }
    if constexpr (kVec) {
      if (c < C) *reinterpret_cast<uint4*>(orow + c * E) = make_uint4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const int e = c * E + j;
        if (c < C && e < D) {
          if constexpr (sizeof(T) == 4)
            reinterpret_cast<uint32_t*>(orow)[e] = o[j];
          else
            reinterpret_cast<unsigned short*>(orow)[e] =
                static_cast<unsigned short>(o[j / 2] >> (16 * (j % 2)));
        }
      }
    }
  }
}

template <typename T, int kC, bool kVec>
cudaError_t launch(const void* x, const float* scale, void* out, int rows, int D, int L,
                   int threads, float eps, cudaStream_t st) {
  const int per_block = threads / L;
  rmsnorm_rows<T, kC, kVec><<<(rows + per_block - 1) / per_block, threads, 0, st>>>(
      static_cast<const T*>(x), scale, static_cast<T*>(out), rows, D, L, eps);
  return cudaGetLastError();
}

template <typename T, bool kVec>
cudaError_t launch_c(const void* x, const float* scale, void* out, int rows, int D, int L,
                     int threads, int chunks, float eps, cudaStream_t st) {
  switch (chunks) {  // the chunks a lane holds, as norm_plan gives them
    case 1: return launch<T, 1, kVec>(x, scale, out, rows, D, L, threads, eps, st);
    case 2: return launch<T, 2, kVec>(x, scale, out, rows, D, L, threads, eps, st);
    case 4: return launch<T, 4, kVec>(x, scale, out, rows, D, L, threads, eps, st);
    case 8: return launch<T, 8, kVec>(x, scale, out, rows, D, L, threads, eps, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_t(const void* x, const float* scale, void* out, int rows, int D, int L,
                     int threads, int chunks, float eps, cudaStream_t st) {
  // 16-byte loads need 16-byte aligned rows of x and y and a 16-byte aligned scale
  const bool vec = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(scale) |
                    reinterpret_cast<uintptr_t>(out)) % 16 == 0 &&
                   D * sizeof(T) % 16 == 0;
  return vec ? launch_c<T, true>(x, scale, out, rows, D, L, threads, chunks, eps, st)
             : launch_c<T, false>(x, scale, out, rows, D, L, threads, chunks, eps, st);
}

// ---------------------------------------------------------------------------
// K3b: the backward, dx and dscale from (x, scale, dy)
// ---------------------------------------------------------------------------
//
// With r = rsqrt(mean(x^2) + eps) and g = dy (1 + scale), per row:
//
//   dx = r g - x r^3 (g . x) / D          dscale = sum over rows of dy x r
//
// in f32, dx in x's type.  The JAX model runs RMSNorm in jnp
// (repro/nn/core.py::rmsnorm), so there is no TPU kernel to copy; this is
// jax.grad of that function.
//
// What bounds it: bytes.  It must read x and dy and write dx once
// (smollm-360m's (8192, 960) bf16: 47 MB, 0.014 ms at 3.35 TB/s), and does
// a few operations an element.  rmsnorm_bwd_fused is one launch:
//
// * A persistent grid (bwd_plan in kernels/rmsnorm.py) of one 256-thread
//   block an SM, each a contiguous run of rows (the runs differ by at most
//   one).  A row is spread over L lanes (a power of two); the block's G =
//   256 / L groups of L lanes take every G-th row of its run, and a lane
//   owns the same 16-byte chunks li, li + L, .. of every row it takes, so
//   its (1 + scale) values, read once, and its dscale partials stay in
//   registers for the whole run (at most 32 f32 of each).
// * Each element of x and dy crosses device memory once and stays in
//   registers from its load to dx's store: the row's two sums (x.x, g.x)
//   join over its lanes by shuffles and, for L > 32, one shared-memory step
//   whose barrier the block's groups take in lockstep.  The next row's
//   loads (16 bytes, not kept in L1, with a hint that L2 fetch 256) are
//   issued before this row's arithmetic, so a group has two rows in flight.
// * dscale without float atomics: the block joins its groups' partials in
//   group order through shared memory into its row of `partial`, then takes
//   a ticket (after a __threadfence).  The last kJoiners blocks to arrive
//   wait until every block has, then each sums 1 / kJoiners of the columns
//   over every block's row: a thread takes a 16-byte column and a run of
//   consecutive rows, all its loads in flight, and the runs' sums join in
//   order through shared memory.  So what follows the last block's rows is
//   one round trip of loads spread over kJoiners SMs (one last block
//   summing all 132 rows at D 960 took 0.011 ms longer:
//   tools/k3b_variants.py).  Equal inputs give equal bits.
// * The two ticket counters (`count`: blocks arrived, joiners done) belong
//   to the caller, one pair a stream (rmsnorm.counters), so launches that
//   overlap on other streams never share them; the last joiner to finish
//   resets both, so the next launch on the stream, or the next replay of a
//   CUDA graph holding one, finds them 0.  Waiting is safe while the card
//   holds more blocks at once than the running launches' joiners: at most
//   kJoiners blocks of a launch wait, so a block that has not started finds
//   a free SM (and a wait past kHangNs traps instead of hanging).
//
// tools/k3b_variants.py builds the designs not kept (a bulk-copy ring, a
// cluster join, other joiner counts, prefetch depths, 2 blocks an SM) from
// this source by text substitutions that must match.
//
// rmsnorm_bwd_rows + rmsnorm_bwd_dscale, further down, are the previous
// design (a warp a row, each row read twice, the dscale partials through
// shared memory and a second kernel that sums the blocks' rows serially);
// only the C entry rmsnorm_bwd_v1 reaches them, for tools/k3b_variants.py
// and chip_smoke.py to time beside the new kernel.
constexpr int kBwdThreads = 256;  // threads of a K3b block (bwd_plan's BWD_THREADS)
constexpr int kJoiners = 32;      // the last blocks to arrive, which sum dscale (BWD_JOINERS)

__device__ __forceinline__ unsigned int ld_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// 16 bytes of a row that this kernel only reads: not kept in L1, and a
// hint that L2 fetch the 256 bytes around them (a warp reads 512 in a row)
__device__ __forceinline__ uint4 ld_row(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}
__device__ __forceinline__ void add4(float4& s, const float4 v) {
  s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
}

template <typename T, int kC>
__global__ void __launch_bounds__(kBwdThreads, 1)
rmsnorm_bwd_fused(const T* __restrict__ x, const float* __restrict__ scale,
                  const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ partial,
                  float* __restrict__ dscale, unsigned int* __restrict__ count, int rows, int D,
                  int L, float eps) {
  constexpr int E = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[2][kBwdThreads / 32][2];  // L > 32: each warp's two sums, by row parity
  __shared__ unsigned int ticket;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = kBwdThreads / L, g = tid / L, li = tid & (L - 1);
  const int C = D / E, D4 = D / 4;
  const int q = rows / gridDim.x, extra = rows % gridDim.x, b = blockIdx.x;
  const int start = b * q + min(b, extra), n = q + (b < extra);  // the block's run of rows
  const int steps = (n + G - 1) / G;  // rows a group takes, at most: the block's lockstep count
  float4* join = reinterpret_cast<float4*>(smem);  // [G][D / 4]: the groups' dscale partials

  float sc[kC][E], dsc[kC][E];  // (1 + scale) at the lane's columns; its dscale partials
#pragma unroll
  for (int i = 0; i < kC; ++i) {
    const int c = li + i * L;
#pragma unroll
    for (int k = 0; k < E; k += 4) {
      const float4 v = c < C ? *reinterpret_cast<const float4*>(scale + c * E + k)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      sc[i][k] = 1.f + v.x, sc[i][k + 1] = 1.f + v.y, sc[i][k + 2] = 1.f + v.z,
      sc[i][k + 3] = 1.f + v.w;
    }
#pragma unroll
    for (int j = 0; j < E; ++j) dsc[i][j] = 0.f;
  }

  // step s's row from the lane's chunks in registers: the two sums over the
  // row's lanes, then dx and the dscale partials
  auto row = [&](const uint32_t (&xw)[kC][4], const uint32_t (&gw)[kC][4], int s) {
    float ss = 0.f, sgx = 0.f;
#pragma unroll
    for (int i = 0; i < kC; ++i)
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const float xf = word_f32<T>(xw[i], j);
        ss = fmaf(xf, xf, ss);
        sgx = fmaf(word_f32<T>(gw[i], j) * sc[i][j], xf, sgx);
      }
    for (int off = (L < 32 ? L : 32) / 2; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      sgx += __shfl_xor_sync(0xffffffffu, sgx, off);
    }
    if (L > 32) {  // the row's warps join through shared memory
      if (lane == 0) red[s & 1][warp][0] = ss, red[s & 1][warp][1] = sgx;
      __syncthreads();
      ss = sgx = 0.f;
      for (int w = g * (L / 32); w < (g + 1) * (L / 32); ++w)
        ss += red[s & 1][w][0], sgx += red[s & 1][w][1];
    }
    if (s * G + g >= n) return;  // past the group's rows
    const float r = rsqrtf(ss / static_cast<float>(D) + eps);
    const float coef = r * r * r * sgx / static_cast<float>(D);
    T* dr = dx + static_cast<size_t>(start + s * G + g) * D;
#pragma unroll
    for (int i = 0; i < kC; ++i) {
      const int c = li + i * L;
      if (c >= C) continue;
      uint32_t o[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const float xf = word_f32<T>(xw[i], j), gf = word_f32<T>(gw[i], j);
        const uint32_t v = out_bits<T>(r * (gf * sc[i][j]) - xf * coef);
        if constexpr (sizeof(T) == 4)
          o[j] = v;
        else
          o[j / 2] |= j % 2 ? v << 16 : v;
        dsc[i][j] = fmaf(gf * xf, r, dsc[i][j]);
      }
      *reinterpret_cast<uint4*>(dr + c * E) = make_uint4(o[0], o[1], o[2], o[3]);  // dx
    }
  };

  // step s's chunks of x and dy (zeros past the group's rows or the row)
  auto load = [&](uint32_t (&xw)[kC][4], uint32_t (&gw)[kC][4], int s) {
    const bool live = s * G + g < n;
    const size_t at = static_cast<size_t>(start + s * G + g) * D;
#pragma unroll
    for (int i = 0; i < kC; ++i) {
      const int c = li + i * L;
      const bool ok = live && c < C;
      const uint4 a = ok ? ld_row(x + at + c * E) : make_uint4(0, 0, 0, 0);
      const uint4 d = ok ? ld_row(dy + at + c * E) : make_uint4(0, 0, 0, 0);
      xw[i][0] = a.x, xw[i][1] = a.y, xw[i][2] = a.z, xw[i][3] = a.w;
      gw[i][0] = d.x, gw[i][1] = d.y, gw[i][2] = d.z, gw[i][3] = d.w;
    }
  };
  // kAhead + 1 register buffers: the loads of the next kAhead rows fly
  // during this row's arithmetic (step s's row is in buf[s % (kAhead + 1)])
  constexpr int kAhead = 1;
  uint32_t buf[kAhead + 1][2][kC][4];
#pragma unroll
  for (int u = 0; u < kAhead; ++u)
    if (u < steps) load(buf[u][0], buf[u][1], u);
  for (int s0 = 0; s0 < steps; s0 += kAhead + 1) {
#pragma unroll
    for (int u = 0; u <= kAhead; ++u) {
      const int s = s0 + u, next = (u + kAhead) % (kAhead + 1);
      if (s >= steps) break;
      if (s + kAhead < steps) load(buf[next][0], buf[next][1], s + kAhead);
      row(buf[u][0], buf[u][1], s);
    }
  }

  // the block's row of dscale partials: its groups', in group order
#pragma unroll
  for (int i = 0; i < kC; ++i) {
    const int c = li + i * L;
    if (c < C)
#pragma unroll
      for (int k = 0; k < E; k += 4)
        join[g * D4 + (c * E + k) / 4] =
            make_float4(dsc[i][k], dsc[i][k + 1], dsc[i][k + 2], dsc[i][k + 3]);
  }
  __syncthreads();
  float4* part = reinterpret_cast<float4*>(partial);
  for (int d = tid; d < D4; d += kBwdThreads) {
    float4 s = join[d];
    for (int h = 1; h < G; ++h) add4(s, join[h * D4 + d]);
    part[static_cast<size_t>(b) * D4 + d] = s;
  }
  const int n_part = gridDim.x;  // rows of partials
  // the last J blocks to arrive wait for the rest, then each sums its share
  // of the columns over every row.  The ticket is taken as cooperative
  // groups' grid barrier takes it: the block's barrier, then one thread's
  // __threadfence (which orders the block's writes before the atomic)
  const int J = min(kJoiners, static_cast<int>(gridDim.x));
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    ticket = atomicAdd(&count[0], 1u);
  }
  __syncthreads();
  if (ticket < gridDim.x - J) return;
  if (tid == 0) {  // the last block to arrive finds the count full at once
    const unsigned long long t0 = global_ns();
    for (uint32_t k = 1; ld_acquire(&count[0]) < gridDim.x; ++k)
      if (k % 1024 == 0 && global_ns() - t0 > kHangNs) __trap();
  }
  __syncthreads();
  // joiner `me` takes 16-byte columns [me * per, (me + 1) * per), `width`
  // at a time; a thread takes one of them and a segment of `seg`
  // consecutive rows (its loads all in flight), and the segments' sums join
  // in order through shared memory
  const int me = static_cast<int>(ticket) - (static_cast<int>(gridDim.x) - J);
  const int per = (D4 + J - 1) / J, width = min(per, kBwdThreads);
  const int nseg = max(1, min(n_part, kBwdThreads / width)), seg = (n_part + nseg - 1) / nseg;
  const int col = tid % width, k = tid / width;
  float4* seg_sum = join;  // [nseg][width]: the block's own partials are written out
  for (int c0 = 0; c0 < per; c0 += width) {
    const int d = me * per + c0 + col;
    const bool mine = c0 + col < per && d < D4;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k < nseg && mine) {
      const int i0 = k * seg, i1 = min(n_part, i0 + seg);
      for (int i = i0; i < i1; i += 16) {
        float4 v[16];
#pragma unroll
        for (int u = 0; u < 16; ++u)
          if (i + u < i1) v[u] = __ldcg(part + static_cast<size_t>(i + u) * D4 + d);
#pragma unroll
        for (int u = 0; u < 16; ++u)
          if (i + u < i1) add4(s, v[u]);
      }
    }
    if (k < nseg) seg_sum[k * width + col] = s;
    __syncthreads();
    if (k == 0 && mine) {
      for (int h = 1; h < nseg; ++h) add4(s, seg_sum[h * width + col]);
      reinterpret_cast<float4*>(dscale)[d] = s;
    }
    __syncthreads();
  }
  // the last joiner to finish waiting resets both counts for the next
  // launch (or the next replay of a CUDA graph holding one)
  if (tid == 0 && atomicInc(&count[1], J - 1) == static_cast<unsigned int>(J - 1))
    atomicExch(&count[0], 0u);
}

template <typename T, int kC>
cudaError_t launch_bwd(const void* x, const float* scale, const void* dy, void* dx,
                       float* partial, float* dscale, unsigned int* count, int rows, int D, int L,
                       int grid, float eps, cudaStream_t st) {
  const int smem = kBwdThreads / L * D * 4;  // the groups' rows of dscale partials
  cudaError_t err = allow_smem<rmsnorm_bwd_fused<T, kC>>(smem);
  if (err != cudaSuccess) return err;
  rmsnorm_bwd_fused<T, kC><<<grid, kBwdThreads, smem, st>>>(
      static_cast<const T*>(x), scale, static_cast<const T*>(dy), static_cast<T*>(dx), partial,
      dscale, count, rows, D, L, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_c(const void* x, const float* scale, const void* dy, void* dx,
                         float* partial, float* dscale, unsigned int* count, int rows, int D,
                         int L, int chunks, int grid, float eps, cudaStream_t st) {
  switch (chunks) {  // the chunks a lane holds, as bwd_plan gives them: 32 elements at most
    case 1:
      return launch_bwd<T, 1>(x, scale, dy, dx, partial, dscale, count, rows, D, L, grid, eps,
                              st);
    case 2:
      return launch_bwd<T, 2>(x, scale, dy, dx, partial, dscale, count, rows, D, L, grid, eps,
                              st);
    case 4:
      return launch_bwd<T, 4>(x, scale, dy, dx, partial, dscale, count, rows, D, L, grid, eps,
                              st);
    case 8:
      if constexpr (sizeof(T) == 4)
        return launch_bwd<T, 8>(x, scale, dy, dx, partial, dscale, count, rows, D, L, grid, eps,
                                st);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

// The previous design of K3b (rmsnorm_bwd_v1): one warp takes one row at a
// time (rows warp-strided over the grid); a lane walks the row's 16-byte
// chunks lane, lane + 32, ... twice: once for the two sums, once, from L1,
// for dx.  dscale's partial for the lane's columns accumulates in the
// warp's own row of shared memory across every row the warp takes, then the
// block sums its warps' rows in a fixed order into one partial row, and
// rmsnorm_bwd_dscale sums the blocks' partials column by column.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_bwd_rows(const T* __restrict__ x, const float* __restrict__ scale,
                 const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ partial,
                 int rows, int D, float eps) {
  constexpr int E = 16 / sizeof(T);
  extern __shared__ __align__(16) float acc[];  // [warps][D]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, W = blockDim.x >> 5;
  float* mine = acc + static_cast<size_t>(warp) * D;
  const int C = D / E;
  for (int c = lane; c < C; c += 32)
#pragma unroll
    for (int j = 0; j < E; ++j) mine[c * E + j] = 0.f;

  for (int row = blockIdx.x * W + warp; row < rows; row += gridDim.x * W) {
    const T* xr = x + static_cast<size_t>(row) * D;
    const T* gr = dy + static_cast<size_t>(row) * D;
    float ss = 0.f, sgx = 0.f;
#pragma unroll 4
    for (int c = lane; c < C; c += 32) {
      const uint4 xv = *reinterpret_cast<const uint4*>(xr + c * E);
      const uint4 gv = *reinterpret_cast<const uint4*>(gr + c * E);
      const uint32_t xw[4] = {xv.x, xv.y, xv.z, xv.w}, gw[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const float xf = word_f32<T>(xw, j);
        ss = fmaf(xf, xf, ss);
        sgx = fmaf(word_f32<T>(gw, j) * (1.f + scale[c * E + j]), xf, sgx);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      sgx += __shfl_xor_sync(0xffffffffu, sgx, off);
    }
    const float r = rsqrtf(ss / static_cast<float>(D) + eps);
    const float coef = r * r * r * sgx / static_cast<float>(D);
    T* dr = dx + static_cast<size_t>(row) * D;
#pragma unroll 4
    for (int c = lane; c < C; c += 32) {
      const uint4 xv = *reinterpret_cast<const uint4*>(xr + c * E);
      const uint4 gv = *reinterpret_cast<const uint4*>(gr + c * E);
      const uint32_t xw[4] = {xv.x, xv.y, xv.z, xv.w}, gw[4] = {gv.x, gv.y, gv.z, gv.w};
      uint32_t o[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const float xf = word_f32<T>(xw, j), gf = word_f32<T>(gw, j);
        const uint32_t b = out_bits<T>(r * gf * (1.f + scale[c * E + j]) - xf * coef);
        if constexpr (sizeof(T) == 4)
          o[j] = b;
        else
          o[j / 2] |= j % 2 ? b << 16 : b;
        mine[c * E + j] += gf * xf * r;
      }
      *reinterpret_cast<uint4*>(dr + c * E) = make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < W; ++w) s += acc[static_cast<size_t>(w) * D + d];
    partial[static_cast<size_t>(blockIdx.x) * D + d] = s;
  }
}

// dscale[d] = sum over the n blocks' partial rows, in block order
__global__ void rmsnorm_bwd_dscale(const float* __restrict__ partial, float* __restrict__ dscale,
                                   int n, int D) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= D) return;
  float s = 0.f;
  for (int i = 0; i < n; ++i) s += partial[static_cast<size_t>(i) * D + d];
  dscale[d] = s;
}

template <typename T>
cudaError_t launch_bwd_v1(const void* x, const float* scale, const void* dy, void* dx,
                          float* partial, float* dscale, int rows, int D, int warps, int grid,
                          float eps, cudaStream_t st) {
  const int smem = warps * D * static_cast<int>(sizeof(float));
  cudaError_t err = allow_smem<rmsnorm_bwd_rows<T>>(smem);
  if (err != cudaSuccess) return err;
  rmsnorm_bwd_rows<T><<<grid, 32 * warps, smem, st>>>(
      static_cast<const T*>(x), scale, static_cast<const T*>(dy), static_cast<T*>(dx), partial,
      rows, D, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rmsnorm_bwd_dscale<<<(D + 127) / 128, 128, 0, st>>>(partial, dscale, grid, D);
  return cudaGetLastError();
}

__global__ void empty_kernel() {}

}  // namespace

// K3b.  dtype: x / dy / dx; scale (D,), partial (grid, D) and dscale (D,)
// f32; count two u32 at 0, which no launch that may overlap this one
// shares (rmsnorm.counters: one pair a stream).  lanes, chunks and grid
// from bwd_plan (kernels/rmsnorm.py): lanes a power of two up to 256,
// lanes x chunks 16-byte chunks covering a row, 32 elements a lane at
// most; D * sizeof(T) a multiple of 16 and every pointer 16-byte aligned.
// One kernel on ``stream``.
extern "C" int rmsnorm_bwd(const void* x, const void* scale, const void* dy, void* dx,
                           void* partial, void* dscale, void* count, int dtype, int rows, int D,
                           int lanes, int chunks, int grid, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int esize = dtype == kF32 ? 4 : 2, E = 16 / esize;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(scale) |
                         reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(dx) |
                         reinterpret_cast<uintptr_t>(partial) | reinterpret_cast<uintptr_t>(dscale);
  if (rows < 1 || D < 1 || lanes < 1 || lanes > kBwdThreads || (lanes & (lanes - 1)) ||
      chunks < 1 || chunks * E > 32 || static_cast<long long>(lanes) * chunks * E < D ||
      grid < 1 || (D * esize) % 16 || addr % 16 || reinterpret_cast<uintptr_t>(count) % 4)
    return cudaErrorInvalidValue;
  const float* sf = static_cast<const float*>(scale);
  float *pf = static_cast<float*>(partial), *df = static_cast<float*>(dscale);
  unsigned int* cnt = static_cast<unsigned int*>(count);
  switch (dtype) {
    case kF32:
      return launch_bwd_c<float>(x, sf, dy, dx, pf, df, cnt, rows, D, lanes, chunks, grid, eps,
                                 st);
    case kBF16:
      return launch_bwd_c<__nv_bfloat16>(x, sf, dy, dx, pf, df, cnt, rows, D, lanes, chunks,
                                         grid, eps, st);
    default: return cudaErrorInvalidValue;
  }
}

// The previous K3b (rmsnorm_bwd_rows + rmsnorm_bwd_dscale), kept only for
// tools/k3b_variants.py and chip_smoke.py to time beside rmsnorm_bwd; the
// port never calls it.  dtype: x / dy / dx; scale, partial (grid, D) and
// dscale (D,) f32; warps a block and grid as rmsnorm.previous_bwd sizes
// them.  Two kernels on ``stream``.
extern "C" int rmsnorm_bwd_v1(const void* x, const void* scale, const void* dy, void* dx,
                              void* partial, void* dscale, int dtype, int rows, int D,
                              int warps, int grid, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int esize = dtype == kF32 ? 4 : 2;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(scale) |
                         reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(dx);
  if (rows < 1 || D < 1 || warps < 1 || 32 * warps > kMaxThreads || grid < 1 ||
      (D * esize) % 16 || addr % 16)
    return cudaErrorInvalidValue;
  const float* sf = static_cast<const float*>(scale);
  float *pf = static_cast<float*>(partial), *df = static_cast<float*>(dscale);
  switch (dtype) {
    case kF32: return launch_bwd_v1<float>(x, sf, dy, dx, pf, df, rows, D, warps, grid, eps, st);
    case kBF16:
      return launch_bwd_v1<__nv_bfloat16>(x, sf, dy, dx, pf, df, rows, D, warps, grid, eps, st);
    default: return cudaErrorInvalidValue;
  }
}

// dtype: x / out; scale f32.  lanes (L), threads and chunks from norm_plan: L a
// power of two, a divisor of threads when L <= 32 and equal to it above (one
// row a block), threads whole warps; L x chunks x 16 bytes covers a row.
extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* out, int dtype, int rows,
                           int D, int lanes, int threads, int chunks, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int esize = dtype == kF32 ? 4 : 2;
  if (rows < 1 || D < 1 || lanes < 1 || (lanes & (lanes - 1)) || threads % 32 ||
      threads > kMaxThreads || (lanes <= 32 ? threads % lanes : threads != lanes) ||
      static_cast<long long>(lanes) * chunks * (16 / esize) < D)
    return cudaErrorInvalidValue;
  const float* sf = static_cast<const float*>(scale);
  switch (dtype) {
    case kF32: return launch_t<float>(x, sf, out, rows, D, lanes, threads, chunks, eps, st);
    case kBF16:
      return launch_t<__nv_bfloat16>(x, sf, out, rows, D, lanes, threads, chunks, eps, st);
    default: return cudaErrorInvalidValue;
  }
}

// The card's fixed cost of one launch: an empty kernel of one block, launched
// through the same ctypes route (chip_smoke.py times it beside K3).
extern "C" int launch_floor(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}
