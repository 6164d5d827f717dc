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

#include "common.cuh"

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
// jax.grad of that function.  What bounds it: it reads x and dy and writes
// dx once (smollm-360m's (8192, 960) bf16: 47 MB, 0.014 ms at 3.35 TB/s).
//
// One warp takes one row at a time (rows warp-strided over the grid); a
// lane walks the row's 16-byte chunks lane, lane + 32, ... twice: once for
// the two sums (sum x^2, sum g x; a butterfly of shuffles joins the warp's
// lanes), once, from L1, for dx.  dscale's partial for the lane's columns
// accumulates in the warp's own row of shared memory across every row the
// warp takes, then the block sums its warps' rows in a fixed order into
// one partial row, and rmsnorm_bwd_dscale sums the blocks' partials column
// by column.  No atomics: equal inputs give equal results bit for bit.
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
cudaError_t launch_bwd(const void* x, const float* scale, const void* dy, void* dx,
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

// dtype: x / dy / dx; scale, partial (grid, D) and dscale (D,) f32.  warps
// and grid from bwd_plan (kernels/rmsnorm.py); D * sizeof(T) a multiple of
// 16 and every pointer 16-byte aligned.  Two kernels on ``stream``.
extern "C" int rmsnorm_bwd(const void* x, const void* scale, const void* dy, void* dx,
                           void* partial, void* dscale, int dtype, int rows, int D, int warps,
                           int grid, float eps, void* stream) {
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
    case kF32: return launch_bwd<float>(x, sf, dy, dx, pf, df, rows, D, warps, grid, eps, st);
    case kBF16:
      return launch_bwd<__nv_bfloat16>(x, sf, dy, dx, pf, df, rows, D, warps, grid, eps, st);
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
