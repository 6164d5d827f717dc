// PTX building blocks shared by the port's tensor-core kernels: cp.async
// (16 bytes, zero-fill), ldmatrix, and mma.sync m16n8k16 bf16 -> f32.
//
// Fragment maps of mma.sync.m16n8k16 (PTX ISA, "Matrix fragments for
// mma.m16n8k16"), lane = 4 * gr + tq:
//   A (16 x 16, row-major), 4 registers of 2 bf16: a0 = A[gr][2tq, 2tq+1],
//     a1 = A[gr+8][2tq..], a2 = A[gr][2tq+8..], a3 = A[gr+8][2tq+8..]
//   B (16 x 8, k x n), 2 registers: b0 = B[2tq, 2tq+1][gr], b1 = B[2tq+8..][gr]
//   C (16 x 8 f32): c0, c1 = C[gr][2tq, 2tq+1], c2, c3 = C[gr+8][2tq, 2tq+1]
// ldmatrix.x4 reads four 8 x 8 b16 matrices whose row addresses come from
// lanes 0-7, 8-15, 16-23, 24-31; lane l receives row l / 4, columns
// 2 (l % 4) and +1 of each (with .trans: column l / 4, rows 2 (l % 4), +1).
#pragma once

#include <cstdint>

#include "common.cuh"

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; ok == false writes zeros and reads nothing
// (src-size 0), so a ragged tail never reads past the end of a tensor
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most N of this thread's committed groups are in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (16 x 8 f32) += a (16 x 16 bf16) * b (16 x 8 bf16)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 and packed (lo in the low half, which mma
// reads as the lower column); *sum gets the rounded values
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi, float* sum) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  const float2 r = __bfloat1622float2(t);
  *sum += r.x + r.y;
  return *reinterpret_cast<uint32_t*>(&t);
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Runs use(i, frag) for i < N, where frag = the fragment load(i, frag)
// fetched kFetch - 1 steps earlier: an ldmatrix's result is not consumed by
// the mma that follows it in program order, so its latency hides behind
// the mmas in between.  Fully unrolled, so the ring indices are constants.
constexpr int kFetch = 4;

template <int N, typename Load, typename Use>
__device__ __forceinline__ void pipelined(Load load, Use use) {
  uint32_t ring[kFetch][4];
#pragma unroll
  for (int i = 0; i < kFetch - 1 && i < N; ++i) load(i, ring[i]);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i + kFetch - 1 < N) load(i + kFetch - 1, ring[(i + kFetch - 1) % kFetch]);
    use(i, ring[i % kFetch]);
  }
}
