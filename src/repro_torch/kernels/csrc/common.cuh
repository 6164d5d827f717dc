// Shared pieces of the port's CUDA kernels: dtype codes, f32 load/store of
// the element types, and the error-string export every library carries.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// dtype codes passed by the Python wrappers (_build.DTYPE_CODES)
enum ReproDtype : int { kF32 = 0, kBF16 = 1 };

// Large finite "minus infinity", as in the JAX package: (-1e30) - (-1e30)
// is 0, not NaN, for rows whose scores are all masked.
#define REPRO_NEG_INF (-1e30f)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Lets the kernel take ``bytes`` of dynamic shared memory (above 48 KB a
// launch is refused otherwise), once per kernel instance and device.
template <auto Kernel>
cudaError_t allow_smem(int bytes) {
  constexpr int kMaxDevices = 64;
  static int allowed[kMaxDevices] = {};  // the largest size set so far, per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && allowed[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = bytes;
  return err;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
