// Shared pieces of the port's CUDA kernels: dtype codes, f32 load/store of
// the element types, and the error-string export every library carries.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

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

template <typename T>
struct TypeTag {
  using type = T;
};

// Calls f(TypeTag<T>, std::integral_constant<int, D>) for the element type T
// of ``dtype`` and a head dim D of the attention kernels' instances; another
// pair returns cudaErrorInvalidValue.
template <typename F>
cudaError_t with_instance(int dtype, int D, F f) {
  auto with_d = [&](auto tag) -> cudaError_t {
    switch (D) {
      case 8: return f(tag, std::integral_constant<int, 8>{});
      case 16: return f(tag, std::integral_constant<int, 16>{});
      case 32: return f(tag, std::integral_constant<int, 32>{});
      case 64: return f(tag, std::integral_constant<int, 64>{});
      case 128: return f(tag, std::integral_constant<int, 128>{});
      case 256: return f(tag, std::integral_constant<int, 256>{});
      default: return cudaErrorInvalidValue;
    }
  };
  switch (dtype) {
    case kF32: return with_d(TypeTag<float>{});
    case kBF16: return with_d(TypeTag<__nv_bfloat16>{});
    default: return cudaErrorInvalidValue;
  }
}

// bf16 at D >= 16 runs an attention kernel's tensor-core instance
template <typename T, int D>
constexpr bool kOnTensorCores = std::is_same_v<T, __nv_bfloat16> && D >= 16;

// What the card made of one kernel instance, for a launch of ``threads``
// threads and ``dyn_smem`` bytes of dynamic shared memory: out = registers
// a thread, local (spilled) bytes a thread, static and dynamic shared bytes
// a block, and the blocks an SM holds at once (``_build.INFO_KEYS``).
template <auto Kernel>
cudaError_t kernel_info(int threads, int dyn_smem, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, Kernel);
  if (err == cudaSuccess) err = allow_smem<Kernel>(dyn_smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, Kernel, threads, dyn_smem);
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = dyn_smem;
  out[4] = blocks;
  return cudaSuccess;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
