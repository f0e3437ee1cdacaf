// Shared helpers of the port's CUDA kernels (built for sm_90a by
// seldon_core_tpu_torch/ops/_build.py, no fast-math).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes passed from Python (ops/_build.py dtype_code)
enum { SCK_F32 = 0, SCK_BF16 = 1 };

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);  // round to nearest even, as torch and XLA
}

// Allow a kernel more than the default 48 KB of dynamic shared memory.
template <typename K>
static cudaError_t sck_allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
