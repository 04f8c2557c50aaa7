// Precision helpers shared by the kernels that have a float64 and a float32
// instance: one template body per kernel, and these overloads pick the
// explicitly rounded operation of the element type, so that no product or
// sum contracts into a fused multiply-add in either instance.

#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double abs_t(double x) { return fabs(x); }
__device__ __forceinline__ float abs_t(float x) { return fabsf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }
__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }

// dynamic shared memory as an array of T: one extern declaration for every
// instance (an `extern __shared__ T x[]` per type would clash)
template <typename T>
__device__ __forceinline__ T* dynamic_smem() {
  extern __shared__ __align__(16) unsigned char repro_torch_smem[];
  return reinterpret_cast<T*>(repro_torch_smem);
}

}  // namespace repro_torch
