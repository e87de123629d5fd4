// Shared helpers of the convexadam_torch CUDA kernels.
//
// Every kernel computes in float32 and rounds each intermediate to its
// storage type T with Io<T>::rnd, so a bfloat16 kernel follows PyTorch's
// per-operation bfloat16 rounding (each op on bf16 tensors computes in float
// and rounds its result).  Arithmetic that must agree with the plain PyTorch
// version goes through the __f*_rn intrinsics, which nvcc never contracts
// into a fused multiply-add.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float ld(const float* p) { return *p; }
  static __device__ __forceinline__ float rnd(float v) { return v; }
  static __device__ __forceinline__ void st(float* p, float v) { *p = v; }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float ld(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ float rnd(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Devices whose shared-memory grants a launch site keeps (its `granted`
// array, one entry a device, indexed by cudaGetDevice).
constexpr int MAX_DEVICES = 64;

// Raise the kernel's dynamic shared-memory limit on the current device the
// first time a launch needs more than the default 48 KB, and only then.
template <typename Kern>
int ensure_smem(Kern kernel, size_t bytes, int* granted) {
  if (bytes <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if ((int)bytes <= granted[dev]) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) granted[dev] = (int)bytes;
  return (int)err;
}
