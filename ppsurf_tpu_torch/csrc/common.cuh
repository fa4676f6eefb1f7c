// Shared helpers of the port's CUDA kernels (sm_90a, plain C interface).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ppsurf {

// Storage type <-> f32. Every product accumulates in f32; a value rounds
// to the storage type exactly where the plain PyTorch version rounds it.
template <typename T> struct Num;

template <> struct Num<float> {
  static __device__ __forceinline__ float to_f(float x) { return x; }
  static __device__ __forceinline__ float from_f(float x) { return x; }
};

template <> struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float x) {
    return __float2bfloat16_rn(x);
  }
};

template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return Num<T>::to_f(Num<T>::from_f(x));
}

}  // namespace ppsurf
