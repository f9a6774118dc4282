// Shared device helpers for the repro_torch kernels: element-type
// conversions (float and bf16), warp reductions, and a launch helper that
// lifts the dynamic shared-memory limit once per kernel instantiation.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rt {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
// round to nearest even, like XLA's f32 -> bf16 convert
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// the model-dtype rounding barrier: f32 -> T -> f32
template <typename T> __device__ __forceinline__ float round_t(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// (value, index) argmax step with jnp.argmax's tie-break: a strictly larger
// value wins; among equal values the lower index wins
__device__ __forceinline__ void arg_better(float& bv, int& bi, float v, int i) {
  if (v > bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

__device__ __forceinline__ void warp_argmax(float& bv, int& bi) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    float v = __shfl_xor_sync(0xffffffffu, bv, o);
    int i = __shfl_xor_sync(0xffffffffu, bi, o);
    arg_better(bv, bi, v, i);
  }
}

// Kernels that take more than 48 KB of dynamic shared memory must opt in;
// returns the error of that call (cudaSuccess when nothing was needed).
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace rt
