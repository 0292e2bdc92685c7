// Shared helpers of the port's hand-written Hopper kernels: dtype
// conversion through the bf16 intrinsics, warp reductions, and the
// finite "-inf" every kernel masks with.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tmt {

// finite "-inf" (the JAX package's NEG_INF): exp() of a masked score
// minus a finite row max is exactly 0, never NaN
constexpr float kNegInf = -1e30f;

// dtype codes shared with the Python wrappers
enum DtypeCode : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

}  // namespace tmt

extern "C" const char* tm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
