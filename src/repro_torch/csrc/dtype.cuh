// Element types shared by the port's kernels: f32 and bf16 loads widened
// to f32, f32 results rounded back to the element type (to nearest
// even, as jnp's astype), and -inf for masked scores.
#pragma once

#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float neg_inf() {
  return -__int_as_float(0x7f800000);
}

}  // namespace
