// 16-byte vectors of the port's row kernels (the RMSNorm forward and
// backward): a Pack of N elements loaded as raw 32-bit words and read
// back as f32, and a vector of f32 values rounded once and stored.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>

namespace {

// N elements of E loaded as raw 32-bit words (N * sizeof(E) is 8, 16 or
// 32 bytes, from an address aligned to it or to 16), read back as f32
template <typename E, int N>
struct Pack {
  static constexpr int W = N * static_cast<int>(sizeof(E)) / 4;
  uint32_t u[W];

  __device__ __forceinline__ void load(const E* p) {
    if constexpr (W == 2) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      u[0] = v.x;
      u[1] = v.y;
    } else {
#pragma unroll
      for (int i = 0; i < W / 4; ++i) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + i);
        u[4 * i] = v.x;
        u[4 * i + 1] = v.y;
        u[4 * i + 2] = v.z;
        u[4 * i + 3] = v.w;
      }
    }
  }

  // element i as f32 (a bf16 is the upper half of its f32: exact)
  __device__ __forceinline__ float get(int i) const {
    if constexpr (sizeof(E) == 4) {
      return __uint_as_float(u[i]);
    } else {
      const uint32_t w = u[i >> 1];
      return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
    }
  }
};

__device__ __forceinline__ uint32_t bits_of(float a) {
  return __float_as_uint(a);
}
__device__ __forceinline__ uint32_t bf16_pair(float a, float b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(a))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(b)))
          << 16);
}

// one 16-byte vector of T from its f32 values, rounded once
template <typename T>
__device__ __forceinline__ void store_vec(T* p,
                                          const float (&v)[16 / sizeof(T)]) {
  uint4 o;
  if constexpr (sizeof(T) == 4) {
    o = make_uint4(bits_of(v[0]), bits_of(v[1]), bits_of(v[2]),
                   bits_of(v[3]));
  } else {
    o = make_uint4(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]),
                   bf16_pair(v[4], v[5]), bf16_pair(v[6], v[7]));
  }
  *reinterpret_cast<uint4*>(p) = o;
}

}  // namespace
