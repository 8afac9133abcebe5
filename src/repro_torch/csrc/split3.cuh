// The three-part bf16 split of f32 values shared by K5's tensor-core
// bodies (ssd_chunk.cu, ssd_chunk_bwd.cu): an f32 operand of a bf16
// wgmma is carried as hi + mid + lo, each part rounded to nearest, and
// each part is one pass of the product.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>

#include "wgmma.cuh"

namespace {

// w split into three bf16 parts, each rounded to nearest: hi = bf16(w),
// mid = bf16(w - hi), lo = bf16(w - hi - mid); both differences are
// exact in f32, so hi + mid + lo carries about 24 bits of w (the lo
// part is rounded when it is packed)
__device__ __forceinline__ void split3(float w, float& hi, float& mid,
                                       float& lo) {
  hi = __bfloat162float(__float2bfloat16_rn(w));
  const float r = w - hi;
  mid = __bfloat162float(__float2bfloat16_rn(r));
  lo = r - mid;
}

// the three parts of v (in the accumulator layout: v[4 i + 0, 1] row m0,
// columns 8 i + 2 t4 + {0, 1}; v[4 i + 2, 3] row m0 + 8) as register A
// fragments a[part][k-step][4], part 0 hi, 1 mid, 2 lo: the columns
// 16 kj .. 16 kj + 15 are k-step kj (as K2 turns its scores into p)
__device__ __forceinline__ void split_fragments(const float* v,
                                                uint32_t (*a)[4][4]) {
#pragma unroll
  for (int kj = 0; kj < 4; ++kj) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float h0, m0, l0, h1, m1, l1;
      split3(v[8 * kj + 2 * q], h0, m0, l0);
      split3(v[8 * kj + 2 * q + 1], h1, m1, l1);
      a[0][kj][q] = pack_bf16(h0, h1);
      a[1][kj][q] = pack_bf16(m0, m1);
      a[2][kj][q] = pack_bf16(l0, l1);
    }
  }
}

}  // namespace
