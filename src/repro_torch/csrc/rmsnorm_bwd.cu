// The gradient of the fused RMSNorm, plain (K4a) and with the residual
// add (K4b), hand-written for Hopper (sm_90a).
//
// Replaces what `jax.grad` derives from the JAX model's norm,
// src/repro/models/layers.py::rms_norm (:70): the JAX package has no
// backward Pallas kernel. Contract, row by row over x (R, D), with the
// forward of rmsnorm.cu (s = x, or s = x + r for K4b, in f32; rs =
// rsqrt(mean(s^2) + eps); y = s * rs * w, cast once), g the gradient of y
// and, for K4b, gr the gradient of the new residual (s cast):
//   ds = rs * (g w - s rs^2 mean(g w s)) (+ gr)      -> dx (= dr), cast once
//   dw = sum over rows of g s rs                     -> cast once to w's type
// all in f32.
//
// What bounds it on an H100: bytes (x, r, g, gr read, dx written, a few
// f32 operations an element).
//
// What the design does about it: a group of G threads a row (G = 32, a
// warp, for rows of up to 1,024 elements, several rows a block; G = the
// block's 256 threads for wider rows), each thread holding the row's
// elements lane, lane + G, ... (at most NPT, a template argument) in
// registers from one coalesced pass, so a row is read once. Blocks walk
// the rows with a grid stride, each thread keeping its columns' share of
// dw in registers across rows. dw is deterministic without atomics: each
// block sums its groups' shares in a fixed order into one partial row of
// a (blocks, D) f32 scratch, and a second launch sums the partials
// column by column in block order and casts once.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dtype.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxD = 8192;
constexpr int kWarpRowMaxD = 1024;  // widest row a warp takes

template <typename X, typename W, int NPT>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_kernel(const X* __restrict__ x, const X* __restrict__ r,
                   const W* __restrict__ w, const X* __restrict__ g,
                   const X* __restrict__ gr, X* __restrict__ dx,
                   float* __restrict__ partial, int R, int D, int G,
                   float eps) {
  extern __shared__ float red[];  // (rows a block) x D, or 2 x warps
  const int lane = threadIdx.x % G, grp = threadIdx.x / G;
  const int rows_per_block = kThreads / G;
  float wv[NPT], dw[NPT];
#pragma unroll
  for (int k = 0; k < NPT; ++k) {
    const int c = lane + k * G;
    wv[k] = c < D ? to_f32(w[c]) : 0.f;
    dw[k] = 0.f;
  }
  for (int row = blockIdx.x * rows_per_block + grp; row < R;
       row += gridDim.x * rows_per_block) {
    const size_t base = static_cast<size_t>(row) * D;
    float s[NPT], gv[NPT];
    float ss = 0.f, gws = 0.f;
#pragma unroll
    for (int k = 0; k < NPT; ++k) {
      const int c = lane + k * G;
      s[k] = gv[k] = 0.f;
      if (c < D) {
        s[k] = to_f32(x[base + c]);
        if (r != nullptr) s[k] += to_f32(r[base + c]);
        gv[k] = to_f32(g[base + c]);
      }
      ss += s[k] * s[k];
      gws += gv[k] * wv[k] * s[k];
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, m);
      gws += __shfl_xor_sync(0xffffffffu, gws, m);
    }
    if (G > 32) {
      // the block is one row: the warps' sums through shared memory
      const int warp = threadIdx.x / 32, n_warps = kThreads / 32;
      __syncthreads();  // the previous row's sums are read
      if (threadIdx.x % 32 == 0) {
        red[warp] = ss;
        red[n_warps + warp] = gws;
      }
      __syncthreads();
      ss = gws = 0.f;
      for (int i = 0; i < n_warps; ++i) {
        ss += red[i];
        gws += red[n_warps + i];
      }
    }
    // as the forward: the mean a division by D
    const float rs = rsqrtf(ss / static_cast<float>(D) + eps);
    const float c_mean = gws / static_cast<float>(D);
#pragma unroll
    for (int k = 0; k < NPT; ++k) {
      const int c = lane + k * G;
      if (c >= D) continue;
      float d = rs * (gv[k] * wv[k] - s[k] * rs * rs * c_mean);
      if (gr != nullptr) d += to_f32(gr[base + c]);
      dx[base + c] = from_f32<X>(d);
      dw[k] += gv[k] * s[k] * rs;
    }
  }
  // the block's partial dw: its groups' shares summed in group order
  __syncthreads();
  if (rows_per_block == 1) {
#pragma unroll
    for (int k = 0; k < NPT; ++k) {
      const int c = lane + k * G;
      if (c < D) partial[static_cast<size_t>(blockIdx.x) * D + c] = dw[k];
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < NPT; ++k) {
    const int c = lane + k * G;
    if (c < D) red[grp * D + c] = dw[k];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += kThreads) {
    float acc = 0.f;
    for (int i = 0; i < rows_per_block; ++i) acc += red[i * D + c];
    partial[static_cast<size_t>(blockIdx.x) * D + c] = acc;
  }
}

// dw[c] = sum over the parts of partial[part, c], in part order
template <typename W>
__global__ void __launch_bounds__(kThreads)
dw_kernel(const float* __restrict__ partial, W* __restrict__ dw, int parts,
          int D) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= D) return;
  float acc = 0.f;
  for (int i = 0; i < parts; ++i) acc += partial[static_cast<size_t>(i) * D + c];
  dw[c] = from_f32<W>(acc);
}

template <typename X, typename W, int NPT>
cudaError_t launch_npt(const void* x, const void* r, const void* w,
                       const void* g, const void* gr, void* dx, void* dw,
                       float* partial, int R, int D, int G, int grid,
                       float eps, cudaStream_t s) {
  const int rows_per_block = kThreads / G;
  const size_t smem = rows_per_block == 1
                          ? sizeof(float) * 2 * (kThreads / 32)
                          : sizeof(float) * rows_per_block * D;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rmsnorm_bwd_kernel<X, W, NPT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  rmsnorm_bwd_kernel<X, W, NPT><<<grid, kThreads, smem, s>>>(
      static_cast<const X*>(x), static_cast<const X*>(r),
      static_cast<const W*>(w), static_cast<const X*>(g),
      static_cast<const X*>(gr), static_cast<X*>(dx), partial, R, D, G, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dw_kernel<W><<<(D + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      partial, static_cast<W*>(dw), grid, D);
  return cudaGetLastError();
}

template <typename X, typename W>
cudaError_t launch(const void* x, const void* r, const void* w, const void* g,
                   const void* gr, void* dx, void* dw, float* partial, int R,
                   int D, int G, int grid, float eps, cudaStream_t s) {
  const int npt = (D + G - 1) / G;
  if (npt <= 4)
    return launch_npt<X, W, 4>(x, r, w, g, gr, dx, dw, partial, R, D, G,
                               grid, eps, s);
  if (npt <= 8)
    return launch_npt<X, W, 8>(x, r, w, g, gr, dx, dw, partial, R, D, G,
                               grid, eps, s);
  if (npt <= 16)
    return launch_npt<X, W, 16>(x, r, w, g, gr, dx, dw, partial, R, D, G,
                                grid, eps, s);
  if (npt <= 32)
    return launch_npt<X, W, 32>(x, r, w, g, gr, dx, dw, partial, R, D, G,
                                grid, eps, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// x, r (null for K4a), g, gr (null when the residual's gradient is
// absent) and dx (R, D) of x_dtype; w and dw (D,) of w_dtype (0 =
// float32, 1 = bfloat16); partial a (grid, D) f32 scratch. G threads a
// row: 32 for D <= 1024, else 256 (the wrapper's `bwd_plan`); grid
// blocks. Two launches on `stream`; returns the first failing launch's
// cudaError_t.
extern "C" int rmsnorm_backward(const void* x, const void* r, const void* w,
                                const void* g, const void* gr, void* dx,
                                void* dw, float* partial, intptr_t R,
                                intptr_t D, intptr_t x_dtype,
                                intptr_t w_dtype, intptr_t G, intptr_t grid,
                                float eps, void* stream) {
  if (R < 1 || R > INT32_MAX || D < 1 || D > kMaxD || grid < 1 ||
      grid > INT32_MAX || !((G == 32 && D <= kWarpRowMaxD) || G == kThreads))
    return cudaErrorInvalidValue;
  const int rows = static_cast<int>(R), d = static_cast<int>(D);
  const int gg = static_cast<int>(G), n = static_cast<int>(grid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && w_dtype == 0)
    return launch<float, float>(x, r, w, g, gr, dx, dw, partial, rows, d, gg,
                                n, eps, s);
  if (x_dtype == 0 && w_dtype == 1)
    return launch<float, __nv_bfloat16>(x, r, w, g, gr, dx, dw, partial, rows,
                                        d, gg, n, eps, s);
  if (x_dtype == 1 && w_dtype == 0)
    return launch<__nv_bfloat16, float>(x, r, w, g, gr, dx, dw, partial, rows,
                                        d, gg, n, eps, s);
  if (x_dtype == 1 && w_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, r, w, g, gr, dx, dw,
                                                partial, rows, d, gg, n, eps,
                                                s);
  return cudaErrorInvalidValue;
}
