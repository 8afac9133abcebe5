// Fused RMSNorm, plain (K4a) and with the residual add (K4b),
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels src/repro/kernels/rmsnorm.py::rmsnorm
// (`_rmsnorm_kernel`, pallas_call at :45) and ::rmsnorm_residual
// (`_rmsnorm_residual_kernel`, pallas_call at :72), with their
// contract, row by row over x (R, D):
//   K4a: y = (x_f32 * rsqrt(mean(x_f32^2) + eps) * w_f32) cast to x's type
//   K4b: s = x_f32 + r_f32; res = s cast to x's type;
//        y = (s * rsqrt(mean(s^2) + eps) * w_f32) cast to x's type
// x, r and the outputs are f32 or bf16 (one type); w is f32 or bf16.
//
// What bounds it on an H100: bytes. K4a reads x once and writes y once
// (4 B per element in bf16 plus the weight), K4b reads x and r and
// writes y and res (8 B per element in bf16); a handful of f32
// operations per element is far below the card's compute rate. At a
// decode step's one row the bound is ~0.01 us and the time is latency:
// one load, one reduction, one store.
//
// What the design does about it: the vector body. A row is reduced by a
// group of G threads; thread g of a group holds the row's 16-byte
// vectors g, g + G, ..., at most VPT of them (a template argument;
// predicated where the row ends), as f32 in registers (s for K4b), with
// the weight's vectors beside them. Every load of a row (x, r and w) is
// issued before the reduction, so no load waits on it, and nothing goes
// through shared memory but one partial sum a warp. The geometry comes
// from the wrapper's shape class (`_plan` in kernels/rmsnorm.py):
// narrow rows (at most 32 vectors, e.g. a 128-wide q/k-norm) take G <= 32
// and several rows a warp, reduced by shuffles inside the group only;
// wide rows take G a multiple of 32, the warps' partials exchanged once
// through shared memory; a decode step's few rows take one vector a
// thread. Blocks walk their rows with a grid-stride loop, so a grid
// smaller than the rows keeps the weight in registers across rows.
//
// The general body takes what the vector body cannot: D not a multiple
// of the vector's elements, or a pointer not 16-byte aligned (a
// contiguous view at an odd offset). It is the first port's kernel: one
// block a row, scalar loads, the row's f32 values in shared memory.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dtype.cuh"
#include "vec.cuh"

namespace {

constexpr int kMaxD = 8192;

// the most threads a block of the vector body may have with VPT vectors a
// thread (its __launch_bounds__; the wrapper's `max_threads`)
__host__ __device__ constexpr int max_threads(int vpt) {
  return vpt <= 2 ? 1024 : (vpt <= 4 ? 512 : 256);
}

template <typename T, typename TW, int VPT, bool RESIDUAL>
__global__ void __launch_bounds__(max_threads(VPT))
    rmsnorm_vector_kernel(const T* __restrict__ x, const T* __restrict__ r,
                          const TW* __restrict__ w, T* __restrict__ y,
                          T* __restrict__ res, int R, int D, int G,
                          float eps) {
  constexpr int V = 16 / sizeof(T);  // elements a vector
  __shared__ float red[2][32];       // a partial a warp, two rows' worth
  const int nv = D / V;
  const int g = threadIdx.x % G;                // place in the row's group
  const int rows_per_block = blockDim.x / G;
  const int row_in_block = threadIdx.x / G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  bool on[VPT];
  Pack<TW, V> wv[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    on[i] = g + i * G < nv;
    if (on[i]) wv[i].load(w + static_cast<size_t>(g + i * G) * V);
  }

  int buf = 0;
  for (int base = blockIdx.x * rows_per_block; base < R;
       base += gridDim.x * rows_per_block, buf ^= 1) {
    const int row = base + row_in_block;
    const bool live = row < R;
    const size_t off = static_cast<size_t>(live ? row : 0) * D;
    float v[VPT][V];
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      if (live && on[i]) {
        const size_t e = off + static_cast<size_t>(g + i * G) * V;
        Pack<T, V> xv;
        xv.load(x + e);
        if constexpr (RESIDUAL) {
          Pack<T, V> rv;
          rv.load(r + e);
#pragma unroll
          for (int j = 0; j < V; ++j) v[i][j] = xv.get(j) + rv.get(j);
          store_vec<T>(res + e, v[i]);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) v[i][j] = xv.get(j);
        }
#pragma unroll
        for (int j = 0; j < V; ++j) ss += v[i][j] * v[i][j];
      }
    }
    // the row's sum: shuffles inside a group of G <= 32 lanes, or inside
    // each warp and then once across the row's G / 32 warps
    float total;
    if (G <= 32) {
      for (int o = G >> 1; o > 0; o >>= 1)
        ss += __shfl_xor_sync(0xffffffffu, ss, o);
      total = ss;
    } else {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        ss += __shfl_xor_sync(0xffffffffu, ss, o);
      if (lane == 0) red[buf][warp] = ss;
      __syncthreads();
      const int wpr = G >> 5, first = row_in_block * wpr;
      total = lane < wpr ? red[buf][first + lane] : 0.f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        total += __shfl_xor_sync(0xffffffffu, total, o);
    }
    const float inv = rsqrtf(total / static_cast<float>(D) + eps);
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      if (live && on[i]) {
        float o[V];
#pragma unroll
        for (int j = 0; j < V; ++j) o[j] = v[i][j] * inv * wv[i].get(j);
        store_vec<T>(y + off + static_cast<size_t>(g + i * G) * V, o);
      }
    }
  }
}

// ------------------------------------------------------ the general body
// sum over the block; every thread gets the total
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = (blockDim.x + 31) >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < n_warps; ++w) t += red[w];
  return t;
}

template <typename T, typename TW, bool RESIDUAL>
__global__ void rmsnorm_scalar_kernel(const T* __restrict__ x,
                                      const T* __restrict__ r,
                                      const TW* __restrict__ w,
                                      T* __restrict__ y, T* __restrict__ res,
                                      int D, float eps) {
  extern __shared__ float row[];  // D floats
  __shared__ float red[32];
  const size_t base = static_cast<size_t>(blockIdx.x) * D;
  float ss = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    float v = to_f32(x[base + i]);
    if (RESIDUAL) {
      v += to_f32(r[base + i]);
      res[base + i] = from_f32<T>(v);
    }
    row[i] = v;
    ss += v * v;
  }
  const float total = block_sum(ss, red);
  const float inv = rsqrtf(total / static_cast<float>(D) + eps);
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    y[base + i] = from_f32<T>(row[i] * inv * to_f32(w[i]));
  }
}

// ------------------------------------------------------------- launches
struct Geometry {
  int vpt, G, rows_per_block, grid;
};

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T, typename TW, int VPT>
cudaError_t launch_vector(const void* x, const void* r, const void* w,
                          void* y, void* res, int R, int D, float eps,
                          const Geometry& g, cudaStream_t s) {
  const int threads = g.G * g.rows_per_block;
  if (threads > max_threads(VPT)) return cudaErrorInvalidValue;
  if (r == nullptr) {
    rmsnorm_vector_kernel<T, TW, VPT, false><<<g.grid, threads, 0, s>>>(
        static_cast<const T*>(x), nullptr, static_cast<const TW*>(w),
        static_cast<T*>(y), nullptr, R, D, g.G, eps);
  } else {
    rmsnorm_vector_kernel<T, TW, VPT, true><<<g.grid, threads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(r),
        static_cast<const TW*>(w), static_cast<T*>(y), static_cast<T*>(res),
        R, D, g.G, eps);
  }
  return cudaGetLastError();
}

template <typename T, typename TW>
cudaError_t launch(const void* x, const void* r, const void* w, void* y,
                   void* res, int R, int D, float eps, const Geometry& g,
                   cudaStream_t s) {
  if (g.vpt == 0) {  // the general body: one block a row
    if (g.rows_per_block != 1 || g.grid != R || g.G < 32 || g.G > 1024 ||
        g.G % 32 != 0)
      return cudaErrorInvalidValue;
    const size_t smem = sizeof(float) * D;
    if (r == nullptr) {
      rmsnorm_scalar_kernel<T, TW, false><<<R, g.G, smem, s>>>(
          static_cast<const T*>(x), nullptr, static_cast<const TW*>(w),
          static_cast<T*>(y), nullptr, D, eps);
    } else {
      rmsnorm_scalar_kernel<T, TW, true><<<R, g.G, smem, s>>>(
          static_cast<const T*>(x), static_cast<const T*>(r),
          static_cast<const TW*>(w), static_cast<T*>(y),
          static_cast<T*>(res), D, eps);
    }
    return cudaGetLastError();
  }
  // the vector body: whole vectors, aligned pointers, a group that
  // covers the row and reduces as the kernel assumes
  constexpr int V = 16 / sizeof(T);
  const bool group_ok = g.G <= 32 ? (g.G & (g.G - 1)) == 0
                                  : g.G % 32 == 0 && g.G <= 1024;
  if (D % V != 0 || !group_ok || g.rows_per_block < 1 || g.grid < 1 ||
      (g.G * g.rows_per_block) % 32 != 0 ||
      static_cast<long>(g.G) * g.vpt * V < D)
    return cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(w) || !aligned16(y) ||
      (r != nullptr && (!aligned16(r) || !aligned16(res))))
    return cudaErrorMisalignedAddress;
  switch (g.vpt) {
    case 1: return launch_vector<T, TW, 1>(x, r, w, y, res, R, D, eps, g, s);
    case 2: return launch_vector<T, TW, 2>(x, r, w, y, res, R, D, eps, g, s);
    case 3: return launch_vector<T, TW, 3>(x, r, w, y, res, R, D, eps, g, s);
    case 4: return launch_vector<T, TW, 4>(x, r, w, y, res, R, D, eps, g, s);
    case 6: return launch_vector<T, TW, 6>(x, r, w, y, res, R, D, eps, g, s);
    case 8: return launch_vector<T, TW, 8>(x, r, w, y, res, R, D, eps, g, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. r == NULL selects K4a (res is
// then unused), otherwise K4b. The geometry is the wrapper's plan:
// vpt = 0 selects the general body (G threads a block, one block a row:
// rows_per_block 1, grid R); vpt in {1, 2, 3, 4, 6, 8} the vector body
// with G threads a row, rows_per_block rows a block and grid blocks.
// The integers come as pointer-sized words: the wrapper's ctypes binding
// converts those about twice as fast as C ints, and a decode step makes
// ~140 of these calls a token. Returns the launch's cudaError_t
// (cudaErrorInvalidValue for a shape or geometry the bodies do not take,
// cudaErrorMisalignedAddress for a pointer the vector body cannot load);
// nothing is launched then.
extern "C" int rmsnorm(const void* x, const void* r, const void* w, void* y,
                       void* res, intptr_t R, intptr_t D, intptr_t x_dtype,
                       intptr_t w_dtype, intptr_t vpt, intptr_t G,
                       intptr_t rows_per_block, intptr_t grid, float eps,
                       void* stream) {
  if (R < 1 || R > INT32_MAX || D < 1 || D > kMaxD || G < 1 || G > 1024 ||
      rows_per_block < 1 || rows_per_block > 1024 || grid < 1 ||
      grid > INT32_MAX || vpt < 0 || vpt > 8)
    return cudaErrorInvalidValue;
  const Geometry g{static_cast<int>(vpt), static_cast<int>(G),
                   static_cast<int>(rows_per_block), static_cast<int>(grid)};
  const int rows = static_cast<int>(R), d = static_cast<int>(D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && w_dtype == 0)
    return launch<float, float>(x, r, w, y, res, rows, d, eps, g, s);
  if (x_dtype == 0 && w_dtype == 1)
    return launch<float, __nv_bfloat16>(x, r, w, y, res, rows, d, eps, g, s);
  if (x_dtype == 1 && w_dtype == 0)
    return launch<__nv_bfloat16, float>(x, r, w, y, res, rows, d, eps, g, s);
  if (x_dtype == 1 && w_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, r, w, y, res, rows, d,
                                                 eps, g, s);
  return cudaErrorInvalidValue;
}
