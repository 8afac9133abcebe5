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
// operations per element is far below the card's compute rate.
// What the design does about it: one block per row. Each thread walks
// the row with a block-stride loop (neighbouring threads on
// neighbouring addresses), keeps the f32 value (s for K4b) in shared
// memory and its partial sum of squares in a register. The partials are
// reduced by warp shuffles and then across warps through shared memory;
// each thread then reads back its own values from shared memory, so x
// and r are read from device memory exactly once. D <= 8192 keeps the
// row (<= 32 KB of f32) inside the default 48 KB of dynamic shared
// memory. Vector (16 B) loads and several rows per block for short
// rows are later work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dtype.cuh"

namespace {

constexpr int kMaxD = 8192;

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
__global__ void rmsnorm_kernel(const T* __restrict__ x,
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

template <typename T, typename TW>
cudaError_t launch(const void* x, const void* r, const void* w, void* y,
                   void* res, int R, int D, float eps, cudaStream_t s) {
  int threads = ((D / 4 + 31) / 32) * 32;  // ~4 elements a thread
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  const size_t smem = sizeof(float) * D;
  if (r == nullptr) {
    rmsnorm_kernel<T, TW, false><<<R, threads, smem, s>>>(
        static_cast<const T*>(x), nullptr, static_cast<const TW*>(w),
        static_cast<T*>(y), nullptr, D, eps);
  } else {
    rmsnorm_kernel<T, TW, true><<<R, threads, smem, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(r),
        static_cast<const TW*>(w), static_cast<T*>(y), static_cast<T*>(res),
        D, eps);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. r == NULL selects K4a (res is
// then unused), otherwise K4b. Returns the launch's cudaError_t.
extern "C" int rmsnorm(int x_dtype, int w_dtype, const void* x,
                       const void* r, const void* w, void* y, void* res,
                       int R, int D, float eps, void* stream) {
  if (R < 1 || D < 1 || D > kMaxD) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && w_dtype == 0)
    return launch<float, float>(x, r, w, y, res, R, D, eps, s);
  if (x_dtype == 0 && w_dtype == 1)
    return launch<float, __nv_bfloat16>(x, r, w, y, res, R, D, eps, s);
  if (x_dtype == 1 && w_dtype == 0)
    return launch<__nv_bfloat16, float>(x, r, w, y, res, R, D, eps, s);
  if (x_dtype == 1 && w_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, r, w, y, res, R, D, eps,
                                                 s);
  return cudaErrorInvalidValue;
}
