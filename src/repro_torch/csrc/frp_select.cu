// FRP candidate selection for ESFF (paper Alg. 3, Eq. 7 and Eq. 10),
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sched_weights.py::frp_select
// (Pallas `_weights_kernel`, pallas_call at :93). The same body also
// serves the engine's own f64 FRP scan, the inline argmin of
// src/repro/core/jax_policies.py (ESFFKernel.on_exec_done, :131-140),
// one lane per thread block.
//
// For every function f of a row:
//   n_e = (n_w + 1) - ((t_l + t_v_j) * K) / t_e              (Eq. 7)
//   w   = t_e + ((beta * (t_l + t_v)) * (K + 1)) / max(n_e, eps)  (Eq. 10)
// masked to n_w > 0, n_e > 0, f != self; the row's result is the
// first index of the minimum (BIG = 1e30 for masked entries) and -1
// when the minimum is BIG, exactly jnp.argmin's first-index rule.
//
// The weight and the first-index reduction live in csrc/frp_select.cuh,
// which csrc/event_loop.cu includes too: the FRP scan that the event loop
// runs inline on every completion is this code. Two contracts share it:
//   f32 (ENGINE = false): the TPU kernel's own. t_e is clamped at 1e-9,
//     eps = 1e-9, beta = 1, one row, scalars by value.
//   f64 (ENGINE = true): the engine's. No clamp on t_e (the running
//     means are positive), eps = 1e-30, beta / t_v_j / self per lane.
// ESFF-H's cold-aware term (jax_policies.py:133-134, n_e -= coldK after
// Eq. 7) is the f64 entry's optional `cold_k` (L, F) i32: null for ESFF,
// which then runs the COLD = false instantiation, the code it always ran.
// The operations run in the reference's order and the library is built
// with --fmad=false, so no multiply-add is contracted and each weight is
// bitwise the plain PyTorch version's.
//
// What bounds it on an H100: it reads about 20 B per function in f32
// (three f32 times + two i32 counts) and about 32 B in f64 (three f64
// times + two i32 counts) and writes one (w, i) pair per row. At the
// main path's F = 200 a row is 6.4 KB: the call is bound by launch
// latency, not by the card. At F = 65,536 the f32 call moves 1.3 MB,
// about 0.4 us at 3.35 TB/s.
// What the design does about it: nothing clever yet. One block per row
// walks the functions with a block-stride loop (neighbouring threads
// read neighbouring addresses), keeps a private (w, i), reduces by warp
// shuffles and then across warps through shared memory, and launches
// once for all lanes of an event step, so the lanes share one launch.
// A single block cannot reach the memory bound at F = 65,536; a
// two-pass multi-block reduction is the next step if that size matters.

#include <cstdint>
#include <cuda_runtime.h>

#include "frp_select.cuh"

namespace {

template <typename T, bool ENGINE, bool COLD>
__global__ void frp_select_kernel(const T* __restrict__ t_e,
                                  const T* __restrict__ t_l,
                                  const T* __restrict__ t_v,
                                  const int32_t* __restrict__ n_w,
                                  const int32_t* __restrict__ k_cnt,
                                  const T* __restrict__ tv_j_lanes,
                                  const int32_t* __restrict__ self_lanes,
                                  const T* __restrict__ beta_lanes,
                                  const int32_t* __restrict__ cold_k,
                                  T tv_j0, int self0, int n_fns,
                                  T* __restrict__ best_w,
                                  int32_t* __restrict__ best_i) {
  const int lane = blockIdx.x;
  const size_t row = static_cast<size_t>(lane) * n_fns;
  const T big = T(1e30);
  const T tv_j = ENGINE ? tv_j_lanes[lane] : tv_j0;
  const int self = ENGINE ? self_lanes[lane] : self0;
  const T beta = ENGINE ? beta_lanes[lane] : T(1);

  T w_min = big;
  int i_min = n_fns;  // beyond every index: loses every tie
  for (int f = threadIdx.x; f < n_fns; f += blockDim.x) {
    const T w = frp::weight<T, ENGINE, COLD>(
        t_e[row + f], t_l[row + f], t_v[row + f],
        static_cast<T>(n_w[row + f]), static_cast<T>(k_cnt[row + f]), tv_j,
        beta, f != self, COLD ? static_cast<T>(cold_k[row + f]) : T(0));
    if (w < w_min) {  // f rises per thread: strict < keeps the first
      w_min = w;
      i_min = f;
    }
  }

  frp::warp_first_min(w_min, i_min);
  __shared__ T warp_w[32];
  __shared__ int warp_i[32];
  const int warp = threadIdx.x / 32;
  const int n_warps = (blockDim.x + 31) / 32;
  if ((threadIdx.x & 31) == 0) {
    warp_w[warp] = w_min;
    warp_i[warp] = i_min;
  }
  __syncthreads();
  if (warp == 0) {
    w_min = threadIdx.x < n_warps ? warp_w[threadIdx.x] : big;
    i_min = threadIdx.x < n_warps ? warp_i[threadIdx.x] : n_fns;
    frp::warp_first_min(w_min, i_min);
    if (threadIdx.x == 0) {
      best_w[lane] = w_min;
      best_i[lane] = w_min >= big ? -1 : i_min;
    }
  }
}

}  // namespace

// Plain C interface for ctypes. Each returns cudaGetLastError() right
// after the launch (0 = launched); the launch is asynchronous on
// `stream`, and nothing here allocates or synchronises.
extern "C" int frp_select_f32(const float* t_e, const float* t_l,
                              const float* t_v, const int32_t* n_w,
                              const int32_t* k_cnt, float tv_j,
                              int self_idx, int n_fns, float* best_w,
                              int32_t* best_i, void* stream) {
  frp_select_kernel<float, false, false>
      <<<1, 1024, 0, static_cast<cudaStream_t>(stream)>>>(
          t_e, t_l, t_v, n_w, k_cnt, nullptr, nullptr, nullptr, nullptr,
          tv_j, self_idx, n_fns, best_w, best_i);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int frp_select_lanes_f64(const double* means,
                                    const double* t_cold,
                                    const double* t_evict,
                                    const int32_t* n_w,
                                    const int32_t* k_cnt,
                                    const double* tv_j,
                                    const int32_t* self_idx,
                                    const double* beta,
                                    const int32_t* cold_k, int n_lanes,
                                    int n_fns, double* best_w,
                                    int32_t* best_i, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cold_k == nullptr)
    frp_select_kernel<double, true, false><<<n_lanes, 256, 0, st>>>(
        means, t_cold, t_evict, n_w, k_cnt, tv_j, self_idx, beta, nullptr,
        0.0, 0, n_fns, best_w, best_i);
  else
    frp_select_kernel<double, true, true><<<n_lanes, 256, 0, st>>>(
        means, t_cold, t_evict, n_w, k_cnt, tv_j, self_idx, beta, cold_k,
        0.0, 0, n_fns, best_w, best_i);
  return static_cast<int>(cudaGetLastError());
}
