// FRP candidate weight (paper Alg. 3, Eq. 7 and Eq. 10) and the
// first-index argmin, shared by csrc/frp_select.cu (K1, the standalone
// kernel) and csrc/event_loop.cu (K0, which runs the same scan inline on
// every completion). Both sources are built with --fmad=false: the
// operations below run in the reference's order, with no multiply-add
// contracted, so each weight is bitwise the plain PyTorch version's.
#pragma once

#include <cstdint>

namespace frp {

template <typename T>
__device__ __forceinline__ T clamp_lo(T x, T lo) {
  // jnp.maximum(x, lo) for finite lo: NaN stays NaN
  return x < lo ? lo : x;
}

// Keep the lexicographically smaller of (w, i) and (ow, oi): the first
// index of the minimum once every pair has been seen, in any order.
template <typename T>
__device__ __forceinline__ void keep_first_min(T& w, int& i, T ow, int oi) {
  if (ow < w || (ow == w && oi < i)) {
    w = ow;
    i = oi;
  }
}

// Warp-wide first-index minimum: every lane of the warp ends with the
// warp's (w, i).
template <typename T>
__device__ __forceinline__ void warp_first_min(T& w, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const T ow = __shfl_xor_sync(0xffffffffu, w, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    keep_first_min(w, i, ow, oi);
  }
}

// The weight of one candidate function, BIG (1e30) when it does not
// qualify (n_w > 0, n_e > 0 and not the finishing function itself):
//   n_e = (n_w + 1) - ((t_l + t_v_j) * K) / t_e                (Eq. 7)
//   w   = t_e + ((beta * (t_l + t_v)) * (K + 1)) / max(n_e, eps) (Eq. 10)
// ENGINE = false is the TPU kernel's f32 contract (t_e clamped at 1e-9,
// eps = 1e-9, beta = 1); ENGINE = true the engine's f64 contract (t_e
// the running mean, unclamped; eps = 1e-30). COLD = true is ESFF-H's
// cold-aware drain estimate: each instance still warming up claims one
// waiting request, n_e -= coldK (the function's COLD slots) after Eq. 7;
// with COLD = false `coldk` is never read.
template <typename T, bool ENGINE, bool COLD = false>
__device__ __forceinline__ T weight(T te, T tl, T tv, T nw, T k, T tv_j,
                                    T beta, bool other, T coldk = T(0)) {
  const T eps = ENGINE ? T(1e-30) : T(1e-9);
  const T den = ENGINE ? te : clamp_lo(te, T(1e-9));
  T n_e = (nw + T(1)) - ((tl + tv_j) * k) / den;
  if (COLD) n_e = n_e - coldk;
  const T w = te + ((beta * (tl + tv)) * (k + T(1))) / clamp_lo(n_e, eps);
  return (nw > T(0) && n_e > T(0) && other) ? w : T(1e30);
}

}  // namespace frp
