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
// What bounds it on an H100: bytes (x, r, g, gr read once, dx written
// once, a few f32 operations an element); the partial sums of dw add
// (blocks + 1) D f32 of traffic, small beside the rows.
//
// What the design does about it: the forward's vector body
// (rmsnorm.cu). A row is reduced by a group of G threads; thread l of a
// group holds the row's 16-byte vectors l, l + G, ..., at most VPT of them
// (a template argument sized to the vectors the row has), as f32 (s) and
// as raw words (g, gr), with the weight's vectors kept in registers across
// rows. Every load of a row is issued before its two sums (of s^2 and of
// g w s), so no load waits on them; the sums are shuffles inside the group
// (G <= 32: narrow rows such as the 128-wide q/k-norm, several rows a
// warp) or inside each warp and then once across the row's warps through
// shared memory (G a multiple of 32: wide rows), one __syncthreads a row,
// double-buffered. The geometry comes from the wrapper's `_bwd_plan`
// (kernels/rmsnorm.py). Blocks walk their rows with a grid stride, each
// thread keeping its columns' share of dw in registers across rows. dw is
// deterministic without atomics: each block sums its groups' shares in
// group order into one partial row of a (blocks, D) f32 scratch, and a
// second launch sums the partials column by column in block order and
// casts once.
//
// The general body takes what the vector body cannot (D not a multiple
// of the vector's elements, a pointer off 16 bytes): a warp a row to D
// 1,024, else the block; scalar loads, the row's elements lane, lane + G,
// ... in registers.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dtype.cuh"
#include "vec.cuh"

namespace {

constexpr int kThreads = 256;  // the general body's block
constexpr int kMaxD = 8192;
constexpr int kWarpRowMaxD = 1024;  // widest row a warp takes (general)
constexpr int kMaxThreads = 1024;   // the vector body's largest block

// the most threads a block of the vector body may have with VPT vectors a
// thread (its __launch_bounds__; the wrapper's `bwd_max_threads`)
__host__ __device__ constexpr int max_threads(int vpt) {
  return vpt <= 1 ? 1024 : (vpt <= 2 ? 512 : 256);
}

// ---------------------------------------------------- the vector body
template <typename X, typename W, int VPT, bool RES, bool GRES>
__global__ void __launch_bounds__(max_threads(VPT))
rmsnorm_bwd_vector_kernel(const X* __restrict__ x, const X* __restrict__ r,
                          const W* __restrict__ w, const X* __restrict__ g,
                          const X* __restrict__ gr, X* __restrict__ dx,
                          float* __restrict__ partial, int R, int D, int G,
                          float eps) {
  constexpr int V = 16 / sizeof(X);  // elements a vector
  // red: a partial of each sum a warp, two rows' worth; then (rows a
  // block) x D f32 for the block's dw when the block holds several rows
  extern __shared__ float smem[];
  float(*red)[2][32] = reinterpret_cast<float(*)[2][32]>(smem);
  const int nv = D / V;
  const int l = threadIdx.x % G;  // place in the row's group
  const int rows_per_block = blockDim.x / G;
  const int grp = threadIdx.x / G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  bool on[VPT];
  Pack<W, V> wv[VPT];
  float dw[VPT][V];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    on[i] = l + i * G < nv;
    if (on[i]) wv[i].load(w + static_cast<size_t>(l + i * G) * V);
#pragma unroll
    for (int j = 0; j < V; ++j) dw[i][j] = 0.f;
  }

  int buf = 0;
  for (int base = blockIdx.x * rows_per_block; base < R;
       base += gridDim.x * rows_per_block, buf ^= 1) {
    const int row = base + grp;
    const bool live = row < R;
    const size_t off = static_cast<size_t>(live ? row : 0) * D;
    float s[VPT][V];
    Pack<X, V> gv[VPT], grv[VPT];
    float ss = 0.f, gws = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      if (live && on[i]) {
        const size_t e = off + static_cast<size_t>(l + i * G) * V;
        Pack<X, V> xv;
        xv.load(x + e);
        gv[i].load(g + e);
        if constexpr (GRES) grv[i].load(gr + e);
        if constexpr (RES) {
          Pack<X, V> rv;
          rv.load(r + e);
#pragma unroll
          for (int j = 0; j < V; ++j) s[i][j] = xv.get(j) + rv.get(j);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) s[i][j] = xv.get(j);
        }
#pragma unroll
        for (int j = 0; j < V; ++j) {
          ss += s[i][j] * s[i][j];
          gws += gv[i].get(j) * wv[i].get(j) * s[i][j];
        }
      }
    }
    // the row's sums: shuffles inside a group of G <= 32 lanes, or inside
    // each warp and then once across the row's G / 32 warps
    if (G <= 32) {
      for (int o = G >> 1; o > 0; o >>= 1) {
        ss += __shfl_xor_sync(0xffffffffu, ss, o);
        gws += __shfl_xor_sync(0xffffffffu, gws, o);
      }
    } else {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        ss += __shfl_xor_sync(0xffffffffu, ss, o);
        gws += __shfl_xor_sync(0xffffffffu, gws, o);
      }
      if (lane == 0) {
        red[buf][0][warp] = ss;
        red[buf][1][warp] = gws;
      }
      __syncthreads();
      const int wpr = G >> 5, first = grp * wpr;
      ss = lane < wpr ? red[buf][0][first + lane] : 0.f;
      gws = lane < wpr ? red[buf][1][first + lane] : 0.f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        ss += __shfl_xor_sync(0xffffffffu, ss, o);
        gws += __shfl_xor_sync(0xffffffffu, gws, o);
      }
    }
    // as the forward: the mean a division by D
    const float rs = rsqrtf(ss / static_cast<float>(D) + eps);
    const float c_mean = gws / static_cast<float>(D);
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      if (live && on[i]) {
        const size_t e = off + static_cast<size_t>(l + i * G) * V;
        float o[V];
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float gj = gv[i].get(j);
          o[j] = rs * (gj * wv[i].get(j) - s[i][j] * rs * rs * c_mean);
          if constexpr (GRES) o[j] += grv[i].get(j);
          dw[i][j] += gj * s[i][j] * rs;
        }
        store_vec<X>(dx + e, o);
      }
    }
  }
  // the block's partial dw: its groups' shares summed in group order
  float* out = partial + static_cast<size_t>(blockIdx.x) * D;
  if (rows_per_block == 1) {
#pragma unroll
    for (int i = 0; i < VPT; ++i)
      if (on[i])
#pragma unroll
        for (int j = 0; j < V; ++j) out[(l + i * G) * V + j] = dw[i][j];
    return;
  }
  float* part = smem + 2 * 2 * 32;  // rows_per_block x D
#pragma unroll
  for (int i = 0; i < VPT; ++i)
    if (on[i])
#pragma unroll
      for (int j = 0; j < V; ++j)
        part[grp * D + (l + i * G) * V + j] = dw[i][j];
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    float acc = 0.f;
    for (int i = 0; i < rows_per_block; ++i) acc += part[i * D + c];
    out[c] = acc;
  }
}

// --------------------------------------------------- the general body
template <typename X, typename W, int NPT>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_general_kernel(const X* __restrict__ x, const X* __restrict__ r,
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

// dw[c] = sum over the parts of partial[part, c], in part order: a block
// takes 32 columns, its 32 x kSplit threads each sum every kSplit-th part
// (in order), and the kSplit sums of a column are added in order
constexpr int kSplit = 16;

template <typename W>
__global__ void __launch_bounds__(32 * kSplit)
dw_kernel(const float* __restrict__ partial, W* __restrict__ dw, int parts,
          int D) {
  __shared__ float sums[kSplit][33];
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + tx;
  float acc = 0.f;
  if (c < D)
    for (int i = ty; i < parts; i += kSplit)
      acc += partial[static_cast<size_t>(i) * D + c];
  sums[ty][tx] = acc;
  __syncthreads();
  if (ty != 0 || c >= D) return;
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < kSplit; ++i) total += sums[i][tx];
  dw[c] = from_f32<W>(total);
}

// ------------------------------------------------------------- launches
struct Geometry {
  int vpt, G, rows_per_block, grid;
};

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
}

template <typename X, typename W, int VPT, bool RES, bool GRES>
cudaError_t launch_vector_form(const void* x, const void* r, const void* w,
                               const void* g, const void* gr, void* dx,
                               float* partial, int R, int D, float eps,
                               const Geometry& q, cudaStream_t s) {
  const int threads = q.G * q.rows_per_block;
  if (threads > max_threads(VPT)) return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (2 * 2 * 32 +
                       (q.rows_per_block > 1 ? q.rows_per_block * D : 0));
  auto kern = rmsnorm_bwd_vector_kernel<X, W, VPT, RES, GRES>;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<q.grid, threads, smem, s>>>(
      static_cast<const X*>(x), static_cast<const X*>(r),
      static_cast<const W*>(w), static_cast<const X*>(g),
      static_cast<const X*>(gr), static_cast<X*>(dx), partial, R, D, q.G,
      eps);
  return cudaGetLastError();
}

template <typename X, typename W, int VPT>
cudaError_t launch_vector(const void* x, const void* r, const void* w,
                          const void* g, const void* gr, void* dx,
                          float* partial, int R, int D, float eps,
                          const Geometry& q, cudaStream_t s) {
  if (r == nullptr)  // K4a: no residual, so no residual's gradient
    return launch_vector_form<X, W, VPT, false, false>(
        x, r, w, g, gr, dx, partial, R, D, eps, q, s);
  if (gr == nullptr)
    return launch_vector_form<X, W, VPT, true, false>(
        x, r, w, g, gr, dx, partial, R, D, eps, q, s);
  return launch_vector_form<X, W, VPT, true, true>(x, r, w, g, gr, dx,
                                                   partial, R, D, eps, q, s);
}

template <typename X, typename W, int NPT>
cudaError_t launch_general(const void* x, const void* r, const void* w,
                           const void* g, const void* gr, void* dx,
                           float* partial, int R, int D, int G, int grid,
                           float eps, cudaStream_t s) {
  const int rows_per_block = kThreads / G;
  const size_t smem = rows_per_block == 1
                          ? sizeof(float) * 2 * (kThreads / 32)
                          : sizeof(float) * rows_per_block * D;
  auto kern = rmsnorm_bwd_general_kernel<X, W, NPT>;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const X*>(x), static_cast<const X*>(r),
      static_cast<const W*>(w), static_cast<const X*>(g),
      static_cast<const X*>(gr), static_cast<X*>(dx), partial, R, D, G, eps);
  return cudaGetLastError();
}

template <typename X, typename W>
cudaError_t launch_rows(const void* x, const void* r, const void* w,
                        const void* g, const void* gr, void* dx,
                        float* partial, int R, int D, float eps,
                        const Geometry& q, cudaStream_t s) {
  if (q.vpt == 0) {  // the general body
    if (!((q.G == 32 && D <= kWarpRowMaxD) || q.G == kThreads) ||
        q.rows_per_block != kThreads / q.G)
      return cudaErrorInvalidValue;
    const int npt = (D + q.G - 1) / q.G;
    if (npt <= 4)
      return launch_general<X, W, 4>(x, r, w, g, gr, dx, partial, R, D, q.G,
                                     q.grid, eps, s);
    if (npt <= 8)
      return launch_general<X, W, 8>(x, r, w, g, gr, dx, partial, R, D, q.G,
                                     q.grid, eps, s);
    if (npt <= 16)
      return launch_general<X, W, 16>(x, r, w, g, gr, dx, partial, R, D,
                                      q.G, q.grid, eps, s);
    if (npt <= 32)
      return launch_general<X, W, 32>(x, r, w, g, gr, dx, partial, R, D,
                                      q.G, q.grid, eps, s);
    return cudaErrorInvalidValue;
  }
  // the vector body: whole vectors, aligned pointers, a group that covers
  // the row and reduces as the kernel assumes, the block's partial rows in
  // shared memory
  constexpr int V = 16 / sizeof(X);
  const bool group_ok = q.G <= 32 ? (q.G & (q.G - 1)) == 0
                                  : q.G % 32 == 0 && q.G <= kMaxThreads;
  const long threads = static_cast<long>(q.G) * q.rows_per_block;
  if (D % V != 0 || !group_ok || q.rows_per_block < 1 || threads % 32 != 0 ||
      threads > kMaxThreads ||
      static_cast<long>(q.G) * q.vpt * V < D ||
      (q.rows_per_block > 1 &&
       sizeof(float) * (q.rows_per_block * static_cast<long>(D) + 128) >
           200 * 1024))
    return cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(w) || !aligned16(g) || !aligned16(dx) ||
      (r != nullptr && !aligned16(r)) || (gr != nullptr && !aligned16(gr)))
    return cudaErrorMisalignedAddress;
  switch (q.vpt) {
    case 1:
      return launch_vector<X, W, 1>(x, r, w, g, gr, dx, partial, R, D, eps,
                                    q, s);
    case 2:
      return launch_vector<X, W, 2>(x, r, w, g, gr, dx, partial, R, D, eps,
                                    q, s);
    case 3:
      return launch_vector<X, W, 3>(x, r, w, g, gr, dx, partial, R, D, eps,
                                    q, s);
    case 4:
      return launch_vector<X, W, 4>(x, r, w, g, gr, dx, partial, R, D, eps,
                                    q, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename X, typename W>
cudaError_t launch(const void* x, const void* r, const void* w, const void* g,
                   const void* gr, void* dx, void* dw, float* partial, int R,
                   int D, float eps, const Geometry& q, cudaStream_t s) {
  cudaError_t e =
      launch_rows<X, W>(x, r, w, g, gr, dx, partial, R, D, eps, q, s);
  if (e != cudaSuccess) return e;
  dw_kernel<W><<<(D + 31) / 32, 32 * kSplit, 0, s>>>(
      partial, static_cast<W*>(dw), q.grid, D);
  return cudaGetLastError();
}

}  // namespace

// x, r (null for K4a), g, gr (null when the residual's gradient is
// absent) and dx (R, D) of x_dtype; w and dw (D,) of w_dtype (0 =
// float32, 1 = bfloat16); partial a (grid, D) f32 scratch. The geometry
// is the wrapper's `_bwd_plan`: vpt = 0 selects the general body (G = 32
// threads a row for D <= 1024, else 256; rows_per_block 256 / G); vpt in
// {1, 2, 3, 4} the vector body with G threads a row and rows_per_block
// rows a block; grid blocks walk the rows. The integers come as
// pointer-sized words, as the forward's. Two launches on `stream`;
// returns the first failing launch's cudaError_t
// (cudaErrorInvalidValue for a shape or geometry the bodies do not take,
// cudaErrorMisalignedAddress for a pointer the vector body cannot load;
// nothing is launched then).
extern "C" int rmsnorm_backward(const void* x, const void* r, const void* w,
                                const void* g, const void* gr, void* dx,
                                void* dw, float* partial, intptr_t R,
                                intptr_t D, intptr_t x_dtype,
                                intptr_t w_dtype, intptr_t vpt, intptr_t G,
                                intptr_t rows_per_block, intptr_t grid,
                                float eps, void* stream) {
  if (R < 1 || R > INT32_MAX || D < 1 || D > kMaxD || G < 1 ||
      G > kMaxThreads || rows_per_block < 1 ||
      rows_per_block > kMaxThreads || grid < 1 || grid > INT32_MAX ||
      vpt < 0 || vpt > 4)
    return cudaErrorInvalidValue;
  const Geometry q{static_cast<int>(vpt), static_cast<int>(G),
                   static_cast<int>(rows_per_block), static_cast<int>(grid)};
  const int rows = static_cast<int>(R), d = static_cast<int>(D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && w_dtype == 0)
    return launch<float, float>(x, r, w, g, gr, dx, dw, partial, rows, d,
                                eps, q, s);
  if (x_dtype == 0 && w_dtype == 1)
    return launch<float, __nv_bfloat16>(x, r, w, g, gr, dx, dw, partial,
                                        rows, d, eps, q, s);
  if (x_dtype == 1 && w_dtype == 0)
    return launch<__nv_bfloat16, float>(x, r, w, g, gr, dx, dw, partial,
                                        rows, d, eps, q, s);
  if (x_dtype == 1 && w_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, r, w, g, gr, dx, dw,
                                                partial, rows, d, eps, q, s);
  return cudaErrorInvalidValue;
}
