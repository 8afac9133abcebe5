// The Mamba2 SSD intra-chunk block (K5), hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_chunk.py::
// ssd_chunk_kernel (`_ssd_kernel`, pallas_call at :69), with its
// contract: for each (batch, chunk, head) cell, with x (c, p), dt and
// cum (c,), B and C (c, n) of the head's group,
//   y[s]  = sum_{t <= s} (C[s] . B[t]) exp(cum[s] - cum[t]) dt[t] x[t]
//   S     = sum_t (B[t] exp(cum[c-1] - cum[t]) dt[t]) (x) x[t]  (p x n)
// all in f32. Layout: x (b, nc, c, h, p) in f32 or bf16 (widened on
// load, so no f32 copy of x is made); dt and cum (b, nc, c, h), B and C
// (b, nc, c, g, n) in f32, head h reading group h / (H / g) (the TPU
// entry takes B and C already repeated over the heads); y (b, nc, c, h,
// p) and the states (b, nc, h, p, n) in f32. Each decay is one
// exponent of a difference, exp(cum[s] - cum[t]), never the product
// exp(cum[s]) exp(-cum[t]): cum falls to about -500 over a chunk, and
// exp(-cum) overflows f32.
//
// What bounds it on an H100: operations. A cell does about c^2 n
// (scores, s >= t) + c^2 p (y) + 2 c p n (states) multiply-adds: at
// Mamba2-780M's c 256, n 128, p 64 some 16.8 MFLOP, 6.4 GFLOP over the
// 384 cells of a 2048-token layer, against ~52 MB moved (x in bf16, y
// and the states in f32). In f32 on the CUDA cores (67 TFLOP/s) that
// is ~0.1 ms of operations against ~0.016 ms of bytes.
// What the design does: every cell gets ceil(c / 64) "y" blocks, one per
// tile of 64 rows s, and ceil(n / 64) "state" blocks, one per slice of
// 64 state columns, so no two blocks write the same output and nothing
// needs atomics (at Mamba2-780M, 6 blocks a cell, 2,304 a layer). A y
// block keeps its 64 rows of C in shared memory and walks the tiles of
// 64 positions t <= its last row (tiles above the diagonal are never
// loaded, as in K2): each tile's B, x, dt and cum are staged, the 64 x
// 64 weights (C B^T, decay, dt, the causal mask) are computed and kept
// in shared memory, then multiplied into the 64 x p output held in
// registers. A state block stages x and the decayed B of each tile and
// accumulates its p x 64 slice of the state. 256 threads; each owns a
// 4 x 4 block of every product (rows ty*4 + i, columns tx + 16 j);
// B and C rows are padded by one word against bank conflicts. The
// heaviest y tiles are issued first. Plain f32 FMA on the CUDA cores:
// tensor cores (TF32) would lose the f32 contract; wgmma is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dtype.cuh"

namespace {

constexpr int kTile = 64;     // rows s of a y block, positions t a step,
                              // state columns of a state block
constexpr int kThreads = 256;
constexpr int kMaxP = 64;     // head dims the kernel takes (p <= 64)
constexpr int kMaxN = 256;    // state sizes the kernel takes (n <= 256)
constexpr int kWS = kTile + 1;  // row stride of the weight tile

// floats of dynamic shared memory: the y block's (the larger) layout
__host__ __device__ constexpr size_t smem_floats(int n) {
  return 2 * static_cast<size_t>(kTile) * (n + 1) + kTile * kMaxP +
         kTile * kWS + 3 * kTile;
}

struct Cell {
  const void* x;     // the cell's x at (s = 0, d = 0)
  const float* dt;   // stride h
  const float* cum;  // stride h
  const float* B;    // stride g * n
  const float* C;
  size_t x_row;      // h * p: one position of x and y
  size_t bc_row;     // g * n: one position of B and C
  int c, h, p, n;
};

// x rows t0 .. t0 + 63 (zero past c and past p), widened to f32
template <typename T>
__device__ __forceinline__ void stage_x(const Cell& cl, int t0, float* xs) {
  const T* x = static_cast<const T*>(cl.x);
  for (int i = threadIdx.x; i < kTile * kMaxP; i += kThreads) {
    const int t = i / kMaxP, d = i % kMaxP;
    xs[i] = t0 + t < cl.c && d < cl.p
                ? to_f32(x[static_cast<size_t>(t0 + t) * cl.x_row + d])
                : 0.f;
  }
}

// y rows s0 .. s0 + 63 of the cell
template <typename T>
__device__ void y_tile(const Cell& cl, int s0, float* y, float* smem) {
  const int c = cl.c, n = cl.n, h = cl.h, NS = n + 1;
  float* Cs = smem;                  // kTile x NS: C of rows s
  float* Bs = Cs + kTile * NS;       // kTile x NS: B of positions t
  float* xs = Bs + kTile * NS;       // kTile x kMaxP
  float* ws = xs + kTile * kMaxP;    // kTile x kWS: the weights (s, t)
  float* cum_s = ws + kTile * kWS;   // kTile
  float* cum_t = cum_s + kTile;      // kTile
  float* dt_t = cum_t + kTile;       // kTile
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  for (int i = tid; i < kTile * n; i += kThreads) {
    const int r = i / n, k = i % n;
    Cs[r * NS + k] =
        s0 + r < c ? cl.C[static_cast<size_t>(s0 + r) * cl.bc_row + k] : 0.f;
  }
  for (int r = tid; r < kTile; r += kThreads)
    cum_s[r] = s0 + r < c ? cl.cum[static_cast<size_t>(s0 + r) * h] : 0.f;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // causal: positions t <= the tile's last row only
  const int t_end = min(c, s0 + kTile);
  for (int t0 = 0; t0 < t_end; t0 += kTile) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = tid; i < kTile * n; i += kThreads) {
      const int t = i / n, k = i % n;
      Bs[t * NS + k] = t0 + t < c
                           ? cl.B[static_cast<size_t>(t0 + t) * cl.bc_row + k]
                           : 0.f;
    }
    stage_x<T>(cl, t0, xs);
    for (int r = tid; r < kTile; r += kThreads) {
      const bool in = t0 + r < c;
      cum_t[r] = in ? cl.cum[static_cast<size_t>(t0 + r) * h] : 0.f;
      dt_t[r] = in ? cl.dt[static_cast<size_t>(t0 + r) * h] : 0.f;
    }
    __syncthreads();

    // scores C[s] . B[t] of rows ty*4 + i, positions tx + 16 j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Cs[(ty * 4 + i) * NS + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[(tx + 16 * j) * NS + k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], b[j], sc[i][j]);
    }
    // weights: masked before the exponent, so no masked (positive)
    // difference is ever exponentiated
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const int s = s0 + r, t = t0 + col;
        float w = 0.f;
        if (t <= s && s < c)
          w = sc[i][j] * expf(cum_s[r] - cum_t[col]) * dt_t[col];
        ws[r * kWS + col] = w;
      }
    }
    __syncthreads();

    // acc += weights x
    const int tk = min(kTile, c - t0);
    for (int t = 0; t < tk; ++t) {
      float w[4], xv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = ws[(ty * 4 + i) * kWS + t];
#pragma unroll
      for (int j = 0; j < 4; ++j) xv[j] = xs[t * kMaxP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(w[i], xv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = s0 + ty * 4 + i;
    if (s >= c) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = tx + 16 * j;
      if (d < cl.p) y[static_cast<size_t>(s) * cl.x_row + d] = acc[i][j];
    }
  }
}

// state columns k0 .. k0 + 63 of the cell: (p, 64) of the (p, n) state
template <typename T>
__device__ void state_tile(const Cell& cl, int k0, float* st, float* smem) {
  const int c = cl.c, n = cl.n, h = cl.h;
  float* xs = smem;                  // kTile x kMaxP
  float* bd = xs + kTile * kMaxP;    // kTile x kTile: decayed B
  float* wt = bd + kTile * kTile;    // kTile: exp(total - cum[t]) dt[t]
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float total = cl.cum[static_cast<size_t>(c - 1) * h];

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int t0 = 0; t0 < c; t0 += kTile) {
    __syncthreads();  // the previous tile is no longer read
    stage_x<T>(cl, t0, xs);
    for (int r = tid; r < kTile; r += kThreads) {
      const size_t at = static_cast<size_t>(t0 + r) * h;
      wt[r] = t0 + r < c ? expf(total - cl.cum[at]) * cl.dt[at] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < kTile * kTile; i += kThreads) {
      const int t = i / kTile, k = i % kTile;
      bd[i] = t0 + t < c && k0 + k < n
                  ? cl.B[static_cast<size_t>(t0 + t) * cl.bc_row + k0 + k] *
                        wt[t]
                  : 0.f;
    }
    __syncthreads();
    const int tk = min(kTile, c - t0);
    for (int t = 0; t < tk; ++t) {
      float xv[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = xs[t * kMaxP + ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bd[t * kTile + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int d = ty * 4 + i;
    if (d >= cl.p) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + tx + 16 * j;
      if (k < n) st[static_cast<size_t>(d) * n + k] = acc[i][j];
    }
  }
}

// grid (b * nc * h cells, n_ytiles + n_stiles): blockIdx.y below
// n_ytiles is a y block (the last row tile first), the rest state blocks
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ cum, const float* __restrict__ B,
                 const float* __restrict__ C, float* __restrict__ y,
                 float* __restrict__ states, int c, int h, int g, int p,
                 int n, int n_ytiles) {
  extern __shared__ __align__(16) float smem[];
  const int cell = blockIdx.x;  // (batch * nc + chunk) * h + head
  const int bc = cell / h, head = cell % h;
  const int grp = head / (h / g);
  Cell cl;
  cl.x_row = static_cast<size_t>(h) * p;
  cl.bc_row = static_cast<size_t>(g) * n;
  const size_t pos0 = static_cast<size_t>(bc) * c;  // the chunk's first
  cl.x = x + pos0 * cl.x_row + static_cast<size_t>(head) * p;
  cl.dt = dt + pos0 * h + head;
  cl.cum = cum + pos0 * h + head;
  cl.B = B + pos0 * cl.bc_row + static_cast<size_t>(grp) * n;
  cl.C = C + pos0 * cl.bc_row + static_cast<size_t>(grp) * n;
  cl.c = c;
  cl.h = h;
  cl.p = p;
  cl.n = n;
  const int role = blockIdx.y;
  if (role < n_ytiles) {
    const int s0 = (n_ytiles - 1 - role) * kTile;
    y_tile<T>(cl, s0, y + pos0 * cl.x_row + static_cast<size_t>(head) * p,
              smem);
  } else {
    const int k0 = (role - n_ytiles) * kTile;
    state_tile<T>(cl, k0, states + static_cast<size_t>(cell) * p * n, smem);
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* cum,
                   const float* B, const float* C, float* y, float* states,
                   int cells, int c, int h, int g, int p, int n,
                   cudaStream_t s) {
  const int n_ytiles = (c + kTile - 1) / kTile;
  const int n_stiles = (n + kTile - 1) / kTile;
  const size_t smem = sizeof(float) * smem_floats(n);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(cells, n_ytiles + n_stiles);
  ssd_chunk_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x), dt, cum, B, C, y, states, c, h, g, p, n,
      n_ytiles);
  return cudaGetLastError();
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16. x (b, nc, c, h, p); dt, cum
// (b, nc, c, h); B, C (b, nc, c, g, n), all f32 but x, contiguous;
// y (b, nc, c, h, p) and states (b, nc, h, p, n) f32, contiguous.
// bnc = b * nc; h % g == 0, 1 <= p <= 64, 1 <= n <= 256. Returns the
// launch's cudaError_t.
extern "C" int ssd_chunk(int x_dtype, const void* x, const void* dt,
                         const void* cum, const void* B, const void* C,
                         void* y, void* states, int bnc, int c, int h, int g,
                         int p, int n, void* stream) {
  if (bnc < 1 || c < 1 || h < 1 || g < 1 || h % g != 0 || p < 1 ||
      p > kMaxP || n < 1 || n > kMaxN ||
      static_cast<long long>(bnc) * h > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* cf = static_cast<const float*>(cum);
  const float* bf = static_cast<const float*>(B);
  const float* cc = static_cast<const float*>(C);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(states);
  if (x_dtype == 0)
    return launch<float>(x, dtf, cf, bf, cc, yf, sf, bnc * h, c, h, g, p, n,
                         s);
  if (x_dtype == 1)
    return launch<__nv_bfloat16>(x, dtf, cf, bf, cc, yf, sf, bnc * h, c, h, g,
                                 p, n, s);
  return cudaErrorInvalidValue;
}
