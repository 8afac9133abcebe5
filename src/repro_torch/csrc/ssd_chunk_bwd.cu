// The gradient of the Mamba2 SSD intra-chunk block (K5's backward),
// hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no Pallas backward of
// `ssd_chunk_kernel`; `jax.grad` differentiates its plain
// src/repro/models/mamba.py::ssd_chunked (:50), whose intra-chunk block
// is K5's contract. For each (batch, chunk, head) cell, with x (c, p),
// dt and cum (c,), B and C (c, n) of the head's group, the forward
// (ssd_chunk.cu) is
//   M[s,t] = (C[s] . B[t]) exp(cum[s] - cum[t]) dt[t]   (s >= t, else 0)
//   y[s]   = sum_t M[s,t] x[t]
//   S      = sum_t w[t] x[t] (x) B[t],  w[t] = exp(cum[c-1] - cum[t]) dt[t]
// and, for the gradients dy (c, p) and dS (p, n), this kernel computes
// (L the decay exp(cum[s] - cum[t]), masked before the exponent, and
// dM[s,t] = dy[s] . x[t] for s >= t):
//   dx[t]   = sum_s M[s,t] dy[s] + w[t] (dS B[t])
//   dC[s]   = sum_t dM L dt[t] B[t]
//   dB[t]   = sum_s dM L dt[t] C[s] + w[t] (dS^T x[t])
//   ddt[t]  = sum_s dM (C[s] . B[t]) L + dw[t] exp(cum[c-1] - cum[t])
//   dcum[s] = sum_t R[s,t] - sum_t R[t,s] - dw[s] w[s]
//             (+ sum_t dw[t] w[t] at s = c - 1)
// with R = dM M and dw[t] = x[t] . (dS B[t]). dB and dC sum the h / g
// heads of a group. All in f32; x, B and C (f32 or bf16) are widened
// exactly as they are read; dx is written in x's type, dB and dC in B's,
// ddt and dcum in f32. Layouts as the forward's: x, dy, dx (b, nc, c, h,
// p); dt, cum, ddt, dcum (b, nc, c, h); B, C, dB, dC (b, nc, c, g, n); dS
// (b, nc, h, p, n).
//
// What bounds it on an H100: operations. A cell needs the scores C B^T
// and dM = dy x^T (c^2 / 2 (n + p) multiply-adds over s >= t), the
// products M^T dy (c^2 p / 2), dM C and dM^T B (c^2 n / 2 each) and the
// state's B dS^T and dS^T x (c p n each): at Mamba2-780M's c 256, n 128,
// p 64 about 42 MFLOP a cell, 32 GFLOP over the 768 cells of a training
// layer (B 4, S 1024), against ~133 MB read and written. In f32 on the
// CUDA cores (67 TFLOP/s) that is ~0.5 ms; the bytes ~40 us. This design
// forms the scores and dM twice (once for each role below), ~30 % more.
//
// The design (a first, simple body: f32 FMA on the CUDA cores, as K5's
// CUDA-core body; tensor cores and TMA are later work):
// - One block a (cell, tile of 64 rows i0 .. i0 + 63). It owns those
//   rows twice: as rows s (dC[s] and the row sums of R, over the tiles t
//   <= its own) and then as positions t (dx[t], dB[t], ddt[t] and the
//   column sums of R, over the tiles s >= its own, plus the state's
//   terms). Every block walks ceil(c / 64) + 2 tile pairs, so the blocks
//   are alike; a cell has ceil(c / 64) of them.
// - Each tile pair forms the 64 x 64 scores (over n) and dM (over p),
//   256 threads each owning a 4 x 4 block (rows ty*4 + i, columns tx +
//   16 j, as K5's CUDA-core body), the weights masked before the
//   exponent; the tiles a product contracts over go through shared
//   memory (rows padded by one word against bank conflicts), the
//   accumulators stay in registers (templated on ceil(n / 64), so every
//   loop has a compile-time count).
// - No atomics, and a fixed order everywhere, so two runs are bitwise
//   equal: a block writes each head's dB and dC rows to f32 scratch,
//   and a second kernel sums a group's heads in head order and casts;
//   a block writes its tile's part of sum_t dw[t] w[t] to scratch, and
//   a third kernel adds the parts, in tile order, to dcum[c - 1].
// - Row sums over a row's 16 threads (tx) by shuffles, in a fixed
//   butterfly.
// Shared memory: 4 tiles of 64 rows (two n wide, two p wide) and two 64
// x 64 weight tiles, 134 KB at n = 128 and 195 KB at n = 256: one block
// an SM.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dtype.cuh"

namespace {

constexpr int kTile = 64;
constexpr int kThreads = 256;
constexpr int kMaxP = 64;
constexpr int kMaxN = 256;
constexpr int kPS = kMaxP + 1;  // row stride of the p-wide tiles
constexpr int kWS = kTile + 1;  // row stride of the weight tiles

// the row stride of an n-wide tile at NK = ceil(n / 64)
template <int NK>
__host__ __device__ constexpr int n_stride() {
  return kTile * NK + 1;
}

template <int NK>
__host__ __device__ constexpr size_t smem_floats() {
  return 2 * static_cast<size_t>(kTile) * n_stride<NK>() +
         2 * static_cast<size_t>(kTile) * kPS + 2 * kTile * kWS + 5 * kTile;
}

// rows r0 .. r0 + 63 of a (positions, width) slice with row pitch
// `pitch`, widened to f32, into a tile of row stride `stride` and
// `cols` columns; zero past `rows` and past `width`
template <typename T>
__device__ __forceinline__ void stage(float* dst, int stride, int cols,
                                      const T* src, size_t pitch, int r0,
                                      int rows, int width) {
  for (int i = threadIdx.x; i < kTile * cols; i += kThreads) {
    const int r = i / cols, k = i % cols;
    dst[r * stride + k] =
        r0 + r < rows && k < width
            ? to_f32(src[static_cast<size_t>(r0 + r) * pitch + k])
            : 0.f;
  }
}

// a[i][j] = sum_k own[ty*4 + i][k] * str[tx + 16 j][k] over K columns
// (tiles of row stride STRIDE)
template <int K, int STRIDE>
__device__ __forceinline__ void product(const float* own, const float* str,
                                        float (&a)[4][4], int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i][j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float u[4], v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) u[i] = own[(ty * 4 + i) * STRIDE + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = str[(tx + 16 * j) * STRIDE + k];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) a[i][j] = fmaf(u[i], v[j], a[i][j]);
  }
}

// the sum over the 16 threads (tx) of a row, in every one of them
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int m = 1; m < 16; m <<= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// One block a (cell, tile): the tile's rows as s (dC, the row sums of R)
// and as t (dx, dB, ddt, dcum), see the header. `dBh` and `dCh` are f32
// scratch (b, nc, c, h, n): each head's own dB and dC; `tot` one float a
// (cell, tile): the tile's sum of dw[t] w[t].
template <typename TX, typename TB, int NK>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_bwd_kernel(const TX* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ cum, const TB* __restrict__ B,
                     const TB* __restrict__ C, const float* __restrict__ dy,
                     const float* __restrict__ dS, TX* __restrict__ dx,
                     float* __restrict__ ddt, float* __restrict__ dcum,
                     float* __restrict__ dBh, float* __restrict__ dCh,
                     float* __restrict__ tot, int c, int h, int g, int p,
                     int n) {
  constexpr int NS = n_stride<NK>();
  constexpr int NW = kTile * NK;  // the n-wide tiles' columns
  constexpr int NJ = 4 * NK;      // a thread's columns of an n-wide output
  extern __shared__ __align__(16) float smem[];
  float* own_n = smem;                   // 64 x NS
  float* own_p = own_n + kTile * NS;     // 64 x kPS
  float* str_n = own_p + kTile * kPS;    // 64 x NS (dS: p x NS)
  float* str_p = str_n + kTile * NS;     // 64 x kPS
  float* w1 = str_p + kTile * kPS;       // 64 x kWS
  float* w2 = w1 + kTile * kWS;          // 64 x kWS
  float* own_cum = w2 + kTile * kWS;     // 64
  float* own_dt = own_cum + kTile;       // 64
  float* str_cum = own_dt + kTile;       // 64
  float* str_dt = str_cum + kTile;       // 64
  float* row_r = str_dt + kTile;         // 64: the s role's sums of R

  const int cell = blockIdx.x;  // (batch * nc + chunk) * h + head
  const int tile = blockIdx.y;
  const int nt = gridDim.y;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int head = cell % h;
  const int grp = head / (h / g);
  // the cell's first position, (batch * nc + chunk) * c, and the pitches
  // of a position: h * p in x, dy and dx, g * n in B and C
  const size_t pos0 = static_cast<size_t>(cell / h) * c;
  const size_t x_row = static_cast<size_t>(h) * p;
  const size_t bc_row = static_cast<size_t>(g) * n;
  const TX* xc = x + pos0 * x_row + static_cast<size_t>(head) * p;
  const float* dyc = dy + pos0 * x_row + static_cast<size_t>(head) * p;
  const TB* Bc = B + pos0 * bc_row + static_cast<size_t>(grp) * n;
  const TB* Cc = C + pos0 * bc_row + static_cast<size_t>(grp) * n;
  const float* cumc = cum + pos0 * h + head;
  const float* dtc = dt + pos0 * h + head;
  const int o0 = tile * kTile;  // the block's own rows o0 .. o0 + 63

  auto stage_col = [&](float* dst, const float* src, int r0) {
    for (int r = tid; r < kTile; r += kThreads)
      dst[r] = r0 + r < c ? src[static_cast<size_t>(r0 + r) * h] : 0.f;
  };

  // ---------------------------------------------------- rows as s
  stage<TB>(own_n, NS, NW, Cc, bc_row, o0, c, n);
  stage<float>(own_p, kPS, kMaxP, dyc, x_row, o0, c, p);
  stage_col(own_cum, cumc, o0);
  float dc_acc[4][NJ];
  float rsum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rsum[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) dc_acc[i][j] = 0.f;
  }
  for (int tj = 0; tj <= tile; ++tj) {
    const int t0 = tj * kTile;
    __syncthreads();  // the previous tile is no longer read
    stage<TB>(str_n, NS, NW, Bc, bc_row, t0, c, n);
    stage<TX>(str_p, kPS, kMaxP, xc, x_row, t0, c, p);
    stage_col(str_cum, cumc, t0);
    stage_col(str_dt, dtc, t0);
    __syncthreads();
    float sc[4][4], dm[4][4];
    product<NW, NS>(own_n, str_n, sc, ty, tx);    // C[s] . B[t]
    product<kMaxP, kPS>(own_p, str_p, dm, ty, tx);  // dy[s] . x[t]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, s = o0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j, t = t0 + col;
        float gv = 0.f;
        if (t <= s && s < c) {
          const float l = expf(own_cum[r] - str_cum[col]);
          const float dtt = str_dt[col];
          gv = dm[i][j] * l * dtt;
          rsum[i] += dm[i][j] * sc[i][j] * l * dtt;  // R[s,t]
        }
        w1[r * kWS + col] = gv;
      }
    }
    __syncthreads();
    // dC[s] += sum_t G[s,t] B[t]
    const int tk = min(kTile, c - t0);
    for (int t = 0; t < tk; ++t) {
      float gv[4], bv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) gv[i] = w1[(ty * 4 + i) * kWS + t];
#pragma unroll
      for (int j = 0; j < NJ; ++j) bv[j] = str_n[t * NS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          dc_acc[i][j] = fmaf(gv[i], bv[j], dc_acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float r = row_sum(rsum[i]);
    if (tx == 0) row_r[ty * 4 + i] = r;
  }
  const size_t head_row = static_cast<size_t>(h) * n;  // a position of dBh
  float* dCh_c = dCh + pos0 * head_row + static_cast<size_t>(head) * n;
  float* dBh_c = dBh + pos0 * head_row + static_cast<size_t>(head) * n;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = o0 + ty * 4 + i;
    if (s >= c) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int k = tx + 16 * j;
      if (k < n) dCh_c[static_cast<size_t>(s) * head_row + k] = dc_acc[i][j];
    }
  }

  // ---------------------------------------------------- rows as t
  __syncthreads();  // the s role's tiles are no longer read
  stage<TB>(own_n, NS, NW, Bc, bc_row, o0, c, n);
  stage<TX>(own_p, kPS, kMaxP, xc, x_row, o0, c, p);
  stage_col(own_cum, cumc, o0);
  stage_col(own_dt, dtc, o0);
  // dS (p rows of n) in the streamed n-wide tile
  const float* dSc = dS + static_cast<size_t>(cell) * p * n;
  for (int i = tid; i < kTile * NW; i += kThreads) {
    const int d = i / NW, k = i % NW;
    str_n[d * NS + k] =
        d < p && k < n ? dSc[static_cast<size_t>(d) * n + k] : 0.f;
  }
  __syncthreads();
  const float total = cumc[static_cast<size_t>(c - 1) * h];
  float dx_acc[4][4], db_acc[4][NJ], qsum[4], csum[4], ew[4], wt[4], dw[4];
  {
    // the state's terms: u[t][d] = (dS B[t])_d, dx[t] = w[t] u[t],
    // dw[t] = x[t] . u[t], dB[t] = w[t] dS^T x[t]
    float u[4][4];
    product<NW, NS>(own_n, str_n, u, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const bool in = o0 + r < c;
      ew[i] = in ? expf(total - own_cum[r]) : 0.f;
      wt[i] = ew[i] * own_dt[r];
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dx_acc[i][j] = wt[i] * u[i][j];
        part = fmaf(own_p[r * kPS + tx + 16 * j], u[i][j], part);
      }
      dw[i] = row_sum(part);
      qsum[i] = 0.f;
      csum[i] = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) db_acc[i][j] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < kMaxP; ++d) {
      float xv[4], sv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = own_p[(ty * 4 + i) * kPS + d];
#pragma unroll
      for (int j = 0; j < NJ; ++j) sv[j] = str_n[d * NS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          db_acc[i][j] = fmaf(xv[i], sv[j], db_acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) db_acc[i][j] *= wt[i];
  }
  for (int sj = tile; sj < nt; ++sj) {
    const int s0 = sj * kTile;
    __syncthreads();  // the previous tile (or dS) is no longer read
    stage<TB>(str_n, NS, NW, Cc, bc_row, s0, c, n);
    stage<float>(str_p, kPS, kMaxP, dyc, x_row, s0, c, p);
    stage_col(str_cum, cumc, s0);
    __syncthreads();
    float sc[4][4], dm[4][4];
    product<NW, NS>(own_n, str_n, sc, ty, tx);      // B[t] . C[s]
    product<kMaxP, kPS>(own_p, str_p, dm, ty, tx);  // x[t] . dy[s]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, t = o0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j, s = s0 + col;
        float mv = 0.f, gv = 0.f;
        if (t <= s && s < c) {
          const float l = expf(str_cum[col] - own_cum[r]);
          const float dtt = own_dt[r];
          const float q = dm[i][j] * sc[i][j] * l;
          mv = sc[i][j] * l * dtt;
          gv = dm[i][j] * l * dtt;
          qsum[i] += q;
          csum[i] += q * dtt;
        }
        w1[r * kWS + col] = mv;
        w2[r * kWS + col] = gv;
      }
    }
    __syncthreads();
    // dx[t] += sum_s M[s,t] dy[s]; dB[t] += sum_s G[s,t] C[s]
    const int sk = min(kTile, c - s0);
    for (int s = 0; s < sk; ++s) {
      float mv[4], gv[4], dv[4], cv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        mv[i] = w1[(ty * 4 + i) * kWS + s];
        gv[i] = w2[(ty * 4 + i) * kWS + s];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) dv[j] = str_p[s * kPS + tx + 16 * j];
#pragma unroll
      for (int j = 0; j < NJ; ++j) cv[j] = str_n[s * NS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          dx_acc[i][j] = fmaf(mv[i], dv[j], dx_acc[i][j]);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          db_acc[i][j] = fmaf(gv[i], cv[j], db_acc[i][j]);
      }
    }
  }
  // outputs of the rows as t
  TX* dxc = dx + pos0 * x_row + static_cast<size_t>(head) * p;
  float tot_part[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, t = o0 + r;
    const float q = row_sum(qsum[i]);
    const float cs = row_sum(csum[i]);
    tot_part[i] = dw[i] * wt[i];
    if (t >= c) continue;
    if (tx == 0) {
      const size_t at = static_cast<size_t>(t) * h;
      ddt[pos0 * h + head + at] = q + dw[i] * ew[i];
      dcum[pos0 * h + head + at] = row_r[r] - cs - tot_part[i];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = tx + 16 * j;
      if (d < p)
        dxc[static_cast<size_t>(t) * x_row + d] =
            from_f32<TX>(dx_acc[i][j]);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int k = tx + 16 * j;
      if (k < n) dBh_c[static_cast<size_t>(t) * head_row + k] = db_acc[i][j];
    }
  }
  // the tile's sum of dw[t] w[t], in row order (rows past c add 0)
  __syncthreads();
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) str_cum[ty * 4 + i] = tot_part[i];
  }
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int r = 0; r < kTile; ++r) s += str_cum[r];
    tot[static_cast<size_t>(cell) * nt + tile] = s;
  }
}

// dB and dC (b, nc, c, g, n) in TB: each the sum, in head order, of its
// group's h / g heads' rows of the scratch
template <typename TB>
__global__ void __launch_bounds__(kThreads)
group_sum_kernel(const float* __restrict__ dBh, const float* __restrict__ dCh,
                 TB* __restrict__ dB, TB* __restrict__ dC, long long total,
                 int h, int g, int n) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int k = static_cast<int>(idx % n);
  const long long rest = idx / n;
  const int grp = static_cast<int>(rest % g);
  const long long pos = rest / g;
  const int hg = h / g;
  const size_t base =
      (static_cast<size_t>(pos) * h + static_cast<size_t>(grp) * hg) * n + k;
  float sb = 0.f, sc = 0.f;
  for (int j = 0; j < hg; ++j) {
    sb += dBh[base + static_cast<size_t>(j) * n];
    sc += dCh[base + static_cast<size_t>(j) * n];
  }
  dB[idx] = from_f32<TB>(sb);
  dC[idx] = from_f32<TB>(sc);
}

// dcum[c - 1] of each cell += the sum, in tile order, of its tiles' sums
// of dw[t] w[t]
__global__ void __launch_bounds__(kThreads)
last_dcum_kernel(float* __restrict__ dcum, const float* __restrict__ tot,
                 int cells, int c, int h, int nt) {
  const int cell = blockIdx.x * kThreads + threadIdx.x;
  if (cell >= cells) return;
  float s = 0.f;
  for (int i = 0; i < nt; ++i) s += tot[static_cast<size_t>(cell) * nt + i];
  const size_t at =
      (static_cast<size_t>(cell / h) * c + (c - 1)) * h + cell % h;
  dcum[at] += s;
}

template <typename TX, typename TB, int NK>
cudaError_t launch_nk(const void* x, const float* dt, const float* cum,
                      const void* B, const void* C, const float* dy,
                      const float* dS, void* dx, float* ddt, float* dcum,
                      float* dBh, float* dCh, float* tot, int cells, int c,
                      int h, int g, int p, int n, cudaStream_t s) {
  const size_t smem = sizeof(float) * smem_floats<NK>();
  cudaError_t e = cudaFuncSetAttribute(
      ssd_chunk_bwd_kernel<TX, TB, NK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int nt = (c + kTile - 1) / kTile;
  ssd_chunk_bwd_kernel<TX, TB, NK><<<dim3(cells, nt), kThreads, smem, s>>>(
      static_cast<const TX*>(x), dt, cum, static_cast<const TB*>(B),
      static_cast<const TB*>(C), dy, dS, static_cast<TX*>(dx), ddt, dcum,
      dBh, dCh, tot, c, h, g, p, n);
  return cudaGetLastError();
}

template <typename TX, typename TB>
cudaError_t launch(const void* x, const float* dt, const float* cum,
                   const void* B, const void* C, const float* dy,
                   const float* dS, void* dx, float* ddt, float* dcum,
                   void* dB, void* dC, float* scratch, int bnc, int c, int h,
                   int g, int p, int n, cudaStream_t s) {
  const int cells = bnc * h;
  const size_t per_head = static_cast<size_t>(bnc) * c * h * n;
  float* dBh = scratch;
  float* dCh = scratch + per_head;
  float* tot = scratch + 2 * per_head;
  cudaError_t e;
  switch ((n + kTile - 1) / kTile) {
    case 1:
      e = launch_nk<TX, TB, 1>(x, dt, cum, B, C, dy, dS, dx, ddt, dcum, dBh,
                               dCh, tot, cells, c, h, g, p, n, s);
      break;
    case 2:
      e = launch_nk<TX, TB, 2>(x, dt, cum, B, C, dy, dS, dx, ddt, dcum, dBh,
                               dCh, tot, cells, c, h, g, p, n, s);
      break;
    case 3:
      e = launch_nk<TX, TB, 3>(x, dt, cum, B, C, dy, dS, dx, ddt, dcum, dBh,
                               dCh, tot, cells, c, h, g, p, n, s);
      break;
    case 4:
      e = launch_nk<TX, TB, 4>(x, dt, cum, B, C, dy, dS, dx, ddt, dcum, dBh,
                               dCh, tot, cells, c, h, g, p, n, s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return e;
  const long long total = static_cast<long long>(bnc) * c * g * n;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  group_sum_kernel<TB><<<static_cast<int>(blocks), kThreads, 0, s>>>(
      dBh, dCh, static_cast<TB*>(dB), static_cast<TB*>(dC), total, h, g, n);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int nt = (c + kTile - 1) / kTile;
  last_dcum_kernel<<<(cells + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      dcum, tot, cells, c, h, nt);
  return cudaGetLastError();
}

}  // namespace

// x_dtype, bc_dtype: 0 = float32, 1 = bfloat16 (x and dx; B, C, dB and dC;
// B and C in bf16 only with x in bf16). dt, cum, dy, dS, ddt and dcum
// f32. Shapes as the header's; all contiguous; bnc = b * nc; h % g == 0,
// 1 <= p <= 64, 1 <= n <= 256. `scratch`: f32 of 2 bnc c h n + bnc h
// ceil(c / 64) floats. Three launches on `stream`; returns the first
// failing launch's cudaError_t.
extern "C" int ssd_chunk_backward(int x_dtype, int bc_dtype, const void* x,
                                  const void* dt, const void* cum,
                                  const void* B, const void* C,
                                  const void* dy, const void* dS, void* dx,
                                  void* ddt, void* dcum, void* dB, void* dC,
                                  void* scratch, int bnc, int c, int h, int g,
                                  int p, int n, void* stream) {
  if (bnc < 1 || c < 1 || h < 1 || g < 1 || h % g != 0 || p < 1 ||
      p > kMaxP || n < 1 || n > kMaxN || ((x_dtype | bc_dtype) & ~1) != 0 ||
      (bc_dtype == 1 && x_dtype != 1) ||
      static_cast<long long>(bnc) * h > 0x7fffffffLL ||
      (c + kTile - 1) / kTile > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* cf = static_cast<const float*>(cum);
  const float* dyf = static_cast<const float*>(dy);
  const float* dSf = static_cast<const float*>(dS);
  float* ddtf = static_cast<float*>(ddt);
  float* dcf = static_cast<float*>(dcum);
  float* scr = static_cast<float*>(scratch);
  using bf = __nv_bfloat16;
  switch (x_dtype * 2 + bc_dtype) {
    case 0:
      return launch<float, float>(x, dtf, cf, B, C, dyf, dSf, dx, ddtf, dcf,
                                  dB, dC, scr, bnc, c, h, g, p, n, s);
    case 2:
      return launch<bf, float>(x, dtf, cf, B, C, dyf, dSf, dx, ddtf, dcf, dB,
                               dC, scr, bnc, c, h, g, p, n, s);
    case 3:
      return launch<bf, bf>(x, dtf, cf, B, C, dyf, dSf, dx, ddtf, dcf, dB,
                            dC, scr, bnc, c, h, g, p, n, s);
  }
  return cudaErrorInvalidValue;
}
