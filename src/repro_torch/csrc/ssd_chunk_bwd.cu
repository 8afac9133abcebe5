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
// CUDA cores (67 TFLOP/s) that is ~0.5 ms; on the tensor cores, with
// every f32 operand in three bf16 parts, ~0.065 ms.
//
// Two bodies; the wrapper (kernels/ssd_chunk.py) picks one by dtype and
// shape class (the forward's rule) and names it in the entry's `body`
// argument. Neither falls back to the other.
//
// The tensor-core body (`body` 1), for x, B and C in bf16 at p = 64, n a
// multiple of 64 up to 256, c <= 256, x, B and C on 16 bytes: three
// launches, no atomics, every sum in a fixed order (two runs are
// bitwise equal).
// - Exactness. Only x, B and C are bf16; dy, dS and the weights are f32.
//   A product of two bf16 values is exact in f32, so the scores C B^T
//   are one pass. Every f32 operand is split into three bf16 parts (hi,
//   mid, lo, each rounded to nearest: split3.cuh), each part one pass:
//   dy in dM = dy x^T, dS in B dS^T and x dS, the weights G against B
//   and C. M^T dy multiplies two f32 operands: of the nine products of
//   M's parts and dy's it keeps the six whose orders add to at most two
//   (hi.hi, hi.mid, mid.hi, hi.lo, mid.mid, lo.hi); the three dropped
//   are below 2^-26 of |M| |dy| a term, and each split leaves at most
//   2^-27 of its value, so every term keeps about f32's 24 bits. TF32 is
//   not used anywhere. tests/test_torch_ssd_backward_body.py repeats
//   this arithmetic on the CPU and holds it to the plain backward.
// - Launch 1, `ssd_bwd_split_kernel`: dy and dS into three bf16 planes each
//   (scratch), so that TMA brings their parts in as bf16 tiles.
// - Launch 2, `ssd_bwd_main_kernel`, two kinds of block of one warpgroup,
//   both owning a tile of 64 positions t (rows t0 .. t0 + 63) of a chunk
//   and walking the tiles of 64 positions s >= them:
//   * a dx block a (chunk, tile, head): u = B dS^T (three passes), dw =
//     x . u, dx = w u, then for each tile s: the scores B[t] . C[s],
//     the weights M^T (masked before the exponent) split into three
//     register A fragments, dx += M^T dy over the six kept terms (dy's
//     parts read MN-major through the transpose bit). Writes dx, dw and
//     the tile's sum of dw w.
//   * a G block a (chunk, tile, slice of up to kSliceHeads heads of one
//     group): for each tile s the scores once, then for each head dM^T =
//     x dy^T (three passes), the row sums over s of dM (C.B) L (ddt's
//     first term), the column sums over t of R (dcum's first term, a
//     partial a tile t), and G^T = dM^T L dt summed over the slice's
//     heads in registers: the scores and G are per group (B and C are),
//     so the slice forms its G tile once instead of once a head. The
//     slice's G tile goes to scratch as (s, t); then, for each 64-column
//     chunk of dB, the state term sum_h w_h[t] (x_h dS_h) (three passes a
//     head). Mamba2-780M's 48 heads a group take 6 slices: the scratch
//     that crosses blocks is 6 partial G's and state terms a chunk
//     (~28 MB at B 4, S 1024) instead of each head's dB and dC (201 MB).
// - Launch 3, `ssd_bwd_group_kernel`: a block a (chunk, group, tile, column
//   chunk) for dC (rows s: sum over t <= s of G's three parts times B)
//   and one for dB (rows t: the slices' state terms plus G^T's parts
//   times C), each summing the group's slices in slice order before the
//   split; then a finisher block a 128 positions: ddt = (row sums) + dw
//   exp(cum[c-1] - cum), dcum = (column sums, in tile order) - dt (row
//   sums) - dw w (+ the chunk's tiles' sums of dw w, in tile order, at c
//   - 1).
// - Loads: thread 0 issues TMA copies through 4-D tensor maps (x, B, C
//   over (b nc, c, h | g, p | n); dy's parts over (3 b nc, c, h, p); dS's
//   over (3 b nc h, p, 1, n)) into a ring of two 32 KB stages, one
//   mbarrier each, in the order the warpgroup consumes them; the maps
//   zero-fill rows past c. Every tile is rows of 64 bf16 (128 bytes) in
//   the TMA's 128-byte swizzle, read by wgmma m64n64k16 with the same
//   swizzle: K-major for the scores, dM, u; MN-major (transpose bit) for
//   dx += M^T dy, the state term and the group kernel's products.
// - Every k-step loop has a compile-time count (templated on n / 64): a
//   run-time count makes ptxas serialise the wgmmas (warning C7515).
// The design's floor (chip_smoke.py's `ssd_bwd_work`): beside the
// bound's passes it forms the scores in both kinds of block, dM^T in
// the G blocks only, the six-term dx, and moves the split planes (dy's
// and dS's three parts: ~6 bytes written and read for each f32) and the
// slices' scratch.
//
// The CUDA-core body (`body` 0), for everything else (f32 inputs, bf16
// x with f32 B and C, other widths, c > 256); a first, simple body of f32
// FMA, as K5's CUDA-core body:
// - One block a (cell, tile of 64 rows i0 .. i0 + 63). It owns those
//   rows twice: as rows s (dC[s] and the row sums of R, over the tiles t
//   <= its own) and then as positions t (dx[t], dB[t], ddt[t] and the
//   column sums of R, over the tiles s >= its own, plus the state's
//   terms). Every block walks ceil(c / 64) + 1 tile pairs, so the blocks
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

#include <algorithm>
#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dtype.cuh"
#include "mbarrier.cuh"
#include "split3.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

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


// ------------------------------- bf16 x, B, C: TMA + wgmma, Hopper only
constexpr int kTcThreads = 128;  // one warpgroup
constexpr int kTcP = 64;         // the head dim the body takes
constexpr int kTcMaxC = 256;     // the chunk lengths it takes
constexpr int kRowBytes = 128;   // a row of 64 bf16: the swizzle span
constexpr int kChunkBytes = kTile * kRowBytes;  // 64 rows x 64 columns
constexpr int kSliceHeads = 8;   // heads a G block walks
constexpr int kStages = 2;
constexpr int kStageBytes = 4 * kChunkBytes;    // the largest item
constexpr int kSplitThreads = 256;

// The main kernel's shared memory at n = 64 NCH: B of the block's rows
// (NCH chunks), x of its rows (a dx block), the ring, then floats: a dx
// block's cum and dt of its head over the chunk (and 64 for its tile's
// sum of dw w); a G block's cum of its heads over the chunk, dt of its
// rows, the row sums (ddt's first term) and each warp's column sums of
// R; then the mbarriers (the ring's, then the resident tiles').
template <int NCH>
struct MainPlan {
  static constexpr int X_OWN = NCH * kChunkBytes;
  static constexpr int RING = X_OWN + kChunkBytes;
  static constexpr int FLOATS_OFF = RING + kStages * kStageBytes;
  static constexpr int CUM = 0;                               // [8][256]
  static constexpr int DT = CUM + kSliceHeads * kTcMaxC;      // [8][64]
  static constexpr int QS = DT + kSliceHeads * kTile;         // [8][64]
  static constexpr int ROWP = QS + kSliceHeads * kTile;       // [8][4][64]
  static constexpr int FLOATS = ROWP + kSliceHeads * 4 * kTile;
  static constexpr int BAR_OFF = FLOATS_OFF + FLOATS * 4;
  static constexpr int SMEM = BAR_OFF + (kStages + 1) * 8 + 1024;
};

// blocks an SM at n = 64 NCH: two fit at n <= 128 (101 / 109 KB)
constexpr int main_blocks_per_sm(int nch) { return nch <= 2 ? 2 : 1; }

// The scratch of the tensor-core body, carved by `carve` in this order
// from the wrapper's f32 buffer, each piece rounded up to 64 floats (the
// wrapper sizes the buffer by ssd_chunk_backward_scratch_floats).
struct Scratch {
  __nv_bfloat16* dy3;  // (3, bnc, c, h, p): dy's parts
  __nv_bfloat16* ds3;  // (3, bnc, h, p, n): dS's parts
  float* gsum;         // (bnc, nsl, cp, cp): a slice's G, (s, t)
  float* dbst;         // (bnc, nsl, cp, n): a slice's state term of dB
  float* rowr;         // (nt, bnc, h, cp): column sums of R a tile t
  float* q;            // (bnc, h, cp): row sums of dM (C.B) L
  float* dw;           // (bnc, h, cp)
  float* tot;          // (bnc, h, nt): a tile's sum of dw w
};

__host__ __device__ constexpr size_t round64(size_t v) {
  return (v + 63) / 64 * 64;
}

// element (r, d) of a swizzled 64 x 64 bf16 tile, in elements
__device__ __forceinline__ int swz(int r, int d) {
  return r * 64 + (((d >> 3) ^ (r & 7)) << 3) + (d & 7);
}

// wgmma descriptors of a 64-row tile stored as 64-column chunks:
// K-major, k-step kk in chunk kk / 4 at byte (kk % 4) * 32; MN-major
// (the product contracts over the tile's rows), k-step kj's rows at kj *
// 16 * 128 bytes, the chunks of a wider N kChunkBytes apart
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk) {
  return smem_desc(tile + (kk / 4) * kChunkBytes + (kk % 4) * 32, 16,
                   8 * kRowBytes, 1);
}
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kj) {
  return smem_desc(tile + kj * 16 * kRowBytes, kChunkBytes, 8 * kRowBytes,
                   1);
}

// v += A B^T over 64 KCH columns, A and B 64-row tiles of KCH chunks
template <int KCH>
__device__ __forceinline__ void add_scores(float (&v)[32], uint32_t a,
                                           uint32_t b) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4 * KCH; ++kk)
    Wgmma<64>::ss(v, kmajor(a, kk), kmajor(b, kk), 1);
  wgmma_commit();
  wgmma_wait_all();
  pin<32>(v);
}

// acc += (part QM of M^T) (part QD of dy), dy's parts kChunkBytes apart
// from `d`, read MN-major
template <int QM, int QD>
__device__ __forceinline__ void dx_term(float (&acc)[32],
                                        const uint32_t (&a)[3][4][4],
                                        uint32_t d) {
#pragma unroll
  for (int kj = 0; kj < 4; ++kj)
    Wgmma<64>::rs(acc, a[QM][kj], mnmajor(d + QD * kChunkBytes, kj), 1);
}

// one halving exchange of column_sums: a lane keeps the entries HALF ..
// 2 HALF - 1 of rc (`up`) or 0 .. HALF - 1, adds its partner's (lane ^
// mask) copy of them and moves them to 0 .. HALF - 1
template <int HALF>
__device__ __forceinline__ void halve(float (&rc)[16], bool up, int mask) {
#pragma unroll
  for (int k = 0; k < HALF; ++k) {
    const float send = up ? rc[k] : rc[HALF + k];
    const float keep = up ? rc[HALF + k] : rc[k];
    rc[k] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
  }
}

// rc[0], rc[1] := the sums over the lanes that share lane % 4 of the
// entries 2 (lane / 4) and 2 (lane / 4) + 1 of rc[16] (three halving
// exchanges, 14 shuffles)
__device__ __forceinline__ void column_sums(float (&rc)[16], int lane) {
  halve<8>(rc, (lane >> 4) & 1, 16);
  halve<4>(rc, (lane >> 3) & 1, 8);
  halve<2>(rc, (lane >> 2) & 1, 4);
}

template <int N>
__device__ __forceinline__ void zero(float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = 0.f;
}

// dy and dS, f32, into their three bf16 parts: plane k of `out` at k *
// count elements
__global__ void __launch_bounds__(kSplitThreads)
ssd_bwd_split_kernel(const float* __restrict__ dy, long long n_dy,
             const float* __restrict__ dS, long long n_ds,
             __nv_bfloat16* __restrict__ dy3,
             __nv_bfloat16* __restrict__ ds3) {
  const long long stride = static_cast<long long>(gridDim.x) * kSplitThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kSplitThreads +
                     threadIdx.x;
       i < n_dy + n_ds; i += stride) {
    const bool is_dy = i < n_dy;
    const long long k = is_dy ? i : i - n_dy;
    const long long count = is_dy ? n_dy : n_ds;
    __nv_bfloat16* out = is_dy ? dy3 : ds3;
    float hi, mid, lo;
    split3(is_dy ? dy[k] : dS[k], hi, mid, lo);
    out[k] = __float2bfloat16_rn(hi);
    out[k + count] = __float2bfloat16_rn(mid);
    out[k + 2 * count] = __float2bfloat16_rn(lo);
  }
}

// One warpgroup a block. blockIdx.x: the chunk (b * nc + chunk), then
// within it first the G blocks (tile, slice), then the dx blocks (tile,
// head). See the header.
template <int NCH>
__global__ void __launch_bounds__(kTcThreads, main_blocks_per_sm(NCH))
ssd_bwd_main_kernel(const __grid_constant__ CUtensorMap tm_x,
                const __grid_constant__ CUtensorMap tm_b,
                const __grid_constant__ CUtensorMap tm_c,
                const __grid_constant__ CUtensorMap tm_dy3,
                const __grid_constant__ CUtensorMap tm_ds3,
                const float* __restrict__ dt, const float* __restrict__ cum,
                __nv_bfloat16* __restrict__ dx, Scratch scr, int bnc, int c,
                int h, int g) {
  using P = MainPlan<NCH>;
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  unsigned char* base =
      tc_smem + ((1024 - (smem_u32(tc_smem) & 1023)) & 1023);
  unsigned char* b_own = base;
  unsigned char* x_own = base + P::X_OWN;
  unsigned char* ring = base + P::RING;
  float* fl = reinterpret_cast<float*>(base + P::FLOATS_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + P::BAR_OFF);
  uint64_t* own_bar = full + kStages;

  const int nt = (c + kTile - 1) / kTile, cp = nt * kTile;
  const int hg = h / g;
  const int spg = (hg + kSliceHeads - 1) / kSliceHeads;  // slices a group
  const int nsl = g * spg;
  const int g_blocks = nt * nsl;
  const int bc = blockIdx.x / (g_blocks + nt * h);
  int r = blockIdx.x % (g_blocks + nt * h);
  const bool is_g = r < g_blocks;
  int j, head0, nheads, sl = 0;
  if (is_g) {
    j = r / nsl;
    sl = r % nsl;
    head0 = (sl / spg) * hg + (sl % spg) * kSliceHeads;
    nheads = min(kSliceHeads, hg - (sl % spg) * kSliceHeads);
  } else {
    r -= g_blocks;
    j = r / h;
    head0 = r % h;
    nheads = 1;
  }
  const int grp = head0 / hg;
  const int t0 = j * kTile;
  const int n_pairs = nt - j;
  const int n_items =
      is_g ? n_pairs * (1 + nheads) + NCH * nheads : 3 + 2 * n_pairs;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    mbar_init(own_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0: item k of the block's sequence into stage k % kStages
  const CUtensorMap* m_x = &tm_x;
  const CUtensorMap* m_c = &tm_c;
  const CUtensorMap* m_dy3 = &tm_dy3;
  const CUtensorMap* m_ds3 = &tm_ds3;
  auto issue = [=](int k) {
    unsigned char* st = ring + (k % kStages) * kStageBytes;
    uint64_t* bar = &full[k % kStages];
    // the tile of C of positions s0 .. s0 + 63 (NCH chunks)
    auto load_c = [&](int i) {
      mbar_expect_tx(bar, NCH * kChunkBytes);
      for (int ch = 0; ch < NCH; ++ch)
        tma_load_4d(st + ch * kChunkBytes, m_c, bar, 64 * ch, grp,
                    kTile * i, bc);
    };
    // dy's three parts of head hd at the tile of positions 64 i, from
    // byte `at` of the stage
    auto load_dy = [&](int hd, int i, int at) {
      for (int q = 0; q < 3; ++q)
        tma_load_4d(st + at + q * kChunkBytes, m_dy3, bar, 0, hd, kTile * i,
                    q * bnc + bc);
    };
    if (!is_g) {
      if (k < 3) {  // dS's part k, every column chunk
        mbar_expect_tx(bar, NCH * kChunkBytes);
        for (int ch = 0; ch < NCH; ++ch)
          tma_load_4d(st + ch * kChunkBytes, m_ds3, bar, 64 * ch, 0, 0,
                      (k * bnc + bc) * h + head0);
      } else if ((k - 3) % 2 == 0) {
        load_c(j + (k - 3) / 2);
      } else {
        mbar_expect_tx(bar, 3 * kChunkBytes);
        load_dy(head0, j + (k - 3) / 2, 0);
      }
      return;
    }
    const int per_pair = 1 + nheads;
    if (k < n_pairs * per_pair) {
      const int i = j + k / per_pair, e = k % per_pair;
      if (e == 0) {
        load_c(i);
      } else {  // x of head e - 1 at the block's rows, dy's parts at s
        mbar_expect_tx(bar, 4 * kChunkBytes);
        tma_load_4d(st, m_x, bar, 0, head0 + e - 1, t0, bc);
        load_dy(head0 + e - 1, i, kChunkBytes);
      }
    } else {  // x and dS's parts of column chunk ch, head hh
      const int kz = k - n_pairs * per_pair;
      const int ch = kz / nheads, hh = kz % nheads;
      mbar_expect_tx(bar, 4 * kChunkBytes);
      tma_load_4d(st, m_x, bar, 0, head0 + hh, t0, bc);
      for (int q = 0; q < 3; ++q)
        tma_load_4d(st + (1 + q) * kChunkBytes, m_ds3, bar, 64 * ch, 0, 0,
                    (q * bnc + bc) * h + head0 + hh);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(own_bar, (NCH + (is_g ? 0 : 1)) * kChunkBytes);
    for (int ch = 0; ch < NCH; ++ch)
      tma_load_4d(b_own + ch * kChunkBytes, &tm_b, own_bar, 64 * ch, grp, t0,
                  bc);
    if (!is_g) tma_load_4d(x_own, &tm_x, own_bar, 0, head0, t0, bc);
    for (int k = 0; k < kStages && k < n_items; ++k) issue(k);
  }
  int it = 0;  // the next item of the sequence
  auto acquire = [&]() -> unsigned char* {
    mbar_wait(&full[it % kStages], (it / kStages) & 1);
    return ring + (it % kStages) * kStageBytes;
  };
  auto release = [&]() {
    __syncthreads();  // every warp is done with the stage
    if (tid == 0 && it + kStages < n_items) issue(it + kStages);
    ++it;
  };

  const int warp = tid / 32, lane = tid % 32;
  const int t4 = lane % 4;
  const int m0 = 16 * warp + lane / 4;  // rows m0 and m0 + 8 of a product
  const int ta = t0 + m0, tb = ta + 8;  // the thread's positions t
  const size_t pos0 = static_cast<size_t>(bc) * c;
  const uint32_t b_addr = smem_u32(b_own);

  if (!is_g) {
    // ------------------------------------------------------- dx block
    const int head = head0;
    float* cum_s = fl;            // cum and dt of the head over the chunk
    float* dt_s = fl + kTcMaxC;
    float* red = dt_s + kTcMaxC;  // 64: the rows' dw w
    for (int q = tid; q < cp; q += kTcThreads) {
      const bool in = q < c;
      const size_t at = (pos0 + q) * h + head;
      cum_s[q] = in ? cum[at] : 0.f;
      dt_s[q] = in ? dt[at] : 0.f;
    }
    __syncthreads();
    const float total = cum_s[c - 1];
    mbar_wait(own_bar, 0);
    // u = B dS^T over dS's three parts, in the dx accumulator
    float acc[32];
    zero(acc);
    for (int q = 0; q < 3; ++q) {
      add_scores<NCH>(acc, b_addr, smem_u32(acquire()));
      release();
    }
    // dw[t] = x[t] . u[t] (each row over its four lanes), dx = w u
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(x_own);
    float dw0 = 0.f, dw1 = 0.f;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int row = m0 + ((e & 2) ? 8 : 0);
      const float xv =
          __bfloat162float(xs[swz(row, 8 * (e / 4) + 2 * t4 + (e & 1))]);
      if (e & 2)
        dw1 = fmaf(xv, acc[e], dw1);
      else
        dw0 = fmaf(xv, acc[e], dw0);
    }
#pragma unroll
    for (int m = 1; m < 4; m <<= 1) {
      dw0 += __shfl_xor_sync(0xffffffffu, dw0, m);
      dw1 += __shfl_xor_sync(0xffffffffu, dw1, m);
    }
    const float ct0 = cum_s[ta], ct1 = cum_s[tb];
    const float dt0 = dt_s[ta], dt1 = dt_s[tb];
    const float w0 = ta < c ? expf(total - ct0) * dt0 : 0.f;
    const float w1 = tb < c ? expf(total - ct1) * dt1 : 0.f;
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] *= (e & 2) ? w1 : w0;

    for (int i = j; i < nt; ++i) {
      const int s0 = kTile * i;
      float v[32];  // M^T: rows t, columns s
      zero(v);
      add_scores<NCH>(v, b_addr, smem_u32(acquire()));
      release();
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int t = (e & 2) ? tb : ta;
        const int s = s0 + 8 * (e / 4) + 2 * t4 + (e & 1);
        v[e] = t <= s && s < c
                   ? v[e] * expf(cum_s[s] - ((e & 2) ? ct1 : ct0)) *
                         ((e & 2) ? dt1 : dt0)
                   : 0.f;
      }
      uint32_t a[3][4][4];
      split_fragments(v, a);
      const uint32_t d = smem_u32(acquire());  // dy's parts hi, mid, lo
      wgmma_fence();
      // the six kept terms: (M part, dy part) with orders adding to <= 2
      dx_term<2, 0>(acc, a, d);
      dx_term<1, 1>(acc, a, d);
      dx_term<0, 2>(acc, a, d);
      dx_term<1, 0>(acc, a, d);
      dx_term<0, 1>(acc, a, d);
      dx_term<0, 0>(acc, a, d);
      wgmma_commit();
      wgmma_wait_all();
      pin<32>(acc);
      release();
    }
    // dx rows ta and tb (not past c); dw and the tile's sum of dw w
    const size_t x_row = static_cast<size_t>(h) * kTcP;
    __nv_bfloat16* dxb = dx + pos0 * x_row + static_cast<size_t>(head) * kTcP;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int t = hh ? tb : ta;
      if (t >= c) continue;
      __nv_bfloat16* row = dxb + static_cast<size_t>(t) * x_row;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<uint32_t*>(row + 8 * i + 2 * t4) =
            pack_bf16(acc[4 * i + 2 * hh], acc[4 * i + 2 * hh + 1]);
    }
    const size_t cell = static_cast<size_t>(bc) * h + head;
    if (t4 == 0) {
      scr.dw[cell * cp + ta] = dw0;
      scr.dw[cell * cp + tb] = dw1;
      red[m0] = dw0 * w0;
      red[m0 + 8] = dw1 * w1;
    }
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int q = 0; q < kTile; ++q) s += red[q];
      scr.tot[cell * nt + j] = s;
    }
    return;
  }

  // ----------------------------------------------------------- G block
  float* cum_s = fl + P::CUM;  // [hh][256]: cum of the slice's heads
  float* dt_s = fl + P::DT;    // [hh][64]: dt at the block's rows
  float* q_s = fl + P::QS;     // [hh][64]: row sums of dM (C.B) L
  float* rowp = fl + P::ROWP;  // [hh][warp][64]: column sums of R
  for (int q = tid; q < nheads * cp; q += kTcThreads) {
    const int rr = q / nheads, hh = q % nheads;  // neighbours: heads
    cum_s[hh * kTcMaxC + rr] =
        rr < c ? cum[(pos0 + rr) * h + head0 + hh] : 0.f;
  }
  for (int q = tid; q < nheads * kTile; q += kTcThreads) {
    const int rr = q / nheads, hh = q % nheads;
    dt_s[hh * kTile + rr] =
        t0 + rr < c ? dt[(pos0 + t0 + rr) * h + head0 + hh] : 0.f;
    q_s[hh * kTile + rr] = 0.f;
  }
  __syncthreads();
  mbar_wait(own_bar, 0);
  float* gdst = scr.gsum + (static_cast<size_t>(bc) * nsl + sl) * cp * cp;

  for (int i = j; i < nt; ++i) {
    const int s0 = kTile * i;
    float sc[32];  // B[t] . C[s]: rows t, columns s
    zero(sc);
    add_scores<NCH>(sc, b_addr, smem_u32(acquire()));
    release();
    float gs[32];  // G^T summed over the slice's heads
    zero(gs);
    for (int hh = 0; hh < nheads; ++hh) {
      // x (rows t), dy's parts (rows s)
      const uint32_t st = smem_u32(acquire());
      float dm[32];  // dM^T = x dy^T
      zero(dm);
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < 3; ++q)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Wgmma<64>::ss(dm, kmajor(st, kk),
                        kmajor(st + (1 + q) * kChunkBytes, kk), 1);
      wgmma_commit();
      wgmma_wait_all();
      pin<32>(dm);
      release();
      const float* cm = cum_s + hh * kTcMaxC;
      const float ct0 = cm[ta], ct1 = cm[tb];
      const float dt0 = dt_s[hh * kTile + m0], dt1 = dt_s[hh * kTile + m0 + 8];
      float q0 = 0.f, q1 = 0.f, rc[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) rc[e] = 0.f;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const bool lo_row = (e & 2) != 0;
        const int t = lo_row ? tb : ta;
        const int s = s0 + 8 * (e / 4) + 2 * t4 + (e & 1);
        const float l =
            t <= s && s < c ? expf(cm[s] - (lo_row ? ct1 : ct0)) : 0.f;
        const float dtt = lo_row ? dt1 : dt0;
        const float qv = dm[e] * sc[e] * l;
        if (lo_row)
          q1 += qv;
        else
          q0 += qv;
        gs[e] = fmaf(dm[e] * l, dtt, gs[e]);
        rc[(e / 4) * 2 + (e & 1)] += qv * dtt;
      }
#pragma unroll
      for (int m = 1; m < 4; m <<= 1) {
        q0 += __shfl_xor_sync(0xffffffffu, q0, m);
        q1 += __shfl_xor_sync(0xffffffffu, q1, m);
      }
      if (t4 == 0) {
        q_s[hh * kTile + m0] += q0;
        q_s[hh * kTile + m0 + 8] += q1;
      }
      // the column sums over the warp's 16 rows (a lane's 16 columns
      // summed over the eight lanes of its t4) by halving exchanges: at
      // lane bit 4, 3, 2 a lane keeps half its columns and adds its
      // partner's; lane 4 g8 + t4 ends with columns 8 g8 + 2 t4 + {0, 1}
      // (rc index 2 g8 + {0, 1}): one row of partials a warp
      column_sums(rc, lane);
      *reinterpret_cast<float2*>(rowp + (hh * 4 + warp) * kTile +
                                 8 * (lane / 4) + 2 * t4) =
          make_float2(rc[0], rc[1]);
    }
    // the slice's G tile, stored as (s, t): a warp's store covers four
    // rows s of eight consecutive t
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int t = (e & 2) ? tb : ta;
      const int s = s0 + 8 * (e / 4) + 2 * t4 + (e & 1);
      gdst[static_cast<size_t>(s) * cp + t] = gs[e];
    }
    __syncthreads();  // every warp's column sums are in rowp
    for (int q = tid; q < nheads * kTile; q += kTcThreads) {
      const int hh = q / kTile, col = q % kTile;
      const float* rp = rowp + hh * 4 * kTile + col;
      scr.rowr[((static_cast<size_t>(j) * bnc + bc) * h + head0 + hh) * cp +
               s0 + col] = ((rp[0] + rp[kTile]) + rp[2 * kTile]) +
                           rp[3 * kTile];
    }
  }
  __syncthreads();  // q_s complete
  for (int q = tid; q < nheads * kTile; q += kTcThreads) {
    const int hh = q / kTile, rr = q % kTile;
    scr.q[(static_cast<size_t>(bc) * h + head0 + hh) * cp + t0 + rr] =
        q_s[hh * kTile + rr];
  }
  // the state term of dB at the block's rows: sum over the slice's heads
  // of w_h[t] (x_h dS_h), a column chunk at a time
  float* dbst = scr.dbst + ((static_cast<size_t>(bc) * nsl + sl) * cp + t0) *
                               (64 * NCH);
  for (int ch = 0; ch < NCH; ++ch) {
    float zs[32];
    zero(zs);
    for (int hh = 0; hh < nheads; ++hh) {
      // x, then dS's parts of chunk ch; x's A fragments from the
      // swizzled tile: rows m0, m0 + 8, columns 16 kj + 2 t4 (+ 8)
      const unsigned char* stage = acquire();
      const uint32_t st = smem_u32(stage);
      const __nv_bfloat16* xs =
          reinterpret_cast<const __nv_bfloat16*>(stage);
      uint32_t xa[4][4];
#pragma unroll
      for (int kj = 0; kj < 4; ++kj)
#pragma unroll
        for (int qq = 0; qq < 4; ++qq)
          xa[kj][qq] = *reinterpret_cast<const uint32_t*>(
              xs + swz(m0 + ((qq & 1) ? 8 : 0),
                       16 * kj + ((qq & 2) ? 8 : 0) + 2 * t4));
      float z[32];
      zero(z);
      wgmma_fence();
#pragma unroll
      for (int q = 2; q >= 0; --q)
#pragma unroll
        for (int kj = 0; kj < 4; ++kj)
          Wgmma<64>::rs(z, xa[kj], mnmajor(st + (1 + q) * kChunkBytes, kj),
                        1);
      wgmma_commit();
      wgmma_wait_all();
      pin<32>(z);
      release();
      const float* cm = cum_s + hh * kTcMaxC;
      const float total = cm[c - 1];
      const float w0 =
          ta < c ? expf(total - cm[ta]) * dt_s[hh * kTile + m0] : 0.f;
      const float w1 =
          tb < c ? expf(total - cm[tb]) * dt_s[hh * kTile + m0 + 8] : 0.f;
#pragma unroll
      for (int e = 0; e < 32; ++e)
        zs[e] = fmaf((e & 2) ? w1 : w0, z[e], zs[e]);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float* row = dbst + static_cast<size_t>(m0 + 8 * hh) * (64 * NCH) +
                   64 * ch;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<float2*>(row + 8 * i + 2 * t4) =
            make_float2(zs[4 * i + 2 * hh], zs[4 * i + 2 * hh + 1]);
    }
  }
}

// Launch 3. The first `tile_blocks` blocks: one a (chunk, group, tile j,
// column chunk ch, role), role 0 dC (rows s of tile j) and 1 dB (rows t
// of tile j); then finisher blocks of kTcThreads positions each.
__global__ void __launch_bounds__(kTcThreads)
ssd_bwd_group_kernel(const __grid_constant__ CUtensorMap tm_b,
                 const __grid_constant__ CUtensorMap tm_c,
                 const float* __restrict__ dt, const float* __restrict__ cum,
                 Scratch scr, __nv_bfloat16* __restrict__ dB,
                 __nv_bfloat16* __restrict__ dC, float* __restrict__ ddt,
                 float* __restrict__ dcum, int bnc, int c, int h, int g,
                 int n, int tile_blocks) {
  const int nt = (c + kTile - 1) / kTile, cp = nt * kTile;
  const int tid = threadIdx.x;
  if (static_cast<int>(blockIdx.x) >= tile_blocks) {
    // ------------------------------------------------------ finisher
    const long long idx =
        static_cast<long long>(blockIdx.x - tile_blocks) * kTcThreads + tid;
    if (idx >= static_cast<long long>(bnc) * h * c) return;
    const int pos = static_cast<int>(idx % c);
    const long long cell = idx / c;  // bc * h + head
    const int head = static_cast<int>(cell % h);
    const size_t bc = static_cast<size_t>(cell / h);
    const size_t at = (bc * c + pos) * h + head;
    const float cm = cum[at], dtt = dt[at];
    const float total = cum[(bc * c + c - 1) * h + head];
    const size_t sidx = static_cast<size_t>(cell) * cp + pos;
    const float qq = scr.q[sidx], dww = scr.dw[sidx];
    float rr = 0.f;
    for (int i = 0; i <= pos / kTile; ++i)
      rr += scr.rowr[static_cast<size_t>(i) * bnc * h * cp + sidx];
    const float ew = expf(total - cm), w = ew * dtt;
    ddt[at] = qq + dww * ew;
    float dc = rr - dtt * qq - dww * w;
    if (pos == c - 1) {
      float s = 0.f;
      for (int i = 0; i < nt; ++i) s += scr.tot[cell * nt + i];
      dc += s;
    }
    dcum[at] = dc;
    return;
  }
  extern __shared__ __align__(1024) unsigned char g_smem[];
  unsigned char* tiles =
      g_smem + ((1024 - (smem_u32(g_smem) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(tiles + 4 * kChunkBytes);
  const int nch = n / 64;
  int r = blockIdx.x;
  const int role = r % 2;
  r /= 2;
  const int ch = r % nch;
  r /= nch;
  const int j = r % nt;
  r /= nt;
  const int grp = r % g;
  const int bc = r / g;
  const int hg = h / g;
  const int spg = (hg + kSliceHeads - 1) / kSliceHeads, nsl = g * spg;
  // the tiles of B (dC: i = 0 .. j) or C (dB: i = j .. nt - 1)
  const int i0 = role == 0 ? 0 : j, i1 = role == 0 ? j + 1 : nt;
  if (tid == 0) {
    for (int i = i0; i < i1; ++i) mbar_init(&bars[i - i0], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = i0; i < i1; ++i) {
      mbar_expect_tx(&bars[i - i0], kChunkBytes);
      tma_load_4d(tiles + (i - i0) * kChunkBytes, role == 0 ? &tm_b : &tm_c,
                  &bars[i - i0], 64 * ch, grp, kTile * i, bc);
    }
  }
  __syncthreads();
  const int warp = tid / 32, lane = tid % 32;
  const int t4 = lane % 4;
  const int m0 = 16 * warp + lane / 4;
  const int r0 = kTile * j + m0;  // the block's rows r0 and r0 + 8
  const size_t gsl = static_cast<size_t>(cp) * cp;  // a slice's G
  const float* gbase =
      scr.gsum + (static_cast<size_t>(bc) * nsl + grp * spg) * gsl;
  // sums over the group's slices, in slice order; a slice's 32 loads
  // are issued together (a run-time loop inside each element's sum
  // would wait on one load at a time)
  float acc[32];
  zero(acc);
  if (role == 1) {
    // the slices' state terms
    const size_t sst = static_cast<size_t>(cp) * n;
    const float* sb = scr.dbst +
                      (static_cast<size_t>(bc) * nsl + grp * spg) * sst +
                      64 * ch;
    for (int k = 0; k < spg; ++k) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int row = r0 + ((e & 2) ? 8 : 0);
        const int col = 8 * (e / 4) + 2 * t4 + (e & 1);
        acc[e] += sb[k * sst + static_cast<size_t>(row) * n + col];
      }
    }
  }
  for (int i = i0; i < i1; ++i) {
    // G (rows s, columns t) for dC, G^T (rows t, columns s) for dB
    float v[32];
    zero(v);
    for (int k = 0; k < spg; ++k) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int row = r0 + ((e & 2) ? 8 : 0);
        const int col = kTile * i + 8 * (e / 4) + 2 * t4 + (e & 1);
        v[e] += gbase[k * gsl + (role == 0
                                     ? static_cast<size_t>(row) * cp + col
                                     : static_cast<size_t>(col) * cp + row)];
      }
    }
    uint32_t a[3][4][4];
    split_fragments(v, a);
    mbar_wait(&bars[i - i0], 0);
    const uint32_t tile = smem_u32(tiles + (i - i0) * kChunkBytes);
    wgmma_fence();
#pragma unroll
    for (int q = 2; q >= 0; --q)
#pragma unroll
      for (int kj = 0; kj < 4; ++kj)
        Wgmma<64>::rs(acc, a[q][kj], mnmajor(tile, kj), 1);
    wgmma_commit();
    wgmma_wait_all();
    pin<32>(acc);
  }
  __nv_bfloat16* out = role == 0 ? dC : dB;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r0 + 8 * hh;
    if (row >= c) continue;
    __nv_bfloat16* o = out + ((static_cast<size_t>(bc) * c + row) * g + grp) *
                                 n + 64 * ch;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<uint32_t*>(o + 8 * i + 2 * t4) =
          pack_bf16(acc[4 * i + 2 * hh], acc[4 * i + 2 * hh + 1]);
  }
}

// bytes of the group kernel's dynamic shared memory: up to four tiles,
// their mbarriers, 1 KB to align
constexpr int kGroupSmem = 4 * kChunkBytes + 4 * 8 + 1024;

// The pieces of the tensor-core body's scratch, as offsets from `base`
// into *s (when s is not null); returns the floats they take in all.
size_t carve(float* base, int bnc, int c, int h, int g, int n, Scratch* s) {
  const int nt = (c + kTile - 1) / kTile, cp = nt * kTile;
  const int hg = h / g, nsl = g * ((hg + kSliceHeads - 1) / kSliceHeads);
  const size_t b = bnc, cells = b * h;
  size_t at = 0;
  auto take = [&](size_t floats) {
    const size_t o = at;
    at += round64(floats);
    return o;
  };
  const size_t dy3 = take(3 * b * c * h * kTcP / 2);
  const size_t ds3 = take(3 * cells * kTcP * static_cast<size_t>(n) / 2);
  const size_t gsum = take(b * nsl * cp * cp);
  const size_t dbst = take(b * nsl * cp * static_cast<size_t>(n));
  const size_t rowr = take(static_cast<size_t>(nt) * cells * cp);
  const size_t q = take(cells * cp);
  const size_t dw = take(cells * cp);
  const size_t tot = take(cells * nt);
  if (s != nullptr) {
    s->dy3 = reinterpret_cast<__nv_bfloat16*>(base + dy3);
    s->ds3 = reinterpret_cast<__nv_bfloat16*>(base + ds3);
    s->gsum = base + gsum;
    s->dbst = base + dbst;
    s->rowr = base + rowr;
    s->q = base + q;
    s->dw = base + dw;
    s->tot = base + tot;
  }
  return at;
}

template <int NCH>
cudaError_t launch_main(const CUtensorMap& mx, const CUtensorMap& mb,
                        const CUtensorMap& mc, const CUtensorMap& mdy,
                        const CUtensorMap& mds, const float* dt,
                        const float* cum, void* dx, const Scratch& scr,
                        int bnc, int c, int h, int g, cudaStream_t s) {
  constexpr int smem = MainPlan<NCH>::SMEM;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_bwd_main_kernel<NCH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const int nt = (c + kTile - 1) / kTile;
  const int hg = h / g, nsl = g * ((hg + kSliceHeads - 1) / kSliceHeads);
  const long long blocks = static_cast<long long>(bnc) * nt * (nsl + h);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  ssd_bwd_main_kernel<NCH><<<static_cast<int>(blocks), kTcThreads, smem, s>>>(
      mx, mb, mc, mdy, mds, dt, cum, static_cast<__nv_bfloat16*>(dx), scr,
      bnc, c, h, g);
  return cudaGetLastError();
}

cudaError_t launch_wgmma(const void* x, const float* dt, const float* cum,
                         const void* B, const void* C, const float* dy,
                         const float* dS, void* dx, float* ddt, float* dcum,
                         void* dB, void* dC, float* scratch, int bnc, int c,
                         int h, int g, int n, cudaStream_t s) {
  Scratch scr;
  carve(scratch, bnc, c, h, g, n, &scr);
  const long long n_dy = static_cast<long long>(bnc) * c * h * kTcP;
  const long long n_ds = static_cast<long long>(bnc) * h * kTcP * n;
  const long long split_blocks =
      std::min<long long>((n_dy + n_ds + kSplitThreads - 1) / kSplitThreads,
                          132LL * 16);
  ssd_bwd_split_kernel<<<static_cast<int>(split_blocks), kSplitThreads, 0,
                         s>>>(dy, n_dy, dS, n_ds, scr.dy3, scr.ds3);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  CUtensorMap mx, mb, mc, mdy, mds;
  if (!bf16_map(&mx, x, bnc, c, h, kTcP, 64, kTile) ||
      !bf16_map(&mb, B, bnc, c, g, n, 64, kTile) ||
      !bf16_map(&mc, C, bnc, c, g, n, 64, kTile) ||
      !bf16_map(&mdy, scr.dy3, 3 * bnc, c, h, kTcP, 64, kTile) ||
      !bf16_map(&mds, scr.ds3, 3 * bnc * h, kTcP, 1, n, 64, kTile))
    return cudaErrorInvalidValue;
  switch (n / 64) {
    case 1:
      e = launch_main<1>(mx, mb, mc, mdy, mds, dt, cum, dx, scr, bnc, c, h, g,
                         s);
      break;
    case 2:
      e = launch_main<2>(mx, mb, mc, mdy, mds, dt, cum, dx, scr, bnc, c, h, g,
                         s);
      break;
    case 3:
      e = launch_main<3>(mx, mb, mc, mdy, mds, dt, cum, dx, scr, bnc, c, h, g,
                         s);
      break;
    case 4:
      e = launch_main<4>(mx, mb, mc, mdy, mds, dt, cum, dx, scr, bnc, c, h, g,
                         s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return e;
  const int nt = (c + kTile - 1) / kTile;
  const long long tile_blocks =
      static_cast<long long>(bnc) * g * nt * (n / 64) * 2;
  const long long fin_blocks =
      (static_cast<long long>(bnc) * h * c + kTcThreads - 1) / kTcThreads;
  if (tile_blocks + fin_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  ssd_bwd_group_kernel<<<static_cast<int>(tile_blocks + fin_blocks),
                         kTcThreads, kGroupSmem, s>>>(
      mb, mc, dt, cum, scr, static_cast<__nv_bfloat16*>(dB),
      static_cast<__nv_bfloat16*>(dC), ddt, dcum, bnc, c, h, g, n,
      static_cast<int>(tile_blocks));
  return cudaGetLastError();
}

}  // namespace

// The f32 floats of the scratch that ssd_chunk_backward needs on `body`
// at these sizes: the CUDA-core body, each head's dB and dC (2 bnc c h
// n) and a partial sum a tile a cell (bnc h ceil(c / 64)); the wgmma
// body, the pieces of `carve`. -1 for sizes or a body that the entry
// does not take.
extern "C" long long ssd_chunk_backward_scratch_floats(int body, int bnc,
                                                       int c, int h, int g,
                                                       int n) {
  if (bnc < 1 || c < 1 || h < 1 || g < 1 || h % g != 0 || n < 1)
    return -1;
  const size_t cells = static_cast<size_t>(bnc) * h;
  if (body == 0)
    return static_cast<long long>(2 * cells * c * n +
                                  cells * ((c + kTile - 1) / kTile));
  if (body == 1)
    return static_cast<long long>(carve(nullptr, bnc, c, h, g, n, nullptr));
  return -1;
}

// body: 0 = the CUDA-core body, 1 = the tensor-core (wgmma) body.
// x_dtype, bc_dtype: 0 = float32, 1 = bfloat16 (x and dx; B, C, dB and dC;
// B and C in bf16 only with x in bf16). dt, cum, dy, dS, ddt and dcum
// f32. Shapes as the header's; all contiguous; bnc = b * nc; h % g == 0,
// 1 <= p <= 64, 1 <= n <= 256. The wgmma body also needs x, B and C in
// bf16 starting on 16 bytes, p = 64, n % 64 == 0 and c <= 256.
// `scratch`: f32, ssd_chunk_backward_scratch_floats of it. Three
// launches on `stream`; returns the first failing launch's cudaError_t.
extern "C" int ssd_chunk_backward(int body, int x_dtype, int bc_dtype,
                                  const void* x, const void* dt,
                                  const void* cum, const void* B,
                                  const void* C, const void* dy,
                                  const void* dS, void* dx, void* ddt,
                                  void* dcum, void* dB, void* dC,
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
  if (body == 1) {
    const bool aligned =
        ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(B) |
          reinterpret_cast<uintptr_t>(C)) &
         15) == 0;
    if (x_dtype != 1 || bc_dtype != 1 || p != kTcP || n % 64 != 0 ||
        c > kTcMaxC || !aligned)
      return cudaErrorInvalidValue;
    return launch_wgmma(x, dtf, cf, B, C, dyf, dSf, dx, ddtf, dcf, dB, dC,
                        scr, bnc, c, h, g, n, s);
  }
  if (body != 0) return cudaErrorInvalidValue;
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
