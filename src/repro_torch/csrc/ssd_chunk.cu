// The Mamba2 SSD intra-chunk block (K5), hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_chunk.py::
// ssd_chunk_kernel (`_ssd_kernel`, pallas_call at :69), with its
// contract: for each (batch, chunk, head) cell, with x (c, p), dt and
// cum (c,), B and C (c, n) of the head's group,
//   y[s]  = sum_{t <= s} (C[s] . B[t]) exp(cum[s] - cum[t]) dt[t] x[t]
//   S     = sum_t (B[t] exp(cum[c-1] - cum[t]) dt[t]) (x) x[t]  (p x n)
// all in f32. Layout: x (b, nc, c, h, p) in f32 or bf16, B and C
// (b, nc, c, g, n) both f32 or both bf16, and bf16 only with x in bf16
// (every input is widened exactly, as the TPU kernel widens them; no
// f32 copy is made); dt and cum (b, nc, c, h) in f32; head h reads
// group h / (H / g) (the TPU entry takes B and C already repeated over
// the heads); y (b, nc, c, h, p) and the states (b, nc, h, p, n) in
// f32. Each decay is one exponent of a difference, exp(cum[s] -
// cum[t]), never the product exp(cum[s]) exp(-cum[t]): cum falls to
// about -500 over a chunk, and exp(-cum) overflows f32. Weights are
// masked before the exponent, so no masked (positive) difference is
// ever exponentiated.
//
// What bounds it on an H100: operations. A cell does about c^2 n
// (scores, s >= t) + c^2 p (y) + 2 c p n (states) multiply-adds: at
// Mamba2-780M's c 256, n 128, p 64 some 16.8 MFLOP, 6.4 GFLOP over the
// 384 cells of a 2048-token layer, against ~52 MB moved (x, B and C in
// bf16, y and the states in f32). In f32 on the CUDA cores (67 TFLOP/s)
// that is ~0.1 ms; on the tensor cores (989 TFLOP/s bf16) the passes
// below come to ~13 us, under the ~16 us of bytes.
//
// Two bodies; the wrapper (kernels/ssd_chunk.py) picks one by dtype and
// shape class and names it in the entry's `body` argument.
//
// The tensor-core body (ssd_chunk_wgmma_kernel), for the served dtypes:
// x, B and C in bf16, p = 64, n a multiple of 64 up to 256, c <= 256.
// - Exactness: a product of two bf16 values is exact in f32, so the
//   scores C B^T are one bf16 wgmma pass with f32 sums. The f32 weights
//   w[s,t] = (C B^T)[s,t] exp(cum[s] - cum[t]) dt[t] and the decayed B
//   of the state, B[t,k] exp(cum[c-1] - cum[t]) dt[t], are split into
//   three bf16 parts (hi = bf16(w), mid = bf16(w - hi), lo = bf16(w -
//   hi - mid), each rounded to nearest: about 24 bits); each part times
//   x (exact in bf16) is one pass, into the output's accumulator.
// - Blocks: one warpgroup (128 threads), four blocks an SM at n = 64
//   (128 registers a thread) and three above (shared memory, 67 KB a
//   block at n = 128, allows no more). The body is bound by latency, so
//   occupancy counts (scripts/ssd_variants.py times fewer blocks an SM,
//   a rolled score loop, a fresh accumulator a tile and a faster
//   exponent). Every cell
//   gets ceil(c / 64) "y" blocks, one per tile of 64 rows s, and n / 64
//   "state" blocks, one per slice of 64 state columns; each output
//   element has one writer, so nothing needs atomics. The heaviest y
//   tiles go first, the lightest last, the state blocks between them.
// - The body is templated on n / 64, so the scores' k-steps have a
//   compile-time count: the first build, whose loop ran over a run-time
//   n, had ptxas serialise every wgmma of the body (warning C7515).
// - Loads: thread 0 issues TMA copies through 4-D tensor maps over
//   (b nc, c, h | g, p | n), so a tile never crosses into the next chunk
//   and the hardware zero-fills rows past c. A y block loads its 64 rows
//   of C once and streams the tiles t <= its rows of B and x through a
//   ring of two stages (one mbarrier each); a state block streams its
//   64-column slice of B and x over the whole chunk. cum and dt of the
//   cell come into shared memory once, by plain loads (a column of
//   stride h).
// - y: scores as wgmma m64n64k16 over n (C and B K-major, from shared
//   memory); the weights formed in registers, masked before the
//   exponent; their three parts become register A fragments of
//   m64n64k16 against x, MN-major through the transpose bit (as K2
//   reads v).
// - states: S^T (64 state columns x p) = (decayed B)^T x: each thread
//   reads the B values of its A fragment from the swizzled tile, scales
//   them by exp(cum[c-1] - cum[t]) dt[t] and splits them; x is the
//   MN-major B operand, as for y.
// - Layout: every tile is rows of 64 bf16 (128 bytes) in the TMA's
//   128-byte swizzle, B and C as n / 64 column chunks; wgmma reads them
//   with the same swizzle.
//
// The CUDA-core body (ssd_chunk_kernel), for everything else (x or B
// and C in f32, other head dims or state sizes, c > 256): every cell
// gets ceil(c / 64) y blocks and ceil(n / 64) state blocks as above. A y
// block keeps its 64 rows of C in shared memory and walks the tiles of
// 64 positions t <= its last row: each tile's B, x, dt and cum are
// staged, the 64 x 64 weights computed and kept in shared memory, then
// multiplied into the 64 x p output held in registers. A state block
// stages x and the decayed B of each tile and accumulates its p x 64
// slice of the state. 256 threads; each owns a 4 x 4 block of every
// product (rows ty*4 + i, columns tx + 16 j); B and C rows are padded by
// one word against bank conflicts. Plain f32 FMA: TF32 would lose the
// f32 contract, and f32 inputs have no exact bf16 split.

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
  const void* B;     // stride g * n
  const void* C;
  size_t x_row;      // h * p: one position of x and y
  size_t bc_row;     // g * n: one position of B and C
  int c, h, p, n;
};

// x rows t0 .. t0 + 63 (zero past c and past p), widened to f32
template <typename TX>
__device__ __forceinline__ void stage_x(const Cell& cl, int t0, float* xs) {
  const TX* x = static_cast<const TX*>(cl.x);
  for (int i = threadIdx.x; i < kTile * kMaxP; i += kThreads) {
    const int t = i / kMaxP, d = i % kMaxP;
    xs[i] = t0 + t < cl.c && d < cl.p
                ? to_f32(x[static_cast<size_t>(t0 + t) * cl.x_row + d])
                : 0.f;
  }
}

// y rows s0 .. s0 + 63 of the cell
template <typename TX, typename TB>
__device__ void y_tile(const Cell& cl, int s0, float* y, float* smem) {
  const int c = cl.c, n = cl.n, h = cl.h, NS = n + 1;
  const TB* Bg = static_cast<const TB*>(cl.B);
  const TB* Cg = static_cast<const TB*>(cl.C);
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
        s0 + r < c ? to_f32(Cg[static_cast<size_t>(s0 + r) * cl.bc_row + k])
                   : 0.f;
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
      Bs[t * NS + k] =
          t0 + t < c
              ? to_f32(Bg[static_cast<size_t>(t0 + t) * cl.bc_row + k])
              : 0.f;
    }
    stage_x<TX>(cl, t0, xs);
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
    // weights, masked before the exponent
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
template <typename TX, typename TB>
__device__ void state_tile(const Cell& cl, int k0, float* st, float* smem) {
  const int c = cl.c, n = cl.n, h = cl.h;
  const TB* Bg = static_cast<const TB*>(cl.B);
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
    stage_x<TX>(cl, t0, xs);
    for (int r = tid; r < kTile; r += kThreads) {
      const size_t at = static_cast<size_t>(t0 + r) * h;
      wt[r] = t0 + r < c ? expf(total - cl.cum[at]) * cl.dt[at] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < kTile * kTile; i += kThreads) {
      const int t = i / kTile, k = i % kTile;
      bd[i] = t0 + t < c && k0 + k < n
                  ? to_f32(Bg[static_cast<size_t>(t0 + t) * cl.bc_row + k0 +
                              k]) *
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
template <typename TX, typename TB>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const TX* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ cum, const TB* __restrict__ B,
                 const TB* __restrict__ C, float* __restrict__ y,
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
    y_tile<TX, TB>(cl, s0,
                   y + pos0 * cl.x_row + static_cast<size_t>(head) * p, smem);
  } else {
    const int k0 = (role - n_ytiles) * kTile;
    state_tile<TX, TB>(cl, k0, states + static_cast<size_t>(cell) * p * n,
                       smem);
  }
}

template <typename TX, typename TB>
cudaError_t launch_cuda_core(const void* x, const float* dt, const float* cum,
                             const void* B, const void* C, float* y,
                             float* states, int cells, int c, int h, int g,
                             int p, int n, cudaStream_t s) {
  const int n_ytiles = (c + kTile - 1) / kTile;
  const int n_stiles = (n + kTile - 1) / kTile;
  const size_t smem = sizeof(float) * smem_floats(n);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_chunk_kernel<TX, TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(cells, n_ytiles + n_stiles);
  ssd_chunk_kernel<TX, TB><<<grid, kThreads, smem, s>>>(
      static_cast<const TX*>(x), dt, cum, static_cast<const TB*>(B),
      static_cast<const TB*>(C), y, states, c, h, g, p, n, n_ytiles);
  return cudaGetLastError();
}


// ------------------------------- bf16 x, B, C: TMA + wgmma, Hopper only
constexpr int kTcThreads = 128;   // one warpgroup
constexpr int kTcP = 64;          // the head dim the body takes
constexpr int kTcMaxC = 256;      // the chunk lengths it takes
constexpr int kRowBytes = 128;    // a row of 64 bf16: the swizzle span
constexpr int kChunkBytes = kTile * kRowBytes;  // 64 rows x 64 columns

// bytes of dynamic shared memory at state size n: C (n / 64 chunks), two
// stages of B (n / 64 chunks) and x (one), cum and dt of the cell, three
// mbarriers, and 1 KB to align the base to the swizzle pattern
__host__ __device__ constexpr int tc_smem_bytes(int n) {
  return (n / 64 + 2 * (n / 64 + 1)) * kChunkBytes +
         2 * kTcMaxC * static_cast<int>(sizeof(float)) + 3 * 8 + 1024;
}

// blocks an SM the body is built for at n = 64 nch: four fit in shared
// memory at n = 64 (43 KB each), three at 128 (67 KB)
constexpr int tc_blocks_per_sm(int nch) { return nch == 1 ? 4 : 3; }

// grid (b * nc * h cells, n_ytiles + NCH), n = 64 NCH. blockIdx.y:
// first the y blocks of row tiles n_ytiles - 1 .. 1 (heaviest first),
// then the state blocks of column slices 0 .. NCH - 1, then the y block
// of tile 0
template <int NCH>
__global__ void __launch_bounds__(kTcThreads, tc_blocks_per_sm(NCH))
ssd_chunk_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                       const __grid_constant__ CUtensorMap tm_b,
                       const __grid_constant__ CUtensorMap tm_c,
                       const float* __restrict__ dt,
                       const float* __restrict__ cum, float* __restrict__ y,
                       float* __restrict__ states, int c, int h, int g,
                       int n_ytiles) {
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  unsigned char* base =
      tc_smem + ((1024 - (smem_u32(tc_smem) & 1023)) & 1023);
  constexpr int nch = NCH, n = 64 * NCH;
  constexpr int stage_bytes = (nch + 1) * kChunkBytes;  // B chunks, then x
  unsigned char* c_s = base;
  unsigned char* stages = base + nch * kChunkBytes;
  float* cum_s = reinterpret_cast<float*>(stages + 2 * stage_bytes);
  float* dt_s = cum_s + kTcMaxC;  // a state block: exp(total - cum) dt
  uint64_t* full = reinterpret_cast<uint64_t*>(dt_s + kTcMaxC);
  uint64_t* c_bar = full + 2;

  const int cell = blockIdx.x;  // (batch * nc + chunk) * h + head
  const int bc = cell / h, head = cell % h;
  const int grp = head / (h / g);
  const int role = blockIdx.y;
  const bool is_y = role < n_ytiles - 1 || role >= n_ytiles - 1 + nch;
  const int tile = role < n_ytiles - 1 ? n_ytiles - 1 - role
                   : is_y              ? 0
                                       : role - (n_ytiles - 1);
  const int s0 = tile * kTile;   // a y block's rows
  const int k0 = tile * kTile;   // a state block's columns
  const int n_t = is_y ? tile + 1 : n_ytiles;  // tiles of t it walks
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    mbar_init(c_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0: the tile of t positions 64 j into stage j % 2
  const CUtensorMap* map_b = &tm_b;
  const CUtensorMap* map_x = &tm_x;
  auto issue = [=](int j) {
    unsigned char* sb = stages + (j & 1) * stage_bytes;
    uint64_t* bar = &full[j & 1];
    mbar_expect_tx(bar, (is_y ? nch + 1 : 2) * kChunkBytes);
    if (is_y) {
      for (int ch = 0; ch < nch; ++ch)
        tma_load_4d(sb + ch * kChunkBytes, map_b, bar, 64 * ch, grp,
                    kTile * j, bc);
    } else {
      tma_load_4d(sb, map_b, bar, k0, grp, kTile * j, bc);
    }
    tma_load_4d(sb + nch * kChunkBytes, map_x, bar, 0, head, kTile * j, bc);
  };
  if (tid == 0) {
    if (is_y) {
      mbar_expect_tx(c_bar, nch * kChunkBytes);
      for (int ch = 0; ch < nch; ++ch)
        tma_load_4d(c_s + ch * kChunkBytes, &tm_c, c_bar, 64 * ch, grp, s0,
                    bc);
    }
    issue(0);
    if (n_t > 1) issue(1);
  }

  // cum and dt of the positions this block reads (zero past c)
  const int rows = n_t * kTile;
  const size_t pos0 = static_cast<size_t>(bc) * c;  // the chunk's first
  for (int r = tid; r < rows; r += kTcThreads) {
    const bool in = r < c;
    const size_t at = (pos0 + r) * h + head;
    cum_s[r] = in ? cum[at] : 0.f;
    dt_s[r] = in ? dt[at] : 0.f;
  }
  __syncthreads();
  if (!is_y) {
    const float total = cum_s[c - 1];
    for (int r = tid; r < rows; r += kTcThreads)
      dt_s[r] = r < c ? expf(total - cum_s[r]) * dt_s[r] : 0.f;
    __syncthreads();
  }

  const int warp = tid / 32, lane = tid % 32;
  const int t4 = lane % 4;
  const int m0 = 16 * warp + lane / 4;  // rows m0 and m0 + 8 of a product
  const uint32_t c_addr = smem_u32(c_s);
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float cs0 = 0.f, cs1 = 0.f;  // cum of a y block's rows
  if (is_y) {
    cs0 = cum_s[s0 + m0];
    cs1 = cum_s[s0 + m0 + 8];
    mbar_wait(c_bar, 0);
  }

  for (int j = 0; j < n_t; ++j) {
    unsigned char* sb = stages + (j & 1) * stage_bytes;
    const uint32_t b_addr = smem_u32(sb);
    const uint32_t x_addr = b_addr + nch * kChunkBytes;
    const int t0 = kTile * j;
    mbar_wait(&full[j & 1], (j >> 1) & 1);

    float v[32];  // y: the weights (s, t); states: decayed B (t, k)^T
    if (is_y) {
      // scores C B^T over n / 16 k-steps: k-step kk lies in chunk kk / 4,
      // at byte (kk % 4) * 32 of its rows
#pragma unroll
      for (int i = 0; i < 32; ++i) v[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * NCH; ++kk) {
        const uint32_t off = (kk / 4) * kChunkBytes + (kk % 4) * 32;
        Wgmma<64>::ss(v, smem_desc(c_addr + off, 16, 8 * kRowBytes, 1),
                      smem_desc(b_addr + off, 16, 8 * kRowBytes, 1), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin<32>(v);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int row = m0 + ((e & 2) ? 8 : 0);
        const int t = t0 + 8 * (e / 4) + 2 * t4 + (e & 1);
        const int s = s0 + row;
        const float cs = (e & 2) ? cs1 : cs0;
        v[e] = t <= s && s < c ? v[e] * expf(cs - cum_s[t]) * dt_s[t] : 0.f;
      }
    } else {
      // B (t, k0 + m) of the fragment's rows m and positions t, from the
      // swizzled tile: row t at 128 t bytes, its 16-byte chunk m / 8
      // stored at chunk (m / 8) ^ (t % 8)
      const __nv_bfloat16* bt = reinterpret_cast<const __nv_bfloat16*>(sb);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int m = m0 + ((e & 2) ? 8 : 0);
        const int t = 8 * (e / 4) + 2 * t4 + (e & 1);
        const int at = t * 64 + (((m / 8) ^ (t % 8)) * 8) + m % 8;
        v[e] = __bfloat162float(bt[at]) * dt_s[t0 + t];
      }
    }

    // the three passes against x, the smallest part first
    uint32_t a[3][4][4];
    split_fragments(v, a);
    wgmma_fence();
#pragma unroll
    for (int q = 2; q >= 0; --q)
#pragma unroll
      for (int kj = 0; kj < 4; ++kj)
        Wgmma<64>::rs(acc, a[q][kj],
                      smem_desc(x_addr + kj * 16 * kRowBytes, kChunkBytes,
                                8 * kRowBytes, 1),
                      1);
    wgmma_commit();
    wgmma_wait_all();
    pin<32>(acc);

    __syncthreads();  // every warp is done with stage j % 2
    if (tid == 0 && j + 2 < n_t) issue(j + 2);
  }

  if (is_y) {
    // y rows s0 + m0 (acc[4 i + 0, 1]) and s0 + m0 + 8 (acc[4 i + 2, 3]),
    // columns 8 i + 2 t4 + {0, 1}; rows past c are not stored
    const size_t x_row = static_cast<size_t>(h) * kTcP;
    float* yb = y + pos0 * x_row + static_cast<size_t>(head) * kTcP;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int s = s0 + m0 + 8 * hh;
      if (s >= c) continue;
      float* yr = yb + static_cast<size_t>(s) * x_row;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<float2*>(yr + 8 * i + 2 * t4) =
            make_float2(acc[4 * i + 2 * hh], acc[4 * i + 2 * hh + 1]);
    }
  } else {
    // the accumulator is S^T: rows k0 + m0 (+ 8), columns d = 8 i + 2 t4
    // + {0, 1}, stored as S (p, n)
    float* sp = states + static_cast<size_t>(cell) * kTcP * n + k0;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = m0 + 8 * hh;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int d = 8 * i + 2 * t4;
        sp[static_cast<size_t>(d) * n + m] = acc[4 * i + 2 * hh];
        sp[static_cast<size_t>(d + 1) * n + m] = acc[4 * i + 2 * hh + 1];
      }
    }
  }
}

template <int NCH>
cudaError_t launch_wgmma_n(const CUtensorMap& mx, const CUtensorMap& mb,
                           const CUtensorMap& mc, const float* dt,
                           const float* cum, float* y, float* states, int bnc,
                           int c, int h, int g, cudaStream_t s) {
  constexpr int smem = tc_smem_bytes(64 * NCH);
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_chunk_wgmma_kernel<NCH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const int n_ytiles = (c + kTile - 1) / kTile;
  const dim3 grid(bnc * h, n_ytiles + NCH);
  ssd_chunk_wgmma_kernel<NCH><<<grid, kTcThreads, smem, s>>>(
      mx, mb, mc, dt, cum, y, states, c, h, g, n_ytiles);
  return cudaGetLastError();
}

cudaError_t launch_wgmma(const void* x, const float* dt, const float* cum,
                         const void* B, const void* C, float* y,
                         float* states, int bnc, int c, int h, int g, int n,
                         cudaStream_t s) {
  CUtensorMap mx, mb, mc;
  if (!bf16_map(&mx, x, bnc, c, h, kTcP, 64, kTile) ||
      !bf16_map(&mb, B, bnc, c, g, n, 64, kTile) ||
      !bf16_map(&mc, C, bnc, c, g, n, 64, kTile))
    return cudaErrorInvalidValue;
  switch (n / 64) {
    case 1:
      return launch_wgmma_n<1>(mx, mb, mc, dt, cum, y, states, bnc, c, h, g,
                               s);
    case 2:
      return launch_wgmma_n<2>(mx, mb, mc, dt, cum, y, states, bnc, c, h, g,
                               s);
    case 3:
      return launch_wgmma_n<3>(mx, mb, mc, dt, cum, y, states, bnc, c, h, g,
                               s);
    case 4:
      return launch_wgmma_n<4>(mx, mb, mc, dt, cum, y, states, bnc, c, h, g,
                               s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// body: 0 = the CUDA-core body, 1 = the tensor-core (wgmma) body.
// x_dtype, bc_dtype: 0 = float32, 1 = bfloat16 (of x; of B and C); B
// and C in bf16 need x in bf16.
// x (b, nc, c, h, p); dt, cum (b, nc, c, h) f32; B, C (b, nc, c, g, n),
// all contiguous; y (b, nc, c, h, p) and states (b, nc, h, p, n) f32,
// contiguous. bnc = b * nc; h % g == 0, 1 <= p <= 64, 1 <= n <= 256.
// The wgmma body also needs x, B and C in bf16 starting on 16 bytes,
// p = 64, n % 64 == 0 and c <= 256. Returns the launch's cudaError_t.
extern "C" int ssd_chunk(int body, int x_dtype, int bc_dtype, const void* x,
                         const void* dt, const void* cum, const void* B,
                         const void* C, void* y, void* states, int bnc, int c,
                         int h, int g, int p, int n, void* stream) {
  if (bnc < 1 || c < 1 || h < 1 || g < 1 || h % g != 0 || p < 1 ||
      p > kMaxP || n < 1 || n > kMaxN || ((x_dtype | bc_dtype) & ~1) != 0 ||
      static_cast<long long>(bnc) * h > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* cf = static_cast<const float*>(cum);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(states);
  const int cells = bnc * h;
  if (body == 1) {
    const bool aligned =
        ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(B) |
          reinterpret_cast<uintptr_t>(C)) &
         15) == 0;
    if (x_dtype != 1 || bc_dtype != 1 || p != kTcP || n % 64 != 0 ||
        c > kTcMaxC || !aligned)
      return cudaErrorInvalidValue;
    return launch_wgmma(x, dtf, cf, B, C, yf, sf, bnc, c, h, g, n, s);
  }
  if (body != 0) return cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  switch (x_dtype * 2 + bc_dtype) {
    case 0:
      return launch_cuda_core<float, float>(x, dtf, cf, B, C, yf, sf, cells,
                                            c, h, g, p, n, s);
    case 2:
      return launch_cuda_core<bf, float>(x, dtf, cf, B, C, yf, sf, cells, c,
                                         h, g, p, n, s);
    case 3:
      return launch_cuda_core<bf, bf>(x, dtf, cf, B, C, yf, sf, cells, c, h,
                                      g, p, n, s);
  }
  return cudaErrorInvalidValue;
}
