// The gradient of causal or bidirectional GQA attention (K2's backward),
// hand-written for Hopper (sm_90a).
//
// Replaces what `jax.grad` derives from the JAX model's attention,
// src/repro/models/layers.py::chunked_attention (:251): the JAX package
// has no backward Pallas kernel and differentiates the plain online
// softmax. Contract, with q (B, S, H, D), k and v (B, T, KVH, D), H =
// KVH * G, o = attention(q, k, v) and do its gradient (B, S, H, D), lse
// the forward's log-sum-exp (B, H, S) f32 (flash_attention.cu):
//   P_ij  = exp(scale * q_i . k_j - lse_i)   (j < T, and j <= i if causal)
//   Dl_i  = sum_d do_id o_id
//   dS_ij = P_ij (do_i . v_j - Dl_i)
//   dq_i  = scale sum_j dS_ij k_j
//   dk_j  = scale sum_{i, heads h of kv head j's group} dS_ij q_i
//   dv_j  = sum_{i, heads of the group} P_ij do_i
// in f32, each output cast once to q's type. f32 or bf16; D in {32, 64,
// 80, 128} (80: the hybrid family's shared block).
//
// What bounds it on an H100: operations. Each visible (i, j) pair costs
// 4 D multiply-adds in the dk/dv pass and 3 D in the dq pass (the scores
// and do . v are formed in both), about 3.5 times the forward's 2 D; the
// bound in the kernels line counts 2.5 times the forward's, the work
// without the recomputed scores, at the tensor cores' rate (this design's
// own floor, with the recomputation, is 3.5 times).
//
// What the design does about it: three launches, and nothing accumulated
// with atomics, so that a step is bitwise repeatable. `delta_kernel` forms
// Dl (16-byte loads, a group of lanes a row); the dk/dv pass owns a tile
// of k/v positions of one kv head and walks, for each of the G query heads
// that share it, the q tiles that can see it (from the diagonal on when
// causal), so that dk and dv sum the G heads in registers; the dq pass
// owns a tile of q rows of one head and walks the k tiles up to the
// diagonal. No block writes what another writes.
//
// bf16 (`dkdv_wgmma_kernel`, `dq_wgmma_kernel`): the forward's parts
// (flash_attention.cu): one block of three warpgroups, a producer that
// gives up registers (setmaxnreg) and issues TMA copies through 4-D tensor
// maps over (B, S|T, H|KVH, D) that zero-fill the ragged edges, a ring of
// STAGES buffers with "full" and "empty" mbarriers, and two consumer
// warpgroups of 64 rows each; tiles stored as swizzled column chunks of
// CW elements (128-byte chunks where D is a multiple of 64, 64 bytes at D
// = 32, 32 bytes for a D such as 80), read by wgmma with that swizzle.
// - dk/dv: a block owns 128 k/v positions (k and v come in once); q, do
//   and the rows' lse and Dl stream through the ring in tiles of 64, for
//   each head of the group. S^T = K Q^T and dP^T = V dO^T are wgmmas with
//   both operands in shared memory, K-major in their natural layout;
//   P^T = exp(scale S^T - lse) and dS^T = P^T (dP^T - Dl) are formed in
//   the accumulators' registers (P in f32 for dS), rounded to bf16 and
//   become the register A operands of dV += P^T dO and dK += dS^T Q,
//   whose B operands, dO and Q in their natural (i, d) layout, are read
//   MN-major through wgmma's transpose bit. The blocks of the first
//   (heaviest, when causal) k tiles are launched first.
// - dq: a block owns 128 q rows (q and do come in once, with each row's
//   lse and Dl in registers); k and v stream in tiles of 64. S = Q K^T
//   and dP = dO V^T in shared memory, dS in registers, dQ += dS K with K
//   read MN-major. The causal stop and the masks of the diagonal and
//   ragged tiles as in the forward; the last q tiles are launched first.
// - lse and Dl reach the dk/dv pass by one bulk copy a tile: delta_kernel
//   writes them (lse times log2(e), for exp2) into a scratch padded to
//   whole tiles, its padding rows with lse = +inf and Dl = 0 (weight 0).
// The rounding of P and dS to bf16 (at most 2^-8 of each) is the one this
// body adds to the plain version's; `backward_round_terms` in
// kernels/flash_attention.py bounds what it can move each output.
//
// f32 has no tensor-core path at its precision and runs on the CUDA
// cores (`dkdv_kernel`, `dq_kernel`: tiles of 64 a block): 256 threads a
// block; each thread computes a 4 x 4 block of the 64 x 64 score and
// do . v tiles (rows ty * 4 + i, columns tx + 16 j, as the forward's f32
// body), and owns a 4 x D/16 block of its accumulators; tiles staged in
// shared memory, rows padded by one 4-byte word against bank conflicts;
// P and dS through shared memory for the products that contract over the
// other index.

#include <cstdint>
#include <type_traits>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dtype.cuh"
#include "mbarrier.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kB = 64;  // rows of a q tile and positions of a k/v tile
constexpr int kThreads = 256;
constexpr int kPS = kB + 1;  // row stride of the f32 P and dS tiles

template <typename T>
__host__ __device__ constexpr int padded(int D) {
  return D + 4 / static_cast<int>(sizeof(T));
}

// elements d and d + 1 of a staged f32 row (d even)
__device__ __forceinline__ float2 pair2(const float* row, int d) {
  return make_float2(row[d], row[d + 1]);
}

// rows [r0, r0 + kB) of a (.., rows, heads, D) tensor at head `head` into a
// padded tile; rows at or past `n` are zero
template <typename T, int D>
__device__ __forceinline__ void stage(T* dst, const T* src, size_t row_pitch,
                                      int r0, int n) {
  constexpr int QS = padded<T>(D);
  for (int i = threadIdx.x; i < kB * D; i += kThreads) {
    const int r = i / D, d = i % D;
    dst[r * QS + d] =
        r0 + r < n ? src[(r0 + r) * row_pitch + d] : from_f32<T>(0.f);
  }
}

// The two 4 x 4 blocks of a tile pair: s = a_rows . b_cols and t =
// c_rows . e_cols over D, rows ty * 4 + i of a and c, columns tx + 16 j
// of b and e (all padded tiles in shared memory)
template <typename T, int D>
__device__ __forceinline__ void two_products(const T* a, const T* b,
                                             const T* c, const T* e,
                                             float (&s)[4][4],
                                             float (&t)[4][4], int ty,
                                             int tx) {
  constexpr int QS = padded<T>(D);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = t[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 2) {
    float2 av[4], bv[4], cv[4], ev[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = pair2(a + (ty * 4 + i) * QS, d);
      cv[i] = pair2(c + (ty * 4 + i) * QS, d);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bv[j] = pair2(b + (tx + 16 * j) * QS, d);
      ev[j] = pair2(e + (tx + 16 * j) * QS, d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] += av[i].x * bv[j].x + av[i].y * bv[j].y;
        t[i][j] += cv[i].x * ev[j].x + cv[i].y * ev[j].y;
      }
  }
}

// VE elements of T loaded or stored as one access
template <typename T, int VE>
struct alignas(VE * sizeof(T)) Vec {
  T e[VE];
};

// the lanes a row of delta_kernel: D / VE 16-byte accesses (VE = 16 /
// sizeof(T) elements), rounded up to a power of two so that a row's lanes
// are a shuffle group (at D = 80: 10 accesses on 16 lanes in bf16, 20 on
// 32 in f32; the lanes past the row's end add 0)
template <typename T, int D>
__host__ __device__ constexpr int delta_lanes() {
  int l = 1;
  while (l * static_cast<int>(16 / sizeof(T)) < D) l *= 2;
  return l;
}

// Dl[b, h, i] = sum_d do[b, i, h, d] o[b, i, h, d]: LPR = delta_lanes
// lanes a row (one 16-byte access of each tensor a lane, VE elements),
// 32 / LPR rows a warp, the rows' sums by shuffles inside the lane
// group. Without PAD (the f32 body) Dl goes to delta[(b H + h) S +
// i]. With PAD (the bf16 body) the rows run to S_rows (S rounded up to
// whole blocks) and two (B, H, S_rows) arrays are written: lse * log2(e)
// at delta[(b H + h) S_rows + i] and Dl B H S_rows further on; rows past S
// get lse = +inf and Dl = 0, so that their softmax weights are 0.
template <typename T, int D, bool PAD>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             const float* __restrict__ lse, float* __restrict__ delta, int B,
             int S, int S_rows, int H) {
  constexpr int VE = 16 / sizeof(T);
  constexpr int LPR = delta_lanes<T, D>();
  static_assert(D % VE == 0 && LPR <= 32, "head dim");
  const long long gid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long n = static_cast<long long>(B) * S_rows * H;
  const long long r = gid / LPR;  // (b, i, h), h fastest
  const int part = static_cast<int>(gid % LPR);
  // a lane past the last row still takes part in its group's shuffles
  const bool live = r < n;
  const int h = static_cast<int>(r % H);
  const int i = static_cast<int>((r / H) % S_rows);
  const int b = static_cast<int>(r / (static_cast<long long>(H) * S_rows));
  float acc = 0.f;
  if (live && i < S && part * VE < D) {
    const size_t at = ((static_cast<size_t>(b) * S + i) * H + h) * D +
                      part * VE;
    const Vec<T, VE> ov = *reinterpret_cast<const Vec<T, VE>*>(o + at);
    const Vec<T, VE> dv = *reinterpret_cast<const Vec<T, VE>*>(dout + at);
#pragma unroll
    for (int e = 0; e < VE; ++e) acc += to_f32(ov.e[e]) * to_f32(dv.e[e]);
  }
#pragma unroll
  for (int m = LPR / 2; m > 0; m >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (!live || part != 0) return;
  const size_t row = (static_cast<size_t>(b) * H + h) * S_rows + i;
  if constexpr (PAD) {
    const size_t n_rows = static_cast<size_t>(B) * H * S_rows;
    // a padding row: weight 0
    delta[row] = i < S ? lse[(static_cast<size_t>(b) * H + h) * S + i] *
                             1.4426950408889634f
                       : __int_as_float(0x7f800000);
    delta[n_rows + row] = i < S ? acc : 0.f;
  } else {
    delta[row] = acc;
  }
}

// P (f32) of rows ty * 4 + i, columns tx + 16 j of the (q0, k0) tile pair
// from its scores, and dS from do . v; both stored in shared memory
__device__ __forceinline__ void weights(const float (&s)[4][4],
                                        const float (&t)[4][4],
                                        const float* lse_s, const float* dl_s,
                                        float* p_s, float* ds_s, int q0,
                                        int k0, int S, int T_len, int causal,
                                        float scale, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const bool ok = q0 + r < S && k0 + c < T_len &&
                      (!causal || k0 + c <= q0 + r);
      const float p = ok ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
      if (p_s != nullptr) p_s[r * kPS + c] = p;
      ds_s[r * kPS + c] = p * (t[i][j] - dl_s[r]);
    }
  }
}

// One block a (k/v tile of kB positions, kv head, batch row): dk and dv of
// the tile, summed over the G query heads of the kv head and over the q
// tiles that see it.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int S, int T_len, int H,
            int KVH, float scale, int causal) {
  constexpr int QS = padded<T>(D);
  constexpr int NC = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);  // kB x QS each
  T* v_s = k_s + kB * QS;
  T* q_s = v_s + kB * QS;
  T* do_s = q_s + kB * QS;
  float* p_s = reinterpret_cast<float*>(do_s + kB * QS);  // kB x kPS
  float* ds_s = p_s + kB * kPS;
  float* lse_s = ds_s + kB * kPS;  // kB
  float* dl_s = lse_s + kB;        // kB

  const int k0 = blockIdx.x * kB;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KVH;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t q_row = static_cast<size_t>(H) * D;
  const size_t kv_row = static_cast<size_t>(KVH) * D;
  const T* k_b = k + static_cast<size_t>(b) * T_len * kv_row + kvh * D;
  const T* v_b = v + static_cast<size_t>(b) * T_len * kv_row + kvh * D;
  stage<T, D>(k_s, k_b, kv_row, k0, T_len);
  stage<T, D>(v_s, v_b, kv_row, k0, T_len);

  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // causal: rows i >= k0 only
  const int q_first = causal ? (k0 / kB) * kB : 0;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const T* q_b = q + static_cast<size_t>(b) * S * q_row + h * D;
    const T* do_b = dout + static_cast<size_t>(b) * S * q_row + h * D;
    const float* lse_b = lse + (static_cast<size_t>(b) * H + h) * S;
    const float* dl_b = delta + (static_cast<size_t>(b) * H + h) * S;
    for (int q0 = q_first; q0 < S; q0 += kB) {
      __syncthreads();  // the previous q tile is no longer read
      stage<T, D>(q_s, q_b, q_row, q0, S);
      stage<T, D>(do_s, do_b, q_row, q0, S);
      for (int r = tid; r < kB; r += kThreads) {
        lse_s[r] = q0 + r < S ? lse_b[q0 + r] : 0.f;
        dl_s[r] = q0 + r < S ? dl_b[q0 + r] : 0.f;
      }
      __syncthreads();
      float s[4][4], t[4][4];
      two_products<T, D>(q_s, k_s, do_s, v_s, s, t, ty, tx);
      weights(s, t, lse_s, dl_s, p_s, ds_s, q0, k0, S, T_len, causal, scale,
              ty, tx);
      __syncthreads();
      // dv[c] += sum_r P[r, c] do[r]; dk[c] += sum_r dS[r, c] q[r]: the
      // thread's k rows are ty * 4 + i, its columns tx + 16 j
      const int tq = min(kB, S - q0);
      for (int r = 0; r < tq; ++r) {
        float pr[4], dsr[4], dov[NC], qv[NC];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pr[i] = p_s[r * kPS + ty * 4 + i];
          dsr[i] = ds_s[r * kPS + ty * 4 + i];
        }
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          dov[j] = to_f32(do_s[r * QS + tx + 16 * j]);
          qv[j] = to_f32(q_s[r * QS + tx + 16 * j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NC; ++j) {
            dv_acc[i][j] += pr[i] * dov[j];
            dk_acc[i][j] += dsr[i] * qv[j];
          }
      }
    }
  }
  T* dk_b = dk + static_cast<size_t>(b) * T_len * kv_row + kvh * D;
  T* dv_b = dv + static_cast<size_t>(b) * T_len * kv_row + kvh * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty * 4 + i;
    if (c >= T_len) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      dk_b[c * kv_row + tx + 16 * j] = from_f32<T>(dk_acc[i][j] * scale);
      dv_b[c * kv_row + tx + 16 * j] = from_f32<T>(dv_acc[i][j]);
    }
  }
}

// One block a (q tile of kB rows, head, batch row): dq of the tile over
// the k tiles it sees.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int S, int T_len, int H, int KVH, float scale,
          int causal) {
  constexpr int QS = padded<T>(D);
  constexpr int NC = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);  // kB x QS each
  T* do_s = q_s + kB * QS;
  T* k_s = do_s + kB * QS;
  T* v_s = k_s + kB * QS;
  float* ds_s = reinterpret_cast<float*>(v_s + kB * QS);  // kB x kPS
  float* lse_s = ds_s + kB * kPS;
  float* dl_s = lse_s + kB;

  const int q0 = blockIdx.x * kB;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t q_row = static_cast<size_t>(H) * D;
  const size_t kv_row = static_cast<size_t>(KVH) * D;
  const T* q_b = q + static_cast<size_t>(b) * S * q_row + h * D;
  const T* do_b = dout + static_cast<size_t>(b) * S * q_row + h * D;
  const T* k_b = k + static_cast<size_t>(b) * T_len * kv_row + kvh * D;
  const T* v_b = v + static_cast<size_t>(b) * T_len * kv_row + kvh * D;
  const float* lse_b = lse + (static_cast<size_t>(b) * H + h) * S;
  const float* dl_b = delta + (static_cast<size_t>(b) * H + h) * S;
  stage<T, D>(q_s, q_b, q_row, q0, S);
  stage<T, D>(do_s, do_b, q_row, q0, S);
  for (int r = tid; r < kB; r += kThreads) {
    lse_s[r] = q0 + r < S ? lse_b[q0 + r] : 0.f;
    dl_s[r] = q0 + r < S ? dl_b[q0 + r] : 0.f;
  }

  float dq_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) dq_acc[i][j] = 0.f;

  const int k_end = causal ? min(T_len, q0 + kB) : T_len;
  for (int k0 = 0; k0 < k_end; k0 += kB) {
    __syncthreads();  // the previous k tile is no longer read
    stage<T, D>(k_s, k_b, kv_row, k0, T_len);
    stage<T, D>(v_s, v_b, kv_row, k0, T_len);
    __syncthreads();
    float s[4][4], t[4][4];
    two_products<T, D>(q_s, k_s, do_s, v_s, s, t, ty, tx);
    weights(s, t, lse_s, dl_s, nullptr, ds_s, q0, k0, S, T_len, causal,
            scale, ty, tx);
    __syncthreads();
    // dq[r] += sum_c dS[r, c] k[c]: rows ty * 4 + i, columns tx + 16 j
    const int tk = min(kB, T_len - k0);
    for (int c = 0; c < tk; ++c) {
      float dsr[4], kv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsr[i] = ds_s[(ty * 4 + i) * kPS + c];
#pragma unroll
      for (int j = 0; j < NC; ++j) kv[j] = to_f32(k_s[c * QS + tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) dq_acc[i][j] += dsr[i] * kv[j];
    }
  }
  T* dq_b = dq + static_cast<size_t>(b) * S * q_row + h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= S) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j)
      dq_b[r * q_row + tx + 16 * j] = from_f32<T>(dq_acc[i][j] * scale);
  }
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// the CUDA-core body (f32)
template <typename T, int D>
cudaError_t launch_cores(const void* q, const void* k, const void* v,
                         const void* o, const void* dout, const float* lse,
                         float* delta, void* dq, void* dk, void* dv, int B,
                         int S, int T_len, int H, int KVH, float scale,
                         int causal, cudaStream_t s) {
  constexpr int QS = padded<T>(D);
  const T* q_t = static_cast<const T*>(q);
  const T* k_t = static_cast<const T*>(k);
  const T* v_t = static_cast<const T*>(v);
  const T* do_t = static_cast<const T*>(dout);
  const long long rows = static_cast<long long>(B) * S * H;
  const long long blocks =
      (rows * delta_lanes<T, D>() + kThreads - 1) / kThreads;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  delta_kernel<T, D, false><<<static_cast<int>(blocks), kThreads, 0, s>>>(
      static_cast<const T*>(o), do_t, lse, delta, B, S, S, H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const size_t tiles = sizeof(T) * 4 * kB * QS;
  const size_t smem_kv = tiles + sizeof(float) * (2 * kB * kPS + 2 * kB);
  const size_t smem_q = tiles + sizeof(float) * (kB * kPS + 2 * kB);
  if ((e = allow_smem(dkdv_kernel<T, D>, smem_kv)) != cudaSuccess) return e;
  if ((e = allow_smem(dq_kernel<T, D>, smem_q)) != cudaSuccess) return e;
  dkdv_kernel<T, D><<<dim3((T_len + kB - 1) / kB, KVH, B), kThreads, smem_kv,
                      s>>>(q_t, k_t, v_t, do_t, lse, delta,
                           static_cast<T*>(dk), static_cast<T*>(dv), S,
                           T_len, H, KVH, scale, causal);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  dq_kernel<T, D><<<dim3((S + kB - 1) / kB, H, B), kThreads, smem_q, s>>>(
      q_t, k_t, v_t, do_t, lse, delta, static_cast<T*>(dq), S, T_len, H, KVH,
      scale, causal);
  return cudaGetLastError();
}

// ------------------------------------- bf16: TMA + wgmma, Hopper only
constexpr int kWgThreads = 384;  // producer warpgroup + two consumers
constexpr int kConsumerWarps = 8;
constexpr int kOwn = 128;   // rows a block owns: 64 a consumer warpgroup
constexpr int kTile = 64;   // rows of a streamed tile
constexpr int kBwdSmemBudget = 216 * 1024;

// The shared-memory plan of head dim D (the forward's FaPlan chunks):
// column chunks of CW elements, SW = 2 CW bytes a row, the swizzle span.
// A block's two resident tiles (kOwn rows each: k and v, or q and do),
// then STAGES stages of two streamed tiles (kTile rows each), then, for
// the dk/dv pass, STAGES pairs of rows (lse and Dl of a tile, f32), then
// the mbarriers. Every tile starts on a multiple of its swizzle pattern
// (8 rows x SW bytes).
template <int D, bool ROWS>
struct BwdPlan {
  static constexpr int CW = D % 64 == 0 ? 64 : (D % 32 == 0 ? 32 : 16);
  static constexpr int SW = 2 * CW;
  static constexpr int NCH = D / CW;
  static constexpr uint32_t LAYOUT = SW == 128 ? 1 : (SW == 64 ? 2 : 3);
  static constexpr int OWN_BYTES = kOwn * D * 2;
  static constexpr int TILE_BYTES = kTile * D * 2;
  static constexpr int ROW_BYTES = ROWS ? kTile * 4 : 0;  // one of lse, Dl
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES + 2 * ROW_BYTES;
  static constexpr int STAGES_FIT =
      (kBwdSmemBudget - 2 * OWN_BYTES) / STAGE_BYTES;
  static constexpr int STAGES = STAGES_FIT < 4 ? STAGES_FIT : 4;
  static constexpr int ROWS_OFF = 2 * OWN_BYTES + STAGES * 2 * TILE_BYTES;
  static constexpr int BAR_OFF = ROWS_OFF + STAGES * 2 * ROW_BYTES;
  // + the mbarriers, + 1 KB to align the base
  static constexpr int SMEM = BAR_OFF + (2 * STAGES + 1) * 8 + 1024;
  static_assert(D % 16 == 0 && NCH * CW == D && STAGES >= 2,
                "unsupported head dim");
};

// one bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// the 64 x 64 tile pair of a consumer warpgroup: x = A B^T and y = C E^T
// over D, A and C its 64 rows of a resident tile (kOwn rows a chunk), B
// and E a streamed tile (kTile rows a chunk); all K-major
template <int D>
__device__ __forceinline__ void two_score_tiles(float (&x)[32],
                                                float (&y)[32], uint32_t a,
                                                uint32_t b, uint32_t c,
                                                uint32_t e) {
  using P = BwdPlan<D, false>;
#pragma unroll
  for (int i = 0; i < 32; ++i) x[i] = y[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // k-step kk lies in chunk kk * 16 / CW, at byte (kk * 16 % CW) * 2
    const uint32_t ch = kk * 16 / P::CW, off = (kk * 16 % P::CW) * 2;
    Wgmma<64>::ss(x,
                  smem_desc(a + ch * kOwn * P::SW + off, 16, 8 * P::SW,
                            P::LAYOUT),
                  smem_desc(b + ch * kTile * P::SW + off, 16, 8 * P::SW,
                            P::LAYOUT),
                  1);
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t ch = kk * 16 / P::CW, off = (kk * 16 % P::CW) * 2;
    Wgmma<64>::ss(y,
                  smem_desc(c + ch * kOwn * P::SW + off, 16, 8 * P::SW,
                            P::LAYOUT),
                  smem_desc(e + ch * kTile * P::SW + off, 16, 8 * P::SW,
                            P::LAYOUT),
                  1);
  }
  wgmma_commit();
  wgmma_wait_all();
  pin<32>(x);
  pin<32>(y);
}

// the A fragments (bf16) of the four k-steps of a 64 x 64 accumulator
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4],
                                       const float (&x)[32]) {
#pragma unroll
  for (int kj = 0; kj < 4; ++kj) {
    a[kj][0] = pack_bf16(x[8 * kj], x[8 * kj + 1]);
    a[kj][1] = pack_bf16(x[8 * kj + 2], x[8 * kj + 3]);
    a[kj][2] = pack_bf16(x[8 * kj + 4], x[8 * kj + 5]);
    a[kj][3] = pack_bf16(x[8 * kj + 6], x[8 * kj + 7]);
  }
}

// acc (64 x D) += A (64 x 64, registers) B, B a streamed tile of kTile
// rows (the contraction) by D columns in its natural layout, read
// MN-major: k-step kj's rows at kj * 16 * SW bytes, column chunks kTile *
// SW apart
template <int D>
__device__ __forceinline__ void product_into(float* acc,
                                             const uint32_t (&a)[4][4],
                                             uint32_t b) {
  using P = BwdPlan<D, false>;
#pragma unroll
  for (int kj = 0; kj < 4; ++kj)
    Wgmma<D>::rs(acc, a[kj],
                 smem_desc(b + kj * 16 * P::SW, kTile * P::SW, 8 * P::SW,
                           P::LAYOUT),
                 1);
}

// rows r0 and r0 + 8 of a consumer's 64 x D accumulator, times `mul`, to
// row pitch `pitch` (elements) of `dst`; rows at or past n not stored
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, size_t pitch,
                                           const float* acc, float mul,
                                           int r0, int n, int t4) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r0 + 8 * hh;
    if (row >= n) continue;
    __nv_bfloat16* d = dst + static_cast<size_t>(row) * pitch;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<uint32_t*>(d + 8 * i + 2 * t4) =
          pack_bf16(acc[4 * i + 2 * hh] * mul, acc[4 * i + 2 * hh + 1] * mul);
  }
}

// this warp is done with stage s: one arrival a warp on its "empty"
// barrier
__device__ __forceinline__ void release(uint64_t* empty, int s, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(&empty[s]);
}

// One block a (k/v tile of kOwn positions, kv head, batch row): dk and dv
// of the tile, summed over the G query heads of the kv head and the q
// tiles that see it. `rows` is delta_kernel's padded scratch (lse * log2
// e, then Dl; S_rows a row of heads).
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_do,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const float* __restrict__ rows,
                  __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, int B, int S, int S_rows,
                  int T_len, int H, int KVH, float scale, float scale_log2,
                  int causal) {
  using P = BwdPlan<D, true>;
  extern __shared__ __align__(1024) unsigned char bw_smem[];
  unsigned char* base = bw_smem + ((1024 - (smem_u32(bw_smem) & 1023)) & 1023);
  unsigned char* k_s = base;
  unsigned char* v_s = base + P::OWN_BYTES;
  unsigned char* st = base + 2 * P::OWN_BYTES;  // stage s: q, then do
  float* rows_s = reinterpret_cast<float*>(base + P::ROWS_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + P::BAR_OFF);
  uint64_t* empty = full + P::STAGES;
  uint64_t* kv_bar = empty + P::STAGES;

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * kOwn;  // the first (heaviest) tiles first
  const int G = H / KVH;
  const int n_q = (S + kTile - 1) / kTile;
  // causal: q rows >= k0 only
  const int q_first = causal ? min(k0 / kTile, n_q) : 0;
  const int per_head = n_q - q_first;
  const int n_it = G * per_head;
  // the warpgroup, read through a shuffle so that ptxas knows it is the
  // same in every lane of a warp (a branch on it does not diverge)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // a consumer warpgroup: CW (a compile-time constant, so that every
  // branch around its wgmmas is uniform) picks k rows [64 CW, 64 CW + 64)
  // of the tile
  auto consume = [&](auto cw_c) {
    constexpr int cw = decltype(cw_c)::value;
    const int tid = threadIdx.x - 128;
    const int warp = (tid / 32) % 4, lane = tid % 32;
    const int t4 = lane % 4;
    const int row_lo = k0 + 64 * cw;
    const int r0 = row_lo + 16 * warp + lane / 4;  // and r0 + 8

    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    const uint32_t k_addr = smem_u32(k_s) + 64 * cw * P::SW;
    const uint32_t v_addr = smem_u32(v_s) + 64 * cw * P::SW;
    mbar_wait(kv_bar, 0);

    // every wgmma batch is waited for before the next branch or barrier
    // wait: an accumulator in flight across those makes ptxas serialise
    // the wgmmas (C7520)
    for (int j = 0; j < n_it; ++j) {
      const int s = j % P::STAGES;
      const int i0 = (q_first + j % per_head) * kTile;
      mbar_wait(&full[s], (j / P::STAGES) & 1);
      // causal: a q tile wholly before this warpgroup's k rows sees none
      if (causal && i0 + kTile - 1 < row_lo) {
        release(empty, s, lane);
        continue;
      }
      const uint32_t q_addr = smem_u32(st + s * 2 * P::TILE_BYTES);
      const uint32_t do_addr = q_addr + P::TILE_BYTES;
      // S^T = K Q^T (k rows by q columns), dP^T = V dO^T
      float sc[32], dp[32];
      two_score_tiles<D>(sc, dp, k_addr, q_addr, v_addr, do_addr);
      // P^T = exp2(scale log2(e) S^T - lse log2(e)) and dS^T = P^T (dP^T -
      // Dl), column i0 + 8 (e / 4) + 2 t4 + (e & 1), row r0 (+ 8 where e &
      // 2); zero where the q row cannot see the k row
      const float* lse2 = rows_s + s * 2 * kTile;
      const float* dl = lse2 + kTile;
      const bool masked = causal && i0 < row_lo + 63;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int col = 8 * (e / 4) + 2 * t4 + (e & 1);
        float p = exp2f(fmaf(sc[e], scale_log2, -lse2[col]));
        if (masked && i0 + col < r0 + ((e & 2) ? 8 : 0)) p = 0.f;
        dp[e] = p * (dp[e] - dl[col]);
        sc[e] = p;
      }
      uint32_t pa[4][4], da[4][4];
      pack_a(pa, sc);
      pack_a(da, dp);
      wgmma_fence();
      product_into<D>(dv_acc, pa, do_addr);  // dV += P^T dO
      product_into<D>(dk_acc, da, q_addr);   // dK += dS^T Q
      wgmma_commit();
      wgmma_wait_all();
      pin<D / 2>(dv_acc);
      pin<D / 2>(dk_acc);
      release(empty, s, lane);
    }
    const size_t pitch = static_cast<size_t>(KVH) * D;
    const size_t at = static_cast<size_t>(b) * T_len * pitch + kvh * D;
    store_rows<D>(dk + at, pitch, dk_acc, scale, r0, T_len, t4);
    store_rows<D>(dv + at, pitch, dv_acc, 1.f, r0, T_len, t4);
  };

  if (wg == 0) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_bar, 2 * P::OWN_BYTES);
#pragma unroll
      for (int c = 0; c < P::NCH; ++c) {
        tma_load_4d(k_s + c * kOwn * P::SW, &tm_k, kv_bar, c * P::CW, kvh,
                    k0, b);
        tma_load_4d(v_s + c * kOwn * P::SW, &tm_v, kv_bar, c * P::CW, kvh,
                    k0, b);
      }
      const size_t plane = static_cast<size_t>(B) * H * S_rows;
      for (int j = 0; j < n_it; ++j) {
        const int s = j % P::STAGES;
        const int h = kvh * G + j / per_head;
        const int i0 = (q_first + j % per_head) * kTile;
        if (j >= P::STAGES) mbar_wait(&empty[s], (j / P::STAGES - 1) & 1);
        mbar_expect_tx(&full[s], P::STAGE_BYTES);
        unsigned char* q_dst = st + s * 2 * P::TILE_BYTES;
        unsigned char* do_dst = q_dst + P::TILE_BYTES;
#pragma unroll
        for (int c = 0; c < P::NCH; ++c) {
          tma_load_4d(q_dst + c * kTile * P::SW, &tm_q, &full[s], c * P::CW,
                      h, i0, b);
          tma_load_4d(do_dst + c * kTile * P::SW, &tm_do, &full[s],
                      c * P::CW, h, i0, b);
        }
        const float* src = rows + (static_cast<size_t>(b) * H + h) * S_rows
                           + i0;
        bulk_load(rows_s + s * 2 * kTile, src, P::ROW_BYTES, &full[s]);
        bulk_load(rows_s + s * 2 * kTile + kTile, src + plane, P::ROW_BYTES,
                  &full[s]);
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    if (wg == 1)
      consume(std::integral_constant<int, 0>());
    else
      consume(std::integral_constant<int, 1>());
  }
}

// One block a (q tile of kOwn rows, head, batch row): dq of the tile over
// the k tiles it sees.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_do,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const float* __restrict__ rows,
                __nv_bfloat16* __restrict__ dq, int B, int S, int S_rows,
                int T_len, int H, int KVH, float scale, float scale_log2,
                int causal) {
  using P = BwdPlan<D, false>;
  extern __shared__ __align__(1024) unsigned char bw_smem[];
  unsigned char* base = bw_smem + ((1024 - (smem_u32(bw_smem) & 1023)) & 1023);
  unsigned char* q_s = base;
  unsigned char* do_s = base + P::OWN_BYTES;
  unsigned char* st = base + 2 * P::OWN_BYTES;  // stage s: k, then v
  uint64_t* full = reinterpret_cast<uint64_t*>(base + P::BAR_OFF);
  uint64_t* empty = full + P::STAGES;
  uint64_t* q_bar = empty + P::STAGES;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kOwn;  // heaviest first
  const int kvh = h / (H / KVH);
  const int k_end = causal ? min(T_len, q0 + kOwn) : T_len;
  const int n_k = (k_end + kTile - 1) / kTile;
  // the warpgroup, read through a shuffle so that ptxas knows it is the
  // same in every lane of a warp (a branch on it does not diverge)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // a consumer warpgroup: q rows [64 CW, 64 CW + 64) of the tile (CW a
  // compile-time constant, as in the dk/dv pass)
  auto consume = [&](auto cw_c) {
    constexpr int cw = decltype(cw_c)::value;
    const int tid = threadIdx.x - 128;
    const int warp = (tid / 32) % 4, lane = tid % 32;
    const int t4 = lane % 4;
    const int row_lo = q0 + 64 * cw;
    const int r0 = row_lo + 16 * warp + lane / 4, r1 = r0 + 8;
    // the rows' lse * log2(e) and Dl (rows past S: +inf and 0)
    const size_t at = (static_cast<size_t>(b) * H + h) * S_rows;
    const size_t plane = static_cast<size_t>(B) * H * S_rows;
    const float lse2[2] = {rows[at + r0], rows[at + r1]};
    const float dl[2] = {rows[plane + at + r0], rows[plane + at + r1]};

    float dq_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
    const uint32_t q_addr = smem_u32(q_s) + 64 * cw * P::SW;
    const uint32_t do_addr = smem_u32(do_s) + 64 * cw * P::SW;
    // causal: this warpgroup's rows see keys < row_lo + 64 only
    const int wg_end = causal ? min(k_end, row_lo + 64) : k_end;
    mbar_wait(q_bar, 0);

    for (int j = 0; j < n_k; ++j) {
      const int s = j % P::STAGES;
      const int k0 = j * kTile;
      mbar_wait(&full[s], (j / P::STAGES) & 1);
      if (k0 >= wg_end) {
        release(empty, s, lane);
        continue;
      }
      const uint32_t k_addr = smem_u32(st + s * 2 * P::TILE_BYTES);
      const uint32_t v_addr = k_addr + P::TILE_BYTES;
      // S = Q K^T, dP = dO V^T
      float sc[32], dp[32];
      two_score_tiles<D>(sc, dp, q_addr, k_addr, do_addr, v_addr);
      // dS = P (dP - Dl), P = exp2(scale log2(e) S - lse log2(e)); key k0 +
      // 8 (e / 4) + 2 t4 + (e & 1), row r0 (r1 where e & 2); zero past T
      // and, causal, past the row
      const bool masked =
          k0 + kTile > T_len || (causal && k0 + kTile - 1 > row_lo);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int hh = (e >> 1) & 1;
        float p = exp2f(fmaf(sc[e], scale_log2, -lse2[hh]));
        if (masked) {
          const int key = k0 + 8 * (e / 4) + 2 * t4 + (e & 1);
          if (key >= T_len || (causal && key > (hh ? r1 : r0))) p = 0.f;
        }
        dp[e] = p * (dp[e] - dl[hh]);
      }
      uint32_t da[4][4];
      pack_a(da, dp);
      wgmma_fence();
      product_into<D>(dq_acc, da, k_addr);  // dQ += dS K
      wgmma_commit();
      wgmma_wait_all();
      pin<D / 2>(dq_acc);
      release(empty, s, lane);
    }
    const size_t pitch = static_cast<size_t>(H) * D;
    store_rows<D>(dq + static_cast<size_t>(b) * S * pitch + h * D, pitch,
                  dq_acc, scale, r0, S, t4);
  };

  if (wg == 0) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_bar, 2 * P::OWN_BYTES);
#pragma unroll
      for (int c = 0; c < P::NCH; ++c) {
        tma_load_4d(q_s + c * kOwn * P::SW, &tm_q, q_bar, c * P::CW, h, q0,
                    b);
        tma_load_4d(do_s + c * kOwn * P::SW, &tm_do, q_bar, c * P::CW, h,
                    q0, b);
      }
      for (int j = 0; j < n_k; ++j) {
        const int s = j % P::STAGES;
        if (j >= P::STAGES) mbar_wait(&empty[s], (j / P::STAGES - 1) & 1);
        mbar_expect_tx(&full[s], 2 * P::TILE_BYTES);
        unsigned char* k_dst = st + s * 2 * P::TILE_BYTES;
        unsigned char* v_dst = k_dst + P::TILE_BYTES;
#pragma unroll
        for (int c = 0; c < P::NCH; ++c) {
          tma_load_4d(k_dst + c * kTile * P::SW, &tm_k, &full[s], c * P::CW,
                      kvh, j * kTile, b);
          tma_load_4d(v_dst + c * kTile * P::SW, &tm_v, &full[s], c * P::CW,
                      kvh, j * kTile, b);
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    if (wg == 1)
      consume(std::integral_constant<int, 0>());
    else
      consume(std::integral_constant<int, 1>());
  }
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const void* o, const void* dout, const float* lse,
                         float* rows, void* dq, void* dk, void* dv, int B,
                         int S, int T_len, int H, int KVH, float scale,
                         int causal, cudaStream_t s) {
  using PK = BwdPlan<D, true>;
  using PQ = BwdPlan<D, false>;
  const int S_rows = (S + kOwn - 1) / kOwn * kOwn;
  const long long n = static_cast<long long>(B) * S_rows * H;
  const long long blocks =
      (n * delta_lanes<__nv_bfloat16, D>() + kThreads - 1) / kThreads;
  const int n_kt = (T_len + kOwn - 1) / kOwn, n_qt = S_rows / kOwn;
  if (blocks > INT32_MAX || n_kt > 65535 || n_qt > 65535)
    return cudaErrorInvalidValue;
  delta_kernel<__nv_bfloat16, D, true>
      <<<static_cast<int>(blocks), kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(o),
          static_cast<const __nv_bfloat16*>(dout), lse, rows, B, S, S_rows,
          H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // the dk/dv pass reads q and do in streamed tiles, k and v whole; the
  // dq pass the other way round
  CUtensorMap q_t, do_t, k_o, v_o, q_o, do_o, k_t, v_t;
  if (!bf16_map(&q_t, q, B, S, H, D, PK::CW, kTile) ||
      !bf16_map(&do_t, dout, B, S, H, D, PK::CW, kTile) ||
      !bf16_map(&k_o, k, B, T_len, KVH, D, PK::CW, kOwn) ||
      !bf16_map(&v_o, v, B, T_len, KVH, D, PK::CW, kOwn) ||
      !bf16_map(&q_o, q, B, S, H, D, PK::CW, kOwn) ||
      !bf16_map(&do_o, dout, B, S, H, D, PK::CW, kOwn) ||
      !bf16_map(&k_t, k, B, T_len, KVH, D, PK::CW, kTile) ||
      !bf16_map(&v_t, v, B, T_len, KVH, D, PK::CW, kTile))
    return cudaErrorInvalidValue;
  static bool smem_set = false;
  if (!smem_set) {
    if ((e = allow_smem(dkdv_wgmma_kernel<D>, PK::SMEM)) != cudaSuccess ||
        (e = allow_smem(dq_wgmma_kernel<D>, PQ::SMEM)) != cudaSuccess)
      return e;
    smem_set = true;
  }
  const float scale_log2 = scale * 1.4426950408889634f;
  dkdv_wgmma_kernel<D><<<dim3(KVH, B, n_kt), kWgThreads, PK::SMEM, s>>>(
      q_t, do_t, k_o, v_o, rows, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), B, S, S_rows, T_len, H, KVH, scale,
      scale_log2, causal);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  dq_wgmma_kernel<D><<<dim3(H, B, n_qt), kWgThreads, PQ::SMEM, s>>>(
      q_o, do_o, k_t, v_t, rows, static_cast<__nv_bfloat16*>(dq), B, S,
      S_rows, T_len, H, KVH, scale, scale_log2, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const float* lse,
                     float* delta, void* dq, void* dk, void* dv, int B, int S,
                     int T_len, int H, int KVH, float scale, int causal,
                     cudaStream_t s) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return launch_wgmma<D>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S,
                           T_len, H, KVH, scale, causal, s);
  else
    return launch_cores<T, D>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                              S, T_len, H, KVH, scale, causal, s);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, int B, int S,
                   int T_len, int H, int KVH, int D, float scale, int causal,
                   cudaStream_t s) {
  switch (D) {
    case 32:
      return launch_d<T, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S,
                             T_len, H, KVH, scale, causal, s);
    case 64:
      return launch_d<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S,
                             T_len, H, KVH, scale, causal, s);
    case 80:
      return launch_d<T, 80>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S,
                             T_len, H, KVH, scale, causal, s);
    case 128:
      return launch_d<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S,
                              T_len, H, KVH, scale, causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dout, dq, dk, dv of one
// type). q, o, dout and dq (B, S, H, D); k, v, dk and dv (B, T, KVH, D);
// lse (B, H, S) f32; all contiguous, H % KVH == 0, bf16 pointers 16-byte
// aligned (the TMA maps). `delta` is f32 scratch of 2 B H S_rows floats,
// S_rows = S rounded up to a multiple of 128 (the bf16 body's padded lse
// and Dl; the f32 body uses B H S of it). Three launches on `stream`;
// returns the first failing launch's cudaError_t.
extern "C" int flash_attention_backward(
    int dtype, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int B, int S, int T_len, int H, int KVH, int D, float scale,
    int causal, void* stream) {
  if (B < 1 || S < 1 || T_len < 1 || KVH < 1 || H % KVH != 0 || B > 65535 ||
      H > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S,
                         T_len, H, KVH, D, scale, causal, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                                 S, T_len, H, KVH, D, scale, causal, s);
  return cudaErrorInvalidValue;
}
