// Causal or bidirectional GQA attention with an online softmax (flash
// attention, K2), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (`_flash_kernel`, pallas_call at :103), with its
// contract: q (B, S, H, D), k (B, T, KVH, D), v (B, T, KVH, Dv), H = KVH *
// G;
//   out[b, i, h] = softmax_j(scale * q[b, i, h] . k[b, j, h / G])
//                  v[b, j, h / G]
// over j < T, and j <= i when causal; with a window W >= 0 (causal
// only) also j >= i - W, the JAX package's sliding window (W + 1 keys a
// row: `(i - j) <= window` in repro/models/layers.py::chunked_attention).
// The running max and sum and the
// accumulator in f32, the output (B, S, H, Dv) cast to q's type. f32 or
// bf16 (q, k, v and out of one type); (D, Dv) = (D, D) for D in {16, 32,
// 64, 80, 128}, or (192, 128): DeepSeek-V3's MLA prefill, whose q and k
// heads carry 128 decompressed dims and 64 rotary ones and whose v heads
// 128 (repro/models/layers.py::mla_apply; `chunked_attention` lets v
// have its own head dim). The value head dim sizes the v tiles, the P V
// product and the output; the q/k dim the q tile, the k tiles and the
// Q K^T product. (192, 128) takes no window and no log-sum-exp: no path
// of the JAX package trains MLA here or windows it.
//
// What bounds it on an H100: operations. A causal prefill of S tokens
// does about 2 * S^2 * H * D multiply-adds (4 * S^2 * H * D / 2
// operations) against 2 * (S * H + 2 * T * KVH) * D bytes in bf16, far
// above the card's 295 operations a byte: the tensor cores' 989
// TFLOP/s are the bound, and only wgmma reaches them.
//
// bf16 (flash_attention_wgmma_kernel): one block of three warpgroups per
// (q tile of 128 rows, q head, batch row).
// - Loads: one producer thread issues TMA copies through 4-D tensor maps
//   over (B, S|T, H|KVH, D), so a tile never crosses into the next batch
//   row and the hardware zero-fills the ragged S and T edges. q comes
//   once; k and v tiles of 128 positions go through a ring of STAGES
//   buffers, each with a "full" mbarrier (the copies' bytes) and an
//   "empty" one (the consumer warps' release), so the loads of the next
//   tiles overlap the products of this one. The producer warpgroup gives
//   up registers (setmaxnreg) to the two consumers.
// - Products: each consumer warpgroup owns 64 q rows. S = Q K^T is a
//   wgmma with both operands in shared memory (K-major); the scores stay
//   in registers, are rounded to bf16 and become the register A operand
//   of O += P V, whose B operand is the v tile in its natural (t, d)
//   layout read through wgmma's transpose bit (MN-major).
// - Layout: a tile is stored as column chunks of CW elements, CW * 2
//   bytes a row, swizzled by the TMA and read by wgmma with the same
//   swizzle: 128-byte chunks where D is a multiple of 64, 64 bytes at
//   D = 32, 32 bytes at D = 16 and D = 80 (a 160-byte row is five
//   32-byte chunks). q/k and v are chunked each by its own head dim.
// - Softmax in base 2 (scores times scale * log2(e), exp2f). Only the
//   tiles that cross the diagonal or the end of T are masked; a causal
//   block stops at the last tile that holds a position <= its last row.
//   A window's block starts at the tile that holds its first row - W, and
//   masks the tiles that cross that edge. The blocks of the last
//   (heaviest) q tiles are launched first.
// - p is rounded to bf16 for the value product, as the tensor cores
//   take it; the running sum keeps the f32 p.
// f32 has no tensor-core path at its precision and runs on the CUDA
// cores (flash_attention_kernel, 256 threads): tiles staged in shared
// memory (k rows padded by 4 bytes against bank conflicts); each thread
// computes a 4 x 4 block of scores and owns a 4 x D/16 block of the
// output accumulator in registers; the running max and sum of each row
// live in shared memory, updated by 4 threads a row with shuffles; at
// D = 80 a thread owns 5 output columns of 16.
//
// Training asks for each row's log-sum-exp as well (f32, (B, H, S),
// natural log of the scaled scores: lse_i = m_i + log l_i), which the
// backward kernel (flash_attention_bwd.cu) reads to rebuild the softmax
// weights. Both bodies take it as a compile-time flag (LSE): without it
// the serving call is the kernel it was, register for register; with it
// the rows' (m, l) are written once after the loop.

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

constexpr int kBQ = 64;  // q rows per block
constexpr int kBK = 64;  // k/v positions per tile
constexpr int kThreads = 256;

// elements d and d + 1 of a staged row (d even)
__device__ __forceinline__ float2 pair(const float* row, int d) {
  return make_float2(row[d], row[d + 1]);
}

// padded row stride of a staged q or k tile, in elements: one 4-byte word
template <typename T>
__host__ __device__ constexpr int padded(int D) {
  return D + 4 / static_cast<int>(sizeof(T));
}

template <typename T, int D, int DV, bool LSE>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, int S, int T_len, int H,
                       int KVH, float scale, int causal, int window) {
  constexpr int QS = padded<T>(D);  // q and k tile row stride
  constexpr int PS = kBK + 1;       // score tile row stride
  constexpr int NC = DV / 16;       // output columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);          // kBQ x QS
  T* k_s = q_s + kBQ * QS;                          // kBK x QS
  T* v_s = k_s + kBK * QS;                          // kBK x DV
  float* p_s = reinterpret_cast<float*>(v_s + kBK * DV);  // kBQ x PS
  float* m_s = p_s + kBQ * PS;                      // kBQ
  float* l_s = m_s + kBQ;                           // kBQ
  float* c_s = l_s + kBQ;                           // kBQ

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;  // rows ty*4.., cols tx + 16 j

  const size_t q_row = static_cast<size_t>(H) * D;     // q position
  const size_t o_row = static_cast<size_t>(H) * DV;    // out position
  const size_t kv_row = static_cast<size_t>(KVH) * D;  // k position
  const size_t v_row = static_cast<size_t>(KVH) * DV;  // v position
  const T* q_b = q + static_cast<size_t>(b) * S * q_row + h * D;
  const T* k_b = k + static_cast<size_t>(b) * T_len * kv_row + kvh * D;
  const T* v_b = v + static_cast<size_t>(b) * T_len * v_row + kvh * DV;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    q_s[r * QS + d] = q0 + r < S ? q_b[(q0 + r) * q_row + d]
                                 : from_f32<T>(0.f);
  }
  for (int r = tid; r < kBQ; r += kThreads) {
    m_s[r] = neg_inf();
    l_s[r] = 0.f;
  }
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;

  // a causal block sees positions <= its last row only; with a window,
  // positions >= its first row - W only: the tiles before are skipped
  const int k_end = causal ? min(T_len, q0 + kBQ) : T_len;
  const int k_start = window >= 0 ? max(0, q0 - window) / kBK * kBK : 0;
  for (int k0 = k_start; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int t = i / D, d = i % D;
      k_s[t * QS + d] =
          k0 + t < T_len ? k_b[(k0 + t) * kv_row + d] : from_f32<T>(0.f);
    }
    for (int i = tid; i < kBK * DV; i += kThreads) {
      const int t = i / DV, d = i % DV;
      v_s[t * DV + d] =
          k0 + t < T_len ? v_b[(k0 + t) * v_row + d] : from_f32<T>(0.f);
    }
    __syncthreads();

    // scores: rows ty*4 + i, columns tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 2) {
      float2 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = pair(q_s + (ty * 4 + i) * QS, d);
#pragma unroll
      for (int j = 0; j < 4; ++j) ka[j] = pair(k_s + (tx + 16 * j) * QS, d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] += qa[i].x * ka[j].x + qa[i].y * ka[j].y;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool ok = k0 + c < T_len && (!causal || k0 + c <= q0 + r) &&
                        (window < 0 || q0 + r - (k0 + c) <= window);
        p_s[r * PS + c] = ok ? s[i][j] * scale : neg_inf();
      }
    }
    __syncthreads();

    // online softmax: 4 neighbouring threads a row, 16 columns each
    {
      const int r = tid / 4, part = tid % 4;
      float* row = p_s + r * PS + part * 16;
      float mx = neg_inf();
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      // a row with no visible position yet keeps weight 0 everywhere
      const float m_use = m_new == neg_inf() ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(row[c] - m_use);
        row[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (part == 0) {
        const float corr = expf(m_old - m_use);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + p v
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= corr;
    }
    const int tk = min(kBK, T_len - k0);
    for (int t = 0; t < tk; ++t) {
      float p[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = p_s[(ty * 4 + i) * PS + t];
#pragma unroll
      for (int j = 0; j < NC; ++j) vv[j] = to_f32(v_s[t * DV + tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] += p[i] * vv[j];
    }
  }
  __syncthreads();
  T* o_b = out + static_cast<size_t>(b) * S * o_row + h * DV;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= S) continue;
    const float inv_l = 1.f / fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NC; ++j)
      o_b[(q0 + r) * o_row + tx + 16 * j] = from_f32<T>(acc[i][j] * inv_l);
  }
  if constexpr (LSE) {
    // m_s and l_s are in natural units; a row that saw nothing gets +inf
    // (its weights exp(s - lse) are 0 in the backward)
    if (tid < kBQ && q0 + tid < S) {
      const float l = l_s[tid];
      lse[(static_cast<size_t>(b) * H + h) * S + q0 + tid] =
          l > 0.f ? m_s[tid] + logf(l) : __int_as_float(0x7f800000);
    }
  }
}


// ------------------------------------- bf16: TMA + wgmma, Hopper only
constexpr int kFaBQ = 128;       // q rows a block: 64 a consumer warpgroup
constexpr int kFaBK = 128;       // k/v positions a tile
constexpr int kFaThreads = 384;  // producer warpgroup + two consumers
constexpr int kConsumerWarps = 8;
constexpr int kSmemBudget = 200 * 1024;
constexpr int kSmemMax = 232448;  // a block's dynamic shared memory at most

// The column chunk of a head dim d: CW elements, SW = 2 CW bytes a row
// (the swizzle span), and wgmma's layout code of that swizzle.
__host__ __device__ constexpr int chunk_of(int d) {
  return d % 64 == 0 ? 64 : (d % 32 == 0 ? 32 : 16);
}
__host__ __device__ constexpr uint32_t layout_of(int sw) {
  return sw == 128 ? 1 : (sw == 64 ? 2 : 3);
}

// The shared-memory plan of head dims (D, DV): q and k in column chunks
// of CW elements, v in chunks of CWV; q (kFaBQ rows), then STAGES k/v
// buffers (kFaBK rows each of k and v), then the mbarriers. Every chunk
// starts on a multiple of its swizzle pattern (8 rows x SW bytes). The
// stages fill kSmemBudget; a plan with fewer than two stages there
// (DeepSeek-V3's (192, 128): a 48 KB q tile and 80 KB a stage) takes the
// block's whole shared memory instead, which holds two.
template <int D, int DV>
struct FaPlan {
  static constexpr int CW = chunk_of(D);
  static constexpr int SW = 2 * CW;
  static constexpr int NCH = D / CW;
  static constexpr uint32_t LAYOUT = layout_of(SW);
  static constexpr int CWV = chunk_of(DV);
  static constexpr int SWV = 2 * CWV;
  static constexpr int NCHV = DV / CWV;
  static constexpr uint32_t LAYOUTV = layout_of(SWV);
  static constexpr int Q_BYTES = kFaBQ * D * 2;
  static constexpr int K_BYTES = kFaBK * D * 2;
  static constexpr int V_BYTES = kFaBK * DV * 2;
  static constexpr int STAGE_BYTES = K_BYTES + V_BYTES;
  static constexpr int STAGES_FIT = (kSmemBudget - Q_BYTES) / STAGE_BYTES;
  static constexpr int STAGES_MAX =
      (kSmemMax - 2048 - Q_BYTES) / STAGE_BYTES;
  static constexpr int STAGES_ANY = STAGES_FIT >= 2 ? STAGES_FIT : STAGES_MAX;
  static constexpr int STAGES = STAGES_ANY < 4 ? STAGES_ANY : 4;
  static constexpr int BAR_OFF = Q_BYTES + STAGES * STAGE_BYTES;
  // + the mbarriers, + 1 KB to align the base
  static constexpr int SMEM = BAR_OFF + (2 * STAGES + 1) * 8 + 1024;
  static_assert(D % 16 == 0 && NCH * CW == D && DV % 16 == 0 &&
                    NCHV * CWV == DV && STAGES >= 2 && SMEM <= kSmemMax,
                "unsupported head dims");
};

template <int D, int DV, bool LSE>
__global__ void __launch_bounds__(kFaThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             __nv_bfloat16* __restrict__ out,
                             float* __restrict__ lse, int S, int T_len,
                             int H, int KVH, float scale_log2, int causal,
                             int window) {
  using P = FaPlan<D, DV>;
  extern __shared__ __align__(1024) unsigned char fa_smem[];
  unsigned char* base = fa_smem + ((1024 - (smem_u32(fa_smem) & 1023)) & 1023);
  unsigned char* q_s = base;
  unsigned char* kv_s = base + P::Q_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + P::BAR_OFF);
  uint64_t* empty = full + P::STAGES;
  uint64_t* q_bar = empty + P::STAGES;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kFaBQ;  // heaviest first
  const int kvh = h / (H / KVH);
  const int k_end = causal ? min(T_len, q0 + kFaBQ) : T_len;
  // a window's block starts at the tile that holds its first row - W:
  // the tiles wholly before the band are skipped; j0 + it is the tile of
  // the it-th iteration, which takes ring stage it % STAGES
  const int j0 = window >= 0 ? max(0, q0 - window) / kFaBK : 0;
  const int n_k = (k_end + kFaBK - 1) / kFaBK - j0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_bar, P::Q_BYTES);
#pragma unroll
      for (int c = 0; c < P::NCH; ++c)
        tma_load_4d(q_s + c * kFaBQ * P::SW, &tm_q, q_bar, c * P::CW, h,
                    q0, b);
      for (int j = 0; j < n_k; ++j) {
        const int s = j % P::STAGES;
        if (j >= P::STAGES) mbar_wait(&empty[s], (j / P::STAGES - 1) & 1);
        const int kt = (j0 + j) * kFaBK;
        mbar_expect_tx(&full[s], P::STAGE_BYTES);
        unsigned char* k_dst = kv_s + s * P::STAGE_BYTES;
        unsigned char* v_dst = k_dst + P::K_BYTES;
#pragma unroll
        for (int c = 0; c < P::NCH; ++c)
          tma_load_4d(k_dst + c * kFaBK * P::SW, &tm_k, &full[s],
                      c * P::CW, kvh, kt, b);
#pragma unroll
        for (int c = 0; c < P::NCHV; ++c)
          tma_load_4d(v_dst + c * kFaBK * P::SWV, &tm_v, &full[s],
                      c * P::CWV, kvh, kt, b);
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    constexpr int NS = kFaBK / 2;  // score registers a thread
    constexpr int NO = DV / 2;     // output registers a thread
    const int tid = threadIdx.x - 128;
    const int cw = tid / 128;  // rows [64 cw, 64 cw + 64) of the tile
    const int warp = (tid / 32) % 4, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const int row_lo = q0 + 64 * cw;
    const int r0 = row_lo + 16 * warp + g, r1 = r0 + 8;

    float o[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.f;
    float m_run[2] = {neg_inf(), neg_inf()}, l_run[2] = {0.f, 0.f};
    const uint32_t q_addr = smem_u32(q_s) + 64 * cw * P::SW;
    mbar_wait(q_bar, 0);

    for (int j = 0; j < n_k; ++j) {
      const int s = j % P::STAGES;
      const int k0 = (j0 + j) * kFaBK;
      mbar_wait(&full[s], (j / P::STAGES) & 1);
      const uint32_t k_addr = smem_u32(kv_s + s * P::STAGE_BYTES);
      const uint32_t v_addr = k_addr + P::K_BYTES;

      // S = Q K^T over D / 16 k-steps: k-step kk lies in chunk
      // kk * 16 / CW, at byte (kk * 16 % CW) * 2 of its rows
      float sc[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) sc[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk * 16 / P::CW;
        const uint32_t off = (kk * 16 % P::CW) * 2;
        const uint64_t da = smem_desc(q_addr + c * kFaBQ * P::SW + off, 16,
                                      8 * P::SW, P::LAYOUT);
        const uint64_t db = smem_desc(k_addr + c * kFaBK * P::SW + off, 16,
                                      8 * P::SW, P::LAYOUT);
        Wgmma<kFaBK>::ss(sc, da, db, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin<NS>(sc);

      // scale (base 2), mask where the tile crosses the diagonal, the
      // end of T or the window's far edge (key < row - W for a row of
      // this warpgroup's 64), and the online softmax of rows r0
      // (sc[4i + 0, 1]) and r1 (sc[4i + 2, 3]); a row's scores sit in
      // the 4 threads of a quad
      const bool masked =
          k0 + kFaBK > T_len || (causal && k0 + kFaBK - 1 > row_lo) ||
          (window >= 0 && k0 < row_lo + 63 - window);
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int e = 0; e < NS; ++e) {
        float x = sc[e] * scale_log2;
        if (masked) {
          const int key = k0 + 8 * (e / 4) + 2 * t4 + (e & 1);
          const int row = (e & 2) ? r1 : r0;
          if (key >= T_len || (causal && key > row) ||
              (window >= 0 && row - key > window))
            x = neg_inf();
        }
        sc[e] = x;
        mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], x);
      }
      float m_use[2], corr[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
        // a row with no visible position yet keeps weight 0 everywhere
        m_use[hh] = mx[hh] == neg_inf() ? 0.f : mx[hh];
        corr[hh] = exp2f(m_run[hh] - m_use[hh]);
        m_run[hh] = mx[hh];
        l_run[hh] *= corr[hh];
      }
      // the row sums stay per thread (a quad's parts) until the end
#pragma unroll
      for (int e = 0; e < NS; ++e) {
        const int hh = (e >> 1) & 1;
        sc[e] = exp2f(sc[e] - m_use[hh]);
        l_run[hh] += sc[e];
      }
#pragma unroll
      for (int i = 0; i < NO; ++i) o[i] *= corr[(i >> 1) & 1];

      // O += P V: the scores of columns 16 kj .. 16 kj + 15 are the A
      // fragment of k-step kj; V's rows 16 kj .. at 16 kj * SWV bytes,
      // its column chunks LBO = kFaBK * SWV apart
      uint32_t pa[kFaBK / 16][4];
#pragma unroll
      for (int kj = 0; kj < kFaBK / 16; ++kj) {
        pa[kj][0] = pack_bf16(sc[8 * kj], sc[8 * kj + 1]);
        pa[kj][1] = pack_bf16(sc[8 * kj + 2], sc[8 * kj + 3]);
        pa[kj][2] = pack_bf16(sc[8 * kj + 4], sc[8 * kj + 5]);
        pa[kj][3] = pack_bf16(sc[8 * kj + 6], sc[8 * kj + 7]);
      }
      wgmma_fence();
#pragma unroll
      for (int kj = 0; kj < kFaBK / 16; ++kj) {
        const uint64_t db = smem_desc(v_addr + kj * 16 * P::SWV,
                                      kFaBK * P::SWV, 8 * P::SWV, P::LAYOUTV);
        Wgmma<DV>::rs(o, pa[kj], db, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin<NO>(o);
      // this warp is done with the k and v of stage s
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // the quad's row sums, then out = O / l, rows past S not stored
    __nv_bfloat16* o_b = out + static_cast<size_t>(b) * S * H * DV + h * DV;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float l = l_run[hh];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = hh == 0 ? r0 : r1;
      if (row >= S) continue;
      if constexpr (LSE) {
        // m_run is in base-2 units (scores times scale * log2(e))
        if (t4 == 0)
          lse[(static_cast<size_t>(b) * H + h) * S + row] =
              l > 0.f ? (m_run[hh] + log2f(l)) * 0.6931471805599453f
                      : __int_as_float(0x7f800000);
      }
      const float inv_l = 1.f / fmaxf(l, 1e-30f);
      __nv_bfloat16* o_r = o_b + static_cast<size_t>(row) * H * DV;
#pragma unroll
      for (int i = 0; i < DV / 8; ++i)
        *reinterpret_cast<uint32_t*>(o_r + 8 * i + 2 * t4) =
            pack_bf16(o[4 * i + 2 * hh] * inv_l,
                      o[4 * i + 2 * hh + 1] * inv_l);
    }
  }
}

template <int D, int DV, bool LSE>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* out, float* lse, int B, int S, int T_len,
                         int H, int KVH, float scale, int causal,
                         int window, cudaStream_t s) {
  using P = FaPlan<D, DV>;
  CUtensorMap mq, mk, mv;
  if (!bf16_map(&mq, q, B, S, H, D, P::CW, kFaBQ) ||
      !bf16_map(&mk, k, B, T_len, KVH, D, P::CW, kFaBK) ||
      !bf16_map(&mv, v, B, T_len, KVH, DV, P::CWV, kFaBK))
    return cudaErrorInvalidValue;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_wgmma_kernel<D, DV, LSE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const int n_q = (S + kFaBQ - 1) / kFaBQ;
  if (n_q > 65535) return cudaErrorInvalidValue;
  const float log2e = 1.4426950408889634f;
  flash_attention_wgmma_kernel<D, DV, LSE>
      <<<dim3(H, B, n_q), kFaThreads, P::SMEM, s>>>(
          mq, mk, mv, static_cast<__nv_bfloat16*>(out), lse, S, T_len, H,
          KVH, scale * log2e, causal, window);
  return cudaGetLastError();
}

template <typename T, int D, int DV, bool LSE>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out,
                     float* lse, int B, int S, int T_len, int H, int KVH,
                     float scale, int causal, int window, cudaStream_t s) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return launch_wgmma<D, DV, LSE>(q, k, v, out, lse, B, S, T_len, H, KVH,
                                    scale, causal, window, s);
  } else {
    const dim3 grid((S + kBQ - 1) / kBQ, H, B);
    const size_t smem =
        sizeof(T) * (static_cast<size_t>(kBQ + kBK) * padded<T>(D) +
                     kBK * DV) +
        sizeof(float) * (kBQ * (kBK + 1) + 3 * kBQ);
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          flash_attention_kernel<T, D, DV, LSE>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return e;
    }
    flash_attention_kernel<T, D, DV, LSE><<<grid, kThreads, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), lse, S, T_len, H,
        KVH, scale, causal, window);
    return cudaGetLastError();
  }
}

template <typename T, bool LSE>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int S, int T_len, int H, int KVH, int D,
                   int Dv, float scale, int causal, int window,
                   cudaStream_t s) {
  if (Dv != D) {
    // MLA's (192, 128): serving only, no window
    if constexpr (!LSE) {
      if (D == 192 && Dv == 128 && window < 0)
        return launch_d<T, 192, 128, false>(q, k, v, out, lse, B, S, T_len,
                                            H, KVH, scale, causal, window,
                                            s);
    }
    return cudaErrorInvalidValue;
  }
  switch (D) {
    case 16:
      return launch_d<T, 16, 16, LSE>(q, k, v, out, lse, B, S, T_len, H,
                                      KVH, scale, causal, window, s);
    case 32:
      return launch_d<T, 32, 32, LSE>(q, k, v, out, lse, B, S, T_len, H,
                                      KVH, scale, causal, window, s);
    case 64:
      return launch_d<T, 64, 64, LSE>(q, k, v, out, lse, B, S, T_len, H,
                                      KVH, scale, causal, window, s);
    case 80:
      return launch_d<T, 80, 80, LSE>(q, k, v, out, lse, B, S, T_len, H,
                                      KVH, scale, causal, window, s);
    case 128:
      return launch_d<T, 128, 128, LSE>(q, k, v, out, lse, B, S, T_len, H,
                                        KVH, scale, causal, window, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_t(const void* q, const void* k, const void* v, void* out,
                     float* lse, int B, int S, int T_len, int H, int KVH,
                     int D, int Dv, float scale, int causal, int window,
                     cudaStream_t s) {
  if (lse == nullptr)
    return launch<T, false>(q, k, v, out, nullptr, B, S, T_len, H, KVH, D,
                            Dv, scale, causal, window, s);
  return launch<T, true>(q, k, v, out, lse, B, S, T_len, H, KVH, D, Dv,
                         scale, causal, window, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q (B, S, H, D), k (B, T, KVH, D), v
// (B, T, KVH, Dv), out (B, S, H, Dv), all contiguous, H % KVH == 0; Dv = D
// or (D, Dv) = (192, 128); window the sliding
// window W (causal only; key j visible to row i iff i - W <= j <= i), -1
// for none; lse (B, H, S) f32, or null when the caller does not want it
// (serving). Returns the launch's cudaError_t.
extern "C" int flash_attention(int dtype, const void* q, const void* k,
                               const void* v, void* out, int B, int S,
                               int T_len, int H, int KVH, int D, int Dv,
                               float scale, int causal, int window,
                               float* lse, void* stream) {
  if (B < 1 || S < 1 || T_len < 1 || KVH < 1 || H % KVH != 0 || B > 65535 ||
      H > 65535 || window < -1 || (window >= 0 && !causal))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_t<float>(q, k, v, out, lse, B, S, T_len, H, KVH, D, Dv,
                           scale, causal, window, s);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(q, k, v, out, lse, B, S, T_len, H, KVH, D,
                                   Dv, scale, causal, window, s);
  return cudaErrorInvalidValue;
}
