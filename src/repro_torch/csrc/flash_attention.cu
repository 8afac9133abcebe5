// Causal or bidirectional GQA attention with an online softmax (flash
// attention, K2), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (`_flash_kernel`, pallas_call at :103), with its
// contract: q (B, S, H, D), k and v (B, T, KVH, D), H = KVH * G;
//   out[b, i, h] = softmax_j(scale * q[b, i, h] . k[b, j, h / G])
//                  v[b, j, h / G]
// over j < T, and j <= i when causal. The running max and sum and the
// accumulator in f32, the output cast to q's type. f32 or bf16 (q, k, v
// and out of one type); D in {16, 32, 64, 80, 128}.
//
// What bounds it on an H100: operations. A causal prefill of S tokens
// does about 2 * S^2 * H * D multiply-adds (4 * S^2 * H * D / 2
// operations) against 2 * (S * H + 2 * T * KVH) * D bytes in bf16, far
// above the card's 295 operations a byte: the tensor cores' 989
// TFLOP/s are the bound.
// What the design does: one block per (q tile of 64 rows, q head, batch
// row). The block walks the k/v tiles of 64 positions with an in-block
// loop, the place of the TPU kernel's sequential kv grid axis; a causal
// block stops at the last tile that holds a position <= its last row,
// so fully masked tiles above the diagonal are never loaded. Ragged S
// and T are masked in the kernel: rows past S are not stored, positions
// past T get no weight.
// - bf16 runs on the tensor cores through mma.sync
//   (flash_attention_mma_kernel: one warp per 16 q rows, the scores kept
//   in registers from one product to the next, p rounded to bf16 for
//   the value product as the tensor cores take it). wgmma with TMA is
//   the later step.
// - f32 has no tensor-core path at its precision and runs on the CUDA
//   cores (flash_attention_kernel, 256 threads): tiles staged in shared
//   memory (k rows padded by 4 bytes against bank conflicts); each
//   thread computes a 4 x 4 block of scores and owns a 4 x D/16 block of
//   the output accumulator in registers; the running max and sum of
//   each row live in shared memory, updated by 4 threads a row with
//   shuffles.
// D = 80 (Zamba2-2.7B's shared attention) needs nothing of its own: it
// is five mma.sync k-steps of 16 and ten n-tiles of 8, ten 16-byte
// chunks a staged row (rows of 88 elements, 176 bytes: 16-byte aligned,
// and the 8 rows a fragment load touches still fall in distinct
// banks); the CUDA-core body's thread owns 5 output columns of 16.

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dtype.cuh"

namespace {

constexpr int kBQ = 64;  // q rows per block
constexpr int kBK = 64;  // k/v positions per tile
constexpr int kThreads = 256;

// elements d and d + 1 of a staged row (d even)
__device__ __forceinline__ float2 pair(const float* row, int d) {
  return make_float2(row[d], row[d + 1]);
}
__device__ __forceinline__ float2 pair(const __nv_bfloat16* row, int d) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + d));
}

// padded row stride of a staged q or k tile, in elements: one 4-byte word
template <typename T>
__host__ __device__ constexpr int padded(int D) {
  return D + 4 / static_cast<int>(sizeof(T));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S,
                       int T_len, int H, int KVH, float scale, int causal) {
  constexpr int QS = padded<T>(D);  // q and k tile row stride
  constexpr int PS = kBK + 1;       // score tile row stride
  constexpr int NC = D / 16;        // output columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);          // kBQ x QS
  T* k_s = q_s + kBQ * QS;                          // kBK x QS
  T* v_s = k_s + kBK * QS;                          // kBK x D
  float* p_s = reinterpret_cast<float*>(v_s + kBK * D);  // kBQ x PS
  float* m_s = p_s + kBQ * PS;                      // kBQ
  float* l_s = m_s + kBQ;                           // kBQ
  float* c_s = l_s + kBQ;                           // kBQ

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;  // rows ty*4.., cols tx + 16 j

  const size_t q_row = static_cast<size_t>(H) * D;    // q/out position
  const size_t kv_row = static_cast<size_t>(KVH) * D;  // k/v position
  const T* q_b = q + static_cast<size_t>(b) * S * q_row + h * D;
  const T* k_b = k + static_cast<size_t>(b) * T_len * kv_row + kvh * D;
  const T* v_b = v + static_cast<size_t>(b) * T_len * kv_row + kvh * D;

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

  // a causal block sees positions <= its last row only
  const int k_end = causal ? min(T_len, q0 + kBQ) : T_len;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int t = i / D, d = i % D;
      T kv = from_f32<T>(0.f), vv = from_f32<T>(0.f);
      if (k0 + t < T_len) {
        kv = k_b[(k0 + t) * kv_row + d];
        vv = v_b[(k0 + t) * kv_row + d];
      }
      k_s[t * QS + d] = kv;
      v_s[t * D + d] = vv;
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
        const bool ok = k0 + c < T_len && (!causal || k0 + c <= q0 + r);
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
      for (int j = 0; j < NC; ++j) vv[j] = to_f32(v_s[t * D + tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] += p[i] * vv[j];
    }
  }
  __syncthreads();
  T* o_b = out + static_cast<size_t>(b) * S * q_row + h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= S) continue;
    const float inv_l = 1.f / fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NC; ++j)
      o_b[(q0 + r) * q_row + tx + 16 * j] = from_f32<T>(acc[i][j] * inv_l);
  }
}

// ------------------------------------------------ bf16: tensor cores
// mma.sync m16n8k16, bf16 in, f32 accumulate. Fragment layouts (PTX ISA,
// "Matrix Fragments for mma.m16n8k16"), with g = lane / 4, t = lane % 4:
//   A (16 x 16, row): a0 (g, 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t + 8..),
//                     a3 (g + 8, 2t + 8..)
//   B (16 x 8, col):  b0 (k 2t..2t+1, n g), b1 (k 2t + 8.., n g)
//   C (16 x 8):       c0, c1 (g, 2t..2t+1), c2, c3 (g + 8, 2t..2t+1)
// The low half of each 32-bit register holds the lower index.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<const uint32_t*>(&v);
}

constexpr int kMmaWarps = 4;  // 16 q rows a warp, 64 a block

// bf16 at head dim D: one block of 4 warps per (q tile of 64 rows, q
// head, batch row); each warp owns 16 q rows, holds their q fragments
// in registers for the whole pass, and computes its 16 x 64 scores and
// its 16 x D output with mma.sync. The k and v tiles are staged in
// shared memory with 16-byte loads (rows padded by 16 bytes, so that
// the 8 rows a fragment load touches fall in distinct banks). The
// scores' accumulator layout is the next product's A layout, so p goes
// from registers to the tensor cores without shared memory (rounded to
// bf16 there; the running sum keeps the f32 p).
template <int D>
__global__ void __launch_bounds__(kMmaWarps * 32)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ out, int S, int T_len,
                           int H, int KVH, float scale, int causal) {
  constexpr int KS = D / 16;     // k-steps over the head dim
  constexpr int ND = D / 8;      // n-tiles over the head dim
  constexpr int NK = kBK / 8;    // n-tiles over a k tile
  constexpr int RS = D + 8;      // staged row stride, elements
  constexpr int CH = D / 8;      // 16-byte chunks a row
  __shared__ __align__(16) __nv_bfloat16 k_s[kBK * RS];
  __shared__ __align__(16) __nv_bfloat16 v_s[kBK * RS];

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;

  const size_t q_row = static_cast<size_t>(H) * D;
  const size_t kv_row = static_cast<size_t>(KVH) * D;
  const __nv_bfloat16* q_b = q + static_cast<size_t>(b) * S * q_row + h * D;
  const __nv_bfloat16* k_b =
      k + static_cast<size_t>(b) * T_len * kv_row + kvh * D;
  const __nv_bfloat16* v_b =
      v + static_cast<size_t>(b) * T_len * kv_row + kvh * D;

  // this thread's two q rows (fragment rows g and g + 8 of the warp)
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int c = ks * 16 + 2 * t4;
    const uint32_t* p0 = reinterpret_cast<const uint32_t*>(
        q_b + static_cast<size_t>(r0) * q_row + c);
    const uint32_t* p1 = reinterpret_cast<const uint32_t*>(
        q_b + static_cast<size_t>(r1) * q_row + c);
    qa[ks][0] = r0 < S ? p0[0] : 0u;
    qa[ks][1] = r1 < S ? p1[0] : 0u;
    qa[ks][2] = r0 < S ? p0[4] : 0u;  // columns c + 8, c + 9
    qa[ks][3] = r1 < S ? p1[4] : 0u;
  }
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {neg_inf(), neg_inf()}, l_run[2] = {0.f, 0.f};

  const int k_end = causal ? min(T_len, q0 + kBQ) : T_len;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < kBK * CH; i += kMmaWarps * 32) {
      const int tr = i / CH, ch = i % CH;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + tr < T_len) {
        const size_t off = static_cast<size_t>(k0 + tr) * kv_row + ch * 8;
        kv = *reinterpret_cast<const uint4*>(k_b + off);
        vv = *reinterpret_cast<const uint4*>(v_b + off);
      }
      *reinterpret_cast<uint4*>(k_s + tr * RS + ch * 8) = kv;
      *reinterpret_cast<uint4*>(v_s + tr * RS + ch * 8) = vv;
    }
    __syncthreads();

    // scores: 16 rows x 64 positions a warp
    float sc[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
      const __nv_bfloat16* kr = k_s + (n * 8 + g) * RS + 2 * t4;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const uint32_t b0 =
            *reinterpret_cast<const uint32_t*>(kr + ks * 16);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(kr + ks * 16 + 8);
        mma_bf16(sc[n], qa[ks], b0, b1);
      }
    }
    // scale, mask, and the online softmax of rows r0 (e = 0, 1) and r1
    // (e = 2, 3); a row's 64 scores sit in the 4 threads of a quad
    float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * t4 + (e & 1);
        const int row = e < 2 ? r0 : r1;
        const bool ok = key < T_len && (!causal || key <= row);
        sc[n][e] = ok ? sc[n][e] * scale : neg_inf();
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
      }
    float corr[2], m_use[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m_run[hh], mx[hh]);
      // a row with no visible position yet keeps weight 0 everywhere
      m_use[hh] = m_new == neg_inf() ? 0.f : m_new;
      corr[hh] = expf(m_run[hh] - m_use[hh]);
      m_run[hh] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[n][e] = expf(sc[n][e] - m_use[e >> 1]);
        sum[e >> 1] += sc[n][e];
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
      sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
      l_run[hh] = l_run[hh] * corr[hh] + sum[hh];
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
    // acc += p v: the scores of n-tiles 2j, 2j + 1 are the A fragment of
    // k-step j
#pragma unroll
    for (int j = 0; j < NK / 2; ++j) {
      const uint32_t pa[4] = {pack_bf16(sc[2 * j][0], sc[2 * j][1]),
                              pack_bf16(sc[2 * j][2], sc[2 * j][3]),
                              pack_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1]),
                              pack_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3])};
      const __nv_bfloat16* vr = v_s + (j * 16 + 2 * t4) * RS + g;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const __nv_bfloat16* vc = vr + n * 8;
        const uint32_t b0 = pack_bf16(vc[0], vc[RS]);
        const uint32_t b1 = pack_bf16(vc[8 * RS], vc[9 * RS]);
        mma_bf16(acc[n], pa, b0, b1);
      }
    }
  }
  __nv_bfloat16* o_b = out + static_cast<size_t>(b) * S * q_row + h * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = hh == 0 ? r0 : r1;
    if (row >= S) continue;
    const float inv_l = 1.f / fmaxf(l_run[hh], 1e-30f);
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<uint32_t*>(o_b + static_cast<size_t>(row) * q_row +
                                   n * 8 + 2 * t4) =
          pack_bf16(acc[n][2 * hh] * inv_l, acc[n][2 * hh + 1] * inv_l);
    }
  }
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out,
                     int B, int S, int T_len, int H, int KVH, float scale,
                     int causal, cudaStream_t s) {
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    flash_attention_mma_kernel<D><<<grid, kMmaWarps * 32, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), S, T_len, H, KVH,
        scale, causal);
  } else {
    const size_t smem =
        sizeof(T) * (static_cast<size_t>(kBQ + kBK) * padded<T>(D) +
                     kBK * D) +
        sizeof(float) * (kBQ * (kBK + 1) + 3 * kBQ);
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          flash_attention_kernel<T, D>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return e;
    }
    flash_attention_kernel<T, D><<<grid, kThreads, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), S, T_len, H, KVH,
        scale, causal);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int T_len, int H, int KVH, int D,
                   float scale, int causal, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch_d<T, 16>(q, k, v, out, B, S, T_len, H, KVH, scale,
                             causal, s);
    case 32:
      return launch_d<T, 32>(q, k, v, out, B, S, T_len, H, KVH, scale,
                             causal, s);
    case 64:
      return launch_d<T, 64>(q, k, v, out, B, S, T_len, H, KVH, scale,
                             causal, s);
    case 80:
      return launch_d<T, 80>(q, k, v, out, B, S, T_len, H, KVH, scale,
                             causal, s);
    case 128:
      return launch_d<T, 128>(q, k, v, out, B, S, T_len, H, KVH, scale,
                              causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q and out (B, S, H, D), k and v
// (B, T, KVH, D), all contiguous, H % KVH == 0. Returns the launch's
// cudaError_t.
extern "C" int flash_attention(int dtype, const void* q, const void* k,
                               const void* v, void* out, int B, int S,
                               int T_len, int H, int KVH, int D, float scale,
                               int causal, void* stream) {
  if (B < 1 || S < 1 || T_len < 1 || KVH < 1 || H % KVH != 0 || B > 65535 ||
      H > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, out, B, S, T_len, H, KVH, D, scale, causal,
                         s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, B, S, T_len, H, KVH, D, scale,
                                 causal, s);
  return cudaErrorInvalidValue;
}
