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
// 128} (80, the hybrid family's shared block, waits for its training).
//
// What bounds it on an H100: operations. Each visible (i, j) pair costs
// 4 D multiply-adds in the dk/dv pass and 3 D in the dq pass (the scores
// and do . v are formed in both), about 3.5 times the forward's 2 D; the
// bound in the kernels line counts 2.5 times the forward's, the work
// without the recomputed scores, at the tensor cores' rate.
//
// What the design does about it (the first body: right and simple, on
// the CUDA cores; tensor cores are later work):
// - three launches: `delta_kernel` forms Dl (one warp a row); `dkdv_kernel`
//   owns a tile of 64 k/v positions of one kv head and walks, for each of
//   the G query heads that share it, the q tiles that can see it (from
//   the diagonal on when causal), so that dk and dv sum the G heads in
//   registers; `dq_kernel` owns a tile of 64 q rows of one head and walks
//   the k tiles up to the diagonal. No block writes what another writes,
//   and nothing is accumulated with atomics: a step is bitwise
//   repeatable.
// - 256 threads a block; each thread computes a 4 x 4 block of the 64 x
//   64 score and do . v tiles (rows ty * 4 + i, columns tx + 16 j, as the
//   forward's f32 body), and owns a 4 x D/16 block of its accumulators;
//   tiles staged in shared memory in the input type, rows padded by one
//   4-byte word against bank conflicts; P and dS through shared memory in
//   f32 for the products that contract over the other index.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dtype.cuh"

namespace {

constexpr int kB = 64;  // rows of a q tile and positions of a k/v tile
constexpr int kThreads = 256;
constexpr int kPS = kB + 1;  // row stride of the f32 P and dS tiles

template <typename T>
__host__ __device__ constexpr int padded(int D) {
  return D + 4 / static_cast<int>(sizeof(T));
}

// elements d and d + 1 of a staged row (d even), as f32
__device__ __forceinline__ float2 pair2(const float* row, int d) {
  return make_float2(row[d], row[d + 1]);
}
__device__ __forceinline__ float2 pair2(const __nv_bfloat16* row, int d) {
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(row + d));
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

// Dl[b, h, i] = sum_d do[b, i, h, d] o[b, i, h, d]: one warp a row
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ delta, int B, int S, int H) {
  const int warp = (blockIdx.x * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= B * S * H) return;
  const int h = warp % H, i = (warp / H) % S, b = warp / (H * S);
  const T* orow = o + static_cast<size_t>(warp) * D;
  const T* drow = dout + static_cast<size_t>(warp) * D;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32) acc += to_f32(orow[d]) * to_f32(drow[d]);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) delta[(static_cast<size_t>(b) * H + h) * S + i] = acc;
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

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const float* lse,
                     float* delta, void* dq, void* dk, void* dv, int B, int S,
                     int T_len, int H, int KVH, float scale, int causal,
                     cudaStream_t s) {
  constexpr int QS = padded<T>(D);
  const T* q_t = static_cast<const T*>(q);
  const T* k_t = static_cast<const T*>(k);
  const T* v_t = static_cast<const T*>(v);
  const T* do_t = static_cast<const T*>(dout);
  const long long rows = static_cast<long long>(B) * S * H;
  const long long blocks = (rows * 32 + kThreads - 1) / kThreads;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  delta_kernel<T, D><<<static_cast<int>(blocks), kThreads, 0, s>>>(
      static_cast<const T*>(o), do_t, delta, B, S, H);
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
// lse and the scratch delta (B, H, S) f32; all contiguous, H % KVH == 0.
// Three launches on `stream`; returns the first failing launch's
// cudaError_t.
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
