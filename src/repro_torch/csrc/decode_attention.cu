// Single-token GQA attention over a KV cache (flash decode, K3),
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// decode_attention (`_decode_kernel`, pallas_call at :104), with its
// contract: q (B, 1, H, D), caches (B, T, KVH, D), H = KVH * G;
//   out[b, h] = softmax_t(scale * q[b, h] . k[b, t, h / G]) v[b, t, h / G]
// over the positions t <= length (t < T); the later positions are
// masked and never read. Products and the online softmax in f32, the
// output cast to q's type. f32 or bf16 (q, k, v and out of one type),
// D in {16, 32, 64, 80, 128, 256}.
//
// What bounds it on an H100: bytes. Each call must read the valid part
// of both caches once, 2 * min(length + 1, T) * KVH * D elements; the
// arithmetic is 4 * G operations per element read, far below the rate
// that would make it compute-bound. At B = 1 there are only KVH kv
// heads (8 for Qwen3-4B), so one block per kv head would keep 8 of the
// card's 132 SMs busy and read the cache at a small share of the HBM
// rate.
// What the design does about it (split-K, "flash decoding"):
// - The valid positions are cut into `n_splits` contiguous ranges, and
//   each (batch row, kv head, group of up to kMaxG query heads, range)
//   gets a block, so a long cache spreads over the whole card. The
//   wrapper picks n_splits from the SM count.
// - In a block, each warp walks its own positions; a row of k or v is
//   read with 16-byte loads by LPR lanes (16 lanes for bf16 at D = 128,
//   so one warp reads two rows at once), kU rows per lane group are in
//   flight before the first use. The G query rows stay in registers and
//   share every k and v row that is read, as in the TPU kernel. Each
//   lane group keeps its own running max, sum and f32 accumulator.
// - The lane groups of a warp merge by shuffles, the warps of a block
//   through shared memory. With one range the block writes the output;
//   otherwise it writes its (max, sum, accumulator) to an f32
//   workspace, and a second kernel merges the ranges of each query row
//   and writes the output.
// No position past the last valid one is read: the TPU kernel skips the
// blocks past `length` the same way.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dtype.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;  // query heads a block serves at most
constexpr int kU = 4;     // rows in flight per lane group

__host__ __device__ constexpr int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p *= 2;
  return p;
}

// A row of D elements is NVEC 16-byte vectors, read by a lane group of
// LPR lanes, a power of two (the shuffles halve it). Where NVEC is not a
// power of two (D = 80: 10 vectors in bf16, 20 in f32), the group is the next
// power of two and its last lanes own no vector: they load nothing and
// add zeros.
template <typename T, int D>
struct Layout {
  static constexpr int VEC = 16 / static_cast<int>(sizeof(T));  // elems/16 B
  static constexpr int NVEC = D / VEC;         // 16-byte vectors in a row
  static constexpr int LPR = NVEC < 32 ? pow2_at_least(NVEC) : 32;  // lanes
  static constexpr int NV = (NVEC + LPR - 1) / LPR;  // vectors per lane
  static constexpr int EPL = NV * VEC;         // elements per lane
  static constexpr int RPW = 32 / LPR;         // rows a warp reads at once
  static_assert(NVEC * VEC == D && NV * LPR >= NVEC && RPW * LPR == 32,
                "unsupported head dim");
  // whether lane j of a group owns its n-th vector
  __device__ static bool owns(int j, int n) { return j + n * LPR < NVEC; }
};

// one 16-byte vector widened to f32
__device__ __forceinline__ void widen(const uint4& v, float* out,
                                      const float*) {
  out[0] = __uint_as_float(v.x);
  out[1] = __uint_as_float(v.y);
  out[2] = __uint_as_float(v.z);
  out[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void widen(const uint4& v, float* out,
                                      const __nv_bfloat16*) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h;
    *reinterpret_cast<uint32_t*>(&h) = w[i];
    const float2 f = __bfloat1622float2(h);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// the part of a row that lane j of its lane group owns: vectors j,
// j + LPR, ... (NV of them, zeros past the row), loaded raw (16 bytes
// each) ...
template <typename T, int D>
__device__ __forceinline__ void load_raw(const T* row, int j, uint4* out) {
  using L = Layout<T, D>;
#pragma unroll
  for (int n = 0; n < L::NV; ++n)
    out[n] = L::owns(j, n)
                 ? __ldg(reinterpret_cast<const uint4*>(
                       row + (j + n * L::LPR) * L::VEC))
                 : make_uint4(0u, 0u, 0u, 0u);
}
// ... and widened to its EPL f32 elements
template <typename T, int D>
__device__ __forceinline__ void widen_part(const uint4* raw, float* out) {
  using L = Layout<T, D>;
#pragma unroll
  for (int n = 0; n < L::NV; ++n)
    widen(raw[n], out + n * L::VEC, static_cast<const T*>(nullptr));
}

// the weight of a running (max m) when merged under the new max M
__device__ __forceinline__ float rescale(float m, float M) {
  return m == M ? 1.f : expf(m - M);  // also -inf against -inf
}

// GM: the query heads a block serves (1, 4 or kMaxG), so that the
// registers of heads a group does not have are not spent
template <typename T, int D, int GM>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc, T* __restrict__ out,
                        float* __restrict__ ws, int B, int T_len, int KVH,
                        int G, int n_valid, int per_split, float scale) {
  using L = Layout<T, D>;
  constexpr int EPL = L::EPL;
  __shared__ float red_m[kWarps][GM];
  __shared__ float red_l[kWarps][GM];
  __shared__ float red_acc[kWarps][GM][D];

  const int b = blockIdx.x / KVH, kvh = blockIdx.x % KVH;
  const int g0 = blockIdx.y * GM;
  const int ng = min(GM, G - g0);
  const int split = blockIdx.z;
  const int t_begin = split * per_split;
  const int t_end = min(n_valid, t_begin + per_split);
  const int H = KVH * G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane / L::LPR, j = lane % L::LPR;

  // the block's query rows, pre-scaled, in registers
  const T* q_b = q + (static_cast<size_t>(b) * H + kvh * G + g0) * D;
  float qr[GM][EPL];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g < ng) {
      uint4 raw[L::NV];
      load_raw<T, D>(q_b + g * D, j, raw);
      widen_part<T, D>(raw, qr[g]);
#pragma unroll
      for (int e = 0; e < EPL; ++e) qr[g][e] *= scale;
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) qr[g][e] = 0.f;
    }
  }
  float m[GM], l[GM], acc[GM][EPL];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = neg_inf();
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  const size_t row_stride = static_cast<size_t>(KVH) * D;  // one position
  const T* k_b = kc + static_cast<size_t>(b) * T_len * row_stride + kvh * D;
  const T* v_b = vc + static_cast<size_t>(b) * T_len * row_stride + kvh * D;
  // rows one pass of the block covers: warp w, lane group r, slot u
  // reads row t0 + u * kStep + w * RPW + r
  constexpr int kStep = kWarps * L::RPW;
  for (int t0 = t_begin; t0 < t_end; t0 += kStep * kU) {
    uint4 kr[kU][L::NV], vr[kU][L::NV];
    bool ok[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int t = t0 + u * kStep + warp * L::RPW + grp;
      ok[u] = t < t_end;
      if (ok[u]) {
        load_raw<T, D>(k_b + t * row_stride, j, kr[u]);
        load_raw<T, D>(v_b + t * row_stride, j, vr[u]);
      } else {
#pragma unroll
        for (int n = 0; n < L::NV; ++n)
          kr[u][n] = vr[u][n] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    // scores: partial dots, then the sum over the row's LPR lanes (the
    // shuffles stay inside a lane group; every lane of the warp takes
    // part, as the loop is uniform across the warp)
    float s[kU][GM];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      float kf[EPL];
      widen_part<T, D>(kr[u], kf);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) a += qr[g][e] * kf[e];
#pragma unroll
        for (int o = L::LPR / 2; o > 0; o >>= 1)
          a += __shfl_xor_sync(0xffffffffu, a, o);
        s[u][g] = a;
      }
    }
    // online softmax over this pass's kU rows
    float p[kU][GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < kU; ++u)
        if (ok[u]) mx = fmaxf(mx, s[u][g]);
      const float corr = rescale(m[g], mx);
      l[g] *= corr;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= corr;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        p[u][g] = ok[u] ? expf(s[u][g] - mx) : 0.f;
        l[g] += p[u][g];
      }
      m[g] = mx;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      float vf[EPL];
      widen_part<T, D>(vr[u], vf);
#pragma unroll
      for (int g = 0; g < GM; ++g)
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] += p[u][g] * vf[e];
    }
  }

  // merge the lane groups of the warp: lane j of each group holds the
  // same elements
#pragma unroll
  for (int o = L::LPR; o < 32; o <<= 1)
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float M = fmaxf(m[g], mo);
      const float a = rescale(m[g], M), c = rescale(mo, M);
      l[g] = l[g] * a + lo * c;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
        acc[g][e] = acc[g][e] * a + ao * c;
      }
      m[g] = M;
    }
  // then the warps, through shared memory
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (j == 0) {
        red_m[warp][g] = m[g];
        red_l[warp][g] = l[g];
      }
#pragma unroll
      for (int n = 0; n < L::NV; ++n)
        if (L::owns(j, n))
#pragma unroll
          for (int i = 0; i < L::VEC; ++i)
            red_acc[warp][g][(j + n * L::LPR) * L::VEC + i] =
                acc[g][n * L::VEC + i];
    }
  }
  __syncthreads();
  const int BH = B * H;
  const int row0 = b * H + kvh * G + g0;  // the block's first query row
  for (int i = threadIdx.x; i < ng * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float M = neg_inf();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, red_m[w][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = rescale(red_m[w][g], M);
      lsum += red_l[w][g] * c;
      a += red_acc[w][g][d] * c;
    }
    if (ws == nullptr) {
      // a range holds at least one valid position, so lsum > 0
      out[static_cast<size_t>(row0 + g) * D + d] = from_f32<T>(a / lsum);
    } else {
      // workspace: acc (n_splits, B * H, D), then (max, sum) pairs
      // (n_splits, B * H, 2)
      const size_t r = static_cast<size_t>(split) * BH + row0 + g;
      ws[r * D + d] = a;
      if (d == 0) {
        float* ml = ws + static_cast<size_t>(gridDim.z) * BH * D;
        ml[2 * r] = M;
        ml[2 * r + 1] = lsum;
      }
    }
  }
}

// merges the n_splits partial results of each query row: one block per
// (batch row, query head)
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ ws, T* __restrict__ out,
                      int BH, int D, int n_splits) {
  const int r = blockIdx.x;
  const float* ml = ws + static_cast<size_t>(n_splits) * BH * D;
  float M = neg_inf();
  for (int s = 0; s < n_splits; ++s)
    M = fmaxf(M, ml[2 * (static_cast<size_t>(s) * BH + r)]);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float lsum = 0.f, a = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const size_t rs = static_cast<size_t>(s) * BH + r;
      const float c = rescale(ml[2 * rs], M);
      lsum += ml[2 * rs + 1] * c;
      a += ws[rs * D + d] * c;
    }
    out[static_cast<size_t>(r) * D + d] = from_f32<T>(a / lsum);
  }
}

template <typename T, int D, int GM>
void launch_g(const T* q, const T* k, const T* v, T* out, float* ws, int B,
              int T_len, int KVH, int G, int n_valid, int per_split,
              int n_splits, float scale, cudaStream_t s) {
  const dim3 grid(B * KVH, (G + GM - 1) / GM, n_splits);
  decode_attention_kernel<T, D, GM><<<grid, kThreads, 0, s>>>(
      q, k, v, out, n_splits > 1 ? ws : nullptr, B, T_len, KVH, G, n_valid,
      per_split, scale);
}

template <typename T, int D>
cudaError_t launch_d(const T* q, const T* k, const T* v, T* out, float* ws,
                     int B, int T_len, int KVH, int G, int n_valid,
                     int per_split, int n_splits, float scale,
                     cudaStream_t s) {
  if (G == 1)
    launch_g<T, D, 1>(q, k, v, out, ws, B, T_len, KVH, G, n_valid,
                      per_split, n_splits, scale, s);
  else if (G <= 4)
    launch_g<T, D, 4>(q, k, v, out, ws, B, T_len, KVH, G, n_valid,
                      per_split, n_splits, scale, s);
  else
    launch_g<T, D, kMaxG>(q, k, v, out, ws, B, T_len, KVH, G, n_valid,
                          per_split, n_splits, scale, s);
  if (n_splits > 1)
    decode_combine_kernel<T><<<B * KVH * G, kThreads, 0, s>>>(
        ws, out, B * KVH * G, D, n_splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* ws, int B, int T_len, int KVH, int G, int D,
                   int n_valid, int per_split, int n_splits, float scale,
                   cudaStream_t s) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
#define DECODE_CASE(DD)                                                   \
  case DD:                                                                \
    return launch_d<T, DD>(qt, kt, vt, ot, ws, B, T_len, KVH, G, n_valid, \
                           per_split, n_splits, scale, s);
  switch (D) {
    DECODE_CASE(16)
    DECODE_CASE(32)
    DECODE_CASE(64)
    DECODE_CASE(80)
    DECODE_CASE(128)
    DECODE_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef DECODE_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q (B, 1, KVH * G, D), k and v
// (B, T, KVH, D), out like q, all contiguous and 16-byte aligned;
// length >= 0 (a host int). The min(length + 1, T) valid positions are
// cut into n_splits ranges of per_split positions, none of them empty;
// with n_splits > 1, ws holds n_splits * B * KVH * G * (D + 2) floats.
// Returns the launches' cudaError_t.
extern "C" int decode_attention(int dtype, const void* q, const void* k,
                                const void* v, void* out, void* ws, int B,
                                int T_len, int KVH, int G, int D, int length,
                                int per_split, int n_splits, float scale,
                                void* stream) {
  if (B < 1 || T_len < 1 || KVH < 1 || G < 1 || length < 0 ||
      per_split < 1 || n_splits < 1 || n_splits > 65535)
    return cudaErrorInvalidValue;
  const int n_valid = length < T_len ? length + 1 : T_len;
  if (static_cast<long long>(per_split) * n_splits < n_valid ||
      static_cast<long long>(per_split) * (n_splits - 1) >= n_valid ||
      (n_splits > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  if (dtype == 0)
    return launch<float>(q, k, v, out, w, B, T_len, KVH, G, D, n_valid,
                         per_split, n_splits, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, w, B, T_len, KVH, G, D,
                                 n_valid, per_split, n_splits, scale, s);
  return cudaErrorInvalidValue;
}
