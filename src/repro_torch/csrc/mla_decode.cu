// Single-token multi-head latent attention (MLA) over the latent cache
// (K3-mla), hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes the attention of its
// MLA decode step, src/repro/models/model.py::_decode_mla (:970), with
// plain einsums. The port runs it as one kernel, as it runs the dense
// decode (K3) in place of `_decode_attention`'s einsums. With weight
// absorption the step is MQA in the latent space, every query head
// reading the one shared latent head:
//   q_abs (B, 1, H, R), q_rope (B, 1, H, DR), c_kv (B, T, R),
//   k_rope (B, T, DR);
//   s[b, h, t] = scale * (q_abs[b, h] . c_kv[b, t] + q_rope[b, h] .
//                k_rope[b, t])  over t <= length (t < T),
//   lat[b, h] = sum_t softmax_t(s)[b, h, t] c_kv[b, t]   (B, 1, H, R)
// The products and the softmax in f32; in bf16 the softmax weights are
// rounded to bf16 before the product with c_kv (model.py:1001, which
// rounds the normalized weights; here each block rounds its weights
// under its running max, the same rounding at another scale), `lat`
// accumulated in f32 and cast once to q's type. f32 or bf16 (every input
// and the output of one type); (R, DR) = (512, 64), DeepSeek-V3's
// kv_lora_rank and qk_rope_dim; any H >= 1 (128 at published widths),
// in groups of kHG heads, the last one partial.
//
// What bounds it on an H100: bytes at the published shapes. A call
// reads the valid cache once, n (R + DR) elements a batch row, and the
// queries; it does 2 H n (2 R + DR) operations: at B 1, H 128, n 2560
// in bf16 2.9 MB (0.88 us at 3.35 TB/s) and 0.71 GFLOP (0.72 us at the
// tensor cores' 989 TFLOP/s). H = 128 query heads share every cache
// row, so the heads are the dimension the design reuses a row over.
// What the design does about it (a simple first design, the products on
// the CUDA cores):
// - A block of 256 threads serves kHG = 16 query heads of one batch row
//   (fewer in a last partial group, its missing query rows zero)
//   over a contiguous range of the valid positions; the ranges of a
//   (batch row, head group) are the blocks of one thread-block cluster
//   (the wrapper's `cluster_plan`, as K3's: about one block an SM, at
//   most 16 a cluster). So a cache row is read by H / kHG blocks (from
//   L2 after the first), not by H.
// - The block's 16 query rows (R + DR = 576 values each) are widened
//   into shared memory once; the range goes through tiles of kTT = 32
//   positions, each row of c_kv and k_rope widened into one 576-wide
//   shared row with 16-byte loads (a thread's 9 (bf16) or 18 (f32) loads
//   of a tile in flight at once). Rows are kQP = 580 floats apart, so
//   the 8 threads of a 16-byte load phase that read 8 query rows hit 8
//   bank groups.
// - Scores: a thread a head and two positions, f32 FMAs over the 576
//   dims (float4 from shared memory); the online softmax a warp two
//   heads, a lane a position (kTT = 32); the value product a thread four
//   heads by eight columns (stride 64: conflict-free), 32 f32
//   accumulators in registers, rescaled at each tile's new max.
// - The blocks of a cluster merge their (max, sum, accumulator) through
//   distributed shared memory as K3 does: each thread sends its 32
//   elements to the blocks that own those shares of the output, then
//   after one cluster barrier every block weighs the parts and writes
//   its share. One launch, no workspace.
// No position past the last valid one is read.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dtype.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kR = 512;               // kv_lora_rank: the latent dim
constexpr int kDR = 64;               // qk_rope_dim
constexpr int kDK = kR + kDR;         // a score's dot product
constexpr int kQP = kDK + 4;          // shared row pitch, floats
constexpr int kHG = 16;               // query heads a block
constexpr int kTT = 32;               // positions a tile (a warp's lanes)
constexpr int kMaxCluster = 16;       // blocks a cluster (non-portable)
constexpr int kOut = kHG * kR;        // a block's output elements
// the value product: a thread 4 heads x 8 columns (column c + 64 j)
constexpr int kAccH = 4, kAccC = 8;
static_assert(kThreads == (kHG / kAccH) * (kR / kAccC) &&
                  kThreads == kHG * kTT / 2 && kTT == 32,
              "thread maps");

// dynamic shared memory, in floats: q rows, the tile's rows, the
// scores / weights (head-major), what the other blocks of the cluster
// send (their part of this block's share, their (max, sum)), their
// weights, and the running (max, sum, rescale) of the block's heads
constexpr int kOffQ = 0;
constexpr int kOffKV = kOffQ + kHG * kQP;
constexpr int kOffP = kOffKV + kTT * kQP;
constexpr int kOffX = kOffP + kHG * kTT;
constexpr int kOffXM = kOffX + kOut + kMaxCluster;
constexpr int kOffXL = kOffXM + kMaxCluster * kHG;
constexpr int kOffXW = kOffXL + kMaxCluster * kHG;
constexpr int kOffRun = kOffXW + kMaxCluster * kHG;
constexpr int kSmemFloats = kOffRun + 3 * kHG;
constexpr int kSmemBytes = kSmemFloats * 4;
static_assert(kOffKV % 4 == 0 && kOffP % 4 == 0 && kQP % 4 == 0 &&
                  kSmemBytes <= 232448,
              "shared-memory plan");

__device__ __forceinline__ float rescale(float m, float M) {
  return m == M ? 1.f : expf(m - M);  // also -inf against -inf
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// one 16-byte vector of T's widened into f32 at dst (16-byte aligned)
template <typename T>
__device__ __forceinline__ void widen_store(float* dst, const uint4& v);
template <>
__device__ __forceinline__ void widen_store<float>(float* dst,
                                                   const uint4& v) {
  *reinterpret_cast<uint4*>(dst) = v;
}
template <>
__device__ __forceinline__ void widen_store<__nv_bfloat16>(float* dst,
                                                           const uint4& v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  float f[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
  reinterpret_cast<float4*>(dst)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// the weight as the value product takes it: bf16 rounds it
template <typename T>
__device__ __forceinline__ float as_weight(float p) {
  return to_f32(from_f32<T>(p));
}

// `n` rows of (a, b) widened into 576-wide shared rows at `dst`: row i's
// first kR values from a + i * kR, the last kDR from b + i * kDR; rows
// n..ROWS-1 zero. A thread issues all of its 16-byte loads before it
// stores any, so their device-memory round trips overlap.
template <typename T, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const T* a, const T* b,
                                          int n, int tid) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  constexpr int NV = kDK / VEC;  // vectors a row
  constexpr int ITERS = (ROWS * NV + kThreads - 1) / kThreads;
  uint4 v[ITERS];
#pragma unroll
  for (int k = 0; k < ITERS; ++k) {
    const int i = tid + k * kThreads;
    const int r = i / NV, c = (i % NV) * VEC;
    v[k] = make_uint4(0u, 0u, 0u, 0u);
    if (i < ROWS * NV && r < n)
      v[k] = *reinterpret_cast<const uint4*>(
          c < kR ? a + static_cast<size_t>(r) * kR + c
                 : b + static_cast<size_t>(r) * kDR + (c - kR));
  }
#pragma unroll
  for (int k = 0; k < ITERS; ++k) {
    const int i = tid + k * kThreads;
    if (i < ROWS * NV)
      widen_store<T>(dst + (i / NV) * kQP + (i % NV) * VEC, v[k]);
  }
}

// Grid (B * H / kHG, 1, n_splits), clusters of (1, 1, n_splits): block z
// of a cluster takes positions [z * per, min((z + 1) * per, n_valid)).
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
mla_decode_kernel(const T* __restrict__ q_abs, const T* __restrict__ q_rope,
                  const T* __restrict__ c_kv, const T* __restrict__ k_rope,
                  T* __restrict__ lat, int T_len, int H, int n_valid,
                  int per, float scale) {
  extern __shared__ __align__(16) float sm[];
  float* q_s = sm + kOffQ;
  float* kv_s = sm + kOffKV;
  float* p_s = sm + kOffP;
  float* xacc = sm + kOffX;
  float* xm = sm + kOffXM;  // [block][head]
  float* xl = sm + kOffXL;
  float* xw = sm + kOffXW;
  float* m_s = sm + kOffRun;
  float* l_s = m_s + kHG;
  float* c_s = l_s + kHG;

  cg::cluster_group cluster = cg::this_cluster();
  // this block has started: the others may write into it once all have
  cluster_arrive_relaxed();
  const int n_blocks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int groups = (H + kHG - 1) / kHG;
  const int b = blockIdx.x / groups, h0 = (blockIdx.x % groups) * kHG;
  const int ng = min(kHG, H - h0);  // the group's heads (rows past: zero)
  const int t_begin = blockIdx.z * per;
  const int t_end = min(n_valid, t_begin + per);  // > t_begin
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const size_t qrow = static_cast<size_t>(b) * H + h0;  // first query row
  load_rows<T, kHG>(q_s, q_abs + qrow * kR, q_rope + qrow * kDR, ng, tid);
  if (tid < kHG) {
    m_s[tid] = neg_inf();
    l_s[tid] = 0.f;
  }
  const T* c_b = c_kv + static_cast<size_t>(b) * T_len * kR;
  const T* r_b = k_rope + static_cast<size_t>(b) * T_len * kDR;

  // the value product's thread: heads 4 ah.., columns ac + 64 j
  const int ah = tid / (kR / kAccC), ac = tid % (kR / kAccC);
  float acc[kAccH][kAccC];
#pragma unroll
  for (int i = 0; i < kAccH; ++i)
#pragma unroll
    for (int j = 0; j < kAccC; ++j) acc[i][j] = 0.f;
  // the scores' thread: head sh, positions st and st + 16
  const int sh = tid % kHG, st = tid / kHG;

  for (int t0 = t_begin; t0 < t_end; t0 += kTT) {
    const int nt = min(kTT, t_end - t0);
    __syncthreads();  // the last tile's rows and weights are read
    load_rows<T, kTT>(kv_s, c_b + static_cast<size_t>(t0) * kR,
                      r_b + static_cast<size_t>(t0) * kDR, nt, tid);
    __syncthreads();

    // 1. scores of head sh at positions st, st + 16
    {
      const float* qr = q_s + sh * kQP;
      const float* k0 = kv_s + st * kQP;
      const float* k1 = kv_s + (st + 16) * kQP;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll 8
      for (int d = 0; d < kDK; d += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(qr + d);
        const float4 a = *reinterpret_cast<const float4*>(k0 + d);
        const float4 c = *reinterpret_cast<const float4*>(k1 + d);
        s0 += qv.x * a.x + qv.y * a.y + qv.z * a.z + qv.w * a.w;
        s1 += qv.x * c.x + qv.y * c.y + qv.z * c.z + qv.w * c.w;
      }
      p_s[sh * kTT + st] = st < nt ? s0 * scale : neg_inf();
      p_s[sh * kTT + st + 16] = st + 16 < nt ? s1 * scale : neg_inf();
    }
    __syncthreads();

    // 2. online softmax: warp w heads 2w, 2w + 1, a lane a position; the
    //    scores become the weights
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int h = 2 * warp + k;
      const float s = p_s[h * kTT + lane];
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[h];
      const float m_new = fmaxf(m_old, mx);
      // the first tile of a range holds a valid position, so m_new is
      // finite; the guard keeps a row of -inf at weight 0
      const float m_use = m_new == neg_inf() ? 0.f : m_new;
      const float p = expf(s - m_use);
      p_s[h * kTT + lane] = as_weight<T>(p);
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        const float corr = rescale(m_old, m_new);
        c_s[h] = corr;
        l_s[h] = l_s[h] * corr + sum;
        m_s[h] = m_new;
      }
    }
    __syncthreads();

    // 3. acc = acc * corr + p c_kv
#pragma unroll
    for (int i = 0; i < kAccH; ++i) {
      const float corr = c_s[kAccH * ah + i];
#pragma unroll
      for (int j = 0; j < kAccC; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int t = 0; t < nt; ++t) {
      float p[kAccH], c[kAccC];
#pragma unroll
      for (int i = 0; i < kAccH; ++i) p[i] = p_s[(kAccH * ah + i) * kTT + t];
#pragma unroll
      for (int j = 0; j < kAccC; ++j) c[j] = kv_s[t * kQP + ac + 64 * j];
#pragma unroll
      for (int i = 0; i < kAccH; ++i)
#pragma unroll
        for (int j = 0; j < kAccC; ++j) acc[i][j] += p[i] * c[j];
    }
  }

  // the merge: element e = h * kR + col of the block's output goes to
  // block e / share, which weighs the cluster's n_blocks parts of it
  const int share = (kOut + n_blocks - 1) / n_blocks;
  cluster_wait();  // every block of the cluster has started
#pragma unroll
  for (int i = 0; i < kAccH; ++i)
#pragma unroll
    for (int j = 0; j < kAccC; ++j) {
      const int e = (kAccH * ah + i) * kR + ac + 64 * j;
      const int to = e / share;
      cluster.map_shared_rank(xacc, to)[rank * share + (e - to * share)] =
          acc[i][j];
    }
  if (tid < kHG * n_blocks) {
    const int h = tid % kHG, to = tid / kHG;
    cluster.map_shared_rank(xm, to)[rank * kHG + h] = m_s[h];
    cluster.map_shared_rank(xl, to)[rank * kHG + h] = l_s[h];
  }
  cluster_arrive();
  cluster_wait();  // every part of this block's share has arrived

  // the weight of block r's part of head h, exp(m_r - M) / L (warp w
  // heads 2w, 2w + 1, lane r)
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int h = 2 * warp + k;
    const bool has = lane < n_blocks;
    const float mr = has ? xm[lane * kHG + h] : neg_inf();
    float Mx = mr;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      Mx = fmaxf(Mx, __shfl_xor_sync(0xffffffffu, Mx, o));
    const float c = has ? rescale(mr, Mx) : 0.f;
    float L = has ? xl[lane * kHG + h] * c : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      L += __shfl_xor_sync(0xffffffffu, L, o);
    // every range holds a valid position, so L > 0
    if (has) xw[lane * kHG + h] = c / L;
  }
  __syncthreads();
  for (int e = tid; e < share && rank * share + e < ng * kR;
       e += kThreads) {
    const int i = rank * share + e, h = i / kR;
    float a = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < n_blocks) a += xw[r * kHG + h] * xacc[r * share + e];
    lat[qrow * kR + i] = from_f32<T>(a);
  }
}

template <typename T>
cudaError_t launch(const void* q_abs, const void* q_rope, const void* c_kv,
                   const void* k_rope, void* lat, int B, int T_len, int H,
                   int n_valid, int per, int n_splits, float scale,
                   cudaStream_t s) {
  auto kern = mla_decode_kernel<T>;
  static bool attrs_set = false;
  if (!attrs_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    attrs_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * ((H + kHG - 1) / kHG), 1, n_splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = n_splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(q_abs),
                           static_cast<const T*>(q_rope),
                           static_cast<const T*>(c_kv),
                           static_cast<const T*>(k_rope),
                           static_cast<T*>(lat), T_len, H, n_valid, per,
                           scale);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q_abs (B, 1, H, R), q_rope (B, 1, H,
// DR), c_kv (B, T, R), k_rope (B, T, DR), lat like q_abs, all contiguous
// and 16-byte aligned; (R, DR) = (512, 64), H >= 1; length
// >= 0 (a host int). The min(length + 1, T) valid positions are cut
// into n_splits <= 16 ranges of per positions, none of them empty, the
// blocks of one cluster. Returns the launch's cudaError_t.
extern "C" int mla_decode_attention(int dtype, const void* q_abs,
                                    const void* q_rope, const void* c_kv,
                                    const void* k_rope, void* lat, int B,
                                    int T_len, int H, int R, int DR,
                                    int length, int per, int n_splits,
                                    float scale, void* stream) {
  if (B < 1 || T_len < 1 || H < 1 || R != kR || DR != kDR || length < 0 ||
      per < 1 || n_splits < 1 || n_splits > kMaxCluster ||
      static_cast<long long>(B) * ((H + kHG - 1) / kHG) > 0x7fffffff)
    return cudaErrorInvalidValue;
  const int n_valid = length < T_len ? length + 1 : T_len;
  if (static_cast<long long>(per) * n_splits < n_valid ||
      static_cast<long long>(per) * (n_splits - 1) >= n_valid)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q_abs, q_rope, c_kv, k_rope, lat, B, T_len, H,
                         n_valid, per, n_splits, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q_abs, q_rope, c_kv, k_rope, lat, B, T_len,
                                 H, n_valid, per, n_splits, scale, s);
  return cudaErrorInvalidValue;
}
