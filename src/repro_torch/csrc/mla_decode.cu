// Single-token multi-head latent attention (MLA) over the latent cache
// (K3-mla), hand-written for Hopper (sm_90a), in two bodies.
//
// Replaces no TPU kernel: the JAX package computes the attention of its
// MLA decode step, src/repro/models/model.py::_decode_mla (:970), with
// plain einsums (weight absorption, :995-1007): the scores einsums
// "bshr,btr->bhst" (q_abs against c_kv) and "bshk,btk->bhst" (q_rope
// against k_rope), the softmax, and "bhst,btr->bshr" (the weights
// against c_kv). The port runs them as one kernel, as it runs the dense
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
// accumulated in f32 and cast once to q's type. (R, DR) = (512, 64),
// DeepSeek-V3's kv_lora_rank and qk_rope_dim; any H >= 1 (128 at
// published widths), in groups of kHG = 16 heads, the last one partial.
//
// What bounds it on an H100: bytes at the published shapes. A call
// reads the valid cache once, n (R + DR) elements a batch row, and the
// queries; it does 2 H n (2 R + DR) operations: at B 1, H 128, n 2560
// in bf16 2.9 MB (0.88 us at 3.35 TB/s) and 0.71 GFLOP (0.72 us at the
// tensor cores' 989 TFLOP/s). H = 128 query heads share every cache
// row, so the heads are the dimension the design reuses a row over.
//
// Shared by both bodies:
// - A block of 256 threads serves kHG = 16 query heads of one batch row
//   (fewer in a last partial group, its missing query rows zero) over a
//   contiguous range of the valid positions; the ranges of a (batch row,
//   head group) are the blocks of one thread-block cluster (the
//   wrapper's `cluster_plan`, as K3's: about one block an SM, at most 16
//   a cluster). So a cache row is read from device memory once and by
//   H / kHG blocks from L2, not by H.
// - The range goes through tiles of kTT = 32 positions with an online
//   softmax in f32 (running max and sum a head, the accumulator rescaled
//   at each tile's new max).
// - The blocks of a cluster merge their (max, sum, accumulator) through
//   distributed shared memory, each block weighing the parts of its
//   share of the output and writing it. One launch, no workspace, no
//   atomics: a repeated call gives the same bits.
// - No position past the last valid one is read.
//
// The tensor-core body (mla_decode_mma_kernel; bf16 only, the served
// dtype). Both products fit mma.sync.m16n8k16 (bf16 in, f32 sums) with
// the block's 16 heads as M, and a product of two bf16 values is exact
// in f32, so it computes what the CUDA-core body computes, in another
// order of f32 sums:
// - Tiles stay bf16 in shared memory, in a ring of two stages: thread 0
//   brings a tile's 32 rows of [c_kv, k_rope] (36,864 B) as nine TMA
//   boxes of 64 columns (128 B a row, the TMA's 128-byte swizzle, so the
//   8 rows of an ldmatrix fall in 8 bank groups), completing on the
//   stage's mbarrier, two tiles ahead of the products. The tensor maps
//   (`latent_map`) cover the valid positions only: a last tile's rows
//   past them come in as zeros, and no position past `length` is read.
// - Scores S (16 x 32) = q_abs . c_kv^T + q_rope . k_rope^T: warp w
//   takes positions 16 (w / 4).. (two n8 tiles) and a quarter of the 36
//   k-steps (w % 4); its query A fragments (9 k-steps) sit in registers
//   for the whole range, read from device memory once; B by ldmatrix
//   from the tile. The four quarters meet in a small f32 array.
// - The online softmax (warp w heads 2w and 2w + 1 at once, 16 lanes a
//   head, two positions a lane) writes P, each weight rounded to bf16
//   under the running max, to shared memory (16 x 32 bf16, pitch 40).
// - Value product lat (16 x 512) += P (16 x 32) . c_kv (32 x 512): warp
//   w takes columns 64 w.. (8 n8 tiles, 32 f32 accumulators a thread);
//   A is P (ldmatrix), B the same c_kv tile (ldmatrix.trans). One shared
//   tile serves both products. Three block barriers a tile.
// - The merge: each block lays its accumulator out in its own shared
//   memory (on the ring, idle by then); after a cluster barrier every
//   thread sends it in 16-byte pieces (whole rows of a warp to one
//   block) to the blocks that own those shares of the output, with the
//   block's (max, sum); after a second one each block weighs the parts
//   of its share in its own memory. 86,480 B of shared memory a block:
//   two blocks share an SM.
// - Why boxes and 16-byte pieces: on an H100 (scripts/mla_timing.py, B
//   1, T 2560, device time) the first form of this body (16-byte
//   cp.async by every thread, the softmax a head at a time, the merge in
//   4-byte pieces bound for 8 blocks a warp's store) took 28.9 us; one
//   bulk copy a row part, two heads at once and a pulling merge 25.8;
//   the nine boxes 18.8; 16-byte pushes 18.3. What is left
//   (scripts/mla_phase_probe.py): a tile every ~1.1 us, the merge ~4.3
//   us of a block's ~12.3, and blocks of two clusters sharing an SM.
//
// The CUDA-core body (mla_decode_kernel; f32, and bf16 when asked for):
// - The block's 16 query rows (R + DR = 576 values each) are widened
//   into shared memory once; each tile's rows of c_kv and k_rope are
//   widened into one 576-wide f32 shared row with 16-byte loads (a
//   thread's 9 (bf16) or 18 (f32) loads of a tile in flight at once).
//   Rows are kQP = 580 floats apart, so the 8 threads of a 16-byte load
//   phase that read 8 query rows hit 8 bank groups.
// - Scores: a thread a head and two positions, f32 FMAs over the 576
//   dims (float4 from shared memory); the online softmax a warp two
//   heads, a lane a position; the value product a thread four heads by
//   eight columns (stride 64: conflict-free), 32 f32 accumulators in
//   registers. 149,504 B of shared memory: one block an SM. The score
//   loop re-reads every 576-float row from shared memory once a head.
// - The merge pushes: after a cluster barrier each thread sends its 32
//   accumulator elements to the blocks that own those shares of the
//   output; after a second one every block weighs what it received.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dtype.cuh"
#include "mbarrier.cuh"
#include "tma.cuh"

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

// ------------------------------------------------ the tensor-core body
constexpr int kBoxW = 64;              // a TMA box's columns (128 B)
constexpr int kBox = kTT * kBoxW * 2;  // a box of a tile's rows, bytes
constexpr int kNBox = kDK / kBoxW;     // boxes a tile: 8 of c_kv, 1 rope
constexpr int kMStage = kNBox * kBox;  // a stage of the ring, bytes
constexpr int kMStages = 2;
constexpr int kKQ = 4;                 // the scores' k-split over warps
constexpr int kKS = kDK / 16 / kKQ;    // a warp's k-steps (of 16 dims)
constexpr int kSP = kTT + 8;           // partial score row pitch, floats
constexpr int kPP = kTT + 8;           // P row pitch, bf16 (5 granules)
constexpr int kWC = kR / 8;            // value columns a warp (8 warps)
constexpr int kXP = kR + 8;            // the merge's row pitch, floats
constexpr int kOut4 = kHG * kR / 4;    // a block's output, in float4
// dynamic shared memory, bytes from a 1024-byte aligned base (the
// swizzle's span; the launch asks 1 KB more to align it): the ring, the
// four partial scores [quarter][head][position], P [head][position] in
// bf16, the running (max, sum, rescale) of the block's heads, a stage's
// mbarrier each. The merge aliases the ring (the block's accumulator,
// [head][kXP] f32, then the parts of its share that the cluster's blocks
// send, [block][share] float4) and the partial scores (the cluster's
// (max, sum) and weights, [block][head] each).
constexpr int kMOffS = kMStages * kMStage;
constexpr int kMOffP = kMOffS + kKQ * kHG * kSP * 4;
constexpr int kMOffRun = kMOffP + kHG * kPP * 2;
constexpr int kMOffBar = kMOffRun + 3 * kHG * 4;
constexpr int kMSmemBytes = kMOffBar + kMStages * 8 + 1024;
static_assert(kDK % (16 * kKQ) == 0 && kR % kBoxW == 0 && kDR == kBoxW &&
                  kWC == kBoxW && kThreads / 32 == 8 && kTT == 2 * 16 &&
                  kHG == 16,
              "the mma body's maps");
static_assert(kBox % 1024 == 0 && (kPP * 2) % 16 == 0 &&
                  (kPP * 2 / 16) % 2 == 1 && kMOffP % 16 == 0 &&
                  kMOffBar % 8 == 0,
              "boxes on the swizzle's span; P's rows an odd number of "
              "granules");
static_assert((kHG * kXP + kHG * kR + 4 * kMaxCluster) * 4 <= kMOffS &&
                  kXP % 4 == 0 &&
                  3 * kMaxCluster * kHG * 4 <= kMOffP - kMOffS &&
                  2 * (kMSmemBytes + 1024) <= 233472,
              "the merge's aliases; two blocks an SM");

// the byte offset of row r's 16-byte granule holding dims d..d + 7 (d a
// multiple of 8) in a stage: box d / 64, its rows 128 B apart, granule
// (d / 8) % 8 stored at granule ((d / 8) % 8) ^ (r % 8) (the TMA's
// 128-byte swizzle)
__device__ __forceinline__ int tile_off(int r, int d) {
  return (d >> 6) * kBox + r * 128 + ((((d >> 3) & 7) ^ (r & 7)) << 4);
}

// mma.sync m16n8k16, bf16 in, f32 accumulate (PTX ISA fragment layouts,
// g = lane / 4, t = lane % 4): A (16 x 16, row) a0 (g, 2t..2t+1), a1
// (g + 8, 2t..), a2 (g, 2t + 8..), a3 (g + 8, 2t + 8..); B (16 x 8, col)
// b0 (k 2t..2t+1, n g), b1 (k 2t + 8.., n g); C c0, c1 (g, 2t..2t+1),
// c2, c3 (g + 8, 2t..)
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices from shared memory: lane l gives the address
// of row l % 8 of matrix l / 8; register j holds matrix j (lane: row
// l / 4, elements 2 (l % 4), + 1; with .trans the matrix transposed:
// elements (2 (l % 4), l / 4) and (2 (l % 4) + 1, l / 4))
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// two bf16 of a query row (4 bytes; zero for a row past the group)
__device__ __forceinline__ uint32_t q_pair(const __nv_bfloat16* p,
                                           bool has) {
  return has ? *reinterpret_cast<const uint32_t*>(p) : 0u;
}

// Grid (B * ceil(H / kHG), 1, n_splits), clusters of (1, 1, n_splits):
// block z of a cluster takes positions [z * per, min((z + 1) * per,
// n_valid)), in tiles of kTT. tm_c, tm_r: c_kv and k_rope as tensor maps
// over the n_valid valid positions (`latent_map`), so a tile's rows past
// them come in as zeros and are never read.
__global__ void __launch_bounds__(kThreads, 2)
mla_decode_mma_kernel(const __grid_constant__ CUtensorMap tm_c,
                      const __grid_constant__ CUtensorMap tm_r,
                      const __nv_bfloat16* __restrict__ q_abs,
                      const __nv_bfloat16* __restrict__ q_rope,
                      __nv_bfloat16* __restrict__ lat, int H, int n_valid,
                      int per, float scale) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(1024) unsigned char mla_smem[];
  unsigned char* dyn =
      mla_smem + ((1024 - (smem_u32(mla_smem) & 1023)) & 1023);
  unsigned char* ring = dyn;
  float* s_part = reinterpret_cast<float*>(dyn + kMOffS);
  bf16* p_s = reinterpret_cast<bf16*>(dyn + kMOffP);
  float* m_s = reinterpret_cast<float*>(dyn + kMOffRun);
  float* l_s = m_s + kHG;
  float* c_s = l_s + kHG;
  uint64_t* full = reinterpret_cast<uint64_t*>(dyn + kMOffBar);
  // the merge's buffers (after the loop): on the ring (the block's own
  // accumulator, then the parts of its share sent to it) and the scores
  float* xacc = reinterpret_cast<float*>(dyn);
  float* xrecv = xacc + kHG * kXP;  // [block][share][4]
  float* xm = s_part;  // [block][head]
  float* xl = xm + kMaxCluster * kHG;
  float* xw = xl + kMaxCluster * kHG;

  cg::cluster_group cluster = cg::this_cluster();
  const int n_blocks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int groups = (H + kHG - 1) / kHG;
  const int b = blockIdx.x / groups, h0 = (blockIdx.x % groups) * kHG;
  const int ng = min(kHG, H - h0);  // the group's heads (rows past: zero)
  const int t_begin = blockIdx.z * per;
  const int t_end = min(n_valid, t_begin + per);  // > t_begin
  const int n_tiles = (t_end - t_begin + kTT - 1) / kTT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  const size_t qrow = static_cast<size_t>(b) * H + h0;  // first query row

  if (tid == 0) {
    for (int i = 0; i < kMStages; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < kHG) {
    m_s[tid] = neg_inf();
    l_s[tid] = 0.f;
  }
  __syncthreads();
  // tile `it` of the range into stage it % 2 (thread 0): its 32 rows in
  // 9 boxes of 64 columns, 8 of c_kv and one of k_rope, completing on the
  // stage's mbarrier
  auto issue = [&](int it) {
    const int t0 = t_begin + it * kTT;
    unsigned char* dst = ring + (it & 1) * kMStage;
    mbar_expect_tx(&full[it & 1], kMStage);
    for (int j = 0; j < kNBox - 1; ++j)
      tma_load_4d(dst + j * kBox, &tm_c, &full[it & 1], j * kBoxW, 0, t0, b);
    tma_load_4d(dst + (kNBox - 1) * kBox, &tm_r, &full[it & 1], 0, 0, t0, b);
  };
  if (tid == 0) {
    issue(0);
    if (n_tiles > 1) issue(1);
  }

  // the scores' warp: positions 16 nh.., k-steps kKS kq..; its query A
  // fragments from device memory (rows g and g + 8 of the group)
  const int kq = warp % kKQ, nh = warp / kKQ;
  uint32_t qa[kKS][4];
#pragma unroll
  for (int j = 0; j < kKS; ++j) {
    const int d = (kq * kKS + j) * 16 + 2 * t4;  // a k-step is in one part
    const bf16* src = d < kR ? q_abs + qrow * kR + d
                             : q_rope + qrow * kDR + (d - kR);
    const int stride = d < kR ? kR : kDR;
    qa[j][0] = q_pair(src + g * stride, g < ng);
    qa[j][1] = q_pair(src + (g + 8) * stride, g + 8 < ng);
    qa[j][2] = q_pair(src + g * stride + 8, g < ng);
    qa[j][3] = q_pair(src + (g + 8) * stride + 8, g + 8 < ng);
  }
  // the value product's warp: columns kWC warp.., 8 n8 tiles
  float acc[kWC / 8][4];
#pragma unroll
  for (int j = 0; j < kWC / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // this lane's ldmatrix rows: the scores' B (position, the k-step's
  // granule), P's A (head, granule), the value's B (position, columns)
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int bpos = nh * 16 + (lane >> 4) * 8 + (lane & 7);
  const int bk = ((lane >> 3) & 1) * 8 + kq * kKS * 16;
  // the softmax's lane: head 2 warp + lane / 16, positions sp, sp + 16
  const int sh = 2 * warp + (lane >> 4), sp = lane & 15;

  for (int it = 0; it < n_tiles; ++it) {
    const int nt = min(kTT, t_end - (t_begin + it * kTT));
    const unsigned char* tile = ring + (it & 1) * kMStage;
    mbar_wait(&full[it & 1], (it >> 1) & 1);  // tile it has landed

    // 1. partial scores: this warp's 16 positions x 16 heads over its
    //    quarter of the dims
    {
      float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kKS; ++j) {
        uint32_t bm[4];
        ldsm_x4(bm, tile + tile_off(bpos, bk + j * 16));
        mma16816(c0, qa[j], bm[0], bm[1]);
        mma16816(c1, qa[j], bm[2], bm[3]);
      }
      float* sp_ = s_part + (kq * kHG + g) * kSP + nh * 16 + 2 * t4;
      *reinterpret_cast<float2*>(sp_) = make_float2(c0[0], c0[1]);
      *reinterpret_cast<float2*>(sp_ + 8) = make_float2(c1[0], c1[1]);
      *reinterpret_cast<float2*>(sp_ + 8 * kSP) = make_float2(c0[2], c0[3]);
      *reinterpret_cast<float2*>(sp_ + 8 * kSP + 8) =
          make_float2(c1[2], c1[3]);
    }
    __syncthreads();

    // 2. online softmax: warp w heads 2w (lanes 0-15) and 2w + 1 (16-31),
    //    a lane two positions; P the weights rounded to bf16 under the
    //    running max
    {
      const float* sq = s_part + sh * kSP + sp;
      float s0 = sq[0] + sq[kHG * kSP] + sq[2 * kHG * kSP] +
                 sq[3 * kHG * kSP];
      float s1 = sq[16] + sq[kHG * kSP + 16] + sq[2 * kHG * kSP + 16] +
                 sq[3 * kHG * kSP + 16];
      s0 = sp < nt ? s0 * scale : neg_inf();
      s1 = sp + 16 < nt ? s1 * scale : neg_inf();
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[sh];
      const float m_new = fmaxf(m_old, mx);
      // the first tile of a range holds a valid position, so m_new is
      // finite; the guard keeps a row of -inf at weight 0
      const float m_use = m_new == neg_inf() ? 0.f : m_new;
      const float p0 = expf(s0 - m_use), p1 = expf(s1 - m_use);
      p_s[sh * kPP + sp] = __float2bfloat16(p0);
      p_s[sh * kPP + sp + 16] = __float2bfloat16(p1);
      float sum = p0 + p1;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (sp == 0) {
        const float corr = rescale(m_old, m_new);
        c_s[sh] = corr;
        l_s[sh] = l_s[sh] * corr + sum;
        m_s[sh] = m_new;
      }
    }
    __syncthreads();

    // 3. acc = acc * corr + P c_kv over this warp's 64 columns
    {
      const float cg0 = c_s[g], cg8 = c_s[g + 8];
#pragma unroll
      for (int j = 0; j < kWC / 8; ++j) {
        acc[j][0] *= cg0;
        acc[j][1] *= cg0;
        acc[j][2] *= cg8;
        acc[j][3] *= cg8;
      }
#pragma unroll
      for (int ks = 0; ks < kTT / 16; ++ks) {
        uint32_t pa[4];
        ldsm_x4(pa, p_s + lrow * kPP + ks * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int jj = 0; jj < kWC / 16; ++jj) {
          uint32_t bm[4];
          ldsm_x4_trans(bm, tile + tile_off(ks * 16 + lrow,
                                            warp * kWC + jj * 16 +
                                                (lane >> 4) * 8));
          mma16816(acc[2 * jj], pa, bm[0], bm[1]);
          mma16816(acc[2 * jj + 1], pa, bm[2], bm[3]);
        }
      }
    }
    __syncthreads();  // the stage, P and the partial scores are free
    if (tid == 0 && it + 2 < n_tiles) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(it + 2);
    }
  }

  // the merge: the block's accumulator into its own shared memory; after
  // a cluster barrier (every block is past its loop) each thread sends
  // 16-byte pieces of it (float4 e of [head][R / 4]) to the block that
  // owns them (e in [r share, (r + 1) share)), and the (max, sum) of the
  // block's heads to every block; after a second one each block weighs
  // the parts of its share in its own memory and writes them
#pragma unroll
  for (int j = 0; j < kWC / 8; ++j) {
    float* x = xacc + g * kXP + warp * kWC + j * 8 + 2 * t4;
    *reinterpret_cast<float2*>(x) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(x + 8 * kXP) =
        make_float2(acc[j][2], acc[j][3]);
  }
  __syncthreads();
  cluster_arrive();
  cluster_wait();
  const int share = (kOut4 + n_blocks - 1) / n_blocks;
  for (int e = tid; e < kOut4; e += kThreads) {
    const int to = e / share, h = e / (kR / 4), c = (e % (kR / 4)) * 4;
    *reinterpret_cast<float4*>(cluster.map_shared_rank(
        xrecv + (rank * share + e - to * share) * 4, to)) =
        *reinterpret_cast<const float4*>(xacc + h * kXP + c);
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
  const int e_end = min(share, ng * (kR / 4) - rank * share);
  for (int i = tid; i < e_end; i += kThreads) {
    const int e = rank * share + i;
    const int h = e / (kR / 4), c = (e % (kR / 4)) * 4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < n_blocks) {
        const float w = xw[r * kHG + h];
        const float4 v =
            *reinterpret_cast<const float4*>(xrecv + (r * share + i) * 4);
        a.x += w * v.x;
        a.y += w * v.y;
        a.z += w * v.z;
        a.w += w * v.w;
      }
    __nv_bfloat162 o[2] = {__floats2bfloat162_rn(a.x, a.y),
                           __floats2bfloat162_rn(a.z, a.w)};
    *reinterpret_cast<uint2*>(lat + (qrow + h) * kR + c) =
        *reinterpret_cast<const uint2*>(o);
  }
}

// ------------------------------------------------------------- launches
constexpr int kBodyCudaCore = 0, kBodyMma = 1;  // the entry's body codes

// the kernel of (body, dtype) and its dynamic shared memory; nullptr
// for a pair no body takes
const void* kernel_of(int body, int dtype, int* smem) {
  if (body == kBodyCudaCore && (dtype == 0 || dtype == 1)) {
    *smem = kSmemBytes;
    return dtype == 0 ? reinterpret_cast<const void*>(mla_decode_kernel<float>)
                      : reinterpret_cast<const void*>(
                            mla_decode_kernel<__nv_bfloat16>);
  }
  if (body == kBodyMma && dtype == 1) {
    *smem = kMSmemBytes;
    return reinterpret_cast<const void*>(mla_decode_mma_kernel);
  }
  return nullptr;
}

// a contiguous bf16 (B, T, D) cache as a tensor map over its first
// n_valid rows (innermost first: D, 1, n_valid, B; rows past n_valid
// read as zeros) with boxes of kBoxW columns x kTT rows, swizzled over
// 128 bytes
bool latent_map(CUtensorMap* map, const void* p, int B, int T_len,
                int n_valid, int D) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), 1,
                              static_cast<cuuint64_t>(n_valid),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {2ull * D, 2ull * D, 2ull * T_len * D};
  const cuuint32_t box[4] = {kBoxW, 1, kTT, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the kernel's attributes (its shared memory, clusters of 16), set once
cudaError_t set_attrs(int body, int dtype) {
  static bool done[2][2] = {};
  int smem = 0;
  const void* kern = kernel_of(body, dtype, &smem);
  if (kern == nullptr) return cudaErrorInvalidValue;
  if (done[body][dtype]) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess) done[body][dtype] = true;
  return e;
}

}  // namespace

// body: 0 = the CUDA-core body (f32 or bf16), 1 = the tensor-core body
// (bf16 only); dtype: 0 = float32, 1 = bfloat16. q_abs (B, 1, H, R),
// q_rope (B, 1, H, DR), c_kv (B, T, R), k_rope (B, T, DR), lat like
// q_abs, all contiguous and 16-byte aligned; (R, DR) = (512, 64), H >=
// 1; length >= 0 (a host int). The min(length + 1, T) valid positions
// are cut into n_splits <= 16 ranges of per positions, none of them
// empty, the blocks of one cluster. Returns the launch's cudaError_t.
extern "C" int mla_decode_attention(int body, int dtype, const void* q_abs,
                                    const void* q_rope, const void* c_kv,
                                    const void* k_rope, void* lat, int B,
                                    int T_len, int H, int R, int DR,
                                    int length, int per, int n_splits,
                                    float scale, void* stream) {
  if (B < 1 || T_len < 1 || H < 1 || R != kR || DR != kDR || length < 0 ||
      per < 1 || n_splits < 1 || n_splits > kMaxCluster ||
      static_cast<long long>(B) * ((H + kHG - 1) / kHG) > 0x7fffffff)
    return cudaErrorInvalidValue;
  int n_valid = length < T_len ? length + 1 : T_len;
  if (static_cast<long long>(per) * n_splits < n_valid ||
      static_cast<long long>(per) * (n_splits - 1) >= n_valid)
    return cudaErrorInvalidValue;
  int smem = 0;
  const void* kern = kernel_of(body, dtype, &smem);
  if (kern == nullptr) return cudaErrorInvalidValue;
  cudaError_t e = set_attrs(body, dtype);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * ((H + kHG - 1) / kHG), 1, n_splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = n_splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (body == kBodyMma) {
    // (tm_c, tm_r, q_abs, q_rope, lat, H, n_valid, per, scale)
    CUtensorMap tm_c, tm_r;
    if (!latent_map(&tm_c, c_kv, B, T_len, n_valid, kR) ||
        !latent_map(&tm_r, k_rope, B, T_len, n_valid, kDR))
      return cudaErrorInvalidValue;
    void* args[] = {&tm_c, &tm_r, &q_abs, &q_rope, &lat,
                    &H,    &n_valid, &per, &scale};
    return cudaLaunchKernelExC(&cfg, kern, args);
  }
  // (q_abs, q_rope, c_kv, k_rope, lat, T_len, H, n_valid, per, scale),
  // the pointers typed by the dtype
  void* args[] = {&q_abs, &q_rope, &c_kv, &k_rope, &lat, &T_len,
                  &H,     &n_valid, &per, &scale};
  return cudaLaunchKernelExC(&cfg, kern, args);
}

// What a body's kernel takes on the current device: its dynamic shared
// memory a block and how many of its blocks fit an SM (the occupancy
// calculator, clusters aside). Returns a cudaError_t.
extern "C" int mla_decode_attention_info(int body, int dtype,
                                         int* smem_bytes,
                                         int* blocks_per_sm) {
  int smem = 0;
  const void* kern = kernel_of(body, dtype, &smem);
  if (kern == nullptr) return cudaErrorInvalidValue;
  cudaError_t e = set_attrs(body, dtype);
  if (e != cudaSuccess) return e;
  *smem_bytes = smem;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kern, kThreads, smem);
}
