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
// card's 132 SMs busy; and a call moves only ~10 MB, so fixed costs
// (launches, a block's first DRAM round trip) weigh as much as the
// bytes.
// What the design does about it: one launch over thread-block clusters.
// - The valid positions are cut into `n_splits` contiguous ranges (the
//   wrapper's `cluster_plan`, about one block per SM), and the ranges of
//   one (batch row, kv head, group of up to kMaxG query heads) are the
//   blocks of one cluster (at most kMaxCluster, 16: a non-portable
//   size).
// - A block brings its whole range into shared memory with bulk
//   asynchronous copies (cp.async.bulk, one k or v row each, k rows
//   first, completing on one mbarrier for k and one for v), so all of
//   its bytes are in flight at once. A range larger than a buffer goes
//   through two buffers in turn, the copies of one overlapping the
//   arithmetic on the other. Rows are stored at a pitch of an odd number
//   of 16-byte granules, so 8 rows read at the same column fall in 8
//   different bank groups.
// - With k in shared memory, a block of 256 threads computes the scores:
//   bf16 on the tensor cores (mma.sync m16n8k16: the query rows of the
//   group as the A operand, zero past G, ldmatrix of 8 k rows as B; the
//   products exact, the sums f32), f32 on the CUDA cores (a thread a
//   position). Then a warp a query row takes the max and the sum of exp
//   over the range (rescaling the running ones across stages), while
//   the v rows land; then each thread accumulates p v in f32 for two
//   output columns over a slice of the positions, and the slices add up
//   at the end (one max a row).
// - The blocks of a cluster then merge their (max, sum, f32 accumulator)
//   through distributed shared memory: each block writes each part of
//   its accumulator into the block that owns that share of the output,
//   with its (max, sum), and after one cluster barrier every block
//   merges and writes its share. No workspace, no second kernel; a
//   block only reads its own shared memory after the barrier, so none
//   has to wait for the others to finish reading it.
// No position past the last valid one is read: the TPU kernel skips the
// blocks past `length` the same way.

#include <cstdint>
#include <type_traits>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dtype.cuh"
#include "mbarrier.cuh"


namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;                // query heads a block serves at most
constexpr int kMaxCluster = 16;         // blocks a cluster (non-portable)
constexpr int kBufBytes = 176 * 1024;   // a block's k/v buffers at most
constexpr int kMaxRows = 512;           // positions a buffer holds at most

// The shared-memory rows of head dim D: a k or v row of ROW bytes is
// stored at a pitch of ROW + 16 bytes, an odd number of 16-byte granules,
// so lanes that read different rows hit different bank groups. The
// scores give each position TPP threads (each a share of the row's
// vectors); the value product gives each thread a pair of columns (NCOL
// pairs) and a slice of the positions (NSL slices).
template <typename T, int D>
struct Rows {
  static constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  static constexpr int NVEC = D / VEC;  // 16-byte vectors in a row
  static constexpr int ROW = D * static_cast<int>(sizeof(T));
  static constexpr int PITCH = ROW + 16;
  static constexpr int NCOL = D / 2;
  static constexpr int NSL = kThreads / NCOL;
  static_assert(NVEC * VEC == D && (PITCH / 16) % 2 == 1 && NSL >= 1,
                "unsupported head dim");
};

// Positions a buffer holds: the whole range where one buffer fits it,
// else half the budget each of two buffers (a multiple of 16).
__host__ __device__ inline int stage_rows(int per, int pitch) {
  int one = kBufBytes / (2 * pitch);
  one = one < kMaxRows ? one : kMaxRows;
  return per <= one ? per : (one / 2) / 16 * 16;
}

// one 16-byte vector of f32 (the f32 body's k rows)
__device__ __forceinline__ void widen(const uint4& v, float* out) {
  out[0] = __uint_as_float(v.x);
  out[1] = __uint_as_float(v.y);
  out[2] = __uint_as_float(v.z);
  out[3] = __uint_as_float(v.w);
}
// elements c and c + 1 of a shared-memory row, widened
__device__ __forceinline__ float2 pair_at(const float* row, int c) {
  return *reinterpret_cast<const float2*>(row + c);
}
__device__ __forceinline__ float2 pair_at(const __nv_bfloat16* row, int c) {
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(row + c));
}

// n f32 values from 16-byte aligned shared memory (n = 1, 4 or 8)
template <int N>
__device__ __forceinline__ void load_f32(float* out, const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      out[i] = v.x;
      out[i + 1] = v.y;
      out[i + 2] = v.z;
      out[i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = p[i];
  }
}

// the weight of a running (max m) when merged under the new max M
__device__ __forceinline__ float rescale(float m, float M) {
  return m == M ? 1.f : expf(m - M);  // also -inf against -inf
}

// one contiguous global -> shared copy of `bytes` (a multiple of 16),
// completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
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

// mma.sync m16n8k16, bf16 in, f32 accumulate (PTX ISA fragment layouts,
// g = lane / 4, t = lane % 4): A (16 x 16, row) a0 (g, 2t..2t+1), a1
// (g + 8, 2t..), a2 (g, 2t + 8..), a3 (g + 8, 2t + 8..); B (16 x 8, col)
// b0 (k 2t..2t+1, n g), b1 (k 2t + 8.., n g); C c0, c1 (g, 2t..2t+1),
// c2, c3 (g + 8, 2t..). Rows 8-15 of A are zero here (a1 = a3 = 0).
__device__ __forceinline__ void mma_rows8(float* c, uint32_t a0, uint32_t a2,
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices from shared memory: lane l gives the address
// of row l % 8 of matrix l / 8; register j holds matrix j in the mma B
// layout (lane: row l / 4, elements 2 (l % 4), + 1)
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// GM: the query heads a block serves (1, 4 or kMaxG), so that the shared
// memory of heads a group does not have is not spent. Grid (B * KVH,
// ceil(G / GM), n_splits), clusters of (1, 1, n_splits).
template <typename T, int D, int GM>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc, T* __restrict__ out,
                        int T_len, int KVH, int G, int n_valid, int per,
                        float scale) {
  using R = Rows<T, D>;
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(128) unsigned char dyn[];
  // per buffer: the k rows' copies, the v rows' copies
  __shared__ __align__(8) uint64_t k_full[2], v_full[2];
  __shared__ __align__(16) float q_s[GM][D];  // f32: query rows, scaled
  __shared__ float m_s[GM], l_s[GM], c_s[GM];  // running max, sum; rescale
  __shared__ float red[R::NSL][GM][D];         // the slices' accumulators
  // what the other blocks of the cluster send: their (max, sum) and
  // their part of this block's share of the output elements
  __shared__ float xm[kMaxCluster][GM], xl[kMaxCluster][GM];
  __shared__ float xacc[GM * D + kMaxCluster];
  __shared__ float xw[kMaxCluster][GM];  // the blocks' weights

  cg::cluster_group cluster = cg::this_cluster();
  // this block has started: the others may write into it once all have
  cluster_arrive_relaxed();
  const int n_blocks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / KVH, kvh = blockIdx.x % KVH;
  const int g0 = blockIdx.y * GM;
  const int ng = min(GM, G - g0);
  const int t_begin = blockIdx.z * per;
  const int n_rows = min(n_valid, t_begin + per) - t_begin;  // >= 1
  const int rows = stage_rows(per, R::PITCH);  // positions a buffer holds
  const int n_bufs = per > rows ? 2 : 1;
  const int n_stages = (n_rows + rows - 1) / rows;
  const int H = KVH * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const size_t row_stride = static_cast<size_t>(KVH) * D;  // one position
  const T* k_b = kc + static_cast<size_t>(b) * T_len * row_stride + kvh * D;
  const T* v_b = vc + static_cast<size_t>(b) * T_len * row_stride + kvh * D;
  const T* q_b = q + (static_cast<size_t>(b) * H + kvh * G + g0) * D;
  // buffer i: k rows [0, rows), then v rows, at R::PITCH bytes; then the
  // scores (rows x GM, f32)
  auto k_buf = [&](int i) { return dyn + i * 2 * rows * R::PITCH; };
  float* s_s = reinterpret_cast<float*>(dyn + n_bufs * 2 * rows * R::PITCH);

  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&k_full[i], 1);
      mbar_init(&v_full[i], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // stage st into buffer st % 2: the block's threads issue its n k row
  // copies, then its n v row copies (the scores need only k)
  auto issue = [&](int st) {
    const int i = st & 1;
    const int r0 = st * rows, nr = min(rows, n_rows - r0);
    if (tid == 0) {
      mbar_expect_tx(&k_full[i], nr * R::ROW);
      mbar_expect_tx(&v_full[i], nr * R::ROW);
    }
    __syncthreads();
    unsigned char* kd = k_buf(i);
    for (int c = tid; c < 2 * nr; c += kThreads) {
      const int isv = c >= nr, r = c - isv * nr;
      const size_t src = static_cast<size_t>(t_begin + r0 + r) * row_stride;
      bulk_copy(kd + (isv * rows + r) * R::PITCH, (isv ? v_b : k_b) + src,
                R::ROW, isv ? &v_full[i] : &k_full[i]);
    }
  };
  issue(0);
  if (n_stages > 1) issue(1);

  // while the copies are in flight: the query rows. bf16: the mma A
  // fragments of this lane's query row g = lane / 4 (zero past ng), as
  // they are (the scale goes on the f32 scores); f32: widened and scaled
  // in shared memory
  constexpr int KS = D / 16;  // mma k-steps over the head dim
  uint32_t qa[kBf16 ? KS : 1][2];
  if constexpr (kBf16) {
    const int g = lane / 4, t4 = lane % 4;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint32_t* p = reinterpret_cast<const uint32_t*>(
          q_b + g * D + ks * 16 + 2 * t4);
      qa[ks][0] = g < ng ? p[0] : 0u;
      qa[ks][1] = g < ng ? p[4] : 0u;  // columns + 8
    }
  } else {
    for (int i = tid; i < GM * D; i += kThreads)
      (&q_s[0][0])[i] = i < ng * D ? to_f32(q_b[i]) * scale : 0.f;
  }
  if (tid < GM) {
    m_s[tid] = neg_inf();
    l_s[tid] = 0.f;
  }
  // the value product's thread: columns 2 col, 2 col + 1 of the rows
  // sl, sl + NSL, ... (threads past NCOL * NSL idle there)
  const int col = tid % R::NCOL, sl = tid / R::NCOL;
  float acc[GM][2];
#pragma unroll
  for (int g = 0; g < GM; ++g) acc[g][0] = acc[g][1] = 0.f;
  __syncthreads();

  for (int st = 0; st < n_stages; ++st) {
    const int i = st & 1;
    const int nr = min(rows, n_rows - st * rows);
    const unsigned char* kb = k_buf(i);
    const unsigned char* vb = kb + rows * R::PITCH;
    mbar_wait(&k_full[i], (st >> 1) & 1);

    // 1. scores s[pos][g]
    if constexpr (kBf16) {
      // on the tensor cores: a warp per 8 positions, query rows x k rows
      // (ldmatrix from the padded rows: 8 rows at an odd number of
      // granules apart, no bank conflicts); the tile past nr reads rows
      // of the buffer whose scores are dropped
      const int g = lane / 4, t4 = lane % 4;
      for (int n0 = warp * 8; n0 < nr; n0 += kWarps * 8) {
        const unsigned char* kr =
            kb + (n0 + lane % 8) * R::PITCH + (lane / 8) * 16;
        float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks + 1 < KS; ks += 2) {
          uint32_t bm[4];
          ldmatrix_x4(bm, kr + ks * 32);
          mma_rows8(c, qa[ks][0], qa[ks][1], bm[0], bm[1]);
          mma_rows8(c, qa[ks + 1][0], qa[ks + 1][1], bm[2], bm[3]);
        }
        if constexpr (KS % 2 == 1) {
          uint32_t bm[2];
          ldmatrix_x2(bm, kr - (lane / 8) * 16 + ((lane / 8) % 2) * 16 +
                              (KS - 1) * 32);
          mma_rows8(c, qa[KS - 1][0], qa[KS - 1][1], bm[0], bm[1]);
        }
        const int pos = n0 + 2 * t4;
        if (g < ng) {
          if (pos < nr) s_s[pos * GM + g] = c[0] * scale;
          if (pos + 1 < nr) s_s[(pos + 1) * GM + g] = c[1] * scale;
        }
      }
    } else {
      // on the CUDA cores: a thread a position, its whole k row against
      // every query row
      for (int pos = tid; pos < nr; pos += kThreads) {
        const uint4* kr = reinterpret_cast<const uint4*>(kb + pos * R::PITCH);
        float s[GM];
#pragma unroll
        for (int g = 0; g < GM; ++g) s[g] = 0.f;
#pragma unroll 4
        for (int n = 0; n < R::NVEC; ++n) {
          float kf[R::VEC];
          widen(kr[n], kf);
#pragma unroll
          for (int g = 0; g < GM; ++g) {
            const float4 qv =
                *reinterpret_cast<const float4*>(&q_s[g][n * R::VEC]);
            s[g] += qv.x * kf[0] + qv.y * kf[1] + qv.z * kf[2] +
                    qv.w * kf[3];
          }
        }
#pragma unroll
        for (int g = 0; g < GM; ++g) s_s[pos * GM + g] = s[g];
      }
    }
    __syncthreads();

    // 2. softmax statistics: warp g for query row g; the scores become
    //    the weights p = exp(s - max)
    if (warp < ng) {
      const int g = warp;
      float mx = neg_inf();
      for (int pos = lane; pos < nr; pos += 32)
        mx = fmaxf(mx, s_s[pos * GM + g]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_s[g], mx);
      float sum = 0.f;
      for (int pos = lane; pos < nr; pos += 32) {
        const float p = expf(s_s[pos * GM + g] - m_new);
        s_s[pos * GM + g] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = rescale(m_s[g], m_new);
        c_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // 3. acc = acc * corr + p v
    mbar_wait(&v_full[i], (st >> 1) & 1);
    if (sl < R::NSL) {
      // this thread's two columns over its slice of the rows
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        acc[g][0] *= c_s[g];
        acc[g][1] *= c_s[g];
      }
#pragma unroll 4
      for (int pos = sl; pos < nr; pos += R::NSL) {
        const float2 vv =
            pair_at(reinterpret_cast<const T*>(vb + pos * R::PITCH),
                    2 * col);
        float p[GM];
        load_f32<GM>(p, s_s + pos * GM);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          acc[g][0] += p[g] * vv.x;
          acc[g][1] += p[g] * vv.y;
        }
      }
    }
    if (st + 1 < n_stages) {
      __syncthreads();  // s_s and buffer i are read
      if (st + 2 < n_stages) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        issue(st + 2);
      }
    }
  }

  // the block's accumulator (bf16: the warps' n-tiles; f32: the slices,
  // one max per query row, so a plain sum), sent out in shares: element
  // i = g * D + d goes to block i / share, which merges the cluster's
  // n_blocks parts of it
  if (sl < R::NSL) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      red[sl][g][2 * col] = acc[g][0];
      red[sl][g][2 * col + 1] = acc[g][1];
    }
  }
  __syncthreads();
  const int n_out = ng * D;
  const int share = (n_out + n_blocks - 1) / n_blocks;
  cluster_wait();  // every block of the cluster has started
  for (int i = tid; i < n_out; i += kThreads) {
    const int g = i / D, d = i % D;
    float a = 0.f;
#pragma unroll
    for (int s = 0; s < R::NSL; ++s) a += red[s][g][d];
    const int j = i / share;
    cluster.map_shared_rank(xacc, j)[rank * share + (i - j * share)] = a;
  }
  if (tid < ng * n_blocks) {
    const int g = tid % ng, j = tid / ng;
    cluster.map_shared_rank(&xm[0][0], j)[rank * GM + g] = m_s[g];
    cluster.map_shared_rank(&xl[0][0], j)[rank * GM + g] = l_s[g];
  }
  cluster_arrive();
  cluster_wait();  // every part of this block's share has arrived

  // the weight of block r's part of query row g, exp(m_r - M) / L (warp
  // g, lane r), then this block's share of the output, an element a
  // thread
  if (warp < ng) {
    const int g = warp;
    const bool has = lane < n_blocks;
    const float mr = has ? xm[lane][g] : neg_inf();
    float Mx = mr;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      Mx = fmaxf(Mx, __shfl_xor_sync(0xffffffffu, Mx, o));
    const float c = has ? rescale(mr, Mx) : 0.f;
    float L = has ? xl[lane][g] * c : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      L += __shfl_xor_sync(0xffffffffu, L, o);
    // every range holds at least one valid position, so L > 0
    if (has) xw[lane][g] = c / L;
  }
  __syncthreads();
  const int row0 = b * H + kvh * G + g0;  // the block's first query row
  for (int e = tid; e < share && rank * share + e < n_out; e += kThreads) {
    const int i = rank * share + e, g = i / D;
    float a = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < n_blocks) a += xw[r][g] * xacc[r * share + e];
    out[static_cast<size_t>(row0) * D + i] = from_f32<T>(a);
  }
}

template <typename T, int D, int GM>
cudaError_t launch_g(const T* q, const T* k, const T* v, T* out, int B,
                     int T_len, int KVH, int G, int n_valid, int per,
                     int n_splits, float scale, cudaStream_t s) {
  auto kern = decode_attention_kernel<T, D, GM>;
  using R = Rows<T, D>;
  static bool attrs_set = false;
  if (!attrs_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kBufBytes + kMaxRows * GM * 4);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    attrs_set = true;
  }

  const int rows = stage_rows(per, R::PITCH);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * KVH, (G + GM - 1) / GM, n_splits);
  cfg.blockDim = dim3(kThreads);
  // the k/v buffers, then the scores
  cfg.dynamicSmemBytes =
      static_cast<size_t>(per > rows ? 2 : 1) * 2 * rows * R::PITCH +
      static_cast<size_t>(rows) * GM * 4;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = n_splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, q, k, v, out, T_len, KVH, G,
                            n_valid, per, scale);
}

template <typename T, int D>
cudaError_t launch_d(const T* q, const T* k, const T* v, T* out, int B,
                     int T_len, int KVH, int G, int n_valid, int per,
                     int n_splits, float scale, cudaStream_t s) {
  if (G == 1)
    return launch_g<T, D, 1>(q, k, v, out, B, T_len, KVH, G, n_valid, per,
                             n_splits, scale, s);
  if (G <= 4)
    return launch_g<T, D, 4>(q, k, v, out, B, T_len, KVH, G, n_valid, per,
                             n_splits, scale, s);
  return launch_g<T, D, kMaxG>(q, k, v, out, B, T_len, KVH, G, n_valid, per,
                               n_splits, scale, s);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int T_len, int KVH, int G, int D, int n_valid,
                   int per, int n_splits, float scale, cudaStream_t s) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
#define DECODE_CASE(DD)                                                   \
  case DD:                                                                \
    return launch_d<T, DD>(qt, kt, vt, ot, B, T_len, KVH, G, n_valid, per, \
                           n_splits, scale, s);
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
// cut into n_splits <= 16 ranges of per positions, none of them empty,
// the blocks of one cluster. Returns the launch's cudaError_t.
extern "C" int decode_attention(int dtype, const void* q, const void* k,
                                const void* v, void* out, int B, int T_len,
                                int KVH, int G, int D, int length, int per,
                                int n_splits, float scale, void* stream) {
  if (B < 1 || T_len < 1 || KVH < 1 || G < 1 || length < 0 || per < 1 ||
      n_splits < 1 || n_splits > kMaxCluster ||
      static_cast<long long>(B) * KVH > 0x7fffffff || G > 65535 * kMaxG)
    return cudaErrorInvalidValue;
  const int n_valid = length < T_len ? length + 1 : T_len;
  if (static_cast<long long>(per) * n_splits < n_valid ||
      static_cast<long long>(per) * (n_splits - 1) >= n_valid)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, out, B, T_len, KVH, G, D, n_valid, per,
                         n_splits, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, B, T_len, KVH, G, D, n_valid,
                                 per, n_splits, scale, s);
  return cudaErrorInvalidValue;
}
