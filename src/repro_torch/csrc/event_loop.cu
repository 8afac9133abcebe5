// The scheduling event loop (K0), run to completion on the card in one
// launch per lane chunk, hand-written for Hopper (sm_90a), with one
// variant a policy.
//
// Replaces the XLA while_loop of src/repro/core/jax_engine.py::_simulate
// (:1001) with the policy kernels of src/repro/core/jax_policies.py:
//   ESFF<lru, cold>   ESFFKernel (:59): FCP on arrival, FRP on
//                     completion; <false, false> is ESFF, <true, true>
//                     ESFF-H (LRU victim in Eq. 8, cold-aware n_e);
//                     runs K1 (the FRP scan,
//                     src/repro/kernels/sched_weights.py:68) inline
//                     through csrc/frp_select.cuh
//   Central<sff>      CentralQueueKernel (:149): SFF and OpenWhisk
//   FaasCache         FaasCacheKernel (:242): the central queue with
//                     GREEDY-DUAL keep-alive
//   OpenWhiskV2       OpenWhiskV2Kernel (:295): per-function queues and
//                     the timer rail
// Each variant is a template instantiation of `Lane`: the policy's
// decisions are fixed at compile time (if constexpr), and the host entry
// picks the instantiation from a policy code, once a launch. Its plain
// version is the eager loop of src/repro_torch/core/engine.py
// (`simulate_eager`, `_event_step`, the hooks of core/policies.py);
// every result is bitwise that loop's, so every expression below keeps
// the eager spelling's order of operations, the library is built with
// --fmad=false, division is IEEE and the histogram's log is libdevice's
// (as torch's on the card).
//
// One warp a lane, one lane a block. A lane's events form a serial
// chain; the warp's threads split the slot scans (thread c owns slots c,
// c + 32, ...) and the function scans (functions f, f + 32, ...: the FRP
// scan, the central queue's head scan, the timer rail's part of the
// pick) and reduce by shuffles. The lane's scalars (counters, sums, the
// event registers) are warp-uniform registers that every thread updates
// alike; shared state is read by all threads and written by thread 0
// between two __syncwarp()s. Per event:
//   pick    first-index argmin over [BUSY slots | COLD slots | original
//           timers (F) | re-arms (F) | arrival], the timers only in
//           OpenWhisk-v2 (ties: EXEC_DONE < COLD_DONE < TIMER < ARRIVAL,
//           then the slot or function index)
//   slot    release; on a completion the estimator update; then the
//           policy's hook (ESFF: FRP or pop the own queue; the central
//           queue: pop the own queue, else retarget to the queue head;
//           OpenWhisk-v2: pop the own queue)
//   timer   (OpenWhisk-v2) consume the timer, then scale up for the
//           queue head, or re-arm it, or nothing if it is not the head
//   arrival the policy's hook (ESFF: FCP, Eq. 7, 8; the central queue:
//           an idle own slot, else queue and scale up; OpenWhisk-v2: an
//           idle own slot, else queue, and arm the arrival's timer)
//   fold    response and slowdown sums, maximum, 64-bin log histogram;
//           with the engine options on, the deadline miss of the request's
//           function (resp > deadline) and its arrival's timeline bin
//           (count, response and execution sums)
// A lane stops when every live request is done, with stall 1 when it is
// active and has no finite event (after a queue overflow), or stall 2 at
// 256 N + 4096 events; each event raises `iters`, so the loop ends.
//
// Engine options (core/engine.py `simulate`). `n_live` (L,), when given,
// makes a lane a ragged prefix of its padded trace row: it replaces N in
// the loop bound and in the arrival gate, so padding never arrives (the
// static cluster tier packs sub-streams of different live lengths into
// one launch this way). `deadlines` (F,) and the timeline (`tl_bins`
// bins of `tl_bucket` seconds, the bin a true division of the arrival)
// fold into (L, F) and (L, tl_bins) arrays in global memory that thread
// 0 alone updates, in event order. A null pointer (0 bins) turns an
// option off: one test a fold.
//
// Layout. The lane's tallies (Tally: the counts and time sums that change
// at most once an event) live in 72 B of static shared memory, touched by
// thread 0 alone. Slots live in (dynamic) shared memory: fn, req, seq, ready (8 B each),
// state and the capacity mask (4 B), and per variant the last dispatch
// time `used` (f64, for an LRU victim: ESFF-H, the central queue,
// OpenWhisk-v2) and FaasCache's `prio` (f64) and `freq` (i32): 40 to 52
// B a slot. The per-function state (est_sum, the lane's t_cold and
// t_evict rows, q_head_pos, q_head_rid as f64 / i64; q_len, est_n, K as
// i32: 52 B; ESFF-H's COLD-slot count, i32; OpenWhisk-v2's timer rail,
// tmr_next, rearm_t, rearm_rid as f64 / i64 and tmr_pos, arr_cnt as
// i32) lives in shared memory too when it fits beside the slots in the
// block's 227 KB, else in global scratch that the wrapper allocates: the
// same code over generic pointers set once at entry
// (kernels/event_loop.py::layout_plan makes the choice). K = |K^j| and
// the COLD-slot count are kept by start_cold (and the COLD count by the
// cold start's completion), where the eager loop recounts (L, C, F). The
// trace (fn_id, arrival, exec_time, the positional queue layout pos_rids
// / pos_off) stays in global memory, L2-resident (~32 B a request). The
// histogram lives in registers: thread t holds bins t and t + 32.
//
// What bounds it on an H100: the trace read once and the results
// written once is ~1.9 MB at N = 60,000 (~0.6 us at 3.35 TB/s); the
// function scans are ~12 f64 operations a function a scan (~30 us for
// Fig. 5's seven ESFF lanes at 34 TFLOP/s). Neither is the limit: a
// lane's events are a serial chain of dependent shared- and L2-memory
// reads, shuffles and f64 divisions, so the time is events x the latency
// of one event, and lanes run side by side (one warp each).

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "frp_select.cuh"

namespace {

constexpr double kBig = 1e30;
constexpr int kCold = 0, kIdle = 1, kBusy = 2;
constexpr long long kI32Max = 2147483647LL;
constexpr double kHistLo = -4.0;
constexpr double kHistPerDecade = 8.0;
constexpr double kInvLn10 = 0.4342944819032518;
constexpr int kHistBins = 64;
constexpr unsigned kAll = 0xffffffffu;

// the columns of the counters, sums and policy-count rows;
// event_loop_layout reports them, with the variant's slot and function
// bytes and kHistBins, to the wrapper
enum { C_NEXT, C_DONE, C_ITERS, C_STALL, C_SEQ, C_GN, C_COLD, C_EVICT,
       C_OVF, N_CTR };
enum { S_GSUM, S_COLD_T, S_EVICT_T, S_RSUM, S_SSUM, S_RMAX, N_SUM };
enum { P_FRP, P_HEAD, P_TIMER, N_PC };

// The policy of a variant, fixed at compile time.
enum Kind { kEsffKind, kCentralKind, kFaasKind, kOwv2Kind };

template <int KIND, bool LRU, bool COLD_AWARE, bool SFF>
struct Policy {
  static constexpr bool esff = KIND == kEsffKind;
  static constexpr bool faas = KIND == kFaasKind;
  static constexpr bool central = KIND == kCentralKind || faas;
  static constexpr bool timers = KIND == kOwv2Kind;
  static constexpr bool lru = LRU;               // ESFF: Eq. 8 by LRU
  static constexpr bool cold_aware = COLD_AWARE;  // ESFF: n_e -= coldK
  static constexpr bool sff = SFF;               // central: SFF order
  // the last dispatch time, read by every LRU victim scan
  static constexpr bool slot_used =
      (esff && LRU) || (central && !faas) || timers;
  static constexpr int slot_bytes =
      4 * 8 + 2 * 4 + (slot_used ? 8 : 0) + (faas ? 8 + 4 : 0);
  static constexpr int fn_bytes =
      5 * 8 + 3 * 4 + (cold_aware ? 4 : 0) + (timers ? 3 * 8 + 2 * 4 : 0);
};

// the variants, by the policy code of the entry (kernels/event_loop.py
// VARIANTS): ESFF with its two flags, the central queue in both orders,
// FaasCache, OpenWhisk-v2
using EsffP = Policy<kEsffKind, false, false, false>;
using EsffColdP = Policy<kEsffKind, false, true, false>;
using EsffLruP = Policy<kEsffKind, true, false, false>;
using EsffHP = Policy<kEsffKind, true, true, false>;
using FifoP = Policy<kCentralKind, false, false, false>;
using SffP = Policy<kCentralKind, false, false, true>;
using FaasP = Policy<kFaasKind, false, false, false>;
using Owv2P = Policy<kOwv2Kind, false, false, false>;
// each variant's bytes, as the wrapper's VARIANTS has them
static_assert(EsffP::slot_bytes == 40 && EsffP::fn_bytes == 52, "esff");
static_assert(EsffColdP::slot_bytes == 40 && EsffColdP::fn_bytes == 56,
              "esff_cold");
static_assert(EsffLruP::slot_bytes == 48 && EsffLruP::fn_bytes == 52,
              "esff_lru");
static_assert(EsffHP::slot_bytes == 48 && EsffHP::fn_bytes == 56, "esff_h");
static_assert(FifoP::slot_bytes == 48 && FifoP::fn_bytes == 52, "fifo");
static_assert(SffP::slot_bytes == 48 && SffP::fn_bytes == 52, "sff");
static_assert(FaasP::slot_bytes == 52 && FaasP::fn_bytes == 52,
              "faascache");
static_assert(Owv2P::slot_bytes == 48 && Owv2P::fn_bytes == 84,
              "openwhisk_v2");

// the slots' bytes, rounded up to 8 so that the per-function arrays that
// follow them in shared memory are aligned
__host__ __device__ constexpr long long slot_region(int slot_bytes,
                                                    int n_slots) {
  return (static_cast<long long>(slot_bytes) * n_slots + 7) / 8 * 8;
}

struct Params {
  const int64_t* fn_id;      // (T, N)
  const double* arrival;     // (T, N)
  const double* exec_time;   // (T, N)
  const int64_t* pos_rids;   // (T, N): request ids sorted by (fn, id)
  const int64_t* pos_off;    // (T, F + 1): per-function offsets
  const double* t_cold;      // (T, F)
  const double* t_evict;     // (T, F)
  const int64_t* trace_ix;   // (L,)
  const uint8_t* cap_mask;   // (L, C) bool
  const double* beta;        // (L,)
  double prior;
  double threshold;          // the timer delay (OpenWhisk-v2)
  int n_req, n_fns, n_slots, queue_cap;
  int fn_in_shared;
  unsigned char* scratch;    // (L, fn_stride) when !fn_in_shared
  long long fn_stride;
  long long max_iters;
  int64_t* ctr;              // (L, N_CTR)
  double* sums;              // (L, N_SUM)
  int32_t* hist;             // (L, 64)
  int64_t* pcounts;          // (L, N_PC): FRP scans, head scans, timers
  double* start;             // (L, N) or null (stream mode)
  double* completion;        // (L, N) or null
  // the engine options, each null (0 bins) when off
  const int64_t* n_live;     // (L,) live prefix of each lane's row
  const double* deadlines;   // (F,)
  int tl_bins;
  double tl_bucket;          // seconds a timeline bin
  int32_t* dl_miss;          // (L, F) zeroed by the wrapper
  int32_t* tl_cnt;           // (L, tl_bins) zeroed by the wrapper
  double* tl_resp;           // (L, tl_bins)
  double* tl_exec;           // (L, tl_bins)
};

// The lane's tallies that change at most once an event and are read only
// at its end: kept in shared memory, and touched by thread 0 alone, so
// that they take no registers from the event loop (thread 0 also writes
// the slot's creation sequence from `seq`). Every sum is still taken in
// event order.
struct Tally {
  long long seq, cold, evict, ovf, scans, head_scans, timers;
  double cold_t, evict_t;
};
__shared__ Tally tally;

// used: only the variants with P::slot_used; prio, freq: FaasCache's
struct Slots {
  long long *fn, *req, *seq;
  double *ready, *used, *prio;
  int *state, *cap, *freq;
};

// coldk: ESFF-H's; tmr_*, rearm_*, arr_cnt: OpenWhisk-v2's
struct Fns {
  double *est_sum, *t_cold, *t_evict, *tmr_next, *rearm_t;
  long long *q_head_pos, *q_head_rid, *rearm_rid;
  int *q_len, *est_n, *k, *coldk, *tmr_pos, *arr_cnt;
};

__device__ __forceinline__ long long clampll(long long x, long long lo,
                                             long long hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Keep the lexicographically smaller of (p, s, i) and (op, os, oi).
__device__ __forceinline__ void keep_lex_min(double& p, long long& s,
                                             int& i, double op,
                                             long long os, int oi) {
  if (op < p || (op == p && (os < s || (os == s && oi < i)))) {
    p = op;
    s = os;
    i = oi;
  }
}

// Warp-wide lexicographic minimum of (p, s, i): every lane of the warp
// ends with the warp's.
__device__ __forceinline__ void warp_lex_min(double& p, long long& s,
                                             int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const double op = __shfl_xor_sync(kAll, p, off);
    const long long os = __shfl_xor_sync(kAll, s, off);
    const int oi = __shfl_xor_sync(kAll, i, off);
    keep_lex_min(p, s, i, op, os, oi);
  }
}

// The lane's event loop under policy P; one object a warp, every member
// warp-uniform.
template <class P>
struct Lane {
  const Params& p;
  const int t;              // this thread's index in the warp
  const int lane, N, F, C, Q;
  const int NL;             // the live prefix: N unless n_live is given
  const int64_t* fn_id;
  const double* arrival;
  const double* exec;
  const int64_t* pos_rids;
  const int64_t* pos_off;
  const double beta;
  Slots sl;
  Fns fs;
  long long next = 0, done = 0, iters = 0, stall = 0, gn = 0;
  double g_sum = 0.0, r_sum = 0.0, s_sum = 0.0, r_max = 0.0;
  double gd_clock = 0.0;    // FaasCache's GREEDY-DUAL clock
  long long ev_rid = -1;    // the event's dispatch, folded at its end
  double ev_comp = 0.0, ev_exec = 0.0;
  int h_lo = 0, h_hi = 0;   // histogram bins t and t + 32

  __device__ Lane(const Params& p_, unsigned char* smem)
      : p(p_), t(threadIdx.x), lane(blockIdx.x), N(p_.n_req),
        F(p_.n_fns), C(p_.n_slots), Q(p_.queue_cap),
        NL(p_.n_live != nullptr ? static_cast<int>(p_.n_live[blockIdx.x])
                                : p_.n_req),
        fn_id(p_.fn_id + p_.trace_ix[blockIdx.x] * p_.n_req),
        arrival(p_.arrival + p_.trace_ix[blockIdx.x] * p_.n_req),
        exec(p_.exec_time + p_.trace_ix[blockIdx.x] * p_.n_req),
        pos_rids(p_.pos_rids + p_.trace_ix[blockIdx.x] * p_.n_req),
        pos_off(p_.pos_off + p_.trace_ix[blockIdx.x] * (p_.n_fns + 1)),
        beta(p_.beta[blockIdx.x]) {
    // slots: the 8-byte arrays, then the 4-byte ones
    unsigned char* b = smem;
    sl.fn = reinterpret_cast<long long*>(b); b += 8 * C;
    sl.req = reinterpret_cast<long long*>(b); b += 8 * C;
    sl.seq = reinterpret_cast<long long*>(b); b += 8 * C;
    sl.ready = reinterpret_cast<double*>(b); b += 8 * C;
    if constexpr (P::slot_used) {
      sl.used = reinterpret_cast<double*>(b); b += 8 * C;
    }
    if constexpr (P::faas) {
      sl.prio = reinterpret_cast<double*>(b); b += 8 * C;
    }
    sl.state = reinterpret_cast<int*>(b); b += 4 * C;
    sl.cap = reinterpret_cast<int*>(b); b += 4 * C;
    if constexpr (P::faas) sl.freq = reinterpret_cast<int*>(b);
    // functions: in shared memory after the slots, or in global scratch
    b = p.fn_in_shared ? smem + slot_region(P::slot_bytes, C)
                       : p.scratch + lane * p.fn_stride;
    fs.est_sum = reinterpret_cast<double*>(b); b += 8 * F;
    fs.t_cold = reinterpret_cast<double*>(b); b += 8 * F;
    fs.t_evict = reinterpret_cast<double*>(b); b += 8 * F;
    fs.q_head_pos = reinterpret_cast<long long*>(b); b += 8 * F;
    fs.q_head_rid = reinterpret_cast<long long*>(b); b += 8 * F;
    if constexpr (P::timers) {
      fs.tmr_next = reinterpret_cast<double*>(b); b += 8 * F;
      fs.rearm_t = reinterpret_cast<double*>(b); b += 8 * F;
      fs.rearm_rid = reinterpret_cast<long long*>(b); b += 8 * F;
    }
    fs.q_len = reinterpret_cast<int*>(b); b += 4 * F;
    fs.est_n = reinterpret_cast<int*>(b); b += 4 * F;
    fs.k = reinterpret_cast<int*>(b);
    if constexpr (P::cold_aware) {
      b += 4 * F;
      fs.coldk = reinterpret_cast<int*>(b);
    }
    if constexpr (P::timers) {
      b += 4 * F;
      fs.tmr_pos = reinterpret_cast<int*>(b); b += 4 * F;
      fs.arr_cnt = reinterpret_cast<int*>(b);
    }
  }

  __device__ void init() {
    const long long tix = p.trace_ix[lane];
    if (t == 0) tally = Tally{0, 0, 0, 0, 0, 0, 0, 0.0, 0.0};
    for (int c = t; c < C; c += 32) {
      sl.fn[c] = -1;
      sl.req[c] = -1;
      sl.seq[c] = kI32Max;
      sl.ready[c] = kBig;
      sl.state[c] = kIdle;
      sl.cap[c] = p.cap_mask[static_cast<long long>(lane) * C + c] != 0;
      if constexpr (P::slot_used) sl.used[c] = 0.0;
      if constexpr (P::faas) {
        sl.prio[c] = 0.0;
        sl.freq[c] = 0;
      }
    }
    for (int f = t; f < F; f += 32) {
      fs.est_sum[f] = 0.0;
      fs.t_cold[f] = p.t_cold[tix * F + f];
      fs.t_evict[f] = p.t_evict[tix * F + f];
      fs.q_head_pos[f] = 0;
      fs.q_head_rid[f] = -1;
      fs.q_len[f] = 0;
      fs.est_n[f] = 0;
      fs.k[f] = 0;
      if constexpr (P::cold_aware) fs.coldk[f] = 0;
      if constexpr (P::timers) {
        fs.tmr_next[f] = kBig;
        fs.rearm_t[f] = kBig;
        fs.rearm_rid[f] = -1;
        fs.tmr_pos[f] = 0;
        fs.arr_cnt[f] = 0;
      }
    }
    __syncwarp();
  }

  __device__ __forceinline__ bool fn_ok(long long f) const {
    return f >= 0 && f < F;
  }
  __device__ __forceinline__ int fc(long long f) const {
    return static_cast<int>(clampll(f, 0, F - 1));
  }
  __device__ __forceinline__ long long rc(long long rid) const {
    return clampll(rid, 0, N - 1);
  }

  // ------------------------------------------------------- estimator
  __device__ __forceinline__ double global_mean() const {
    return gn > 0 ? g_sum / frp::clamp_lo(static_cast<double>(gn), 1.0)
                  : p.prior;
  }
  __device__ __forceinline__ double mean_of(int f, double g) const {
    const int n = fs.est_n[f];
    return n > 0 ? fs.est_sum[f] / frp::clamp_lo(static_cast<double>(n), 1.0)
                 : g;
  }

  // --------------------------------------------------- slot primitives
  __device__ void dispatch(int slot, long long rid, double tm) {
    const double e = exec[rc(rid)];
    const double comp = tm + e;
    __syncwarp();
    if (t == 0) {
      sl.state[slot] = kBusy;
      sl.ready[slot] = comp;
      sl.req[slot] = rid;
      if constexpr (P::slot_used) sl.used[slot] = tm;
      if (p.start != nullptr && rid >= 0 && rid < N) {
        const long long at = static_cast<long long>(lane) * N + rid;
        p.start[at] = tm;
        p.completion[at] = comp;
      }
    }
    __syncwarp();
    ev_rid = rid;
    ev_comp = comp;
    ev_exec = e;
  }

  // The policy's dispatch: FaasCache first raises the slot's use count
  // and recomputes its priority, clock + (freq + 1) * t_cold.
  __device__ __forceinline__ void serve(int slot, long long rid,
                                        double tm) {
    if constexpr (P::faas) {
      const double prio =
          gd_clock + ((static_cast<double>(sl.freq[slot]) + 1.0) *
                      fs.t_cold[fc(sl.fn[slot])]);
      __syncwarp();
      if (t == 0) {
        sl.freq[slot] += 1;
        sl.prio[slot] = prio;
      }
      __syncwarp();
    }
    dispatch(slot, rid, tm);
  }

  // Claim or convert `slot` for `fn` (evict_fn = -1: an empty slot;
  // otherwise the resident function pays its eviction cost first).
  __device__ void start_cold(int slot, long long fn, double tm,
                             long long evict_fn) {
    const bool evicting = evict_fn >= 0;
    const double ev_cost = evicting ? fs.t_evict[fc(evict_fn)] : 0.0;
    const double tc = fs.t_cold[fc(fn)];
    const long long old = sl.fn[slot];
    const bool was_cold = P::cold_aware && sl.state[slot] == kCold;
    __syncwarp();
    if (t == 0) {
      sl.fn[slot] = fn;
      sl.state[slot] = kCold;
      sl.ready[slot] = (tm + tc) + ev_cost;
      sl.req[slot] = -1;
      sl.seq[slot] = tally.seq;
      if constexpr (P::slot_used) sl.used[slot] = 0.0;
      if constexpr (P::faas) {
        sl.freq[slot] = 0;
        sl.prio[slot] = 0.0;
      }
      if (fn_ok(old)) fs.k[old] -= 1;
      if (fn_ok(fn)) fs.k[fn] += 1;
      if constexpr (P::cold_aware) {
        if (was_cold && fn_ok(old)) fs.coldk[old] -= 1;
        if (fn_ok(fn)) fs.coldk[fn] += 1;
      }
      tally.seq += 1;
      tally.cold += 1;
      tally.evict += evicting;
      tally.cold_t = tally.cold_t + tc;
      tally.evict_t = tally.evict_t + ev_cost;
    }
    __syncwarp();
  }

  // ------------------------------------------------------------ queues
  // Consume the head of fn's queue and return its rid; the head cache
  // moves to the successor (garbage when the queue empties).
  __device__ long long q_pop(long long fn) {
    const int f = fc(fn);
    const long long rid = fs.q_head_rid[f];
    const long long gi = pos_off[f] + (fs.q_head_pos[f] + 1);
    const long long succ = pos_rids[clampll(gi, 0, N - 1)];
    __syncwarp();
    if (t == 0 && fn_ok(fn)) {
      fs.q_head_rid[fn] = succ;
      fs.q_head_pos[fn] += 1;
      fs.q_len[fn] -= 1;
    }
    __syncwarp();
    return rid;
  }

  // Append rid (the next arrival position of fn); a push onto a full
  // backlog is dropped and counted in ovf. Returns whether it pushed.
  __device__ bool q_push(long long fn, long long rid) {
    const int q0 = fs.q_len[fc(fn)];
    if (q0 >= Q) {
      if (t == 0) tally.ovf += 1;
      return false;
    }
    __syncwarp();
    if (t == 0 && fn_ok(fn)) {
      if (q0 == 0) fs.q_head_rid[fn] = rid;
      fs.q_len[fn] = q0 + 1;
    }
    __syncwarp();
    return true;
  }

  // ------------------------------------------------------- slot scans
  // The earliest-created idle slot of j (`own`, slot 0 when none);
  // returns whether there is one.
  __device__ __forceinline__ bool find_own(long long j, int& own) const {
    long long key = LLONG_MAX;
    own = INT_MAX;
    bool any_own = false;
    for (int c = t; c < C; c += 32) {
      const bool m = sl.fn[c] == j && sl.state[c] == kIdle && sl.cap[c];
      any_own |= m;
      frp::keep_first_min(key, own, m ? sl.seq[c] : kI32Max, c);
    }
    frp::warp_first_min(key, own);
    return __any_sync(kAll, any_own);
  }

  // The first empty usable slot, INT_MAX when none.
  __device__ __forceinline__ int first_empty() const {
    int empty = INT_MAX;
    for (int c = t; c < C; c += 32)
      if (sl.fn[c] < 0 && sl.cap[c] && c < empty) empty = c;
    for (int off = 16; off > 0; off >>= 1)
      empty = min(empty, __shfl_xor_sync(kAll, empty, off));
    return empty;
  }

  // The keep-alive victim among idle usable instances: the least `key`
  // (the last use for LRU, the priority for GREEDY-DUAL), ties toward
  // the earliest-created instance; returns whether there is one.
  __device__ __forceinline__ bool idle_victim(const double* key,
                                              int& vi) const {
    double vp = INFINITY;
    long long vs = LLONG_MAX;
    vi = INT_MAX;
    bool any = false;
    for (int c = t; c < C; c += 32) {
      if (!(sl.state[c] == kIdle && sl.fn[c] >= 0 && sl.cap[c])) continue;
      any = true;
      keep_lex_min(vp, vs, vi, key[c], sl.seq[c], c);
    }
    warp_lex_min(vp, vs, vi);
    return __any_sync(kAll, any);
  }

  // Whether fn has an instance warming up.
  __device__ __forceinline__ bool warming(long long fn) const {
    bool w = false;
    for (int c = t; c < C; c += 32)
      w |= sl.fn[c] == fn && sl.state[c] == kCold && sl.cap[c];
    return __any_sync(kAll, w);
  }

  // Pop the own queue onto the freed `slot`, if it has a request;
  // returns whether it did.
  __device__ __forceinline__ bool drain_own(int slot, double tm) {
    const long long j = sl.fn[slot];
    if (fs.q_len[fc(j)] > 0) {
      const long long rid = q_pop(j);
      serve(slot, rid, tm);
      return true;
    }
    return false;
  }

  // ------------------------------------------------------- ESFF hooks
  // FRP (Algorithm 3): replace the finished instance by the function of
  // least Eq. 10 weight when it beats the own weight (Eq. 9), else serve
  // the own queue.
  __device__ void esff_exec_done(int slot, double tm) {
    const long long j = sl.fn[slot];
    const int jc = fc(j);
    const double g = global_mean();
    const double nwj = static_cast<double>(fs.q_len[jc]);
    const double tvj = fs.t_evict[jc];
    const double w_own =
        nwj > 0.0 ? mean_of(jc, g) + (tvj * static_cast<double>(fs.k[jc]))
                                         / frp::clamp_lo(nwj, 1.0)
                  : kBig;
    // K1 inline: Eq. 7 swapped (less the COLD slots for ESFF-H) +
    // Eq. 10, first-index argmin over F
    double bw = kBig;
    int bi = F;
    for (int f = t; f < F; f += 32) {
      const double w = frp::weight<double, true, P::cold_aware>(
          mean_of(f, g), fs.t_cold[f], fs.t_evict[f],
          static_cast<double>(fs.q_len[f]), static_cast<double>(fs.k[f]),
          tvj, beta, f != jc,
          P::cold_aware ? static_cast<double>(fs.coldk[f]) : 0.0);
      if (w < bw) {  // f rises per thread: strict < keeps the first
        bw = w;
        bi = f;
      }
    }
    frp::warp_first_min(bw, bi);
    if (t == 0) tally.scans += 1;
    const int best_i = bw >= kBig ? -1 : bi;
    if (best_i >= 0 && bw < w_own) {
      start_cold(slot, best_i, tm, j);
    } else if (fs.q_len[jc] > 0) {
      const long long rid = q_pop(j);
      dispatch(slot, rid, tm);
    }
  }

  // FCP (Algorithm 2) for the arrival `rid` of function j at time tm.
  __device__ void esff_arrival(long long rid, long long j, double tm) {
    const int jc = fc(j);
    int own;
    const bool any_own = find_own(j, own);
    const double qj = static_cast<double>(fs.q_len[jc]);
    if (any_own && qj == 0.0) {
      dispatch(own, rid, tm);
      if (t == 0 && fn_ok(j)) fs.q_head_pos[j] += 1;  // consumed directly
      __syncwarp();
      return;
    }
    const double g = global_mean();
    const double tcj = fs.t_cold[jc];
    const double kj = static_cast<double>(fs.k[jc]);
    const double mj = mean_of(jc, g);
    // ESFF-H: each instance of j still warming up claims one request
    const double cj = P::cold_aware ? static_cast<double>(fs.coldk[jc]) : 0.0;
    // Eq. (7) for an empty slot: start one if the backlog outlasts a
    // cold start
    const int empty = first_empty();
    if (empty < C) {
      double n_e = (qj + 1.0) - ((tcj * kj) / mj);
      if constexpr (P::cold_aware) n_e = n_e - cj;
      if (n_e > 0.0) start_cold(empty, j, tm, -1);
    } else {
      // Eq. (8): convert an idle instance of another function; the
      // victim has the largest running mean (ESFF) or the oldest last
      // use (ESFF-H), ties toward the earliest-created instance, then
      // the first slot
      double vp = INFINITY;
      long long vs = LLONG_MAX;
      int vi = INT_MAX;
      bool any_elig = false;
      for (int c = t; c < C; c += 32) {
        const long long fnc = sl.fn[c];
        if (!(sl.state[c] == kIdle && fnc >= 0 && fnc != j && sl.cap[c]))
          continue;
        const int sf = fc(fnc);
        double n_e2 = (qj + 1.0) - (((tcj + fs.t_evict[sf]) * kj) / mj);
        if constexpr (P::cold_aware) n_e2 = n_e2 - cj;
        if (!(n_e2 > 0.0)) continue;
        any_elig = true;
        const double pc = P::lru ? sl.used[c] : -mean_of(sf, g);
        keep_lex_min(vp, vs, vi, pc, sl.seq[c], c);
      }
      warp_lex_min(vp, vs, vi);
      if (__any_sync(kAll, any_elig)) start_cold(vi, j, tm, sl.fn[vi]);
    }
    q_push(j, rid);
  }

  // ----------------------------------------------- central-queue hooks
  // FaasCache: the clock rises to the evicted instance's priority.
  __device__ __forceinline__ void note_evict(int slot) {
    if constexpr (P::faas) {
      const double pr = sl.prio[slot];
      gd_clock = pr > gd_clock ? pr : gd_clock;
    }
  }

  // The central queue's head: the first-index lexicographic minimum of
  // (running mean for SFF, 0 for FIFO; head request id) over the
  // functions with a waiting request; -1 when none waits.
  __device__ int head_fn() {
    const double g = P::sff ? global_mean() : 0.0;
    double hp = INFINITY;
    long long hs = LLONG_MAX;
    int hi = INT_MAX;
    for (int f = t; f < F; f += 32) {
      if (fs.q_len[f] > 0)
        keep_lex_min(hp, hs, hi, P::sff ? mean_of(f, g) : 0.0,
                     fs.q_head_rid[f], f);
    }
    warp_lex_min(hp, hs, hi);
    if (t == 0) tally.head_scans += 1;
    return hi < F ? hi : -1;
  }

  // A freed idle slot: serve its own function's earliest request (warm
  // reuse), else retarget it to the queue head's function, unless that
  // function already has an instance warming up.
  __device__ void serve_or_replace(int slot, double tm) {
    if (drain_own(slot, tm)) return;
    const int f = head_fn();
    if (f >= 0 && !warming(f)) {
      note_evict(slot);
      start_cold(slot, f, tm, sl.fn[slot]);
    }
  }

  // No idle own instance for an arrival of j: claim a free slot, else
  // evict the keep-alive victim (LRU, or GREEDY-DUAL for FaasCache).
  __device__ void scale_up(long long j, double tm) {
    const int empty = first_empty();
    if (empty < C) {
      start_cold(empty, j, tm, -1);
      return;
    }
    int vi;
    if (idle_victim(P::faas ? sl.prio : sl.used, vi)) {
      note_evict(vi);
      start_cold(vi, j, tm, sl.fn[vi]);
    }
  }

  __device__ void central_arrival(long long rid, long long j, double tm) {
    int own;
    const bool any_own = find_own(j, own);
    if (any_own && fs.q_len[fc(j)] == 0) {
      serve(own, rid, tm);
      if (t == 0 && fn_ok(j)) fs.q_head_pos[j] += 1;  // consumed directly
      __syncwarp();
      return;
    }
    q_push(j, rid);
    scale_up(j, tm);
  }

  // ------------------------------------------------ OpenWhisk-v2 hooks
  __device__ void rearm(long long j, long long rid, double t_fire) {
    __syncwarp();
    if (t == 0 && fn_ok(j)) {
      fs.rearm_t[j] = t_fire;
      fs.rearm_rid[j] = rid;
    }
    __syncwarp();
  }

  // An idle own slot, else queue; then the arrival's original timer: an
  // idle rail arms its head fire time for a pushed arrival and consumes
  // the entry of one that was not pushed; behind a busy rail the entry
  // stays and fires later as a no-op.
  __device__ void owv2_arrival(long long rid, long long j, double tm) {
    const int jc = fc(j);
    int own;
    const bool any_own = find_own(j, own);
    bool pushed = false;
    if (any_own && fs.q_len[jc] == 0) {
      dispatch(own, rid, tm);
      if (t == 0 && fn_ok(j)) fs.q_head_pos[j] += 1;  // consumed directly
      __syncwarp();
    } else {
      pushed = q_push(j, rid);
    }
    if (fs.tmr_pos[jc] == fs.arr_cnt[jc] - 1) {
      __syncwarp();
      if (t == 0 && fn_ok(j)) {
        if (pushed)
          fs.tmr_next[j] = tm + p.threshold;
        else
          fs.tmr_pos[j] += 1;
      }
      __syncwarp();
    }
  }

  // A timer of `rid` fires: if rid heads its queue, scale up for it (an
  // empty slot, else the LRU idle victim), unless its function is still
  // warming up or nothing is evictable: then re-arm at tm + threshold.
  __device__ void owv2_timer(long long rid, double tm) {
    const long long j = fn_id[rc(rid)];
    const int jc = fc(j);
    if (!(fs.q_len[jc] > 0 && fs.q_head_rid[jc] == rid)) return;
    if (warming(j)) {
      rearm(j, rid, tm + p.threshold);
      return;
    }
    const int empty = first_empty();
    if (empty < C) {
      start_cold(empty, j, tm, -1);
      return;
    }
    int vi;
    if (idle_victim(sl.used, vi))
      start_cold(vi, j, tm, sl.fn[vi]);
    else
      rearm(j, rid, tm + p.threshold);
  }

  // ------------------------------------------------- the policy's hooks
  __device__ __forceinline__ void on_slot(bool is_cold, int slot,
                                          double tm) {
    if constexpr (P::esff) {
      if (is_cold)
        drain_own(slot, tm);
      else
        esff_exec_done(slot, tm);
    } else if constexpr (P::central) {
      serve_or_replace(slot, tm);
    } else {
      drain_own(slot, tm);
    }
  }

  __device__ __forceinline__ void on_arrival(long long rid, long long j,
                                             double tm) {
    if constexpr (P::esff)
      esff_arrival(rid, j, tm);
    else if constexpr (P::central)
      central_arrival(rid, j, tm);
    else
      owv2_arrival(rid, j, tm);
  }

  // ------------------------------------------------------------- fold
  __device__ void fold() {
    if (ev_rid < 0) return;
    const double resp = ev_comp - arrival[rc(ev_rid)];
    const double slow = resp / frp::clamp_lo(ev_exec, 1e-9);
    r_sum = r_sum + resp;
    s_sum = s_sum + slow;
    r_max = resp > r_max ? resp : r_max;
    const double lg = log(frp::clamp_lo(resp, 1e-30)) * kInvLn10;
    double b = floor((lg - kHistLo) * kHistPerDecade);
    b = b < 0.0 ? 0.0 : (b > kHistBins - 1 ? kHistBins - 1 : b);
    const int bin = static_cast<int>(b);
    if (t == (bin & 31)) {
      if (bin < 32) ++h_lo; else ++h_hi;
    }
    if (t == 0) options_fold(resp);
  }

  // The engine options' part of the fold (thread 0, global memory); the
  // arrival is read again here, so that it is not held live across the
  // histogram's bin when the options are off.
  __device__ __forceinline__ void options_fold(double resp) {
    if (p.deadlines != nullptr) {
      const long long fnr = fn_id[rc(ev_rid)];
      if (fn_ok(fnr) && resp > p.deadlines[fnr])
        p.dl_miss[static_cast<long long>(lane) * F + fnr] += 1;
    }
    if (p.tl_bins > 0) {
      int tb = static_cast<int>(arrival[rc(ev_rid)] / p.tl_bucket);
      tb = tb < 0 ? 0 : (tb > p.tl_bins - 1 ? p.tl_bins - 1 : tb);
      const long long at = static_cast<long long>(lane) * p.tl_bins + tb;
      p.tl_cnt[at] += 1;
      p.tl_resp[at] = p.tl_resp[at] + resp;
      p.tl_exec[at] = p.tl_exec[at] + ev_exec;
    }
  }

  // The timer event at candidate `ei` (an original timer or a re-arm):
  // consume it, then the hook.
  __device__ void timer_event(int ei, double tm) {
    const int n0 = 2 * C;
    long long rid;
    if (ei < n0 + F) {
      // the next original timer of f: the arrival at position tmr_pos;
      // the rail moves on to its successor, if it has arrived
      const int f = ei - n0;
      const long long p_o = fs.tmr_pos[f];
      const long long base = pos_off[f];
      rid = pos_rids[clampll(base + p_o, 0, N - 1)];
      const long long succ = pos_rids[clampll(base + (p_o + 1), 0, N - 1)];
      const double nxt =
          p_o + 1 < fs.arr_cnt[f] ? arrival[rc(succ)] + p.threshold : kBig;
      __syncwarp();
      if (t == 0) {
        fs.tmr_pos[f] = static_cast<int>(p_o + 1);
        fs.tmr_next[f] = nxt;
      }
      __syncwarp();
    } else {
      const int f = ei - n0 - F;
      rid = fs.rearm_rid[f];
      __syncwarp();
      if (t == 0) fs.rearm_t[f] = kBig;
      __syncwarp();
    }
    if (t == 0) tally.timers += 1;
    owv2_timer(rid, tm);
  }

  // ------------------------------------------------------------- loop
  __device__ void run() {
    // the arrival's candidate index: after the slots (and the timers)
    const int n_arr = 2 * C + (P::timers ? 2 * F : 0);
    // the next arrival, loaded one event ahead
    double t_arr = N > 0 ? arrival[0] : kBig;
    long long fn_arr = N > 0 ? fn_id[0] : 0;
    while (done < NL && stall == 0) {
      // pick: first-index argmin over
      // [busy | cold | (original timers | re-arms) | arrival]
      double w = INFINITY;
      int ei = INT_MAX;
      for (int c = t; c < C; c += 32) {
        const double r = sl.cap[c] ? sl.ready[c] : kBig;
        const int st = sl.state[c];
        frp::keep_first_min(w, ei, st == kBusy ? r : kBig, c);
        frp::keep_first_min(w, ei, st == kCold ? r : kBig, C + c);
      }
      if constexpr (P::timers) {
        for (int f = t; f < F; f += 32) {
          frp::keep_first_min(w, ei, fs.tmr_next[f], 2 * C + f);
          frp::keep_first_min(w, ei, fs.rearm_t[f], 2 * C + F + f);
        }
      }
      frp::warp_first_min(w, ei);
      const long long na = next;
      frp::keep_first_min(w, ei, na < NL ? t_arr : kBig, n_arr);
      if (!(w < kBig)) {
        stall = 1;
        break;
      }
      const double t_ev = w;
      const bool ev_slot = ei < 2 * C;
      const bool is_cold = ei >= C;
      const int slot = static_cast<int>(clampll(is_cold ? ei - C : ei, 0,
                                                C - 1));
      const bool ev_arr = ei == n_arr && na < NL;
      ev_rid = -1;
      ev_comp = 0.0;
      ev_exec = 0.0;
      if (ev_slot) {
        // release, estimator, then the policy hook
        const long long rid_done = sl.req[slot];
        const long long j_done = sl.fn[slot];
        const double e_done = exec[rc(rid_done)];
        __syncwarp();
        if (t == 0) {
          sl.state[slot] = kIdle;
          sl.ready[slot] = kBig;
          sl.req[slot] = -1;
          if (!is_cold && fn_ok(j_done)) {
            fs.est_sum[j_done] = fs.est_sum[j_done] + e_done;
            fs.est_n[j_done] += 1;
          }
          if constexpr (P::cold_aware) {
            if (is_cold && fn_ok(j_done)) fs.coldk[j_done] -= 1;
          }
        }
        __syncwarp();
        if (!is_cold) {
          g_sum = g_sum + e_done;
          gn += 1;
          done += 1;
        }
        on_slot(is_cold, slot, t_ev);
        iters += 1;
      } else if (P::timers && ei < n_arr) {
        iters += 1;
        timer_event(ei, t_ev);
      } else if (ev_arr) {
        next = na + 1;
        iters += 1;
        const long long j = fn_arr;
        const double ta = t_arr;
        if (next < N) {  // the next arrival's loads overlap this event
          t_arr = arrival[next];
          fn_arr = fn_id[next];
        }
        if constexpr (P::timers) {
          if (t == 0 && fn_ok(j)) fs.arr_cnt[j] += 1;
          __syncwarp();
        }
        on_arrival(na, j, ta);
      }
      fold();
      if (iters >= p.max_iters) stall = 2;
    }
  }

  __device__ void write_out() {
    if (t == 0) {
      int64_t* c = p.ctr + static_cast<long long>(lane) * N_CTR;
      c[C_NEXT] = next;
      c[C_DONE] = done;
      c[C_ITERS] = iters;
      c[C_STALL] = stall;
      c[C_SEQ] = tally.seq;
      c[C_GN] = gn;
      c[C_COLD] = tally.cold;
      c[C_EVICT] = tally.evict;
      c[C_OVF] = tally.ovf;
      double* s = p.sums + static_cast<long long>(lane) * N_SUM;
      s[S_GSUM] = g_sum;
      s[S_COLD_T] = tally.cold_t;
      s[S_EVICT_T] = tally.evict_t;
      s[S_RSUM] = r_sum;
      s[S_SSUM] = s_sum;
      s[S_RMAX] = r_max;
      int64_t* pc = p.pcounts + static_cast<long long>(lane) * N_PC;
      pc[P_FRP] = tally.scans;
      pc[P_HEAD] = tally.head_scans;
      pc[P_TIMER] = tally.timers;
    }
    int32_t* h = p.hist + static_cast<long long>(lane) * kHistBins;
    h[t] = h_lo;
    h[t + 32] = h_hi;
  }
};

// `p` stays in the parameter space (__grid_constant__): the lane keeps a
// reference to it, with no copy to local memory.
template <class P>
__global__ void __launch_bounds__(32)
    event_loop_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  Lane<P> ln(p, smem);
  ln.init();
  ln.run();
  ln.write_out();
}

template <class P>
int launch(const Params& p, int n_lanes, int smem_bytes,
           cudaStream_t stream) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        event_loop_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  event_loop_kernel<P><<<n_lanes, 32, smem_bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <class P>
int layout(long long* out, int n) {
  const long long v[] = {P::slot_bytes, P::fn_bytes, kHistBins,
                         C_NEXT,        C_DONE,      C_ITERS,   C_STALL,
                         C_SEQ,         C_GN,        C_COLD,    C_EVICT,
                         C_OVF,         N_CTR,       S_GSUM,    S_COLD_T,
                         S_EVICT_T,     S_RSUM,      S_SSUM,    S_RMAX,
                         N_SUM,         P_FRP,       P_HEAD,    P_TIMER,
                         N_PC};
  const int m = static_cast<int>(sizeof(v) / sizeof(v[0]));
  for (int i = 0; i < m && i < n; ++i) out[i] = v[i];
  return m;
}

// One case a policy code; the codes are the wrapper's VARIANTS.
#define K0_VARIANTS(X)                                                   \
  X(0, EsffP) X(1, EsffColdP) X(2, EsffLruP) X(3, EsffHP) X(4, FifoP)    \
  X(5, SffP) X(6, FaasP) X(7, Owv2P)

}  // namespace

// Plain C interface for ctypes: one block of one warp a lane,
// `smem_bytes` of dynamic shared memory (slots, and the per-function
// state when fn_in_shared), the variant chosen by `policy`; the engine
// options as in Params (null pointers and tl_bins 0 when off). Returns
// cudaGetLastError() right after the launch (0 = launched; -1 for an
// unknown policy code); the launch is asynchronous on `stream`, and
// nothing here allocates or synchronises.
extern "C" int event_loop_run(
    int policy, const int64_t* fn_id, const double* arrival,
    const double* exec_time, const int64_t* pos_rids, const int64_t* pos_off,
    const double* t_cold, const double* t_evict, const int64_t* trace_ix,
    const uint8_t* cap_mask, const double* beta, double prior,
    double threshold, int n_lanes, int n_req, int n_fns, int n_slots,
    int queue_cap, int fn_in_shared, int smem_bytes, void* scratch,
    long long fn_stride, long long max_iters, int64_t* ctr, double* sums,
    int32_t* hist, int64_t* pcounts, double* start, double* completion,
    const int64_t* n_live, const double* deadlines, int tl_bins,
    double tl_bucket, int32_t* dl_miss, int32_t* tl_cnt, double* tl_resp,
    double* tl_exec, void* stream) {
  Params p;
  p.fn_id = fn_id;
  p.arrival = arrival;
  p.exec_time = exec_time;
  p.pos_rids = pos_rids;
  p.pos_off = pos_off;
  p.t_cold = t_cold;
  p.t_evict = t_evict;
  p.trace_ix = trace_ix;
  p.cap_mask = cap_mask;
  p.beta = beta;
  p.prior = prior;
  p.threshold = threshold;
  p.n_req = n_req;
  p.n_fns = n_fns;
  p.n_slots = n_slots;
  p.queue_cap = queue_cap;
  p.fn_in_shared = fn_in_shared;
  p.scratch = static_cast<unsigned char*>(scratch);
  p.fn_stride = fn_stride;
  p.max_iters = max_iters;
  p.ctr = ctr;
  p.sums = sums;
  p.hist = hist;
  p.pcounts = pcounts;
  p.start = start;
  p.completion = completion;
  p.n_live = n_live;
  p.deadlines = deadlines;
  p.tl_bins = tl_bins;
  p.tl_bucket = tl_bucket;
  p.dl_miss = dl_miss;
  p.tl_cnt = tl_cnt;
  p.tl_resp = tl_resp;
  p.tl_exec = tl_exec;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (policy) {
#define K0_LAUNCH(code, P) \
  case code:               \
    return launch<P>(p, n_lanes, smem_bytes, st);
    K0_VARIANTS(K0_LAUNCH)
#undef K0_LAUNCH
  }
  return -1;
}

// The layout of variant `policy` that the wrapper reads the results by
// and plans shared memory with: its slot and function bytes, kHistBins,
// then the column of each counter (C_NEXT .. C_OVF, N_CTR), each sum
// (S_GSUM .. S_RMAX, N_SUM) and each policy count (P_FRP .. P_TIMER,
// N_PC). kernels/event_loop.py checks it once a variant against its
// own. Returns the number of values (24), writing at most `n` of them;
// -1 for an unknown policy code.
extern "C" int event_loop_layout(int policy, long long* out, int n) {
  switch (policy) {
#define K0_LAYOUT(code, P) \
  case code:               \
    return layout<P>(out, n);
    K0_VARIANTS(K0_LAYOUT)
#undef K0_LAYOUT
  }
  return -1;
}
