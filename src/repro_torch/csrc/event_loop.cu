// The ESFF event loop (K0), run to completion on the card in one launch
// per lane chunk, hand-written for Hopper (sm_90a).
//
// Replaces the XLA while_loop of src/repro/core/jax_engine.py::_simulate
// (:1001) with the ESFF policy kernel (src/repro/core/jax_policies.py:59:
// FCP on arrival, FRP on completion), and runs K1 (the FRP scan,
// src/repro/kernels/sched_weights.py:68) inline through
// csrc/frp_select.cuh. Its plain version is the eager loop of
// src/repro_torch/core/engine.py (`simulate_eager`, `_event_step`, the
// hooks of core/policies.py::ESFFKernel); every result is bitwise that
// loop's, so every expression below keeps the eager spelling's order of
// operations, the library is built with --fmad=false, division is IEEE
// and the histogram's log is libdevice's (as torch's on the card).
//
// One warp a lane, one lane a block. A lane's events form a serial
// chain; the warp's threads split the slot scans (thread c owns slots c,
// c + 32, ...) and the FRP scan (functions f, f + 32, ...) and reduce by
// shuffles. The lane's scalars (counters, sums, the event registers) are
// warp-uniform registers that every thread updates alike; shared state
// is read by all threads and written by thread 0 between two
// __syncwarp()s. Per event:
//   pick    first-index argmin over [BUSY slots | COLD slots | arrival]
//           (ties: EXEC_DONE < COLD_DONE < ARRIVAL, then the slot index)
//   slot    release; on a completion the estimator update, then FRP
//           (Eq. 9, 10: the inline scan, replace or pop the own queue);
//           on a cold start done, pop the own queue
//   arrival FCP (Eq. 7, 8): an idle own slot, else queue and maybe start
//           a cold slot (an empty one, or the victim of Eq. 8)
//   fold    response and slowdown sums, maximum, 64-bin log histogram
// A lane stops when every request is done, with stall 1 when it is
// active and has no finite event (after a queue overflow), or stall 2 at
// 256 N + 4096 events; each event raises `iters`, so the loop ends.
//
// Layout. Slots (40 B each) live in shared memory. The per-function
// state (52 B each: est_sum, the lane's t_cold and t_evict rows,
// q_head_pos, q_head_rid as f64 / i64; q_len, est_n, K as i32) lives in
// shared memory too when it fits beside the slots in the block's 227 KB
// (F up to ~4,400), else in global scratch that the wrapper allocates:
// the same code over generic pointers set once at entry
// (kernels/event_loop.py::layout_plan makes the choice). K = |K^j| is a
// count kept by start_cold, where the eager loop recounts (L, C, F).
// The trace (fn_id, arrival, exec_time, the positional queue layout
// pos_rids / pos_off) stays in global memory, L2-resident (~32 B a
// request). The histogram lives in registers: thread t holds bins t and
// t + 32.
//
// What bounds it on an H100: the trace read once and the results
// written once is ~1.9 MB at N = 60,000 (~0.6 us at 3.35 TB/s); the FRP
// scans are ~12 f64 operations a function a completion (~30 us for
// Fig. 5's seven lanes at 34 TFLOP/s). Neither is the limit: a lane's
// events are a serial chain of dependent shared- and L2-memory reads,
// shuffles and f64 divisions, so the time is events x the latency of
// one event, and lanes run side by side (one warp each).

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
constexpr int kSlotBytes = 40;
constexpr int kFnBytes = 52;
static_assert(kSlotBytes == 4 * 8 + 2 * 4, "the slot arrays of Lane()");
static_assert(kFnBytes == 5 * 8 + 3 * 4, "the function arrays of Lane()");

// the columns of the counters and sums rows; esff_event_loop_layout
// reports them, with kSlotBytes, kFnBytes and kHistBins, to the wrapper
enum { C_NEXT, C_DONE, C_ITERS, C_STALL, C_SEQ, C_GN, C_COLD, C_EVICT,
       C_OVF, N_CTR };
enum { S_GSUM, S_COLD_T, S_EVICT_T, S_RSUM, S_SSUM, S_RMAX, N_SUM };

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
  int n_req, n_fns, n_slots, queue_cap;
  int fn_in_shared;
  unsigned char* scratch;    // (L, fn_stride) when !fn_in_shared
  long long fn_stride;
  long long max_iters;
  int64_t* ctr;              // (L, N_CTR)
  double* sums;              // (L, N_SUM)
  int32_t* hist;             // (L, 64)
  int64_t* scans;            // (L,): inline FRP scans
  double* start;             // (L, N) or null (stream mode)
  double* completion;        // (L, N) or null
};

// the eager state's slot_used (the LRU tie-break of ESFF-H) is not
// kept: no ESFF hook reads it
struct Slots {
  long long *fn, *req, *seq;
  double* ready;
  int *state, *cap;
};

struct Fns {
  double *est_sum, *t_cold, *t_evict;
  long long *q_head_pos, *q_head_rid;
  int *q_len, *est_n, *k;
};

__device__ __forceinline__ long long clampll(long long x, long long lo,
                                             long long hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// The lane's event loop; one object a warp, every member warp-uniform.
struct Lane {
  const Params& p;
  const int t;              // this thread's index in the warp
  const int lane, N, F, C, Q;
  const int64_t* fn_id;
  const double* arrival;
  const double* exec;
  const int64_t* pos_rids;
  const int64_t* pos_off;
  const double beta;
  Slots sl;
  Fns fs;
  long long next = 0, done = 0, iters = 0, stall = 0, seq = 0, gn = 0,
            cold = 0, evict = 0, ovf = 0, scans = 0;
  double g_sum = 0.0, cold_t = 0.0, evict_t = 0.0, r_sum = 0.0,
         s_sum = 0.0, r_max = 0.0;
  long long ev_rid = -1;    // the event's dispatch, folded at its end
  double ev_comp = 0.0, ev_exec = 0.0;
  int h_lo = 0, h_hi = 0;   // histogram bins t and t + 32

  __device__ Lane(const Params& p_, unsigned char* smem)
      : p(p_), t(threadIdx.x), lane(blockIdx.x), N(p_.n_req),
        F(p_.n_fns), C(p_.n_slots), Q(p_.queue_cap),
        fn_id(p_.fn_id + p_.trace_ix[blockIdx.x] * p_.n_req),
        arrival(p_.arrival + p_.trace_ix[blockIdx.x] * p_.n_req),
        exec(p_.exec_time + p_.trace_ix[blockIdx.x] * p_.n_req),
        pos_rids(p_.pos_rids + p_.trace_ix[blockIdx.x] * p_.n_req),
        pos_off(p_.pos_off + p_.trace_ix[blockIdx.x] * (p_.n_fns + 1)),
        beta(p_.beta[blockIdx.x]) {
    // slots: four 8-byte arrays, then two 4-byte ones
    unsigned char* b = smem;
    sl.fn = reinterpret_cast<long long*>(b); b += 8 * C;
    sl.req = reinterpret_cast<long long*>(b); b += 8 * C;
    sl.seq = reinterpret_cast<long long*>(b); b += 8 * C;
    sl.ready = reinterpret_cast<double*>(b); b += 8 * C;
    sl.state = reinterpret_cast<int*>(b); b += 4 * C;
    sl.cap = reinterpret_cast<int*>(b); b += 4 * C;
    // functions: in shared memory after the slots, or in global scratch
    b = p.fn_in_shared ? smem + kSlotBytes * C
                       : p.scratch + lane * p.fn_stride;
    fs.est_sum = reinterpret_cast<double*>(b); b += 8 * F;
    fs.t_cold = reinterpret_cast<double*>(b); b += 8 * F;
    fs.t_evict = reinterpret_cast<double*>(b); b += 8 * F;
    fs.q_head_pos = reinterpret_cast<long long*>(b); b += 8 * F;
    fs.q_head_rid = reinterpret_cast<long long*>(b); b += 8 * F;
    fs.q_len = reinterpret_cast<int*>(b); b += 4 * F;
    fs.est_n = reinterpret_cast<int*>(b); b += 4 * F;
    fs.k = reinterpret_cast<int*>(b);
  }

  __device__ void init() {
    const long long tix = p.trace_ix[lane];
    for (int c = t; c < C; c += 32) {
      sl.fn[c] = -1;
      sl.req[c] = -1;
      sl.seq[c] = kI32Max;
      sl.ready[c] = kBig;
      sl.state[c] = kIdle;
      sl.cap[c] = p.cap_mask[static_cast<long long>(lane) * C + c] != 0;
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

  // Claim or convert `slot` for `fn` (evict_fn = -1: an empty slot;
  // otherwise the resident function pays its eviction cost first).
  __device__ void start_cold(int slot, long long fn, double tm,
                             long long evict_fn) {
    const bool evicting = evict_fn >= 0;
    const double ev_cost = evicting ? fs.t_evict[fc(evict_fn)] : 0.0;
    const double tc = fs.t_cold[fc(fn)];
    const long long old = sl.fn[slot];
    __syncwarp();
    if (t == 0) {
      sl.fn[slot] = fn;
      sl.state[slot] = kCold;
      sl.ready[slot] = (tm + tc) + ev_cost;
      sl.req[slot] = -1;
      sl.seq[slot] = seq;
      if (fn_ok(old)) fs.k[old] -= 1;
      if (fn_ok(fn)) fs.k[fn] += 1;
    }
    __syncwarp();
    seq += 1;
    cold += 1;
    evict += evicting;
    cold_t = cold_t + tc;
    evict_t = evict_t + ev_cost;
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
  // backlog is dropped and counted in ovf.
  __device__ void q_push(long long fn, long long rid) {
    const int q0 = fs.q_len[fc(fn)];
    if (q0 >= Q) {
      ovf += 1;
      return;
    }
    __syncwarp();
    if (t == 0 && fn_ok(fn)) {
      if (q0 == 0) fs.q_head_rid[fn] = rid;
      fs.q_len[fn] = q0 + 1;
    }
    __syncwarp();
  }

  // ------------------------------------------------------ policy hooks
  __device__ void on_cold_done(int slot, double tm) {
    const long long j = sl.fn[slot];
    if (fs.q_len[fc(j)] > 0) {
      const long long rid = q_pop(j);
      dispatch(slot, rid, tm);
    }
  }

  // FRP (Algorithm 3): replace the finished instance by the function of
  // least Eq. 10 weight when it beats the own weight (Eq. 9), else serve
  // the own queue.
  __device__ void on_exec_done(int slot, double tm) {
    const long long j = sl.fn[slot];
    const int jc = fc(j);
    const double g = global_mean();
    const double nwj = static_cast<double>(fs.q_len[jc]);
    const double tvj = fs.t_evict[jc];
    const double w_own =
        nwj > 0.0 ? mean_of(jc, g) + (tvj * static_cast<double>(fs.k[jc]))
                                         / frp::clamp_lo(nwj, 1.0)
                  : kBig;
    // K1 inline: Eq. 7 swapped + Eq. 10, first-index argmin over F
    double bw = kBig;
    int bi = F;
    for (int f = t; f < F; f += 32) {
      const double w = frp::weight<double, true>(
          mean_of(f, g), fs.t_cold[f], fs.t_evict[f],
          static_cast<double>(fs.q_len[f]), static_cast<double>(fs.k[f]),
          tvj, beta, f != jc);
      if (w < bw) {  // f rises per thread: strict < keeps the first
        bw = w;
        bi = f;
      }
    }
    frp::warp_first_min(bw, bi);
    scans += 1;
    const int best_i = bw >= kBig ? -1 : bi;
    if (best_i >= 0 && bw < w_own) {
      start_cold(slot, best_i, tm, j);
    } else if (fs.q_len[jc] > 0) {
      const long long rid = q_pop(j);
      dispatch(slot, rid, tm);
    }
  }

  // FCP (Algorithm 2) for the arrival `rid` of function j at time tm.
  __device__ void on_arrival(long long rid, long long j, double tm) {
    const int jc = fc(j);
    // the earliest-created idle slot of j (slot 0 when there is none)
    long long key = LLONG_MAX;
    int own = INT_MAX;
    bool any_own = false;
    for (int c = t; c < C; c += 32) {
      const bool m = sl.fn[c] == j && sl.state[c] == kIdle && sl.cap[c];
      any_own |= m;
      frp::keep_first_min(key, own, m ? sl.seq[c] : kI32Max, c);
    }
    frp::warp_first_min(key, own);
    any_own = __any_sync(kAll, any_own);
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
    // Eq. (7) for an empty slot: start one if the backlog outlasts a
    // cold start
    int empty = INT_MAX;
    for (int c = t; c < C; c += 32)
      if (sl.fn[c] < 0 && sl.cap[c] && c < empty) empty = c;
    for (int off = 16; off > 0; off >>= 1)
      empty = min(empty, __shfl_xor_sync(kAll, empty, off));
    if (empty < C) {
      const double n_e = (qj + 1.0) - ((tcj * kj) / mj);
      if (n_e > 0.0) start_cold(empty, j, tm, -1);
    } else {
      // Eq. (8): convert an idle instance of another function; the
      // victim has the largest running mean, ties toward the
      // earliest-created instance, then the first slot
      double vp = INFINITY;
      long long vs = LLONG_MAX;
      int vi = INT_MAX;
      bool any_elig = false;
      for (int c = t; c < C; c += 32) {
        const long long fnc = sl.fn[c];
        if (!(sl.state[c] == kIdle && fnc >= 0 && fnc != j && sl.cap[c]))
          continue;
        const int sf = fc(fnc);
        const double n_e2 = (qj + 1.0) - (((tcj + fs.t_evict[sf]) * kj) / mj);
        if (!(n_e2 > 0.0)) continue;
        any_elig = true;
        const double pc = -mean_of(sf, g);
        const long long sc = sl.seq[c];
        if (pc < vp || (pc == vp && (sc < vs || (sc == vs && c < vi)))) {
          vp = pc;
          vs = sc;
          vi = c;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const double op = __shfl_xor_sync(kAll, vp, off);
        const long long os = __shfl_xor_sync(kAll, vs, off);
        const int oi = __shfl_xor_sync(kAll, vi, off);
        if (op < vp || (op == vp && (os < vs || (os == vs && oi < vi)))) {
          vp = op;
          vs = os;
          vi = oi;
        }
      }
      if (__any_sync(kAll, any_elig)) start_cold(vi, j, tm, sl.fn[vi]);
    }
    q_push(j, rid);
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
  }

  // ------------------------------------------------------------- loop
  __device__ void run() {
    // the next arrival, loaded one event ahead
    double t_arr = N > 0 ? arrival[0] : kBig;
    long long fn_arr = N > 0 ? fn_id[0] : 0;
    while (done < N && stall == 0) {
      // pick: first-index argmin over [busy | cold | arrival]
      double w = INFINITY;
      int ei = INT_MAX;
      for (int c = t; c < C; c += 32) {
        const double r = sl.cap[c] ? sl.ready[c] : kBig;
        const int st = sl.state[c];
        frp::keep_first_min(w, ei, st == kBusy ? r : kBig, c);
        frp::keep_first_min(w, ei, st == kCold ? r : kBig, C + c);
      }
      frp::warp_first_min(w, ei);
      const long long na = next;
      frp::keep_first_min(w, ei, na < N ? t_arr : kBig, 2 * C);
      if (!(w < kBig)) {
        stall = 1;
        break;
      }
      const double t_ev = w;
      const bool ev_slot = ei < 2 * C;
      const bool is_cold = ei >= C;
      const int slot = static_cast<int>(clampll(is_cold ? ei - C : ei, 0,
                                                C - 1));
      const bool ev_arr = ei == 2 * C && na < N;
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
        }
        __syncwarp();
        if (is_cold) {
          on_cold_done(slot, t_ev);
        } else {
          g_sum = g_sum + e_done;
          gn += 1;
          done += 1;
          on_exec_done(slot, t_ev);
        }
        iters += 1;
      } else if (ev_arr) {
        next = na + 1;
        iters += 1;
        const long long j = fn_arr;
        const double ta = t_arr;
        if (next < N) {  // the next arrival's loads overlap this event
          t_arr = arrival[next];
          fn_arr = fn_id[next];
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
      c[C_SEQ] = seq;
      c[C_GN] = gn;
      c[C_COLD] = cold;
      c[C_EVICT] = evict;
      c[C_OVF] = ovf;
      double* s = p.sums + static_cast<long long>(lane) * N_SUM;
      s[S_GSUM] = g_sum;
      s[S_COLD_T] = cold_t;
      s[S_EVICT_T] = evict_t;
      s[S_RSUM] = r_sum;
      s[S_SSUM] = s_sum;
      s[S_RMAX] = r_max;
      p.scans[lane] = scans;
    }
    int32_t* h = p.hist + static_cast<long long>(lane) * kHistBins;
    h[t] = h_lo;
    h[t + 32] = h_hi;
  }
};

// `p` stays in the parameter space (__grid_constant__): the lane keeps a
// reference to it, with no copy to local memory.
__global__ void __launch_bounds__(32)
    esff_event_loop_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  Lane ln(p, smem);
  ln.init();
  ln.run();
  ln.write_out();
}

}  // namespace

// Plain C interface for ctypes: one block of one warp a lane,
// `smem_bytes` of dynamic shared memory (slots, and the per-function
// state when fn_in_shared). Returns cudaGetLastError() right after the
// launch (0 = launched); the launch is asynchronous on `stream`, and
// nothing here allocates or synchronises.
extern "C" int esff_event_loop(
    const int64_t* fn_id, const double* arrival, const double* exec_time,
    const int64_t* pos_rids, const int64_t* pos_off, const double* t_cold,
    const double* t_evict, const int64_t* trace_ix, const uint8_t* cap_mask,
    const double* beta, double prior, int n_lanes, int n_req, int n_fns,
    int n_slots, int queue_cap, int fn_in_shared, int smem_bytes,
    void* scratch, long long fn_stride, long long max_iters, int64_t* ctr,
    double* sums, int32_t* hist, int64_t* scans, double* start,
    double* completion, void* stream) {
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
  p.scans = scans;
  p.start = start;
  p.completion = completion;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        esff_event_loop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  esff_event_loop_kernel<<<n_lanes, 32, smem_bytes,
                           static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The layout the wrapper reads the results by and plans shared memory
// with: kSlotBytes, kFnBytes, kHistBins, then the column of each counter
// (C_NEXT .. C_OVF, N_CTR) and each sum (S_GSUM .. S_RMAX, N_SUM).
// kernels/event_loop.py checks it once against its LAYOUT. Returns the
// number of values (20), writing at most `n` of them.
extern "C" int esff_event_loop_layout(long long* out, int n) {
  const long long v[] = {kSlotBytes, kFnBytes, kHistBins,
                         C_NEXT,     C_DONE,   C_ITERS,   C_STALL, C_SEQ,
                         C_GN,       C_COLD,   C_EVICT,   C_OVF,   N_CTR,
                         S_GSUM,     S_COLD_T, S_EVICT_T, S_RSUM,  S_SSUM,
                         S_RMAX,     N_SUM};
  const int m = static_cast<int>(sizeof(v) / sizeof(v[0]));
  for (int i = 0; i < m && i < n; ++i) out[i] = v[i];
  return m;
}
