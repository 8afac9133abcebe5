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
// picks the instantiation from a policy code, once a launch. `Lane`'s
// second parameter is the topology: one node (the single-node engine) or
// a cluster of K nodes behind a dynamic router (the K-node variant,
// below). Its plain
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
// at most once an event) live in 88 B of static shared memory, touched by
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
// The K-node variant (event_loop_cluster_run) replaces the XLA while_loop
// of src/repro/cluster/engine.py::_simulate_cluster (:413); its plain
// version is src/repro_torch/cluster/engine.py (`simulate_cluster_eager`).
// A lane
// carries its own topology (Params::topo: K nodes of C slots, the router
// code, JSQ's d and the hash seed; its delays and capacity mask). The
// hooks above run unchanged on the event's node through base offsets:
// enter_node(k) points the slot view at slots k*C.. and the per-function
// view at k*F.. and loads the node's estimator globals (and FaasCache's
// clock), leave_node() stores them back: JAX's per-event view and commit.
// What differs is the queue and the timer rail (q_push, q_pop,
// consume_direct, arm, timer_event): per-(node, function) FIFOs on the
// link rail `nxt` (one int32 successor a request, in global memory, each
// written once when its successor is pushed), the timer chain `tnx` over
// node arrivals (la_rid, tmr_seq, tmr_rid), and, on a lane with delay,
// the in-flight chain `dnx` a node. Per event:
//   pick    first-index argmin over [BUSY K*C | COLD K*C | timers K*F |
//           re-arms K*F (OpenWhisk-v2) | in-flight heads K (a lane with
//           delay) | orphan 1 | toggles K (a lane with churn) | arrival],
//           node-major in each class
//   route   at an arrival, the lane's router on the state before the
//           event (K > 1): JSQ(d) draws d distinct nodes by a partial
//           Fisher-Yates over mix32(rid, seed + i) and keeps the least
//           loaded (queued + busy; ties: the earliest draw);
//           cold_aware takes the node of least startability score
//           ((no idle own instance ? t_cold : 0) + mean_j * q_j + gmean
//           * (q_tot + busy)), slo_aware adds the node's delay; each
//           thread scores nodes t, t + 32, ...
//   node    a raw arrival of a lane with delay joins its node's in-flight
//           FIFO, stamped with its landing time arrival + delay_k (land_t);
//           the head lands then as a node arrival; the policy, the timers
//           and the fold run on that node-local clock. With a delay
//           schedule (a lane flag, `var`) delay_k is the node's
//           piecewise-constant value at the arrival (fmod for a periodic
//           one, exact as jnp.mod on positive operands)
//   churn   (a lane flag, `churn`: some node toggles) a toggle event a
//           node off its row of churn_t, the cursor ch_ix (even: up).
//           NODE_DOWN drains the node onto the lane's park FIFO (chained
//           on nxt): its busy slots' requests by ascending rid (each
//           thread links its slots' rids to the next larger busy rid, no
//           sort), then its queues function-major (thread 0); then the
//           node's slots, queues, |K^j| and COLD counts and FaasCache's
//           clock start afresh (the estimators survive). NODE_UP re-arms
//           the park FIFO. A REROUTE event sends the park head through
//           the router while a node is up; routers skip down nodes and a
//           pick of a down node goes to the lowest-id up node. An arrival
//           while every node is down parks, and so does a landing on a
//           node that went down in flight. Such a lane folds a
//           completion at its EXEC_DONE, from the raw arrival; under
//           delay a re-routed orphan is stamped at its re-send, so that
//           it pays its new node's delay then
//   resil   (a launch flag, Params::resil: failure injection, timeouts,
//           retries, shedding; src/repro/cluster/engine.py
//           ClusterResilCtx, :329) a dispatch counts an attempt (att, L x
//           N in global memory); at EXEC_DONE the attempt succeeds iff
//           att > n_fail (the planned outcome rows rs_nfail, rs_tmo,
//           rs_key), and only a success counts done and node_done, folds
//           and (exact mode) records its completion; a failure exhausts
//           the budget or joins the lane's retry FIFO (chained on nxt,
//           eligible rt_t = t + backoff, the power of two an integer
//           shift, the jitter mix32 of (key << 4 | att - 1)), whose head
//           is a RETRY event after the toggles, routed like an arrival
//           (parked while every node is down); its successor fires no
//           earlier than it. A push onto a full queue counts ovf, sheds
//           the arrival, or sheds the queue's head (shed_mode 0, 1, 2).
//           The lane ends when every request is terminal (done,
//           exhausted or shed), folds at EXEC_DONE from the raw arrival
//           (as churn: `direct`), and a drained attempt is given back.
//           The FIFO's scalars and the tallies are in static shared
//           memory (Resil), touched by thread 0
//   breaker (a lane whose router code has kBreakerBit) each node keeps a
//           tumbling window of completed attempts and failures and a
//           reopen time (node table), updated at its EXEC_DONE; the
//           router skips tripped nodes unless every up node is tripped
// The single-node form (Lane<P, false>) has none of churn, delay or
// resilience: the engine runs a resilient single node as a K = 1 lane of
// this variant. The slots of a lane (K*C <= Params::slot_cap) and the node
// table live in shared memory; the per-(node, function) state beside them when it fits,
// else in global scratch. The node table caches the landing time of each
// in-flight head and each node's next toggle. `node_done` counts
// completions a node; in exact mode with a delay and without churn,
// `node_of` records each request's node; `churn_counts` a lane's toggles
// and re-routes.
//
// The trace rail (telemetry; src/repro/core/jax_engine.py :1432-1478 and
// src/repro/cluster/engine.py :1278-1345) is a compile-time flag,
// K0_TRACED, set by the traced units (csrc/event_loop_traced.cu, the
// single-node form; csrc/event_loop_cluster_traced_*.cu, the K-node form),
// so that the untraced forms compile as they did. A traced lane writes one
// record a processed event, at row tr_off[lane] + iters - 1 of the record
// buffers (tr_i: kind, rid, fn, node, aux, qlen, busy, warm, seq as
// int32; tr_f: time and execution time as f64; 52 B), while it fits below
// tr_off[lane + 1]: the wrapper launches with a capacity a lane and again
// with exact counts (the lane's iters) when a lane had more. TR_AUX comes
// from the change of the counters over the event (cold starts, overflows,
// sheds, failures, timeouts, exhaustions) and of the event node's queue
// total; busy and warm are a warp reduction over the event node's slots,
// qlen its queue total (the single-node form keeps the lane's in a
// register).
// Thread 0 writes the record after the event's fold. A park (every node
// down) is recorded on node 0, the node the reference's router falls back
// to; tr_no_node writes node -1 (the single-node engine's K = 1 lanes).
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

#ifdef K0_TRACED
constexpr bool kTraced = true;
#else
constexpr bool kTraced = false;
#endif
// the trace rail's event kinds (repro_torch/telemetry/rail.py TraceKind)
// and record widths
enum { TK_ARRIVAL, TK_EXEC, TK_COLD, TK_TIMER, TK_RETRY, TK_NODE_ARRIVAL,
       TK_REROUTE, TK_CHURN };
constexpr int kTrI = 9, kTrF = 2;

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
  // the K-node variant: a lane's t_cold and t_evict rows (16 B a
  // function), and a node's per-function state (est_sum, q_tail_rid,
  // q_head_rid; q_len, est_n, K; the COLD count; the timer chain's
  // tmr_next, rearm_t, rearm_rid, tmr_rid, la_rid and tmr_seq, arr_cnt)
  static constexpr int node_fn_bytes =
      3 * 8 + 3 * 4 + (cold_aware ? 4 : 0) + (timers ? 5 * 8 + 2 * 4 : 0);
};
// a node of the K-node variant: gn, g_sum, FaasCache's clock, the delay,
// the landing time of its in-flight head, its next toggle, the breaker's
// reopen time; q_tot, the in-flight head, tail and length, node_done, the
// toggle cursor, the breaker's window of attempts and failures
constexpr int kNodeBytes = 7 * 8 + 8 * 4;
constexpr int kLaneFnBytes = 2 * 8;
constexpr int kMaxJsqD = 8;   // JSQ(d) on the card: d <= 8
constexpr int kBreakerBit = 4;  // a router code's circuit-breaker flag
// the columns of the resilience layer's (L, N_RS) counts
enum { R_FAILED, R_TMO, R_RETRIED, R_SHED, R_EXH, R_TRIPS, N_RS };

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
// the K-node variant's bytes a (node, function), as the wrapper's
// CLUSTER_FN_BYTES has them
static_assert(EsffP::node_fn_bytes == 36 && EsffHP::node_fn_bytes == 40 &&
                  FaasP::node_fn_bytes == 36 && Owv2P::node_fn_bytes == 84,
              "node_fn_bytes");

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
  // the K-node variant (null in the single-node one); cap_mask is then
  // (L, kmax, n_slots)
  const int64_t* topo;       // (L, 5): K, C, router code, JSQ's d, seed
  const double* delays;      // (L, kmax)
  int kmax;
  int slot_cap;              // the slots one block holds: max K * C
  int32_t* links;            // (L, 3, N): nxt, tnx, dnx
  int32_t* node_done;        // (L, kmax)
  int32_t* node_of;          // (L, N) or null
  // churn and time-varying delay: null (and 0 columns) when no lane has
  // them; a lane with none has all-BIG toggles and one step a node
  const double* churn_t;     // (L, kmax, n_toggle_cols) toggle times
  int n_toggle_cols;
  const double* dtimes;      // (L, kmax, n_steps) step times, BIG-padded
  const double* dvals;       // (L, kmax, n_steps) step values
  const double* dper;        // (L, kmax) periods (0: not periodic)
  int n_steps;
  double* land_t;            // (L, N) landing times, or null
  int64_t* churn_counts;     // (L, 2): toggles, re-routes
  // the resilience layer (resil 0: off, every pointer null); the planned
  // outcomes and the jitter keys are (T, N) rows, as the trace
  int resil;
  const int32_t* rs_nfail;   // (T, N) leading failed attempts
  const uint8_t* rs_tmo;     // (T, N) the failures are timeouts
  const int32_t* rs_key;     // (T, N) original request ids
  int32_t* att;              // (L, N) attempts started, zeroed
  double* rt_t;              // (L, N) retry eligibility times
  int max_att, shed_mode;
  double rt_base, rt_cap, rt_jit;
  unsigned rt_seed;          // (fail_seed ^ JITTER_SALT) mod 2^32
  const double* brk;         // (L, 3) volume, trip point, cooldown, or null
  int64_t* resil_counts;     // (L, N_RS)
  // the trace rail (the traced units only): lane l's records at rows
  // [tr_off[l], tr_off[l + 1]) of tr_i (R, kTrI) and tr_f (R, kTrF), and
  // whether a record's node is -1 (the K-node form's K = 1 lanes of the
  // single-node engine)
  int32_t* tr_i;
  double* tr_f;
  const int64_t* tr_off;
  int tr_no_node;
};

// The lane's tallies that change at most once an event and are read only
// at its end: kept in shared memory, and touched by thread 0 alone, so
// that they take no registers from the event loop (thread 0 also writes
// the slot's creation sequence from `seq`). Every sum is still taken in
// event order.
struct Tally {
  long long seq, cold, evict, ovf, scans, head_scans, timers, toggles,
      reroutes;
  double cold_t, evict_t;
};
__shared__ Tally tally;

// The resilience layer's lane state (the K-node variant only, so that the
// single-node form's shared memory is unchanged): the retry FIFO's head,
// tail, length and head fire time, the terminal requests (done, exhausted
// or shed) and the counts of N_RS; thread 0 writes them.
struct Resil {
  long long term, n[N_RS];
  double r_fire;
  int r_head, r_tail, r_len;
};
__shared__ Resil rs;

// used: only the variants with P::slot_used; prio, freq: FaasCache's
struct Slots {
  long long *fn, *req, *seq;
  double *ready, *used, *prio;
  int *state, *cap, *freq;
};

// coldk: ESFF-H's; tmr_*, rearm_*, arr_cnt: OpenWhisk-v2's; in the K-node
// variant q_tail_rid takes q_head_pos's place and tmr_pos counts the
// consumed entries of the timer chain, whose head is tmr_rid and whose
// last arrival is la_rid
struct Fns {
  double *est_sum, *t_cold, *t_evict, *tmr_next, *rearm_t;
  long long *q_head_pos, *q_tail_rid, *q_head_rid, *rearm_rid, *tmr_rid,
      *la_rid;
  int *q_len, *est_n, *k, *coldk, *tmr_pos, *arr_cnt;
};

// The node table of the K-node variant (gd: FaasCache's clock; land: the
// in-flight head's landing time; ch_t: the next toggle, at cursor ch_ix).
struct Nodes {
  long long* gn;
  double *g_sum, *gd, *delay, *land, *ch_t, *cbr_until;
  int *q_tot, *pend_head, *pend_tail, *pend_len, *done, *ch_ix, *cbr_n,
      *cbr_f;
};

// murmur3's 32-bit finaliser over x ^ (seed * golden ratio), as
// repro_torch.cluster.routers.mix32_py
__device__ __forceinline__ unsigned mix32(unsigned x, unsigned seed) {
  unsigned h = x ^ (seed * 0x9E3779B9u);
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

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

// The lane's event loop under policy P, on one node or (CL) on a cluster
// of K; one object a warp, every member warp-uniform.
template <class P, bool CL>
struct Lane {
  const Params& p;
  const int t;              // this thread's index in the warp
  const int lane, N, F;
  const int C;              // slots a node (CL: this lane's)
  const int Q;
  const int NL;             // the live prefix: N unless n_live is given
  const int64_t* fn_id;
  const double* arrival;
  const double* exec;
  const int64_t* pos_rids;
  const int64_t* pos_off;
  const double beta;
  const int K;              // nodes (1 on the single-node topology)
  Slots sl;                 // the event node's slots (CL: a view of sl_all)
  Fns fs;                   // the event node's functions (CL: of fs_all)
  // the K-node variant: every node's slots and functions, the node table,
  // the link rails, the event's node and whether the lane has a delay
  Slots sl_all;
  Fns fs_all;
  Nodes nd;
  int32_t *nxt = nullptr, *tnx = nullptr, *dnx = nullptr;
  int node = 0;
  bool has_delay = false;
  bool var = false;         // a node's delay follows a schedule
  bool churn = false;       // some node toggles
  bool direct = false;      // churn or resilience: fold at EXEC_DONE
  bool shift = false;       // responses from the node-local arrival
  double delay_k = 0.0;     // the event node's delay (CL, has_delay)
  // churn: the park FIFO (head, tail, length, the head's eligibility) and
  // the nodes up
  int park_head = -1, park_tail = -1, park_len = 0, n_up = 0;
  double park_t = kBig;
  long long max_iters = 0;  // the stall bound
  long long next = 0, done = 0, iters = 0, stall = 0, gn = 0;
  double g_sum = 0.0, r_sum = 0.0, s_sum = 0.0, r_max = 0.0;
  double gd_clock = 0.0;    // FaasCache's GREEDY-DUAL clock
  long long ev_rid = -1;    // the event's dispatch, folded at its end
  double ev_comp = 0.0, ev_exec = 0.0;
  int h_lo = 0, h_hi = 0;   // histogram bins t and t + 32
  int tr_q0 = 0;            // traced: the event node's queue total before
  int tr_q = 0;             // traced, one node: the lane's queue total

  __device__ Lane(const Params& p_, unsigned char* smem)
      : p(p_), t(threadIdx.x), lane(blockIdx.x), N(p_.n_req),
        F(p_.n_fns),
        C(CL ? static_cast<int>(p_.topo[blockIdx.x * 5 + 1]) : p_.n_slots),
        Q(p_.queue_cap),
        NL(p_.n_live != nullptr ? static_cast<int>(p_.n_live[blockIdx.x])
                                : p_.n_req),
        fn_id(p_.fn_id + p_.trace_ix[blockIdx.x] * p_.n_req),
        arrival(p_.arrival + p_.trace_ix[blockIdx.x] * p_.n_req),
        exec(p_.exec_time + p_.trace_ix[blockIdx.x] * p_.n_req),
        pos_rids(p_.pos_rids + p_.trace_ix[blockIdx.x] * p_.n_req),
        pos_off(p_.pos_off + p_.trace_ix[blockIdx.x] * (p_.n_fns + 1)),
        beta(p_.beta[blockIdx.x]),
        K(CL ? static_cast<int>(p_.topo[blockIdx.x * 5]) : 1) {
    // slots, K * C of them: the 8-byte arrays, then the 4-byte ones
    const int S = K * C;
    unsigned char* b = smem;
    sl.fn = reinterpret_cast<long long*>(b); b += 8 * S;
    sl.req = reinterpret_cast<long long*>(b); b += 8 * S;
    sl.seq = reinterpret_cast<long long*>(b); b += 8 * S;
    sl.ready = reinterpret_cast<double*>(b); b += 8 * S;
    if constexpr (P::slot_used) {
      sl.used = reinterpret_cast<double*>(b); b += 8 * S;
    }
    if constexpr (P::faas) {
      sl.prio = reinterpret_cast<double*>(b); b += 8 * S;
    }
    sl.state = reinterpret_cast<int*>(b); b += 4 * S;
    sl.cap = reinterpret_cast<int*>(b); b += 4 * S;
    if constexpr (P::faas) sl.freq = reinterpret_cast<int*>(b);
    // CL: the node table after the block's slot region
    const long long slots_end =
        slot_region(P::slot_bytes, CL ? p.slot_cap : C);
    if constexpr (CL) {
      b = smem + slots_end;
      nd.gn = reinterpret_cast<long long*>(b); b += 8 * p.kmax;
      nd.g_sum = reinterpret_cast<double*>(b); b += 8 * p.kmax;
      nd.gd = reinterpret_cast<double*>(b); b += 8 * p.kmax;
      nd.delay = reinterpret_cast<double*>(b); b += 8 * p.kmax;
      nd.land = reinterpret_cast<double*>(b); b += 8 * p.kmax;
      nd.ch_t = reinterpret_cast<double*>(b); b += 8 * p.kmax;
      nd.cbr_until = reinterpret_cast<double*>(b); b += 8 * p.kmax;
      nd.q_tot = reinterpret_cast<int*>(b); b += 4 * p.kmax;
      nd.pend_head = reinterpret_cast<int*>(b); b += 4 * p.kmax;
      nd.pend_tail = reinterpret_cast<int*>(b); b += 4 * p.kmax;
      nd.pend_len = reinterpret_cast<int*>(b); b += 4 * p.kmax;
      nd.done = reinterpret_cast<int*>(b); b += 4 * p.kmax;
      nd.ch_ix = reinterpret_cast<int*>(b); b += 4 * p.kmax;
      nd.cbr_n = reinterpret_cast<int*>(b); b += 4 * p.kmax;
      nd.cbr_f = reinterpret_cast<int*>(b);
      int32_t* lk = p.links + static_cast<long long>(lane) * 3 * N;
      nxt = lk;
      tnx = lk + N;
      dnx = lk + 2 * static_cast<long long>(N);
    }
    // functions: in shared memory after the slots (and the node table),
    // or in global scratch; CL: the lane's t_cold and t_evict rows, then
    // the K * F per-(node, function) arrays
    b = p.fn_in_shared
            ? smem + slots_end +
                  (CL ? (static_cast<long long>(kNodeBytes) * p.kmax + 7) /
                            8 * 8
                      : 0)
            : p.scratch + lane * p.fn_stride;
    const int KF = K * F;
    if constexpr (CL) {
      fs.t_cold = reinterpret_cast<double*>(b); b += 8 * F;
      fs.t_evict = reinterpret_cast<double*>(b); b += 8 * F;
      fs.est_sum = reinterpret_cast<double*>(b); b += 8 * KF;
      fs.q_tail_rid = reinterpret_cast<long long*>(b); b += 8 * KF;
    } else {
      fs.est_sum = reinterpret_cast<double*>(b); b += 8 * F;
      fs.t_cold = reinterpret_cast<double*>(b); b += 8 * F;
      fs.t_evict = reinterpret_cast<double*>(b); b += 8 * F;
      fs.q_head_pos = reinterpret_cast<long long*>(b); b += 8 * F;
    }
    fs.q_head_rid = reinterpret_cast<long long*>(b); b += 8 * KF;
    if constexpr (P::timers) {
      fs.tmr_next = reinterpret_cast<double*>(b); b += 8 * KF;
      fs.rearm_t = reinterpret_cast<double*>(b); b += 8 * KF;
      fs.rearm_rid = reinterpret_cast<long long*>(b); b += 8 * KF;
      if constexpr (CL) {
        fs.tmr_rid = reinterpret_cast<long long*>(b); b += 8 * KF;
        fs.la_rid = reinterpret_cast<long long*>(b); b += 8 * KF;
      }
    }
    fs.q_len = reinterpret_cast<int*>(b); b += 4 * KF;
    fs.est_n = reinterpret_cast<int*>(b); b += 4 * KF;
    fs.k = reinterpret_cast<int*>(b);
    if constexpr (P::cold_aware) {
      b += 4 * KF;
      fs.coldk = reinterpret_cast<int*>(b);
    }
    if constexpr (P::timers) {
      b += 4 * KF;
      fs.tmr_pos = reinterpret_cast<int*>(b); b += 4 * KF;
      fs.arr_cnt = reinterpret_cast<int*>(b);
    }
    sl_all = sl;
    fs_all = fs;
  }

  __device__ void init() {
    const long long tix = p.trace_ix[lane];
    if (t == 0) tally = Tally{0, 0, 0, 0, 0, 0, 0, 0, 0, 0.0, 0.0};
    for (int i = t; i < K * C; i += 32) {
      sl.fn[i] = -1;
      sl.req[i] = -1;
      sl.seq[i] = kI32Max;
      sl.ready[i] = kBig;
      sl.state[i] = kIdle;
      // cap_mask is (L, C) on one node, (L, kmax, n_slots) on K
      const long long at =
          CL ? (static_cast<long long>(lane) * p.kmax + i / C) * p.n_slots +
                   i % C
             : static_cast<long long>(lane) * C + i;
      sl.cap[i] = p.cap_mask[at] != 0;
      if constexpr (P::slot_used) sl.used[i] = 0.0;
      if constexpr (P::faas) {
        sl.prio[i] = 0.0;
        sl.freq[i] = 0;
      }
    }
    for (int f = t; f < F; f += 32) {
      fs.t_cold[f] = p.t_cold[tix * F + f];
      fs.t_evict[f] = p.t_evict[tix * F + f];
      if constexpr (!CL) fs.q_head_pos[f] = 0;
    }
    for (int i = t; i < K * F; i += 32) {
      fs.est_sum[i] = 0.0;
      fs.q_head_rid[i] = -1;
      if constexpr (CL) fs.q_tail_rid[i] = -1;
      fs.q_len[i] = 0;
      fs.est_n[i] = 0;
      fs.k[i] = 0;
      if constexpr (P::cold_aware) fs.coldk[i] = 0;
      if constexpr (P::timers) {
        fs.tmr_next[i] = kBig;
        fs.rearm_t[i] = kBig;
        fs.rearm_rid[i] = -1;
        fs.tmr_pos[i] = 0;
        fs.arr_cnt[i] = 0;
        if constexpr (CL) {
          fs.tmr_rid[i] = -1;
          fs.la_rid[i] = -1;
        }
      }
    }
    if constexpr (CL) {
      bool delayed = false, varied = false, toggles = false;
      int width = 0;  // the lane's most toggles a node
      for (int k = t; k < K; k += 32) {
        const long long nk = static_cast<long long>(lane) * p.kmax + k;
        nd.gn[k] = 0;
        nd.g_sum[k] = 0.0;
        nd.gd[k] = 0.0;
        nd.delay[k] = p.delays[nk];
        delayed |= nd.delay[k] > 0.0;
        varied |= p.n_steps > 1 && p.dtimes[nk * p.n_steps + 1] < kBig;
        nd.land[k] = kBig;
        nd.ch_t[k] = kBig;
        if (p.n_toggle_cols > 0) {
          const double* row = p.churn_t + nk * p.n_toggle_cols;
          nd.ch_t[k] = row[0];
          int n = 0;
          for (int e = 0; e < p.n_toggle_cols; ++e) n += row[e] < kBig;
          toggles |= n > 0;
          width = max(width, n);
        }
        nd.q_tot[k] = 0;
        nd.pend_head[k] = -1;
        nd.pend_tail[k] = -1;
        nd.pend_len[k] = 0;
        nd.done[k] = 0;
        nd.ch_ix[k] = 0;
        nd.cbr_until[k] = 0.0;
        nd.cbr_n[k] = 0;
        nd.cbr_f[k] = 0;
      }
      if (t == 0) {
        rs.term = 0;
        for (int i = 0; i < N_RS; ++i) rs.n[i] = 0;
        rs.r_fire = kBig;
        rs.r_head = -1;
        rs.r_tail = -1;
        rs.r_len = 0;
      }
      var = __any_sync(kAll, varied);
      has_delay = __any_sync(kAll, delayed) || var;
      churn = __any_sync(kAll, toggles);
      direct = churn || p.resil != 0;
      shift = has_delay && !direct;
      n_up = K;
      // the JAX package's stall guard: + (4 N + 64) K E under churn, E
      // its toggle columns (the most toggles of a node + 1), times the
      // attempts a request may take under resilience
      width = __reduce_max_sync(kAll, width);
      max_iters = p.max_iters +
                  (churn ? (4LL * N + 64) * K * (width + 1) : 0LL);
      if (p.resil) max_iters *= p.max_att;
    } else {
      max_iters = p.max_iters;
    }
    __syncwarp();
  }

  // ------------------------------------------------- the event's node
  // Point the views at node k (slots k*C.., functions k*F..) and load its
  // estimator globals, FaasCache's clock and its delay.
  __device__ __forceinline__ void enter_node(int k) {
    node = k;
    const int s0 = k * C;
    sl.fn = sl_all.fn + s0;
    sl.req = sl_all.req + s0;
    sl.seq = sl_all.seq + s0;
    sl.ready = sl_all.ready + s0;
    if constexpr (P::slot_used) sl.used = sl_all.used + s0;
    if constexpr (P::faas) {
      sl.prio = sl_all.prio + s0;
      sl.freq = sl_all.freq + s0;
    }
    sl.state = sl_all.state + s0;
    sl.cap = sl_all.cap + s0;
    const int f0 = k * F;
    fs.est_sum = fs_all.est_sum + f0;
    fs.q_tail_rid = fs_all.q_tail_rid + f0;
    fs.q_head_rid = fs_all.q_head_rid + f0;
    fs.q_len = fs_all.q_len + f0;
    fs.est_n = fs_all.est_n + f0;
    fs.k = fs_all.k + f0;
    if constexpr (P::cold_aware) fs.coldk = fs_all.coldk + f0;
    if constexpr (P::timers) {
      fs.tmr_next = fs_all.tmr_next + f0;
      fs.rearm_t = fs_all.rearm_t + f0;
      fs.rearm_rid = fs_all.rearm_rid + f0;
      fs.tmr_rid = fs_all.tmr_rid + f0;
      fs.la_rid = fs_all.la_rid + f0;
      fs.tmr_pos = fs_all.tmr_pos + f0;
      fs.arr_cnt = fs_all.arr_cnt + f0;
    }
    gn = nd.gn[k];
    g_sum = nd.g_sum[k];
    if constexpr (P::faas) gd_clock = nd.gd[k];
    delay_k = nd.delay[k];
    if constexpr (kTraced) tr_q0 = nd.q_tot[k];
  }

  // Store the event node's estimator globals and clock back.
  __device__ __forceinline__ void leave_node() {
    __syncwarp();
    if (t == 0) {
      nd.gn[node] = gn;
      nd.g_sum[node] = g_sum;
      if constexpr (P::faas) nd.gd[node] = gd_clock;
    }
    __syncwarp();
  }

  // Node k's delay at time tm: its schedule's value on a lane with one
  // (the last step at or before tm, tm taken modulo a positive period, as
  // repro.cluster.engine._sched_delay counts it), its constant otherwise.
  __device__ double delay_at(int k, double tm) const {
    if (!var) return nd.delay[k];
    const long long nk = static_cast<long long>(lane) * p.kmax + k;
    const double per = p.dper[nk];
    const double tt = per > 0.0 ? fmod(tm, per) : tm;
    const double* dt = p.dtimes + nk * p.n_steps;
    int n = 0;
    for (int i = 0; i < p.n_steps; ++i) n += tt >= dt[i];
    const int ix = n < 1 ? 0 : (n > p.n_steps ? p.n_steps - 1 : n - 1);
    return p.dvals[nk * p.n_steps + ix];
  }

  // The node-local arrival of rid: + the event node's delay at the arrival
  // on a lane with one and without churn (CL), the trace's arrival
  // otherwise (a churn lane measures from it).
  __device__ __forceinline__ double arrival_at(long long rid) const {
    const double a = arrival[rc(rid)];
    if constexpr (CL) {
      if (!shift) return a;
      return a + (var ? delay_at(node, a) : delay_k);
    }
    return a;
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
        if (!CL || !p.resil) p.completion[at] = comp;  // resil: on success
        if constexpr (CL) {
          if (p.node_of != nullptr && !direct) p.node_of[at] = node;
        }
      }
      if constexpr (CL) {
        if (p.resil && rid >= 0 && rid < N)
          p.att[static_cast<long long>(lane) * N + rid] += 1;
      }
    }
    __syncwarp();
    if (CL && direct) return;  // churn and resil fold the completion
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
  // Consume the head of fn's queue and return its rid; the head moves to
  // the successor: the next position of fn's arrivals (garbage when the
  // queue empties), or (CL) the head's link on the rail (-1 then).
  __device__ long long q_pop(long long fn) {
    const int f = fc(fn);
    const long long rid = fs.q_head_rid[f];
    long long succ;
    if constexpr (CL) {
      succ = fs.q_len[f] > 1 ? nxt[rc(rid)] : -1;
    } else {
      const long long gi = pos_off[f] + (fs.q_head_pos[f] + 1);
      succ = pos_rids[clampll(gi, 0, N - 1)];
    }
    __syncwarp();
    if (t == 0) {
      if (fn_ok(fn)) {
        fs.q_head_rid[fn] = succ;
        if constexpr (!CL) fs.q_head_pos[fn] += 1;
        fs.q_len[fn] -= 1;
      }
      if constexpr (CL) nd.q_tot[node] -= 1;
    }
    if constexpr (kTraced && !CL) tr_q -= fn_ok(fn);
    __syncwarp();
    return rid;
  }

  // Append rid (the next arrival position of fn; CL: linked from the
  // tail); a push onto a full backlog is dropped and counted in ovf, or
  // (CL, resil) by the shed mode: shed the arrival (1), or shed the
  // queue's head and admit the arrival (2). Returns whether it pushed.
  __device__ bool q_push(long long fn, long long rid) {
    const int q0 = fs.q_len[fc(fn)];
    const int mode = CL ? p.shed_mode : 0;
    if (q0 >= Q && mode != 2) {
      if (t == 0) {
        if constexpr (CL) {
          if (mode == 1) {
            rs.n[R_SHED] += 1;
            rs.term += 1;
          } else {
            tally.ovf += 1;
          }
        } else {
          tally.ovf += 1;
        }
      }
      return false;
    }
    __syncwarp();
    if (t == 0) {
      int q1 = q0;  // the length before the push
      if constexpr (CL) {
        if (q0 >= Q) {  // shed_oldest: the head leaves, terminal
          const long long hsucc = nxt[rc(fs.q_head_rid[fc(fn)])];
          if (fn_ok(fn)) {
            fs.q_head_rid[fn] = hsucc;
            q1 = q0 - 1;
          }
          nd.q_tot[node] -= 1;
          rs.n[R_SHED] += 1;
          rs.term += 1;
        }
      }
      if (fn_ok(fn)) {
        if (q1 == 0)
          fs.q_head_rid[fn] = rid;
        else if constexpr (CL)
          nxt[rc(fs.q_tail_rid[fn])] = static_cast<int32_t>(rid);
        if constexpr (CL) fs.q_tail_rid[fn] = rid;
        fs.q_len[fn] = q1 + 1;
      }
      if constexpr (CL) nd.q_tot[node] += 1;
    }
    if constexpr (kTraced && !CL) tr_q += fn_ok(fn);
    __syncwarp();
    return true;
  }

  // A directly dispatched arrival of fn: its (empty-queue) position is
  // consumed; on the link rail (CL) it never enters the chain.
  __device__ __forceinline__ void consume_direct(long long fn) {
    if constexpr (!CL) {
      if (t == 0 && fn_ok(fn)) fs.q_head_pos[fn] += 1;
      __syncwarp();
    }
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
      consume_direct(j);
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
      consume_direct(j);
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
      consume_direct(j);
    } else {
      pushed = q_push(j, rid);
    }
    if (fs.tmr_pos[jc] == fs.arr_cnt[jc] - 1) {
      __syncwarp();
      if (t == 0 && fn_ok(j)) {
        if (pushed) {
          fs.tmr_next[j] = tm + p.threshold;
          if constexpr (CL) fs.tmr_rid[j] = rid;  // the chain's head
        } else {
          fs.tmr_pos[j] += 1;
        }
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
    const double resp = ev_comp - arrival_at(ev_rid);
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
      int tb = static_cast<int>(arrival_at(ev_rid) / p.tl_bucket);
      tb = tb < 0 ? 0 : (tb > p.tl_bins - 1 ? p.tl_bins - 1 : tb);
      const long long at = static_cast<long long>(lane) * p.tl_bins + tb;
      p.tl_cnt[at] += 1;
      p.tl_resp[at] = p.tl_resp[at] + resp;
      p.tl_exec[at] = p.tl_exec[at] + ev_exec;
    }
  }

  // The timer event of function f (an original timer, or a re-arm):
  // consume it, then the hook.
  __device__ void timer_event(bool orig, int f, double tm) {
    long long rid;
    if (orig) {
      // the next original timer of f: the arrival at position tmr_pos (CL:
      // the chain's head); the rail moves on to its successor, if it has
      // arrived
      const long long p_o = fs.tmr_pos[f];
      long long succ;
      if constexpr (CL) {
        rid = fs.tmr_rid[f];
        succ = tnx[rc(rid)];
      } else {
        const long long base = pos_off[f];
        rid = pos_rids[clampll(base + p_o, 0, N - 1)];
        succ = pos_rids[clampll(base + (p_o + 1), 0, N - 1)];
      }
      const bool more = p_o + 1 < fs.arr_cnt[f];
      const double nxt_t = more ? arrival_at(succ) + p.threshold : kBig;
      __syncwarp();
      if (t == 0) {
        fs.tmr_pos[f] = static_cast<int>(p_o + 1);
        fs.tmr_next[f] = nxt_t;
        if constexpr (CL) fs.tmr_rid[f] = more ? succ : -1;
      }
      __syncwarp();
    } else {
      rid = fs.rearm_rid[f];
      __syncwarp();
      if (t == 0) fs.rearm_t[f] = kBig;
      __syncwarp();
    }
    if (t == 0) tally.timers += 1;
    owv2_timer(rid, tm);
  }

  // ---------------------------------------------------- the trace rail
  // An event's record, as the branch that handled it knows it: kind, rid,
  // the slot's function (a slot event; else the request's is read) and
  // the execution time (EXEC).
  struct TraceEv {
    int kind;
    long long rid, fn;
    double dt;
  };
  // What a record compares with after the event: the counters whose
  // change sets TR_AUX (read by thread 0, which writes them).
  struct TracePre {
    long long cold, ovf, shed, failed, tmo, exh;
  };

  __device__ __forceinline__ TracePre trace_pre() const {
    TracePre pre{tally.cold, tally.ovf, 0, 0, 0, 0};
    if constexpr (CL) {
      pre.shed = rs.n[R_SHED];
      pre.failed = rs.n[R_FAILED];
      pre.tmo = rs.n[R_TMO];
      pre.exh = rs.n[R_EXH];
    }
    return pre;
  }

  // The event node's queue total, on every thread: the node table's (CL),
  // else the lane's, kept by q_push and q_pop (the sum of q_len, as the
  // reference's q_len.sum()).
  __device__ __forceinline__ int queued_total() const {
    if constexpr (CL) {
      return nd.q_tot[node];
    } else {
      return tr_q;
    }
  }

  // The request of f's timer event (an original or a re-arm), read before
  // timer_event consumes it.
  __device__ __forceinline__ long long timer_rid(bool orig, int f) const {
    if (!orig) return fs.rearm_rid[f];
    if constexpr (CL) {
      return fs.tmr_rid[f];
    } else {
      return pos_rids[clampll(pos_off[f] + fs.tmr_pos[f], 0, N - 1)];
    }
  }

  // The event's record, after its fold: busy and warm over the event
  // node's usable slots (a warp reduction), its queue total, TR_AUX from
  // the counters against `pre` and the queue total against tr_q0; thread 0
  // writes it at row iters - 1 of the lane's window, if it fits.
  __device__ void record(const TraceEv& ev, double tm, const TracePre& pre) {
    __syncwarp();
    int busy = 0, warm = 0;
    for (int c = t; c < C; c += 32) {
      if (!sl.cap[c]) continue;
      const int st = sl.state[c];
      busy += st == kBusy;
      warm += st == kIdle && sl.fn[c] >= 0;
    }
    busy = __reduce_add_sync(kAll, busy);
    warm = __reduce_add_sync(kAll, warm);
    const int q = queued_total();
    if (t != 0) return;
    const long long at = p.tr_off[lane] + (iters - 1);
    if (at >= p.tr_off[lane + 1]) return;
    int aux = 0;
    if (ev.kind == TK_EXEC) {
      if constexpr (CL) {
        const bool tmo = rs.n[R_TMO] > pre.tmo;
        const bool fail = rs.n[R_FAILED] > pre.failed || tmo;
        aux = (rs.n[R_EXH] > pre.exh ? 2 : (fail ? 1 : 0)) + (tmo ? 4 : 0);
      }
    } else if (ev.kind == TK_CHURN) {
      aux = is_up(node) ? 1 : 0;
    } else {
      aux = (tally.cold > pre.cold ? 1 : 0) + (q > tr_q0 ? 2 : 0) +
            (tally.ovf > pre.ovf ? 8 : 0);
      if constexpr (CL) aux += rs.n[R_SHED] > pre.shed ? 4 : 0;
    }
    const bool slot_ev = ev.kind == TK_EXEC || ev.kind == TK_COLD;
    const long long fn =
        slot_ev ? ev.fn : (ev.rid >= 0 ? fn_id[rc(ev.rid)] : -1);
    int32_t* r = p.tr_i + at * kTrI;
    r[0] = ev.kind;
    r[1] = static_cast<int32_t>(ev.rid);
    r[2] = static_cast<int32_t>(fn);
    r[3] = CL && !p.tr_no_node ? node : -1;
    r[4] = aux;
    r[5] = q;
    r[6] = busy;
    r[7] = warm;
    r[8] = static_cast<int32_t>(iters);
    p.tr_f[at * kTrF] = tm;
    p.tr_f[at * kTrF + 1] = ev.dt;
  }

  // ------------------------------------------------------------- loop
  __device__ void run() {
    // the arrival's candidate index: after the slots (and the timers)
    const int n_arr = 2 * C + (P::timers ? 2 * F : 0);
    // the next arrival, loaded one event ahead
    double t_arr = N > 0 ? arrival[0] : kBig;
    long long fn_arr = N > 0 ? fn_id[0] : 0;
    while (done < NL && stall == 0) {
      [[maybe_unused]] TracePre pre;
      [[maybe_unused]] TraceEv tv{-1, -1, -1, 0.0};
      if constexpr (kTraced) {
        pre = trace_pre();
        tr_q0 = queued_total();
      }
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
        if constexpr (kTraced)
          tv = TraceEv{is_cold ? TK_COLD : TK_EXEC, rid_done, j_done,
                       is_cold ? 0.0 : e_done};
        on_slot(is_cold, slot, t_ev);
        iters += 1;
      } else if (P::timers && ei < n_arr) {
        iters += 1;
        const bool orig = ei < 2 * C + F;
        const int f = orig ? ei - 2 * C : ei - 2 * C - F;
        if constexpr (kTraced) tv = TraceEv{TK_TIMER, timer_rid(orig, f), -1};
        timer_event(orig, f, t_ev);
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
        if constexpr (kTraced) tv = TraceEv{TK_ARRIVAL, na, -1};
        on_arrival(na, j, ta);
      }
      fold();
      if constexpr (kTraced) record(tv, t_ev, pre);
      if (iters >= p.max_iters) stall = 2;
    }
  }

  // ------------------------------------------------- the K-node loop
  // Whether node k is up (always, on a lane without churn).
  __device__ __forceinline__ bool is_up(int k) const {
    return !churn || (nd.ch_ix[k] & 1) == 0;
  }

  // Whether the router may pick node k at tm: up and, on a breaker lane
  // (`open_only`), not tripped (cbr_until <= tm).
  __device__ __forceinline__ bool usable(int k, double tm,
                                         bool open_only) const {
    return is_up(k) && (!open_only || nd.cbr_until[k] <= tm);
  }

  // Queued plus busy usable slots of node k, on every thread (I32_MAX for
  // a node the router may not pick).
  __device__ __forceinline__ long long node_load(int k, bool ok) const {
    int b = 0;
    for (int c = t; c < C; c += 32) {
      const int i = k * C + c;
      b += sl_all.state[i] == kBusy && sl_all.cap[i];
    }
    const long long l =
        static_cast<long long>(nd.q_tot[k]) + __reduce_add_sync(kAll, b);
    return ok ? l : kI32Max;
  }

  // The router's node for the request rid of function j at time tm, on
  // the state before the event (every thread ends with the same node); a
  // down pick goes to the lowest-id up node (0 when none is up).
  __device__ int route(long long rid, long long j, double tm) {
    const int k = pick_node(rid, j, tm);
    if (!churn || is_up(k)) return k;
    int first = INT_MAX;
    for (int q = t; q < K; q += 32)
      if (is_up(q)) first = min(first, q);
    first = __reduce_min_sync(kAll, first);
    return first == INT_MAX ? 0 : first;
  }

  __device__ int pick_node(long long rid, long long j, double tm) {
    if (K == 1) return 0;
    const int code = static_cast<int>(p.topo[lane * 5 + 2]) & ~kBreakerBit;
    const long long seed = p.topo[lane * 5 + 4];
    // a breaker lane skips its tripped nodes, unless every up node is
    // tripped (it fails open)
    bool open_only = false;
    if (p.topo[lane * 5 + 2] & kBreakerBit) {
      bool any = false;
      for (int q = t; q < K; q += 32) any |= usable(q, tm, true);
      open_only = __any_sync(kAll, any);
    }
    if (code == 0) {
      // JSQ(d): the first min(d, K) positions of a partial Fisher-Yates
      // shuffle of the node ids; only the positions it touches are kept,
      // as (position, node) writes, the latest of a position winning
      const int d = min(static_cast<int>(p.topo[lane * 5 + 3]), K);
      int pos[2 * kMaxJsqD], val[2 * kMaxJsqD];
      int m = 0;
      auto at = [&](int x) {
        int v = x;
        for (int q = 0; q < m; ++q)
          if (pos[q] == x) v = val[q];
        return v;
      };
      for (int i = 0; i < d; ++i) {
        const unsigned h = mix32(static_cast<unsigned>(rid),
                                 static_cast<unsigned>(seed + i));
        const int jd = i + static_cast<int>(h % static_cast<unsigned>(K - i));
        const int ni = at(i), nj = at(jd);
        pos[m] = i;
        val[m++] = nj;
        pos[m] = jd;
        val[m++] = ni;
      }
      int best = at(0);
      long long bl = node_load(best, usable(best, tm, open_only));
      for (int i = 1; i < d; ++i) {  // strict <: ties keep the earliest draw
        const int c = at(i);
        const long long l = node_load(c, usable(c, tm, open_only));
        if (l < bl) {
          best = c;
          bl = l;
        }
      }
      return best;
    }
    // cold_aware (1) and slo_aware (2): the first node of least
    // startability score (+ its delay for slo_aware), in the reference's
    // order of operations
    const int jc = fc(j);
    double bw = INFINITY;
    int bi = INT_MAX;
    for (int k = t; k < K; k += 32) {
      bool idle = false;
      int busy = 0;
      for (int c = 0; c < C; ++c) {
        const int i = k * C + c;
        if (!sl_all.cap[i]) continue;
        const int st = sl_all.state[i];
        busy += st == kBusy;
        idle |= st == kIdle && sl_all.fn[i] == jc;
      }
      const long long gnk = nd.gn[k];
      const double gmean =
          gnk > 0 ? nd.g_sum[k] / frp::clamp_lo(static_cast<double>(gnk), 1.0)
                  : p.prior;
      const int kf = k * F + jc;
      const int n_j = fs_all.est_n[kf];
      const double mean_j =
          n_j > 0 ? fs_all.est_sum[kf] /
                        frp::clamp_lo(static_cast<double>(n_j), 1.0)
                  : gmean;
      double score =
          ((idle ? 0.0 : fs_all.t_cold[jc]) +
           mean_j * static_cast<double>(fs_all.q_len[kf])) +
          gmean * static_cast<double>(static_cast<long long>(nd.q_tot[k]) +
                                      busy);
      if (code == 2 && has_delay) score = score + delay_at(k, tm);
      frp::keep_first_min(bw, bi, usable(k, tm, open_only) ? score : kBig,
                          k);
    }
    frp::warp_first_min(bw, bi);
    return bi;
  }

  // A node arrival of rid (function j) at node-local time tm: the timer
  // chain of (node, j) (OpenWhisk-v2), then the policy's arrival hook.
  __device__ void node_arrival(long long rid, long long j, double tm) {
    if constexpr (P::timers) {
      __syncwarp();
      if (t == 0 && fn_ok(j)) {
        const long long prev = fs.la_rid[j];
        if (prev >= 0) tnx[rc(prev)] = static_cast<int32_t>(rid);
        fs.la_rid[j] = rid;
        fs.arr_cnt[j] += 1;
      }
      __syncwarp();
    }
    on_arrival(rid, j, tm);
  }

  // The landing time of rid in flight: stamped at its send.
  __device__ __forceinline__ double landing(long long rid) const {
    return p.land_t[static_cast<long long>(lane) * N + rc(rid)];
  }

  // Send rid to node k at time tm: it joins k's in-flight FIFO and lands
  // at tm + k's delay then (a raw arrival's tm is its arrival).
  __device__ void send(int k, long long rid, double tm) {
    const double land = tm + delay_at(k, tm);
    __syncwarp();
    if (t == 0) {
      p.land_t[static_cast<long long>(lane) * N + rid] = land;
      if (nd.pend_len[k] == 0) {
        nd.pend_head[k] = static_cast<int>(rid);
        nd.land[k] = land;
      } else {
        dnx[nd.pend_tail[k]] = static_cast<int32_t>(rid);
      }
      nd.pend_tail[k] = static_cast<int>(rid);
      nd.pend_len[k] += 1;
    }
    __syncwarp();
  }

  // Append rid to the lane's park FIFO; an empty one becomes eligible at
  // tm.
  __device__ void park(long long rid, double tm) {
    __syncwarp();
    if (t == 0 && park_len > 0) nxt[park_tail] = static_cast<int32_t>(rid);
    __syncwarp();
    if (park_len == 0) {
      park_head = static_cast<int>(rid);
      park_t = tm;
    }
    park_tail = static_cast<int>(rid);
    park_len += 1;
  }

  // NODE_DOWN on the event node at tm: its busy slots' requests, by
  // ascending rid, then its queues function-major, become the park FIFO
  // (empty now: the node was up, so every parked request re-routed
  // first), eligible at tm; then its slots, queues, the counts |K^j| and
  // COLD and FaasCache's clock start afresh. Its estimators survive.
  __device__ void drain(double tm) {
    // each busy rid links to the next larger one: no sort
    int nb = 0, lo = INT_MAX, hi = -1;
    for (int c = t; c < C; c += 32) {
      if (!(sl.state[c] == kBusy && sl.cap[c])) continue;
      const int r = static_cast<int>(sl.req[c]);
      ++nb;
      lo = min(lo, r);
      hi = max(hi, r);
      // a drained attempt never completes: it gives its attempt back
      if (p.resil) p.att[static_cast<long long>(lane) * N + r] -= 1;
      int succ = INT_MAX;
      for (int c2 = 0; c2 < C; ++c2) {
        const int r2 = static_cast<int>(sl.req[c2]);
        if (sl.state[c2] == kBusy && sl.cap[c2] && r2 > r && r2 < succ)
          succ = r2;
      }
      if (succ != INT_MAX) nxt[r] = succ;
    }
    nb = __reduce_add_sync(kAll, nb);
    lo = __reduce_min_sync(kAll, lo);
    hi = __reduce_max_sync(kAll, hi);
    // the queues: each non-empty one links from the tail of the last one
    // before it, else from the largest busy rid
    int head = nb > 0 ? lo : -1, tail = nb > 0 ? hi : -1;
    __syncwarp();
    if (t == 0) {
      for (int f = 0; f < F; ++f) {
        if (fs.q_len[f] <= 0) continue;
        if (tail >= 0)
          nxt[tail] = static_cast<int32_t>(fs.q_head_rid[f]);
        else
          head = static_cast<int>(fs.q_head_rid[f]);
        tail = static_cast<int>(fs.q_tail_rid[f]);
      }
    }
    head = __shfl_sync(kAll, head, 0);
    tail = __shfl_sync(kAll, tail, 0);
    const int n_drain = nb + nd.q_tot[node];
    if (n_drain > 0) {
      park_head = head;
      park_tail = tail;
      park_len = n_drain;
      park_t = tm;
    }
    __syncwarp();
    for (int c = t; c < C; c += 32) {
      sl.fn[c] = -1;
      sl.state[c] = kIdle;
      sl.ready[c] = kBig;
      sl.req[c] = -1;
      sl.seq[c] = kI32Max;
      if constexpr (P::slot_used) sl.used[c] = 0.0;
      if constexpr (P::faas) {
        sl.prio[c] = 0.0;
        sl.freq[c] = 0;
      }
    }
    for (int f = t; f < F; f += 32) {
      fs.q_len[f] = 0;
      fs.q_head_rid[f] = -1;
      fs.q_tail_rid[f] = -1;
      fs.k[f] = 0;
      if constexpr (P::cold_aware) fs.coldk[f] = 0;
    }
    if (t == 0) nd.q_tot[node] = 0;
    if constexpr (P::faas) gd_clock = 0.0;
    __syncwarp();
  }

  // The event node's toggle at tm: down (drain it) or up (the park FIFO
  // becomes eligible now).
  __device__ void toggle(double tm) {
    const int ci = nd.ch_ix[node];
    const bool was_up = (ci & 1) == 0;
    const long long nk = static_cast<long long>(lane) * p.kmax + node;
    const double next_t =
        p.churn_t[nk * p.n_toggle_cols + min(ci + 1, p.n_toggle_cols - 1)];
    __syncwarp();
    if (t == 0) {
      nd.ch_ix[node] = ci + 1;
      nd.ch_t[node] = next_t;
      tally.toggles += 1;
    }
    __syncwarp();
    n_up += was_up ? -1 : 1;
    if constexpr (!P::timers) {  // the runner keeps timers off churn
      if (was_up)
        drain(tm);
      else if (park_len > 0)
        park_t = tm;
    }
  }

  // Backoff after the failed attempt att of the request with original id
  // key: min(base * 2^(att - 1), cap) (an integer shift) times the jitter
  // factor 1 + jitter * (2u - 1), u = mix32 of (key << 4 | att - 1) / 2^32
  // (repro.core.resilience.backoff_jax).
  __device__ __forceinline__ double backoff(int att, long long key) const {
    const double x =
        p.rt_base * static_cast<double>(1LL << (att - 1));
    const double d = x < p.rt_cap ? x : p.rt_cap;
    const unsigned h = mix32((static_cast<unsigned>(key) << 4) |
                                 (static_cast<unsigned>(att - 1) & 15u),
                             p.rt_seed);
    const double u = static_cast<double>(h) / 4294967296.0;
    return d * (1.0 + p.rt_jit * (2.0 * u - 1.0));
  }

  // EXEC_DONE under resilience of rid's attempt on the event node at tm:
  // success iff its attempts exceed its planned failures; a failure
  // exhausts the budget or joins the retry FIFO. Thread 0 writes; returns
  // whether it succeeded.
  __device__ bool attempt_done(long long rid, double tm) {
    const long long at = static_cast<long long>(lane) * N + rc(rid);
    const long long row = (exec - p.exec_time) + rc(rid);  // its trace row
    const int att = p.att[at];
    const bool ok = att > p.rs_nfail[row];
    const bool exh = !ok && att >= p.max_att;
    const bool retry = !ok && !exh;
    const double elig = retry ? tm + backoff(att, p.rs_key[row]) : kBig;
    __syncwarp();
    if (t == 0) {
      rs.term += ok || exh;
      if (!ok) rs.n[p.rs_tmo[row] ? R_TMO : R_FAILED] += 1;
      rs.n[R_RETRIED] += retry;
      rs.n[R_EXH] += exh;
      if (ok && p.completion != nullptr) p.completion[at] = tm;
      if (retry) {
        p.rt_t[at] = elig;
        if (rs.r_len == 0) {
          rs.r_head = static_cast<int>(rid);
          rs.r_fire = elig;
        } else {
          nxt[rs.r_tail] = static_cast<int32_t>(rid);
        }
        rs.r_tail = static_cast<int>(rid);
        rs.r_len += 1;
      }
    }
    __syncwarp();
    return ok;
  }

  // The event node's circuit breaker at an EXEC_DONE at tm (thread 0):
  // closed (reopen time 0), the attempt joins the window, and a full
  // window trips it when its failures reach the trip point; half-open
  // (reopen time in (0, tm]), the attempt decides: success closes it,
  // failure trips it again; open, the completion is ignored.
  __device__ void breaker(double tm, bool fail) {
    if (t == 0) {
      const double* b = p.brk + 3 * static_cast<long long>(lane);
      const double until0 = nd.cbr_until[node];
      const bool half = until0 > 0.0 && until0 <= tm;
      const bool closed = until0 == 0.0;
      const int n1 = nd.cbr_n[node] + closed;
      const int f1 = nd.cbr_f[node] + (closed && fail);
      const bool boundary = closed && n1 >= b[0];
      const bool trip = (boundary && f1 >= b[1]) || (half && fail);
      nd.cbr_until[node] = trip ? tm + b[2] : (half ? 0.0 : until0);
      nd.cbr_n[node] = boundary || half ? 0 : n1;
      nd.cbr_f[node] = boundary || half ? 0 : f1;
      rs.n[R_TRIPS] += trip;
    }
  }

  // The retry FIFO's head re-enters at tm, routed now (parked while every
  // node is down); its successor fires no earlier than now.
  __device__ void retry_event(double tm) {
    const long long rid = rs.r_head;
    const int rlen0 = rs.r_len;
    const long long succ = nxt[rc(rid)];
    const double sf = p.rt_t[static_cast<long long>(lane) * N + rc(succ)];
    const double nfire = rlen0 > 1 ? (sf > tm ? sf : tm) : kBig;
    const long long j = fn_id[rc(rid)];
    const bool parks = churn && n_up == 0;
    const int k = parks ? 0 : route(rid, j, tm);
    __syncwarp();
    if (t == 0) {
      rs.r_head = static_cast<int>(succ);
      if (rlen0 <= 1) rs.r_tail = -1;
      rs.r_len = rlen0 - 1;
      rs.r_fire = nfire;
    }
    __syncwarp();
    if (parks) {
      if constexpr (kTraced) enter_node(0);  // recorded on node 0
      park(rid, tm);
    } else {
      enter_node(k);
      if (has_delay)
        send(k, rid, tm);
      else
        node_arrival(rid, j, tm);
    }
  }

  // Every request at its end: done, or under resilience terminal.
  __device__ __forceinline__ long long ended() const {
    return p.resil ? rs.term : done;
  }

  __device__ void run_cluster() {
    const int KC = K * C, KF = K * F;
    const int p0 = 2 * KC + (P::timers ? 2 * KF : 0);  // in-flight heads
    const int o0 = p0 + (has_delay ? K : 0);           // the park head
    const int c0 = o0 + (churn ? 1 : 0);               // the toggles
    const int r0 = c0 + (churn ? K : 0);               // the retry head
    const int n_arr = r0 + (p.resil ? 1 : 0);
    const bool brk = p.topo[lane * 5 + 2] & kBreakerBit;
    double t_arr = N > 0 ? arrival[0] : kBig;
    long long fn_arr = N > 0 ? fn_id[0] : 0;
    while (ended() < NL && stall == 0) {
      __syncwarp();  // the router reads what thread 0 wrote last event
      [[maybe_unused]] TracePre pre;
      [[maybe_unused]] TraceEv tv{-1, -1, -1, 0.0};
      if constexpr (kTraced) pre = trace_pre();
      double w = INFINITY;
      int ei = INT_MAX;
      for (int i = t; i < KC; i += 32) {
        const double r = sl_all.cap[i] ? sl_all.ready[i] : kBig;
        const int st = sl_all.state[i];
        frp::keep_first_min(w, ei, st == kBusy ? r : kBig, i);
        frp::keep_first_min(w, ei, st == kCold ? r : kBig, KC + i);
      }
      if constexpr (P::timers) {
        for (int i = t; i < KF; i += 32) {
          frp::keep_first_min(w, ei, fs_all.tmr_next[i], 2 * KC + i);
          frp::keep_first_min(w, ei, fs_all.rearm_t[i], 2 * KC + KF + i);
        }
      }
      if (has_delay) {
        for (int k = t; k < K; k += 32)
          frp::keep_first_min(w, ei, nd.pend_len[k] > 0 ? nd.land[k] : kBig,
                              p0 + k);
      }
      if (churn) {
        for (int k = t; k < K; k += 32)
          frp::keep_first_min(w, ei, nd.ch_t[k], c0 + k);
      }
      frp::warp_first_min(w, ei);
      if (churn)
        frp::keep_first_min(w, ei,
                            park_len > 0 && n_up > 0 ? park_t : kBig, o0);
      if (p.resil) frp::keep_first_min(w, ei, rs.r_fire, r0);
      const long long na = next;
      frp::keep_first_min(w, ei, na < NL ? t_arr : kBig, n_arr);
      if (!(w < kBig)) {
        stall = 1;
        break;
      }
      const double t_ev = w;
      ev_rid = -1;
      ev_comp = 0.0;
      ev_exec = 0.0;
      if (ei < 2 * KC) {
        // release, the node's estimator, then the policy hook
        const bool is_cold = ei >= KC;
        const int i = is_cold ? ei - KC : ei;
        enter_node(i / C);
        const int slot = i % C;
        const long long rid_done = sl.req[slot];
        const long long j_done = sl.fn[slot];
        const double e_done = exec[rc(rid_done)];
        // the attempt's outcome (always a success without resilience)
        const bool ok = is_cold || !p.resil || attempt_done(rid_done, t_ev);
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
          if (!is_cold && ok) nd.done[node] += 1;
        }
        if (!is_cold && brk) breaker(t_ev, !ok);
        __syncwarp();
        if (!is_cold) {
          g_sum = g_sum + e_done;
          gn += 1;
          if (ok) {
            done += 1;
            if (direct) {  // churn and resil fold the completion
              ev_rid = rid_done;
              ev_comp = t_ev;
              ev_exec = e_done;
            }
          }
        }
        if constexpr (kTraced)
          tv = TraceEv{is_cold ? TK_COLD : TK_EXEC, rid_done, j_done,
                       is_cold ? 0.0 : e_done};
        on_slot(is_cold, slot, t_ev);
        iters += 1;
      } else if (P::timers && ei < p0) {
        const bool orig = ei < 2 * KC + KF;
        const int kf = orig ? ei - 2 * KC : ei - 2 * KC - KF;
        enter_node(kf / F);
        iters += 1;
        if constexpr (kTraced)
          tv = TraceEv{TK_TIMER, timer_rid(orig, kf % F), -1};
        timer_event(orig, kf % F, t_ev);
      } else if (ei < o0) {
        // the head of node k's in-flight FIFO lands (and parks if the node
        // went down in flight)
        enter_node(ei - p0);
        const long long rid = nd.pend_head[node];
        const long long succ = nd.pend_len[node] > 1 ? dnx[rc(rid)] : -1;
        const double succ_land = succ >= 0 ? landing(succ) : kBig;
        __syncwarp();
        if (t == 0) {
          nd.pend_head[node] = static_cast<int>(succ);
          nd.pend_len[node] -= 1;
          nd.land[node] = succ_land;
        }
        __syncwarp();
        iters += 1;
        if constexpr (kTraced) tv = TraceEv{TK_NODE_ARRIVAL, rid, -1};
        if (is_up(node))
          node_arrival(rid, fn_id[rc(rid)], t_ev);
        else
          park(rid, t_ev);
      } else if (ei < c0) {
        // re-route the park head, decided now
        const long long rid = park_head;
        const int k = route(rid, fn_id[rc(rid)], t_ev);
        enter_node(k);
        const int succ = park_len > 1 ? nxt[rc(rid)] : -1;
        park_head = succ;
        if (park_len <= 1) park_tail = -1;
        park_len -= 1;
        iters += 1;
        if (t == 0) tally.reroutes += 1;
        if constexpr (kTraced) tv = TraceEv{TK_REROUTE, rid, -1};
        if (has_delay)
          send(k, rid, t_ev);
        else
          node_arrival(rid, fn_id[rc(rid)], t_ev);
      } else if (ei < r0) {
        enter_node(ei - c0);
        iters += 1;
        if constexpr (kTraced) tv = TraceEv{TK_CHURN, -1, -1};
        toggle(t_ev);
      } else if (ei < n_arr) {
        iters += 1;
        if constexpr (kTraced) tv = TraceEv{TK_RETRY, rs.r_head, -1};
        retry_event(t_ev);
      } else if (na < NL) {
        next = na + 1;
        iters += 1;
        const long long j = fn_arr;
        const double ta = t_arr;
        if (next < N) {
          t_arr = arrival[next];
          fn_arr = fn_id[next];
        }
        if constexpr (kTraced) tv = TraceEv{TK_ARRIVAL, na, -1};
        if (churn && n_up == 0) {
          // every node is down (a traced lane records it on node 0, the
          // reference router's fallback)
          if constexpr (kTraced) enter_node(0);
          park(na, ta);
        } else {
          const int k = route(na, j, ta);
          enter_node(k);
          if (has_delay)
            send(k, na, ta);  // in flight to node k
          else
            node_arrival(na, j, ta);
        }
      }
      fold();
      if constexpr (kTraced) record(tv, t_ev, pre);
      leave_node();
      if (iters >= max_iters) stall = 2;
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
    if constexpr (CL) {
      for (int k = t; k < p.kmax; k += 32)
        p.node_done[static_cast<long long>(lane) * p.kmax + k] =
            k < K ? nd.done[k] : 0;
      if (t == 0) {
        p.churn_counts[2 * static_cast<long long>(lane)] = tally.toggles;
        p.churn_counts[2 * static_cast<long long>(lane) + 1] = tally.reroutes;
        for (int i = 0; i < N_RS; ++i)
          p.resil_counts[static_cast<long long>(lane) * N_RS + i] = rs.n[i];
      }
    }
  }
};

// `p` stays in the parameter space (__grid_constant__): the lane keeps a
// reference to it, with no copy to local memory. The single-node form
// (CL = false only).
template <class P, bool CL>
__global__ void __launch_bounds__(32)
    event_loop_kernel(const __grid_constant__ Params p) {
  static_assert(!CL, "the K-node form is event_loop_cluster_kernel");
  extern __shared__ __align__(16) unsigned char smem[];
  Lane<P, CL> ln(p, smem);
  ln.init();
  ln.run();
  ln.write_out();
}

// The K-node form (CL = true only), bounded to at least one block an SM so
// that ptxas may give a thread up to 255 registers: under the single-node
// form's bound it caps the K-node lane at 168 registers and spills 24-316
// B a variant (PERF.md, the kernel table's K0 cluster row).
template <class P, bool CL>
__global__ void __launch_bounds__(32, 1)
    event_loop_cluster_kernel(const __grid_constant__ Params p) {
  static_assert(CL, "the single-node form is event_loop_kernel");
  extern __shared__ __align__(16) unsigned char smem[];
  Lane<P, CL> ln(p, smem);
  ln.init();
  ln.enter_node(0);
  ln.run_cluster();
  ln.write_out();
}

template <class P, bool CL>
int launch(const Params& p, int n_lanes, int smem_bytes,
           cudaStream_t stream) {
  cudaError_t e = cudaSuccess;
  if constexpr (CL) {
    if (smem_bytes > 48 * 1024)
      e = cudaFuncSetAttribute(event_loop_cluster_kernel<P, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    event_loop_cluster_kernel<P, true><<<n_lanes, 32, smem_bytes, stream>>>(
        p);
  } else {
    if (smem_bytes > 48 * 1024)
      e = cudaFuncSetAttribute(event_loop_kernel<P, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    event_loop_kernel<P, false><<<n_lanes, 32, smem_bytes, stream>>>(p);
  }
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

#define K0_ARGS                                                              \
  const int64_t *fn_id, const double *arrival, const double *exec_time,     \
      const int64_t *pos_rids, const int64_t *pos_off, const double *t_cold, \
      const double *t_evict, const int64_t *trace_ix,                       \
      const uint8_t *cap_mask, const double *beta, double prior,            \
      double threshold, int n_lanes, int n_req, int n_fns, int n_slots,     \
      int queue_cap, int fn_in_shared, int smem_bytes, void *scratch,       \
      long long fn_stride, long long max_iters, int64_t *ctr, double *sums, \
      int32_t *hist, int64_t *pcounts, double *start, double *completion,   \
      const int64_t *n_live, const double *deadlines, int tl_bins,          \
      double tl_bucket, int32_t *dl_miss, int32_t *tl_cnt, double *tl_resp, \
      double *tl_exec

// The Params of both entries' shared arguments (the cluster's null).
Params params(K0_ARGS) {
  Params p{};
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
  (void)n_lanes;
  (void)smem_bytes;
  return p;
}

// The traced units' entries take the record buffers (and, K-node form,
// tr_no_node) after the engine's arguments, under their own names.
#ifdef K0_TRACED
#define K0_SINGLE_ENTRY event_loop_traced_run
#define K0_CLUSTER_ENTRY event_loop_cluster_traced_run
#define K0_TRACE_PARAMS \
  , int32_t *tr_i, double *tr_f, const int64_t *tr_off
#define K0_CLUSTER_TRACE_PARAMS K0_TRACE_PARAMS, int tr_no_node
#define K0_SET_TRACE(p) \
  (p).tr_i = tr_i;      \
  (p).tr_f = tr_f;      \
  (p).tr_off = tr_off
#else
#define K0_SINGLE_ENTRY event_loop_run
#define K0_CLUSTER_ENTRY event_loop_cluster_run
#define K0_TRACE_PARAMS
#define K0_CLUSTER_TRACE_PARAMS
#define K0_SET_TRACE(p) (void)(p)
#endif

#define K0_PASS                                                             \
  fn_id, arrival, exec_time, pos_rids, pos_off, t_cold, t_evict, trace_ix,  \
      cap_mask, beta, prior, threshold, n_lanes, n_req, n_fns, n_slots,     \
      queue_cap, fn_in_shared, smem_bytes, scratch, fn_stride, max_iters,   \
      ctr, sums, hist, pcounts, start, completion, n_live, deadlines,       \
      tl_bins, tl_bucket, dl_miss, tl_cnt, tl_resp, tl_exec

}  // namespace

// The entries of this translation unit. Built alone (event_loop.cu), the
// single-node form's: event_loop_run and event_loop_layout. Included by
// csrc/event_loop_cluster_*.cu with K0_CLUSTER_VARIANTS defined (a part
// of K0_VARIANTS), the K-node form's of those variants:
// event_loop_cluster_run and event_loop_cluster_layout, so that nvcc
// builds the forms and halves in parallel processes (kernels/_build.py
// SOURCES; the wrapper loads each variant's K-node entry from its
// library, kernels/event_loop.py CLUSTER_SOURCE).
#ifndef K0_CLUSTER_VARIANTS
// Plain C interface for ctypes: one block of one warp a lane,
// `smem_bytes` of dynamic shared memory (slots, and the per-function
// state when fn_in_shared), the variant chosen by `policy`; the engine
// options as in Params (null pointers and tl_bins 0 when off). Returns
// cudaGetLastError() right after the launch (0 = launched; -1 for an
// unknown policy code); the launch is asynchronous on `stream`, and
// nothing here allocates or synchronises.
extern "C" int K0_SINGLE_ENTRY(int policy, K0_ARGS K0_TRACE_PARAMS,
                               void* stream) {
  Params p = params(K0_PASS);
  K0_SET_TRACE(p);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (policy) {
#define K0_LAUNCH(code, P) \
  case code:               \
    return launch<P, false>(p, n_lanes, smem_bytes, st);
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

#else
// The K-node variant: as event_loop_run (pos_rids and pos_off unused,
// cap_mask (L, kmax, n_slots), `smem_bytes` the slots of slot_cap, the
// node table of kmax and the per-(node, function) state when
// fn_in_shared), plus each lane's topology `topo` (L, 5: K, C, router
// code, JSQ's d, seed) and `delays` (L, kmax), the link rails `links` (L,
// 3, N) int32, the outputs node_done (L, kmax) and node_of (L, N; null
// unless in exact mode with a delay); churn's toggle times `churn_t` (L,
// kmax, n_toggle_cols) and the delay schedules `dtimes`, `dvals` (L, kmax,
// n_steps) and `dper` (L, kmax), each null (0 columns) when no lane has
// them, `land_t` (L, N) f64 (null unless a lane has a delay) and
// the output churn_counts (L, 2): each lane's toggles and re-routes; the
// resilience layer (`resil` 1: the (T, N) rows rs_nfail int32, rs_tmo
// uint8 and rs_key int32, the zeroed (L, N) int32 att and (L, N) f64
// rt_t, max_att, shed_mode, the backoff's base, cap, jitter and seed term;
// 0: every pointer null), the breaker lanes' (L, 3) f64 `brk` (volume,
// trip point, cooldown; null when no lane has kBreakerBit) and the output
// resil_counts (L, N_RS).
extern "C" int K0_CLUSTER_ENTRY(
    int policy, K0_ARGS, const int64_t* topo, const double* delays,
    int kmax, int slot_cap, int32_t* links, int32_t* node_done,
    int32_t* node_of, const double* churn_t, int n_toggle_cols,
    const double* dtimes, const double* dvals, const double* dper,
    int n_steps, double* land_t, int64_t* churn_counts, int resil,
    const int32_t* rs_nfail, const uint8_t* rs_tmo, const int32_t* rs_key,
    int32_t* att, double* rt_t, int max_att, int shed_mode, double rt_base,
    double rt_cap, double rt_jit, long long rt_seed, const double* brk,
    int64_t* resil_counts K0_CLUSTER_TRACE_PARAMS, void* stream) {
  Params p = params(K0_PASS);
  K0_SET_TRACE(p);
#ifdef K0_TRACED
  p.tr_no_node = tr_no_node;
#endif
  p.topo = topo;
  p.delays = delays;
  p.kmax = kmax;
  p.slot_cap = slot_cap;
  p.links = links;
  p.node_done = node_done;
  p.node_of = node_of;
  p.churn_t = churn_t;
  p.n_toggle_cols = n_toggle_cols;
  p.dtimes = dtimes;
  p.dvals = dvals;
  p.dper = dper;
  p.n_steps = n_steps;
  p.land_t = land_t;
  p.churn_counts = churn_counts;
  p.resil = resil;
  p.rs_nfail = rs_nfail;
  p.rs_tmo = rs_tmo;
  p.rs_key = rs_key;
  p.att = att;
  p.rt_t = rt_t;
  p.max_att = max_att;
  p.shed_mode = shed_mode;
  p.rt_base = rt_base;
  p.rt_cap = rt_cap;
  p.rt_jit = rt_jit;
  p.rt_seed = static_cast<unsigned>(rt_seed);
  p.brk = brk;
  p.resil_counts = resil_counts;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (policy) {
#define K0_LAUNCH(code, P) \
  case code:               \
    return launch<P, true>(p, n_lanes, smem_bytes, st);
    K0_CLUSTER_VARIANTS(K0_LAUNCH)
#undef K0_LAUNCH
  }
  return -1;
}

// The K-node variant's layout of `policy`: its bytes a (node, function),
// a lane's function rows (t_cold, t_evict) a function, a node, JSQ's
// largest d, the breaker bit of a router code and the columns of the
// resilience counts (R_FAILED .. R_TRIPS, N_RS). Returns 12, writing at
// most `n`; -1 for an unknown code.
extern "C" int event_loop_cluster_layout(int policy, long long* out, int n) {
  long long v[12] = {0,         kLaneFnBytes, kNodeBytes, kMaxJsqD,
                     kBreakerBit, R_FAILED,   R_TMO,      R_RETRIED,
                     R_SHED,    R_EXH,        R_TRIPS,    N_RS};
  switch (policy) {
#define K0_CL_LAYOUT(code, P) \
  case code:                  \
    v[0] = P::node_fn_bytes;  \
    break;
    K0_VARIANTS(K0_CL_LAYOUT)
#undef K0_CL_LAYOUT
    default:
      return -1;
  }
  for (int i = 0; i < 12 && i < n; ++i) out[i] = v[i];
  return 12;
}
#endif  // K0_CLUSTER_VARIANTS
