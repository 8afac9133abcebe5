"""Lane-batched event engine for a C-slot edge server, in PyTorch.

Port of `repro.core.jax_engine` in its single-window form: the state
layout, the queue ops, the slot primitives (`dispatch` / `start_cold`),
the timer rail, the running-mean estimator, the per-event metric fold
and the event loop. Decisions live in policy kernels
(`repro_torch.core.policies`).
Every array carries a leading *lane* dimension L, one lane per sweep
point (trace x capacity x beta), where the JAX engine used ``vmap``.

State (F functions, C slots, N requests, L lanes; int64 where a value
indexes, int32 for counts, float64 for every time):

  slots:  slot_fn (L, C) resident function (-1 empty), slot_state
          {COLD, IDLE, BUSY}, slot_ready (next slot event time, BIG when
          idle), slot_req (request in service), slot_used (last
          dispatch time), slot_seq (creation sequence: the tie-break of
          victim and idle-slot scans)
  queues: per-function FIFOs as position cursors into the trace's
          per-function arrival order (``pos_rids`` / ``pos_off``, a
          stable argsort of fn_id): q_head_pos, q_head_rid, q_len (L, F)
  est:    est_sum (L, F) f64 / est_n (L, F) running means, with the
          global mean (g_sum / g_n), then ``prior``, as fallback
  timers: (only for a kernel with ``has_timers``) original timers fire
          at arrival + threshold in arrival order, so the rail rides the
          per-function positions: tmr_pos (L, F) i32 is the next
          position whose timer fires, arr_cnt (L, F) i32 counts arrived
          positions, tmr_next (L, F) f64 is the head fire time (BIG when
          idle). Re-arms (only ever the queue head) keep the one-entry
          cache rearm_t (L, F) f64 / rearm_rid (L, F)
  ctrs:   one (L,) tensor per counter: ``next`` (arrival cursor),
          ``done``, ``iters`` (processed events), ``stall``, ``seq``,
          ``cold``, ``evict``, ``ovf`` and the f64 sums ``cold_t``,
          ``evict_t``, ``r_sum``, ``s_sum``, ``r_max``. (The JAX engine
          packs them into two arrays to shrink its loop carry; here a
          named tensor each costs the same one op per update.)
  out:    ``hist`` (L, HIST_BINS), the log-spaced response histogram;
          in exact mode (``stream=False``) also start/completion
          (L, N) per request; with ``deadlines`` the per-function miss
          counts ``dl_miss`` (L, F) i32; with ``tl_bins`` the arrival-
          minute timeline ``tl_cnt`` (L, bins) i32, ``tl_resp`` and
          ``tl_exec`` (L, bins) f64.

Engine options (`simulate`): ``n_live`` (L,) makes each lane a ragged
prefix of its trace row (the arrival candidate is BIG once ``next >=
n_live``, and a lane is active while ``done < n_live``), so padded rows
share one operand (the static cluster tier); ``deadlines`` (F,) counts
each dispatch whose response exceeds its function's deadline; ``tl_bins``
/ ``tl_bucket`` bin each dispatch by its arrival time. ``window`` is
accepted and changes nothing: the JAX engine's results are bitwise
window-invariant, and the port runs one window.

Event arbitration is the reference's: one first-index argmin over the
packed candidate times [BUSY slots | COLD slots | (original timers |
re-arms) | next arrival] per lane, so at equal times EXEC_DONE <
COLD_DONE < TIMER (original < re-arm) < ARRIVAL and the slot or
function index breaks ties within a class. Writes are guarded: a
disabled write (``on`` false, or an index out of range) matches no
element of its one-hot mask, which is where the JAX engine sent writes
to a dropped sentinel index. Each f64 accumulation touches one element
per lane per event, in event order, so sums are deterministic on every
device and streamed sums are bitwise the exact-mode ones.

Two routes run this loop. `simulate` sends a built-in policy (the four
kernel classes of `repro_torch.core.policies`) to the event-loop kernel
`repro_torch.kernels.event_loop` (K0): on a CUDA device one launch per
lane chunk runs every event of every lane, and on the CPU the wrapper
takes its plain version, `simulate_eager`. Any other `PolicyKernel` (a
subclass too) runs `simulate_eager` on either device. The eager
loop runs SEG events between termination checks (the host reads one
flag per segment, never inside an event step) and launches every op of
the step separately, ~418 ops a step on a GPU: it is the kernel's plain
version, the reference that the kernel is held to bitwise, and too slow
on a card for the paper's traces (see PERF.md).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.request import Trace
from repro_torch.telemetry.rail import TraceKind
from repro_torch.utils.device import resolve_device

BIG = 1e30
COLD, IDLE, BUSY = 0, 1, 2
I32_MAX = int(np.iinfo(np.int32).max)
SEG = 32          # events between host-side termination checks

# Streaming response histogram: log-spaced, 8 bins/decade over
# [1e-4, 1e4) seconds. Quantile reads are exact to one bin width.
HIST_BINS = 64
HIST_LO = -4.0
HIST_PER_DECADE = 8
# jnp.log10 is log(x) * (1 / ln 10); the bin index uses the same
# spelling so a response on a bin edge lands in the reference's bin
INV_LN10 = 0.4342944819032518

# Lanes per engine call, by device type. Results do not depend on it.
LANE_CHUNKS = {"cpu": 8, "cuda": 256}

_COUNTERS = ("next", "done", "iters", "stall", "seq", "gn", "cold",
             "evict", "ovf")
_SUMS = ("g_sum", "cold_t", "evict_t", "r_sum", "s_sum", "r_max")

# the counters whose change in an event sets its record's TR_AUX bits
_TRACE_CTRS = ("cold", "ovf", "shed", "failed", "tmo", "exh")

# The state that scales with the trace length N, by name, with the reason
# it may: of the eager loop (`_init_state`) and of the event-loop
# kernel's single-node launches (`kernels.event_loop._Results`,
# `_TraceBuffers`). Every other tensor of either is O(F + C + HIST_BINS)
# a lane. Metadata: no loop reads it; `repro_torch.analysis` holds the
# allocations to it in both directions.
CARRY_RAILS = {
    "start": "exact mode's per-request dispatch time: the (L, N) record "
             "is the requested output, not loop bookkeeping (streaming "
             "mode folds it away); the eager loop keeps one spare column "
             "for disabled writes, (L, N + 1).",
    "completion": "exact mode's per-request completion time; the same "
                  "contract as `start`.",
    "tr_i": "the event-loop kernel's traced window (traced launches "
            "only): one int32 record an event in a per-lane window of "
            "`trace_capacity(N)` rows, copied back once a launch. It "
            "scales with N where the JAX package's (L, SEG) overlay does "
            "not, because a kernel cannot hand records to the host in the "
            "middle of a launch: the window holds the lane's whole stream "
            "(an exact relaunch when a lane overruns it). The eager loop "
            "keeps O(SEG) records and flushes them a segment.",
    "tr_f": "the traced window's float64 half (event time, execution "
            "time); the same contract as `tr_i`.",
}


def positional_layout(fn_id, f):
    """The positional queue layout of (T, N) int64 ``fn_id``: request
    ids sorted by (fn, id), (T, N), and per-function offsets, (T, F + 1)
    -- fn j's k-th arrival is ``pos_rids[pos_off[j] + k]``. Shared by
    the eager loop and the event-loop kernel."""
    T = fn_id.shape[0]
    dev = fn_id.device
    pos_rids = torch.argsort(fn_id, dim=1, stable=True)
    counts = torch.zeros((T, f), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, fn_id.clamp(0, f - 1), torch.ones_like(fn_id))
    pos_off = torch.cat(
        [torch.zeros((T, 1), dtype=torch.int64, device=dev),
         torch.cumsum(counts, 1)], 1)
    return pos_rids, pos_off


class EngineCtx:
    """Per-run view handed to policy kernels: the shared trace operands
    (flattened, read through per-lane base offsets), the per-lane knobs
    and the shape constants. Counterpart of `jax_engine.EngineCtx` in
    its single-window form: every read goes to the full trace."""

    def __init__(self, *, fn_id, arrival, exec_time, t_cold_l, t_evict_l,
                 trace_ix, cap_mask, beta, prior, f, c, q, stream,
                 threshold=0.1, n_live=None, deadlines=None, tl_bins=0,
                 tl_bucket=60.0, positional=True):
        N = fn_id.shape[1]
        dev = fn_id.device
        self.N, self.F, self.C, self.Q = N, f, c, q
        self.L = trace_ix.shape[0]
        self.stream = stream
        self._fn = fn_id.reshape(-1)
        self._arr = arrival.reshape(-1)
        self._ex = exec_time.reshape(-1)
        if positional:   # the cluster's link-rail queues need no layout
            pos, off = positional_layout(fn_id, f)
            self._pos = pos.reshape(-1)
            self._off = off.reshape(-1)
        self.b_n = trace_ix * N          # per-lane base into (T, N)
        self.b_f1 = trace_ix * (f + 1)   # per-lane base into (T, F+1)
        self.t_cold = t_cold_l           # (L, F) this lane's row
        self.t_evict = t_evict_l
        self.cap_mask = cap_mask         # (L, C) bool
        self.beta = beta                 # (L,) f64
        self.prior = prior
        self.threshold = threshold       # timer delay (timer policies)
        # (L,) live prefix of each lane's trace row
        self.n_live = (torch.full((self.L,), N, dtype=torch.int64,
                                  device=dev)
                       if n_live is None else n_live)
        self.deadlines = deadlines       # (F,) f64 or None
        # (L,) bool: the lanes whose dispatch records the event's fold
        # (None: every lane); the cluster's direct lanes fold at EXEC_DONE
        self.fold_mask = None
        # the resilience layer (the K-node loop's ctx): a dispatch counts
        # an attempt, and the completion is recorded on success only
        self.has_resil = False
        self.defer_completion = False
        self.tl_bins = tl_bins           # timeline bins (0: off)
        # an (L,) tensor, so that the bin is a true division on every
        # device (CUDA multiplies by the reciprocal of a Python scalar)
        self.tl_bucket = torch.full((self.L,), float(tl_bucket),
                                    dtype=torch.float64, device=dev)
        self.lanes = torch.arange(self.L, device=dev)
        self.ar_c = torch.arange(c, device=dev)
        self.ar_f = torch.arange(f, device=dev)
        self.ar_h = torch.arange(HIST_BINS, device=dev)
        self.ar_tl = torch.arange(tl_bins, device=dev)

    # ------------------------------------------------------ trace reads
    def _rid(self, rid):
        return self.b_n + rid.clamp(0, self.N - 1)

    def fn_at(self, rid):
        return self._fn[self._rid(rid)]

    def arrival_at(self, rid):
        return self._arr[self._rid(rid)]

    def exec_at(self, rid):
        return self._ex[self._rid(rid)]

    def rid_at_pos(self, fn, pos):
        """Request id at arrival position ``pos`` of function ``fn``
        (garbage on out-of-range positions; callers gate)."""
        gi = self._off[self.b_f1 + fn.clamp(0, self.F - 1)] + pos
        return self._pos[self.b_n + gi.clamp(0, self.N - 1)]

    def row(self, x, idx, n):
        """``x[l, idx[l]]`` per lane, ``idx`` clipped to [0, n)."""
        return x[self.lanes, idx.clamp(0, n - 1)]

    # -------------------------------------------------------- estimator
    def est_means(self, s):
        """Per-function running means with global-mean / prior
        fallback, (L, F) f64."""
        counts = s["est_n"].to(torch.float64)
        g_n = s["gn"]
        g = torch.where(g_n > 0,
                        s["g_sum"] / torch.clamp_min(g_n.to(torch.float64),
                                                     1),
                        self.prior)
        return torch.where(s["est_n"] > 0,
                           s["est_sum"] / torch.clamp_min(counts, 1),
                           g[:, None])

    # ----------------------------------------------------------- queues
    def q_push(self, s, fn, rid, on):
        """Append ``rid`` (by construction the next arrival position of
        ``fn``): only the length moves, plus the head cache when the
        queue was empty. A push onto a full backlog (q_len ==
        queue_cap) is dropped and counted in ``ovf``. Returns whether
        it pushed, (L,) bool."""
        q0 = self.row(s["q_len"], fn, self.F)
        full = q0 >= self.Q
        do = on & ~full
        s["q_head_rid"] = torch.where(_hit(do & (q0 == 0), fn, self.ar_f),
                                      rid[:, None], s["q_head_rid"])
        s["q_len"] = s["q_len"] + _hit(do, fn, self.ar_f)
        s["ovf"] = s["ovf"] + (on & full)
        return do

    def q_consume_direct(self, s, fn, on):
        """Account a directly dispatched arrival: its (empty-queue)
        head position is consumed without ever being enqueued."""
        s["q_head_pos"] = s["q_head_pos"] + _hit(on, fn, self.ar_f)

    def q_pop(self, s, fn, on):
        """Consume the head of ``fn``'s queue and return its rid; the
        head cache is refreshed with the successor (garbage when the
        queue empties; reads gate on q_len)."""
        rid = self.row(s["q_head_rid"], fn, self.F)
        succ = self.rid_at_pos(fn, self.row(s["q_head_pos"], fn, self.F)
                               + 1)
        m = _hit(on, fn, self.ar_f)
        s["q_head_rid"] = torch.where(m, succ[:, None], s["q_head_rid"])
        s["q_head_pos"] = s["q_head_pos"] + m
        s["q_len"] = s["q_len"] - m.to(torch.int32)
        return rid

    def arm_timer(self, s, fn, rid, t, pushed, on):
        """Account the original timer of the arrival ``rid`` of ``fn`` at
        ``t``, the newest entry of ``fn``'s timer rail (its position
        identifies the request). If the rail is idle (this arrival is its
        head) a *pushed* arrival arms the head fire time, while one that
        was not pushed is consumed silently; an arrival behind a busy
        rail stays armed and later fires as a no-op (its is-head gate
        fails)."""
        rail_head = (self.row(s["tmr_pos"], fn, self.F)
                     == self.row(s["arr_cnt"], fn, self.F) - 1)
        m = _hit(on & rail_head & pushed, fn, self.ar_f)
        s["tmr_next"] = torch.where(m, (t + self.threshold)[:, None],
                                    s["tmr_next"])
        s["tmr_pos"] = s["tmr_pos"] + _hit(on & rail_head & ~pushed, fn,
                                           self.ar_f)


class PolicyKernel:
    """Interface a policy implements over the engine state (counterpart
    of `jax_engine.PolicyKernel`). Each hook runs every event step for
    every lane and folds its ``on`` (L,) predicate into every write;
    the engine has already done the policy-independent bookkeeping
    (arrival cursor, estimator update and slot release) before it
    calls a hook (and, for a timer event, consumed the timer). Hooks
    update the state dict ``s`` in place.

    Queue contract: every enabled ``on_arrival`` consumes exactly one
    queue position of the request's function -- ``q_push`` when it
    queues, ``q_consume_direct`` when it dispatches straight to a slot.
    """

    name = "base"
    has_timers = False
    default_beta = 1.0

    def extra_state(self, L, C, F) -> Dict[str, torch.Tensor]:
        """Kernel-private state tensors (leading L), e.g. FaasCache's
        per-slot GREEDY-DUAL bookkeeping; the engine moves them to the
        run's device. Keys must not collide with the engine's."""
        return {}

    def on_arrival(self, ctx, s, rid, t, on):
        raise NotImplementedError

    def on_cold_done(self, ctx, s, slot, t, on):
        raise NotImplementedError

    def on_exec_done(self, ctx, s, slot, rid, t, on):
        raise NotImplementedError

    def on_timer(self, ctx, s, rid, t, on):
        """A timer of request ``rid`` fires (kernels with
        ``has_timers``)."""


# --------------------------------------------------------------- helpers
def _hit(on, idx, ar):
    """(L, n) one-hot write mask: ``idx[l]`` where ``on[l]``. An index
    outside [0, n) matches nothing -- the counterpart of the JAX
    engine's dropped sentinel index (`jax_engine._gidx`)."""
    return (ar == idx[:, None]) & on[:, None]


def lex_argmin(primary, secondary, valid):
    """First index minimising ``(primary, secondary)`` among ``valid``,
    per lane: iterate in ``secondary`` order, keep on strict
    improvement."""
    p = torch.where(valid, primary, BIG)
    tie = valid & (p <= p.min(dim=1, keepdim=True).values)
    return torch.argmin(torch.where(tie, secondary, I32_MAX), dim=1)


def argmin_i32(vals, valid):
    """First valid index minimising an integer key, per lane."""
    return torch.argmin(torch.where(valid, vals, I32_MAX), dim=1)


def k_counts(ctx, s):
    """|K^j| -- slots assigned to each function, any state: (L, F)
    int32, contiguous."""
    return (s["slot_fn"][:, :, None] == ctx.ar_f).sum(1, dtype=torch.int32)


def cold_counts(ctx, s):
    """Slots warming up (state COLD) per function: (L, F) int32."""
    warming = (s["slot_state"] == COLD)[:, :, None]
    return ((s["slot_fn"][:, :, None] == ctx.ar_f) & warming).sum(
        1, dtype=torch.int32)


def q_head(ctx, s, fn):
    """Head request id of ``fn``'s queue, (L,) (garbage when empty:
    callers gate on ``q_len``)."""
    return ctx.row(s["q_head_rid"], fn, ctx.F)


def rearm_timer(ctx, s, fn, rid, t_fire, on):
    """Re-arm the (unique) blocked queue head of ``fn`` at ``t_fire``."""
    m = _hit(on, fn, ctx.ar_f)
    s["rearm_t"] = torch.where(m, t_fire[:, None], s["rearm_t"])
    s["rearm_rid"] = torch.where(m, rid[:, None], s["rearm_rid"])


def idle_own(ctx, s, fn):
    """Mask of usable idle slots already resident with ``fn``."""
    return ((s["slot_fn"] == fn[:, None]) & (s["slot_state"] == IDLE)
            & ctx.cap_mask)


def pick_idle_own(ctx, s, fn):
    """(any, earliest-created idle own slot) per lane."""
    mask = idle_own(ctx, s, fn)
    return mask.any(1), argmin_i32(s["slot_seq"], mask)


def dispatch(ctx, s, slot, rid, t, on):
    """Run ``rid`` on the idle ``slot`` of its function.

    The metric fold happens once at the end of the event
    (`_fold_event`): the dispatch only records (rid, completion, exec)
    in the per-event registers ``ev_*`` (on the lanes of
    ``ctx.fold_mask`` when it is set). At most one dispatch happens per
    event, so the registers never clobber a live record. Exact mode also
    writes the per-request start/completion (the last dispatch of a
    request wins; under resilience the completion is written at a
    successful EXEC_DONE instead, and each dispatch counts an attempt in
    ``att``)."""
    e = ctx.exec_at(rid)
    comp = t + e
    m = _hit(on, slot, ctx.ar_c)
    s["slot_state"] = torch.where(m, BUSY, s["slot_state"])
    s["slot_ready"] = torch.where(m, comp[:, None], s["slot_ready"])
    s["slot_req"] = torch.where(m, rid[:, None], s["slot_req"])
    s["slot_used"] = torch.where(m, t[:, None], s["slot_used"])
    fold = on if ctx.fold_mask is None else on & ctx.fold_mask
    s["ev_rid"] = torch.where(fold, rid, s["ev_rid"])
    s["ev_comp"] = torch.where(fold, comp, s["ev_comp"])
    s["ev_exec"] = torch.where(fold, e, s["ev_exec"])
    if ctx.has_resil or not ctx.stream:
        col = torch.where(on, rid, ctx.N)[:, None]   # column N: dropped
        if ctx.has_resil:
            s["att"].scatter_add_(1, col, on[:, None].to(torch.int64))
        if not ctx.stream:
            s["start"].scatter_(1, col, t[:, None])
            if not ctx.defer_completion:
                s["completion"].scatter_(1, col, comp[:, None])


def _fold_event(ctx, s):
    """End-of-event metric fold of the ``ev_*`` dispatch registers, in
    event order: response and slowdown sums, maximum, histogram, then
    (when on) the deadline misses (``resp > deadline``, strictly) and the
    timeline bin of the request's arrival."""
    rid = s["ev_rid"]
    on = rid >= 0
    arr = ctx.arrival_at(rid)
    resp = s["ev_comp"] - arr
    slow = resp / torch.clamp_min(s["ev_exec"], 1e-9)
    s["r_sum"] = s["r_sum"] + torch.where(on, resp, 0.0)
    s["s_sum"] = s["s_sum"] + torch.where(on, slow, 0.0)
    s["r_max"] = torch.maximum(s["r_max"], torch.where(on, resp, 0.0))
    s["hist"] = s["hist"] + _hit(on, hist_bin(resp), ctx.ar_h)
    if ctx.deadlines is not None:
        fnr = ctx.fn_at(rid)
        dl = ctx.deadlines[fnr.clamp(0, ctx.F - 1)]
        s["dl_miss"] = s["dl_miss"] + _hit(on & (resp > dl), fnr, ctx.ar_f)
    if ctx.tl_bins:
        tb = (arr / ctx.tl_bucket).to(torch.int32).clamp(0, ctx.tl_bins - 1)
        m = _hit(on, tb, ctx.ar_tl)
        s["tl_cnt"] = s["tl_cnt"] + m
        s["tl_resp"] = torch.where(m, s["tl_resp"] + resp[:, None],
                                   s["tl_resp"])
        s["tl_exec"] = torch.where(m, s["tl_exec"] + s["ev_exec"][:, None],
                                   s["tl_exec"])


def start_cold(ctx, s, slot, fn, t, evict_fn, on):
    """Claim/convert ``slot`` for ``fn`` (``evict_fn`` = -1: an empty
    slot; otherwise the resident function pays its eviction cost
    first)."""
    evicting = on & (evict_fn >= 0)
    ev_cost = torch.where(evicting,
                          ctx.row(ctx.t_evict, evict_fn, ctx.F), 0.0)
    tc = ctx.row(ctx.t_cold, fn, ctx.F)
    m = _hit(on, slot, ctx.ar_c)
    s["slot_fn"] = torch.where(m, fn[:, None], s["slot_fn"])
    s["slot_state"] = torch.where(m, COLD, s["slot_state"])
    s["slot_ready"] = torch.where(m, (t + tc + ev_cost)[:, None],
                                  s["slot_ready"])
    s["slot_req"] = torch.where(m, -1, s["slot_req"])
    s["slot_used"] = torch.where(m, 0.0, s["slot_used"])
    s["slot_seq"] = torch.where(m, s["seq"][:, None], s["slot_seq"])
    s["seq"] = s["seq"] + on
    s["cold"] = s["cold"] + on
    s["evict"] = s["evict"] + evicting
    s["cold_t"] = s["cold_t"] + torch.where(on, tc, 0.0)
    s["evict_t"] = s["evict_t"] + ev_cost


# ----------------------------------------------------- streaming metrics
def hist_edges() -> np.ndarray:
    """Bin edges (HIST_BINS + 1,) of the streaming response histogram."""
    return 10.0 ** (HIST_LO + np.arange(HIST_BINS + 1) / HIST_PER_DECADE)


def hist_bin(resp):
    """Log-spaced bin index of response times (int64)."""
    lg = torch.log(torch.clamp_min(resp, 1e-30)) * INV_LN10
    b = torch.floor((lg - HIST_LO) * HIST_PER_DECADE)
    return b.clamp(0, HIST_BINS - 1).to(torch.int64)


def hist_quantile(hist, q, n, resp_max=None):
    """Upper edge of the bin holding the q-quantile of ``n`` folded
    responses (an int, or an (L, 1) tensor of live counts), clamped to
    ``resp_max`` (the top bin reports the maximum itself); (L,
    HIST_BINS) -> (L,)."""
    cum = torch.cumsum(hist, dim=-1)
    if isinstance(n, torch.Tensor):
        need = torch.ceil(q * n.to(torch.float64)).to(cum.dtype)
    else:
        need = math.ceil(q * n)
    b = torch.argmax((cum >= need).to(torch.uint8), dim=-1)
    edge = torch.as_tensor(hist_edges(), device=hist.device)[b + 1]
    if resp_max is None:
        return edge
    return torch.where(b >= HIST_BINS - 1, resp_max,
                       torch.minimum(edge, resp_max))


def hist_cdf(hist):
    """(edges, cdf) numpy arrays for plotting a CDF from the streamed
    histogram."""
    h = np.asarray(hist, np.float64)
    cum = h.cumsum(axis=-1)
    total = np.maximum(cum[..., -1:], 1.0)
    return hist_edges()[1:], cum / total


def percentile_linear(x, q: float):
    """Row-wise percentile with linear interpolation, in the spelling
    of ``jnp.percentile`` (sort, q * (n - 1), weights 1 - frac and
    frac)."""
    a = torch.sort(x, dim=1).values
    n = a.shape[1]
    pos = (q / 100.0) * (n - 1)
    lo, hi = math.floor(pos), math.ceil(pos)
    hw = pos - lo
    lo, hi = min(max(lo, 0), n - 1), min(max(hi, 0), n - 1)
    return a[:, lo] * (1.0 - hw) + a[:, hi] * hw


def percentile_nan(x, q: float):
    """Row-wise percentile over each row's values that are not NaN, in the
    spelling of ``jnp.nanpercentile`` (sorted, NaN last; the count of
    values sets the position); NaN for a row of NaN."""
    a = torch.sort(x, dim=1).values
    n = (~torch.isnan(x)).sum(1)
    pos = (q / 100.0) * (n.to(torch.float64)[:, None] - 1.0)
    lo, hi = torch.floor(pos), torch.ceil(pos)
    hw = pos - lo
    top = torch.clamp_min(n[:, None] - 1, 0)
    lo = torch.minimum(lo.clamp_min(0).to(torch.int64), top)
    hi = torch.minimum(hi.clamp_min(0).to(torch.int64), top)
    v = (a.gather(1, lo) * (1.0 - hw) + a.gather(1, hi) * hw)[:, 0]
    return torch.where(n > 0, v, math.nan)


def percentile_live(x, q: float, n_live):
    """Row-wise percentile of each row's first ``n_live`` entries, in the
    spelling of ``jnp.nanpercentile`` over the row with the rest NaN; NaN
    for an empty row."""
    live = torch.arange(x.shape[1], device=x.device) < n_live[:, None]
    return percentile_nan(torch.where(live, x, math.nan), q)


# ------------------------------------------------------------ event loop
def _init_state(kernel, L, C, F, N, stream, dev, deadlines=False,
                tl_bins=0) -> Dict[str, torch.Tensor]:
    i64, i32, f64 = torch.int64, torch.int32, torch.float64
    s = dict(
        slot_fn=torch.full((L, C), -1, dtype=i64, device=dev),
        slot_state=torch.full((L, C), IDLE, dtype=i64, device=dev),
        slot_ready=torch.full((L, C), BIG, dtype=f64, device=dev),
        slot_req=torch.full((L, C), -1, dtype=i64, device=dev),
        slot_used=torch.zeros((L, C), dtype=f64, device=dev),
        slot_seq=torch.full((L, C), I32_MAX, dtype=i64, device=dev),
        q_head_pos=torch.zeros((L, F), dtype=i64, device=dev),
        q_head_rid=torch.full((L, F), -1, dtype=i64, device=dev),
        q_len=torch.zeros((L, F), dtype=i32, device=dev),
        est_sum=torch.zeros((L, F), dtype=f64, device=dev),
        est_n=torch.zeros((L, F), dtype=i32, device=dev),
        hist=torch.zeros((L, HIST_BINS), dtype=i64, device=dev),
    )
    for k in _COUNTERS:
        s[k] = torch.zeros((L,), dtype=i64, device=dev)
    for k in _SUMS:
        s[k] = torch.zeros((L,), dtype=f64, device=dev)
    if not stream:
        # one spare column takes the disabled writes
        s["start"] = torch.full((L, N + 1), -1.0, dtype=f64, device=dev)
        s["completion"] = torch.full((L, N + 1), -1.0, dtype=f64,
                                     device=dev)
    if deadlines:
        s["dl_miss"] = torch.zeros((L, F), dtype=i32, device=dev)
    if tl_bins:
        s["tl_cnt"] = torch.zeros((L, tl_bins), dtype=i32, device=dev)
        s["tl_resp"] = torch.zeros((L, tl_bins), dtype=f64, device=dev)
        s["tl_exec"] = torch.zeros((L, tl_bins), dtype=f64, device=dev)
    if kernel.has_timers:
        s["arr_cnt"] = torch.zeros((L, F), dtype=i32, device=dev)
        s["tmr_pos"] = torch.zeros((L, F), dtype=i32, device=dev)
        s["tmr_next"] = torch.full((L, F), BIG, dtype=f64, device=dev)
        s["rearm_t"] = torch.full((L, F), BIG, dtype=f64, device=dev)
        s["rearm_rid"] = torch.full((L, F), -1, dtype=i64, device=dev)
    for k, v in kernel.extra_state(L, C, F).items():
        if k in s:
            raise ValueError(f"policy {kernel.name!r}: extra_state key "
                             f"{k!r} collides with the engine's state")
        s[k] = v.to(dev)
    return s


def _event_step(ctx, kernel, s, max_iters, rec=None):
    """One event for every lane: pick, handle, fold. With ``rec`` (a
    list), also appends the step's trace records (`_trace_record`)."""
    N, C, F = ctx.N, ctx.C, ctx.F
    timers = kernel.has_timers
    if rec is not None:
        pre = _trace_pre(s, s["q_len"].sum(1))
    # ---- pick: first-index argmin over
    # [busy | cold | (original timers | re-arms) | arrival]
    na = s["next"]
    nl = ctx.n_live
    t_arr = torch.where(na < nl, ctx.arrival_at(na), BIG)
    ready = torch.where(ctx.cap_mask, s["slot_ready"], BIG)
    st = s["slot_state"]
    blocks = [torch.where(st == BUSY, ready, BIG),
              torch.where(st == COLD, ready, BIG)]
    if timers:
        blocks += [s["tmr_next"], s["rearm_t"]]
    cand = torch.cat(blocks + [t_arr[:, None]], dim=1)
    t_ev, ei = torch.min(cand, dim=1)   # first index of the minimum

    active = (s["done"] < nl) & (s["stall"] == 0)
    live = active & (t_ev < BIG)
    ev_slot = live & (ei < 2 * C)
    is_cold = ei >= C
    slot = torch.where(is_cold, ei - C, ei).clamp(0, C - 1)
    ev_arr = live & (ei == cand.shape[1] - 1) & (na < nl)

    # ---- slot event: release, estimator, then the policy hooks
    cold_on = ev_slot & is_cold
    exec_on = ev_slot & ~is_cold
    rid_done = ctx.row(s["slot_req"], slot, C)
    j_done = ctx.row(s["slot_fn"], slot, C)
    e_done = ctx.exec_at(rid_done)
    m = _hit(ev_slot, slot, ctx.ar_c)
    s["slot_state"] = torch.where(m, IDLE, s["slot_state"])
    s["slot_ready"] = torch.where(m, BIG, s["slot_ready"])
    s["slot_req"] = torch.where(m, -1, s["slot_req"])
    mj = _hit(exec_on, j_done, ctx.ar_f)
    s["est_sum"] = torch.where(mj, s["est_sum"] + e_done[:, None],
                               s["est_sum"])
    s["est_n"] = s["est_n"] + mj
    s["g_sum"] = s["g_sum"] + torch.where(exec_on, e_done, 0.0)
    s["gn"] = s["gn"] + exec_on
    s["done"] = s["done"] + exec_on
    s["ev_rid"] = torch.full_like(na, -1)
    s["ev_comp"] = torch.zeros_like(t_ev)
    s["ev_exec"] = torch.zeros_like(t_ev)
    kernel.on_cold_done(ctx, s, slot, t_ev, cold_on)
    kernel.on_exec_done(ctx, s, slot, rid_done, t_ev, exec_on)

    # ---- timer: an original (arrival + threshold, in arrival order)
    # or the re-armed head; the timer is consumed before the hook
    ev_timer = torch.zeros_like(live)
    if timers:
        n0 = 2 * C
        fire_orig = live & (ei >= n0) & (ei < n0 + F)
        fire_re = live & (ei >= n0 + F) & (ei < n0 + 2 * F)
        ev_timer = fire_orig | fire_re
        f_o = (ei - n0).clamp(0, F - 1)
        f_r = (ei - n0 - F).clamp(0, F - 1)
        p_o = ctx.row(s["tmr_pos"], f_o, F)
        rid_o = ctx.rid_at_pos(f_o, p_o)
        succ = ctx.rid_at_pos(f_o, p_o + 1)
        more = p_o + 1 < ctx.row(s["arr_cnt"], f_o, F)
        mo = _hit(fire_orig, f_o, ctx.ar_f)
        s["tmr_pos"] = s["tmr_pos"] + mo
        nxt = torch.where(more, ctx.arrival_at(succ) + ctx.threshold, BIG)
        s["tmr_next"] = torch.where(mo, nxt[:, None], s["tmr_next"])
        rid_r = ctx.row(s["rearm_rid"], f_r, F)
        s["rearm_t"] = torch.where(_hit(fire_re, f_r, ctx.ar_f), BIG,
                                   s["rearm_t"])
        rid_t = torch.where(fire_orig, rid_o, rid_r)
        kernel.on_timer(ctx, s, rid_t, t_ev, ev_timer)

    # ---- arrival
    rid_a = na.clamp(max=N - 1)
    s["next"] = na + ev_arr
    s["iters"] = s["iters"] + (ev_slot | ev_timer | ev_arr)
    if timers:
        s["arr_cnt"] = s["arr_cnt"] + _hit(ev_arr, ctx.fn_at(rid_a),
                                           ctx.ar_f)
    kernel.on_arrival(ctx, s, rid_a, t_arr, ev_arr)

    _fold_event(ctx, s)
    if rec is not None:
        kind = torch.where(exec_on, TraceKind.EXEC, torch.where(
            cold_on, TraceKind.COLD, torch.where(
                ev_timer, TraceKind.TIMER,
                torch.where(ev_arr, TraceKind.ARRIVAL, -1))))
        rid = torch.where(ev_slot, rid_done, torch.where(ev_arr, rid_a, -1))
        if timers:
            rid = torch.where(ev_timer, rid_t, rid)
        rec.append(_trace_record(
            ctx, s, pre, kind, rid, j_done, ev_slot, exec_on, t_ev, e_done,
            torch.full_like(na, -1), s["q_len"].sum(1), ctx.cap_mask))
    s["stall"] = torch.where(
        active & ~live, 1,
        torch.where(active & (s["iters"] >= max_iters), 2, s["stall"]))


def _trace_pre(s, q0):
    """What an event's trace record compares with after the event: the
    counters of `_TRACE_CTRS` that ``s`` has, and ``q0``, the event
    node's queue total before it."""
    pre = {k: s[k].clone() for k in _TRACE_CTRS if k in s}
    pre["q0"] = q0.clone()
    return pre


def _trace_record(ctx, s, pre, kind, rid, j_done, ev_slot, exec_on, t_ev,
                  e_done, node, qlen, capm, churn=None):
    """One step's trace records, (L, TR_RI) int32 and (L, TR_RF) f64, as
    the JAX engines stage them (`repro_torch.telemetry.rail`): ``kind``
    (-1 on a lane that made no progress), ``rid`` and the function (the
    slot's on a slot event, else the request's), the event's ``node``,
    TR_AUX from the counter changes against ``pre`` (`_trace_pre`; on an
    EXEC the attempt's outcome, else the arrival-class bits; ``churn`` =
    (ev_churn, node_up) overrides it with the toggle's direction), the
    event node's queue total ``qlen`` and its busy and warm slots among
    ``capm`` in ``s`` after the event, the lane's ``iters``, the event's
    time and, on an EXEC, its execution time."""
    def up(k):
        return (s[k] - pre[k]) > 0 if k in pre else torch.zeros_like(ev_slot)

    fn = torch.where(ev_slot, j_done,
                     torch.where(rid >= 0, ctx.fn_at(rid), -1))
    aux_ex = (torch.where(up("exh"), 2,
                          torch.where(up("failed") | up("tmo"), 1, 0))
              + torch.where(up("tmo"), 4, 0))
    aux = (torch.where(up("cold"), 1, 0)
           + torch.where(qlen > pre["q0"], 2, 0)
           + torch.where(up("shed"), 4, 0) + torch.where(up("ovf"), 8, 0))
    aux = torch.where(exec_on, aux_ex, aux)
    if churn is not None:
        aux = torch.where(churn[0], churn[1].to(aux.dtype), aux)
    st = s["slot_state"]
    busy = ((st == BUSY) & capm).sum(1)
    warm = ((st == IDLE) & (s["slot_fn"] >= 0) & capm).sum(1)
    rec_i = torch.stack([kind, rid, fn, node.to(kind.dtype), aux,
                         qlen.to(kind.dtype), busy, warm, s["iters"]],
                        1).to(torch.int32)
    rec_f = torch.stack([t_ev, torch.where(exec_on, e_done, 0.0)], 1)
    return rec_i, rec_f


def flush_trace(rec) -> None:
    """Hand one segment's records (`_event_step`'s list of per-step
    pairs) to the active sink as a (L, SEG, ·) block (one copy back)."""
    from repro_torch.telemetry import profiling
    from repro_torch.telemetry.rail import active_sink
    sink = active_sink()
    if sink is not None and rec:
        with profiling.phase("copy"):
            sink.append(torch.stack([r[0] for r in rec], 1).cpu().numpy(),
                        torch.stack([r[1] for r in rec], 1).cpu().numpy())
    rec.clear()


def simulate(fn_id, arrival, exec_time, t_cold, t_evict, trace_ix,
             cap_mask, beta, prior, threshold=0.1, *, kernel, n_fns,
             capacity, queue_cap, stream=False, window=0, tl_bins=0,
             tl_bucket=60.0, n_live=None, deadlines=None, rs_nfail=None,
             rs_tmo=None, rs_key=None, resil=None,
             trace=False) -> Dict[str, torch.Tensor]:
    """Lane-batched engine (counterpart of `jax_engine._simulate`).

    Trace arrays are shared (T, ...) tensors; ``trace_ix`` (L,) int64,
    ``cap_mask`` (L, C) bool and ``beta`` (L,) f64 carry the lane
    dimension. All tensors must sit on one device; the run stays
    there. ``threshold`` is the timer policies' delay: a timer fires
    ``threshold`` seconds after its arrival or re-arm. Returns per-lane
    counters (int32), f64 sums and the histogram; in exact mode also
    start/completion (L, N).

    Options (see the module docstring): ``n_live`` (L,) ints, ragged
    prefixes; ``deadlines`` (F,) seconds, adds ``deadline_miss`` (L, F);
    ``tl_bins`` > 0 with ``tl_bucket`` seconds a bin, adds ``tl_count``,
    ``tl_resp_sum`` and ``tl_exec_sum`` (L, tl_bins); ``window`` >= 0 is
    accepted and changes nothing. ``trace`` (bool) also writes each
    lane's trace records (`repro_torch.telemetry.rail`) to the active
    sink of a `repro_torch.telemetry.collect` scope, through the traced
    variant of the route below; the results are those of the untraced
    run, bitwise.

    The resilience layer (``resil`` with its (T, N) outcome operands
    ``rs_nfail``, ``rs_tmo``, ``rs_key``; see
    `repro_torch.cluster.engine.simulate_cluster`) runs each lane as a
    one-node lane of the K-node engine, whose results are the JAX
    single-node engine's bitwise; it adds ``failed``, ``timed_out``,
    ``retried``, ``shed`` and ``failed_exhausted`` (L,).

    Otherwise a built-in policy goes to the event-loop kernel (one launch
    a call on a CUDA device, its plain version `simulate_eager` on the
    CPU); any other `PolicyKernel` runs `simulate_eager`. The route is
    chosen by the policy's type, never by a failed build."""
    if window < 0 or tl_bins < 0:
        raise ValueError(f"simulate: window and tl_bins must be >= 0, got "
                         f"{window} and {tl_bins}")
    if resil is not None:
        return _simulate_one_node(
            fn_id, arrival, exec_time, t_cold, t_evict, trace_ix, cap_mask,
            beta, prior, threshold, kernel=kernel, n_fns=n_fns,
            capacity=capacity, queue_cap=queue_cap, stream=stream,
            tl_bins=tl_bins, tl_bucket=tl_bucket, n_live=n_live,
            deadlines=deadlines, rs_nfail=rs_nfail, rs_tmo=rs_tmo,
            rs_key=rs_key, resil=resil, trace=trace)
    from repro_torch.kernels import event_loop as K0
    f64, i64 = torch.float64, torch.int64
    dev = fn_id.device
    args = (fn_id.to(i64).contiguous(),
            arrival.to(f64).contiguous(), exec_time.to(f64).contiguous(),
            t_cold.to(f64).contiguous(), t_evict.to(f64).contiguous(),
            trace_ix.to(i64).contiguous(),
            cap_mask.to(torch.bool).contiguous(), beta.to(f64).contiguous(),
            float(prior))
    if n_live is not None:
        n_live = _as_tensor(n_live, i64, dev).contiguous()
    kw = dict(kernel=kernel, n_fns=n_fns, capacity=capacity,
              queue_cap=queue_cap, stream=stream,
              threshold=float(threshold), tl_bins=int(tl_bins),
              tl_bucket=float(tl_bucket), n_live=n_live,
              deadlines=(None if deadlines is None
                         else _as_tensor(deadlines, f64, dev).contiguous()),
              trace=bool(trace))
    if K0.has_device_loop(kernel):
        return K0.event_loop(*args, **kw)     # checks n_live itself
    if n_live is not None:
        check_n_live(n_live, fn_id.shape[1])
    return simulate_eager(*args, **kw)


def _simulate_one_node(fn_id, arrival, exec_time, t_cold, t_evict,
                       trace_ix, cap_mask, beta, prior, threshold, *,
                       kernel, rs_nfail, rs_tmo, rs_key, resil, **kw):
    """`simulate` under resilience: every lane a one-node cluster (no
    delay, the router never asked) of `cluster.engine.simulate_cluster`,
    on the event-loop kernel's K-node variant on a card; its trace
    records carry node -1, as the single-node engine's."""
    from repro_torch.cluster.engine import simulate_cluster
    from repro_torch.cluster.routers import get_router
    dev = fn_id.device
    L = trace_ix.shape[0]
    ones = torch.ones((L,), dtype=torch.int64, device=dev)
    out = simulate_cluster(
        fn_id, arrival, exec_time, t_cold, t_evict, trace_ix,
        _as_tensor(cap_mask, torch.bool, dev)[:, None], beta, prior,
        threshold, kernel=kernel, routers=(get_router("jsq2"),),
        router_ix=ones - 1, n_nodes=ones, seeds=ones - 1,
        delays=torch.zeros((L, 1), dtype=torch.float64, device=dev),
        rs_nfail=rs_nfail, rs_tmo=rs_tmo, rs_key=rs_key, resil=resil,
        trace_node=False, **kw)
    del out["node_done"]
    return out


def check_n_live(n_live, n_requests: int) -> None:
    """Raise unless every live count lies in [0, N] (one host read)."""
    if bool(((n_live < 0) | (n_live > n_requests)).any()):
        raise ValueError(f"n_live must lie in [0, N = {n_requests}]")


def simulate_eager(fn_id, arrival, exec_time, t_cold, t_evict, trace_ix,
                   cap_mask, beta, prior, *, kernel, n_fns, capacity,
                   queue_cap, stream=False, threshold=0.1, n_live=None,
                   deadlines=None, tl_bins=0, tl_bucket=60.0, trace=False
                   ) -> Dict[str, torch.Tensor]:
    """The eager event loop: `_event_step` over every lane, SEG steps
    between host checks, the policy's hooks run gated for every lane on
    every step. Inputs as `simulate` (int64 ``fn_id``, ``trace_ix`` and
    ``n_live``, f64 times, ``beta`` and ``deadlines``, bool
    ``cap_mask``); the plain version of the event-loop kernel and the
    route of every policy without one. With ``trace`` each segment's
    records go to the active sink (`flush_trace`)."""
    L = trace_ix.shape[0]
    N = fn_id.shape[1]
    F, C = n_fns, capacity
    dev = fn_id.device
    ctx = EngineCtx(
        fn_id=fn_id, arrival=arrival, exec_time=exec_time,
        t_cold_l=t_cold[trace_ix].contiguous(),
        t_evict_l=t_evict[trace_ix].contiguous(),
        trace_ix=trace_ix, cap_mask=cap_mask, beta=beta,
        prior=float(prior), f=F, c=C, q=queue_cap, stream=stream,
        threshold=float(threshold), n_live=n_live, deadlines=deadlines,
        tl_bins=tl_bins, tl_bucket=tl_bucket)
    s = _init_state(kernel, L, C, F, N, stream, dev,
                    deadlines=deadlines is not None, tl_bins=tl_bins)
    max_iters = max_events(N)

    def running():
        return bool(((s["done"] < ctx.n_live) & (s["stall"] == 0)).any())

    rec = [] if trace else None
    while running():   # one host sync per SEG events
        for _ in range(SEG):
            _event_step(ctx, kernel, s, max_iters, rec)
        if trace:
            flush_trace(rec)

    i32 = torch.int32
    out = dict(cold_starts=s["cold"].to(i32), cold_time=s["cold_t"],
               evictions=s["evict"].to(i32), evict_time=s["evict_t"],
               overflow=s["ovf"].to(i32), stalled=s["stall"].to(i32),
               n_events=s["iters"].to(i32), done=s["done"].to(i32),
               resp_sum=s["r_sum"], slow_sum=s["s_sum"],
               max_response=s["r_max"], resp_hist=s["hist"].to(i32))
    if tl_bins:
        out["tl_count"] = s["tl_cnt"]
        out["tl_resp_sum"] = s["tl_resp"]
        out["tl_exec_sum"] = s["tl_exec"]
    if deadlines is not None:
        out["deadline_miss"] = s["dl_miss"]
    if not stream:
        out["start"] = s["start"][:, :N]
        out["completion"] = s["completion"][:, :N]
    return out


def max_events(n_requests: int) -> int:
    """A lane stalls (code 2) once it has processed this many events."""
    return 256 * n_requests + 4096


def _as_tensor(x, dtype, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dtype=dtype, device=dev)
    return torch.tensor(np.asarray(x), dtype=dtype, device=dev)


# ------------------------------------------------------------ public API
def simulate_policy(fn_id, arrival, exec_time, t_cold, t_evict, *,
                    policy: str = "esff", n_fns: int, capacity: int,
                    queue_cap: int = 512, beta=None, prior: float = 0.1,
                    threshold: float = 0.1, cap_mask=None,
                    stream: bool = False, window: int = 0,
                    tl_bins: int = 0, tl_bucket: float = 60.0, device=None
                    ) -> Dict[str, torch.Tensor]:
    """Run ``policy`` over one (arrival-sorted) request stream on
    ``device`` (CUDA unless ``device="cpu"``). Counterpart of
    `jax_engine.simulate_policy_jax`; inputs may be numpy arrays or
    tensors. Returns the counters, the streamed sums and the
    histogram, plus per-request start/completion unless ``stream``,
    and the timeline (``tl_*``) when ``tl_bins`` > 0."""
    from repro_torch.api.registry import get_kernel
    dev = resolve_device(device)
    kernel = get_kernel(policy)
    if beta is None:
        beta = kernel.default_beta
    if cap_mask is None:
        cap_mask = np.ones((capacity,), bool)
    f64 = torch.float64
    share = lambda x, dt: _as_tensor(x, dt, dev)[None]  # noqa: E731
    out = simulate(share(fn_id, torch.int64), share(arrival, f64),
                   share(exec_time, f64), share(t_cold, f64),
                   share(t_evict, f64),
                   torch.zeros((1,), dtype=torch.int64, device=dev),
                   share(cap_mask, torch.bool),
                   torch.full((1,), float(beta), dtype=f64, device=dev),
                   prior, threshold, kernel=kernel, n_fns=n_fns,
                   capacity=capacity, queue_cap=queue_cap, stream=stream,
                   window=window, tl_bins=tl_bins, tl_bucket=tl_bucket)
    return {k: v[0] for k, v in out.items()}


def simulate_policy_from_trace(trace: Trace, policy: str, capacity: int,
                               *, beta=None, queue_cap: int = 1024,
                               prior: float = 0.1, threshold: float = 0.1,
                               device=None) -> Dict[str, np.ndarray]:
    """Trace-object convenience wrapper (exact per-request mode);
    returns numpy arrays plus ``response`` and ``mean_response``."""
    a = trace.to_arrays()
    out = simulate_policy(
        a["fn_id"], a["arrival"], a["exec_time"], a["cold_start"],
        a["evict"], policy=policy, n_fns=trace.n_functions,
        capacity=capacity, queue_cap=queue_cap, beta=beta, prior=prior,
        threshold=threshold, device=device)
    out = {k: v.cpu().numpy() for k, v in out.items()}
    out["response"] = out["completion"] - a["arrival"]
    out["mean_response"] = float(out["response"].mean())
    return out


def sweep_metrics(fn, arr, ex, cold, ev, tix, masks, betas, prior,
                  threshold=0.1, *, kernel, n_fns, capacity, queue_cap,
                  stream=True, keep_responses=False, n_live=None,
                  deadlines=None, window=0, tl_bins=0, tl_bucket=60.0,
                  rs_nfail=None, rs_tmo=None, rs_key=None, resil=None,
                  trace=False) -> Dict[str, torch.Tensor]:
    """Lane-batched run + metric reduction (counterpart of
    `jax_engine._sweep_metrics`). Means and slowdowns come from the
    streamed sums in both modes; p99 is exact in exact mode (linear
    interpolation, as ``jnp.percentile``) and one-bin-accurate from the
    histogram in streaming mode. ``keep_responses`` (exact mode only)
    also returns the (L, N) per-request responses. With ``n_live`` (L,)
    the means and quantiles reduce over each lane's live prefix; under
    resilience (``resil`` and its operands, as `simulate`) over the
    successes. ``trace`` as `simulate`'s."""
    if keep_responses and stream:
        raise ValueError("keep_responses requires stream=False")
    out = simulate(fn, arr, ex, cold, ev, tix, masks, betas, prior,
                   threshold, kernel=kernel, n_fns=n_fns,
                   capacity=capacity, queue_cap=queue_cap, stream=stream,
                   window=window, tl_bins=tl_bins, tl_bucket=tl_bucket,
                   n_live=n_live, deadlines=deadlines, rs_nfail=rs_nfail,
                   rs_tmo=rs_tmo, rs_key=rs_key, resil=resil, trace=trace)
    arr_l = None if stream else arr.to(torch.float64)[tix]
    return reduce_metrics(out, arr_l, fn.shape[1], n_live, stream,
                          keep_responses, resil=resil is not None)


def reduce_metrics(out, arr_l, N: int, n_live, stream: bool,
                   keep_responses: bool, resil: bool = False
                   ) -> Dict[str, torch.Tensor]:
    """`sweep_metrics`' reduction of a run's outputs ``out`` over ``N``
    requests a lane (each lane's live prefix with ``n_live``); in exact
    mode ``arr_l`` (L, N) holds the arrivals the responses are measured
    from. Under resilience (``resil``) the means and quantiles reduce over
    the successful completions (``done``; a shed or exhausted request's
    completion stays -1, its response NaN), and the layer's counters are
    kept."""
    if resil:
        den = torch.clamp_min(out["done"], 1).to(torch.float64)
        means = (out["resp_sum"] / den, out["slow_sum"] / den)
        nq = out["done"][:, None]
    elif n_live is None:
        # the reference's mean is XLA's a / N, which XLA folds into
        # a * (1 / N); spelled out here so the CPU and CUDA (which also
        # turns division by a Python scalar into a reciprocal multiply)
        # both give the reference's bits
        inv_n = 1.0 / N
        means = (out["resp_sum"] * inv_n, out["slow_sum"] * inv_n)
        nq = N
    else:
        # an array denominator: a plain IEEE division, as XLA's
        nl = _as_tensor(n_live, torch.int64, out["done"].device)
        den = torch.clamp_min(nl, 1).to(torch.float64)
        means = (out["resp_sum"] / den, out["slow_sum"] / den)
        nq = nl[:, None]
    if stream:
        p99 = hist_quantile(out["resp_hist"], 0.99, nq, out["max_response"])
    else:
        resp = out["completion"] - arr_l
        if resil:
            resp = torch.where(out["completion"] >= 0, resp, math.nan)
            p99 = percentile_nan(resp, 99.0)
        elif n_live is None:
            p99 = percentile_linear(resp, 99.0)
        else:
            p99 = percentile_live(resp, 99.0, nl)
    res = dict(mean_response=means[0], mean_slowdown=means[1],
               resp_sum=out["resp_sum"], slow_sum=out["slow_sum"],
               done=out["done"], p99_response=p99,
               max_response=out["max_response"],
               resp_hist=out["resp_hist"],
               cold_starts=out["cold_starts"], cold_time=out["cold_time"],
               evictions=out["evictions"], overflow=out["overflow"],
               stalled=out["stalled"], n_events=out["n_events"])
    for k in ("tl_count", "tl_resp_sum", "tl_exec_sum", "deadline_miss",
              "failed", "timed_out", "retried", "shed", "failed_exhausted"):
        if k in out:
            res[k] = out[k]
    if keep_responses:
        res["response"] = resp
    return res


def goodput(done, n):
    """Fraction of the offered requests that completed successfully,
    ``done / n``, in numpy outside the engine (as `jax_engine.goodput`),
    so that every tier derives it alike."""
    return (np.asarray(done, np.float64)
            / np.maximum(np.asarray(n, np.float64), 1.0))


def slo_attainment(deadline_miss, done):
    """Fraction of completed requests that met their function's deadline:
    ``1 - deadline_miss.sum(-1) / done``, in numpy outside the engine
    (as `jax_engine.slo_attainment`), so that every tier derives it
    alike."""
    miss = np.asarray(deadline_miss)
    d = np.maximum(np.asarray(done, dtype=np.float64), 1.0)
    return 1.0 - miss.sum(axis=-1) / d


def lane_chunk_for(setting: Optional[int], device: torch.device) -> int:
    """Lanes per engine call: ``setting`` when given, else the
    per-device `LANE_CHUNKS` entry."""
    if setting is None:
        return LANE_CHUNKS[device.type]
    if isinstance(setting, bool) or not isinstance(setting, int):
        raise ValueError(
            f"lane_chunk must be an int or None, got {setting!r} (the "
            "'auto' probe is not ported)")
    return max(1, setting)
