"""The dynamic-routing cluster engine: K nodes in one event loop a lane
(counterpart of `repro.cluster.engine`).

A dynamic router reads live cluster state at every arrival, so the
routing decision lives inside the event loop. The loop generalises the
single-node engine (`repro_torch.core.engine`) to K co-simulated nodes a
lane:

* **slots** are a (L, K, C) node-major rail, and the next event is the
  first-index argmin over [BUSY K·C | COLD K·C | timers K·F | re-arms K·F
  (timer policies) | in-flight heads K (a lane with delay) | orphan 1 |
  toggles K (a lane with churn) | ARRIVAL], so the same-time class order
  EXEC < COLD < TIMER < NODE_ARRIVAL < REROUTE < CHURN < ARRIVAL and the
  tie-break inside a class (node-major) extend the single-node engine's;
* **queues** are per-(node, function) FIFOs on a link rail ``nxt`` (one
  successor rid a request): which arrivals of f_j reach node k depends on
  the state, so the single-node engine's positional cursors do not
  apply. Each link is written once, when its successor is pushed, and
  read when the head is popped. The JAX package stages these writes in a
  segment overlay to spare XLA copies; results do not depend on it, and
  here every write goes straight to the rail;
* **timer rails** (OpenWhisk-v2) ride a second chain ``tnx`` over node
  arrivals: per (node, function) the chain's last rid ``la_rid``, the
  arrivals ``arr_cnt`` and the consumed entries ``tmr_seq``, so the
  chain reproduces the single-node positional rail event for event (arm
  at the node-local arrival, fire in arrival order, consume silently on
  a direct dispatch, gate a no-op fire by the queue-head check);
* **network delay** (a lane whose ``delays`` row is not all zero) rides a
  third chain ``dnx``: the router decides at the raw ARRIVAL, the request
  joins its node's in-flight FIFO, stamped with its landing time
  (``land_t``), and arrives ``delay_k`` later as a NODE_ARRIVAL event;
  the node's policy, timers and response accounting run on the
  node-local clock (response from the delayed arrival). A
  `DelaySchedule` makes the delay a node's piecewise-constant function
  of time (`sched_delay`), sampled at the raw arrival for the landing and
  the response, and at the decision for slo_aware's delay term;
* **churn** adds a toggle event a node off its row of ``churn_t`` (the
  cursor ``ch_ix``, even: up). NODE_DOWN drains the node (its busy
  slots' requests by ascending rid, then its queues function-major) onto
  the lane's park FIFO, chained on ``nxt``, and resets its slots, queues
  and policy state (its estimators survive); one REROUTE event a parked
  request sends the park head through the router while a node is up.
  Routers see the ``up`` mask and a pick of a down node is re-aimed at
  the lowest-id up node; an arrival while every node is down parks, and
  so does a request landing on a node that went down in flight. A churn
  lane folds at EXEC_DONE (a drained dispatch never completes), measures
  responses from the raw arrival, and under delay stamps a re-routed
  orphan's ``land_t`` at its re-send (it pays its new node's delay then);
* **resilience** (a call with ``resil``: failure injection, timeouts,
  retries, shedding; `repro_torch.core.resilience`) reads each request's
  pre-planned outcome (``rs_nfail``, ``rs_tmo``, ``rs_key``) at its
  EXEC_DONE: the attempt counter ``att`` rises at each dispatch, and an
  attempt succeeds iff ``att > n_fail``. Only successes count ``done``,
  fold and count ``node_done``; a failed attempt either exhausts its
  budget or joins the lane's retry FIFO (chained on ``nxt``, eligible
  ``backoff`` later, never overtaking), whose head is a RETRY event
  routed like an arrival (parked while every node is down). A push onto
  a full queue is counted in ``ovf``, sheds the arrival, or sheds the
  queue's head (``shed_oldest``). A lane then ends when every request is
  terminal (``term``: done, exhausted or shed). Every lane of such a
  call folds at EXEC_DONE and measures from the raw arrival, as a churn
  lane does, and a drained attempt gives its attempt back;
* **the circuit breaker** (a lane whose router is a `BreakerRouter`)
  keeps a tumbling window of completed attempts a node (``cbr_n``,
  ``cbr_f``) and its reopen time ``cbr_until``, updated at the node's
  EXEC_DONE and read by the router;
* **estimators** are node-local: each node learns from its own
  completions only, with the node's global mean, then the prior, as
  fallback.

Policy hooks (`repro_torch.core.policies`) run unmodified: each event the
event's node is sliced into a single-node view (the slot, timer and
arrival phases are mutually exclusive, and the router reads the state
before the event), the hooks run on it through `ClusterNodeCtx`, and the
view is written back. A lane may have fewer nodes than the call's K (its
``n_nodes``): its padding nodes have no usable slot and never hold an
event, and routers skip them. With one node and zero delay a lane is
bitwise the single-node engine, timer policies included, and under resilience
the single-node engine's resilient run (which `engine.simulate` lowers
onto K = 1 lanes here).

`simulate_cluster` sends a built-in policy with a built-in router to the
event-loop kernel's K-node variant (`repro_torch.kernels.event_loop.
cluster_loop`: one launch a lane chunk on a card, `simulate_cluster_eager`
on the CPU); any other policy or router runs `simulate_cluster_eager`.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from repro_torch.cluster.routers import (BreakerRouter, ClusterView,
                                         has_device_route)
from repro_torch.core import engine as E
from repro_torch.core.engine import (BIG, BUSY, COLD, HIST_BINS, I32_MAX,
                                     IDLE, EngineCtx, _fold_event, _hit)
from repro_torch.core.resilience import backoff_torch
from repro_torch.telemetry.rail import TraceKind

# per-node state, sliced to the event's node before the hooks run (the
# timer and in-flight keys and the policy's extra state are added when
# they exist)
_NODAL = ("slot_fn", "slot_state", "slot_ready", "slot_req", "slot_used",
          "slot_seq", "q_len", "q_head_rid", "q_tail_rid", "q_tot",
          "est_sum", "est_n", "gn", "g_sum")
_NODAL_TMR = ("arr_cnt", "tmr_seq", "tmr_rid", "tmr_next", "rearm_t",
              "rearm_rid", "la_rid")
_NODAL_PEND = ("pend_head", "pend_tail", "pend_len")
_COUNTERS = ("next", "done", "iters", "stall", "seq", "cold", "evict",
             "ovf")
# the resilience layer's tallies: terminal requests (done, exhausted or
# shed), failed and timed-out attempts, retries, sheds, exhausted ones
_RESIL_COUNTERS = ("term", "failed", "tmo", "retried", "shed", "exh")
_RESIL_OUT = (("failed", "failed"), ("timed_out", "tmo"),
              ("retried", "retried"), ("shed", "shed"),
              ("failed_exhausted", "exh"))
_SUMS = ("cold_t", "evict_t", "r_sum", "s_sum", "r_max")

# The state that scales with the trace length N, by name, with the reason
# it may: of the eager K-node loop (`_init_state`, (L, N + 1) rails whose
# last column takes disabled writes) and of the event-loop kernel's
# K-node launches (`kernels.event_loop._ClusterResults`, `_TraceBuffers`,
# (L, N) rails). Every other tensor of either is O(K (F + C) + HIST_BINS)
# a lane. Metadata: no loop reads it; `repro_torch.analysis` holds the
# allocations to it in both directions.
CARRY_RAILS = {
    "nxt": "the per-(node, function) FIFO successor rid (also the park "
           "and retry FIFOs): a router decides at run time which node "
           "queues a request, so the single-node positional cursors do "
           "not apply and the queue is a chain of one link a request.",
    "tnx": "OpenWhisk-v2's timer chain over node arrivals, one link a "
           "request (the same argument as `nxt`).",
    "dnx": "the in-flight chain of a lane with network delay: requests "
           "sent to a node and not yet landed, one link a request.",
    "links": "the kernel's three chains `nxt`, `tnx` and `dnx` as one "
             "(L, 3, N) int32 tensor (each lane's chains in its own "
             "rows).",
    "land_t": "the landing time of each request in flight (a lane with "
              "delay), stamped at its send and at a churn re-send.",
    "att": "the resilience layer's attempts started a request.",
    "rt_t": "the resilience layer's retry eligibility time a request "
            "(its backoff target).",
    "node_of": "exact mode with delay records each request's node: an "
               "output record, not loop bookkeeping.",
    "start": "exact mode's per-request dispatch time (an output).",
    "completion": "exact mode's per-request completion time (an output).",
    "tr_i": "the K-node kernel's traced window: the same contract as "
            "`repro_torch.core.engine.CARRY_RAILS['tr_i']`, sized a lane "
            "by `lane_trace_capacity`.",
    "tr_f": "the traced window's float64 half.",
}


def sched_delay(t, dt, dv, dp):
    """Piecewise-constant `DelaySchedule` lookup elementwise over ``t``
    (counterpart of `repro.cluster.engine._sched_delay`): the value of
    the last step at or before ``t``, ``t`` taken modulo ``dp`` where
    ``dp > 0``. ``dt`` / ``dv`` are the `BIG`-padded step times and
    values, shaped ``t.shape + (D,)``; ``dp`` has ``t.shape``. The
    modulo is ``fmod``, exact for positive operands and equal to
    ``jnp.mod`` there."""
    per = torch.where(dp > 0, dp, 1.0)
    tt = torch.where(dp > 0, torch.fmod(t, per), t)
    ix = ((tt[..., None] >= dt).sum(-1) - 1).clamp(0, dt.shape[-1] - 1)
    return dv.gather(-1, ix[..., None])[..., 0]


class ClusterNodeCtx(EngineCtx):
    """Single-node view ctx over the event's node of each lane
    (counterpart of `repro.cluster.engine.ClusterNodeCtx`). The engine
    sets ``cap_mask`` (L, C), ``delay`` (L,) and, when a lane has a delay
    schedule, ``dsched`` (the event node's step times, values and
    period) before each event. Reads go to the full trace; `arrival_at`
    is the node-local clock on a lane with delay that is not in direct
    mode (a churn lane, or any lane under resilience, measures from the
    raw arrival); the queue and timer ops work on the link rails ``nxt``
    and ``tnx`` (L, N + 1) of the state, whose last column takes the
    disabled writes. Under resilience (``resil``, with the (T, N) outcome
    operands ``rs``) the queue push takes the shed mode, and the trace's
    outcome rows are read as the trace's columns are."""

    def __init__(self, *, lane_delay, lane_direct, lane_var, resil=None,
                 rs=None, **kw):
        super().__init__(positional=False, **kw)
        self.lane_delay = lane_delay     # (L,) bool: the lane has delay
        self.lane_var = lane_var         # (L,) bool: ... a schedule
        # (L,) bool: responses from the node-local arrival
        self.shift = lane_delay & ~lane_direct
        if bool(lane_direct.any()):
            self.fold_mask = ~lane_direct  # direct lanes fold at EXEC_DONE
        self.delay = None                # (L,) f64, the event's node's
        self.dsched = None               # its schedule rows, or None
        self.has_resil = resil is not None
        self.defer_completion = self.has_resil   # completion on success
        self.shed_mode = 0 if resil is None else resil[1]
        if rs is not None:
            self._nf, self._tm, self._ky = (x.reshape(-1) for x in rs)

    def nfail_at(self, rid):
        return self._nf[self._rid(rid)]

    def tmo_at(self, rid):
        return self._tm[self._rid(rid)]

    def key_at(self, rid):
        return self._ky[self._rid(rid)]

    def node_delay(self, t):
        """The event node's delay at ``t`` (its schedule's on a lane
        with one, its constant otherwise)."""
        if self.dsched is None:
            return self.delay
        return torch.where(self.lane_var, sched_delay(t, *self.dsched),
                           self.delay)

    def arrival_at(self, rid):
        a = super().arrival_at(rid)
        return torch.where(self.shift, a + self.node_delay(a), a)

    def rail_at(self, rail, rid):
        """``rail[l, rid[l]]`` per lane, rid clipped to [0, N)."""
        return rail[self.lanes, rid.clamp(0, self.N - 1)]

    def link(self, s, rail, at, rid, on):
        """``rail[l, at[l]] = rid[l]`` where ``on`` (column N otherwise)."""
        s[rail][self.lanes, torch.where(on, at, self.N)] = rid

    def q_push(self, s, fn, rid, on):
        """Append ``rid`` to ``fn``'s queue: the link from the old tail,
        the tail, the head when the queue was empty, the length and the
        node's total. A push onto a full backlog is dropped and counted in
        ``ovf``, or under resilience as the shed mode says: ``shed`` drops
        the arrival, ``shed_oldest`` the queue's head to admit it (each
        shed request is terminal). Returns whether it pushed."""
        q0 = self.row(s["q_len"], fn, self.F)
        full = q0 >= self.Q
        if self.shed_mode == 2:
            evict = on & full
            hsucc = self.rail_at(s["nxt"], self.row(s["q_head_rid"], fn,
                                                    self.F))
            m = _hit(evict, fn, self.ar_f)
            s["q_head_rid"] = torch.where(m, hsucc[:, None], s["q_head_rid"])
            s["q_len"] = s["q_len"] - m.to(torch.int32)
            s["q_tot"] = s["q_tot"] - evict.to(torch.int32)
            s["shed"] = s["shed"] + evict
            s["term"] = s["term"] + evict
            do = on
            was_empty = (q0 - evict.to(torch.int32)) == 0
        else:
            do = on & ~full
            was_empty = q0 == 0
            if self.shed_mode == 1:
                s["shed"] = s["shed"] + (on & full)
                s["term"] = s["term"] + (on & full)
            else:
                s["ovf"] = s["ovf"] + (on & full)
        self.link(s, "nxt", self.row(s["q_tail_rid"], fn, self.F), rid,
                  do & ~was_empty)
        s["q_head_rid"] = torch.where(_hit(do & was_empty, fn, self.ar_f),
                                      rid[:, None], s["q_head_rid"])
        s["q_tail_rid"] = torch.where(_hit(do, fn, self.ar_f), rid[:, None],
                                      s["q_tail_rid"])
        s["q_len"] = s["q_len"] + _hit(do, fn, self.ar_f)
        s["q_tot"] = s["q_tot"] + do
        return do

    def q_consume_direct(self, s, fn, on):
        """A directly dispatched arrival never enters the chain."""

    def q_pop(self, s, fn, on):
        """Consume the head of ``fn``'s queue and return its rid; the
        head moves to its successor on the rail (-1 when the queue
        empties)."""
        rid = self.row(s["q_head_rid"], fn, self.F)
        succ = torch.where(self.row(s["q_len"], fn, self.F) > 1,
                           self.rail_at(s["nxt"], rid), -1)
        m = _hit(on, fn, self.ar_f)
        s["q_head_rid"] = torch.where(m, succ[:, None], s["q_head_rid"])
        s["q_len"] = s["q_len"] - m.to(torch.int32)
        s["q_tot"] = s["q_tot"] - on.to(torch.int32)
        return rid

    def arm_timer(self, s, fn, rid, t, pushed, on):
        """The original timer of the node arrival ``rid`` of ``fn`` (the
        newest entry of the (node, fn) chain): at the head of an idle
        rail a pushed arrival arms ``t + threshold``, one that was not
        pushed is consumed silently; behind a busy rail it stays chained
        and fires later."""
        head = (self.row(s["tmr_seq"], fn, self.F)
                == self.row(s["arr_cnt"], fn, self.F) - 1)
        m = _hit(on & head & pushed, fn, self.ar_f)
        s["tmr_rid"] = torch.where(m, rid[:, None], s["tmr_rid"])
        s["tmr_next"] = torch.where(m, (t + self.threshold)[:, None],
                                    s["tmr_next"])
        s["tmr_seq"] = s["tmr_seq"] + _hit(on & head & ~pushed, fn,
                                           self.ar_f)


def has_cluster_loop(kernel, routers: Sequence) -> bool:
    """Whether the event-loop kernel's K-node variant runs ``kernel``
    with every router of ``routers``: a built-in policy class and the
    built-in router classes, by exact type."""
    from repro_torch.kernels import event_loop as K0
    return K0.has_device_loop(kernel) and all(
        has_device_route(r) for r in routers)


class Topology:
    """The lanes' clusters of one run, and the modes they switch on: each
    lane's node count, capacity masks, router, seed and constant delays;
    under churn its (K, E) toggle times (`BIG`-padded: a lane with none
    keeps the plain loop), under a delay schedule its (K, D) steps, values
    and periods (a lane with a second step is time-varying). A lane has
    delay when a constant delay is not zero or its delay varies, as the
    JAX package's ``has_delay``. A lane is in direct mode (folds at
    EXEC_DONE, measures from the raw arrival) under churn and, in a call
    with ``resil``, always; a lane whose router is a `BreakerRouter` keeps
    its breaker's volume, trip point and cooldown."""

    def __init__(self, routers, router_ix, n_nodes, seeds, delays, cap_mask,
                 churn_t=None, dtimes=None, dvals=None, dper=None,
                 resil=None):
        self.routers, self.router_ix = routers, router_ix
        self.n_nodes, self.seeds, self.delays = n_nodes, seeds, delays
        self.cap_mask = cap_mask
        L, Kx = cap_mask.shape[:2]
        dev = cap_mask.device
        self.node_ok = torch.arange(Kx, device=dev) < n_nodes[:, None]
        self.churn_t = churn_t
        self.lane_churn = (torch.zeros((L,), dtype=torch.bool, device=dev)
                           if churn_t is None
                           else (churn_t < BIG).flatten(1).any(1))
        self.any_churn = bool(self.lane_churn.any())
        self.dtimes, self.dvals, self.dper = dtimes, dvals, dper
        self.lane_var = (torch.zeros((L,), dtype=torch.bool, device=dev)
                         if dtimes is None
                         else (dtimes[:, :, 1:] < BIG).flatten(1).any(1))
        self.any_var = bool(self.lane_var.any())
        self.lane_delay = (delays > 0).any(1) | self.lane_var
        self.any_delay = bool(self.lane_delay.any())
        self.resil = resil
        self.lane_direct = self.lane_churn | (resil is not None)
        brk = [type(r) is BreakerRouter for r in routers]
        self.any_brk = any(brk)
        if self.any_brk:
            def per_lane(vals, dt):
                return torch.tensor(vals, dtype=dt, device=dev)[router_ix]
            self.lane_brk = per_lane(brk, torch.bool)
            self.brk_volume = per_lane(
                [getattr(r, "volume", 1) for r in routers], torch.int64)
            self.brk_trip_at = per_lane(
                [getattr(r, "trip_at", 1) for r in routers], torch.int64)
            self.brk_cooldown = per_lane(
                [getattr(r, "cooldown", 0.0) for r in routers],
                torch.float64)

    def max_events(self, N: int):
        """(L,) the events after which a lane stalls (code 2): the
        single-node bound, plus (4 N + 64) K E on a churn lane (every
        toggle may orphan a nodeful of requests), E its toggle columns as
        the JAX package's operand has them (its most toggles + 1); times
        ``max_attempts`` under resilience (each request may run and
        re-enter that often)."""
        out = torch.full_like(self.n_nodes, E.max_events(N))
        if self.any_churn:
            width = (self.churn_t < BIG).sum(2).amax(1) + 1
            out = torch.where(self.lane_churn,
                              out + (4 * N + 64) * self.n_nodes * width, out)
        if self.resil is not None:
            out = out * self.resil[0]
        return out


def _init_state(kernel, L, Kx, C, F, N, stream, dev, timers, topo,
                deadlines, tl_bins) -> Dict[str, torch.Tensor]:
    i64, i32, f64 = torch.int64, torch.int32, torch.float64

    def full(shape, v, dt):
        return torch.full(shape, v, dtype=dt, device=dev)

    s = dict(
        slot_fn=full((L, Kx, C), -1, i64),
        slot_state=full((L, Kx, C), IDLE, i64),
        slot_ready=full((L, Kx, C), BIG, f64),
        slot_req=full((L, Kx, C), -1, i64),
        slot_used=full((L, Kx, C), 0.0, f64),
        slot_seq=full((L, Kx, C), I32_MAX, i64),
        q_len=full((L, Kx, F), 0, i32),
        q_head_rid=full((L, Kx, F), -1, i64),
        q_tail_rid=full((L, Kx, F), -1, i64),
        q_tot=full((L, Kx), 0, i32),
        est_sum=full((L, Kx, F), 0.0, f64),
        est_n=full((L, Kx, F), 0, i32),
        gn=full((L, Kx), 0, i64),
        g_sum=full((L, Kx), 0.0, f64),
        node_done=full((L, Kx), 0, i32),
        nxt=full((L, N + 1), -1, i64),
        hist=full((L, HIST_BINS), 0, i64),
    )
    for k in _COUNTERS:
        s[k] = full((L,), 0, i64)
    for k in _SUMS:
        s[k] = full((L,), 0.0, f64)
    if timers:
        for k in ("arr_cnt", "tmr_seq"):
            s[k] = full((L, Kx, F), 0, i32)
        for k in ("tmr_rid", "rearm_rid", "la_rid"):
            s[k] = full((L, Kx, F), -1, i64)
        for k in ("tmr_next", "rearm_t"):
            s[k] = full((L, Kx, F), BIG, f64)
        s["tnx"] = full((L, N + 1), -1, i64)
    if topo.any_delay:
        s["pend_head"] = full((L, Kx), -1, i64)
        s["pend_tail"] = full((L, Kx), -1, i64)
        s["pend_len"] = full((L, Kx), 0, i32)
        s["dnx"] = full((L, N + 1), -1, i64)
        # the landing time of each request in flight, stamped at its send
        s["land_t"] = full((L, N + 1), 0.0, f64)
    if topo.any_churn:
        # the availability cursor (even: up) a node, and the lane's park
        # FIFO of requests orphaned by a NODE_DOWN or arriving while
        # every node is down (chained on ``nxt``; park_t is its head's
        # eligibility time), and what the lane's churn did
        s["ch_ix"] = full((L, Kx), 0, i64)
        s["park_head"] = full((L,), -1, i64)
        s["park_tail"] = full((L,), -1, i64)
        s["park_len"] = full((L,), 0, i32)
        s["park_t"] = full((L,), BIG, f64)
        s["toggles"] = full((L,), 0, i64)
        s["reroutes"] = full((L,), 0, i64)
    if topo.resil is not None:
        # the attempts started a request, its retry's eligibility, and the
        # lane's retry FIFO (chained on ``nxt``; r_fire its head's time)
        s["att"] = full((L, N + 1), 0, i64)
        s["rt_t"] = full((L, N + 1), 0.0, f64)
        s["r_head"] = full((L,), -1, i64)
        s["r_tail"] = full((L,), -1, i64)
        s["r_len"] = full((L,), 0, i32)
        s["r_fire"] = full((L,), BIG, f64)
        for k in _RESIL_COUNTERS:
            s[k] = full((L,), 0, i64)
    if topo.any_brk:
        # each node's breaker: the window's attempts and failures, and its
        # reopen time (0: closed)
        s["cbr_n"] = full((L, Kx), 0, i64)
        s["cbr_f"] = full((L, Kx), 0, i64)
        s["cbr_until"] = full((L, Kx), 0.0, f64)
        s["trips"] = full((L,), 0, i64)
    if not stream:
        for k in ("start", "completion"):
            s[k] = full((L, N + 1), -1.0, f64)
        if topo.any_delay:
            s["node_of"] = full((L, N + 1), 0, i32)
    if deadlines:
        s["dl_miss"] = full((L, F), 0, i32)
    if tl_bins:
        s["tl_cnt"] = full((L, tl_bins), 0, i32)
        s["tl_resp"] = full((L, tl_bins), 0.0, f64)
        s["tl_exec"] = full((L, tl_bins), 0.0, f64)
    extra = kernel.extra_state(L, C, F)
    for k, v in extra.items():
        if k in s:
            raise ValueError(f"policy {kernel.name!r}: extra_state key "
                             f"{k!r} collides with the engine's state")
        # one copy of the policy's per-server state a node
        s[k] = v.to(dev)[:, None].repeat((1, Kx) + (1,) * (v.dim() - 1))
    return s, tuple(extra)


def _route(ctx, s, topo, rid, t, up):
    """Each lane's router pick for the request ``rid`` at ``t`` on the
    state before the event, clipped to the lane's nodes; under churn
    (``up`` (L, K), False on a down node) re-aimed at the lowest-id up
    node when the pick is down, as the JAX package does."""
    delay_now = topo.delays
    if topo.any_var:
        Kx = topo.delays.shape[1]
        at = sched_delay(t[:, None].expand(-1, Kx), topo.dtimes,
                         topo.dvals, topo.dper)
        delay_now = torch.where(topo.lane_var[:, None], at, delay_now)
    g = ClusterView(q_len=s["q_len"], q_tot=s["q_tot"],
                    slot_fn=s["slot_fn"], slot_state=s["slot_state"],
                    cap_mask=topo.cap_mask, est_sum=s["est_sum"],
                    est_n=s["est_n"], node_gn=s["gn"],
                    node_gsum=s["g_sum"], t_cold=ctx.t_cold,
                    prior=ctx.prior, n_nodes=topo.n_nodes,
                    node_ok=topo.node_ok, seed=topo.seeds,
                    delay_now=delay_now, up=up,
                    brk_until=s.get("cbr_until"))
    j = ctx.fn_at(rid)
    k = None
    for i, r in enumerate(topo.routers):
        pick = r.pick(g, j, rid, t).to(torch.int64)
        k = pick if k is None else torch.where(topo.router_ix == i, pick, k)
    k = torch.minimum(k.clamp_min(0), topo.n_nodes - 1)
    if up is not None:
        k = torch.where(up[ctx.lanes, k], k,
                        torch.argmax(up.to(torch.int32), dim=1))
    return k


def _drain(ctx, v, ev_down, t_ev, extra0):
    """NODE_DOWN on the event's node (lanes ``ev_down``): its busy slots'
    requests in ascending rid order, then its queues function-major, are
    chained on ``nxt`` into the lane's park FIFO (empty at a NODE_DOWN:
    the node was up, so every parked request re-routed first), eligible
    at ``t_ev``; then the node's slots, queues and the policy's per-node
    state start afresh. Its estimators survive the outage."""
    N, F, C = ctx.N, ctx.F, ctx.C
    lanes = ctx.lanes[:, None]
    busy = (v["slot_state"] == BUSY) & ctx.cap_mask & ev_down[:, None]
    rids_b = torch.sort(torch.where(busy, v["slot_req"], I32_MAX),
                        dim=1).values
    valid_b = rids_b < I32_MAX
    n_busy = valid_b.sum(1)
    succ_b = torch.cat([rids_b[:, 1:], torch.full_like(rids_b[:, :1],
                                                       I32_MAX)], 1)
    link_b = valid_b & (succ_b < I32_MAX)
    v["nxt"][lanes, torch.where(link_b, rids_b, N)] = succ_b
    if ctx.has_resil:
        # a drained attempt never completes: it gives its attempt back
        at = torch.where(valid_b, rids_b, N)
        v["att"][lanes, at] = v["att"][lanes, at] - valid_b.to(torch.int64)
    # each non-empty queue links from the tail of the last non-empty one
    # before it, else from the last busy rid
    nonempty = v["q_len"] > 0
    cmax = torch.cummax(torch.where(nonempty, ctx.ar_f, -1), dim=1).values
    lnb = torch.cat([torch.full_like(cmax[:, :1], -1), cmax[:, :-1]], 1)
    busy_last = torch.where(
        n_busy > 0, rids_b.gather(1, (n_busy - 1).clamp(0, C - 1)[:, None])
        [:, 0], -1)
    tails = v["q_tail_rid"]
    prev = torch.where(lnb >= 0, tails.gather(1, lnb.clamp(0, F - 1)),
                       busy_last[:, None])
    heads = v["q_head_rid"]
    link_q = ev_down[:, None] & nonempty & (prev >= 0)
    v["nxt"][lanes, torch.where(link_q, prev, N)] = heads
    has_q = nonempty.any(1)
    first = torch.argmax(nonempty.to(torch.int32), dim=1)
    d_head = torch.where(n_busy > 0, rids_b[:, 0],
                         torch.where(has_q, ctx.row(heads, first, F), -1))
    d_tail = torch.where(has_q, ctx.row(tails, cmax[:, -1], F), busy_last)
    n_drain = n_busy.to(torch.int32) + v["q_tot"]
    parked = ev_down & (n_drain > 0)
    v["park_head"] = torch.where(parked, d_head, v["park_head"])
    v["park_tail"] = torch.where(parked, d_tail, v["park_tail"])
    v["park_len"] = torch.where(parked, n_drain, v["park_len"])
    v["park_t"] = torch.where(parked, t_ev, v["park_t"])
    # the node starts afresh
    dn = ev_down[:, None]
    for key, val in (("slot_fn", -1), ("slot_state", IDLE),
                     ("slot_ready", BIG), ("slot_req", -1),
                     ("slot_used", 0.0), ("slot_seq", I32_MAX),
                     ("q_len", 0), ("q_head_rid", -1), ("q_tail_rid", -1)):
        v[key] = torch.where(dn, val, v[key])
    v["q_tot"] = torch.where(ev_down, 0, v["q_tot"])
    for key, val in extra0.items():
        m = ev_down.reshape((-1,) + (1,) * (v[key].dim() - 1))
        v[key] = torch.where(m, val, v[key])


def _terminal(s, resil: bool):
    """Each lane's requests at their end: ``done``, or under resilience
    ``term`` (done, exhausted or shed)."""
    return s["term"] if resil else s["done"]


def _resil_exec_done(ctx, v, topo, rid_done, t_ev, exec_on):
    """EXEC_DONE under resilience: the attempt succeeds iff its count
    exceeds the request's planned failures; a failure exhausts the budget
    or joins the lane's retry FIFO, eligible its backoff later (only an
    empty FIFO arms the fire time). Returns the successes and the
    failures."""
    max_att, _, base, cap, jit, seed = topo.resil
    att = ctx.rail_at(v["att"], rid_done)
    ok = exec_on & (att > ctx.nfail_at(rid_done))
    fail = exec_on & ~ok
    exh = fail & (att >= max_att)
    retry = fail & ~exh
    tmo = ctx.tmo_at(rid_done)
    v["done"] = v["done"] + ok
    v["term"] = v["term"] + (ok | exh)
    v["failed"] = v["failed"] + (fail & ~tmo)
    v["tmo"] = v["tmo"] + (fail & tmo)
    v["retried"] = v["retried"] + retry
    v["exh"] = v["exh"] + exh
    if not ctx.stream:
        # an exhausted or shed request keeps completion -1
        ctx.link(v, "completion", rid_done, t_ev, ok)
    elig = t_ev + backoff_torch(att, ctx.key_at(rid_done), base, cap, jit,
                                seed)
    ctx.link(v, "rt_t", rid_done, elig, retry)
    r_empty = v["r_len"] == 0
    ctx.link(v, "nxt", v["r_tail"], rid_done, retry & ~r_empty)
    v["r_head"] = torch.where(retry & r_empty, rid_done, v["r_head"])
    v["r_tail"] = torch.where(retry, rid_done, v["r_tail"])
    v["r_fire"] = torch.where(retry & r_empty, elig, v["r_fire"])
    v["r_len"] = v["r_len"] + retry
    return ok, fail


def _breaker(v, topo, t_ev, exec_on, fail):
    """The event node's circuit breaker at an EXEC_DONE (breaker lanes):
    closed, it counts the attempt into its window and trips when a full
    window's failures reach the trip point; half-open, the first attempt
    decides (success closes, failure trips again); open, a completion is
    a straggler and ignored."""
    on = exec_on & topo.lane_brk
    until0 = v["cbr_until"]
    half = on & (until0 > 0.0) & (until0 <= t_ev)
    closed = on & (until0 == 0.0)
    n1 = v["cbr_n"] + closed
    f1 = v["cbr_f"] + (closed & fail)
    boundary = closed & (n1 >= topo.brk_volume)
    trip = (boundary & (f1 >= topo.brk_trip_at)) | (half & fail)
    v["cbr_until"] = torch.where(trip, t_ev + topo.brk_cooldown,
                                 torch.where(half, 0.0, until0))
    reset = boundary | half
    v["cbr_n"] = torch.where(reset, 0, n1)
    v["cbr_f"] = torch.where(reset, 0, f1)
    v["trips"] = v["trips"] + trip


def _cluster_step(ctx, kernel, s, nodal, topo, max_iters, extra0, rec=None,
                  trace_node=True):
    """One event for every lane: pick, route, the event node's view, the
    hooks, write-back, fold. With ``rec`` (a list), also appends the
    step's trace records (`engine._trace_record`; node -1 unless
    ``trace_node``)."""
    N, C, F = ctx.N, ctx.C, ctx.F
    L, Kx = s["q_tot"].shape
    KC, KF = Kx * C, Kx * F
    lanes = ctx.lanes
    timers = kernel.has_timers
    cap_mask, delays = topo.cap_mask, topo.delays
    churn = topo.any_churn
    resil = topo.resil is not None
    direct = topo.lane_direct
    # ---- pick: first-index argmin over [busy | cold | (timers | re-arms)
    # | (in-flight heads) | (orphan | toggles) | (retry) | arrival],
    # node-major in each class
    na = s["next"]
    nl = ctx.n_live
    t_arr = torch.where(na < nl, E.EngineCtx.arrival_at(ctx, na), BIG)
    ready = torch.where(cap_mask, s["slot_ready"], BIG).reshape(L, KC)
    st = s["slot_state"].reshape(L, KC)
    blocks = [torch.where(st == BUSY, ready, BIG),
              torch.where(st == COLD, ready, BIG)]
    if timers:
        blocks += [s["tmr_next"].reshape(L, KF), s["rearm_t"].reshape(L, KF)]
    n_pend = sum(b.shape[1] for b in blocks)
    if topo.any_delay:
        land = s["land_t"].gather(1, s["pend_head"].clamp(0, N - 1))
        blocks.append(torch.where(s["pend_len"] > 0, land, BIG))
    n_orph = sum(b.shape[1] for b in blocks)
    up = None
    if churn:
        up = ((s["ch_ix"] & 1) == 0) & topo.node_ok
        anyup = up.any(1)
        blocks.append(torch.where((s["park_len"] > 0) & anyup, s["park_t"],
                                  BIG)[:, None])
        E_ = topo.churn_t.shape[2]
        blocks.append(topo.churn_t.gather(
            2, s["ch_ix"].clamp(0, E_ - 1)[..., None])[..., 0])
    n_rtry = sum(b.shape[1] for b in blocks)
    if resil:
        blocks.append(s["r_fire"][:, None])
    cand = torch.cat(blocks + [t_arr[:, None]], dim=1)
    t_ev, ei = torch.min(cand, dim=1)

    active = (_terminal(s, resil) < nl) & (s["stall"] == 0)
    live = active & (t_ev < BIG)
    ev_slot = live & (ei < 2 * KC)
    is_cold = ei >= KC
    sflat = torch.where(is_cold, ei - KC, ei).clamp(0, KC - 1)
    slot = sflat % C
    ev_arr = live & (ei == cand.shape[1] - 1) & (na < nl)
    no = torch.zeros_like(live)
    ev_orph, ev_churn, ev_rtry = no, no, no
    rid_a = na.clamp(max=N - 1)
    rid_rt, t_rt = rid_a, t_arr
    if churn:
        ev_orph = live & (ei == n_orph)
        ev_churn = live & (ei > n_orph) & (ei <= n_orph + Kx)
        # a re-routed orphan is the park head, decided at its event
        rid_rt = torch.where(ev_orph, s["park_head"].clamp(0, N - 1), rid_a)
        t_rt = torch.where(ev_orph, t_ev, t_arr)
    if resil:
        # ... and a retry the retry FIFO's head, at its fire time
        ev_rtry = live & (ei == n_rtry)
        rid_rt = torch.where(ev_rtry, s["r_head"].clamp(0, N - 1), rid_rt)
        t_rt = torch.where(ev_rtry, t_ev, t_rt)

    # ---- route (read-only, on the state before the event), then the
    # event's node
    k_ev = torch.where(ev_slot, sflat // C,
                       _route(ctx, s, topo, rid_rt, t_rt, up))
    ev_timer = no
    if timers:
        n0 = 2 * KC
        fire_orig = live & (ei >= n0) & (ei < n0 + KF)
        fire_re = live & (ei >= n0 + KF) & (ei < n0 + 2 * KF)
        ev_timer = fire_orig | fire_re
        kf_t = torch.where(fire_orig, ei - n0, ei - n0 - KF).clamp(0, KF - 1)
        f_t = kf_t % F
        k_ev = torch.where(ev_timer, kf_t // F, k_ev)
    ev_pend = no
    if topo.any_delay:
        ev_pend = live & (ei >= n_pend) & (ei < n_pend + Kx)
        k_ev = torch.where(ev_pend, (ei - n_pend).clamp(0, Kx - 1), k_ev)
    if churn:
        k_ev = torch.where(ev_churn, (ei - n_orph - 1).clamp(0, Kx - 1),
                           k_ev)
    v = dict(s)
    for key in nodal:
        v[key] = s[key][lanes, k_ev]
    ctx.cap_mask = cap_mask[lanes, k_ev]
    ctx.delay = delays[lanes, k_ev]
    if topo.any_var:
        ctx.dsched = (topo.dtimes[lanes, k_ev], topo.dvals[lanes, k_ev],
                      topo.dper[lanes, k_ev])
    if rec is not None:
        pre = E._trace_pre(v, v["q_tot"])

    # ---- slot event: release, the node's estimator, under resilience the
    # attempt's outcome (and the breaker), the policy hooks
    cold_on = ev_slot & is_cold
    exec_on = ev_slot & ~is_cold
    rid_done = ctx.row(v["slot_req"], slot, C)
    j_done = ctx.row(v["slot_fn"], slot, C)
    e_done = ctx.exec_at(rid_done)
    m = _hit(ev_slot, slot, ctx.ar_c)
    v["slot_state"] = torch.where(m, IDLE, v["slot_state"])
    v["slot_ready"] = torch.where(m, BIG, v["slot_ready"])
    v["slot_req"] = torch.where(m, -1, v["slot_req"])
    mj = _hit(exec_on, j_done, ctx.ar_f)
    v["est_sum"] = torch.where(mj, v["est_sum"] + e_done[:, None],
                               v["est_sum"])
    v["est_n"] = v["est_n"] + mj
    v["g_sum"] = v["g_sum"] + torch.where(exec_on, e_done, 0.0)
    v["gn"] = v["gn"] + exec_on
    if resil:
        ok_on, fail_on = _resil_exec_done(ctx, v, topo, rid_done, t_ev,
                                          exec_on)
    else:
        ok_on, fail_on = exec_on, no
        v["done"] = v["done"] + exec_on
    if topo.any_brk:
        _breaker(v, topo, t_ev, exec_on, fail_on)
    # a direct lane folds each successful completion (the run that
    # survived), not each dispatch (a drained one may never complete)
    fold_done = ok_on & direct
    v["ev_rid"] = torch.where(fold_done, rid_done, -1)
    v["ev_comp"] = torch.where(fold_done, t_ev, 0.0)
    v["ev_exec"] = torch.where(fold_done, e_done, 0.0)
    kernel.on_cold_done(ctx, v, slot, t_ev, cold_on)
    kernel.on_exec_done(ctx, v, slot, rid_done, t_ev, exec_on)

    # ---- timer: an original timer (the chain moves on to the next node
    # arrival of its function, if one has arrived) or the re-armed head
    if timers:
        rid_o = ctx.row(v["tmr_rid"], f_t, F)
        more = (ctx.row(v["tmr_seq"], f_t, F) + 1
                < ctx.row(v["arr_cnt"], f_t, F))
        succ = ctx.rail_at(s["tnx"], rid_o)
        mo = _hit(fire_orig, f_t, ctx.ar_f)
        v["tmr_seq"] = v["tmr_seq"] + mo
        v["tmr_rid"] = torch.where(mo, torch.where(more, succ, -1)[:, None],
                                   v["tmr_rid"])
        nxt = torch.where(more, ctx.arrival_at(succ) + ctx.threshold, BIG)
        v["tmr_next"] = torch.where(mo, nxt[:, None], v["tmr_next"])
        rid_r = ctx.row(v["rearm_rid"], f_t, F)
        v["rearm_t"] = torch.where(_hit(fire_re, f_t, ctx.ar_f), BIG,
                                   v["rearm_t"])
        rid_t = torch.where(fire_orig, rid_o, rid_r)
        kernel.on_timer(ctx, v, rid_t, t_ev, ev_timer)

    # ---- churn: the node's toggle (NODE_DOWN drains it, NODE_UP re-arms
    # the park FIFO), or the re-route of the park head
    node_up = torch.ones_like(live)
    anyup_r = torch.ones_like(live)
    if churn:
        anyup_r = anyup
        up0 = (v["ch_ix"] & 1) == 0
        v["ch_ix"] = v["ch_ix"] + ev_churn
        _drain(ctx, v, ev_churn & up0, t_ev, extra0)
        v["park_t"] = torch.where(ev_churn & ~up0 & (v["park_len"] > 0),
                                  t_ev, v["park_t"])
        rid_o = v["park_head"]
        plen = v["park_len"]
        succ_o = torch.where(plen > 1, ctx.rail_at(v["nxt"], rid_o), -1)
        v["park_head"] = torch.where(ev_orph, succ_o, rid_o)
        v["park_tail"] = torch.where(ev_orph & (plen <= 1), -1,
                                     v["park_tail"])
        v["park_len"] = plen - ev_orph.to(torch.int32)
        node_up = (v["ch_ix"] & 1) == 0
        v["toggles"] = v["toggles"] + ev_churn
        v["reroutes"] = v["reroutes"] + ev_orph

    # ---- retry: pop the retry FIFO's head; its successor fires no
    # earlier than now (a retry never overtakes)
    if resil:
        rlen0 = v["r_len"]
        rid_y = v["r_head"]
        succ_y = ctx.rail_at(v["nxt"], rid_y)
        v["r_head"] = torch.where(ev_rtry, succ_y, rid_y)
        v["r_tail"] = torch.where(ev_rtry & (rlen0 <= 1), -1, v["r_tail"])
        v["r_len"] = rlen0 - ev_rtry.to(torch.int32)
        nfire = torch.maximum(ctx.rail_at(v["rt_t"], succ_y), t_ev)
        v["r_fire"] = torch.where(ev_rtry, torch.where(rlen0 > 1, nfire, BIG),
                                  v["r_fire"])

    # ---- node arrival: the in-flight head lands (a lane with delay: on a
    # down node it parks instead), or the raw arrival, the re-routed
    # orphan or the retry arrives at once (a lane without)
    at_once = ~ctx.lane_delay
    rid_na, t_na = rid_a, t_arr
    na_on = ev_arr & at_once
    if churn:
        rid_na = torch.where(ev_orph, rid_o, rid_a)
        t_na = torch.where(ev_orph, t_ev, t_arr)
        na_on = (na_on & anyup) | (ev_orph & at_once)
    if resil:
        rid_na = torch.where(ev_rtry, rid_y, rid_na)
        t_na = torch.where(ev_rtry, t_ev, t_na)
        na_on = na_on | (ev_rtry & at_once & anyup_r)
    if topo.any_delay:
        plen0 = v["pend_len"]
        rid_p = v["pend_head"]
        succ_p = torch.where(plen0 > 1, ctx.rail_at(s["dnx"], rid_p), -1)
        v["pend_head"] = torch.where(ev_pend, succ_p, v["pend_head"])
        v["pend_len"] = plen0 - ev_pend.to(torch.int32)
        rid_na = torch.where(ev_pend, rid_p, rid_na)
        t_na = torch.where(ev_pend, t_ev, t_na)
        na_on = na_on | (ev_pend & node_up)
    if timers:
        # chain every node arrival onto its (node, fn) timer rail
        j_na = ctx.fn_at(rid_na)
        ctx.link(v, "tnx", ctx.row(v["la_rid"], j_na, F), rid_na,
                 na_on & (ctx.row(v["la_rid"], j_na, F) >= 0))
        mn = _hit(na_on, j_na, ctx.ar_f)
        v["la_rid"] = torch.where(mn, rid_na[:, None], v["la_rid"])
        v["arr_cnt"] = v["arr_cnt"] + mn
    v["next"] = na + ev_arr
    v["iters"] = v["iters"] + (ev_slot | ev_timer | ev_arr | ev_pend
                               | ev_orph | ev_churn | ev_rtry)
    kernel.on_arrival(ctx, v, rid_na, t_na, na_on)
    if topo.any_delay:
        # a raw arrival (or a re-routed orphan, or a retry) of a lane with
        # delay goes in flight to the router's node and lands at the send
        # time plus the node's delay then
        snd = ev_arr & ctx.lane_delay
        rid_s = rid_a
        if churn:
            snd = (snd & anyup) | (ev_orph & ctx.lane_delay)
            rid_s = torch.where(ev_orph, rid_o, rid_a)
        if resil:
            snd = snd | (ev_rtry & ctx.lane_delay & anyup_r)
            rid_s = torch.where(ev_rtry, rid_y, rid_s)
        ctx.link(v, "land_t", rid_s, t_ev + ctx.node_delay(t_ev), snd)
        pempty = v["pend_len"] == 0
        ctx.link(v, "dnx", v["pend_tail"], rid_s, snd & ~pempty)
        v["pend_head"] = torch.where(snd & pempty, rid_s, v["pend_head"])
        v["pend_tail"] = torch.where(snd, rid_s, v["pend_tail"])
        v["pend_len"] = v["pend_len"] + snd
        if "node_of" in v:
            ctx.link(v, "node_of", v["ev_rid"], k_ev.to(torch.int32),
                     (v["ev_rid"] >= 0) & ~direct)
    if churn:
        # park: a fresh arrival (or a retry) while every node is down, or
        # a landing on a node that went down in flight
        park_in = (ev_arr & ~anyup) | (ev_pend & ~node_up)
        rid_pk = torch.where(ev_pend, rid_p, rid_a) if topo.any_delay \
            else rid_a
        if resil:
            park_in = park_in | (ev_rtry & ~anyup)
            rid_pk = torch.where(ev_rtry, rid_y, rid_pk)
        pk_empty = v["park_len"] == 0
        ctx.link(v, "nxt", v["park_tail"], rid_pk, park_in & ~pk_empty)
        v["park_head"] = torch.where(park_in & pk_empty, rid_pk,
                                     v["park_head"])
        v["park_tail"] = torch.where(park_in, rid_pk, v["park_tail"])
        v["park_len"] = v["park_len"] + park_in
        v["park_t"] = torch.where(park_in & pk_empty, t_ev, v["park_t"])

    _fold_event(ctx, v)
    if rec is not None:
        kind = torch.where(exec_on, TraceKind.EXEC,
                           torch.where(cold_on, TraceKind.COLD, -1))
        rid = torch.where(ev_slot, rid_done, -1)
        if timers:
            kind = torch.where(ev_timer, TraceKind.TIMER, kind)
            rid = torch.where(ev_timer, rid_t, rid)
        if churn:
            kind = torch.where(ev_churn, TraceKind.CHURN,
                               torch.where(ev_orph, TraceKind.REROUTE, kind))
            rid = torch.where(ev_orph, rid_o, rid)
        if resil:
            kind = torch.where(ev_rtry, TraceKind.RETRY, kind)
            rid = torch.where(ev_rtry, rid_y, rid)
        if topo.any_delay:
            kind = torch.where(ev_pend, TraceKind.NODE_ARRIVAL, kind)
            rid = torch.where(ev_pend, rid_p, rid)
        kind = torch.where(ev_arr, TraceKind.ARRIVAL, kind)
        rid = torch.where(ev_arr, rid_a, rid)
        rec.append(E._trace_record(
            ctx, v, pre, kind, rid, j_done, ev_slot, exec_on, t_ev, e_done,
            k_ev if trace_node else torch.full_like(k_ev, -1), v["q_tot"],
            ctx.cap_mask, churn=(ev_churn, node_up) if churn else None))
    v["stall"] = torch.where(
        active & ~live, 1,
        torch.where(active & (v["iters"] >= max_iters), 2, v["stall"]))
    for key in nodal:
        s[key][lanes, k_ev] = v[key]
        v[key] = s[key]
    v["node_done"] = v["node_done"] + _hit(ok_on, k_ev,
                                           torch.arange(Kx, device=na.device))
    for key in ("ev_rid", "ev_comp", "ev_exec"):
        del v[key]
    s.update(v)


def simulate_cluster_eager(fn_id, arrival, exec_time, t_cold, t_evict,
                           trace_ix, cap_mask, beta, prior, *, kernel,
                           routers, router_ix, n_nodes, seeds, delays, n_fns,
                           capacity, queue_cap, stream=False, threshold=0.1,
                           n_live=None, deadlines=None, tl_bins=0,
                           tl_bucket=60.0, churn_t=None, dtimes=None,
                           dvals=None, dper=None, rs_nfail=None, rs_tmo=None,
                           rs_key=None, resil=None, trace=False,
                           trace_node=True) -> Dict[str, torch.Tensor]:
    """The eager K-node loop (counterpart of
    `repro.cluster.engine._simulate_cluster`): `_cluster_step` over every
    lane, SEG steps between host checks; the plain version of the
    event-loop kernel's K-node variant and the route of every policy or
    router without one.

    Inputs as `simulate_cluster`. Returns the single-node engine's
    outputs plus ``node_done`` (L, K); in exact mode when a lane has
    delay, ``node_of`` (L, N), the node that served each request (0 on a
    lane in direct mode); under churn ``toggles`` and ``reroutes`` (L,),
    the lane's NODE_DOWN / NODE_UP events and park-head re-routes; under
    resilience ``failed``, ``timed_out``, ``retried``, ``shed`` and
    ``failed_exhausted`` (L,); with a `BreakerRouter` ``breaker_trips``
    (L,). With ``trace`` each segment's trace records go to the active
    sink (`engine.flush_trace`)."""
    L = trace_ix.shape[0]
    N = fn_id.shape[1]
    F, C = n_fns, capacity
    Kx = cap_mask.shape[1]
    dev = fn_id.device
    topo = Topology(routers, router_ix, n_nodes, seeds, delays, cap_mask,
                    churn_t, dtimes, dvals, dper, resil)
    timers = kernel.has_timers
    if timers and topo.any_churn:
        raise ValueError("timer-rail kernels are not supported under churn "
                         "(rejected at the runner)")
    if timers and resil is not None:
        raise ValueError("timer-rail kernels are not supported under the "
                         "resilience layer (rejected at the runner)")
    ctx = ClusterNodeCtx(
        fn_id=fn_id, arrival=arrival, exec_time=exec_time,
        t_cold_l=t_cold[trace_ix].contiguous(),
        t_evict_l=t_evict[trace_ix].contiguous(), trace_ix=trace_ix,
        cap_mask=cap_mask[:, 0], beta=beta, prior=float(prior), f=F, c=C,
        q=queue_cap, stream=stream, threshold=float(threshold),
        n_live=n_live, deadlines=deadlines, tl_bins=tl_bins,
        tl_bucket=tl_bucket, lane_delay=topo.lane_delay,
        lane_direct=topo.lane_direct, lane_var=topo.lane_var, resil=resil,
        rs=None if resil is None else (rs_nfail, rs_tmo, rs_key))
    s, extra = _init_state(kernel, L, Kx, C, F, N, stream, dev, timers, topo,
                           deadlines is not None, tl_bins)
    nodal = (_NODAL + (_NODAL_TMR if timers else ())
             + (_NODAL_PEND if topo.any_delay else ())
             + (("ch_ix",) if topo.any_churn else ())
             + (("cbr_n", "cbr_f", "cbr_until") if topo.any_brk else ())
             + extra)
    # each node's policy state as it starts, for a NODE_DOWN's reset
    extra0 = {k: v[0].to(dev) for k, v in kernel.extra_state(1, C, F).items()}
    max_iters = topo.max_events(N)
    has_resil = resil is not None

    def running():
        return bool(((_terminal(s, has_resil) < ctx.n_live)
                     & (s["stall"] == 0)).any())

    rec = [] if trace else None
    while running():   # one host sync per SEG events
        for _ in range(E.SEG):
            _cluster_step(ctx, kernel, s, nodal, topo, max_iters, extra0,
                          rec, trace_node)
        if trace:
            E.flush_trace(rec)

    i32 = torch.int32
    out = dict(cold_starts=s["cold"].to(i32), cold_time=s["cold_t"],
               evictions=s["evict"].to(i32), evict_time=s["evict_t"],
               overflow=s["ovf"].to(i32), stalled=s["stall"].to(i32),
               n_events=s["iters"].to(i32), done=s["done"].to(i32),
               node_done=s["node_done"], resp_sum=s["r_sum"],
               slow_sum=s["s_sum"], max_response=s["r_max"],
               resp_hist=s["hist"].to(i32))
    if tl_bins:
        out["tl_count"] = s["tl_cnt"]
        out["tl_resp_sum"] = s["tl_resp"]
        out["tl_exec_sum"] = s["tl_exec"]
    if deadlines is not None:
        out["deadline_miss"] = s["dl_miss"]
    if topo.any_churn:
        out["toggles"] = s["toggles"]
        out["reroutes"] = s["reroutes"]
    if has_resil:
        for name, key in _RESIL_OUT:
            out[name] = s[key].to(i32)
    if topo.any_brk:
        out["breaker_trips"] = s["trips"].to(i32)
    if not stream:
        out["start"] = s["start"][:, :N]
        out["completion"] = s["completion"][:, :N]
        if "node_of" in s:
            out["node_of"] = s["node_of"][:, :N]
    return out


def simulate_cluster(fn_id, arrival, exec_time, t_cold, t_evict, trace_ix,
                     cap_mask, beta, prior, threshold=0.1, *, kernel,
                     routers, router_ix, n_nodes, seeds, delays, n_fns,
                     capacity, queue_cap, stream=False, seg=0, n_live=None,
                     deadlines=None, tl_bins=0, tl_bucket=60.0,
                     churn_t=None, dtimes=None, dvals=None, dper=None,
                     rs_nfail=None, rs_tmo=None, rs_key=None, resil=None,
                     trace=False, trace_node=True
                     ) -> Dict[str, torch.Tensor]:
    """Lane-batched K-node engine (counterpart of
    `repro.cluster.engine._simulate_cluster`).

    Trace arrays are shared (T, ...) tensors as for `engine.simulate`;
    each lane carries its topology: ``cap_mask`` (L, K, C) bool (node k's
    usable slots; a lane with fewer nodes masks the rest), ``n_nodes``
    (L,) ints, ``seeds`` (L,) ints (the routers' hash seed), ``delays``
    (L, K) f64 seconds (the constant per-node network delay) and its
    router ``routers[router_ix[l]]`` (`DynamicRouter` instances). The
    lowerings of `ClusterSpec` add, each ``None`` when no lane has it:
    ``churn_t`` (L, K, E) f64, each node's toggle times (even index:
    down, odd: up), `BIG`-padded (a lane whose row is all `BIG` runs the
    plain loop, bitwise), and ``dtimes`` / ``dvals`` (L, K, D) f64 with
    ``dper`` (L, K), each node's delay schedule (`ClusterSpec.delay_ops`;
    a lane whose nodes all have one step keeps its constant ``delays``).
    A lane has delay when a ``delays`` entry is not zero or its delay
    varies. ``seg`` is accepted and changes nothing (the JAX package's
    segment length). Options as `engine.simulate`: ``n_live``,
    ``deadlines``, ``tl_bins`` and ``tl_bucket``. The resilience layer
    (`ExperimentSpec.resilience_ops`): the (T, N) operands ``rs_nfail``
    (leading failed attempts), ``rs_tmo`` (bool: the failures are
    timeouts) and ``rs_key`` (each request's original trace id), and the
    tuple ``resil`` = (max_attempts, shed mode, base, cap, jitter,
    fail_seed), for every lane of the call; ``exec_time`` is then the
    attempts' time, ``min(exec, timeout)``. ``trace`` writes each lane's
    trace records to the active sink, as `engine.simulate`'s does, with
    each event's node (-1 without ``trace_node``: `engine.simulate`'s
    single node under resilience).

    A built-in policy whose routers are all built-in (or breakers around
    built-ins) goes to the event-loop kernel's K-node variant (one launch
    a call on a card, its plain version `simulate_cluster_eager` on the
    CPU); any other runs `simulate_cluster_eager`. The route is chosen by
    type, never by a failed build."""
    if seg < 0 or tl_bins < 0:
        raise ValueError(f"simulate_cluster: seg and tl_bins must be >= 0, "
                         f"got {seg} and {tl_bins}")
    from repro_torch.kernels import event_loop as K0
    f64, i64 = torch.float64, torch.int64
    dev = fn_id.device
    as_t = E._as_tensor
    args = (fn_id.to(i64).contiguous(), arrival.to(f64).contiguous(),
            exec_time.to(f64).contiguous(), t_cold.to(f64).contiguous(),
            t_evict.to(f64).contiguous(), trace_ix.to(i64).contiguous(),
            cap_mask.to(torch.bool).contiguous(), beta.to(f64).contiguous(),
            float(prior))
    L, Kx = cap_mask.shape[:2]
    routers = tuple(routers)
    topo = dict(routers=routers,
                router_ix=as_t(router_ix, i64, dev).contiguous(),
                n_nodes=as_t(n_nodes, i64, dev).contiguous(),
                seeds=as_t(seeds, i64, dev).contiguous(),
                delays=as_t(delays, f64, dev).contiguous())
    shapes = [("router_ix", (L,)), ("n_nodes", (L,)), ("seeds", (L,)),
              ("delays", (L, Kx))]
    if churn_t is not None:
        topo["churn_t"] = as_t(churn_t, f64, dev).contiguous()
        shapes.append(("churn_t", (L, Kx, topo["churn_t"].shape[-1])))
    if (dtimes is None) != (dvals is None) or (dtimes is None) != (
            dper is None):
        raise ValueError("simulate_cluster: dtimes, dvals and dper go "
                         "together")
    if dtimes is not None:
        for name, x in (("dtimes", dtimes), ("dvals", dvals),
                        ("dper", dper)):
            topo[name] = as_t(x, f64, dev).contiguous()
        D = topo["dtimes"].shape[-1]
        shapes += [("dtimes", (L, Kx, D)), ("dvals", (L, Kx, D)),
                   ("dper", (L, Kx))]
    for name, shape in shapes:
        if tuple(topo[name].shape) != shape:
            raise ValueError(f"simulate_cluster: {name} has shape "
                             f"{tuple(topo[name].shape)}, expected {shape}")
    topo.update(resil_operands(rs_nfail, rs_tmo, rs_key, resil,
                               tuple(fn_id.shape), dev))
    if n_live is not None:
        n_live = as_t(n_live, i64, dev).contiguous()
    kw = dict(kernel=kernel, n_fns=n_fns, capacity=capacity,
              queue_cap=queue_cap, stream=stream, threshold=float(threshold),
              n_live=n_live, tl_bins=int(tl_bins), tl_bucket=float(tl_bucket),
              deadlines=(None if deadlines is None
                         else as_t(deadlines, f64, dev).contiguous()),
              trace=bool(trace), trace_node=bool(trace_node), **topo)
    if has_cluster_loop(kernel, routers):
        return K0.cluster_loop(*args, **kw)   # checks its inputs itself
    check_topology(kw["n_nodes"], kw["router_ix"], kw["delays"],
                   len(routers), kw.get("dtimes"), kw.get("dper"))
    if n_live is not None:
        E.check_n_live(n_live, fn_id.shape[1])
    return simulate_cluster_eager(*args, **kw)


def resil_operands(rs_nfail, rs_tmo, rs_key, resil, shape, dev) -> dict:
    """The resilience layer's keywords of `simulate_cluster_eager` and
    `cluster_loop`, on ``dev``: the (T, N) = ``shape`` outcome operands
    as int32, bool and int32, and the ``resil`` tuple; an empty dict
    when ``resil`` is None. Raises when the operands are missing or
    misshapen, or the tuple is not one the layer makes."""
    ops = (rs_nfail, rs_tmo, rs_key)
    if any((x is None) != (resil is None) for x in ops):
        raise ValueError("simulate_cluster: resil and rs_nfail, rs_tmo, "
                         "rs_key go together")
    if resil is None:
        return {}
    check_resil(resil)
    max_att, mode, base, cap, jit, seed = resil
    out = dict(resil=(int(max_att), int(mode), float(base), float(cap),
                      float(jit), int(seed)))
    for name, x, dt in (("rs_nfail", rs_nfail, torch.int32),
                        ("rs_tmo", rs_tmo, torch.bool),
                        ("rs_key", rs_key, torch.int32)):
        x = E._as_tensor(x, dt, dev).contiguous()
        if tuple(x.shape) != shape:
            raise ValueError(f"simulate_cluster: {name} has shape "
                             f"{tuple(x.shape)}, expected {shape}")
        out[name] = x
    return out


def check_resil(resil) -> None:
    """Raise unless ``resil`` is a tuple the layer makes: (max_attempts
    in [1, 16], shed mode 0-2, base >= 0, cap >= 0, jitter in [0, 1),
    fail_seed)."""
    from repro_torch.core.resilience import MAX_ATTEMPTS, SHED_MODES
    max_att, mode, base, cap, jit, _ = resil
    if not (1 <= int(max_att) <= MAX_ATTEMPTS
            and int(mode) in SHED_MODES.values() and base >= 0
            and cap >= 0 and 0.0 <= jit < 1.0):
        raise ValueError(f"simulate_cluster: resil {resil!r} is not "
                         "(max_attempts in [1, 16], shed mode 0-2, base "
                         ">= 0, cap >= 0, jitter in [0, 1), fail_seed)")


def check_topology(n_nodes, router_ix, delays, n_routers: int, dtimes=None,
                   dper=None) -> None:
    """Raise unless every lane's node count lies in [1, K], its router
    index in [0, n_routers), its delays are >= 0 and, with a delay
    schedule, each node's first step is at 0 and its period >= 0 (one
    host read)."""
    Kx = delays.shape[1]
    bad = ((n_nodes < 1) | (n_nodes > Kx) | (router_ix < 0)
           | (router_ix >= n_routers) | (delays < 0).any(1))
    if dtimes is not None:
        bad = bad | (dtimes[..., 0] != 0).any(1) | (dper < 0).any(1)
    if bool(bad.any()):
        raise ValueError(f"simulate_cluster: n_nodes must lie in [1, {Kx}], "
                         f"router_ix in [0, {n_routers}), delays be >= 0 "
                         "and a delay schedule start at 0 with a period "
                         ">= 0")


def cluster_metrics(fn, arr, ex, cold, ev, tix, masks, betas, prior,
                    threshold=0.1, *, kernel, routers, router_ix, n_nodes,
                    seeds, delays, n_fns, capacity, queue_cap, stream=True,
                    keep_responses=False, n_live=None, deadlines=None,
                    seg=0, tl_bins=0, tl_bucket=60.0, churn_t=None,
                    dtimes=None, dvals=None, dper=None, rs_nfail=None,
                    rs_tmo=None, rs_key=None, resil=None, trace=False
                    ) -> Dict[str, torch.Tensor]:
    """Lane-batched K-node run + metric reduction (counterpart of
    `repro.cluster.engine._cluster_metrics`): `engine.sweep_metrics`'s
    metrics plus ``node_done`` (and ``breaker_trips`` with a breaker). In
    exact mode a lane with delay measures each response from the
    request's node-local (delayed) arrival, a lane in direct mode (churn,
    resilience) from the raw arrival. ``trace`` as `simulate_cluster`'s."""
    if keep_responses and stream:
        raise ValueError("keep_responses requires stream=False")
    out = simulate_cluster(
        fn, arr, ex, cold, ev, tix, masks, betas, prior, threshold,
        kernel=kernel, routers=routers, router_ix=router_ix,
        n_nodes=n_nodes, seeds=seeds, delays=delays, n_fns=n_fns,
        capacity=capacity, queue_cap=queue_cap, stream=stream, seg=seg,
        n_live=n_live, deadlines=deadlines, tl_bins=tl_bins,
        tl_bucket=tl_bucket, churn_t=churn_t, dtimes=dtimes, dvals=dvals,
        dper=dper, rs_nfail=rs_nfail, rs_tmo=rs_tmo, rs_key=rs_key,
        resil=resil, trace=trace)
    arr_l = None
    if not stream:
        arr_l = arr.to(torch.float64)[tix]
        if "node_of" in out and resil is None:
            dev = arr.device
            topo = Topology(routers, E._as_tensor(router_ix, torch.int64,
                                                  dev),
                            E._as_tensor(n_nodes, torch.int64, dev),
                            None, E._as_tensor(delays, torch.float64, dev),
                            masks, *(None if x is None else E._as_tensor(
                                x, torch.float64, dev)
                                for x in (churn_t, dtimes, dvals, dper)))
            nof = out["node_of"].to(torch.int64)
            shift = topo.delays.gather(1, nof)
            if topo.any_var:
                def rows(x):
                    return x.gather(1, nof[..., None].expand(
                        -1, -1, x.shape[-1]))
                shift = torch.where(
                    topo.lane_var[:, None],
                    sched_delay(arr_l, rows(topo.dtimes), rows(topo.dvals),
                                topo.dper.gather(1, nof)), shift)
            on = topo.lane_delay & ~topo.lane_direct
            arr_l = torch.where(on[:, None], arr_l + shift, arr_l)
    res = E.reduce_metrics(out, arr_l, fn.shape[1], n_live, stream,
                           keep_responses, resil=resil is not None)
    res["node_done"] = out["node_done"]
    if "breaker_trips" in out:
        res["breaker_trips"] = out["breaker_trips"]
    return res
