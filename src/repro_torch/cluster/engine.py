"""The dynamic-routing cluster engine: K nodes in one event loop a lane
(counterpart of `repro.cluster.engine`, its form without churn, the
resilience layer or time-varying delay).

A dynamic router reads live cluster state at every arrival, so the
routing decision lives inside the event loop. The loop generalises the
single-node engine (`repro_torch.core.engine`) to K co-simulated nodes a
lane:

* **slots** are a (L, K, C) node-major rail, and the next event is the
  first-index argmin over [BUSY K·C | COLD K·C | timers K·F | re-arms K·F
  (timer policies) | in-flight heads K (a lane with delay) | ARRIVAL], so
  the same-time class order EXEC < COLD < TIMER < NODE_ARRIVAL < ARRIVAL
  and the tie-break inside a class (node-major) extend the single-node
  engine's;
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
  joins its node's in-flight FIFO and arrives ``delay_k`` later as a
  NODE_ARRIVAL event; the node's policy, timers and response accounting
  run on the node-local clock (response from the delayed arrival);
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
bitwise the single-node engine, timer policies included.

`simulate_cluster` sends a built-in policy with a built-in router to the
event-loop kernel's K-node variant (`repro_torch.kernels.event_loop.
cluster_loop`: one launch a lane chunk on a card, `simulate_cluster_eager`
on the CPU); any other policy or router runs `simulate_cluster_eager`.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from repro_torch.cluster.routers import ClusterView, ROUTER_CODES
from repro_torch.core import engine as E
from repro_torch.core.engine import (BIG, BUSY, COLD, HIST_BINS, I32_MAX,
                                     IDLE, EngineCtx, _fold_event, _hit)

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
_SUMS = ("cold_t", "evict_t", "r_sum", "s_sum", "r_max")


class ClusterNodeCtx(EngineCtx):
    """Single-node view ctx over the event's node of each lane
    (counterpart of `repro.cluster.engine.ClusterNodeCtx`). The engine
    sets ``cap_mask`` (L, C) and ``delay`` (L,) to the event's node
    before each event. Reads go to the full trace; `arrival_at` is the
    node-local clock on a lane with delay; the queue and timer ops work
    on the link rails ``nxt`` and ``tnx`` (L, N + 1) of the state, whose
    last column takes the disabled writes."""

    def __init__(self, *, lane_delay, **kw):
        super().__init__(positional=False, **kw)
        self.lane_delay = lane_delay     # (L,) bool: the lane has delay
        self.delay = None                # (L,) f64, the event's node's

    def arrival_at(self, rid):
        a = super().arrival_at(rid)
        return torch.where(self.lane_delay, a + self.delay, a)

    def rail_at(self, rail, rid):
        """``rail[l, rid[l]]`` per lane, rid clipped to [0, N)."""
        return rail[self.lanes, rid.clamp(0, self.N - 1)]

    def link(self, s, rail, at, rid, on):
        """``rail[l, at[l]] = rid[l]`` where ``on`` (column N otherwise)."""
        s[rail][self.lanes, torch.where(on, at, self.N)] = rid

    def q_push(self, s, fn, rid, on):
        """Append ``rid`` to ``fn``'s queue: the link from the old tail,
        the tail, the head when the queue was empty, the length and the
        node's total; a push onto a full backlog is dropped and counted
        in ``ovf``. Returns whether it pushed."""
        q0 = self.row(s["q_len"], fn, self.F)
        full = q0 >= self.Q
        do = on & ~full
        was_empty = q0 == 0
        self.link(s, "nxt", self.row(s["q_tail_rid"], fn, self.F), rid,
                  do & ~was_empty)
        s["q_head_rid"] = torch.where(_hit(do & was_empty, fn, self.ar_f),
                                      rid[:, None], s["q_head_rid"])
        s["q_tail_rid"] = torch.where(_hit(do, fn, self.ar_f), rid[:, None],
                                      s["q_tail_rid"])
        s["q_len"] = s["q_len"] + _hit(do, fn, self.ar_f)
        s["q_tot"] = s["q_tot"] + do
        s["ovf"] = s["ovf"] + (on & full)
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
        type(r) in ROUTER_CODES for r in routers)


def _init_state(kernel, L, Kx, C, F, N, stream, dev, timers, delay,
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
    if delay:
        s["pend_head"] = full((L, Kx), -1, i64)
        s["pend_tail"] = full((L, Kx), -1, i64)
        s["pend_len"] = full((L, Kx), 0, i32)
        s["dnx"] = full((L, N + 1), -1, i64)
    if not stream:
        for k in ("start", "completion"):
            s[k] = full((L, N + 1), -1.0, f64)
        if delay:
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


def _route(ctx, s, routers, router_ix, n_nodes, seeds, delays, node_ok,
           cap_mask, rid, t):
    """Each lane's router pick for the arrival ``rid`` at ``t`` on the
    state before the event, clipped to the lane's nodes."""
    g = ClusterView(q_len=s["q_len"], q_tot=s["q_tot"],
                    slot_fn=s["slot_fn"], slot_state=s["slot_state"],
                    cap_mask=cap_mask, est_sum=s["est_sum"],
                    est_n=s["est_n"], node_gn=s["gn"],
                    node_gsum=s["g_sum"], t_cold=ctx.t_cold,
                    prior=ctx.prior, n_nodes=n_nodes, node_ok=node_ok,
                    seed=seeds, delay_now=delays)
    j = ctx.fn_at(rid)
    k = None
    for i, r in enumerate(routers):
        pick = r.pick(g, j, rid, t).to(torch.int64)
        k = pick if k is None else torch.where(router_ix == i, pick, k)
    return torch.minimum(k.clamp_min(0), n_nodes - 1)


def _cluster_step(ctx, kernel, s, nodal, routers, router_ix, n_nodes,
                  seeds, delays, node_ok, cap_mask, any_delay, max_iters):
    """One event for every lane: pick, route, the event node's view, the
    hooks, write-back, fold."""
    N, C, F = ctx.N, ctx.C, ctx.F
    L, Kx = s["q_tot"].shape
    KC, KF = Kx * C, Kx * F
    lanes = ctx.lanes
    timers = kernel.has_timers
    # ---- pick: first-index argmin over [busy | cold | (timers | re-arms)
    # | (in-flight heads) | arrival], node-major in each class
    na = s["next"]
    nl = ctx.n_live
    t_arr = torch.where(na < nl, E.EngineCtx.arrival_at(ctx, na), BIG)
    ready = torch.where(cap_mask, s["slot_ready"], BIG).reshape(L, KC)
    st = s["slot_state"].reshape(L, KC)
    blocks = [torch.where(st == BUSY, ready, BIG),
              torch.where(st == COLD, ready, BIG)]
    if timers:
        blocks += [s["tmr_next"].reshape(L, KF), s["rearm_t"].reshape(L, KF)]
    if any_delay:
        ph = s["pend_head"].clamp(0, N - 1)
        land = ctx._arr[ctx.b_n[:, None] + ph] + delays
        blocks.append(torch.where(s["pend_len"] > 0, land, BIG))
    cand = torch.cat(blocks + [t_arr[:, None]], dim=1)
    t_ev, ei = torch.min(cand, dim=1)

    active = (s["done"] < nl) & (s["stall"] == 0)
    live = active & (t_ev < BIG)
    ev_slot = live & (ei < 2 * KC)
    is_cold = ei >= KC
    sflat = torch.where(is_cold, ei - KC, ei).clamp(0, KC - 1)
    slot = sflat % C
    ev_arr = live & (ei == cand.shape[1] - 1) & (na < nl)

    # ---- route (read-only, on the state before the event), then the
    # event's node
    rid_a = na.clamp(max=N - 1)
    k_ev = torch.where(ev_slot, sflat // C,
                       _route(ctx, s, routers, router_ix, n_nodes, seeds,
                              delays, node_ok, cap_mask, rid_a, t_arr))
    ev_timer = torch.zeros_like(live)
    if timers:
        n0 = 2 * KC
        fire_orig = live & (ei >= n0) & (ei < n0 + KF)
        fire_re = live & (ei >= n0 + KF) & (ei < n0 + 2 * KF)
        ev_timer = fire_orig | fire_re
        kf_t = torch.where(fire_orig, ei - n0, ei - n0 - KF).clamp(0, KF - 1)
        f_t = kf_t % F
        k_ev = torch.where(ev_timer, kf_t // F, k_ev)
    ev_pend = torch.zeros_like(live)
    if any_delay:
        p0 = 2 * KC + (2 * KF if timers else 0)
        ev_pend = live & (ei >= p0) & (ei < p0 + Kx)
        k_ev = torch.where(ev_pend, (ei - p0).clamp(0, Kx - 1), k_ev)
    v = dict(s)
    for key in nodal:
        v[key] = s[key][lanes, k_ev]
    ctx.cap_mask = cap_mask[lanes, k_ev]
    ctx.delay = delays[lanes, k_ev]

    # ---- slot event: release, the node's estimator, the policy hooks
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
    v["done"] = v["done"] + exec_on
    v["ev_rid"] = torch.full_like(na, -1)
    v["ev_comp"] = torch.zeros_like(t_ev)
    v["ev_exec"] = torch.zeros_like(t_ev)
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
        kernel.on_timer(ctx, v, torch.where(fire_orig, rid_o, rid_r), t_ev,
                        ev_timer)

    # ---- node arrival: the in-flight head lands (a lane with delay), or
    # the raw arrival arrives at once (a lane without)
    rid_na, t_na, na_on = rid_a, t_arr, ev_arr & ~ctx.lane_delay
    if any_delay:
        plen0 = v["pend_len"]
        rid_p = v["pend_head"]
        succ_p = torch.where(plen0 > 1, ctx.rail_at(s["dnx"], rid_p), -1)
        v["pend_head"] = torch.where(ev_pend, succ_p, v["pend_head"])
        v["pend_len"] = plen0 - ev_pend.to(torch.int32)
        rid_na = torch.where(ev_pend, rid_p, rid_a)
        t_na = torch.where(ev_pend, t_ev, t_arr)
        na_on = na_on | ev_pend
    if timers:
        # chain every node arrival onto its (node, fn) timer rail
        j_na = ctx.fn_at(rid_na)
        ctx.link(v, "tnx", ctx.row(v["la_rid"], j_na, F), rid_na,
                 na_on & (ctx.row(v["la_rid"], j_na, F) >= 0))
        mn = _hit(na_on, j_na, ctx.ar_f)
        v["la_rid"] = torch.where(mn, rid_na[:, None], v["la_rid"])
        v["arr_cnt"] = v["arr_cnt"] + mn
    v["next"] = na + ev_arr
    v["iters"] = v["iters"] + (ev_slot | ev_timer | ev_arr | ev_pend)
    kernel.on_arrival(ctx, v, rid_na, t_na, na_on)
    if any_delay:
        # the raw arrival of a lane with delay goes in flight to the
        # router's node
        snd = ev_arr & ctx.lane_delay
        pempty = v["pend_len"] == 0
        ctx.link(v, "dnx", v["pend_tail"], rid_a, snd & ~pempty)
        v["pend_head"] = torch.where(snd & pempty, rid_a, v["pend_head"])
        v["pend_tail"] = torch.where(snd, rid_a, v["pend_tail"])
        v["pend_len"] = v["pend_len"] + snd
        if "node_of" in v:
            ctx.link(v, "node_of", v["ev_rid"], k_ev.to(torch.int32),
                     v["ev_rid"] >= 0)

    _fold_event(ctx, v)
    v["stall"] = torch.where(
        active & ~live, 1,
        torch.where(active & (v["iters"] >= max_iters), 2, v["stall"]))
    for key in nodal:
        s[key][lanes, k_ev] = v[key]
        v[key] = s[key]
    v["node_done"] = v["node_done"] + _hit(exec_on, k_ev,
                                           torch.arange(Kx, device=na.device))
    for key in ("ev_rid", "ev_comp", "ev_exec"):
        del v[key]
    s.update(v)


def simulate_cluster_eager(fn_id, arrival, exec_time, t_cold, t_evict,
                           trace_ix, cap_mask, beta, prior, *, kernel,
                           routers, router_ix, n_nodes, seeds, delays, n_fns,
                           capacity, queue_cap, stream=False, threshold=0.1,
                           n_live=None, deadlines=None, tl_bins=0,
                           tl_bucket=60.0) -> Dict[str, torch.Tensor]:
    """The eager K-node loop (counterpart of
    `repro.cluster.engine._simulate_cluster` without churn and the
    resilience layer): `_cluster_step` over every lane, SEG steps between
    host checks; the plain version of the event-loop kernel's K-node
    variant and the route of every policy or router without one.

    Inputs as `simulate_cluster`. Returns the single-node engine's
    outputs plus ``node_done`` (L, K) and, in exact mode when a lane has
    delay, ``node_of`` (L, N): the node that served each request."""
    L = trace_ix.shape[0]
    N = fn_id.shape[1]
    F, C = n_fns, capacity
    Kx = cap_mask.shape[1]
    dev = fn_id.device
    lane_delay = (delays > 0).any(1)
    any_delay = bool(lane_delay.any())
    ctx = ClusterNodeCtx(
        fn_id=fn_id, arrival=arrival, exec_time=exec_time,
        t_cold_l=t_cold[trace_ix].contiguous(),
        t_evict_l=t_evict[trace_ix].contiguous(), trace_ix=trace_ix,
        cap_mask=cap_mask[:, 0], beta=beta, prior=float(prior), f=F, c=C,
        q=queue_cap, stream=stream, threshold=float(threshold),
        n_live=n_live, deadlines=deadlines, tl_bins=tl_bins,
        tl_bucket=tl_bucket, lane_delay=lane_delay)
    timers = kernel.has_timers
    s, extra = _init_state(kernel, L, Kx, C, F, N, stream, dev, timers,
                           any_delay, deadlines is not None, tl_bins)
    nodal = (_NODAL + (_NODAL_TMR if timers else ())
             + (_NODAL_PEND if any_delay else ()) + extra)
    node_ok = torch.arange(Kx, device=dev) < n_nodes[:, None]
    max_iters = E.max_events(N)

    def running():
        return bool(((s["done"] < ctx.n_live) & (s["stall"] == 0)).any())

    while running():   # one host sync per SEG events
        for _ in range(E.SEG):
            _cluster_step(ctx, kernel, s, nodal, routers, router_ix,
                          n_nodes, seeds, delays, node_ok, cap_mask,
                          any_delay, max_iters)

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
                     deadlines=None, tl_bins=0, tl_bucket=60.0
                     ) -> Dict[str, torch.Tensor]:
    """Lane-batched K-node engine (counterpart of
    `repro.cluster.engine._simulate_cluster` in its no-churn,
    no-resilience, constant-delay form).

    Trace arrays are shared (T, ...) tensors as for `engine.simulate`;
    each lane carries its topology: ``cap_mask`` (L, K, C) bool (node k's
    usable slots; a lane with fewer nodes masks the rest), ``n_nodes``
    (L,) ints, ``seeds`` (L,) ints (the routers' hash seed), ``delays``
    (L, K) f64 seconds (the constant per-node network delay; a lane whose
    row is all zero has no in-flight rail) and its router
    ``routers[router_ix[l]]`` (`DynamicRouter` instances). ``seg`` is
    accepted and changes nothing (the JAX package's segment length).
    Options as `engine.simulate`: ``n_live``, ``deadlines``, ``tl_bins``
    and ``tl_bucket``.

    A built-in policy whose routers are all built-in goes to the
    event-loop kernel's K-node variant (one launch a call on a card, its
    plain version `simulate_cluster_eager` on the CPU); any other runs
    `simulate_cluster_eager`. The route is chosen by type, never by a
    failed build."""
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
    for name, shape in (("router_ix", (L,)), ("n_nodes", (L,)),
                        ("seeds", (L,)), ("delays", (L, Kx))):
        if tuple(topo[name].shape) != shape:
            raise ValueError(f"simulate_cluster: {name} has shape "
                             f"{tuple(topo[name].shape)}, expected {shape}")
    if n_live is not None:
        n_live = as_t(n_live, i64, dev).contiguous()
    kw = dict(kernel=kernel, n_fns=n_fns, capacity=capacity,
              queue_cap=queue_cap, stream=stream, threshold=float(threshold),
              n_live=n_live, tl_bins=int(tl_bins), tl_bucket=float(tl_bucket),
              deadlines=(None if deadlines is None
                         else as_t(deadlines, f64, dev).contiguous()),
              **topo)
    if has_cluster_loop(kernel, routers):
        return K0.cluster_loop(*args, **kw)   # checks its inputs itself
    check_topology(kw["n_nodes"], kw["router_ix"], kw["delays"],
                   len(routers))
    if n_live is not None:
        E.check_n_live(n_live, fn_id.shape[1])
    return simulate_cluster_eager(*args, **kw)


def check_topology(n_nodes, router_ix, delays, n_routers: int) -> None:
    """Raise unless every lane's node count lies in [1, K], its router
    index in [0, n_routers) and its delays are >= 0 (one host read)."""
    Kx = delays.shape[1]
    bad = ((n_nodes < 1) | (n_nodes > Kx) | (router_ix < 0)
           | (router_ix >= n_routers) | (delays < 0).any(1))
    if bool(bad.any()):
        raise ValueError(f"simulate_cluster: n_nodes must lie in [1, {Kx}], "
                         f"router_ix in [0, {n_routers}) and delays be >= "
                         "0")


def cluster_metrics(fn, arr, ex, cold, ev, tix, masks, betas, prior,
                    threshold=0.1, *, kernel, routers, router_ix, n_nodes,
                    seeds, delays, n_fns, capacity, queue_cap, stream=True,
                    keep_responses=False, n_live=None, deadlines=None,
                    seg=0, tl_bins=0, tl_bucket=60.0
                    ) -> Dict[str, torch.Tensor]:
    """Lane-batched K-node run + metric reduction (counterpart of
    `repro.cluster.engine._cluster_metrics`): `engine.sweep_metrics`'s
    metrics plus ``node_done``. In exact mode a lane with delay measures
    each response from the request's node-local (delayed) arrival."""
    if keep_responses and stream:
        raise ValueError("keep_responses requires stream=False")
    out = simulate_cluster(
        fn, arr, ex, cold, ev, tix, masks, betas, prior, threshold,
        kernel=kernel, routers=routers, router_ix=router_ix,
        n_nodes=n_nodes, seeds=seeds, delays=delays, n_fns=n_fns,
        capacity=capacity, queue_cap=queue_cap, stream=stream, seg=seg,
        n_live=n_live, deadlines=deadlines, tl_bins=tl_bins,
        tl_bucket=tl_bucket)
    arr_l = None
    if not stream:
        arr_l = arr.to(torch.float64)[tix]
        if "node_of" in out:
            d = E._as_tensor(delays, torch.float64, arr.device)
            shift = d.gather(1, out["node_of"].to(torch.int64))
            arr_l = torch.where((d > 0).any(1)[:, None], arr_l + shift,
                                arr_l)
    res = E.reduce_metrics(out, arr_l, fn.shape[1], n_live, stream,
                           keep_responses)
    res["node_done"] = out["node_done"]
    return res
