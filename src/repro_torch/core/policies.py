"""Policy kernels for the lane-batched engine (`repro_torch.core.engine`).

Counterpart of `repro.core.jax_policies`, every policy of it:

* **esff** -- FCP (Alg. 2) on arrival and FRP (Alg. 3) on completion,
  with running-mean estimation; ``beta`` = 1.0 is the paper-faithful
  scheduler.
* **esff_h** -- ESFF plus the three ESFF-H fixes
  (`repro_torch.core.esff_h`): beta hysteresis (default 2.0),
  cold-aware drain estimates (each instance still warming up claims one
  waiting request) and the LRU victim in Eq. 8.
* **sff / openwhisk** -- the central-queue baselines: immediate
  scale-up on arrival (LRU eviction at capacity), warm reuse of a freed
  slot's own queue, else retarget to the central-queue head (at most
  one warming replica). SFF orders the central queue by running-mean
  execution time, OpenWhisk by arrival.
* **faascache** -- OpenWhisk scheduling with GREEDY-DUAL keep-alive
  [Fuerst & Sharma, ASPLOS'21]: per-slot ``slot_freq`` / ``slot_prio``
  and a lane clock ``gd_clock``.
* **openwhisk_v2** -- per-function queues; a queue head waits
  ``threshold`` before it may scale up, through the engine's timer rail.

These hooks are the plain version of the event-loop kernel
(`repro_torch.kernels.event_loop`, whose policy variants in
``csrc/event_loop.cu`` mirror them): `engine.simulate` runs them only on
the CPU, or on a card when called through `engine.simulate_eager`. The
ESFF hooks' FRP scan over all functions goes through
`repro_torch.kernels.frp_select.frp_select_lanes` (with the cold-aware
term for ESFF-H).

Hooks follow the engine's guarded-write convention: they run every
event for every lane, compute with possibly-garbage values where their
``on`` predicate is false, and fold the predicate into every write.
Each keeps the reference's order of operations. Ties break like the
Python engine's scans: toward the earliest-created instance
(``slot_seq``) and the lowest function index.
"""
from __future__ import annotations

import torch

from repro_torch.core.engine import (BIG, COLD, IDLE, PolicyKernel, _hit,
                                     cold_counts, dispatch,
                                     k_counts, lex_argmin, pick_idle_own,
                                     q_head, rearm_timer, start_cold)
from repro_torch.kernels.frp_select import frp_select_lanes


def _first(mask):
    """First set index per lane (0 when none): ``jnp.argmax`` of a
    bool row."""
    return torch.argmax(mask.to(torch.uint8), dim=1)


def _warming(ctx, s, fn):
    """Whether ``fn`` has an instance warming up, (L,)."""
    return ((s["slot_fn"] == fn[:, None]) & (s["slot_state"] == COLD)
            & ctx.cap_mask).any(1)


def _no_evict(fn):
    return torch.full_like(fn, -1)


class ESFFKernel(PolicyKernel):
    """ESFF (Algorithms 1-3); the flags select the ESFF-H variants."""

    def __init__(self, name: str = "esff", *, lru_victim: bool = False,
                 cold_aware: bool = False, default_beta: float = 1.0):
        self.name = name
        self.lru_victim = lru_victim
        self.cold_aware = cold_aware
        self.default_beta = default_beta

    def _drain_terms(self, ctx, s):
        """means, |K|, and the cold-instance correction of Eq. 6/7."""
        coldK = cold_counts(ctx, s) if self.cold_aware else None
        return ctx.est_means(s), k_counts(ctx, s), coldK

    # ------------------------------------------------- FCP (Algorithm 2)
    def on_arrival(self, ctx, s, rid, t, on):
        j = ctx.fn_at(rid)
        means, K, coldK = self._drain_terms(ctx, s)
        has_own, own_slot = pick_idle_own(ctx, s, j)
        qj = ctx.row(s["q_len"], j, ctx.F).to(torch.float64)
        direct = on & has_own & (qj == 0)
        dispatch(ctx, s, own_slot, rid, t, direct)
        ctx.q_consume_direct(s, j, direct)
        queued = on & ~direct

        # Eq. (7) for an empty slot: start one if the backlog outlasts
        # a cold start
        empty = (s["slot_fn"] < 0) & ctx.cap_mask
        empty_any = empty.any(1)
        tcj = ctx.row(ctx.t_cold, j, ctx.F)
        Kj = ctx.row(K, j, ctx.F)
        mj = ctx.row(means, j, ctx.F)
        n_e = qj + 1.0 - tcj * Kj / mj
        if self.cold_aware:
            cj = ctx.row(coldK, j, ctx.F).to(torch.float64)
            n_e = n_e - cj
        start_cold(ctx, s, _first(empty), j, t, _no_evict(j),
                   queued & empty_any & (n_e > 0))

        # Eq. (8): convert an idle instance of another function
        slot_fn = s["slot_fn"]
        idle = ((s["slot_state"] == IDLE) & (slot_fn >= 0)
                & (slot_fn != j[:, None]) & ctx.cap_mask)
        sf = torch.where(slot_fn >= 0, slot_fn, 0)
        n_e2 = (qj[:, None] + 1.0
                - (tcj[:, None] + ctx.t_evict.gather(1, sf)) * Kj[:, None]
                / mj[:, None])
        if self.cold_aware:
            n_e2 = n_e2 - cj[:, None]
        elig = idle & (n_e2 > 0)
        # victim: argmax of the running mean (ESFF) or LRU (ESFF-H),
        # ties toward the earliest-created instance
        primary = (s["slot_used"] if self.lru_victim
                   else -means.gather(1, sf))
        victim = lex_argmin(primary, s["slot_seq"], elig)
        start_cold(ctx, s, victim, j, t, ctx.row(slot_fn, victim, ctx.C),
                   queued & ~empty_any & elig.any(1))
        ctx.q_push(s, j, rid, queued)

    # ----------------------------------------------------- instance ready
    def on_cold_done(self, ctx, s, slot, t, on):
        j = ctx.row(s["slot_fn"], slot, ctx.C)
        take = on & (ctx.row(s["q_len"], j, ctx.F) > 0)
        rid = ctx.q_pop(s, j, take)
        dispatch(ctx, s, slot, rid, t, take)

    # ------------------------------------------------- FRP (Algorithm 3)
    def on_exec_done(self, ctx, s, slot, rid, t, on):
        j = ctx.row(s["slot_fn"], slot, ctx.C)
        jc = j.clamp(0, ctx.F - 1)
        means, K, coldK = self._drain_terms(ctx, s)
        nw = s["q_len"]
        nwj = ctx.row(nw, jc, ctx.F).to(torch.float64)
        tvj = ctx.row(ctx.t_evict, jc, ctx.F)
        # Eq. (9): the finishing function's own weight
        w_own = torch.where(
            nwj > 0,
            ctx.row(means, jc, ctx.F)
            + tvj * ctx.row(K, jc, ctx.F) / torch.clamp_min(nwj, 1),
            BIG)
        # Eq. (7) swapped (less coldK for ESFF-H) + Eq. (10) with beta,
        # first-index argmin
        best_w, best_i = frp_select_lanes(
            means, ctx.t_cold, ctx.t_evict, nw, K, tvj,
            jc.to(torch.int32), ctx.beta, coldK)
        replace = on & (best_i >= 0) & (best_w < w_own)
        start_cold(ctx, s, slot, best_i.to(torch.int64), t, j, replace)
        take = on & ~replace & (ctx.row(s["q_len"], jc, ctx.F) > 0)
        rid2 = ctx.q_pop(s, j, take)
        dispatch(ctx, s, slot, rid2, t, take)


class CentralQueueKernel(PolicyKernel):
    """OpenWhisk / SFF: central queue + immediate scale-up + LRU keep-
    alive, with warm reuse of a freed slot's own waiting requests.

    The dispatch bookkeeping, the eviction-victim key, the eviction
    note and the new-instance reset are hooks that FaasCache overrides
    to swap LRU for GREEDY-DUAL priorities."""

    def __init__(self, name: str, *, order: str = "fifo"):
        assert order in ("fifo", "sff")
        self.name = name
        self.order = order

    # -- keep-alive hooks (FaasCache overrides) --------------------------
    def _dispatch(self, ctx, s, slot, rid, t, on):
        dispatch(ctx, s, slot, rid, t, on)

    def _victim_key(self, ctx, s):
        """Primary eviction key among idle slots (ties: slot_seq)."""
        return s["slot_used"]    # LRU

    def _note_evict(self, ctx, s, victim, on):
        pass

    def _start_cold(self, ctx, s, slot, fn, t, evict_fn, on):
        start_cold(ctx, s, slot, fn, t, evict_fn, on)

    def _head_fn(self, ctx, s):
        """Central-queue head: (exists, fn) per lane. Requests are
        globally FIFO-comparable by id, so OpenWhisk minimises the head
        id and SFF (running mean, id) lexicographically."""
        heads = s["q_head_rid"]
        valid = s["q_len"] > 0
        primary = (ctx.est_means(s) if self.order == "sff"
                   else torch.zeros_like(s["est_sum"]))
        return valid.any(1), lex_argmin(primary, heads, valid)

    def _scale_up(self, ctx, s, j, t, on):
        """No idle instance for an arrival of ``j``: claim a free slot,
        else evict the keep-alive victim (ties: earliest-created)."""
        empty = (s["slot_fn"] < 0) & ctx.cap_mask
        empty_any = empty.any(1)
        self._start_cold(ctx, s, _first(empty), j, t, _no_evict(j),
                         on & empty_any)
        idle = ((s["slot_state"] == IDLE) & (s["slot_fn"] >= 0)
                & ctx.cap_mask)
        victim = lex_argmin(self._victim_key(ctx, s), s["slot_seq"], idle)
        evicting = on & ~empty_any & idle.any(1)
        self._note_evict(ctx, s, victim, evicting)
        self._start_cold(ctx, s, victim, j, t,
                         ctx.row(s["slot_fn"], victim, ctx.C), evicting)

    def on_arrival(self, ctx, s, rid, t, on):
        j = ctx.fn_at(rid)
        has_own, own_slot = pick_idle_own(ctx, s, j)
        direct = on & has_own & (ctx.row(s["q_len"], j, ctx.F) == 0)
        self._dispatch(ctx, s, own_slot, rid, t, direct)
        ctx.q_consume_direct(s, j, direct)
        queued = on & ~direct
        ctx.q_push(s, j, rid, queued)
        self._scale_up(ctx, s, j, t, queued)

    def _serve_or_replace(self, ctx, s, slot, t, on):
        """Central-queue discipline for a freed idle slot: drain its own
        function's earliest request (warm reuse), else retarget to the
        queue-head function -- at most one warming replica at a time."""
        j = ctx.row(s["slot_fn"], slot, ctx.C)
        own = on & (ctx.row(s["q_len"], j, ctx.F) > 0)
        rid = ctx.q_pop(s, j, own)
        self._dispatch(ctx, s, slot, rid, t, own)

        exists, f = self._head_fn(ctx, s)
        retarget = on & ~own & exists & ~_warming(ctx, s, f)
        self._note_evict(ctx, s, slot, retarget)
        self._start_cold(ctx, s, slot, f, t, j, retarget)

    def on_cold_done(self, ctx, s, slot, t, on):
        self._serve_or_replace(ctx, s, slot, t, on)

    def on_exec_done(self, ctx, s, slot, rid, t, on):
        self._serve_or_replace(ctx, s, slot, t, on)


class FaasCacheKernel(CentralQueueKernel):
    """FaasCache [Fuerst & Sharma, ASPLOS'21]: OpenWhisk scheduling
    with GREEDY-DUAL keep-alive.

    Per-slot state: ``slot_freq`` (use count of the resident instance)
    and ``slot_prio`` (= clock + (freq + 1) * cold_start, recomputed at
    every dispatch with the pre-increment freq); ``gd_clock`` is the
    lane's clock, raised to the victim's priority on every eviction. A
    fresh instance keeps priority 0.0 until its first dispatch."""

    def __init__(self, name: str = "faascache"):
        super().__init__(name, order="fifo")

    def extra_state(self, L, C, F):
        return dict(slot_freq=torch.zeros((L, C), dtype=torch.int32),
                    slot_prio=torch.zeros((L, C), dtype=torch.float64),
                    gd_clock=torch.zeros((L,), dtype=torch.float64))

    def _dispatch(self, ctx, s, slot, rid, t, on):
        sc = slot.clamp(0, ctx.C - 1)
        fn = ctx.row(s["slot_fn"], sc, ctx.C).clamp(0, ctx.F - 1)
        freq = ctx.row(s["slot_freq"], sc, ctx.C).to(torch.float64)
        prio = s["gd_clock"] + (freq + 1.0) * ctx.row(ctx.t_cold, fn, ctx.F)
        m = _hit(on, slot, ctx.ar_c)
        s["slot_freq"] = s["slot_freq"] + m
        s["slot_prio"] = torch.where(m, prio[:, None], s["slot_prio"])
        dispatch(ctx, s, slot, rid, t, on)

    def _victim_key(self, ctx, s):
        return s["slot_prio"]    # GREEDY-DUAL

    def _note_evict(self, ctx, s, victim, on):
        prio = ctx.row(s["slot_prio"], victim, ctx.C)
        s["gd_clock"] = torch.maximum(s["gd_clock"],
                                      torch.where(on, prio, -BIG))

    def _start_cold(self, ctx, s, slot, fn, t, evict_fn, on):
        start_cold(ctx, s, slot, fn, t, evict_fn, on)
        m = _hit(on, slot, ctx.ar_c)
        s["slot_freq"] = torch.where(m, 0, s["slot_freq"])
        s["slot_prio"] = torch.where(m, 0.0, s["slot_prio"])


class OpenWhiskV2Kernel(PolicyKernel):
    """Per-function queues + head-wait threshold before scale-up.

    Timers keep the reference's quirks: a timer firing for a request
    that is not its queue's head is a no-op (the then-head's own timer
    is relied upon), and a blocked head (its function still warming,
    or nothing evictable) re-arms at ``t + threshold``."""

    has_timers = True

    def __init__(self, name: str = "openwhisk_v2"):
        self.name = name

    def on_arrival(self, ctx, s, rid, t, on):
        j = ctx.fn_at(rid)
        has_own, own_slot = pick_idle_own(ctx, s, j)
        direct = on & has_own & (ctx.row(s["q_len"], j, ctx.F) == 0)
        dispatch(ctx, s, own_slot, rid, t, direct)
        ctx.q_consume_direct(s, j, direct)
        queued = on & ~direct
        pushed = ctx.q_push(s, j, rid, queued)
        ctx.arm_timer(s, j, rid, t, pushed, on)

    def on_timer(self, ctx, s, rid, t, on):
        j = ctx.fn_at(rid)
        is_head = ((ctx.row(s["q_len"], j, ctx.F) > 0)
                   & (q_head(ctx, s, j) == rid))
        act = on & is_head
        warming = _warming(ctx, s, j)

        empty = (s["slot_fn"] < 0) & ctx.cap_mask
        empty_any = empty.any(1)
        scale = act & ~warming
        start_cold(ctx, s, _first(empty), j, t, _no_evict(j),
                   scale & empty_any)
        idle = ((s["slot_state"] == IDLE) & (s["slot_fn"] >= 0)
                & ctx.cap_mask)
        idle_any = idle.any(1)
        victim = lex_argmin(s["slot_used"], s["slot_seq"], idle)
        start_cold(ctx, s, victim, j, t,
                   ctx.row(s["slot_fn"], victim, ctx.C),
                   scale & ~empty_any & idle_any)
        # blocked (still warming, or nothing evictable): retry later
        rearm = (act & warming) | (scale & ~empty_any & ~idle_any)
        rearm_timer(ctx, s, j, rid, t + ctx.threshold, rearm)

    def _drain_own(self, ctx, s, slot, t, on):
        j = ctx.row(s["slot_fn"], slot, ctx.C)
        take = on & (ctx.row(s["q_len"], j, ctx.F) > 0)
        rid = ctx.q_pop(s, j, take)
        dispatch(ctx, s, slot, rid, t, take)

    def on_cold_done(self, ctx, s, slot, t, on):
        self._drain_own(ctx, s, slot, t, on)

    def on_exec_done(self, ctx, s, slot, rid, t, on):
        self._drain_own(ctx, s, slot, t, on)


# The same six names and defaults as `repro.core.jax_policies.KERNELS`.
KERNELS = {
    "esff": ESFFKernel("esff"),
    "esff_h": ESFFKernel("esff_h", lru_victim=True, cold_aware=True,
                         default_beta=2.0),
    "sff": CentralQueueKernel("sff", order="sff"),
    "openwhisk": CentralQueueKernel("openwhisk", order="fifo"),
    "faascache": FaasCacheKernel(),
    "openwhisk_v2": OpenWhiskV2Kernel(),
}
