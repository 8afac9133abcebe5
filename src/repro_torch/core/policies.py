"""Policy kernels for the lane-batched engine (`repro_torch.core.engine`).

Counterpart of `repro.core.jax_policies`. Ported so far:

* **esff** -- FCP (Alg. 2) on arrival and FRP (Alg. 3) on completion,
  with running-mean estimation; ``beta`` = 1.0 is the paper-faithful
  scheduler. These hooks are the plain version of the event-loop
  kernel (`repro_torch.kernels.event_loop`, whose device functions
  ``on_arrival`` / ``on_cold_done`` / ``on_exec_done`` mirror them):
  `engine.simulate` runs them only on the CPU, or on a card when called
  through `engine.simulate_eager`. Their FRP scan over all functions
  goes through `repro_torch.kernels.frp_select.frp_select_lanes`.

The other policies (esff_h, sff, openwhisk, faascache, openwhisk_v2)
are ROADMAP Queue 1, item 1.

Hooks follow the engine's guarded-write convention: they run every
event for every lane, compute with possibly-garbage values where their
``on`` predicate is false, and fold the predicate into every write.
Ties break like the Python engine's scans: toward the earliest-created
instance (``slot_seq``) and the lowest function index.
"""
from __future__ import annotations

import torch

from repro_torch.core.engine import (BIG, IDLE, PolicyKernel, dispatch,
                                     k_counts, lex_argmin, pick_idle_own,
                                     start_cold)
from repro_torch.kernels.frp_select import frp_select_lanes


class ESFFKernel(PolicyKernel):
    """ESFF (Algorithms 1-3)."""

    def __init__(self, name: str = "esff", *, default_beta: float = 1.0):
        self.name = name
        self.default_beta = default_beta

    # ------------------------------------------------- FCP (Algorithm 2)
    def on_arrival(self, ctx, s, rid, t, on):
        j = ctx.fn_at(rid)
        means = ctx.est_means(s)
        K = k_counts(ctx, s)
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
        start_cold(ctx, s, torch.argmax(empty.to(torch.uint8), dim=1), j,
                   t, torch.full_like(j, -1), queued & empty_any & (n_e > 0))

        # Eq. (8): convert an idle instance of another function
        slot_fn = s["slot_fn"]
        idle = ((s["slot_state"] == IDLE) & (slot_fn >= 0)
                & (slot_fn != j[:, None]) & ctx.cap_mask)
        sf = torch.where(slot_fn >= 0, slot_fn, 0)
        n_e2 = (qj[:, None] + 1.0
                - (tcj[:, None] + ctx.t_evict.gather(1, sf)) * Kj[:, None]
                / mj[:, None])
        elig = idle & (n_e2 > 0)
        # victim: argmax of the running mean, ties toward the
        # earliest-created instance
        victim = lex_argmin(-means.gather(1, sf), s["slot_seq"], elig)
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
        means = ctx.est_means(s)
        K = k_counts(ctx, s)
        nw = s["q_len"]
        nwj = ctx.row(nw, jc, ctx.F).to(torch.float64)
        tvj = ctx.row(ctx.t_evict, jc, ctx.F)
        # Eq. (9): the finishing function's own weight
        w_own = torch.where(
            nwj > 0,
            ctx.row(means, jc, ctx.F)
            + tvj * ctx.row(K, jc, ctx.F) / torch.clamp_min(nwj, 1),
            BIG)
        # Eq. (7) swapped + Eq. (10) with beta, first-index argmin
        best_w, best_i = frp_select_lanes(
            means, ctx.t_cold, ctx.t_evict, nw, K, tvj,
            jc.to(torch.int32), ctx.beta)
        replace = on & (best_i >= 0) & (best_w < w_own)
        start_cold(ctx, s, slot, best_i.to(torch.int64), t, j, replace)
        take = on & ~replace & (ctx.row(s["q_len"], jc, ctx.F) > 0)
        rid2 = ctx.q_pop(s, j, take)
        dispatch(ctx, s, slot, rid2, t, take)


KERNELS = {"esff": ESFFKernel("esff")}
