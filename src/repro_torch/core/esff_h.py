"""ESFF-H — beyond-paper scheduler (EXPERIMENTS.md §Perf, scheduling side).

Three measured pathologies of literal ESFF are fixed (each validated in
EXPERIMENTS.md §Repro; β=1 + the flags off recover exact ESFF):

1. **Lateral ping-pong** (dense-queue regimes): FRP converts slots
   between two hot functions whose queues coexist; each round trip costs
   t_v + t_l' + t_v' + t_l (~4-5 s) while serving milliseconds of work.
   Fix: a *hysteresis factor* ``beta`` > 1 on the conversion setup cost
   in the candidate weight, so a steal must beat the incumbent by the
   amortised round-trip cost, not half of it.

2. **Double provisioning**: Eq. (6)/(7) ignore instances already warming
   up (state COLD) — for long functions the drain term ``window*K/t_e``
   is ~0, so a second instance starts although one is seconds from
   ready. Fix: each in-flight instance claims one waiting request in the
   drain estimate (``n_e -= K_cold``).

3. **Warm-pool blindness** (abundant-capacity regimes): FCP's victim
   rule (Eq. 8, argmax t̄_e) repeatedly evicts the hottest long
   functions' idle instances; at capacity 32 the LRU-keep-alive
   baselines beat literal ESFF by 1.6x on warm hits alone. Fix: among
   Eq. 8's eligible candidates, evict the LEAST-RECENTLY-USED instead
   (``lru_victim``). With it, ESFF-H beats every baseline at every
   capacity 8-32 (benchmarks/fig5).

Everything else — weights, FCP/FRP structure, per-function queues — is
inherited from the faithful ESFF implementation.
"""
from __future__ import annotations

from repro_torch.core.esff import ESFF
from repro_torch.core.policy import POLICIES
from repro_torch.core.server import InstanceState


@POLICIES.register("esff_h")
class ESFFH(ESFF):
    name = "esff_h"
    beta = 2.0          # hysteresis on conversion setup cost
    lru_victim = True   # Eq. 8 victim: LRU among eligible (vs argmax t_e)

    def _cold_count(self, fn_id: int) -> int:
        srv = self.server
        return sum(1 for i in srv.by_fn[fn_id]
                   if srv.instances[i].state == InstanceState.COLD)

    def _drain_estimate(self, fn_id: int, window: float) -> float:
        base = super()._drain_estimate(fn_id, window)
        return base - self._cold_count(fn_id)

    def _weight_candidate(self, fn_id: int, n_e: float) -> float:
        f = self.functions[fn_id]
        k = self.server.k_count(fn_id)
        return (self.est.mean(fn_id)
                + self.beta * (f.cold_start + f.evict) * (k + 1) / n_e)

    def on_arrival(self, req, t):
        if not self.lru_victim:
            return super().on_arrival(req, t)
        fn = req.fn_id
        srv = self.server
        idle = srv.idle_of(fn)
        if not self.queues[fn] and idle is not None:
            srv.dispatch(idle, req, t)
            return
        if srv.has_free_slot():
            n_e = self._drain_estimate(fn, self.functions[fn].cold_start)
            if n_e > 0:
                srv.start_cold(fn, t)
        else:
            best, best_lru = None, None
            for inst in srv.idle_instances():
                if inst.fn_id == fn:
                    continue
                window = (self.functions[fn].cold_start
                          + self.functions[inst.fn_id].evict)
                if self._drain_estimate(fn, window) > 0:
                    if best is None or inst.last_used < best_lru:
                        best, best_lru = inst, inst.last_used
            if best is not None:
                srv.start_cold(fn, t, evict=best)
        self.queues[fn].append(req)
