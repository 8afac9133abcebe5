"""ESFF — Enhanced Shortest Function First (paper §V, Algorithms 1-3).

Two event-driven sub-policies:

* **FCP** (Function Creation Policy, Alg. 2) at request arrival: dispatch
  to an idle instance when the queue is empty, otherwise selectively cold
  start a new instance (Eq. 6) or replace another function's idle instance
  (Eqs. 7-8).
* **FRP** (Function Replacement Policy, Alg. 3) at request completion:
  replace the just-freed instance with the *most urgent* function — the
  smallest weight w_{j'} (Eq. 10) among functions with waiting requests —
  if w_{j'} <= w_j (Eq. 9).

Paper-typo resolutions are documented in DESIGN.md §1 and unit-tested
against the worked examples of Fig. 1 and Fig. 4.
"""
from __future__ import annotations

import math

from repro_torch.core.policy import POLICIES, Policy
from repro_torch.core.request import Request
from repro_torch.core.server import Instance, InstanceState


@POLICIES.register("esff")
class ESFF(Policy):
    name = "esff"

    def bind(self, server, estimator) -> None:
        super().bind(server, estimator)
        self._init_fn_queues()

    # ------------------------------------------------------------ weights
    def _weight_current(self, fn_id: int) -> float:
        """Eq. (9): w_j = t̄_e^j + t̄_v^j |K^j| / n_j^w  (∞ when queue empty).

        t̄_l is dropped from the numerator because f_j is already resident.
        """
        n_w = len(self.queues[fn_id])
        if n_w == 0:
            return math.inf
        f = self.functions[fn_id]
        k = self.server.k_count(fn_id)
        return self.est.mean(fn_id) + f.evict * k / n_w

    def _drain_estimate(self, fn_id: int, window: float) -> float:
        """Eq. (6)/(7) core: n^e = n^w + 1 - window * |K^j| / t̄_e^j.

        ``window`` is the unavailability window (cold start, plus eviction
        when a replacement is involved); |K^j| existing instances keep
        draining the queue during it.
        """
        n_w = len(self.queues[fn_id])
        k = self.server.k_count(fn_id)
        return n_w + 1.0 - window * k / self.est.mean(fn_id)

    def _weight_candidate(self, fn_id: int, n_e: float) -> float:
        """Eq. (10): w_{j'} = t̄_e + (t̄_l + t̄_v)(|K^{j'}|+1) / n^e_{j',j}."""
        f = self.functions[fn_id]
        k = self.server.k_count(fn_id)
        return self.est.mean(fn_id) + (f.cold_start + f.evict) * (k + 1) / n_e

    # ------------------------------------------------- FCP (Algorithm 2)
    def on_arrival(self, req: Request, t: float) -> None:
        fn = req.fn_id
        srv = self.server
        idle = srv.idle_of(fn)
        if not self.queues[fn] and idle is not None:
            srv.dispatch(idle, req, t)                      # lines 1-2
            return
        if srv.has_free_slot():                             # lines 4-7
            n_e = self._drain_estimate(fn, self.functions[fn].cold_start)
            if n_e > 0:
                srv.start_cold(fn, t)
        else:                                               # lines 8-12
            best, best_exec = None, -1.0
            for inst in srv.idle_instances():
                if inst.fn_id == fn:
                    # An idle own instance with a non-empty queue cannot
                    # occur (invariant), but guard anyway: just dispatch.
                    continue
                window = (self.functions[fn].cold_start
                          + self.functions[inst.fn_id].evict)
                if self._drain_estimate(fn, window) > 0:    # Eqs. (7)-(8)
                    mean = self.est.mean(inst.fn_id)
                    if mean > best_exec:
                        best, best_exec = inst, mean
            if best is not None:                            # argmax t̄_e^{j'}
                srv.start_cold(fn, t, evict=best)
        self.queues[fn].append(req)                         # line 13

    # ---------------------------------------------------- instance ready
    def on_cold_done(self, inst: Instance, t: float) -> None:
        q = self.queues[inst.fn_id]
        if q:
            self.server.make_idle(inst)
            self.server.dispatch(inst, q.popleft(), t)
        else:
            self.server.make_idle(inst)

    # ------------------------------------------------- FRP (Algorithm 3)
    def on_exec_done(self, inst: Instance, req: Request, t: float) -> None:
        fn = inst.fn_id
        srv = self.server
        w_x = self._weight_current(fn)                      # line 1 (Eq. 9)
        f_x = fn
        for g in self.functions:                            # lines 2-9
            j2 = g.fn_id
            if j2 == fn or not self.queues[j2]:
                continue                                    # S = {n^w > 0}
            window = g.cold_start + self.functions[fn].evict
            n_e = self._drain_estimate(j2, window)          # Eq. (7) swapped
            if n_e <= 0:
                continue
            w = self._weight_candidate(j2, n_e)             # Eq. (10)
            if w < w_x:
                w_x, f_x = w, j2
        if f_x != fn:                                       # lines 10-11
            srv.make_idle(inst)
            srv.start_cold(f_x, t, evict=inst)
        elif self.queues[fn]:                               # lines 12-13
            srv.make_idle(inst)
            srv.dispatch(inst, self.queues[fn].popleft(), t)
        else:                                               # lines 14-15
            srv.make_idle(inst)
