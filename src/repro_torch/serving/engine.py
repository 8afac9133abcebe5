"""Edge serving engine: the paper's scheduler driving real models
(counterpart of `repro.serving.engine`).

The engine reuses the event-driven core (``repro_torch.core``) unchanged —
policies, server slots, metrics — but the *times are measured, not
simulated*: a cold start really builds/compiles the model
(ModelInstance.cold_start) and an execution really runs
prefill+decode (ModelInstance.execute). Measured durations feed back
into the discrete-event clock, so a trace's worth of requests is
evaluated in one pass without wall-clock idling, while every service
time is a genuine accelerator measurement. Models run on ``device``:
CUDA unless the caller passes ``device="cpu"``.

Straggler mitigation: an execution exceeding ``straggler_factor`` x the
function's running-mean is recorded and (optionally) re-dispatched to a
second instance — the duplicate's completion wins (speculative
execution; see tests/test_torch_serving.py).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.utils.device import resolve_device
from repro_torch.core.events import EventKind, EventQueue
from repro_torch.core.metrics import SimResult, collect
from repro_torch.core.policy import POLICIES, Policy
from repro_torch.core.request import FunctionProfile, Request
from repro_torch.core.server import EdgeServer, ExecTimeEstimator
from repro_torch.serving.instance import ModelInstance, ServedFunction
from repro_torch.utils import get_logger

log = get_logger("serving")


class EdgeServingEngine:
    """C-slot edge server serving real models under a core policy."""

    def __init__(self, functions: Sequence[ServedFunction], capacity: int,
                 policy: str = "esff", straggler_factor: float = 0.0,
                 seed: int = 0, device=None):
        self.served = list(functions)
        self.device = resolve_device(device)
        self.capacity = capacity
        self.policy_name = policy
        self.straggler_factor = straggler_factor
        self.seed = seed
        # measured platform profile (filled by warm_profile)
        self.profiles: Dict[int, FunctionProfile] = {}
        self._instances: Dict[int, ModelInstance] = {}
        self.stragglers: List[dict] = []

    # ------------------------------------------------------------ setup
    def _measure_function(self, fn: ServedFunction) -> FunctionProfile:
        """One throwaway instance measures t_l (cold) and seeds t_e."""
        inst = ModelInstance(fn, self.device)
        cold = inst.cold_start()
        exec_s = inst.execute(seed=0)
        evict = inst.evict() + 1e-4
        return FunctionProfile(fn.fn_id, cold_start=cold, evict=evict,
                               true_mean_exec=exec_s, name=fn.name)

    def warm_profile(self) -> Dict[int, FunctionProfile]:
        for fn in self.served:
            p = self._measure_function(fn)
            self.profiles[fn.fn_id] = p
            log.info("profiled %s: cold %.3fs exec %.4fs", fn.name,
                     p.cold_start, p.true_mean_exec)
        return self.profiles

    # ------------------------------------------------------------- run
    def run(self, requests: Sequence[Request]) -> SimResult:
        """Serve ``requests`` (arrival times define the event clock;
        exec/cold times are measured live)."""
        if not self.profiles:
            self.warm_profile()
        functions = [self.profiles[f.fn_id] for f in self.served]
        events = EventQueue()
        server = EdgeServer(functions, self.capacity, events)
        est = ExecTimeEstimator(len(functions))
        policy: Policy = POLICIES[self.policy_name]()
        policy.bind(server, est)

        by_id = {f.fn_id: f for f in self.served}
        live: Dict[int, ModelInstance] = {}   # inst_id -> replica

        # live execution: measured service time replaces trace exec_time
        orig_dispatch = server.dispatch

        def live_dispatch(inst, req, t):
            replica = live.get(inst.inst_id)
            if replica is None or replica.model is None:
                replica = ModelInstance(by_id[inst.fn_id], self.device)
                replica.cold_start()   # should be rare: warm pool miss
                live[inst.inst_id] = replica
            measured = replica.execute(seed=req.req_id)
            mean = est.mean(req.fn_id)
            if (self.straggler_factor and est.n[req.fn_id] > 3
                    and measured > self.straggler_factor * mean):
                # speculative re-execution: duplicate wins
                dup = replica.execute(seed=req.req_id)
                self.stragglers.append(dict(
                    req=req.req_id, fn=req.fn_id, measured=measured,
                    mean=mean, dup=dup))
                measured = min(measured, dup)
            req.exec_time = measured
            orig_dispatch(inst, req, t)

        orig_cold = server.start_cold

        def live_cold(fn_id, t, evict=None):
            if evict is not None:
                rep = live.pop(evict.inst_id, None)
                if rep is not None:
                    functions[evict.fn_id].evict = max(rep.evict(), 1e-4)
            replica = ModelInstance(by_id[fn_id], self.device)
            measured = replica.cold_start()
            functions[fn_id].cold_start = measured   # event clock uses
            inst = orig_cold(fn_id, t, evict=evict)  # the measured value
            live[inst.inst_id] = replica
            return inst

        server.dispatch = live_dispatch
        server.start_cold = live_cold

        for r in requests:
            r.start = -1.0
            r.completion = -1.0
            events.push(r.arrival, EventKind.ARRIVAL, r)

        t0 = time.perf_counter()
        while True:
            ev = events.pop()
            if ev is None:
                break
            if ev.kind == EventKind.ARRIVAL:
                policy.on_arrival(ev.payload, ev.time)
            elif ev.kind == EventKind.EXEC_DONE:
                inst = ev.payload
                req = inst.current
                est.observe(req.fn_id, req.exec_time)
                policy.on_exec_done(inst, req, ev.time)
            elif ev.kind == EventKind.COLD_DONE:
                policy.on_cold_done(ev.payload, ev.time)
            elif ev.kind == EventKind.TIMER:
                policy.on_timer(ev.payload, ev.time)
        wall = time.perf_counter() - t0
        return collect(self.policy_name, self.capacity, list(requests),
                       server.stats, wall,
                       {"engine": "live", "stragglers":
                        len(self.stragglers)})

    # --------------------------------------------------------- helpers
    def make_requests(self, n: int, duration: float,
                      popularity: Optional[Sequence[float]] = None,
                      seed: int = 0) -> List[Request]:
        rng = np.random.default_rng(seed)
        F = len(self.served)
        p = np.asarray(popularity if popularity is not None
                       else 1.0 / np.arange(1, F + 1))
        p = p / p.sum()
        fns = rng.choice(F, size=n, p=p)
        arr = np.sort(rng.uniform(0, duration, n))
        return [Request(i, int(self.served[f].fn_id), float(t), 0.0)
                for i, (f, t) in enumerate(zip(fns, arr))]
