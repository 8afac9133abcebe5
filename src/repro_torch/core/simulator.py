"""Event loop driving a scheduling policy over a request trace.

``simulate(trace, policy, capacity)`` is the single entry point used by
tests, benchmarks and the serving engine's shadow mode.
"""
from __future__ import annotations

import time as _time
from typing import Optional, Union

from repro_torch.core.events import EventKind, EventQueue
from repro_torch.core.metrics import SimResult, collect
from repro_torch.core.policy import POLICIES, Policy
from repro_torch.core.request import Trace
from repro_torch.core.server import EdgeServer, ExecTimeEstimator


def simulate(trace: Trace, policy: Union[str, Policy], capacity: int,
             *, oracle_exec: bool = False, exec_prior: float = 0.1,
             max_events: Optional[int] = None) -> SimResult:
    """Run ``policy`` over ``trace`` on a C-slot edge server.

    oracle_exec=True gives the scheduler the true per-function mean
    execution times (used for validation); the default estimates them
    online from completions, as the paper's ESFF does.
    """
    if isinstance(policy, str):
        policy = POLICIES[policy]()
    events = EventQueue()
    server = EdgeServer(trace.functions, capacity, events)
    oracle = ([f.true_mean_exec for f in trace.functions]
              if oracle_exec else None)
    est = ExecTimeEstimator(trace.n_functions, prior=exec_prior,
                            oracle=oracle)
    policy.bind(server, est)

    for r in trace.requests:
        r.start = -1.0
        r.completion = -1.0
        events.push(r.arrival, EventKind.ARRIVAL, r)

    t0 = _time.perf_counter()
    n_events = 0
    while True:
        ev = events.pop()
        if ev is None:
            break
        n_events += 1
        if max_events is not None and n_events > max_events:
            raise RuntimeError(f"event budget exceeded ({max_events})")
        if ev.kind == EventKind.ARRIVAL:
            policy.on_arrival(ev.payload, ev.time)
        elif ev.kind == EventKind.EXEC_DONE:
            inst = ev.payload
            req = inst.current
            est.observe(req.fn_id, req.exec_time)   # history update first
            policy.on_exec_done(inst, req, ev.time)
        elif ev.kind == EventKind.COLD_DONE:
            policy.on_cold_done(ev.payload, ev.time)
        elif ev.kind == EventKind.TIMER:
            policy.on_timer(ev.payload, ev.time)
    wall = _time.perf_counter() - t0

    return collect(policy.name, capacity, trace.requests, server.stats,
                   wall, dict(trace.meta, n_events=n_events))
