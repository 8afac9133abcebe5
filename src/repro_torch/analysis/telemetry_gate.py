"""Telemetry free when off: the trace rail costs nothing untraced.

Counterpart of `repro.analysis.telemetry_gate` (no callback in the
untraced HLO, the ordered callback present in the traced jaxpr). The
port's rail is a compile-time flag of K0 and a ``trace`` argument of the
eager loops, so:

* **build units** -- the untraced event-loop units (``event_loop`` and
  `_build.CLUSTER_UNITS`) are compiled without ``K0_TRACED`` (neither
  their source nor their nvcc flags, `_build.nvcc_flags`, define it), the
  traced units define it, and the wrapper sends an untraced launch only
  to an untraced unit; on a card, the untraced libraries export no
  traced entry and the traced ones do;
* **eager loops** -- an untraced run of either eager loop never calls
  `repro_torch.core.engine.flush_trace`; the positive check: a traced
  run does (so the gate cannot pass vacuously if the flush is renamed).
"""
from __future__ import annotations

import re
from typing import Dict, List

_DEFINE = re.compile(r"^\s*#\s*define\s+K0_TRACED\b", re.M)
_TRACED_ENTRIES = {"event_loop_traced_run", "event_loop_cluster_traced_run"}


def _unit_traced(unit: str) -> bool:
    from repro_torch.kernels import _build
    src = (_build.CSRC / f"{unit}.cu").read_text()
    flags = " ".join(_build.nvcc_flags(unit))
    return bool(_DEFINE.search(src)) or "K0_TRACED" in flags


def audit_units(device=None) -> Dict:
    from repro_torch.kernels import _build
    from repro_torch.kernels import event_loop as K0
    untraced = ("event_loop",) + _build.CLUSTER_UNITS
    traced = _build.TRACED_UNITS + _build.CLUSTER_TRACED_UNITS
    problems = [f"{u}: the untraced unit compiles the trace rail in "
                "(K0_TRACED)" for u in untraced if _unit_traced(u)]
    problems += [f"{u}: the traced unit does not define K0_TRACED"
                 for u in traced if not _unit_traced(u)]
    routed = set(K0.CLUSTER_SOURCE.values()) | {"event_loop"}
    problems += [f"an untraced launch goes to {u}, which is not an "
                 "untraced unit" for u in sorted(routed - set(untraced))]
    exports = {}
    if device is not None and device.type == "cuda":
        for u in untraced + traced:
            lib = _build.load_library(u)
            has = sorted(e for e in _TRACED_ENTRIES if hasattr(lib, e))
            exports[u] = has
            if (u in traced) != bool(has):
                problems.append(f"{u}: exports {has or 'no'} traced entry")
    return dict(entry="build_units", passed=not problems,
                untraced=list(untraced), traced=list(traced),
                traced_exports=exports or None, problems=problems)


def _flushes(run) -> int:
    """How often ``run()`` calls the eager loops' flush."""
    from repro_torch.core import engine as E
    real, calls = E.flush_trace, []

    def counted(rec):
        calls.append(1)
        return real(rec)

    E.flush_trace = counted
    try:
        run()
    finally:
        E.flush_trace = real
    return len(calls)


def audit_eager(n_requests: int = 30) -> Dict:
    """Untraced runs of both eager loops (CPU tensors, ``n_requests``
    requests) make no flush; traced runs make at least one each."""
    import torch

    from repro_torch.api.runner import trace_operands
    from repro_torch.api.spec import SyntheticTrace
    from repro_torch.cluster.engine import simulate_cluster_eager
    from repro_torch.cluster.routers import get_router
    from repro_torch.core import engine as E
    from repro_torch.core.policies import KERNELS
    from repro_torch.telemetry import rail
    cpu = torch.device("cpu")
    a = SyntheticTrace.make(n_functions=4, n_requests=n_requests,
                            seed=1).arrays()
    ops = trace_operands({k: v[None].copy() for k, v in a.items()}, cpu)
    args = (ops["fn_id"], ops["arrival"], ops["exec_time"],
            ops["cold_start"], ops["evict"], torch.zeros(1, dtype=torch.int64))
    kw = dict(kernel=KERNELS["esff"], n_fns=4, queue_cap=64)
    one = torch.ones(1, dtype=torch.int64)
    beta = torch.ones(1, dtype=torch.float64)

    def single(trace):
        return lambda: E.simulate_eager(
            *args, torch.ones((1, 2), dtype=torch.bool), beta, 0.1,
            capacity=2, trace=trace, **kw)

    def cluster(trace):
        return lambda: simulate_cluster_eager(
            *args, torch.ones((1, 2, 2), dtype=torch.bool), beta, 0.1,
            routers=(get_router("jsq2"),), router_ix=one - 1,
            n_nodes=one * 2, seeds=one - 1,
            delays=torch.zeros((1, 2), dtype=torch.float64), capacity=2,
            trace=trace, **kw)

    counts: Dict[str, int] = {}
    problems: List[str] = []
    for name, make in (("single", single), ("cluster", cluster)):
        counts[f"{name}_untraced"] = _flushes(make(False))
        with rail.collect():
            counts[f"{name}_traced"] = _flushes(make(True))
        if counts[f"{name}_untraced"]:
            problems.append(
                f"{name}: an untraced eager run flushed the trace rail "
                f"{counts[f'{name}_untraced']} time(s) -- the rail must "
                "cost nothing when trace=False")
        if not counts[f"{name}_traced"]:
            problems.append(
                f"{name}: a traced eager run never called flush_trace -- "
                "the flush changed; update this gate")
    return dict(entry="eager_flush", passed=not problems, flushes=counts,
                problems=problems)
