"""Lower the `ExperimentSpec.cluster` axis onto the routing tiers
(counterpart of `repro.cluster.runner`).

`run_cluster_experiment` executes one spec whose ``cluster`` field
declares a sequence of topologies and stacks the per-entry (P, T, K, B)
metric grids into a `ResultSet` with a trailing ``cluster`` axis,
labeled by `ClusterSpec.label`:

* ``None`` entries run the plain single-node path: `run_experiment` on a
  cluster-less copy of the spec, so those cells are bitwise the plain
  API's;
* static-router entries run the static tier
  (`repro_torch.cluster.static.run_static_entries`), all of them in one
  batch of lanes;
* dynamic-router entries run the K-node event loop
  (`repro_torch.cluster.engine.cluster_metrics`), all of them in one
  batch of lanes: each lane (entry x trace x capacity x beta) carries
  its own node count, node capacities, router, seed and delays, and its
  entry's churn toggles and delay schedule over the traces' horizon, so
  one engine call (one launch of the event-loop kernel's K-node variant
  on a card) runs a lane chunk of every dynamic entry of a policy.

Every entry contributes the same metric set (plain cells get a one-node
``node_done``), padded to the axis-wide largest node count; when an entry
routes through a circuit breaker, the others get an all-zero
``breaker_trips``. Under resilience every tier reads the same planned
outcomes (`ExperimentSpec.resilience_ops`), and ``goodput`` is derived
from the stacked counters.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Dict, List

import numpy as np
import torch

from repro_torch.cluster.static import run_static_entries


def _pad_node_dim(a: np.ndarray, k_max: int) -> np.ndarray:
    """Right-pad the trailing node axis with zeros to ``k_max``."""
    if a.shape[-1] == k_max:
        return a
    pad = [(0, 0)] * (a.ndim - 1) + [(0, k_max - a.shape[-1])]
    return np.pad(a, pad)


def pack_dynamic_lanes(spec, entries, T: int, horizon: float):
    """The dynamic tier's lanes for ``entries`` (dynamic `ClusterSpec`s)
    of ``spec`` over T traces of arrivals up to ``horizon``: entry-major,
    then trace, capacity, beta. Returns the routers (distinct, in entry
    order) and the lane columns ``trace_ix``, ``cap_mask`` (L, K, C) over
    the widest entry and largest node, ``n_nodes``, ``seeds``, ``delays``
    (L, K), ``router_ix`` and ``beta_ix`` (into the beta axis), numpy;
    when an entry has churn, ``churn_t`` (L, K, E), and when one has a
    delay schedule, ``dtimes`` / ``dvals`` (L, K, D) and ``dper`` (L, K),
    each padded to the widest entry (`BIG` toggle times, `BIG` step
    times, the last step's value); a lane without churn or a schedule
    gets all-`BIG` toggles and one step holding its constant delays."""
    from repro_torch.cluster.spec import BIG
    B = 1 if spec.betas is None else len(spec.betas)
    Kx = max(e.n_nodes for e in entries)
    C = max(max(e.node_caps(c)) for e in entries for c in spec.capacities)
    # each entry's lowerings over [0, horizon], as the JAX runner makes
    # them: the churn operand, the delay schedules, the constant delays
    ops = [(e.churn_operand(horizon), e.delay_ops(), e.delays())
           for e in entries]
    E = max((c.shape[1] for c, _, _ in ops if c is not None), default=0)
    D = max((d[0].shape[1] for _, d, _ in ops if d is not None), default=0)
    routers = []
    cols = {k: [] for k in ("trace_ix", "cap_mask", "n_nodes", "seeds",
                            "delays", "router_ix", "beta_ix", "churn_t",
                            "dtimes", "dvals", "dper")}
    for e, (churn, dops, consts) in zip(entries, ops):
        r = e.get_router()
        if r not in routers:
            routers.append(r)
        K = e.n_nodes
        delays = np.zeros((Kx,), np.float64)
        delays[:K] = consts
        churn_t = np.full((Kx, E), BIG, np.float64)
        if churn is not None:
            churn_t[:K, :churn.shape[1]] = churn
        dtimes = np.full((Kx, D), BIG, np.float64)
        dvals = np.zeros((Kx, D), np.float64)
        dper = np.zeros((Kx,), np.float64)
        if D:
            dtimes[:, 0] = 0.0
            dvals[:] = delays[:, None]
        if dops is not None:
            dt, dv, dp = dops
            dtimes[:K, :dt.shape[1]] = dt
            dvals[:K, :dv.shape[1]] = dv
            dvals[:K, dv.shape[1]:] = dv[:, -1:]
            dper[:K] = dp
        for t in range(T):
            for c in spec.capacities:
                mask = np.zeros((Kx, C), bool)
                for k, nc in enumerate(e.node_caps(c)):
                    mask[k, :nc] = True
                for b in range(B):
                    cols["trace_ix"].append(t)
                    cols["cap_mask"].append(mask)
                    cols["n_nodes"].append(e.n_nodes)
                    cols["seeds"].append(e.seed)
                    cols["delays"].append(delays)
                    cols["router_ix"].append(routers.index(r))
                    cols["beta_ix"].append(b)
                    cols["churn_t"].append(churn_t)
                    cols["dtimes"].append(dtimes)
                    cols["dvals"].append(dvals)
                    cols["dper"].append(dper)
    stacked = ("cap_mask", "delays", "churn_t", "dtimes", "dvals", "dper")
    lanes = {k: np.stack(v) if k in stacked else np.asarray(v, np.int64)
             for k, v in cols.items()}
    if not E:
        del lanes["churn_t"]
    if not D:
        for k in ("dtimes", "dvals", "dper"):
            del lanes[k]
    return tuple(routers), lanes


def horizon_of(stacked: Dict[str, np.ndarray]) -> float:
    """The traces' last arrival, over which churn toggles expand (as the
    JAX runner's ``horizon``)."""
    arr = stacked["arrival"]
    return float(arr.max()) if arr.size else 0.0


def reject_timers_under_churn(spec, entries, kernels, horizon: float):
    """The JAX runner's refusal of a timer policy on an entry whose nodes
    toggle over the horizon: a drained timer would fire against a dead
    node."""
    timered = [p for p in spec.policies if kernels[p].has_timers]
    if not timered:
        return
    for e in entries:
        if e.churn_operand(horizon) is not None:
            raise ValueError(
                f"cluster entry {e.label!r} declares churn, but "
                f"policies {timered} arm per-request timers — a "
                "drained timer would fire against a dead node. Drop "
                "the policy or the churn schedule")


def dynamic_calls(spec, entries, stacked: Dict[str, np.ndarray], F: int,
                  kernels: dict, betas: Dict[str, np.ndarray], deadlines,
                  device, chunk: int, rs=None):
    """The dynamic tier's engine calls for ``entries`` of ``spec``: the
    lanes of `pack_dynamic_lanes`, ``chunk`` of them a call,
    policy-major. Returns ``(calls, L)``: each call ``(policy, lo, hi,
    args, kw)`` is one ``cluster_metrics(*args, **kw)`` over lanes [lo,
    hi) on ``device``; under resilience (``rs`` of
    `ExperimentSpec.resilience_ops`, ``stacked``'s exec times its
    attempts' times) each call carries the (T, N) outcome operands.
    Raises on a timer policy under churn."""
    from repro_torch.api.runner import resil_kwargs, trace_operands
    T = stacked["fn_id"].shape[0]
    horizon = horizon_of(stacked)
    reject_timers_under_churn(spec, entries, kernels, horizon)
    routers, lanes = pack_dynamic_lanes(spec, entries, T, horizon)
    shared = list(trace_operands(stacked, device).values())
    L = len(lanes["trace_ix"])
    rs_kw = resil_kwargs(rs, device)

    def col(x, lo, hi):
        return torch.as_tensor(x[lo:hi], device=device)

    calls = []
    for policy in spec.policies:
        beta_l = np.asarray(betas[policy], np.float64)[lanes["beta_ix"]]
        for lo in range(0, L, chunk):
            hi = min(lo + chunk, L)
            args = (*shared, col(lanes["trace_ix"], lo, hi),
                    col(lanes["cap_mask"], lo, hi), col(beta_l, lo, hi),
                    spec.prior, spec.threshold)
            kw = dict(rs_kw, kernel=kernels[policy], routers=routers,
                      router_ix=col(lanes["router_ix"], lo, hi),
                      n_nodes=col(lanes["n_nodes"], lo, hi),
                      seeds=col(lanes["seeds"], lo, hi),
                      delays=col(lanes["delays"], lo, hi), n_fns=F,
                      capacity=lanes["cap_mask"].shape[2],
                      queue_cap=spec.queue_cap, stream=spec.stream,
                      keep_responses=spec.keep_per_request,
                      deadlines=deadlines, tl_bins=spec.tl_bins,
                      tl_bucket=spec.tl_bucket, trace=spec.trace_events)
            for k in ("churn_t", "dtimes", "dvals", "dper"):
                if k in lanes:
                    kw[k] = col(lanes[k], lo, hi)
            calls.append((policy, lo, hi, args, kw))
    return calls, L


def split_dynamic_lanes(spec, entries, flat: Dict[str, np.ndarray],
                        T: int) -> List[Dict[str, np.ndarray]]:
    """One policy's per-lane metrics ``flat`` (lanes in
    `pack_dynamic_lanes` order, numpy) as one (T, KC, B)-shaped metric
    dict an entry, ``node_done`` cut to the entry's nodes."""
    KC = len(spec.capacities)
    B = 1 if spec.betas is None else len(spec.betas)
    n = T * KC * B
    out = []
    for i, e in enumerate(entries):
        d = {m: v[i * n:(i + 1) * n].reshape((T, KC, B) + v.shape[1:])
             for m, v in flat.items()}
        d["node_done"] = d["node_done"][..., :e.n_nodes]
        out.append(d)
    return out


def run_dynamic_entries(spec, entries, stacked: Dict[str, np.ndarray],
                        F: int, kernels: dict, betas: Dict[str, np.ndarray],
                        deadlines, device, chunk: int, rs=None,
                        trace_cells=None) -> List[Dict[str, np.ndarray]]:
    """Run the dynamic `ClusterSpec` ``entries`` of ``spec`` over its grid
    on ``device``; one (P, T, KC, B)-shaped metric dict an entry (plus
    trailing dims: ``node_done`` (.., K), ``resp_hist`` (.., bins), ...).
    The engine calls are `dynamic_calls`'. Under ``spec.trace_events``
    each call runs in its own collection scope and ``trace_cells`` (a
    list) gets one dict of cell streams an entry, keyed (pi, t, kc, b)."""
    from repro_torch.api.runner import to_numpy, traced_call
    from repro_torch.cluster.engine import cluster_metrics
    T = stacked["fn_id"].shape[0]
    calls, L = dynamic_calls(spec, entries, stacked, F, kernels, betas,
                             deadlines, device, chunk, rs)
    KC = len(spec.capacities)
    B = 1 if spec.betas is None else len(spec.betas)
    if spec.trace_events and trace_cells is not None:
        trace_cells[:] = [{} for _ in entries]
    flat: Dict[str, Dict[str, np.ndarray]] = {p: {} for p in spec.policies}
    for policy, lo, hi, args, kw in calls:
        out, events = traced_call(
            lambda: to_numpy(cluster_metrics(*args, **kw)),
            spec.trace_events, hi - lo)
        if events is not None and trace_cells is not None:
            pi = spec.policies.index(policy)
            for j, ev in enumerate(events):
                # lanes entry-major, then trace, capacity, beta
                e, rest = divmod(lo + j, T * KC * B)
                t, rest = divmod(rest, KC * B)
                trace_cells[e][(pi, t) + divmod(rest, B)] = ev
        for k, v in out.items():
            if k not in flat[policy]:
                flat[policy][k] = np.zeros((L,) + v.shape[1:], v.dtype)
            flat[policy][k][lo:hi] = v
    split = [split_dynamic_lanes(spec, entries, flat[p], T)
             for p in spec.policies]
    return [{m: np.stack([per_entry[j][m] for per_entry in split])
             for m in split[0][j]} for j in range(len(entries))]


def run_cluster_experiment(spec, dev: torch.device):
    """Execute a cluster-axed `ExperimentSpec` on ``dev``; see the module
    docstring."""
    from repro_torch.api.registry import get_kernel
    from repro_torch.api.results import ResultSet
    from repro_torch.api.runner import (_lower_grid, _unique_labels,
                                        lower_resilience, result_meta,
                                        run_experiment, trace_run)
    from repro_torch.core.engine import (goodput, lane_chunk_for,
                                         slo_attainment)

    entries = list(spec.cluster)
    sources, stacked, F, N = _lower_grid(spec)
    stacked, rs = lower_resilience(spec, stacked, F)
    kernels = {p: get_kernel(p) for p in spec.policies}
    betas = {p: np.asarray([kernels[p].default_beta] if spec.betas is None
                           else list(spec.betas), np.float64)
             for p in spec.policies}
    deadlines = spec.deadline_ops(F)
    k_max = max((e.n_nodes if e is not None else 1) for e in entries)

    chunk = lane_chunk_for(spec.lane_chunk, dev)
    static = [e for e in entries
              if e is not None and not e.get_router().dynamic]
    dynamic = [e for e in entries
               if e is not None and e.get_router().dynamic]
    static_cells: List[dict] = []
    dynamic_cells: List[dict] = []
    static_data = iter(run_static_entries(
        spec, static, stacked, F, N, kernels, betas, deadlines, dev, chunk,
        rs, static_cells) if static else ())
    dl_op = (None if deadlines is None
             else torch.as_tensor(deadlines, device=dev))
    dynamic_data = iter(run_dynamic_entries(
        spec, dynamic, stacked, F, kernels, betas, dl_op, dev, chunk, rs,
        dynamic_cells) if dynamic else ())
    static_cells, dynamic_cells = iter(static_cells), iter(dynamic_cells)
    entry_data: List[Dict[str, np.ndarray]] = []
    entry_cells: List[dict] = []
    for entry in entries:
        if entry is not None and entry.get_router().dynamic:
            d = next(dynamic_data)
            cells = next(dynamic_cells, {})
        elif entry is None:
            plain = run_experiment(replace(spec, cluster=None), device=dev)
            d = dict(plain.data)
            cells = plain.trace.cells if plain.trace is not None else {}
            # recomputed below from the stacked counters, as for every
            # entry
            d.pop("slo_attainment", None)
            d.pop("goodput", None)
            d["node_done"] = d["done"][..., None].astype(np.int32)
        else:
            d = next(static_data)
            cells = next(static_cells, {})
        d["node_done"] = _pad_node_dim(d["node_done"], k_max)
        entry_data.append(d)
        entry_cells.append(cells)
    # only breaker-routed entries count trips; the others count none
    if any("breaker_trips" in d for d in entry_data):
        for d in entry_data:
            d.setdefault("breaker_trips", np.zeros_like(d["done"], np.int64))
    keys = set(entry_data[0])
    for d in entry_data[1:]:
        if set(d) != keys:
            raise RuntimeError(f"cluster entries disagree on metrics: "
                               f"{sorted(keys ^ set(d))}")
    data = {m: np.stack([d[m] for d in entry_data], axis=4) for m in keys}
    if deadlines is not None:
        data["slo_attainment"] = slo_attainment(data["deadline_miss"],
                                                data["done"])
    if rs is not None:
        data["goodput"] = goodput(data["done"], N)
    labels = _unique_labels([(e.label if e is not None else "none")
                             for e in entries])
    coords = dict(policy=list(spec.policies),
                  trace=_unique_labels([s.label for s in sources]),
                  capacity=list(spec.capacities),
                  beta=(list(spec.betas) if spec.betas is not None
                        else ["default"]),
                  cluster=labels)
    meta = result_meta(
        spec, dev, N, F, chunk, kernels,
        cluster=[None if e is None else dict(
            n_nodes=e.n_nodes, router=e.router,
            node_capacity=(list(e.node_capacity)
                           if e.node_capacity is not None else None),
            net_delay=list(e.delays()), seed=e.seed,
            has_churn=e.has_churn(), var_delay=e.delay_ops() is not None)
            for e in entries])
    return ResultSet(data=data, coords=coords, meta=meta,
                     trace=trace_run(spec, coords, {
                         key + (ei,): ev
                         for ei, cells in enumerate(entry_cells)
                         for key, ev in cells.items()}))
