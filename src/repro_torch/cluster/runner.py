"""Lower the `ExperimentSpec.cluster` axis onto the routing tiers
(counterpart of `repro.cluster.runner`, its plain and static branches).

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
* dynamic-router entries raise NotImplementedError (ROADMAP Queue 1,
  item 1), before anything runs.

Every entry contributes the same metric set (plain cells get a one-node
``node_done``), padded to the axis-wide largest node count.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Dict, List

import numpy as np
import torch

from repro_torch.cluster.routers import DYNAMIC_NOT_PORTED
from repro_torch.cluster.static import run_static_entries


def _pad_node_dim(a: np.ndarray, k_max: int) -> np.ndarray:
    """Right-pad the trailing node axis with zeros to ``k_max``."""
    if a.shape[-1] == k_max:
        return a
    pad = [(0, 0)] * (a.ndim - 1) + [(0, k_max - a.shape[-1])]
    return np.pad(a, pad)


def run_cluster_experiment(spec, dev: torch.device):
    """Execute a cluster-axed `ExperimentSpec` on ``dev``; see the module
    docstring."""
    from repro_torch.api.registry import get_kernel
    from repro_torch.api.results import ResultSet
    from repro_torch.api.runner import (_lower_grid, _unique_labels,
                                        result_meta, run_experiment)
    from repro_torch.core.engine import lane_chunk_for, slo_attainment

    entries = list(spec.cluster)
    for e in entries:
        if e is not None and e.get_router().dynamic:
            raise NotImplementedError(
                f"cluster entry {e.label!r}: router {e.router!r} is "
                f"dynamic: {DYNAMIC_NOT_PORTED}")
    sources, stacked, F, N = _lower_grid(spec)
    kernels = {p: get_kernel(p) for p in spec.policies}
    betas = {p: np.asarray([kernels[p].default_beta] if spec.betas is None
                           else list(spec.betas), np.float64)
             for p in spec.policies}
    deadlines = spec.deadline_ops(F)
    k_max = max((e.n_nodes if e is not None else 1) for e in entries)

    static = [e for e in entries if e is not None]
    static_data = iter(run_static_entries(
        spec, static, stacked, F, N, kernels, betas, deadlines, dev,
        lane_chunk_for(spec.lane_chunk, dev)) if static else ())
    entry_data: List[Dict[str, np.ndarray]] = []
    for entry in entries:
        if entry is None:
            d = dict(run_experiment(replace(spec, cluster=None),
                                    device=dev).data)
            # recomputed below from the stacked counters, as for every
            # entry
            d.pop("slo_attainment", None)
            d["node_done"] = d["done"][..., None].astype(np.int32)
        else:
            d = next(static_data)
        d["node_done"] = _pad_node_dim(d["node_done"], k_max)
        entry_data.append(d)
    keys = set(entry_data[0])
    for d in entry_data[1:]:
        if set(d) != keys:
            raise RuntimeError(f"cluster entries disagree on metrics: "
                               f"{sorted(keys ^ set(d))}")
    data = {m: np.stack([d[m] for d in entry_data], axis=4) for m in keys}
    if deadlines is not None:
        data["slo_attainment"] = slo_attainment(data["deadline_miss"],
                                                data["done"])
    labels = _unique_labels([(e.label if e is not None else "none")
                             for e in entries])
    coords = dict(policy=list(spec.policies),
                  trace=_unique_labels([s.label for s in sources]),
                  capacity=list(spec.capacities),
                  beta=(list(spec.betas) if spec.betas is not None
                        else ["default"]),
                  cluster=labels)
    meta = result_meta(
        spec, dev, N, F, lane_chunk_for(spec.lane_chunk, dev), kernels,
        cluster=[None if e is None else dict(
            n_nodes=e.n_nodes, router=e.router,
            node_capacity=(list(e.node_capacity)
                           if e.node_capacity is not None else None),
            net_delay=list(e.delays()), seed=e.seed)
            for e in entries])
    return ResultSet(data=data, coords=coords, meta=meta)
