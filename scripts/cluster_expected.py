"""Make the JAX package's constants that ``chip_smoke.py`` holds the
port's ``options``, ``static_cluster`` and ``dynamic_cluster`` phases
against (``scripts/cluster_expected.json``).

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/cluster_expected.py \
        [--n 60000] [--part options fig8 static_cluster dynamic_cluster] \
        [--out scripts/cluster_expected.json]

Each part runs `repro.api.run_experiment` on the spec that the smoke's
phase runs through the port, and prints one JSON line a part with the
ResultSet's values, floats as Python's repr (so read back they are
bitwise the JAX package's):

* ``options``: the Fig. 5 trace (F = 200, seed 0, the benchmarks'
  Azure-like settings), the six policies at C = 16, ``queue_cap`` 8192,
  the minute timeline over the trace (``tl_bins`` = the trace's minutes,
  ``tl_bucket`` 60 s) and ``deadlines`` = 0.35 s
  (``benchmarks/fig_churn.py``'s DEADLINE): each policy's counters,
  sums, means, p99, histogram, ``tl_*``, ``deadline_miss`` and
  ``slo_attainment``.
* ``fig8``: ESFF over ``head(20000)`` of that trace at C = 16,
  ``queue_cap`` 4096, with the timeline (``benchmarks/fig8_timeline.py``'s
  engine panels).
* ``static_cluster``: ``benchmarks/fig_cluster.py``'s static half: the
  routers ``hash`` and ``round_robin`` at K = 1, 2, 4, 8, 16, 32 nodes of
  32 // K slots (AGG = 32) and at K = 64 of one slot (AGG = 64), ESFF and
  SFF, ``queue_cap`` 32768: each (policy, cluster label) cell's merged
  metrics and ``node_done``.
* ``dynamic_cluster``: fig_cluster's dynamic half, the same two specs
  with the routers ``jsq2`` and ``cold_aware`` (the K-node event loop):
  each cell's metrics and ``node_done``.

``--out`` merges the parts into that JSON file under ``[part][str(n)]``.
At N = 60,000 a part takes minutes of CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

POLICIES = ("esff", "esff_h", "sff", "openwhisk", "faascache",
            "openwhisk_v2")
TRACE_KW = dict(utilization=0.2, exec_median=0.1, exec_sigma=1.4,
                burst_frac=0.3)
OPTIONS = dict(capacity=16, queue_cap=8192, tl_bucket=60.0, deadline=0.35)
FIG8 = dict(head=20000, capacity=16, queue_cap=4096, tl_bucket=60.0)
CLUSTER = dict(routers=("hash", "round_robin"),
               dynamic_routers=("jsq2", "cold_aware"),
               ks=(1, 2, 4, 8, 16, 32),
               agg=32, ks_fleet=(64,), agg_fleet=64,
               policies=("esff", "sff"), queue_cap=1 << 15)
# the ResultSet's metrics that each part keeps (per cell)
KEYS = ("done", "overflow", "stalled", "cold_starts", "evictions",
        "cold_time", "resp_sum", "slow_sum", "max_response",
        "mean_response", "mean_slowdown", "p99_response", "resp_hist")
OPTION_KEYS = KEYS + ("tl_count", "tl_resp_sum", "tl_exec_sum",
                      "deadline_miss", "slo_attainment")
FIG8_KEYS = KEYS + ("tl_count", "tl_resp_sum", "tl_exec_sum")
CLUSTER_KEYS = KEYS + ("node_done",)
PARTS = ("options", "fig8", "static_cluster", "dynamic_cluster")


def trace(api, n):
    return api.SyntheticTrace.make(n_functions=200, n_requests=n, seed=0,
                                   **TRACE_KW)


def n_bins(src, bucket):
    """The timeline's bins: every minute of the trace's arrivals."""
    return int(src.arrays()["arrival"].max() // bucket) + 1


def option_spec(api, n, **kw):
    src = trace(api, n)
    return api.ExperimentSpec(
        traces=[src], policies=POLICIES, capacities=(OPTIONS["capacity"],),
        queue_cap=OPTIONS["queue_cap"],
        tl_bins=n_bins(src, OPTIONS["tl_bucket"]),
        tl_bucket=OPTIONS["tl_bucket"], deadlines=OPTIONS["deadline"], **kw)


def fig8_spec(api, n, **kw):
    src = trace(api, n).head(min(FIG8["head"], n))
    return api.ExperimentSpec(
        traces=[src], policies=("esff",), capacities=(FIG8["capacity"],),
        queue_cap=FIG8["queue_cap"], tl_bins=n_bins(src, FIG8["tl_bucket"]),
        tl_bucket=FIG8["tl_bucket"], **kw)


def cluster_entries(api, ks, agg, routers):
    return [api.ClusterSpec(n_nodes=k, router=r,
                            node_capacity=(agg // k,) * k)
            for r in routers for k in ks if agg % k == 0]


def cluster_specs(api, n, routers=CLUSTER["routers"], **kw):
    """The two specs of one half of fig_cluster (the static routers by
    default; ``CLUSTER["dynamic_routers"]`` for the dynamic half): AGG =
    32 over K = 1..32 and the K = 64 fleet at AGG = 64."""
    src = trace(api, n)
    return [api.ExperimentSpec(
        traces=[src], policies=CLUSTER["policies"], capacities=(agg,),
        queue_cap=CLUSTER["queue_cap"],
        cluster=cluster_entries(api, ks, agg, routers), **kw)
        for ks, agg in ((CLUSTER["ks"], CLUSTER["agg"]),
                        (CLUSTER["ks_fleet"], CLUSTER["agg_fleet"]))]


def cell(rs, keys, **which):
    """One cell's metrics as Python numbers (lists for vector metrics)."""
    out = {}
    for k in keys:
        v = rs.value(k, **which)
        out[k] = np.asarray(v).tolist() if np.ndim(v) else v
    return out


def run_part(api, part, n):
    if part == "options":
        rs = api.run_experiment(option_spec(api, n))
        return dict(tl_bins=rs.meta["tl_bins"], **OPTIONS,
                    policies={p: cell(rs, OPTION_KEYS, policy=p)
                              for p in POLICIES})
    if part == "fig8":
        rs = api.run_experiment(fig8_spec(api, n))
        return dict(tl_bins=rs.meta["tl_bins"], **FIG8,
                    esff=cell(rs, FIG8_KEYS, policy="esff"))
    routers = CLUSTER["routers" if part == "static_cluster"
                      else "dynamic_routers"]
    cells = {}
    for spec in cluster_specs(api, n, routers):
        rs = api.run_experiment(spec)
        for e in spec.cluster:
            for p in spec.policies:
                cells.setdefault(p, {})[e.label] = cell(
                    rs, CLUSTER_KEYS, policy=p, cluster=e.label)
    return dict(queue_cap=CLUSTER["queue_cap"], cells=cells)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=60000)
    ap.add_argument("--part", nargs="+",
                    choices=PARTS, default=list(PARTS))
    ap.add_argument("--out", default=None,
                    help="JSON file to merge the constants into")
    a = ap.parse_args(argv)
    from repro import api
    store = {}
    if a.out and os.path.exists(a.out):
        with open(a.out) as f:
            store = json.load(f)
    for part in a.part:
        t0 = time.perf_counter()
        res = run_part(api, part, a.n)
        print(json.dumps(dict(part=part, n=a.n,
                              seconds=time.perf_counter() - t0)),
              flush=True)
        if a.out:
            store.setdefault(part, {})[str(a.n)] = res
            with open(a.out, "w") as f:
                json.dump(store, f, sort_keys=True)
                f.write("\n")
        else:
            print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
