"""Make the JAX package's constants that ``chip_smoke.py`` holds the
port's ``options``, ``static_cluster``, ``dynamic_cluster``, ``churn``
and ``resilience`` phases against (``scripts/cluster_expected.json``).

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/cluster_expected.py \
        [--n 60000] [--part options fig8 static_cluster dynamic_cluster \
        churn resilience] [--out scripts/cluster_expected.json]

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
* ``churn``: ``benchmarks/fig_churn.py`` at full size (routers ``jsq2``,
  ``cold_aware`` and ``slo_aware`` x K = 2, 4, 8 nodes of 32 // K slots,
  nodes 1..K-1 on ``PeriodicChurn(60 s, duty 0.7, phase i * 60 / K)``,
  delays 0.004 i / (K - 1), a 0.35 s deadline, ``queue_cap`` 32768,
  ESFF and SFF), and the ``leo-delay`` spec (K = 4 nodes of 8 slots,
  delays 0, 4, 8, 12 ms, nodes 1..3 on ``DelaySchedule(times=(0, 30),
  values=(5 ms, 80 ms), period=60)``: ``jsq2`` and ``slo_aware`` without
  churn, ``slo_aware`` with fig_churn's K = 4 churn): each cell's metrics,
  ``node_done``, ``deadline_miss`` and ``slo_attainment``.
* ``resilience``: ``benchmarks/fig_resilience.py`` at full size (ESFF,
  ``jsq2`` at K = 1, 4, 8 nodes of 32 // K slots, fail_prob 0, 0.05,
  0.15, 0.3 x the retry policies no_retry, retry3 and retry3_jitter,
  ``on_overflow="shed"``, ``queue_cap`` 32768, a 0.35 s deadline,
  fail_seed 99), its breaker row (K = 4 x 8, retry3) at fail_prob 0.15
  and 0.6, and ``resil-tiers`` (the five policies without timers at C =
  32, fail_prob 0.2, timeouts 2 s, ``RetryPolicy(3, 0.05, 1.0, 0.3)``,
  ``shed_oldest`` at ``queue_cap`` 64, a 0.35 s deadline; the single
  node, ``hash`` K = 4 x 8, ``slo_aware`` K = 4 x 8 with delays and
  ``cold_aware`` K = 4 x 8 under fig_churn's K = 4 churn and delays):
  each spec's cells (``[spec name][policy][cluster label]``) with
  ``CHURN_KEYS``, the resilience counters, ``goodput`` and, on a breaker
  entry, ``breaker_trips``.

``--out`` merges the parts into that JSON file under ``[part][str(n)]``.
At N = 60,000 a part takes minutes of CPU (``churn``: ~6; ``resilience``:
1,657 s of wall time by its printed ``seconds``, JAX using ~2 cores).
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
# benchmarks/fig_churn.py: one availability cycle of ``period`` seconds a
# node, up for ``duty`` of it, phases staggered over the cycle; node 0
# always up; delays ``delay_step`` * i / (K - 1)
CHURN = dict(routers=("jsq2", "cold_aware", "slo_aware"), ks=(2, 4, 8),
             agg=32, period=60.0, duty=0.7, delay_step=0.004,
             deadline=0.35, policies=("esff", "sff"), queue_cap=1 << 15)
# the leo-delay spec: K = 4 nodes of 8 slots whose links 1..3 swing
# between 5 ms and 80 ms every half ``period`` (a LEO pass)
LEO = dict(n_nodes=4, slots=8, net_delay=(0.0, 0.004, 0.008, 0.012),
           values=(0.005, 0.08))
CHURN_KEYS = CLUSTER_KEYS + ("deadline_miss", "slo_attainment")
# benchmarks/fig_resilience.py: jsq2 at K = 1, 4, 8 nodes of AGG // K
# slots, ESFF, one spec a (fail_prob, retry policy), shedding the arrival
# on a full queue; retry policies as (max_attempts, base, cap, jitter).
# Its timed breaker row (K = 4, retry3) at fail_prob 0.15, and again at
# 0.6, where the breaker trips and re-closes many times
RESIL = dict(router="jsq2", ks=(1, 4, 8), agg=32,
             fail_probs=(0.0, 0.05, 0.15, 0.3),
             retries=(("no_retry", (1, 1.0, 30.0, 0.0)),
                      ("retry3", (3, 0.05, 1.0, 0.0)),
                      ("retry3_jitter", (3, 0.05, 1.0, 0.3))),
             deadline=0.35, queue_cap=1 << 15, on_overflow="shed",
             fail_seed=99, policies=("esff",), breaker_k=4,
             breaker_fail_probs=(0.15, 0.6))
# every tier and non-timer policy under one set of faults: the single
# node, the static tier (hash), slo_aware with delay and cold_aware under
# fig_churn's K = 4 churn and delays; timeouts 2 s (49 requests of the
# trace run longer), shedding the queue's oldest request
TIERS = dict(policies=("esff", "esff_h", "sff", "openwhisk", "faascache"),
             capacity=32, n_nodes=4, slots=8, queue_cap=64,
             on_overflow="shed_oldest", deadline=0.35, fail_prob=0.2,
             timeouts=2.0, retry=(3, 0.05, 1.0, 0.3), fail_seed=99,
             slo_delay=(0.0, 0.002, 0.004, 0.006))
RESIL_COUNTERS = ("failed", "timed_out", "retried", "shed",
                  "failed_exhausted", "goodput", "breaker_trips")
RESIL_KEYS = CHURN_KEYS + RESIL_COUNTERS
PARTS = ("options", "fig8", "static_cluster", "dynamic_cluster", "churn",
         "resilience")


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


def churn_of(api, k, period=CHURN["period"]):
    """fig_churn's availability of a K-node cluster: node 0 always up,
    node i on a ``period`` cycle, up 70 % of it, phase i * period / K."""
    return (None,) + tuple(
        api.PeriodicChurn(period=period, duty=CHURN["duty"],
                          phase=i * period / k) for i in range(1, k))


def fig_churn_entries(api, period=CHURN["period"]):
    """benchmarks/fig_churn.py's topologies (``_entries``): each router x
    K of ``CHURN``, AGG // K slots a node."""
    agg = CHURN["agg"]
    return [api.ClusterSpec(
        n_nodes=k, router=r, node_capacity=(agg // k,) * k,
        net_delay=tuple(CHURN["delay_step"] * i / max(k - 1, 1)
                        for i in range(k)),
        churn=churn_of(api, k, period))
        for r in CHURN["routers"] for k in CHURN["ks"] if agg % k == 0]


def leo_entries(api, period=CHURN["period"]):
    """The leo-delay spec's topologies: jsq2 and slo_aware on the swinging
    links, then slo_aware with fig_churn's K = 4 churn on top."""
    k = LEO["n_nodes"]
    ds = api.DelaySchedule(times=(0.0, period / 2), values=LEO["values"],
                           period=period)
    base = dict(n_nodes=k, node_capacity=(LEO["slots"],) * k,
                net_delay=LEO["net_delay"],
                delay_schedule=(None,) + (ds,) * (k - 1))
    return [api.ClusterSpec(router="jsq2", **base),
            api.ClusterSpec(router="slo_aware", **base),
            api.ClusterSpec(router="slo_aware", churn=churn_of(api, k, period),
                            **base)]


def churn_specs(api, n, period=CHURN["period"], **kw):
    """The churn part's two specs over the trace of ``n`` requests:
    fig_churn and leo-delay (``period`` scales every churn cycle and
    delay swing; a short trace needs a short one to see an outage)."""
    src = trace(api, n)
    return [api.ExperimentSpec(
        traces=[src], policies=CHURN["policies"], capacities=(CHURN["agg"],),
        queue_cap=CHURN["queue_cap"], deadlines=CHURN["deadline"],
        cluster=entries, **kw)
        for entries in (fig_churn_entries(api, period),
                        leo_entries(api, period))]


def retry_of(api, rp):
    return api.RetryPolicy(max_attempts=rp[0], base=rp[1], cap=rp[2],
                           jitter=rp[3])


def resilience_specs(api, n, period=CHURN["period"], **kw):
    """The resilience part's specs over the trace of ``n`` requests, as
    (name, spec) pairs: fig_resilience's twelve (``fp<p>/<retry>``), the
    two breaker specs (``breaker/fp<p>``) and ``resil-tiers`` (``period``
    scales its churn cycle, as `churn_specs`)."""
    src = trace(api, n)
    R, T = RESIL, TIERS
    common = dict(traces=[src], policies=R["policies"],
                  capacities=(R["agg"],), queue_cap=R["queue_cap"],
                  deadlines=R["deadline"], on_overflow=R["on_overflow"],
                  fail_seed=R["fail_seed"], **kw)
    out = []
    entries = cluster_entries(api, R["ks"], R["agg"], (R["router"],))
    for fp in R["fail_probs"]:
        for name, rp in R["retries"]:
            out.append((f"fp{fp}/{name}", api.ExperimentSpec(
                cluster=entries, fail_prob=fp, retry=retry_of(api, rp),
                **common)))
    k = R["breaker_k"]
    brk = [api.ClusterSpec(n_nodes=k, router="breaker",
                           node_capacity=(R["agg"] // k,) * k)]
    for fp in R["breaker_fail_probs"]:
        out.append((f"breaker/fp{fp}", api.ExperimentSpec(
            cluster=brk, fail_prob=fp,
            retry=retry_of(api, R["retries"][1][1]), **common)))
    k, caps = T["n_nodes"], (T["slots"],) * T["n_nodes"]
    tiers = [None,
             api.ClusterSpec(n_nodes=k, router="hash", node_capacity=caps),
             api.ClusterSpec(n_nodes=k, router="slo_aware",
                             node_capacity=caps, net_delay=T["slo_delay"]),
             api.ClusterSpec(
                 n_nodes=k, router="cold_aware", node_capacity=caps,
                 net_delay=tuple(CHURN["delay_step"] * i / (k - 1)
                                 for i in range(k)),
                 churn=churn_of(api, k, period))]
    out.append(("resil-tiers", api.ExperimentSpec(
        traces=[src], policies=T["policies"], capacities=(T["capacity"],),
        queue_cap=T["queue_cap"], deadlines=T["deadline"],
        on_overflow=T["on_overflow"], fail_prob=T["fail_prob"],
        timeouts=T["timeouts"], retry=retry_of(api, T["retry"]),
        fail_seed=T["fail_seed"], cluster=tiers, **kw)))
    return out


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
    if part == "resilience":
        cells = {}
        for name, spec in resilience_specs(api, n):
            rs = api.run_experiment(spec).check()
            keys = [k for k in RESIL_KEYS if k in rs.data]
            labels = rs.coords["cluster"]
            cells[name] = {p: {lab: cell(rs, keys, policy=p, cluster=lab)
                               for lab in labels}
                           for p in spec.policies}
        return dict(cells=cells)
    if part == "churn":
        specs, keys = churn_specs(api, n), CHURN_KEYS
    else:
        routers = CLUSTER["routers" if part == "static_cluster"
                          else "dynamic_routers"]
        specs, keys = cluster_specs(api, n, routers), CLUSTER_KEYS
    cells = {}
    for spec in specs:
        rs = api.run_experiment(spec)
        for e in spec.cluster:
            for p in spec.policies:
                cells.setdefault(p, {})[e.label] = cell(
                    rs, keys, policy=p, cluster=e.label)
    return dict(queue_cap=specs[0].queue_cap, cells=cells)


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
