"""Make the JAX package's constants that ``chip_smoke.py``'s ``telemetry``
phase holds the port's traced runs against
(``scripts/telemetry_expected.json``).

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/telemetry_expected.py \
        [--out scripts/telemetry_expected.json]

Every case runs `repro.api.run_experiment` with ``trace_events=True`` on
tests/test_telemetry.py's trace (``SyntheticTrace.make(n_functions=12,
n_requests=400, seed=3, utilization=0.25)``, C = 3 unless a case says
otherwise, ``queue_cap`` 64, stream mode) and keeps, for each traced cell, its record count, the
count of each event kind and the SHA-256 of its int32 columns and of its
f64 columns (`digest`):

* ``churn_retry_k4``: tests/test_telemetry.py's K = 4 churn + retry
  spec (ESFF, jsq2, node 0 down over the trace's 30-60 % quantiles,
  its ``FAULTS``);
* ``single_node``: the same trace on the single node, the six policies;
* ``static_hash_k3``: the static tier, ``hash`` at K = 3 (ESFF);
* ``slo_aware_delay_k4``: ``slo_aware`` at K = 4 with delays of 0, 10,
  20 and 30 ms (ESFF and SFF);
* ``sff_churn_k4``: SFF under jsq2 at K = 4 nodes of one slot, node 0 on
  ``PeriodicChurn(span / 3, duty=0.5)``: its drains re-route tens of
  requests in bulk (the order of SFF's bulk re-routes).

The smoke builds the same specs through the port's API (`build_spec`,
which takes the API module), so this file imports JAX only in `main`.
A run takes ~30 s of CPU.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np

TRACE = dict(n_functions=12, n_requests=400, seed=3, utilization=0.25)
BASE = dict(capacities=(3,), queue_cap=64, stream=True)
FIELDS_I = ("kind", "rid", "fn", "node", "aux", "qlen", "busy", "warm",
            "seq")
FIELDS_F = ("t", "dt")
N_KINDS = 8
CASES = ("churn_retry_k4", "single_node", "static_hash_k3",
         "slo_aware_delay_k4", "sff_churn_k4")
POLICIES = ("esff", "esff_h", "sff", "openwhisk", "faascache",
            "openwhisk_v2")


def build_spec(api, case: str, n_requests: int = None):
    """The ExperimentSpec of ``case`` in ``api`` (`repro.api` or
    `repro_torch.api`), traced; ``n_requests`` cuts the trace to its head
    (the churn window's quantiles taken on the cut trace)."""
    src = api.SyntheticTrace.make(**TRACE)
    if n_requests is not None:
        src = src.head(n_requests)
    kw = dict(BASE, traces=[src], trace_events=True)
    if case == "churn_retry_k4":
        arr = np.asarray(src.arrays()["arrival"])
        t30, t60 = (float(np.quantile(arr, q)) for q in (0.3, 0.6))
        kw.update(policies=("esff",), cluster=[api.ClusterSpec(
            n_nodes=4, router="jsq2",
            churn=(((t30, t60),),) + (None,) * 3)],
            fail_prob=0.2, timeouts=8.0,
            retry=api.RetryPolicy(max_attempts=3, base=0.05, cap=1.0,
                                  jitter=0.3),
            on_overflow="shed", fail_seed=99)
    elif case == "single_node":
        kw.update(policies=POLICIES)
    elif case == "static_hash_k3":
        kw.update(policies=("esff",),
                  cluster=[api.ClusterSpec(n_nodes=3, router="hash")])
    elif case == "slo_aware_delay_k4":
        kw.update(policies=("esff", "sff"), cluster=[api.ClusterSpec(
            n_nodes=4, router="slo_aware",
            net_delay=(0.0, 0.01, 0.02, 0.03))])
    elif case == "sff_churn_k4":
        span = float(np.max(src.arrays()["arrival"]))
        kw.update(policies=("sff",), capacities=(1,), cluster=[
            api.ClusterSpec(n_nodes=4, router="jsq2", churn=(
                api.PeriodicChurn(span / 3, duty=0.5),) + (None,) * 3)])
    else:
        raise KeyError(case)
    return api.ExperimentSpec(**kw)


def digest(ev: dict) -> dict:
    """One stream's record count, events by kind, and the SHA-256 of its
    records' int32 fields (row-major, little-endian, in `FIELDS_I` order)
    and of their f64 fields (`FIELDS_F`)."""
    kind = np.asarray(ev["kind"])
    ri = np.stack([np.asarray(ev[f]) for f in FIELDS_I], 1).astype("<i4")
    rf = np.stack([np.asarray(ev[f]) for f in FIELDS_F], 1).astype("<f8")
    return dict(records=int(len(kind)),
                kinds=np.bincount(kind, minlength=N_KINDS).tolist(),
                sha_i=hashlib.sha256(ri.tobytes()).hexdigest(),
                sha_f=hashlib.sha256(rf.tobytes()).hexdigest())


def cell_name(key) -> str:
    return ",".join(str(int(k)) for k in key)


def case_digests(trace_run) -> dict:
    """Each traced cell's `digest`, by its key (`cell_name`)."""
    return {cell_name(k): digest(ev)
            for k, ev in sorted(trace_run.cells.items())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        "telemetry_expected.json"))
    a = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "src"))
    import repro.api as api
    store = {case: case_digests(api.run_experiment(
        build_spec(api, case)).trace) for case in CASES}
    with open(a.out, "w") as f:
        json.dump(dict(trace=TRACE, cases=store), f, indent=1,
                  sort_keys=True)
    print(json.dumps({c: len(v) for c, v in store.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
