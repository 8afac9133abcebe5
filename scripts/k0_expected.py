"""Make the JAX package's constants that ``chip_smoke.py`` holds the
port's Fig. 5 and Fig. 6 grids against (``scripts/k0_expected.json``).

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/k0_expected.py \
        --n 60000 --queue-cap 8192 [--grid fig5 fig6] [--policies ...] \
        [--out scripts/k0_expected.json]

For each policy it runs `repro.core.jax_engine._simulate` once over the
grid's lanes (streaming mode, the policy's default beta), exactly the
engine call `repro.api.run_experiment` makes, and prints one JSON line a
(grid, policy): the counters, ``n_events`` (which the ResultSet does
not carry), ``mean_response`` and ``mean_slowdown`` as ``sum * (1 / N)``
(XLA's spelling of the ResultSet's ``sum / N``), and ``max_response``.
Floats print as Python's repr, so read back they are bitwise the
engine's. ``--out`` also merges them into that JSON file, under
``[grid][str(n)][policy]``, beside the ``queue_cap`` they were made at
(one for the whole file). A JAX CPU run takes about 10-80 s a policy at
N = 60,000.

Fig. 5: one trace (F = 200, seed 0, the benchmarks' Azure-like
settings), C = 8, 12, ..., 32. Fig. 6: that trace's arrivals scaled by
0.6, 0.8, 1.0, 1.2, 1.4 (`TraceSource.scaled`), C = 16.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

CAPACITIES = (8, 12, 16, 20, 24, 28, 32)
RATIOS = (0.6, 0.8, 1.0, 1.2, 1.4)
FIG6_CAPACITY = 16
POLICIES = ("esff", "esff_h", "sff", "openwhisk", "faascache",
            "openwhisk_v2")
TRACE_KW = dict(utilization=0.2, exec_median=0.1, exec_sigma=1.4,
                burst_frac=0.3)
KEYS = ("done", "overflow", "stalled", "cold_starts", "evictions",
        "n_events", "mean_response", "mean_slowdown", "max_response")


def grid(name, n):
    """(trace sources, capacities) of one grid."""
    from repro.api import SyntheticTrace
    src = SyntheticTrace.make(n_functions=200, n_requests=n, seed=0,
                              **TRACE_KW)
    if name == "fig5":
        return [src], CAPACITIES
    return [src.scaled(r) for r in RATIOS], (FIG6_CAPACITY,)


def run(name, n, queue_cap, policy):
    import jax.numpy as jnp

    from repro.core.jax_engine import _simulate
    from repro.core.jax_policies import KERNELS
    sources, caps = grid(name, n)
    arrs = [s.arrays() for s in sources]
    sh = {k: jnp.asarray(np.stack([a[k] for a in arrs]))
          for k in ("fn_id", "arrival", "exec_time", "cold_start",
                    "evict")}
    C = max(caps)
    T, K = len(sources), len(caps)
    tix = jnp.asarray(np.repeat(np.arange(T, dtype=np.int32), K))
    masks = jnp.asarray(np.tile(np.stack([np.arange(C) < c for c in caps]),
                                (T, 1)))
    kernel = KERNELS[policy]
    betas = jnp.full((T * K,), kernel.default_beta, jnp.float64)
    out = _simulate(sh["fn_id"], sh["arrival"], sh["exec_time"],
                    sh["cold_start"], sh["evict"], tix, masks, betas,
                    jnp.float64(0.1), jnp.float64(0.1), kernel=kernel,
                    n_fns=len(arrs[0]["cold_start"]), capacity=C,
                    queue_cap=queue_cap, stream=True)
    out = {k: np.asarray(v) for k, v in out.items()}
    inv_n = 1.0 / n
    res = dict(done=out["done"], overflow=out["overflow"],
               stalled=out["stalled"], cold_starts=out["cold_starts"],
               evictions=out["evictions"], n_events=out["n_events"],
               mean_response=out["resp_sum"] * inv_n,
               mean_slowdown=out["slow_sum"] * inv_n,
               max_response=out["max_response"])
    return {k: [int(x) if np.issubdtype(res[k].dtype, np.integer)
                else float(x) for x in res[k]] for k in KEYS}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=60000)
    ap.add_argument("--queue-cap", type=int, default=8192)
    ap.add_argument("--grid", choices=("fig5", "fig6"), nargs="+",
                    default=["fig5", "fig6"])
    ap.add_argument("--policies", nargs="+", default=list(POLICIES))
    ap.add_argument("--out", default=None,
                    help="JSON file to merge the constants into")
    a = ap.parse_args(argv)
    store = None
    if a.out:
        store = {"queue_cap": a.queue_cap}
        if os.path.exists(a.out):
            with open(a.out) as f:
                store = json.load(f)
        if store["queue_cap"] != a.queue_cap:
            raise SystemExit(f"{a.out} holds constants made at queue_cap "
                             f"{store['queue_cap']}, not {a.queue_cap}")
    for g in a.grid:
        for p in a.policies:
            t0 = time.perf_counter()
            res = run(g, a.n, a.queue_cap, p)
            print(json.dumps(dict(grid=g, n=a.n, queue_cap=a.queue_cap,
                                  policy=p, seconds=time.perf_counter() - t0,
                                  **res)), flush=True)
            if store is not None:
                store.setdefault(g, {}).setdefault(str(a.n), {})[p] = res
                with open(a.out, "w") as f:
                    json.dump(store, f, indent=1, sort_keys=True)
                    f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
