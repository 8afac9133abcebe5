"""Shared helpers of the dynamic-tier parity tests: one spec through the
JAX package's `run_experiment` and the port's (CPU), and the cell-by-cell
bar (integers exact, per-request responses and sums within rtol 1e-9).
Numpy only at import: each helper imports the packages it runs."""
import numpy as np

SRC = dict(n_functions=12, n_requests=400, seed=3, utilization=0.25)
DELAYS = (0.0, 0.013, 0.027, 0.041)
TOL = dict(rtol=1e-9, atol=1e-9)
EXACT = dict(capacities=(3,), queue_cap=256, stream=False,
             keep_per_request=True)
# the float metrics held within TOL; every other metric is held exactly
FLOATS = ("response", "p99_response", "resp_sum", "slow_sum",
          "mean_response", "mean_slowdown", "cold_time", "max_response",
          "tl_resp_sum", "tl_exec_sum")
# tests/test_resilience.py's faults (fail_prob, timeouts, the retry policy
# as (max_attempts, base, cap, jitter), shedding, the seed)
FAULTS = dict(fail_prob=0.2, timeouts=8.0, retry=(3, 0.05, 1.0, 0.3),
              on_overflow="shed", fail_seed=99)
RESIL_COUNTS = ("done", "failed", "timed_out", "retried", "shed",
                "failed_exhausted")


def faults(api, **kw):
    """`FAULTS` (overridden by ``kw``) as spec keywords of ``api``."""
    f = dict(FAULTS, **kw)
    f["retry"] = api.RetryPolicy(*f["retry"])
    return f


def both_specs(make):
    """``make(api)`` -> an ExperimentSpec's keywords (its traces, cluster
    and faults built from ``api``), run through the JAX package and the
    port (CPU)."""
    import repro.api as japi
    import repro_torch.api as tapi
    jx = japi.run_experiment(japi.ExperimentSpec(**make(japi))).check()
    pt = tapi.run_experiment(tapi.ExperimentSpec(device="cpu",
                                                 **make(tapi))).check()
    return jx, pt


def assert_resil_cells_match(jx, pt, n_requests=SRC["n_requests"],
                             clusters=None):
    """Every cell of the port's ResultSet against the JAX package's under
    the resilience layer (``clusters``: the cluster labels to hold, all by
    default; the port may have more), and the conservation: each request
    done, shed or exhausted once, each success counted by one node."""
    if clusters is not None:
        pt = pt.sel(cluster=list(clusters))
    assert pt.coords == jx.coords
    assert set(pt.data) == set(jx.data) | {"n_events"}
    for m, v in jx.data.items():
        if m in FLOATS:
            np.testing.assert_allclose(pt[m], v, err_msg=m, **TOL)
        else:
            np.testing.assert_array_equal(pt[m], v, err_msg=m)
    tot = pt["done"] + pt["shed"] + pt["failed_exhausted"]
    np.testing.assert_array_equal(tot, n_requests)
    if "node_done" in pt.data:
        np.testing.assert_array_equal(pt["node_done"].sum(-1), pt["done"])


def both(entries, n_requests=None, **kw):
    """The same spec through the JAX package and the port (CPU).
    ``entries`` is a list of `ClusterSpec` keyword dicts, or a callable
    that builds the entries from an api module (``repro.api`` or
    ``repro_torch.api``: its ClusterSpec, PeriodicChurn and
    DelaySchedule)."""
    import repro.api as japi
    import repro_torch.api as tapi
    src = dict(SRC) if n_requests is None else dict(SRC,
                                                    n_requests=n_requests)
    if not callable(entries):
        dicts = entries

        def entries(api):
            return [api.ClusterSpec(**e) for e in dicts]
    jx = japi.run_experiment(japi.ExperimentSpec(
        traces=[japi.SyntheticTrace.make(**src)], cluster=entries(japi),
        **kw)).check()
    pt = tapi.run_experiment(tapi.ExperimentSpec(
        traces=[tapi.SyntheticTrace.make(**src)], cluster=entries(tapi),
        device="cpu", **kw)).check()
    return jx, pt


def assert_cells_match(jx, pt, n_requests=SRC["n_requests"]):
    """Every cell of the port's ResultSet against the JAX package's, and
    the conservation of requests: each served once, by one node."""
    assert pt.coords == jx.coords
    assert set(pt.data) == set(jx.data) | {"n_events"}
    for m, v in jx.data.items():
        if m in FLOATS:
            np.testing.assert_allclose(pt[m], v, err_msg=m, **TOL)
        else:
            np.testing.assert_array_equal(pt[m], v, err_msg=m)
    np.testing.assert_array_equal(pt["done"], n_requests)
    np.testing.assert_array_equal(pt["node_done"].sum(-1), pt["done"])
