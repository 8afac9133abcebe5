"""The port's Python reference cluster
(`repro_torch.cluster.simulate_cluster_reference`) against the JAX
package's (`repro.cluster.reference`), and the port's eager K-node loop
against it.

* Reference against reference: every returned array equal (NaNs equal)
  and the event logs equal, on the cases of tests/test_cluster.py
  (dynamic routers, network delay, the static path), tests/test_churn.py
  (periodic churn under jsq2 and slo_aware, churn with delay, an all-down
  window, delay schedules, deadlines under churn) and
  tests/test_resilience.py (retries and shedding on both tiers, the
  breaker, churn with faults), over the same trace (F = 12, N = 400,
  seed 3). Both are plain Python, so the cases cost seconds.
* The eager K-node loop (`repro_torch.api.run_experiment` on the CPU)
  against the port's reference at the JAX package's ``_assert_parity``
  bar (tests/test_churn.py): responses within rtol 1e-9 and atol 1e-9,
  ``cold_starts`` and ``node_done`` exact; a churn case, a delay-schedule
  case and a resilience case with the breaker.
"""
import numpy as np
import pytest
import torch

import repro_torch.api as tapi
import repro_torch.cluster as tcl
from repro_torch.core.resilience import RetryPolicy

SRC = dict(n_functions=12, n_requests=400, seed=3, utilization=0.25)
_ARR = tapi.SyntheticTrace.make(**SRC).arrays()["arrival"]
SPAN = float(_ARR.max())
T30, T45, T60 = (float(np.quantile(_ARR, q)) for q in (0.3, 0.45, 0.6))
FAULT_KW = dict(fail_prob=0.2, timeouts=8.0, on_overflow="shed",
                fail_seed=99)
RETRY = dict(max_attempts=3, base=0.05, cap=1.0, jitter=0.3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The eager loop's ops are tiny: one intra-op thread a test process
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _periodic(a):
    return (None, a.PeriodicChurn(SPAN / 3, duty=0.7),
            a.PeriodicChurn(SPAN / 3, duty=0.7, phase=SPAN / 9),
            a.PeriodicChurn(SPAN / 3, duty=0.7, phase=2 * SPAN / 9))


def _sched(a):
    return (None, None, a.DelaySchedule(times=(0.0, SPAN / 4),
                                        values=(0.005, 0.08),
                                        period=SPAN / 2))


# (name, policy, ClusterSpec kwargs from a package's api, reference kw):
# each package builds its own spec and trace from the same numbers
CASES = [
    *[(f"dynamic-{r}-{p}", p, lambda a, r=r: dict(n_nodes=4, router=r),
       dict(capacity=3))
      for r in ("jsq2", "cold_aware") for p in ("esff", "sff",
                                                "openwhisk_v2")],
    *[(f"net-delay-{p}", p, lambda a: dict(
        n_nodes=4, router="jsq2", net_delay=(0.0, 0.013, 0.027, 0.041)),
       dict(capacity=3)) for p in ("esff", "openwhisk_v2")],
    *[(f"static-hash-{p}", p, lambda a: dict(
        n_nodes=3, router="hash", node_capacity=(4, 2, 3),
        net_delay=(0.0, 0.05, 0.1)), {}) for p in ("esff", "openwhisk_v2")],
    *[(f"churn-{r}-{p}", p, lambda a, r=r: dict(
        n_nodes=4, router=r, churn=_periodic(a)), dict(capacity=3))
      for r in ("jsq2", "slo_aware") for p in ("esff", "sff")],
    ("churn-delay", "esff", lambda a: dict(
        n_nodes=3, router="jsq2", net_delay=(0.0, 0.013, 0.027),
        churn=(None, ((T30, T60),), None)), dict(capacity=3)),
    ("all-down", "esff", lambda a: dict(
        n_nodes=2, router="jsq2", churn=(((T30, T45),), ((T30, T45),))),
     dict(capacity=3)),
    *[(f"var-delay-{r}", "esff", lambda a, r=r: dict(
        n_nodes=3, router=r, net_delay=(0.0, 0.01, 0.0),
        delay_schedule=_sched(a)), dict(capacity=3))
      for r in ("jsq2", "slo_aware")],
    ("deadlines-churn", "esff", lambda a: dict(
        n_nodes=3, router="jsq2", churn=(None, ((T30, T60),), None)),
     dict(capacity=3, deadlines=np.full((12,), 0.35))),
    *[(f"faults-{r}", "esff", lambda a, r=r: dict(n_nodes=4, router=r),
       dict(capacity=3, queue_cap=64, **FAULT_KW))
      for r in ("hash", "round_robin", "jsq2", "cold_aware")],
    ("breaker", "esff", lambda a: dict(n_nodes=4, router="breaker"),
     dict(capacity=3, queue_cap=64, **dict(FAULT_KW, fail_prob=0.6))),
    ("churn-faults", "esff", lambda a: dict(
        n_nodes=4, router="jsq2",
        churn=(None, a.PeriodicChurn(SPAN / 3, duty=0.7), None, None)),
     dict(capacity=3, queue_cap=64, **FAULT_KW)),
]


def _ref_kw(a, kw):
    """``kw`` with a RetryPolicy of package ``a`` where faults are on."""
    if "fail_prob" not in kw:
        return dict(kw)
    return dict(kw, retry=a.RetryPolicy(**RETRY))


def _run_ref(a, ref_mod, policy, make, kw):
    log = []
    trace = a.SyntheticTrace.make(**SRC).to_trace()
    out = ref_mod.simulate_cluster_reference(
        trace, policy, a.ClusterSpec(**make(a)), event_log=log,
        **_ref_kw(a, kw))
    return out, log


@pytest.mark.parametrize("name,policy,make,kw", CASES,
                         ids=[c[0] for c in CASES])
def test_reference_matches_jax_reference(name, policy, make, kw):
    japi = pytest.importorskip("repro.api")
    jref = pytest.importorskip("repro.cluster.reference")
    from repro_torch.cluster import reference as tref
    jout, jlog = _run_ref(japi, jref, policy, make, kw)
    tout, tlog = _run_ref(tapi, tref, policy, make, kw)
    assert sorted(tout) == sorted(jout)
    for k, want in jout.items():
        got = tout[k]
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype and got.shape == want.shape, k
            assert np.array_equal(got, want, equal_nan=(
                want.dtype.kind == "f")), k
        else:
            assert type(got) is type(want) and got == want, k
    # a dead instance's completion counts as an event but logs nothing
    assert 0 < len(tlog) <= tout["n_events"]
    assert tlog == jlog


def test_reference_counts_conserve_and_name_events():
    """A resilience case conserves its requests, and every event of its
    log is one of the rail's kinds with a node in range (or -1)."""
    from repro_torch.cluster import reference as tref
    from repro_torch.telemetry.rail import TraceKind
    out, log = _run_ref(tapi, tref, "esff", CASES[-1][2], CASES[-1][3])
    assert (out["done"] + out["shed"] + out["failed_exhausted"]
            == SRC["n_requests"])
    assert out["retried"] > 0 and out["failed"] > 0
    assert {k for k, *_ in log} <= set(range(len(TraceKind.NAMES)))
    assert all(-1 <= n < 4 for *_, n, _ in log)


def _assert_parity(rs, ref, policy, msg=""):
    """tests/test_churn.py's bar: responses within 1e-9, cold starts and
    each node's completions exact."""
    np.testing.assert_allclose(rs.value("response", policy=policy),
                               ref["response"], rtol=1e-9, atol=1e-9,
                               err_msg=msg)
    assert int(rs.value("cold_starts", policy=policy)) \
        == ref["cold_starts"], msg
    np.testing.assert_array_equal(
        rs.value("node_done", policy=policy), ref["node_done"],
        err_msg=msg)


EAGER = {
    "churn-jsq2-esff": next(c for c in CASES if c[0] == "churn-jsq2-esff"),
    "var-delay-slo_aware": next(c for c in CASES
                                if c[0] == "var-delay-slo_aware"),
    "breaker": next(c for c in CASES if c[0] == "breaker"),
}


@pytest.mark.parametrize("name", sorted(EAGER))
def test_eager_cluster_loop_matches_reference(name):
    """The port's eager K-node loop (the CPU route of the dynamic tier)
    request for request against the port's reference."""
    _, policy, make, kw = EAGER[name]
    cs = tapi.ClusterSpec(**make(tapi))
    kw = dict(kw)
    spec_kw = dict(queue_cap=kw.pop("queue_cap", 256))
    kw.pop("capacity")
    if "fail_prob" in kw:
        spec_kw.update(kw, retry=RetryPolicy(**RETRY))
    rs = tapi.run_experiment(tapi.ExperimentSpec(
        traces=[tapi.SyntheticTrace.make(**SRC)], policies=(policy,),
        capacities=(3,), stream=False, keep_per_request=True,
        cluster=[cs], **spec_kw), device="cpu").check()
    ref = tcl.simulate_cluster_reference(
        tapi.SyntheticTrace.make(**SRC).to_trace(), policy, cs,
        **_ref_kw(tapi, EAGER[name][3]))
    _assert_parity(rs, ref, policy, name)
    if "fail_prob" in kw:
        for k in ("done", "failed", "timed_out", "retried", "shed",
                  "failed_exhausted", "breaker_trips"):
            assert int(rs.value(k, policy=policy)) == int(ref[k]), k
        assert int(ref["breaker_trips"]) > 0
