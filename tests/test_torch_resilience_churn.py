"""The port's resilience layer with node churn and the circuit breaker
against the JAX package (N = 400, F = 12, tests/test_resilience.py's
faults, exact mode): churn plus faults under jsq2 for ESFF and SFF, a
window in which every node is down while retries wait (they park), the
breaker at fail_prob 0.6 (it trips and recovers), a table of fault knobs
(conservation, and no layer at all when every knob is trivial), and the
`BreakerRouter`'s validation and fail-open. Integers exact, per-request
responses and sums within rtol 1e-9, NaN where JAX has NaN."""
import numpy as np
import pytest
import torch

import repro_torch.api as tapi
from repro_torch.cluster.routers import (BreakerRouter, ClusterView,
                                         JSQRouter, get_router)
from torch_cluster_cases import (SRC, assert_resil_cells_match, both_specs,
                                 faults)

SPAN = float(tapi.SyntheticTrace.make(**SRC).arrays()["arrival"].max())
EXACT = dict(capacities=(3,), queue_cap=64, stream=False,
             keep_per_request=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def spec_kw(api, policies, cluster, fault_kw=None, **kw):
    return dict(traces=[api.SyntheticTrace.make(**SRC)], policies=policies,
                cluster=cluster(api), **faults(api, **(fault_kw or {})),
                **dict(EXACT, **kw))


def test_churn_plus_faults_match_jax():
    """tests/test_resilience.py's churn case: node 1 on a SPAN / 3 cycle;
    drained attempts give their attempt back and re-route."""
    jx, pt = both_specs(lambda a: spec_kw(a, ("esff", "sff"), lambda b: [
        b.ClusterSpec(n_nodes=4, router="jsq2", churn=(
            None, b.PeriodicChurn(SPAN / 3, duty=0.7), None, None))]))
    assert_resil_cells_match(jx, pt)


def test_all_down_window_parks_retries():
    """Every node down over the 30 % to 45 % quantiles of the arrivals:
    retries falling due then park with the arrivals and re-route when a
    node is up again."""
    arr = tapi.SyntheticTrace.make(**SRC).arrays()["arrival"]
    q30, q45 = (float(np.quantile(arr, q)) for q in (0.3, 0.45))
    jx, pt = both_specs(lambda a: spec_kw(a, ("esff",), lambda b: [
        b.ClusterSpec(n_nodes=2, router="jsq2",
                      churn=(((q30, q45),),) * 2)], dict(fail_prob=0.4)))
    assert_resil_cells_match(jx, pt)
    assert int(pt["retried"].sum()) > 0


def test_breaker_trips_and_recovers_match_jax():
    jx, pt = both_specs(lambda a: spec_kw(a, ("esff",), lambda b: [
        b.ClusterSpec(n_nodes=4, router="breaker")], dict(fail_prob=0.6)))
    assert_resil_cells_match(jx, pt)
    trips = int(pt.value("breaker_trips"))
    assert trips > 0 and trips == int(jx.value("breaker_trips"))
    assert int(pt.value("done")) > 0


@pytest.mark.parametrize("fail_prob,timeout,attempts,jitter,mode,churned", [
    (0.0, None, 3, 0.0, "error", False),
    (0.3, None, 1, 0.0, "shed", True),
    (0.1, 1.0, 5, 0.9, "shed_oldest", False),
    (0.45, 20.0, 2, 0.5, "shed", True)])
def test_fault_knob_table(fail_prob, timeout, attempts, jitter, mode,
                          churned):
    """A few knob combinations on jsq2 K = 2 at queue_cap 16: each
    conserves its requests and matches the JAX package; with every knob
    trivial the run is bitwise the run without the layer."""
    trivial = fail_prob == 0.0 and timeout is None

    def make(api):
        cs = api.ClusterSpec(
            n_nodes=2, router="jsq2",
            churn=((None, api.PeriodicChurn(SPAN / 3, duty=0.7))
                   if churned else None))
        kw = dict(traces=[api.SyntheticTrace.make(**SRC)],
                  policies=("esff",), capacities=(3,), queue_cap=16,
                  cluster=[cs], fail_seed=7)
        if not trivial:
            kw.update(fail_prob=fail_prob, timeouts=timeout, on_overflow=mode,
                      retry=api.RetryPolicy(max_attempts=attempts, base=0.05,
                                            cap=1.0, jitter=jitter))
        return kw
    if trivial:
        kw = dict(make(tapi), device="cpu")
        rs = tapi.run_experiment(tapi.ExperimentSpec(
            **kw, fail_prob=0.0, timeouts=None, on_overflow="error"))
        r0 = tapi.run_experiment(tapi.ExperimentSpec(**kw))
        assert set(rs.data) == set(r0.data)
        for k in r0.data:
            np.testing.assert_array_equal(rs[k], r0[k], err_msg=k)
        return
    jx, pt = both_specs(make)
    assert_resil_cells_match(jx, pt)


# --------------------------------------------------- the breaker router
def test_breaker_router_validation():
    inner = JSQRouter()
    with pytest.raises(TypeError, match="DynamicRouter"):
        BreakerRouter(get_router("hash"))
    for kw in (dict(threshold=0.0), dict(threshold=1.5)):
        with pytest.raises(ValueError, match="threshold"):
            BreakerRouter(inner, **kw)
    for kw in (dict(volume=0), dict(cooldown=0.0)):
        with pytest.raises(ValueError, match="volume >= 1 and cooldown"):
            BreakerRouter(inner, **kw)
    b = BreakerRouter(inner, volume=7, threshold=0.3)
    assert b.trip_at == 3 and get_router("breaker").inner.name == "jsq2"


def test_breaker_skips_tripped_nodes_and_fails_open():
    """At K = 2 (cold_aware inside, node 0 the better score): node 0
    tripped sends the request to node 1; both tripped, the breaker fails
    open and routes as its inner router."""
    from repro_torch.cluster.routers import ColdAwareRouter
    L, K, C, F = 3, 2, 2, 3
    g = dict(q_len=torch.zeros((L, K, F), dtype=torch.int32),
             q_tot=torch.tensor([[0, 1]] * L, dtype=torch.int32),
             slot_fn=torch.full((L, K, C), -1), slot_state=torch.ones(
                 (L, K, C), dtype=torch.int64),
             cap_mask=torch.ones((L, K, C), dtype=torch.bool),
             est_sum=torch.zeros((L, K, F), dtype=torch.float64),
             est_n=torch.zeros((L, K, F), dtype=torch.int32),
             node_gn=torch.zeros((L, K), dtype=torch.int64),
             node_gsum=torch.zeros((L, K), dtype=torch.float64),
             t_cold=torch.ones((L, F), dtype=torch.float64), prior=0.1,
             n_nodes=torch.full((L,), K), node_ok=torch.ones(
                 (L, K), dtype=torch.bool), seed=torch.zeros(L, dtype=torch.int64),
             delay_now=torch.zeros((L, K), dtype=torch.float64), up=None,
             brk_until=torch.tensor([[0.0, 0.0], [9.0, 0.0], [9.0, 9.0]],
                                    dtype=torch.float64))
    j = torch.zeros(L, dtype=torch.int64)
    t = torch.full((L,), 5.0, dtype=torch.float64)
    brk = BreakerRouter(ColdAwareRouter())
    got = brk.pick(ClusterView(**g), j, torch.arange(L), t)
    assert got.tolist() == [0, 1, 0]
