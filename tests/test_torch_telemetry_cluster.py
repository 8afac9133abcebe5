"""The port's traced cluster tiers against the JAX package's on
tests/test_telemetry.py's trace, event for event, every field (integers
exact; times within 1e-9, bitwise expected): the static tier (hash at K
= 3: sub-stream request ids remapped to global ids, nodes patched in, K
streams merged), the dynamic tier (jsq2 at K = 2; slo_aware at K = 4 with
delays: NODE_ARRIVAL), the K = 4 churn + retry spec (RETRY, REROUTE,
CHURN), SFF's bulk re-routes under periodic churn (their order), the
single node under faults (node -1), and a grid of 2 traces x 2
capacities x 2 betas x a cluster axis of a plain, a static and a dynamic
entry (each cell's stream filed under its own coordinates); and tracing
leaves
every metric of each tier bitwise. On the CPU the traced runs go through
the eager loops (the event-loop kernel's plain version)."""
import numpy as np
import pytest
import torch

import repro.api as japi
import repro_torch.api as tapi
from repro_torch.telemetry import TraceKind
from torch_telemetry_cases import assert_streams_match

SRC = dict(n_functions=12, n_requests=400, seed=3, utilization=0.25)
N = 400
BASE = dict(policies=("esff",), capacities=(3,), queue_cap=64, stream=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The eager loop's ops are tiny: one intra-op thread a test process
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _faults(api):
    return dict(fail_prob=0.2, timeouts=8.0,
                retry=api.RetryPolicy(max_attempts=3, base=0.05, cap=1.0,
                                      jitter=0.3),
                on_overflow="shed", fail_seed=99)


def _span(api):
    return float(api.SyntheticTrace.make(**SRC).arrays()["arrival"].max())


def _churn(api):
    arr = api.SyntheticTrace.make(**SRC).arrays()["arrival"]
    t30, t60 = (float(np.quantile(arr, q)) for q in (0.3, 0.6))
    return api.ClusterSpec(n_nodes=4, router="jsq2",
                           churn=(((t30, t60),),) + (None,) * 3)


# name: the spec's keywords, in either API
CASES = {
    # every axis of the grid longer than one: a swapped index in any
    # runner's cell mapping files a stream under another cell
    "grid": lambda api: dict(
        traces=[api.SyntheticTrace.make(**SRC),
                api.SyntheticTrace.make(**dict(SRC, seed=4))],
        capacities=(2, 3), betas=(0.5, 1.0),
        cluster=[None, api.ClusterSpec(n_nodes=3, router="hash"),
                 api.ClusterSpec(n_nodes=2, router="jsq2")]),
    "static_hash_k3": lambda api: dict(cluster=[api.ClusterSpec(
        n_nodes=3, router="hash")]),
    "jsq2_k2": lambda api: dict(cluster=[api.ClusterSpec(
        n_nodes=2, router="jsq2")]),
    "slo_aware_delay_k4": lambda api: dict(cluster=[api.ClusterSpec(
        n_nodes=4, router="slo_aware", net_delay=(0.0, 0.01, 0.02, 0.03))]),
    "churn_retry_k4": lambda api: dict(cluster=[_churn(api)],
                                       **_faults(api)),
    "single_node_faults": lambda api: _faults(api),
    # SFF's drains re-route tens of requests in bulk
    "sff_periodic_churn_k4": lambda api: dict(
        policies=("sff",), capacities=(1,), cluster=[api.ClusterSpec(
            n_nodes=4, router="jsq2", churn=(api.PeriodicChurn(
                _span(api) / 3, duty=0.5),) + (None,) * 3)]),
}


@pytest.fixture(scope="module")
def runs():
    """Each case traced through the JAX package and the port, and untraced
    through the port."""
    out = {}
    for name, kw in CASES.items():
        jspec = dict(BASE, traces=[japi.SyntheticTrace.make(**SRC)])
        jspec.update(kw(japi))
        jx = japi.run_experiment(japi.ExperimentSpec(trace_events=True,
                                                     **jspec))
        spec = dict(BASE, traces=[tapi.SyntheticTrace.make(**SRC)],
                    device="cpu")
        spec.update(kw(tapi))
        pt = tapi.run_experiment(tapi.ExperimentSpec(trace_events=True,
                                                     **spec))
        plain = tapi.run_experiment(tapi.ExperimentSpec(**spec))
        out[name] = (jx, pt, plain)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_cluster_tiers_event_for_event(runs, case):
    jx, pt, _ = runs[case]
    assert_streams_match(jx.trace, pt.trace)
    if case == "grid":
        assert len(pt.trace.cells) == 2 * 2 * 2 * 3
        for key, ev in pt.trace.cells.items():
            am = ev["kind"] == TraceKind.ARRIVAL
            assert sorted(ev["rid"][am].tolist()) == list(range(N)), key
        return
    ev = pt.trace.events()
    assert int((ev["kind"] == TraceKind.ARRIVAL).sum()) == N
    kinds = set(ev["kind"].tolist())
    if case == "churn_retry_k4":
        assert {TraceKind.RETRY, TraceKind.REROUTE,
                TraceKind.CHURN} <= kinds
    if case == "sff_periodic_churn_k4":
        assert int((ev["kind"] == TraceKind.REROUTE).sum()) >= 20
    if case == "slo_aware_delay_k4":
        assert int((ev["kind"] == TraceKind.NODE_ARRIVAL).sum()) == N
    if case == "single_node_faults":
        assert (ev["node"] == -1).all() and TraceKind.RETRY in kinds
    if case == "static_hash_k3":
        am = ev["kind"] == TraceKind.ARRIVAL
        assert sorted(ev["rid"][am].tolist()) == list(range(N))
        assert set(np.unique(ev["node"]).tolist()) == {0, 1, 2}
        assert np.all(np.diff(ev["t"]) >= 0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tracing_is_free_on_every_tier(runs, case):
    _, pt, plain = runs[case]
    assert plain.trace is None and pt.trace is not None
    assert sorted(pt.data) == sorted(plain.data)
    for m in plain.data:
        np.testing.assert_array_equal(pt[m], plain[m], err_msg=(case, m))
    # one record a processed event on the dynamic tiers and the single node
    if case not in ("static_hash_k3", "grid"):
        assert pt.trace.n_events == int(pt["n_events"].sum())
