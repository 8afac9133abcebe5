"""The static cluster tier of the port (`repro_torch.cluster`) against
the JAX package's (`repro.cluster`) on the same numpy inputs: the mix32
hash, the static routers' partition, the K = 1 bitwise gate, the merge's
invariance to node order, mixed capacities and constant delays with the
engine options on (integers exact, merged sums and means bitwise, the
exact-mode p99 within rtol 1e-9), the cluster axis of the ResultSet, and
what stays unported raising with its ROADMAP item (the dynamic tier is
tests/test_torch_cluster_dynamic.py's)."""
from dataclasses import replace

import numpy as np
import pytest
import torch

import repro.api as japi
import repro_torch.api as tapi
from repro.cluster.routers import mix32_np as jax_mix32_np
from repro.cluster.routers import mix32_py as jax_mix32_py
from repro.cluster.static import build_node_streams as jax_streams
from repro_torch.cluster import ClusterSpec, routers
from repro_torch.cluster.static import (_ordered_sum, build_node_streams,
                                        merge_node_metrics)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The eager loop's ops are tiny: one intra-op thread a test process
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SRC = dict(n_functions=12, n_requests=400, seed=3, utilization=0.25)
GRID = dict(policies=("esff", "sff"), capacities=(6,), queue_cap=256)
STATIC_ROUTERS = ("hash", "round_robin", "weighted_random")


def _tsrc():
    return tapi.SyntheticTrace.make(**SRC)


def _run(entries, **kw):
    g = dict(GRID, **kw)
    return tapi.run_experiment(tapi.ExperimentSpec(
        traces=[_tsrc()], cluster=entries, device="cpu", **g))


@pytest.fixture(scope="module")
def plain():
    return tapi.run_experiment(tapi.ExperimentSpec(
        traces=[_tsrc()], device="cpu", **GRID)).check()


def test_mix32_matches_the_jax_packages():
    ids = np.arange(2000)
    for seed in (0, 7, 12345):
        want = jax_mix32_np(ids, seed)
        np.testing.assert_array_equal(routers.mix32_np(ids, seed), want)
        assert [routers.mix32_py(i, seed) for i in ids[:50]] == \
            [jax_mix32_py(i, seed) for i in ids[:50]] == want[:50].tolist()


@pytest.mark.parametrize("router", STATIC_ROUTERS)
def test_static_partition_routes_every_request_exactly_once(router):
    a = _tsrc().arrays()
    N = len(a["fn_id"])
    kw = dict(n_nodes=4, router=router, seed=5, net_delay=(0, 0.1, 0, 1),
              weights=(1, 2, 3, 4) if router == "weighted_random" else None)
    assign, streams, n_live, index = build_node_streams(
        a, ClusterSpec(**kw))
    assert assign.shape == (N,) and assign.min() >= 0 and assign.max() < 4
    allidx = np.concatenate(index)
    assert np.array_equal(np.sort(allidx), np.arange(N))
    assert n_live.sum() == N
    for k in range(4):
        nk = int(n_live[k])
        assert np.array_equal(streams["fn_id"][k, :nk], a["fn_id"][index[k]])
        assert np.all(np.diff(streams["arrival"][k, :nk]) >= 0)
        assert np.all(streams["arrival"][k, nk:] == 1e30)
        assert not streams["fn_id"][k, nk:].any()
        assert not streams["exec_time"][k, nk:].any()
    j = jax_streams(a, japi.ClusterSpec(**kw))
    np.testing.assert_array_equal(assign, j[0])
    for key, v in streams.items():
        np.testing.assert_array_equal(v, j[1][key], err_msg=key)
    np.testing.assert_array_equal(n_live, j[2])


def test_k1_cluster_bitwise_identical_to_single_node(plain):
    """A 1-node cluster with zero network delay is bitwise the plain
    single-node run, under both static routers."""
    rs = _run([ClusterSpec(n_nodes=1, router="hash"),
               ClusterSpec(n_nodes=1, router="round_robin")])
    assert rs.dims[-1] == "cluster"
    assert set(rs.data) == set(plain.data) | {"node_done"}
    for u, lab in enumerate(rs.coords["cluster"]):
        for m in plain.data:
            np.testing.assert_array_equal(
                plain.data[m], np.take(rs.data[m], u, axis=4),
                err_msg=f"{lab}/{m}")


class _PermutedHash(routers.StaticRouter):
    """Hash routing with relabeled node ids: the same partition, nodes
    numbered differently."""

    name = "perm_hash"

    def __init__(self, perm):
        self.perm = np.asarray(perm, np.int32)

    def assign(self, fn_id, arrival, spec):
        return self.perm[routers.ROUTERS["hash"].assign(fn_id, arrival,
                                                         spec)]


def test_static_merge_bitwise_invariant_to_node_order():
    perm = [2, 0, 3, 1]
    tapi.register_router("perm_hash", _PermutedHash(perm))
    try:
        base = _run([ClusterSpec(n_nodes=4, router="hash")])
        relabeled = _run([ClusterSpec(n_nodes=4, router="perm_hash")])
    finally:
        tapi.unregister_router("perm_hash")
    for m in base.data:
        a, b = base.data[m], relabeled.data[m]
        if m == "node_done":      # relabeled[perm[k]] == base[k]
            b = b[..., perm]
        np.testing.assert_array_equal(a, b, err_msg=m)
    # the ordered sum itself: any order of the addends, the same bits
    x = np.random.default_rng(0).uniform(0, 1e3, (3, 7))
    for p in ([6, 5, 4, 3, 2, 1, 0], [3, 1, 4, 0, 5, 2, 6]):
        np.testing.assert_array_equal(_ordered_sum(x[:, p], 1),
                                      _ordered_sum(x, 1))


def _entries(api):
    return [None,
            api.ClusterSpec(n_nodes=2, router="hash",
                            node_capacity=(4, 2), net_delay=0.05),
            api.ClusterSpec(n_nodes=3, router="round_robin",
                            node_capacity=(3, 1, 2),
                            net_delay=(0.0, 0.2, 0.01)),
            api.ClusterSpec(n_nodes=3, router="weighted_random", seed=9,
                            weights=(1.0, 2.0, 3.0),
                            node_capacity=(1, 2, 3))]


@pytest.mark.parametrize("policy", ("esff", "sff", "faascache"))
def test_static_tier_matches_jax(policy):
    """Mixed node capacities, constant delays, a plain entry beside the
    static ones, deadlines and the timeline: every merged metric and
    node_done bitwise the JAX static tier's."""
    kw = dict(policies=(policy,), capacities=(6,), queue_cap=256,
              deadlines=0.8, tl_bins=4, tl_bucket=30.0)
    jx = japi.run_experiment(japi.ExperimentSpec(
        traces=[japi.SyntheticTrace.make(**SRC)], cluster=_entries(japi),
        **kw)).check()
    pt = tapi.run_experiment(tapi.ExperimentSpec(
        traces=[_tsrc()], cluster=_entries(tapi), device="cpu",
        **kw)).check()
    assert pt.coords == jx.coords
    assert set(pt.data) == set(jx.data) | {"n_events"}
    for m, v in jx.data.items():
        np.testing.assert_array_equal(pt[m], v, err_msg=m)
    assert pt["node_done"].shape[-1] == 3
    np.testing.assert_array_equal(pt["node_done"].sum(-1), pt["done"])


def test_static_exact_mode_matches_jax():
    """Exact mode: the per-request responses reassembled across nodes and
    the p99 over them."""
    kw = dict(policies=("esff",), capacities=(4,), queue_cap=256,
              stream=False, keep_per_request=True)
    jx = japi.run_experiment(japi.ExperimentSpec(
        traces=[japi.SyntheticTrace.make(**SRC)],
        cluster=_entries(japi)[1:3], **kw))
    pt = _run(_entries(tapi)[1:3], **kw)
    for m, v in jx.data.items():
        if m in ("response", "p99_response"):
            np.testing.assert_allclose(pt[m], v, rtol=1e-9, atol=1e-9)
        else:
            np.testing.assert_array_equal(pt[m], v, err_msg=m)


def test_merge_recomputes_means_from_the_merged_sums():
    rng = np.random.default_rng(1)
    per = dict(resp_sum=rng.uniform(0, 10, (2, 3)),
               slow_sum=rng.uniform(0, 10, (2, 3)),
               done=np.array([[3, 4, 5], [1, 1, 1]]),
               resp_hist=rng.integers(0, 3, (2, 3, 64)).astype(np.int32),
               max_response=rng.uniform(0, 5, (2, 3)))
    out = merge_node_metrics(per, node_axis=1, n_total=12)
    np.testing.assert_array_equal(out["mean_response"],
                                  _ordered_sum(per["resp_sum"], 1)
                                  * (1.0 / 12))
    np.testing.assert_array_equal(out["node_done"], per["done"])
    np.testing.assert_array_equal(out["max_response"],
                                  per["max_response"].max(1))


def test_resultset_cluster_axis_sel_rows_npz(tmp_path):
    entries = [None, ClusterSpec(n_nodes=2, router="round_robin")]
    rs = _run(entries, policies=("esff",))
    assert rs.coords["cluster"] == ["none", "round_robin:K2"]
    cell = rs.sel(cluster="round_robin:K2")
    assert cell.grid_shape == (1, 1, 1, 1, 1)
    nd = cell.value("node_done")
    assert nd.shape == (2,) and nd.sum() == SRC["n_requests"]
    assert rs.value("node_done", cluster="none").tolist() == \
        [SRC["n_requests"], 0]
    rows = list(rs.rows())
    assert [r["cluster"] for r in rows] == ["none", "round_robin:K2"]
    path = tmp_path / "rs.npz"
    rs.save_npz(path)
    back = tapi.ResultSet.load_npz(path)
    assert back.dims == rs.dims
    for m in rs.metrics:
        np.testing.assert_array_equal(back[m], rs[m])


def test_breaker_router_raises_with_its_item():
    """The circuit breaker of the resilience layer (ported) runs: without
    faults it never trips and routes as jsq2, and a run with faults
    conserves its requests."""
    spec = tapi.ExperimentSpec(
        traces=[_tsrc()], cluster=[ClusterSpec(n_nodes=2, router="breaker"),
                                   ClusterSpec(n_nodes=2, router="jsq2")],
        device="cpu", **GRID)
    rs = tapi.run_experiment(spec.validate()).check()
    assert not rs["breaker_trips"].any()
    for k in ("done", "resp_sum", "node_done", "resp_hist"):
        np.testing.assert_array_equal(rs[k][:, :, :, :, 0],
                                      rs[k][:, :, :, :, 1])
    faulty = tapi.run_experiment(replace(
        spec, fail_prob=0.5, on_overflow="shed")).check()
    tot = faulty["done"] + faulty["shed"] + faulty["failed_exhausted"]
    assert (tot == faulty.meta["n_requests"]).all()


@pytest.mark.parametrize("field", ("churn", "delay_schedule"))
def test_churn_and_delay_schedules_raise_with_their_item(field):
    """Churn and time-varying delay (ROADMAP Queue 1, item 2) run on the
    dynamic tier only: the spec validates, and on a static router the run
    raises, as the JAX package's does."""
    value = {"churn": (((0.5, 1.0),), None),
             "delay_schedule": tapi.DelaySchedule(times=(0.0, 1.0),
                                                  values=(0.01, 0.02))}
    spec = tapi.ExperimentSpec(
        traces=[_tsrc()], device="cpu",
        cluster=[ClusterSpec(n_nodes=2, router="hash",
                             **{field: value[field]})], **GRID)
    spec.validate()
    with pytest.raises(ValueError, match="static"):
        tapi.run_experiment(spec)


def test_cluster_spec_validation_errors():
    bad = [dict(n_nodes=0), dict(n_nodes=2, node_capacity=(1,)),
           dict(n_nodes=2, node_capacity=(1, 0)),
           dict(n_nodes=2, net_delay=(0.1,)),
           dict(n_nodes=2, net_delay=-1.0),
           dict(n_nodes=2, net_delay=float("nan")),
           dict(n_nodes=2, weights=(1.0,)),
           dict(n_nodes=2, weights=(1.0, 0.0))]
    for kw in bad:
        with pytest.raises(ValueError):
            ClusterSpec(**kw).validate()
    with pytest.raises(KeyError, match="registered routers"):
        ClusterSpec(router="nope").validate()
    with pytest.raises(ValueError, match="exactly one entry"):
        tapi.ExperimentSpec(
            traces=[_tsrc()], capacities=(4, 8),
            cluster=[ClusterSpec(n_nodes=2, node_capacity=(2, 2))]
        ).validate()
    with pytest.raises(TypeError):
        tapi.ExperimentSpec(traces=[_tsrc()], cluster=["hash"]).validate()
    with pytest.raises(ValueError, match="cluster=()"):
        tapi.ExperimentSpec(traces=[_tsrc()], cluster=()).validate()
    assert ClusterSpec(n_nodes=4, router="hash",
                       node_capacity=(2, 2, 2, 2)).label == "hash:K4x2"
    assert ClusterSpec(n_nodes=2, router="round_robin",
                       node_capacity=(3, 1), net_delay=0.1).label == \
        "round_robin:K2x3,1+d"
    with pytest.raises(TypeError):
        tapi.register_router("x", object())
    with pytest.raises(ValueError, match="already registered"):
        tapi.register_router("hash", routers.HashRouter())
