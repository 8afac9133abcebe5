"""The dynamic cluster tier of the port (`repro_torch.cluster.engine`: the
K-node event loop and its routers) against the JAX package's
(`repro.cluster.engine`) on the same numpy inputs: JSQ's draws and the
startability score, the routers at K = 4 with and without a network
delay (integers exact, per-request responses and sums within the ROADMAP
bar, most of them bitwise), slo_aware's reduction to cold_aware, the
conservation of requests, and a user's own dynamic router on the eager
loop. The K = 1 identity and the in-flight rail's node_of are
tests/test_torch_cluster_rails.py's."""
import numpy as np
import pytest
import torch

import repro.api as japi
import repro_torch.api as tapi
from repro.cluster.routers import ClusterView as JaxView
from repro.cluster.routers import JSQRouter as JaxJSQ
from repro.cluster.routers import _startability_score
from repro.cluster.routers import get_router as jax_router
from repro_torch.cluster import ClusterSpec, routers
from repro_torch.core.policies import KERNELS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The eager loop's ops are tiny: one intra-op thread a test process
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SRC = dict(n_functions=12, n_requests=400, seed=3, utilization=0.25)
DELAYS = (0.0, 0.013, 0.027, 0.041)
TOL = dict(rtol=1e-9, atol=1e-9)
EXACT = dict(capacities=(3,), queue_cap=256, stream=False,
             keep_per_request=True)


def _both(entries, **kw):
    """The same spec through the JAX package and the port (CPU)."""
    jx = japi.run_experiment(japi.ExperimentSpec(
        traces=[japi.SyntheticTrace.make(**SRC)],
        cluster=[japi.ClusterSpec(**e) for e in entries], **kw)).check()
    pt = tapi.run_experiment(tapi.ExperimentSpec(
        traces=[tapi.SyntheticTrace.make(**SRC)],
        cluster=[ClusterSpec(**e) for e in entries], device="cpu",
        **kw)).check()
    return jx, pt


def _assert_cells_match(jx, pt):
    assert pt.coords == jx.coords
    assert set(pt.data) == set(jx.data) | {"n_events"}
    for m, v in jx.data.items():
        if m in ("response", "p99_response", "resp_sum", "slow_sum",
                 "mean_response", "mean_slowdown", "cold_time",
                 "max_response"):
            np.testing.assert_allclose(pt[m], v, err_msg=m, **TOL)
        else:
            np.testing.assert_array_equal(pt[m], v, err_msg=m)
    # conservation: every request served once, by one node
    np.testing.assert_array_equal(pt["done"], SRC["n_requests"])
    np.testing.assert_array_equal(pt["node_done"].sum(-1), pt["done"])


# ------------------------------------------------------------- routers
def test_jsq_draws_match_mix32():
    """JSQ's partial Fisher-Yates on tensors draws the nodes that the JAX
    package's pairs of mix32_py name, for many request ids and seeds."""
    rid = torch.arange(300, dtype=torch.int64)
    for K, seed in ((2, 0), (5, 3), (64, 12345), (7, 2 ** 33 + 5)):
        want = []
        for r in rid.tolist():
            nodes = list(range(K))
            for i, j in JaxJSQ.sample(r, seed, K, 2):
                nodes[i], nodes[j] = nodes[j], nodes[i]
            want.append(nodes[:2])
        # every load equal: the pick is the first draw
        g = _view(np.random.default_rng(K), L=len(rid), K=K)
        g.q_tot = torch.zeros_like(g.q_tot)
        g.slot_state = torch.zeros_like(g.slot_state)
        g.seed = torch.full((len(rid),), seed)
        got = routers.JSQRouter("jsq2").pick(g, None, rid, None)
        assert got.tolist() == [w[0] for w in want]
        h = routers.mix32_torch(rid, torch.tensor(seed))
        assert h.tolist() == [routers.mix32_py(r, seed) for r in rid.tolist()]


def _view(rng, L, K, C=3, F=5):
    """A random lane-batched ClusterView (the port's)."""
    return routers.ClusterView(
        q_len=torch.tensor(rng.integers(0, 4, (L, K, F)), dtype=torch.int32),
        q_tot=torch.tensor(rng.integers(0, 9, (L, K)), dtype=torch.int32),
        slot_fn=torch.tensor(rng.integers(-1, F, (L, K, C))),
        slot_state=torch.tensor(rng.integers(0, 3, (L, K, C))),
        cap_mask=torch.tensor(rng.random((L, K, C)) < 0.8),
        est_sum=torch.tensor(rng.uniform(0, 3, (L, K, F))),
        est_n=torch.tensor(rng.integers(0, 3, (L, K, F)), dtype=torch.int32),
        node_gn=torch.tensor(rng.integers(0, 3, (L, K))),
        node_gsum=torch.tensor(rng.uniform(0, 5, (L, K))),
        t_cold=torch.tensor(rng.uniform(0.1, 2, (L, F))), prior=0.1,
        n_nodes=torch.full((L,), K), node_ok=torch.ones((L, K), dtype=bool),
        seed=torch.zeros((L,), dtype=torch.int64),
        delay_now=torch.tensor(rng.uniform(0, 0.05, (L, K))))


def test_startability_score_bitwise_jax():
    """The cold-aware score on random views, lane by lane, against JAX's
    `_startability_score`, bitwise; cold_aware and slo_aware pick its
    first argmin (slo_aware after adding the delays)."""
    import jax.numpy as jnp
    rng = np.random.default_rng(4)
    L, K = 16, 6
    g = _view(rng, L, K)
    j = torch.tensor(rng.integers(0, 5, L))
    got = routers.startability_score(g, j)
    for li in range(L):
        jv = JaxView(**{k: (jnp.asarray(getattr(g, k)[li].numpy())
                           if k not in ("prior",) else g.prior)
                        for k in ("q_len", "q_tot", "slot_fn", "slot_state",
                                  "cap_mask", "est_sum", "est_n", "node_gn",
                                  "node_gsum", "prior")},
                     t_cold=jnp.asarray(g.t_cold[li].numpy()), n_nodes=K,
                     seed=0)
        want = np.asarray(_startability_score(jv, int(j[li])))
        np.testing.assert_array_equal(got[li].numpy(), want)
        jv.delay_now = jnp.asarray(g.delay_now[li].numpy())
        assert int(routers.ROUTERS["slo_aware"].pick(g, j, None, None)[li]) \
            == int(jax_router("slo_aware").pick(jv, int(j[li]), 0, 0.0))
        jv.delay_now = None
        assert int(routers.ROUTERS["cold_aware"].pick(g, j, None, None)[li]) \
            == int(jax_router("cold_aware").pick(jv, int(j[li]), 0, 0.0))


# ------------------------------------------------ the K-node loop vs JAX
@pytest.mark.parametrize("policy", ("esff", "sff", "openwhisk_v2"))
def test_k4_routers_match_jax_exact(policy):
    """jsq2 and cold_aware at K = 4 nodes of C = 3 in exact mode: every
    per-request response, counter, node_done and sum against the JAX
    package's K-node loop."""
    jx, pt = _both([dict(n_nodes=4, router=r) for r in ("jsq2",
                                                        "cold_aware")],
                   policies=(policy,), **EXACT)
    _assert_cells_match(jx, pt)


def test_slo_aware_under_delay_matches_jax():
    """slo_aware weighs each node's delay in: against JAX in exact mode,
    beside cold_aware, which ignores it."""
    entries = [dict(n_nodes=4, router=r, net_delay=DELAYS)
               for r in ("slo_aware", "cold_aware")]
    jx, pt = _both(entries, policies=("faascache",), **EXACT)
    _assert_cells_match(jx, pt)


def test_slo_aware_without_delay_is_cold_aware():
    """With no delay slo_aware adds nothing to the score: bitwise
    cold_aware, in one call (two lanes side by side)."""
    pt = tapi.run_experiment(tapi.ExperimentSpec(
        traces=[tapi.SyntheticTrace.make(**SRC)], policies=("esff_h",),
        capacities=(2,), queue_cap=256, device="cpu",
        cluster=[ClusterSpec(n_nodes=3, router=r)
                 for r in ("slo_aware", "cold_aware")]))
    for m, v in pt.data.items():     # (P, T, KC, B, cluster, ...)
        np.testing.assert_array_equal(v[:, :, :, :, 0], v[:, :, :, :, 1],
                                      err_msg=m)


def test_stream_mode_conserves_requests():
    """Stream mode at K = 4 with mixed node capacities, both routers side
    by side: every request is done once, the per-node counts add up, and
    the streamed sums are bitwise the exact-mode run's."""
    kw = dict(policies=("sff",), capacities=(6,), queue_cap=256)
    e = [ClusterSpec(n_nodes=4, router=r, node_capacity=(3, 1, 2, 1),
                     seed=2) for r in ("jsq2", "cold_aware")]
    src = [tapi.SyntheticTrace.make(**SRC)]
    st = tapi.run_experiment(tapi.ExperimentSpec(
        traces=src, cluster=e, device="cpu", **kw)).check()
    ex = tapi.run_experiment(tapi.ExperimentSpec(
        traces=src, cluster=e, device="cpu", stream=False, **kw)).check()
    np.testing.assert_array_equal(st["done"], SRC["n_requests"])
    np.testing.assert_array_equal(st["node_done"].sum(-1), st["done"])
    for m in ("resp_sum", "slow_sum", "cold_starts", "node_done",
              "resp_hist", "n_events"):
        np.testing.assert_array_equal(st[m], ex[m], err_msg=m)


# ------------------------------------------------- a user's own router
class _LeastBusy(routers.DynamicRouter):
    """Fewest busy slots, ties to the lowest node id: not a built-in, so
    it runs on the eager K-node loop."""

    name = "least_busy"

    def pick(self, g, j, rid, t):
        busy = ((g.slot_state == 2) & g.cap_mask).sum(-1)
        return torch.argmin(torch.where(g.node_ok, busy, 10 ** 9), dim=1)


def test_custom_dynamic_router_runs_eagerly():
    from repro_torch.cluster.engine import has_cluster_loop
    from repro_torch.kernels import event_loop as K0
    r = tapi.register_router("least_busy", _LeastBusy())
    try:
        assert not has_cluster_loop(KERNELS["esff"], (r,))
        assert has_cluster_loop(KERNELS["esff"],
                                (routers.get_router("jsq2"),))
        plain0 = K0.cluster_loop.plain_calls
        rs = tapi.run_experiment(tapi.ExperimentSpec(
            traces=[tapi.SyntheticTrace.make(**dict(SRC, n_requests=150))],
            policies=("esff",), capacities=(2,), queue_cap=256,
            device="cpu",
            cluster=[ClusterSpec(n_nodes=3, router="least_busy")])).check()
        assert K0.cluster_loop.plain_calls == plain0   # not the wrapper
    finally:
        tapi.unregister_router("least_busy")
    nd = rs.value("node_done")
    assert nd.sum() == 150 and (nd > 0).all()
