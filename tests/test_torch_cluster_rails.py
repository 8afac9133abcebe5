"""The rails of the port's dynamic cluster tier
(`repro_torch.cluster.engine`), where it departs from the single-node
engine's queues: the K = 1 identity (a one-node cluster at zero delay is
bitwise the port's single-node run under each of jsq2, cold_aware and
slo_aware, for all six policies: the link-rail queues and OpenWhisk-v2's
timer chain over node arrivals reproduce the positional rails), and the
in-flight rail of a network delay against the JAX package
(`repro.cluster.engine._simulate_cluster`), with each request's node."""
import numpy as np
import pytest
import torch

import repro_torch.api as tapi
from repro.api.registry import get_kernel as jax_kernel
from repro.cluster.engine import _simulate_cluster
from repro.cluster.routers import get_router as jax_router
from repro_torch.cluster import ClusterSpec, routers
from repro_torch.cluster.engine import simulate_cluster
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
ROUTERS = ("jsq2", "cold_aware", "slo_aware")
DELAYS = (0.0, 0.013, 0.027, 0.041)
TOL = dict(rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("policy", ("esff", "esff_h", "sff", "openwhisk",
                                    "faascache", "openwhisk_v2"))
def test_one_node_dynamic_cluster_is_the_single_node_run(policy):
    """The three routers' one-node entries run as lanes of one K-node
    call beside a plain entry, in exact mode: every metric bitwise."""
    rs = tapi.run_experiment(tapi.ExperimentSpec(
        traces=[tapi.SyntheticTrace.make(**SRC)], policies=(policy,),
        capacities=(6,), queue_cap=256, stream=False, keep_per_request=True,
        device="cpu",
        cluster=[None] + [ClusterSpec(n_nodes=1, router=r)
                          for r in ROUTERS])).check()
    assert rs.coords["cluster"] == ["none"] + [f"{r}:K1" for r in ROUTERS]
    for m, v in rs.data.items():    # (P, T, KC, B, cluster, ...)
        for u in range(1, len(ROUTERS) + 1):
            np.testing.assert_array_equal(v[:, :, :, :, u],
                                          v[:, :, :, :, 0],
                                          err_msg=f"{ROUTERS[u - 1]} {m}")
    N = SRC["n_requests"]
    assert int(rs.value("done", cluster="jsq2:K1")) == N
    if policy == "openwhisk_v2":    # the timer chain fired
        timers = (rs.value("n_events", cluster="jsq2:K1") - N
                  - rs.value("done", cluster="jsq2:K1")
                  - rs.value("cold_starts", cluster="jsq2:K1"))
        assert timers > 100


def _direct(policy, router, delays, seed=0, C=3, stream=False):
    """`_simulate_cluster` (JAX) and `simulate_cluster` (the port) on one
    lane of the small trace at K = len(delays) nodes of C slots."""
    a = tapi.SyntheticTrace.make(**SRC).arrays()
    K = len(delays)
    cols = ("fn_id", "arrival", "exec_time", "cold_start", "evict")
    beta = KERNELS[policy].default_beta
    jo = _simulate_cluster(
        *(np.asarray(a[k])[None] for k in cols), np.zeros(1, np.int32),
        np.ones((1, K, C), bool), np.full(1, beta), 0.1, 0.1,
        np.asarray(delays), kernel=jax_kernel(policy),
        router=jax_router(router), n_nodes=K, n_fns=SRC["n_functions"],
        capacity=C, queue_cap=256, seed=seed, stream=stream,
        has_delay=any(delays))
    t = [torch.tensor(np.asarray(a[k]))[None] for k in cols]
    po = simulate_cluster(
        *t, torch.zeros(1, dtype=torch.int64),
        torch.ones((1, K, C), dtype=torch.bool),
        torch.full((1,), beta, dtype=torch.float64), 0.1, 0.1,
        kernel=KERNELS[policy], routers=(routers.get_router(router),),
        router_ix=[0], n_nodes=[K], seeds=[seed], delays=[list(delays)],
        n_fns=SRC["n_functions"], capacity=C, queue_cap=256, stream=stream)
    return {k: np.asarray(v) for k, v in jo.items()}, po


@pytest.mark.parametrize("policy", ("esff", "openwhisk_v2"))
def test_net_delay_matches_jax(policy):
    """jsq2 with per-node delays, through the engine: the in-flight rail,
    every dispatch and completion on the node-local clock, and the node of
    each request (node_of), against the JAX package (run_experiment's
    responses under delay: test_torch_cluster_dynamic.py)."""
    jo, po = _direct(policy, "jsq2", DELAYS, seed=5)
    for k in ("node_of", "node_done", "done", "cold_starts", "evictions",
              "n_events", "resp_hist", "overflow", "stalled"):
        np.testing.assert_array_equal(po[k].numpy(), jo[k], err_msg=k)
    for k in ("start", "completion", "resp_sum", "slow_sum"):
        np.testing.assert_allclose(po[k].numpy(), jo[k], err_msg=k, **TOL)
    assert set(po["node_of"][0].tolist()) == {0, 1, 2, 3}
