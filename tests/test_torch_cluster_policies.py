"""The dynamic cluster tier's policies at K = 4 against the JAX package's
K-node loop (`repro.api.run_experiment`, exact mode unless stated, N =
400, F = 12): ESFF-H, OpenWhisk and FaasCache under jsq2 and cold_aware,
mixed node capacities, slo_aware and jsq2 under a per-node delay, and
stream mode under delay. Integers exact, per-request responses and sums
within rtol 1e-9 (tests/torch_cluster_cases.py)."""
import pytest
import torch

from torch_cluster_cases import DELAYS, EXACT, assert_cells_match, both


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The eager loop's ops are tiny: one intra-op thread a test process
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROUTERS = ("jsq2", "cold_aware")


@pytest.mark.parametrize("policy", ("esff_h", "openwhisk", "faascache"))
def test_routers_match_jax(policy):
    """jsq2 and cold_aware at K = 4 nodes of 3 slots."""
    jx, pt = both([dict(n_nodes=4, router=r) for r in ROUTERS],
                  policies=(policy,), **EXACT)
    assert_cells_match(jx, pt)


@pytest.mark.parametrize("policy", ("esff", "sff", "openwhisk_v2",
                                    "esff_h"))
def test_mixed_node_capacity_matches_jax(policy):
    """Both routers over nodes of 3, 1, 2 and 1 slots. OpenWhisk-v2 runs
    at N = 200: its timers make it the costliest lane on the CPU."""
    n = 200 if policy == "openwhisk_v2" else None
    jx, pt = both([dict(n_nodes=4, router=r, node_capacity=(3, 1, 2, 1),
                        seed=2) for r in ROUTERS],
                  n_requests=n, policies=(policy,), **EXACT)
    assert_cells_match(jx, pt, n or 400)


@pytest.mark.parametrize("policy", ("esff", "openwhisk_v2", "esff_h"))
def test_delay_routers_match_jax(policy):
    """slo_aware and jsq2 under per-node delays of 0 to 41 ms."""
    jx, pt = both([dict(n_nodes=4, router=r, net_delay=DELAYS)
                   for r in ("slo_aware", "jsq2")],
                  policies=(policy,), **EXACT)
    assert_cells_match(jx, pt)


@pytest.mark.parametrize("policy", ("esff", "sff"))
def test_stream_mode_under_delay_matches_jax(policy):
    """Stream mode under delay: the streamed sums, histogram and p99."""
    jx, pt = both([dict(n_nodes=4, router=r, net_delay=DELAYS)
                   for r in ROUTERS],
                  policies=(policy,), capacities=(3,), queue_cap=256)
    assert_cells_match(jx, pt)
