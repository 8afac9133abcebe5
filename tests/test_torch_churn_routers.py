"""The port's routers under node churn against the JAX package
(`repro.api.run_experiment`, exact mode, N = 400, F = 12, K = 4, the
shapes of tests/test_churn.py): staggered periodic churn under jsq2,
slo_aware and cold_aware for ESFF and SFF, churn with a constant delay
a node, and the policies whose node state a NODE_DOWN resets (ESFF-H's
counts, OpenWhisk's LRU, FaasCache's GREEDY-DUAL clock). Integers exact,
per-request responses and sums within rtol 1e-9."""
import pytest
import torch

import repro_torch.api as tapi
from torch_cluster_cases import EXACT, SRC, assert_cells_match, both

SPAN = float(tapi.SyntheticTrace.make(**SRC).arrays()["arrival"].max())


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def periodic(api):
    """Node 0 always up, nodes 1..3 on a SPAN / 3 cycle, up 70 % of it,
    phases staggered by SPAN / 9 (the LEO-pass shape)."""
    return (None,) + tuple(api.PeriodicChurn(SPAN / 3, duty=0.7,
                                             phase=i * SPAN / 9)
                           for i in range(3))


@pytest.mark.parametrize("router", ["jsq2", "slo_aware", "cold_aware"])
def test_periodic_churn_matches_jax(router):
    """Drains, parked arrivals and re-routes, ESFF and SFF."""
    jx, pt = both(lambda a: [a.ClusterSpec(n_nodes=4, router=router,
                                           churn=periodic(a))],
                  policies=("esff", "sff"), **EXACT)
    assert_cells_match(jx, pt)


def test_churn_with_constant_delay_matches_jax():
    """Orphans re-pay the delivery leg of the node they re-route to, and
    responses run from the raw arrival."""
    import numpy as np
    arr = tapi.SyntheticTrace.make(**SRC).arrays()["arrival"]
    t30, t60 = (float(np.quantile(arr, q)) for q in (0.3, 0.6))
    jx, pt = both([dict(n_nodes=3, router=r, net_delay=(0.0, 0.013, 0.027),
                        churn=(None, ((t30, t60),), None))
                   for r in ("jsq2", "slo_aware")],
                  policies=("esff",), **EXACT)
    assert_cells_match(jx, pt)


@pytest.mark.parametrize("policy", ["esff_h", "openwhisk", "faascache"])
def test_node_reset_policies_under_churn_match_jax(policy):
    """A NODE_DOWN resets the node's slots and the policy's per-node state
    (ESFF-H's |K^j| and COLD counts, FaasCache's clock and priorities)
    while its estimators survive."""
    jx, pt = both(lambda a: [a.ClusterSpec(n_nodes=4, router="jsq2",
                                           churn=periodic(a))],
                  policies=(policy,), **EXACT)
    assert_cells_match(jx, pt)
