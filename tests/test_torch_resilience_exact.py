"""The port's resilience layer in exact mode against the JAX package:
the single node and the static tier (hash, K = 2) for the five policies
that admit the layer, shedding the queue's oldest request at queue_cap
8, with each request's response kept (NaN for a shed or exhausted one),
at the shapes of tests/test_resilience.py. Integers exact, responses
and sums within rtol 1e-9."""
import numpy as np
import pytest
import torch

from torch_cluster_cases import (SRC, assert_resil_cells_match, both_specs,
                                 faults)

POLICIES = ("esff", "esff_h", "sff", "openwhisk", "faascache")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiers_exact():
    return both_specs(lambda api: dict(
        traces=[api.SyntheticTrace.make(**SRC)], policies=POLICIES,
        capacities=(3,), queue_cap=8, stream=False, keep_per_request=True,
        cluster=(None, api.ClusterSpec(n_nodes=2, router="hash")),
        **faults(api, on_overflow="shed_oldest")))


def test_shed_oldest_exact_matches_jax(tiers_exact):
    jx, pt = tiers_exact
    assert_resil_cells_match(jx, pt)
    resp = pt["response"]
    # a shed or exhausted request has no response
    assert np.isnan(resp).sum() == int((pt["shed"]
                                        + pt["failed_exhausted"]).sum())
    assert int(pt["shed"].sum()) > 0


def test_exact_p99_over_the_successes(tiers_exact):
    """The exact p99 is the percentile of the successes' responses."""
    _, pt = tiers_exact
    want = np.nanpercentile(pt["response"], 99.0, axis=-1)
    np.testing.assert_allclose(pt["p99_response"], want, rtol=1e-12)
