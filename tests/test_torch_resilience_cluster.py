"""The port's resilience layer on the dynamic tier against the JAX
package (N = 400, F = 12, K = 4, tests/test_resilience.py's faults,
shedding at queue_cap 16): jsq2, cold_aware, slo_aware with a delay a
node and jsq2 over mixed node capacities (3, 1, 2, 1) for ESFF and SFF;
ESFF-H, OpenWhisk and FaasCache under jsq2; and streaming equal to exact
mode. Integers exact, sums within rtol 1e-9."""
import numpy as np
import pytest
import torch

import repro_torch.api as tapi
from torch_cluster_cases import (DELAYS, SRC, assert_resil_cells_match,
                                 both_specs, faults)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def routers(api):
    C = api.ClusterSpec
    return [C(n_nodes=4, router="jsq2"), C(n_nodes=4, router="cold_aware"),
            C(n_nodes=4, router="slo_aware", net_delay=DELAYS),
            C(n_nodes=4, router="jsq2", node_capacity=(3, 1, 2, 1))]


def spec_kw(api, policies, cluster, **kw):
    return dict(traces=[api.SyntheticTrace.make(**SRC)], policies=policies,
                capacities=(3,), queue_cap=16, cluster=cluster(api),
                **faults(api), **kw)


def test_routers_match_jax():
    jx, pt = both_specs(lambda a: spec_kw(a, ("esff", "sff"), routers))
    assert_resil_cells_match(jx, pt)
    for k in ("shed", "retried", "timed_out", "failed_exhausted"):
        assert int(pt[k].sum()) > 0, k


def test_other_policies_under_jsq2_match_jax():
    jx, pt = both_specs(lambda a: spec_kw(
        a, ("esff_h", "openwhisk", "faascache"),
        lambda b: [b.ClusterSpec(n_nodes=4, router="jsq2")]))
    assert_resil_cells_match(jx, pt)


def test_stream_equals_exact():
    """The streamed means are the exact-mode ones, bitwise (one fold),
    and every counter is equal."""
    kw = spec_kw(tapi, ("esff",), routers, device="cpu")
    rs = tapi.run_experiment(tapi.ExperimentSpec(**kw)).check()
    rx = tapi.run_experiment(tapi.ExperimentSpec(
        **dict(kw, stream=False))).check()
    for k in ("done", "shed", "failed", "timed_out", "retried",
              "failed_exhausted", "node_done", "mean_response",
              "mean_slowdown", "resp_hist", "goodput"):
        np.testing.assert_array_equal(rs[k], rx[k], err_msg=k)
