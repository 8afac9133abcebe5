"""Time-varying network delay on the port's dynamic cluster tier against
the JAX package (`repro.api.run_experiment`, exact mode, N = 400, F =
12): a periodic `DelaySchedule` under jsq2 and slo_aware (the landing
time, the response and slo_aware's delay term all sample the schedule),
OpenWhisk-v2's timers on the scheduled node-local clock, and churn on
top of a schedule (each re-send lands at its own delay). Integers exact,
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


def schedule(api):
    return api.DelaySchedule(times=(0.0, SPAN / 4), values=(0.005, 0.08),
                             period=SPAN / 2)


@pytest.mark.parametrize("policy", ["esff", "openwhisk_v2"])
def test_delay_schedule_matches_jax(policy):
    """jsq2 and slo_aware over a node whose link swings 5 ms <-> 80 ms."""
    jx, pt = both(lambda a: [a.ClusterSpec(
        n_nodes=3, router=r, net_delay=(0.0, 0.01, 0.0),
        delay_schedule=(None, None, schedule(a)))
        for r in ("jsq2", "slo_aware")], policies=(policy,), **EXACT)
    assert_cells_match(jx, pt)


def test_churn_plus_schedule_matches_jax():
    """Staggered periodic churn on links that swing, ESFF and SFF under
    slo_aware, with a deadline."""
    def entries(a):
        return [a.ClusterSpec(
            n_nodes=4, router="slo_aware",
            net_delay=(0.0, 0.004, 0.008, 0.012),
            delay_schedule=(None,) + (schedule(a),) * 3,
            churn=(None,) + tuple(a.PeriodicChurn(SPAN / 3, duty=0.7,
                                                  phase=i * SPAN / 9)
                                  for i in range(3)))]
    jx, pt = both(entries, policies=("esff", "sff"), deadlines=0.35,
                  **EXACT)
    assert_cells_match(jx, pt)
