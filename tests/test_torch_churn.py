"""Node churn on the port's dynamic cluster tier against the JAX package
(`repro.api.run_experiment`, exact mode, N = 400, F = 12, in the shapes of
tests/test_churn.py): the spec's validation message for message, its
lowerings (toggles, the churn operand, the delay schedule's operands)
array for array, the static tier's and the timer policies' refusals, the
K = 1 always-up identity, conservation under a mid-flight death, the
all-down window, stream mode and deadlines under churn. Integers exact,
per-request responses and sums within rtol 1e-9
(tests/torch_cluster_cases.py). The routers under periodic churn are in
tests/test_torch_churn_routers.py, the delay schedules in
tests/test_torch_churn_delay.py."""
import math

import numpy as np
import pytest
import torch

import repro.api as japi
import repro_torch.api as tapi
from repro.cluster.engine import _sched_delay as jax_sched_delay
from repro_torch.cluster.engine import sched_delay
from torch_cluster_cases import EXACT, SRC, assert_cells_match, both

_ARR = tapi.SyntheticTrace.make(**SRC).arrays()["arrival"]
SPAN = float(_ARR.max())
T30, T45, T60 = (float(np.quantile(_ARR, q)) for q in (0.3, 0.45, 0.6))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The eager loop's ops are tiny: one intra-op thread a test process
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------ the spec
BAD_SPECS = [
    lambda a: a.ClusterSpec(n_nodes=2, router="jsq2",
                            churn=(None, ((3.0, 2.0),))),
    lambda a: a.ClusterSpec(n_nodes=1, router="jsq2",
                            churn=(((1.0, 5.0), (4.0, 8.0)),)),
    lambda a: a.ClusterSpec(n_nodes=1, router="jsq2",
                            churn=(((float("nan"), 2.0),),)),
    lambda a: a.ClusterSpec(n_nodes=1, router="jsq2",
                            churn=(((1.0, float("inf")),),)),
    lambda a: a.ClusterSpec(router="jsq2",
                            churn=a.PeriodicChurn(10.0, duty=0.0)),
    lambda a: a.ClusterSpec(router="jsq2",
                            churn=a.PeriodicChurn(10.0, duty=1.5)),
    lambda a: a.ClusterSpec(router="jsq2", churn=a.PeriodicChurn(-1.0)),
    lambda a: a.ClusterSpec(router="jsq2",
                            churn=a.PeriodicChurn(5.0, phase=math.inf)),
    lambda a: a.ClusterSpec(n_nodes=3, router="jsq2", churn=(None, ())),
    lambda a: a.ClusterSpec(n_nodes=3, router="jsq2",
                            delay_schedule=(None, None)),
    lambda a: a.ClusterSpec(n_nodes=2, router="jsq2",
                            delay_schedule=(None, 0.5)),
    lambda a: a.ClusterSpec(n_nodes=2, delay_schedule=a.DelaySchedule(
        times=(1.0,), values=(0.1,))),
    lambda a: a.ClusterSpec(n_nodes=2, delay_schedule=a.DelaySchedule(
        times=(0.0, 2.0, 2.0), values=(0.1, 0.2, 0.3))),
    lambda a: a.ClusterSpec(n_nodes=2, delay_schedule=a.DelaySchedule(
        times=(0.0, 2.0), values=(0.1,))),
    lambda a: a.ClusterSpec(n_nodes=2, delay_schedule=a.DelaySchedule(
        times=(0.0, 2.0), values=(0.1, -0.2))),
    lambda a: a.ClusterSpec(n_nodes=2, delay_schedule=a.DelaySchedule(
        times=(0.0, 2.0), values=(0.1, 0.2), period=-1.0)),
    lambda a: a.ClusterSpec(n_nodes=2, delay_schedule=a.DelaySchedule(
        times=(0.0, 2.0), values=(0.1, 0.2), period=2.0)),
]


@pytest.mark.parametrize("make", BAD_SPECS)
def test_spec_validation_matches_jax_message_for_message(make):
    """Each bad churn or delay schedule raises the JAX package's exception
    with its message."""
    errs = []
    for api in (japi, tapi):
        with pytest.raises((ValueError, TypeError)) as e:
            make(api).validate()
        errs.append((type(e.value), str(e.value)))
    assert errs[0] == errs[1]


GOOD_SPECS = [
    lambda a: a.ClusterSpec(n_nodes=3, router="jsq2",
                            churn=a.PeriodicChurn(10.0, duty=0.5)),
    lambda a: a.ClusterSpec(n_nodes=4, router="slo_aware", churn=(
        None, a.PeriodicChurn(SPAN / 3, duty=0.7),
        a.PeriodicChurn(SPAN / 3, duty=0.7, phase=SPAN / 9),
        a.PeriodicChurn(SPAN / 3, duty=0.7, phase=2 * SPAN / 9))),
    # starts down (phase past t = 0), and ends the horizon down
    lambda a: a.ClusterSpec(n_nodes=2, router="jsq2", churn=(
        a.PeriodicChurn(7.0, duty=0.3, phase=2.5),
        a.PeriodicChurn(6.0, duty=0.9, phase=-4.0))),
    lambda a: a.ClusterSpec(n_nodes=2, router="cold_aware",
                            churn=(((0.0, 3.0), (5.0, 9.5)), ((T30, T60),))),
    lambda a: a.ClusterSpec(n_nodes=1, router="jsq2",
                            churn=a.PeriodicChurn(10.0, duty=1.0)),
    lambda a: a.ClusterSpec(n_nodes=1, router="jsq2", churn=((),)),
    lambda a: a.ClusterSpec(n_nodes=3, router="slo_aware",
                            net_delay=(0.0, 0.01, 0.02),
                            delay_schedule=(None, a.DelaySchedule(
                                times=(0.0, 5.0, 7.5),
                                values=(0.005, 0.08, 0.02), period=10.0),
                                a.DelaySchedule(times=(0.0,),
                                                values=(0.03,)))),
    lambda a: a.ClusterSpec(n_nodes=2, router="jsq2", delay_schedule=(
        a.DelaySchedule(times=(0.0,), values=(0.04,)), None),
        net_delay=0.01),
    lambda a: a.ClusterSpec(n_nodes=2, router="hash", net_delay=0.02),
]


@pytest.mark.parametrize("make", GOOD_SPECS)
@pytest.mark.parametrize("horizon", [0.0, 9.99, 17.0, SPAN])
def test_lowerings_match_jax(make, horizon):
    """The label, `has_churn`, the toggles (a cycle before t = 0 and the
    next up of a node that ends the horizon down), the churn operand
    (BIG-padded, an all-BIG trailing column), `delays` (a one-step
    schedule folded in) and `delay_ops`, against the JAX package's."""
    j, t = make(japi).validate(), make(tapi).validate()
    assert t.label == j.label
    assert t.has_churn() == j.has_churn()
    assert t.churn_toggles(horizon) == j.churn_toggles(horizon)
    assert t.delays() == j.delays()
    for want, got in ((j.churn_operand(horizon), t.churn_operand(horizon)),
                      (j.delay_ops(), t.delay_ops())):
        assert (want is None) == (got is None)
        if want is not None:
            for w, g in zip(want if isinstance(want, tuple) else (want,),
                            got if isinstance(got, tuple) else (got,)):
                assert g.dtype == np.float64
                np.testing.assert_array_equal(g, w)


def test_sched_delay_matches_jax():
    """The schedule lookup on random times, periodic and not, bitwise the
    JAX package's `_sched_delay` (fmod against jnp.mod) and the spec's
    `DelaySchedule.at`."""
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    t = np.concatenate([rng.uniform(0, 500, 400), [0.0, 5.0, 10.0, 60.0]])
    dt = np.array([[0.0, 5.0, 7.5, 1e30], [0.0, 1e30, 1e30, 1e30],
                   [0.0, 30.0, 1e30, 1e30]])
    dv = np.array([[0.005, 0.08, 0.02, 0.02], [0.03] * 4,
                   [0.005, 0.08, 0.08, 0.08]])
    dp = np.array([10.0, 0.0, 60.0])
    for k in range(3):
        shape = (len(t), 4)
        args = (np.broadcast_to(dt[k], shape), np.broadcast_to(dv[k], shape),
                np.full(len(t), dp[k]))
        got = sched_delay(torch.tensor(t), *map(torch.tensor, args)).numpy()
        want = np.asarray(jax_sched_delay(jnp.asarray(t),
                                          *map(jnp.asarray, args)))
        np.testing.assert_array_equal(got, want)
    ds = tapi.DelaySchedule(times=(0.0, 5.0, 7.5), values=(0.005, 0.08, 0.02),
                            period=10.0)
    assert [ds.at(x) for x in t] == [japi.DelaySchedule(
        times=(0.0, 5.0, 7.5), values=(0.005, 0.08, 0.02),
        period=10.0).at(x) for x in t]


def _reject(api, cluster, policy):
    return api.run_experiment(api.ExperimentSpec(
        traces=[api.SyntheticTrace.make(**SRC)], policies=(policy,),
        capacities=(3,), cluster=[cluster(api)],
        **({} if api is japi else dict(device="cpu"))))


@pytest.mark.parametrize("cluster,policy", [
    (lambda a: a.ClusterSpec(n_nodes=2, router="hash",
                             churn=(((T30, T45),), None)), "esff"),
    (lambda a: a.ClusterSpec(n_nodes=2, router="round_robin",
                             delay_schedule=a.DelaySchedule(
                                 times=(0.0, 5.0), values=(0.01, 0.2))),
     "esff"),
    (lambda a: a.ClusterSpec(n_nodes=2, router="jsq2",
                             churn=(((T30, T45),), None)), "openwhisk_v2")])
def test_static_tier_and_timer_policies_refuse_churn_as_jax(cluster,
                                                            policy):
    """The static tier refuses churn and delay schedules, and a timer
    policy refuses churn, with the JAX package's messages."""
    msgs = []
    for api in (japi, tapi):
        with pytest.raises(ValueError) as e:
            _reject(api, cluster, policy)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert ("static" in msgs[0]) != ("timer" in msgs[0])


# ------------------------------------------------------ the loop
def test_k1_always_up_churn_is_the_plain_loop():
    """Schedules with no toggle (duty 1, an empty window list) lower to the
    plain loop: bitwise the run without churn, and the JAX package's."""
    def run(churn):
        return tapi.run_experiment(tapi.ExperimentSpec(
            traces=[tapi.SyntheticTrace.make(**SRC)], policies=("esff",),
            device="cpu", cluster=[tapi.ClusterSpec(
                n_nodes=1, router="jsq2", churn=churn)], **EXACT)).check()
    plain = run(None)
    for churn in (tapi.PeriodicChurn(10.0, duty=1.0), ((),)):
        rs = run(churn)
        for m in plain.data:
            np.testing.assert_array_equal(rs.data[m], plain.data[m],
                                          err_msg=f"{churn} {m}")
    jx, pt = both([dict(n_nodes=1, router="jsq2", churn=((),))],
                  policies=("esff",), **EXACT)
    assert_cells_match(jx, pt)


def test_mid_flight_death_conserves_requests_as_jax():
    """Node 0 of four dies at T30 holding running and queued work and comes
    back at T60: every request completes once, every response is
    positive, and the run is the JAX package's request for request."""
    jx, pt = both([dict(n_nodes=4, router="jsq2",
                        churn=(((T30, T60),), None, None, None))],
                  policies=("esff", "sff"), **EXACT)
    assert_cells_match(jx, pt)
    assert (pt["response"] > 0).all()


def test_all_down_window_parks_and_resumes_as_jax():
    """Every node down over [T30, T45]: arrivals in the window park, and
    none completes before the cluster comes back."""
    win = ((T30, T45),)
    jx, pt = both([dict(n_nodes=2, router="jsq2", churn=(win, win))],
                  policies=("esff",), **EXACT)
    assert_cells_match(jx, pt)
    inside = (_ARR >= T30) & (_ARR < T45)
    assert inside.any()
    comp = _ARR + pt.value("response", policy="esff")
    assert (comp[inside] >= T45).all()


def test_stream_mode_and_deadlines_under_churn_match_jax():
    """Stream mode (streamed sums, histogram, p99) with a 0.35 s deadline
    under staggered periodic churn, and the deadline misses against the
    raw arrival in exact mode, against the JAX package."""
    def entries(api):
        return [api.ClusterSpec(n_nodes=3, router="jsq2", churn=(
            None, api.PeriodicChurn(SPAN / 3, duty=0.7),
            ((T30, T60),)))]
    jx, pt = both(entries, policies=("sff",), capacities=(3,),
                  queue_cap=256, deadlines=0.35)
    assert_cells_match(jx, pt)
    jx, pt = both(entries, policies=("esff",), deadlines=0.35, **EXACT)
    assert_cells_match(jx, pt)
    resp = pt.value("response", policy="esff")
    fn = tapi.SyntheticTrace.make(**SRC).arrays()["fn_id"]
    np.testing.assert_array_equal(pt.value("deadline_miss", policy="esff"),
                                  np.bincount(fn[resp > 0.35], minlength=12))
