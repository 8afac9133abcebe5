"""The port's resilience layer (failure injection, timeouts, retries with
capped exponential backoff, shedding) against the JAX package: the
planning and backoff helpers bitwise, the spec's validation, the no-fault
lowering, `ResultSet.check`'s conservation and overflow messages, and the
single node and the static tier (hash, round_robin with a delay) for the
five policies that admit the layer, streaming with ``shed``, at the
shapes of tests/test_resilience.py (N = 400, F = 12, C = 3). The single
node runs as a one-node lane of the K-node loop, which must equal a K = 1
jsq2 cluster; integers exact, sums within rtol 1e-9."""
import numpy as np
import pytest
import torch

import repro.api as japi
import repro_torch.api as tapi
from torch_cluster_cases import (SRC, assert_resil_cells_match, both_specs,
                                 faults)

POLICIES = ("esff", "esff_h", "sff", "openwhisk", "faascache")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ helpers
def test_backoff_bitwise_against_jax():
    """`backoff_torch` and `backoff_py` against `backoff_jax` on the 256
    draws of tests/test_resilience.py, jitter included."""
    from repro.core.resilience import backoff_jax
    from repro_torch.core.resilience import backoff_py, backoff_torch
    rng = np.random.default_rng(7)
    keys = rng.integers(0, 1 << 20, size=256).astype(np.int32)
    atts = rng.integers(1, 16, size=256).astype(np.int32)
    for base, cap, jitter, seed in ((0.05, 1.0, 0.3, 99), (1.0, 30.0, 0.0, 0),
                                    (0.5, 4.0, 0.99, 12345)):
        ref = np.asarray(backoff_jax(atts, keys, base, cap, jitter, seed))
        got = backoff_torch(torch.as_tensor(atts), torch.as_tensor(keys),
                            base, cap, jitter, seed).numpy()
        py = np.array([backoff_py(int(a), int(k), base, cap, jitter, seed)
                       for a, k in zip(atts, keys)])
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(py, ref)


@pytest.mark.parametrize("fail_prob,timeouts,attempts", [
    (0.3, None, 4), (0.2, 8.0, 3), ((0.0, 0.5, 0.9), (1.0, 0.5, 3.0), 16)])
def test_plan_outcomes_array_equal_jax(fail_prob, timeouts, attempts):
    from repro.core.resilience import plan_outcomes as jplan
    from repro_torch.core.resilience import plan_outcomes
    rng = np.random.default_rng(1)
    F = 1 if np.isscalar(fail_prob) else len(fail_prob)
    fn = rng.integers(0, F, 500)
    ex = rng.lognormal(0.0, 1.0, 500)
    rid = rng.permutation(5000)[:500]
    kw = dict(fail_prob=fail_prob, timeouts=timeouts, max_attempts=attempts,
              n_fns=F, seed=99, rid=rid)
    for got, want in zip(plan_outcomes(fn, ex, **kw), jplan(fn, ex, **kw)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_retry_policy_validation():
    for kw, match in ((dict(max_attempts=0), "max_attempts"),
                      (dict(max_attempts=17), "max_attempts"),
                      (dict(jitter=1.0), "jitter"),
                      (dict(base=-1.0), ">= 0")):
        with pytest.raises(ValueError, match=match):
            japi.RetryPolicy(**kw)
        with pytest.raises(ValueError, match=match):
            tapi.RetryPolicy(**kw)
    assert tapi.RetryPolicy(max_attempts=5, base=0.5).as_tuple() == \
        japi.RetryPolicy(max_attempts=5, base=0.5).as_tuple()


@pytest.mark.parametrize("kw,exc,match", [
    (dict(on_overflow="drop"), ValueError, "on_overflow"),
    (dict(fail_prob=1.5), ValueError, "fail_prob"),
    (dict(fail_prob=-0.1), ValueError, "fail_prob"),
    (dict(timeouts=0.0), ValueError, "timeouts"),
    (dict(fail_prob=0.1, retry=3), TypeError, "RetryPolicy"),
    (dict(retry="policy"), ValueError, "does nothing"),
    (dict(policies=("openwhisk_v2",), fail_prob=0.1), ValueError, "timers")])
def test_spec_validation_as_jax(kw, exc, match):
    """The port's spec refuses what the JAX package's refuses, with the
    same exception and message."""
    def spec(api):
        k = dict(kw)
        if k.get("retry") == "policy":
            k["retry"] = api.RetryPolicy()
        k.setdefault("policies", ("esff",))
        return api.ExperimentSpec(
            traces=[api.SyntheticTrace.make(**SRC)], capacities=(3,), **k)
    msgs = []
    for api in (japi, tapi):
        with pytest.raises(exc, match=match) as e:
            spec(api).validate()
        msgs.append(str(e.value).replace("—", "--"))
    assert msgs[0] == msgs[1]


def test_spec_lowerings_as_jax():
    """`resilience_active`, `retry_policy`, `resilience_ops` and
    `resilience_meta` of the port's spec equal the JAX package's."""
    def spec(api, **kw):
        return api.ExperimentSpec(traces=[api.SyntheticTrace.make(**SRC)],
                                  capacities=(3,), **kw)
    for kw in (dict(), dict(on_overflow="shed"),
               dict(fail_prob=(0.1,) * 12, timeouts=2.0, fail_seed=7)):
        j, t = spec(japi, **kw), spec(tapi, **kw)
        assert t.resilience_active() == j.resilience_active()
        assert t.resilience_meta() == j.resilience_meta()
        st = japi.SyntheticTrace.make(**SRC).arrays()
        stacked = {k: st[k][None] for k in ("fn_id", "exec_time")}
        jo, to = j.resilience_ops(stacked, 12), t.resilience_ops(stacked, 12)
        assert (jo is None) == (to is None)
        if jo is not None:
            assert to[4] == jo[4]
            for a, b in zip(to[:4], jo[:4]):
                np.testing.assert_array_equal(a, b)


# ---------------------------------------------- lowering and checks
def test_no_fault_spec_lowers_bitwise_unchanged():
    """fail_prob 0, no timeouts and on_overflow "error" leave every tier
    on the run without the layer, bitwise, and add no metric."""
    def spec(**kw):
        return tapi.ExperimentSpec(
            traces=[tapi.SyntheticTrace.make(**SRC)], policies=("esff",),
            capacities=(3,), queue_cap=256, device="cpu", cluster=(
                None, tapi.ClusterSpec(n_nodes=2, router="hash"),
                tapi.ClusterSpec(n_nodes=2, router="jsq2")), **kw)
    r0 = tapi.run_experiment(spec()).check()
    r1 = tapi.run_experiment(spec(fail_prob=0.0, timeouts=None,
                                  on_overflow="error")).check()
    assert set(r0.data) == set(r1.data)
    for k in r0.data:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    assert "shed" not in r0.data and "goodput" not in r0.data


def test_check_conservation_and_overflow_messages():
    grid = dict(policy=["esff"], trace=["t"], capacity=[3], beta=["default"])
    one = lambda v: np.full((1, 1, 1, 1), v)  # noqa: E731
    data = dict(done=one(8), shed=one(1), failed_exhausted=one(0),
                overflow=one(0), stalled=one(0))
    meta = dict(n_requests=10, resilience=dict(on_overflow="shed"))
    with pytest.raises(RuntimeError, match="conservation"):
        tapi.ResultSet(data=data, coords=grid, meta=meta).check()
    data["failed_exhausted"] = one(1)
    tapi.ResultSet(data=data, coords=grid, meta=meta).check()
    # with shedding disabled an overrun names the cell's coordinates
    rs = tapi.run_experiment(tapi.ExperimentSpec(
        traces=[tapi.SyntheticTrace.make(**SRC)], policies=("esff",),
        capacities=(3,), queue_cap=2, fail_prob=0.2, fail_seed=99,
        device="cpu"))
    with pytest.raises(RuntimeError, match="shedding disabled"):
        rs.check()
    with pytest.raises(RuntimeError, match="policy='esff'"):
        rs.check()


# ----------------------------------------- single node and static tier
@pytest.fixture(scope="module")
def tiers_stream():
    """The single node and the static tier (hash K = 2, round_robin K = 3
    with a 3 ms delay) under tests/test_resilience.py's faults, shedding
    at queue_cap 8, the five policies, streaming: the JAX package's run,
    and the port's with a K = 1 jsq2 entry added."""
    def make(api, k1):
        cl = [None, api.ClusterSpec(n_nodes=2, router="hash"),
              api.ClusterSpec(n_nodes=3, router="round_robin",
                              net_delay=0.003)]
        if k1:
            cl.append(api.ClusterSpec(n_nodes=1, router="jsq2"))
        return dict(traces=[api.SyntheticTrace.make(**SRC)],
                    policies=POLICIES, capacities=(3,), queue_cap=8,
                    cluster=cl, **faults(api))
    jx = japi.run_experiment(japi.ExperimentSpec(**make(japi, False)))
    pt = tapi.run_experiment(tapi.ExperimentSpec(device="cpu",
                                                 **make(tapi, True)))
    return jx.check(), pt.check()


def test_single_node_and_static_tier_match_jax(tiers_stream):
    jx, pt = tiers_stream
    assert_resil_cells_match(jx, pt, clusters=jx.coords["cluster"])
    assert int(pt["shed"].sum()) > 0 and int(pt["retried"].sum()) > 0


def test_k1_cluster_is_the_single_node(tiers_stream):
    """A K = 1 jsq2 cluster is the single node, bitwise, in every metric
    (the route `engine.simulate` takes under resilience)."""
    _, pt = tiers_stream
    one, k1 = pt.sel(cluster="none"), pt.sel(cluster="jsq2:K1")
    for k in pt.data:
        np.testing.assert_array_equal(one[k], k1[k], err_msg=k)
