"""The engine options of the port (`n_live`, `deadlines`, the minute
timeline `tl_bins` / `tl_bucket`, `window=`) against the JAX package on
the same numpy inputs, for every policy: the eager loop (the CPU route
and the plain version of the event-loop kernel) folds them in event
order, so counters, histograms, timeline counts and deadline misses are
exact and the streamed sums bitwise the JAX engine's; the exact-mode p99
within rtol 1e-9. The kernel's variants against the eager loop, bitwise,
need a card: tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

import repro.api as japi
import repro_torch.api as tapi
from repro.core.jax_engine import _sweep_metrics
from repro.core.jax_policies import KERNELS as JAX_KERNELS
from repro.core.simulator import simulate as py_simulate
from repro.traces import synth_azure_arrays, synth_azure_trace
from repro_torch.core import engine as E
from repro_torch.core.policies import KERNELS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The eager loop's ops are tiny: one intra-op thread a test process
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


POLICIES = ("esff", "esff_h", "sff", "openwhisk", "faascache",
            "openwhisk_v2")
COLS = ("fn_id", "arrival", "exec_time", "cold_start", "evict")
F, N, C = 12, 300, 4
# ragged lanes: the whole row, a prefix, none, a short prefix
N_LIVE = np.array([N, 150, 0, 77], np.int32)
CAPS = (4, 3, 4, 2)
BUCKET = 10.0


def _trace():
    return synth_azure_arrays(n_functions=F, n_requests=N,
                              utilization=0.15, seed=3)


def _deadlines():
    return np.linspace(0.2, 3.0, F)


def _bins(a):
    return int(a["arrival"].max() // BUCKET) + 1


def _jax(a, policy, **kw):
    k = JAX_KERNELS[policy]
    masks = np.stack([np.arange(C) < c for c in CAPS])
    out = _sweep_metrics(
        *(np.asarray(a[c])[None] for c in COLS),
        np.zeros(len(CAPS), np.int32), masks,
        np.full(len(CAPS), k.default_beta), np.float64(0.1),
        np.float64(0.1), N_LIVE, _deadlines(), kernel=k, n_fns=F,
        capacity=C, queue_cap=512, **kw)
    return {m: np.asarray(v) for m, v in out.items()}


def _port(a, policy, **kw):
    k = KERNELS[policy]
    masks = torch.tensor(np.stack([np.arange(C) < c for c in CAPS]))
    out = E.sweep_metrics(
        *(torch.as_tensor(a[c])[None] for c in COLS),
        torch.zeros(len(CAPS), dtype=torch.int64), masks,
        torch.full((len(CAPS),), k.default_beta, dtype=torch.float64),
        0.1, 0.1, kernel=k, n_fns=F, capacity=C, queue_cap=512,
        n_live=N_LIVE, deadlines=_deadlines(), **kw)
    return {m: v.numpy() for m, v in out.items()}


@pytest.mark.parametrize("policy", POLICIES)
def test_engine_options_match_jax(policy):
    """Ragged n_live lanes (one of them empty), per-function deadlines
    and the timeline in one lane batch, bitwise the JAX engine's; the
    port runs at window=64 (a window changes no result) against the JAX
    engine's single window."""
    a = _trace()
    kw = dict(stream=True, tl_bins=_bins(a), tl_bucket=BUCKET)
    jx = _jax(a, policy, **kw)
    pt = _port(a, policy, window=64, **kw)
    assert set(pt) == set(jx) | {"n_events"}
    for m, v in jx.items():
        np.testing.assert_array_equal(pt[m], v, err_msg=f"{policy} {m}")
    np.testing.assert_array_equal(pt["done"], N_LIVE)
    assert not pt["stalled"].any() and not pt["overflow"].any()
    # the empty lane ends at once, with nothing folded
    assert pt["n_events"][2] == 0 and pt["tl_count"][2].sum() == 0
    np.testing.assert_array_equal(pt["tl_count"].sum(1), N_LIVE)
    assert 0 < pt["deadline_miss"].sum() < N_LIVE.sum()


@pytest.mark.parametrize("policy", POLICIES)
def test_api_deadlines_timeline_exact_mode_match_jax(policy):
    """Through the API: one scalar deadline (broadcast to every
    function), the timeline and exact mode with the per-request
    responses (the port's at window=128); deadline_miss and
    slo_attainment bitwise, p99 within rtol 1e-9."""
    a = _trace()
    kw = dict(policies=(policy,), capacities=(3, 5), queue_cap=512,
              deadlines=1.5, tl_bins=_bins(a), tl_bucket=BUCKET,
              stream=False, keep_per_request=True)
    jx = japi.run_experiment(japi.ExperimentSpec(
        traces=[japi.ArrayTrace.make(a)], **kw))
    pt = tapi.run_experiment(tapi.ExperimentSpec(
        traces=[tapi.ArrayTrace.from_arrays(a)], device="cpu", window=128,
        **kw))
    assert set(pt.data) == set(jx.data) | {"n_events"}
    for m, v in jx.data.items():
        if m in ("p99_response", "response"):
            np.testing.assert_allclose(pt[m], v, rtol=1e-9, atol=1e-9)
        else:
            np.testing.assert_array_equal(pt[m], v, err_msg=m)
    assert pt["deadline_miss"].shape == (1, 1, 2, 1, F)
    np.testing.assert_array_equal(
        pt["slo_attainment"],
        1.0 - pt["deadline_miss"].sum(-1) / pt["done"])
    assert pt.meta["deadlines"] == 1.5 and pt.meta["tl_bins"] == _bins(a)


@pytest.mark.parametrize("policy", POLICIES)
def test_timeline_fold_matches_python_timeline(policy):
    """The minute-binned fold reproduces the Python event engine's Fig. 8
    timeline (tests/test_streaming.py's oracle): the same bins, counts
    and means."""
    tr = synth_azure_trace(n_functions=12, n_requests=400,
                           utilization=0.25, seed=3)
    a = tr.to_arrays()
    n_bins = int(a["arrival"].max() // 60.0) + 1
    rs = tapi.run_experiment(tapi.ExperimentSpec(
        traces=[tapi.ArrayTrace.from_arrays(a)], policies=(policy,),
        capacities=(6,), queue_cap=512, tl_bins=n_bins, tl_bucket=60.0,
        device="cpu")).check()
    cnt = rs.value("tl_count").astype(np.int64)
    rsum, esum = rs.value("tl_resp_sum"), rs.value("tl_exec_sum")
    assert int(cnt.sum()) == len(tr)
    tl = py_simulate(tr, policy, capacity=6).timeline(60.0)
    n_py = len(tl["minute"])
    np.testing.assert_array_equal(cnt[:n_py], tl["n_requests"])
    nz = cnt[:n_py] > 0
    np.testing.assert_allclose(rsum[:n_py][nz] / cnt[:n_py][nz],
                               tl["mean_response"][nz], rtol=1e-12)
    np.testing.assert_allclose(esum[:n_py][nz] / cnt[:n_py][nz],
                               tl["mean_exec"][nz], rtol=1e-12)


def test_option_values_are_checked():
    a = _trace()
    t = {c: torch.as_tensor(a[c])[None] for c in COLS}
    args = (t["fn_id"], t["arrival"], t["exec_time"], t["cold_start"],
            t["evict"], torch.zeros(1, dtype=torch.int64),
            torch.ones(1, C, dtype=torch.bool),
            torch.ones(1, dtype=torch.float64), 0.1)
    kw = dict(kernel=KERNELS["esff"], n_fns=F, capacity=C, queue_cap=64)
    for bad in (dict(n_live=[N + 1]), dict(n_live=[-1]),
                dict(window=-1), dict(tl_bins=-2)):
        with pytest.raises(ValueError):
            E.simulate(*args, **kw, **bad)
    src = tapi.ArrayTrace.from_arrays(a)
    for bad in (dict(deadlines=()), dict(deadlines=0.0),
                dict(deadlines=float("inf")), dict(tl_bins=-1),
                dict(window=-1)):
        with pytest.raises(ValueError):
            tapi.ExperimentSpec(traces=[src], **bad).validate()
    spec = tapi.ExperimentSpec(traces=[src], deadlines=(1.0, 2.0))
    with pytest.raises(ValueError, match="2 entries"):
        spec.deadline_ops(F)
    np.testing.assert_array_equal(
        tapi.ExperimentSpec(traces=[src], deadlines=2).deadline_ops(3),
        np.full(3, 2.0))


def test_event_loop_wrapper_checks_the_option_operands():
    """The kernel's wrapper takes int64 (L,) live counts and f64 (F,)
    deadlines on the trace's device, and raises on anything else before
    any launch or plain call."""
    from repro_torch.kernels import event_loop as K0
    a = _trace()
    t = {c: torch.as_tensor(a[c], dtype=torch.int64 if c == "fn_id"
                            else torch.float64)[None] for c in COLS}
    args = (t["fn_id"], t["arrival"], t["exec_time"], t["cold_start"],
            t["evict"], torch.zeros(2, dtype=torch.int64),
            torch.ones(2, C, dtype=torch.bool),
            torch.ones(2, dtype=torch.float64), 0.1)
    kw = dict(kernel=KERNELS["esff"], n_fns=F, capacity=C, queue_cap=64)
    before = (K0.event_loop.plain_calls, K0.event_loop.launches)
    for bad, exc in ((dict(n_live=torch.tensor([1, 2], dtype=torch.int32)),
                      TypeError),
                     (dict(n_live=torch.tensor([1, 2, 3])), ValueError),
                     (dict(n_live=torch.tensor([1, N + 1])), ValueError),
                     (dict(deadlines=torch.ones(F, dtype=torch.float32)),
                      TypeError),
                     (dict(deadlines=torch.ones(F + 1,
                                                dtype=torch.float64)),
                      ValueError),
                     (dict(tl_bins=-1), ValueError)):
        with pytest.raises(exc):
            K0.event_loop(*args, **kw, **bad)
    assert (K0.event_loop.plain_calls, K0.event_loop.launches) == before
