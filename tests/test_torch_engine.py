"""The port's ESFF engine (`repro_torch.core.engine`) against the JAX
engine on the same numpy arrays: counters and the response histogram
exact, per-request completions within rtol = atol = 1e-9 (the bar of
tests/test_jax_engine.py; bitwise is expected), plus the port's own
stream-vs-exact and lane-batching invariants."""
import warnings

import numpy as np
import pytest
import torch

from repro.core.jax_engine import simulate_policy_jax
from repro.traces import synth_azure_arrays
from repro_torch.core import engine as E
from repro_torch.core.policies import KERNELS
from repro_torch.kernels import frp_select as fs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The eager loop's ops are tiny: one intra-op thread a test process
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


COUNTERS = ("cold_starts", "evictions", "overflow", "stalled", "done",
            "n_events")
COLS = ("fn_id", "arrival", "exec_time", "cold_start", "evict")


def _trace(F, n, seed):
    return synth_azure_arrays(n_functions=F, n_requests=n,
                              utilization=0.2, seed=seed)


def _both(a, F, capacity, **kw):
    jx = simulate_policy_jax(*(a[k] for k in COLS), policy="esff",
                             n_fns=F, capacity=capacity, **kw)
    pt = E.simulate_policy(*(a[k] for k in COLS), policy="esff", n_fns=F,
                           capacity=capacity, device="cpu", **kw)
    return ({k: np.asarray(v) for k, v in jx.items()},
            {k: v.numpy() for k, v in pt.items()})


def _ulps(a, b):
    return int(np.abs(a.view(np.int64) - b.view(np.int64)).max())


@pytest.mark.parametrize("F,seed,capacity,n", [
    (20, 5, 8, 400), (20, 1, 4, 300), (200, 2, 16, 1000)])
def test_esff_matches_jax_engine(F, seed, capacity, n):
    a = _trace(F, n, seed)
    jx, pt = _both(a, F, capacity)
    assert int(pt["overflow"]) == 0 and int(pt["stalled"]) == 0
    assert int(pt["done"]) == n
    for k in COUNTERS:
        assert int(pt[k]) == int(jx[k]), k
    np.testing.assert_array_equal(pt["resp_hist"], jx["resp_hist"])
    for k in ("completion", "start"):
        np.testing.assert_allclose(pt[k], jx[k], rtol=1e-9, atol=1e-9)
        if not np.array_equal(pt[k], jx[k]):
            warnings.warn(f"{k}: not bitwise, max {_ulps(pt[k], jx[k])} "
                          "ulp from the JAX engine")
    for k in ("resp_sum", "slow_sum", "max_response", "cold_time",
              "evict_time"):
        np.testing.assert_allclose(pt[k], jx[k], rtol=1e-9, atol=0)


def test_queue_overflow_matches_jax_engine():
    """A saturated queue_cap surfaces in overflow and stalls the run,
    exactly as in the JAX engine."""
    n = 12
    a = dict(fn_id=np.zeros(n, np.int32),
             arrival=0.01 * np.arange(n), exec_time=np.ones(n),
             cold_start=np.array([0.5]), evict=np.array([0.2]))
    jx, pt = _both(a, 1, 1, queue_cap=2)
    assert int(pt["overflow"]) > 0
    for k in COUNTERS:
        assert int(pt[k]) == int(jx[k]), k
    np.testing.assert_array_equal(pt["completion"], jx["completion"])


def test_stream_sums_bitwise_equal_exact_sums():
    a = _trace(20, 400, 5)
    run = lambda stream: E.simulate_policy(  # noqa: E731
        *(a[k] for k in COLS), n_fns=20, capacity=8, stream=stream,
        device="cpu")
    ex, st = run(False), run(True)
    assert "completion" not in st
    for k, v in st.items():
        assert torch.equal(v, ex[k]), k


def test_lane_batch_equals_single_lanes():
    """Capacities as slot masks over one lane batch give bitwise the
    results of separate single-lane runs."""
    F, caps = 20, (4, 6, 8)
    a = _trace(F, 300, 1)
    t = {k: torch.tensor(a[k])[None] for k in COLS}
    masks = torch.tensor(np.stack([np.arange(max(caps)) < c
                                   for c in caps]))
    batch = E.simulate(t["fn_id"], t["arrival"], t["exec_time"],
                       t["cold_start"], t["evict"],
                       torch.zeros(len(caps), dtype=torch.int64), masks,
                       torch.ones(len(caps), dtype=torch.float64), 0.1,
                       kernel=KERNELS["esff"], n_fns=F,
                       capacity=max(caps), queue_cap=512)
    for li, c in enumerate(caps):
        one = E.simulate_policy(*(a[k] for k in COLS), n_fns=F,
                                capacity=c, device="cpu")
        for k, v in one.items():
            assert torch.equal(batch[k][li], v), (c, k)


def test_engine_frp_goes_through_frp_select_lanes():
    a = _trace(20, 200, 3)
    before = fs.frp_select_lanes.plain_calls
    E.simulate_policy(*(a[k] for k in COLS), n_fns=20, capacity=4,
                      stream=True, device="cpu")
    assert fs.frp_select_lanes.plain_calls > before


@pytest.mark.parametrize("opt", ["resil", "trace"])
def test_unported_engine_options_raise(opt):
    """Both options are ported: ``trace`` leaves every output bitwise and
    writes one record a processed event; the resilience layer runs and
    conserves the requests."""
    a = _trace(5, 20, 0)
    t = {k: torch.as_tensor(a[k])[None] for k in COLS}

    def run(**kw):
        return E.simulate(t["fn_id"], t["arrival"], t["exec_time"],
                          t["cold_start"], t["evict"],
                          torch.zeros(1, dtype=torch.int64),
                          torch.ones(1, 2, dtype=torch.bool),
                          torch.ones(1, dtype=torch.float64), 0.1,
                          kernel=KERNELS["esff"], n_fns=5, capacity=2,
                          queue_cap=2, **kw)
    if opt == "trace":
        from repro_torch.telemetry import rail
        plain = run()
        with rail.collect() as sink:
            traced = run(trace=True)
        assert sorted(traced) == sorted(plain)
        for k, v in plain.items():
            assert torch.equal(traced[k], v), k
        ev = sink.lane_events(0)
        n = int(plain["n_events"][0])
        assert len(ev["kind"]) == n
        assert ev["seq"].tolist() == list(range(1, n + 1))
        assert int((ev["kind"] == rail.TraceKind.ARRIVAL).sum()) == 20
        return
    from repro_torch.core.resilience import plan_outcomes
    eff, nfail, tmo = plan_outcomes(a["fn_id"], a["exec_time"], fail_prob=0.3,
                                    timeouts=None, max_attempts=2, n_fns=5,
                                    seed=1)
    out = run(rs_nfail=torch.as_tensor(nfail)[None],
              rs_tmo=torch.as_tensor(tmo)[None],
              rs_key=torch.arange(20, dtype=torch.int32)[None],
              resil=(2, 1, 0.05, 1.0, 0.0, 1))
    assert int(out["failed"][0]) > 0
    assert int(out["done"][0] + out["shed"][0]
               + out["failed_exhausted"][0]) == 20


def test_simulate_policy_from_trace_matches_jax():
    from repro.core.jax_engine import simulate_policy_from_trace as jx_run
    from repro.traces import synth_azure_trace
    from repro_torch.core.request import Trace
    tr = synth_azure_trace(n_functions=20, n_requests=300,
                           utilization=0.2, seed=1)
    jx = jx_run(tr, "esff", 4)
    pt = E.simulate_policy_from_trace(Trace.from_arrays(tr.to_arrays()),
                                      "esff", 4, device="cpu")
    np.testing.assert_allclose(pt["response"], jx["response"], rtol=1e-9,
                               atol=1e-9)
    assert pt["mean_response"] == pytest.approx(jx["mean_response"],
                                                rel=1e-9)


def test_histogram_helpers_match_jax():
    import jax.numpy as jnp

    from repro.core import jax_engine as J
    r = np.random.default_rng(4)
    hist = r.integers(0, 50, (3, E.HIST_BINS)).astype(np.int32)
    hist[1, -1] += 40              # a tail in the top bin
    n = hist.sum(1)
    rmax = np.array([3.0, 2e4, 0.5])
    np.testing.assert_array_equal(E.hist_edges(), J.hist_edges())
    for a, b in zip(E.hist_cdf(hist), J.hist_cdf(hist)):
        np.testing.assert_array_equal(a, b)
    for i in range(3):
        want = J.hist_quantile(jnp.asarray(hist[i]), 0.99, int(n[i]),
                               jnp.float64(rmax[i]))
        got = E.hist_quantile(torch.tensor(hist[i:i + 1]), 0.99,
                              int(n[i]), torch.tensor(rmax[i:i + 1]))
        assert float(got[0]) == float(want)
    resp = np.concatenate([10.0 ** np.arange(-5, 5),
                           r.lognormal(0, 3, 1000)])
    np.testing.assert_array_equal(E.hist_bin(torch.tensor(resp)).numpy(),
                                  np.asarray(J.hist_bin(jnp.asarray(resp))))
