"""The port's six policies (`repro_torch.core.policies`) against the JAX
engine's (`repro.core.jax_policies`) on the same numpy arrays: counters
and the response histogram exact, per-request completions and the f64
sums within rtol = atol = 1e-9 (the bar of tests/test_jax_engine.py;
bitwise is expected), plus the timer rail's quirks, FaasCache's
GREEDY-DUAL order, a central-queue overflow, ESFF-H's cold-aware FRP
scan, the trace views of Fig. 6 and a Fig. 6-shaped experiment. On the
CPU every policy runs the eager loop, the plain version of the
event-loop kernel's variants (tests/test_torch_cuda.py holds the
kernel to it on a card)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
import repro_torch.api as tapi
from repro.core.jax_engine import simulate_policy_jax
from repro.core.jax_policies import KERNELS as JAX_KERNELS
from repro.traces import synth_azure_arrays
from repro_torch.core import engine as E
from repro_torch.core.policies import (KERNELS, FaasCacheKernel,
                                       OpenWhiskV2Kernel)
from repro_torch.kernels import frp_select as fs
from torch_event_traces import overflow_trace, tie_trace


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
INT_KEYS = ("cold_starts", "evictions", "overflow", "stalled", "done",
            "n_events", "resp_hist")
F64_KEYS = ("resp_sum", "slow_sum", "max_response", "cold_time",
            "evict_time")


def _trace(F, n, seed):
    return synth_azure_arrays(n_functions=F, n_requests=n,
                              utilization=0.2, seed=seed)


def _jax(a, policy, F, C, **kw):
    out = simulate_policy_jax(*(a[k] for k in COLS), policy=policy,
                              n_fns=F, capacity=C, **kw)
    return {k: np.asarray(v) for k, v in out.items()}


def _port(a, policy, F, C, kernel=None, **kw):
    if kernel is not None:
        kw["beta"] = kw.get("beta", kernel.default_beta)
        tapi.register_policy("probe", kernel, replace=True)
        policy = "probe"
    try:
        out = E.simulate_policy(*(a[k] for k in COLS), policy=policy,
                                n_fns=F, capacity=C, device="cpu", **kw)
    finally:
        if kernel is not None:
            tapi.unregister_policy("probe")
    return {k: v.numpy() for k, v in out.items()}


def _assert_matches(pt, jx):
    for k in INT_KEYS:
        np.testing.assert_array_equal(pt[k], jx[k], err_msg=k)
    for k in F64_KEYS + ("completion", "start"):
        np.testing.assert_allclose(pt[k], jx[k], rtol=1e-9, atol=1e-9,
                                   err_msg=k)


@pytest.mark.parametrize("F,seed,capacity,n", [
    (20, 5, 8, 400), (20, 1, 4, 300), (200, 2, 16, 1000)])
@pytest.mark.parametrize("policy", POLICIES)
def test_policy_matches_jax_engine(policy, F, seed, capacity, n):
    a = _trace(F, n, seed)
    jx = _jax(a, policy, F, capacity)
    pt = _port(a, policy, F, capacity)
    assert int(pt["overflow"]) == 0 and int(pt["stalled"]) == 0
    assert int(pt["done"]) == n
    _assert_matches(pt, jx)


@pytest.mark.parametrize("policy", POLICIES)
def test_mixed_lane_batch_equals_single_lanes(policy):
    """Two traces x two capacities as three lanes of one batch, each
    lane bitwise its own single-lane run."""
    traces = [_trace(20, 300, s) for s in (1, 6)]
    lanes = [(0, 4), (1, 4), (1, 8)]
    f64 = torch.float64
    t = {k: torch.tensor(np.stack([a[k] for a in traces]),
                         dtype=torch.int64 if k == "fn_id" else f64)
         for k in COLS}
    kernel = KERNELS[policy]
    beta = torch.full((3,), kernel.default_beta, dtype=f64)
    masks = torch.tensor(np.stack([np.arange(8) < c for _, c in lanes]))
    batch = E.simulate(t["fn_id"], t["arrival"], t["exec_time"],
                       t["cold_start"], t["evict"],
                       torch.tensor([ti for ti, _ in lanes]), masks, beta,
                       0.1, kernel=kernel, n_fns=20, capacity=8,
                       queue_cap=512)
    for li, (ti, c) in enumerate(lanes):
        one = _port(traces[ti], policy, 20, c)
        for k, v in one.items():
            np.testing.assert_array_equal(batch[k][li].numpy(), v,
                                          err_msg=f"lane {li}: {k}")


def test_esff_h_default_beta_matches_python_class():
    from repro_torch.core.esff_h import ESFFH
    assert KERNELS["esff_h"].default_beta == ESFFH.beta == 2.0
    for name, k in JAX_KERNELS.items():
        assert KERNELS[name].default_beta == k.default_beta, name


class _GreedyDualProbe(FaasCacheKernel):
    """FaasCache with a count of scale-ups whose eviction meets a tie of
    the lowest priority (a subclass: it runs the eager loop, with the
    built-in's hooks)."""

    def __init__(self):
        super().__init__("probe")
        self.ties = 0

    def _scale_up(self, ctx, s, j, t, on):
        empty = ((s["slot_fn"] < 0) & ctx.cap_mask).any(1)
        idle = ((s["slot_state"] == E.IDLE) & (s["slot_fn"] >= 0)
                & ctx.cap_mask)
        p = torch.where(idle, s["slot_prio"], E.BIG)
        low = idle & (p == p.min(1, keepdim=True).values)
        self.ties += int((on & ~empty & (low.sum(1) > 1)).sum())
        super()._scale_up(ctx, s, j, t, on)


def test_faascache_tie_and_eviction_order():
    """Three slots, five functions of equal cold start: function 0 is
    used most, so GREEDY-DUAL keeps it where LRU would evict it;
    instances used alike tie on priority, and the earliest-created goes
    first; each eviction raises the clock."""
    F, C = 5, 3
    fn = np.array([0, 0, 1, 2, 3, 4, 1, 2, 0, 3, 4, 0] * 4, np.int64)
    n = len(fn)
    a = dict(fn_id=fn, arrival=0.25 * np.arange(n),
             exec_time=np.full(n, 0.125),
             cold_start=np.full(F, 0.5), evict=np.full(F, 0.25))
    jx = _jax(a, "faascache", F, C)
    probe = _GreedyDualProbe()
    pt = _port(a, "faascache", F, C, kernel=probe)
    _assert_matches(pt, jx)
    assert int(pt["evictions"]) > 10 and int(pt["done"]) == n
    assert probe.ties > 0
    # LRU keep-alive (OpenWhisk) evicts in another order on this trace
    ow = _port(a, "openwhisk", F, C)
    assert not np.array_equal(ow["start"], pt["start"])


class _TimerProbe(OpenWhiskV2Kernel):
    """OpenWhisk-v2 with counts of the timer rail's quirks (a subclass:
    it runs the eager loop, with the built-in's hooks)."""

    def __init__(self):
        super().__init__("probe")
        self.n = dict(noop=0, rearm=0, tie=0, behind_busy=0)

    def on_cold_done(self, ctx, s, slot, t, on):
        # the first hook of every step: the timers are still pending, t
        # is the event's time; an original and a re-arm at that time
        at = (t < E.BIG)[:, None] & (s["tmr_next"] == t[:, None])
        re = (s["rearm_t"] == t[:, None])
        self.n["tie"] += int((at.any(1) & re.any(1)).sum())
        super().on_cold_done(ctx, s, slot, t, on)

    def on_arrival(self, ctx, s, rid, t, on):
        j = ctx.fn_at(rid)
        has_own, _ = E.pick_idle_own(ctx, s, j)
        direct = on & has_own & (ctx.row(s["q_len"], j, ctx.F) == 0)
        busy = (ctx.row(s["tmr_pos"], j, ctx.F)
                != ctx.row(s["arr_cnt"], j, ctx.F) - 1)
        self.n["behind_busy"] += int((direct & busy).sum())
        super().on_arrival(ctx, s, rid, t, on)

    def on_timer(self, ctx, s, rid, t, on):
        j = ctx.fn_at(rid)
        head = ((ctx.row(s["q_len"], j, ctx.F) > 0)
                & (E.q_head(ctx, s, j) == rid))
        self.n["noop"] += int((on & ~head).sum())
        before = s["rearm_t"].clone()
        super().on_timer(ctx, s, rid, t, on)
        self.n["rearm"] += int((on & (s["rearm_t"] != before).any(1)).sum())


def _busy_rail_trace():
    """One function, one slot, threshold 1/4 s: request 1 queues behind
    request 0 and is served before its timer fires; request 2 then finds
    the instance idle and dispatches directly while request 1's timer is
    still pending (a busy rail), so request 2's timer later fires as a
    no-op (request 3 keeps the lane running past it)."""
    return dict(fn_id=np.zeros(4, np.int64),
                arrival=np.array([0.0, 1.125, 1.3125, 3.0]),
                exec_time=np.array([0.5, 0.03125, 0.03125, 0.5]),
                cold_start=np.array([0.5]), evict=np.array([0.25]))


def _tie_timer_trace():
    """Arrivals in fours at multiples of 1/8 s (exact in binary): with a
    threshold of 1/4 s original timers tie, and re-arms fall on
    originals' times."""
    a = tie_trace(240, 6)
    a["arrival"] = np.repeat(0.125 * np.arange(60), 4)
    a["exec_time"] = 0.25 + 0.125 * (np.arange(240) * 7 % 6 % 3)
    return a


@pytest.mark.parametrize("case,C", [("ties", 1), ("ties", 2), ("ties", 3),
                                    ("busy_rail", 1)])
def test_openwhisk_v2_timer_quirks_match_jax(case, C):
    """The timer rail's quirks, each seen by a probe, with the counters,
    histogram and every request's start and completion the JAX
    engine's: timers of non-head requests fire as no-ops (among them a
    direct dispatch behind a busy rail), blocked heads re-arm, and an
    original timer and a re-arm fall at the same time."""
    a = _busy_rail_trace() if case == "busy_rail" else _tie_timer_trace()
    F = len(a["cold_start"])
    probe = _TimerProbe()
    jx = _jax(a, "openwhisk_v2", F, C, threshold=0.25)
    pt = _port(a, "openwhisk_v2", F, C, kernel=probe, threshold=0.25)
    _assert_matches(pt, jx)
    assert int(pt["done"]) == len(a["fn_id"])
    assert probe.n["noop"] > 0, probe.n
    if case == "busy_rail":
        assert probe.n["behind_busy"] == 1, probe.n
    else:
        assert probe.n["rearm"] > 0 and probe.n["tie"] > 0, probe.n
    # the built-in gives the probe's results (the probe only counts)
    np.testing.assert_array_equal(
        _port(a, "openwhisk_v2", F, C, threshold=0.25)["completion"],
        pt["completion"])


@pytest.mark.parametrize("policy", ["sff", "openwhisk", "faascache",
                                    "openwhisk_v2"])
def test_central_queue_overflow_counts_as_jax(policy):
    a = overflow_trace()
    jx = _jax(a, policy, 1, 1, queue_cap=2)
    pt = _port(a, policy, 1, 1, queue_cap=2)
    assert int(pt["overflow"]) > 0 and int(pt["stalled"]) == 1
    _assert_matches(pt, jx)


def test_frp_select_lanes_plain_cold_aware_matches_jax():
    """ESFF-H's FRP scan (Eq. 7 less the COLD slots, Eq. 10 with beta,
    first-index argmin; jax_policies.ESFFKernel.on_exec_done) in the
    JAX spelling against the plain version with ``coldK``."""
    r = np.random.default_rng(3)
    L, F = 5, 300
    means = r.uniform(0.001, 10, (L, F))
    t_cold = r.uniform(0.5, 1.5, (L, F))
    t_evict = r.uniform(0.5, 1.5, (L, F))
    nw = r.integers(0, 6, (L, F)).astype(np.int32)
    K = r.integers(1, 4, (L, F)).astype(np.int32)
    coldK = r.integers(0, K + 1).astype(np.int32)
    jc = r.integers(0, F, L)
    beta = r.uniform(1.0, 2.5, L)
    tv_j = t_evict[np.arange(L), jc]
    want_w, want_i = [], []
    for li in range(L):
        Kf = jnp.asarray(K[li]).astype(jnp.float64)
        n_e = (jnp.asarray(nw[li]).astype(jnp.float64) + 1.0
               - (t_cold[li] + t_evict[li, jc[li]]) * Kf / means[li])
        n_e = n_e - jnp.asarray(coldK[li]).astype(jnp.float64)
        w = (means[li] + beta[li] * (t_cold[li] + t_evict[li]) * (Kf + 1.0)
             / jnp.maximum(n_e, 1e-30))
        valid = (nw[li] > 0) & (n_e > 0) & (jnp.arange(F) != jc[li])
        w = jnp.where(valid, w, 1e30)
        best = int(jnp.argmin(w))
        want_w.append(float(w[best]))
        want_i.append(best if bool(valid.any()) else -1)
    f64, i32 = torch.float64, torch.int32
    got_w, got_i = fs.frp_select_lanes(
        *(torch.tensor(x, dtype=f64) for x in (means, t_cold, t_evict)),
        torch.tensor(nw), torch.tensor(K), torch.tensor(tv_j, dtype=f64),
        torch.tensor(jc, dtype=i32), torch.tensor(beta, dtype=f64),
        torch.tensor(coldK))
    assert got_i.tolist() == want_i
    np.testing.assert_array_equal(got_w.numpy(), np.array(want_w))
    # the term moves the choice: without it another function wins a lane
    plain_w, plain_i = fs.frp_select_lanes_plain(
        *(torch.tensor(x, dtype=f64) for x in (means, t_cold, t_evict)),
        torch.tensor(nw), torch.tensor(K), torch.tensor(tv_j, dtype=f64),
        torch.tensor(jc, dtype=i32), torch.tensor(beta, dtype=f64))
    assert not torch.equal(plain_w, got_w)


@pytest.mark.parametrize("view", ["head", "scaled", "scaled_head"])
def test_trace_views_bitwise_jax(view):
    kw = dict(n_functions=30, n_requests=500, seed=4, utilization=0.3)
    srcs = [japi.SyntheticTrace.make(**kw), tapi.SyntheticTrace.make(**kw)]
    if view == "head":
        srcs = [s.head(321) for s in srcs]
    elif view == "scaled":
        srcs = [s.scaled(1.2) for s in srcs]
    else:
        srcs = [s.scaled(0.6).head(200) for s in srcs]
    j, t = srcs
    assert t.label == j.label
    assert type(t).__name__ == type(j).__name__
    ja, ta = j.arrays(), t.arrays()
    assert sorted(ta) == sorted(ja)
    for k in ja:
        assert ta[k].dtype == ja[k].dtype, k
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    reseeded = t.with_seed(9)
    assert reseeded.label == j.with_seed(9).label


def test_fig6_shaped_experiment_matches_jax():
    """Five intensity ratios of one trace x the six policies at one
    capacity (the shape of benchmarks/fig6_intensity.py, at N = 250)."""
    ratios = (0.6, 0.8, 1.0, 1.2, 1.4)
    kw = dict(n_functions=20, n_requests=250, seed=0, utilization=0.25)
    fields = dict(policies=POLICIES, capacities=(6,), queue_cap=512)
    j = japi.run_experiment(japi.ExperimentSpec(
        traces=[japi.SyntheticTrace.make(**kw).scaled(r) for r in ratios],
        **fields)).check()
    t = tapi.run_experiment(tapi.ExperimentSpec(
        traces=[tapi.SyntheticTrace.make(**kw).scaled(r) for r in ratios],
        **fields), device="cpu").check()
    assert t.coords == j.coords
    for k in j.metrics:
        a, b = t[k], j[k]
        assert a.shape == b.shape, k
        if b.dtype.kind in "iub":
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=0, err_msg=k)
