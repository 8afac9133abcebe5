"""The event-loop kernel's wrapper (`repro_torch.kernels.event_loop`) on
the CPU: the routing of `engine.simulate`, the wrapper's checks, its
build flags and layout plan, and its plain version against the JAX
engine on traces with ties and on a batch of mixed lanes (counters and
the histogram exact, f64 results within rtol 1e-9, the bar of
tests/test_jax_engine.py). The kernel itself against the eager loop,
bitwise, needs a card: tests/test_torch_cuda.py."""
import re

import numpy as np
import pytest
import torch

from repro.core.jax_engine import simulate_policy_jax
from repro.traces import synth_azure_arrays
from repro_torch.core import engine as E
from repro_torch.core.policies import KERNELS, ESFFKernel
from repro_torch.kernels import _build
from repro_torch.kernels import event_loop as K0
from torch_event_traces import overflow_trace, tie_trace

COLS = ("fn_id", "arrival", "exec_time", "cold_start", "evict")
F64_KEYS = ("resp_sum", "slow_sum", "max_response", "cold_time",
            "evict_time")
INT_KEYS = ("cold_starts", "evictions", "overflow", "stalled", "done",
            "n_events", "resp_hist")


def _args(traces, lanes, C):
    """simulate()'s positional inputs, (trace, capacity, beta) a lane."""
    f64 = torch.float64
    t = {k: torch.tensor(np.stack([a[k] for a in traces]),
                         dtype=torch.int64 if k == "fn_id" else f64)
         for k in COLS}
    return (t["fn_id"], t["arrival"], t["exec_time"], t["cold_start"],
            t["evict"], torch.tensor([x[0] for x in lanes]),
            torch.tensor(np.stack([np.arange(C) < x[1] for x in lanes])),
            torch.tensor([x[2] for x in lanes], dtype=f64), 0.1)


def _counts():
    return K0.event_loop.plain_calls, K0.event_loop.launches


def test_cpu_run_goes_through_the_plain_loop():
    a = tie_trace()
    before = _counts()
    out = E.simulate(*_args([a], [(0, 3, 1.0)], 3), kernel=KERNELS["esff"],
                     n_fns=6, capacity=3, queue_cap=512)
    assert _counts() == (before[0] + 1, before[1])
    assert int(out["done"][0]) == 400


def test_other_policy_kernels_keep_the_eager_loop():
    """A subclass may override a hook: it has no device hooks, so it
    runs the eager loop (and gets ESFF's results here, hooks unchanged)."""
    class Mine(ESFFKernel):
        pass

    args = _args([tie_trace()], [(0, 3, 1.0)], 3)
    kw = dict(n_fns=6, capacity=3, queue_cap=512)
    assert K0.has_device_loop(KERNELS["esff"])
    assert K0.has_device_loop(ESFFKernel("esff-b2", default_beta=2.0))
    assert not K0.has_device_loop(Mine())
    before = _counts()
    mine = E.simulate(*args, kernel=Mine(), **kw)
    assert _counts() == before
    ref = E.simulate(*args, kernel=KERNELS["esff"], **kw)
    for k, v in ref.items():
        assert torch.equal(mine[k], v), k
    with pytest.raises(ValueError, match="no device hooks"):
        K0.event_loop(*args, kernel=Mine(), **kw)


def _good():
    return list(_args([tie_trace(40, 3)], [(0, 2, 1.0), (0, 3, 1.0)], 3))


@pytest.mark.parametrize("pos,bad,exc", [
    (1, lambda x: x.to(torch.float32), TypeError),        # dtype
    (0, lambda x: x.to(torch.int32), TypeError),
    (6, lambda x: x.to(torch.uint8), TypeError),
    (6, lambda x: torch.ones(2, 4, dtype=torch.bool), ValueError),  # shape
    (3, lambda x: x[:, :2].contiguous(), ValueError),
    (7, lambda x: torch.ones(3, dtype=torch.float64), ValueError),
    (2, lambda x: x.to("meta"), ValueError),              # device
    (6, lambda x: x.t().contiguous().t(), ValueError),    # layout
])
def test_wrapper_rejects_what_the_kernel_does_not_take(pos, bad, exc):
    args = _good()
    args[pos] = bad(args[pos])
    before = _counts()
    with pytest.raises(exc):
        K0.event_loop(*args, kernel=KERNELS["esff"], n_fns=3, capacity=3,
                      queue_cap=512)
    assert _counts() == before


def test_build_flags_and_sources():
    assert "event_loop" in _build.SOURCES
    assert "--fmad=false" in _build.nvcc_flags("event_loop")
    assert _build.EXTRA_FLAGS["event_loop"] == ("--fmad=false",)


@pytest.mark.parametrize("F,C,shared", [(200, 32, True), (200, 48, True),
                                        (2000, 16, True), (4400, 32, True),
                                        (5000, 8, False),
                                        (5000, 48, False)])
def test_layout_plan(F, C, shared):
    plan = K0.layout_plan(F, C)
    assert plan["fn_in_shared"] is shared
    if shared:
        assert plan["smem_bytes"] == K0.SLOT_BYTES * C + K0.FN_BYTES * F
        assert plan["smem_bytes"] <= K0.SHARED_MAX
        assert plan["scratch_bytes"] == 0
    else:
        assert plan["smem_bytes"] == K0.SLOT_BYTES * C
        assert plan["scratch_bytes"] >= K0.FN_BYTES * F
        assert plan["scratch_bytes"] % 16 == 0
    assert K0.layout_plan(200, 32)["smem_bytes"] == 11680
    # F = 2,000 (a card test's case) needs the >48 KB opt-in
    assert K0.layout_plan(2000, 16)["smem_bytes"] > 48 * 1024


def _c_source():
    return (_build.CSRC / "event_loop.cu").read_text()


def test_layout_is_the_kernel_sources():
    """The wrapper's sizes and result columns against the kernel's
    source (the card checks the built library: test_torch_cuda.py)."""
    src = _c_source()
    for name, v in (("kSlotBytes", K0.SLOT_BYTES),
                    ("kFnBytes", K0.FN_BYTES)):
        assert re.search(rf"constexpr int {name} = {v};", src), name
    enums = re.findall(r"enum \{([^}]*)\}", src)
    ctr, sums = ([w.strip() for w in e.split(",")] for e in enums[:2])
    assert ctr == [f"C_{k.upper()}" for k in K0.COUNTERS] + ["N_CTR"]
    assert sums == ["S_GSUM", "S_COLD_T", "S_EVICT_T", "S_RSUM", "S_SSUM",
                    "S_RMAX", "N_SUM"]
    assert len(sums) == len(K0.SUMS) + 1
    assert K0.LAYOUT[:3] == (K0.SLOT_BYTES, K0.FN_BYTES, E.HIST_BINS)


def _jax_lane(a, F, C, beta, queue_cap):
    out = simulate_policy_jax(*(a[k] for k in COLS), policy="esff",
                              n_fns=F, capacity=C, queue_cap=queue_cap,
                              beta=beta)
    return {k: np.asarray(v) for k, v in out.items()}


def _assert_lane_matches_jax(pt, li, jx):
    for k in INT_KEYS:
        np.testing.assert_array_equal(pt[k][li].numpy(), jx[k], err_msg=k)
    for k in F64_KEYS + ("completion", "start"):
        np.testing.assert_allclose(pt[k][li].numpy(), jx[k], rtol=1e-9,
                                   atol=1e-9, err_msg=k)


@pytest.mark.parametrize("C", [1, 2, 3, 4])
def test_plain_version_matches_jax_on_ties(C):
    a = tie_trace()
    pt = K0.event_loop(*_args([a], [(0, C, 1.0)], C),
                       kernel=KERNELS["esff"], n_fns=6, capacity=C,
                       queue_cap=512)
    _assert_lane_matches_jax(pt, 0, _jax_lane(a, 6, C, 1.0, 512))


def test_plain_version_matches_jax_on_mixed_lanes():
    """Two traces x capacity masks x betas in one lane batch, each lane
    against its own JAX run."""
    traces = [synth_azure_arrays(n_functions=20, n_requests=300,
                                 utilization=0.2, seed=s) for s in (1, 6)]
    lanes = [(ti, c, b) for ti in (0, 1) for c in (4, 8) for b in (1.0, 2.0)]
    pt = K0.event_loop(*_args(traces, lanes, 8), kernel=KERNELS["esff"],
                       n_fns=20, capacity=8, queue_cap=512)
    for li, (ti, c, b) in enumerate(lanes):
        _assert_lane_matches_jax(pt, li, _jax_lane(traces[ti], 20, c, b,
                                                   512))


def test_plain_version_matches_jax_on_overflow():
    a = overflow_trace()
    pt = K0.event_loop(*_args([a], [(0, 1, 1.0)], 1),
                       kernel=KERNELS["esff"], n_fns=1, capacity=1,
                       queue_cap=2)
    assert int(pt["overflow"][0]) > 0 and int(pt["stalled"][0]) == 1
    _assert_lane_matches_jax(pt, 0, _jax_lane(a, 1, 1, 1.0, 2))
