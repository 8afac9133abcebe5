"""The event-loop kernel's wrapper (`repro_torch.kernels.event_loop`) on
the CPU: the routing of `engine.simulate`, the wrapper's checks, its
build flags and layout plan (the K-node variant's wrapper, `cluster_loop`,
too), and its plain version against the JAX
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
from repro_torch.core.policies import (KERNELS, CentralQueueKernel,
                                       ESFFKernel, FaasCacheKernel,
                                       OpenWhiskV2Kernel)
from repro_torch.kernels import _build
from repro_torch.kernels import event_loop as K0
from torch_event_traces import overflow_trace, tie_trace


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The eager loop's ops are tiny: one intra-op thread a test process
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


# one policy a built-in class: (class, constructor keywords)
BUILT_IN = {"esff": (ESFFKernel, {}),
            "sff": (CentralQueueKernel, dict(name="sff", order="sff")),
            "faascache": (FaasCacheKernel, {}),
            "openwhisk_v2": (OpenWhiskV2Kernel, {})}


@pytest.mark.parametrize("policy", sorted(BUILT_IN))
def test_other_policy_kernels_keep_the_eager_loop(policy):
    """A subclass of a built-in policy class may override a hook: it has
    no device hooks, so it runs the eager loop (and gets the built-in's
    results here, hooks unchanged), while the built-in has device hooks."""
    cls, ckw = BUILT_IN[policy]

    class Mine(cls):
        pass

    args = _args([tie_trace()], [(0, 3, 1.0)], 3)
    kw = dict(n_fns=6, capacity=3, queue_cap=512)
    assert K0.has_device_loop(KERNELS[policy])
    assert K0.has_device_loop(cls(**ckw))
    assert not K0.has_device_loop(Mine(**ckw))
    before = _counts()
    mine = E.simulate(*args, kernel=Mine(**ckw), **kw)
    assert _counts() == before
    ref = E.simulate(*args, kernel=KERNELS[policy], **kw)
    assert _counts() == (before[0] + 1, before[1])
    for k, v in ref.items():
        assert torch.equal(mine[k], v), k
    with pytest.raises(ValueError, match="no device hooks"):
        K0.event_loop(*args, kernel=Mine(**ckw), **kw)


def test_every_built_in_policy_has_a_variant():
    got = {name: K0.variant_of(k) for name, k in KERNELS.items()}
    assert got == {"esff": "esff", "esff_h": "esff_h", "sff": "sff",
                   "openwhisk": "fifo", "faascache": "faascache",
                   "openwhisk_v2": "openwhisk_v2"}
    assert K0.variant_of(ESFFKernel("x", lru_victim=True)) == "esff_lru"
    assert K0.variant_of(ESFFKernel("x", cold_aware=True)) == "esff_cold"
    assert sorted(v["code"] for v in K0.VARIANTS.values()) == list(range(8))


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


@pytest.mark.parametrize("variant", sorted(K0.VARIANTS))
@pytest.mark.parametrize("F,C", [(200, 32), (200, 48), (2000, 16),
                                 (4400, 32), (2600, 7), (5000, 8),
                                 (5000, 48)])
def test_layout_plan(F, C, variant):
    v = K0.VARIANTS[variant]
    plan = K0.layout_plan(F, C, variant)
    # the slots' bytes, rounded up to 8 for the f64 arrays after them
    slots = -(-v["slot_bytes"] * C // 8) * 8
    assert slots % 8 == 0 and 0 <= slots - v["slot_bytes"] * C < 8
    shared = slots + v["fn_bytes"] * F <= K0.SHARED_MAX
    assert plan["fn_in_shared"] is shared
    if shared:
        assert plan["smem_bytes"] == slots + v["fn_bytes"] * F
        assert plan["scratch_bytes"] == 0
    else:
        assert plan["smem_bytes"] == slots
        assert plan["scratch_bytes"] >= v["fn_bytes"] * F
        assert plan["scratch_bytes"] % 16 == 0
    assert plan["smem_bytes"] <= K0.SHARED_MAX


def test_layout_plan_fixed_points():
    # ESFF's plan: 40 B a slot, 52 B a function
    assert K0.layout_plan(200, 32)["smem_bytes"] == 11680
    assert K0.layout_plan(4400, 32)["fn_in_shared"]
    assert not K0.layout_plan(5000, 8)["fn_in_shared"]
    # F = 2,000 (a card test's case) needs the >48 KB opt-in
    assert K0.layout_plan(2000, 16)["smem_bytes"] > 48 * 1024
    # FaasCache's 52 B slots at an odd C: padded to 8
    assert K0.layout_plan(10, 7, "faascache")["smem_bytes"] == 368 + 520
    # OpenWhisk-v2's timer rail moves F = 2,800 to global scratch
    assert not K0.layout_plan(2800, 16, "openwhisk_v2")["fn_in_shared"]
    assert K0.layout_plan(2800, 16, "esff")["fn_in_shared"]


def _c_source():
    return (_build.CSRC / "event_loop.cu").read_text()


def test_layout_is_the_kernel_sources():
    """Every variant's code and sizes and the result columns against the
    kernel's source, whose static_asserts hold each variant's bytes (the
    card checks the built library: test_torch_cuda.py)."""
    src = _c_source()
    codes = {alias: int(code)
             for code, alias in re.findall(r"X\((\d+), (\w+)\)", src)}
    # static_assert(<alias>::slot_bytes == S && <alias>::fn_bytes == B,
    #               "<variant>")
    asserts = re.findall(r"static_assert\((\w+)::slot_bytes == (\d+) &&"
                         r"\s+\1::fn_bytes == (\d+),\s+\"(\w+)\"\)", src)
    names = {name: alias for alias, _, _, name in asserts}
    sizes = {alias: (int(a), int(b)) for alias, a, b, _ in asserts}
    assert sorted(names) == sorted(K0.VARIANTS)
    for variant, v in K0.VARIANTS.items():
        alias = names[variant]
        assert codes[alias] == v["code"], variant
        assert sizes[alias] == (v["slot_bytes"], v["fn_bytes"]), variant
        assert K0.layout(variant)[:3] == (v["slot_bytes"], v["fn_bytes"],
                                          E.HIST_BINS)
    enums = re.findall(r"enum \{([^}]*)\}", src)
    ctr, sums, pcs = ([w.strip() for w in e.split(",")] for e in enums[:3])
    assert ctr == [f"C_{k.upper()}" for k in K0.COUNTERS] + ["N_CTR"]
    assert sums == ["S_GSUM", "S_COLD_T", "S_EVICT_T", "S_RSUM", "S_SSUM",
                    "S_RMAX", "N_SUM"]
    assert len(sums) == len(K0.SUMS) + 1
    assert pcs == ["P_FRP", "P_HEAD", "P_TIMER", "N_PC"]
    assert len(pcs) == len(K0.POLICY_COUNTS) + 1


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


def test_cluster_layout_plan_and_sizes():
    """The K-node variant's plan: fig_cluster's widest lanes (K = 32 nodes
    of F = 200 functions) put the per-(node, function) state in global
    scratch, a small cluster keeps it in shared memory; its sizes are the
    kernel source's static_assert."""
    big = K0.cluster_layout_plan(200, 32, 32, "esff")
    assert not big["fn_in_shared"]
    assert big["scratch_bytes"] == -(-(16 * 200 + 36 * 32 * 200) // 16) * 16
    assert big["smem_bytes"] == 40 * 32 + 88 * 32
    assert K0.cluster_layout_plan(200, 32, 4, "esff")["fn_in_shared"]
    with pytest.raises(ValueError, match="shared memory"):
        K0.cluster_layout_plan(200, 10 ** 5, 64, "esff")
    m = re.search(r"static_assert\(EsffP::node_fn_bytes == (\d+) && "
                  r"EsffHP::node_fn_bytes == (\d+) &&\s+FaasP::node_fn_bytes"
                  r" == (\d+) && Owv2P::node_fn_bytes == (\d+),", _c_source())
    assert [int(x) for x in m.groups()] == [K0.CLUSTER_FN_BYTES[v] for v in (
        "esff", "esff_h", "faascache", "openwhisk_v2")]


@pytest.mark.parametrize("case", ["mask_2d", "n_nodes", "router_ix",
                                  "delay", "jsq_d"])
def test_cluster_wrapper_rejects_what_the_kernel_does_not_take(case):
    from repro_torch.cluster.routers import JSQRouter, get_router
    a = tie_trace(n=40)
    t = [torch.tensor(a[k])[None] for k in COLS]
    L, K, C = 2, 3, 2
    kw = dict(kernel=KERNELS["esff"], routers=(get_router("jsq2"),),
              router_ix=torch.zeros(L, dtype=torch.int64),
              n_nodes=torch.full((L,), K), seeds=torch.zeros(L, dtype=torch.int64),
              delays=torch.zeros((L, K), dtype=torch.float64), n_fns=6,
              capacity=C, queue_cap=64)
    mask = torch.ones((L, K, C), dtype=torch.bool)
    if case == "mask_2d":
        mask = mask[:, 0]
    elif case == "n_nodes":
        kw["n_nodes"] = torch.tensor([3, 4])
    elif case == "router_ix":
        kw["router_ix"] = torch.tensor([0, 1])
    elif case == "delay":
        kw["delays"] = torch.tensor([[0.0, -0.1, 0.0], [0.0, 0.0, 0.0]],
                                    dtype=torch.float64)
    else:
        kw["routers"] = (JSQRouter("jsq9", d=9),)
    with pytest.raises(ValueError):
        K0.cluster_loop(*t, torch.zeros(L, dtype=torch.int64), mask,
                        torch.ones(L, dtype=torch.float64), 0.1, **kw)
