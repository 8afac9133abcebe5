"""Card-only checks of the port: each CUDA kernel against its plain
PyTorch version (the event-loop kernel and its K-node variant against
the eager loops, bitwise; the backward kernels against their plain
backwards, bitwise repeatable),
and the engine, the chunked SSD and the models (dense, moe, ssm, hybrid)
on the card against themselves on the CPU. Every test skips without a
CUDA device (a CUDA kernel has no CPU mode). The file imports no JAX,
so it runs on a machine without it (``--noconftest`` skips
tests/conftest.py, which imports JAX):

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core import engine as E
from repro_torch.core.policies import KERNELS, ESFFKernel
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import event_loop as K0
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import frp_select as fs
from repro_torch.kernels import rmsnorm as RN
from repro_torch.kernels import ssd_chunk as K5
from repro_torch.models import build_model
from repro_torch.traces import synth_azure_arrays
from torch_event_traces import overflow_trace, tie_trace

COLS = ("fn_id", "arrival", "exec_time", "cold_start", "evict")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _rows(shape, seed):
    r = np.random.default_rng(seed)
    return (r.uniform(0.001, 10, shape), r.uniform(0.5, 1.5, shape),
            r.uniform(0.5, 1.5, shape), r.integers(0, 5, shape),
            r.integers(0, 3, shape))


@pytest.mark.cuda
@pytest.mark.parametrize("F,seed", [(200, 0), (5000, 3), (65536, 5)])
def test_frp_select_kernel_matches_plain(cuda, F, seed):
    te, tl, tv, nw, K = _rows(F, seed)
    t = [torch.tensor(x, dtype=torch.float32, device=cuda)
         for x in (te, tl, tv)]
    t += [torch.tensor(x, dtype=torch.int32, device=cuda) for x in (nw, K)]
    launches = fs.frp_select.launches
    kw, ki = fs.frp_select(*t, 1.0, 3)
    pw, pi = fs.frp_select_plain(*t, 1.0, 3)
    torch.cuda.synchronize()
    assert fs.frp_select.launches == launches + 1
    assert int(ki) == int(pi)
    np.testing.assert_allclose(float(kw), float(pw), rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("L,F", [(7, 200), (3, 1000)])
def test_frp_select_lanes_kernel_bitwise_plain(cuda, L, F):
    te, tl, tv, nw, K = _rows((L, F), L + F)
    f64, i32 = torch.float64, torch.int32
    jc = torch.arange(L, device=cuda) * 7 % F
    args = [torch.tensor(x, dtype=f64, device=cuda) for x in (te, tl, tv)]
    args += [torch.tensor(x, dtype=i32, device=cuda) for x in (nw, K)]
    args += [args[2][torch.arange(L, device=cuda), jc].contiguous(),
             jc.to(i32), torch.linspace(0.5, 2.0, L, dtype=f64,
                                        device=cuda)]
    kw, ki = fs.frp_select_lanes(*args)
    pw, pi = fs.frp_select_lanes_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(ki, pi)
    assert torch.equal(kw, pw)


@pytest.mark.cuda
def test_engine_on_card_matches_cpu(cuda):
    a = synth_azure_arrays(n_functions=200, n_requests=1000,
                           utilization=0.2, seed=2)
    run = lambda dev: E.simulate_policy(  # noqa: E731
        *(a[k] for k in COLS), n_fns=200, capacity=16, device=dev)
    launches = (K0.event_loop.launches, fs.frp_select_lanes.launches)
    card = run(cuda)
    assert K0.event_loop.launches == launches[0] + 1
    assert fs.frp_select_lanes.launches == launches[1]   # K1 is inline
    cpu = run("cpu")
    for k, v in cpu.items():
        assert torch.equal(card[k].cpu(), v), k


# ------------------------------------------------ the event-loop kernel
def _azure(F, n, seed):
    return synth_azure_arrays(n_functions=F, n_requests=n, utilization=0.2,
                              seed=seed)


# the built-in ESFF class with one flag of ESFF-H each
POLICIES = dict(KERNELS, esff_lru=ESFFKernel("esff_lru", lru_victim=True),
                esff_cold=ESFFKernel("esff_cold", cold_aware=True))

# name: (traces, F, capacities, betas, queue_cap, stream, policy)
EVENT_LOOP_CASES = {
    "stream": ([_azure(200, 1000, 2)], 200, (16,), (1.0,), 512, True,
               "esff"),
    "exact": ([_azure(200, 1000, 2)], 200, (16,), (1.0,), 512, False,
              "esff"),
    "overflow": ([overflow_trace()], 1, (1,), (1.0,), 2, False, "esff"),
    "global_layout": ([_azure(5000, 600, 4)], 5000, (8,), (1.0,), 512,
                      True, "esff"),
    # the function state in shared memory above 48 KB (~104 KB)
    "shared_over_48k": ([_azure(2000, 800, 7)], 2000, (16,), (1.0,), 512,
                        True, "esff"),
    "c48": ([_azure(50, 800, 5)], 50, (48,), (1.0,), 512, False, "esff"),
    "mixed_lanes": ([_azure(20, 300, 1), _azure(20, 300, 6)], 20,
                    (4, 6, 8), (1.0, 2.0), 512, True, "esff"),
    "ties": ([tie_trace()], 6, (2, 3, 4), (1.0,), 512, False, "esff"),
    # the other variants
    "esff_h": ([_azure(200, 1000, 2), _azure(200, 1000, 3)], 200,
               (4, 8, 16), (1.0, 2.0), 512, False, "esff_h"),
    "esff_h_ties": ([tie_trace()], 6, (2, 3, 4), (2.0,), 512, False,
                    "esff_h"),
    "esff_lru": ([_azure(50, 800, 5)], 50, (4, 8), (1.0,), 512, True,
                 "esff_lru"),
    "esff_cold": ([_azure(50, 800, 5)], 50, (4, 8), (1.0,), 512, True,
                  "esff_cold"),
    "sff": ([_azure(200, 1000, 2)], 200, (4, 8, 16), (1.0,), 512, False,
            "sff"),
    "openwhisk": ([_azure(200, 1000, 2)], 200, (4, 8, 16), (1.0,), 512,
                  False, "openwhisk"),
    "central_ties": ([tie_trace()], 6, (2, 3, 4), (1.0,), 512, False,
                     "sff"),
    "central_overflow": ([overflow_trace()], 1, (1,), (1.0,), 2, False,
                         "openwhisk"),
    "faascache": ([_azure(50, 800, 5), _azure(50, 800, 6)], 50, (3, 8, 48),
                  (1.0,), 512, False, "faascache"),
    # FaasCache's 52 B slots at an odd C, and its functions above 48 KB
    "faascache_f2000": ([_azure(2000, 800, 7)], 2000, (7, 16), (1.0,), 512,
                        True, "faascache"),
    "faascache_global": ([_azure(5000, 600, 4)], 5000, (8,), (1.0,), 512,
                         True, "faascache"),
    "openwhisk_v2": ([_azure(200, 1000, 2), _azure(200, 1000, 3)], 200,
                     (8, 16), (1.0,), 512, False, "openwhisk_v2"),
    # arrivals in fours at one time: original timers tie, and re-arms
    # fall on originals
    "openwhisk_v2_ties": ([tie_trace()], 6, (1, 2, 3, 4), (1.0,), 512,
                          False, "openwhisk_v2"),
    "openwhisk_v2_global": ([_azure(3000, 600, 4)], 3000, (16,), (1.0,),
                            512, True, "openwhisk_v2"),
    "openwhisk_v2_overflow": ([overflow_trace()], 1, (1,), (1.0,), 2,
                              False, "openwhisk_v2"),
}


def _event_loop_inputs(device, traces, caps, betas):
    """Every trace x capacity x beta as one lane batch on ``device``:
    `engine.simulate`'s operands, in the dtypes of `simulate_eager`."""
    f64 = torch.float64
    t = {k: torch.tensor(np.stack([a[k] for a in traces]), device=device)
         for k in COLS}
    lanes = [(ti, c, b) for ti in range(len(traces)) for c in caps
             for b in betas]
    C = max(caps)
    return (t["fn_id"].to(torch.int64), t["arrival"].to(f64),
            t["exec_time"].to(f64), t["cold_start"].to(f64),
            t["evict"].to(f64),
            torch.tensor([x[0] for x in lanes], device=device),
            torch.tensor(np.stack([np.arange(C) < x[1] for x in lanes]),
                         device=device),
            torch.tensor([x[2] for x in lanes], dtype=f64, device=device))


def _event_loop_run(device, traces, F, caps, betas, queue_cap, stream,
                    policy="esff"):
    """Every trace x capacity x beta as one lane batch on ``device``."""
    return E.simulate(*_event_loop_inputs(device, traces, caps, betas), 0.1,
                      kernel=POLICIES[policy], n_fns=F, capacity=max(caps),
                      queue_cap=queue_cap, stream=stream)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(EVENT_LOOP_CASES))
def test_event_loop_kernel_bitwise_eager(cuda, case):
    traces, F, caps, betas, queue_cap, stream, policy = \
        EVENT_LOOP_CASES[case]
    launches = K0.event_loop.launches
    card = _event_loop_run(cuda, traces, F, caps, betas, queue_cap, stream,
                           policy)
    torch.cuda.synchronize()
    assert K0.event_loop.launches == launches + 1
    counts = {k: getattr(K0.event_loop, k).cpu()
              for k in ("last_scans", "last_head_scans", "last_timers")}
    cpu = _event_loop_run("cpu", traces, F, caps, betas, queue_cap, stream,
                          policy)
    assert sorted(card) == sorted(cpu)
    for k, v in cpu.items():
        assert torch.equal(card[k].cpu(), v), (case, k)
    if "overflow" in case:
        assert int(cpu["overflow"][0]) > 0 and int(cpu["stalled"][0]) == 1
    variant = K0.variant_of(POLICIES[policy])
    plan = K0.layout_plan(F, max(caps), variant)
    if "global" in case:
        assert not plan["fn_in_shared"]
    if case in ("shared_over_48k", "faascache_f2000"):
        assert plan["fn_in_shared"] and plan["smem_bytes"] > 48 * 1024
    i64 = torch.int64
    zero = torch.zeros_like(counts["last_scans"])
    # one inline FRP scan per completion in the ESFF variants; the
    # timer events are the events that are neither a slot's nor an
    # arrival
    esff = variant.startswith("esff")
    assert torch.equal(counts["last_scans"],
                       cpu["done"].to(i64) if esff else zero)
    if variant in ("sff", "fifo", "faascache"):
        assert bool((counts["last_head_scans"] > 0).all())
    else:
        assert torch.equal(counts["last_head_scans"], zero)
    if variant == "openwhisk_v2" and "overflow" not in case:
        N = traces[0]["fn_id"].shape[0]
        timers = (cpu["n_events"] - cpu["done"] - cpu["cold_starts"]
                  - N).to(i64)
        assert torch.equal(counts["last_timers"], timers)
        assert bool((timers > 0).all())
    elif variant != "openwhisk_v2":
        assert torch.equal(counts["last_timers"], zero)


@pytest.mark.cuda
def test_event_loop_library_layout_is_the_wrappers(cuda):
    """The built library reports, for every variant, the slot and
    function sizes and the result columns the wrapper plans and reads
    by."""
    K0._CHECKED.clear()
    for variant in K0.VARIANTS:
        K0._check_layout(variant)
    assert K0._CHECKED == {(v, False, False) for v in K0.VARIANTS}


@pytest.mark.cuda
def test_eager_loop_on_card_matches_kernel(cuda):
    """The plain version itself on the card (every op a launch, K1 as
    its own kernel) gives the kernel's bits."""
    a = _azure(50, 300, 3)
    t = {k: torch.tensor(a[k], dtype=torch.int64 if k == "fn_id"
                         else torch.float64, device=cuda)[None]
         for k in COLS}
    args = (t["fn_id"], t["arrival"], t["exec_time"], t["cold_start"],
            t["evict"], torch.zeros(1, dtype=torch.int64, device=cuda),
            torch.ones(1, 8, dtype=torch.bool, device=cuda),
            torch.ones(1, dtype=torch.float64, device=cuda), 0.1)
    kw = dict(kernel=KERNELS["esff"], n_fns=50, capacity=8, queue_cap=512,
              stream=False)
    k1 = fs.frp_select_lanes.launches
    eager = E.simulate_eager(*args, **kw)
    assert fs.frp_select_lanes.launches > k1
    card = K0.event_loop(*args, **kw)
    for k, v in eager.items():
        assert torch.equal(card[k], v), k


# -------------------------------------- the engine options in every variant
def _static_rows(a, entries):
    """The static tier's packing of one trace: every node of every entry
    (a ClusterSpec) a padded row, with its slots and live length."""
    from repro_torch.cluster.static import build_node_streams
    rows, caps, n_live = [], [], []
    for e in entries:
        _, streams, nl, _ = build_node_streams(a, e)
        for k in range(e.n_nodes):
            rows.append(dict(a, **{c: streams[c][k] for c in
                                   ("fn_id", "arrival", "exec_time")}))
            caps.append(e.node_caps(0)[k])
            n_live.append(int(nl[k]))
    return rows, caps, n_live


def _option_case(case):
    """(traces, lane trace indices, capacities, F, n_live, deadlines,
    tl_bins, tl_bucket) of an option case."""
    from repro_torch.cluster import ClusterSpec
    if case == "n_live":            # ragged lanes, one of them empty
        return ([_azure(50, 400, 5)], [0] * 4, [8, 16, 8, 4], 50,
                [400, 211, 0, 57], None, 0, 60.0)
    if case == "timeline_deadlines":
        return ([_azure(200, 1000, 2), _azure(200, 1000, 3)],
                [0, 0, 1, 1], [8, 16, 8, 16], 200, None,
                np.linspace(0.2, 2.0, 200), 9, 30.0)
    a = _azure(50, 800, 6)          # the static tier's packing
    rows, caps, n_live = _static_rows(a, [
        ClusterSpec(n_nodes=1, router="hash", node_capacity=(8,)),
        ClusterSpec(n_nodes=4, router="hash", node_capacity=(2,) * 4),
        ClusterSpec(n_nodes=8, router="round_robin",
                    node_capacity=(1,) * 8)])
    return (rows, list(range(len(rows))), caps, 50, n_live,
            np.full(50, 0.5), 12, 20.0)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("case", ["n_live", "timeline_deadlines",
                                  "static_packing"])
def test_event_loop_kernel_options_bitwise_eager(cuda, case, policy):
    """Every variant with the engine options on, in one launch, bitwise
    the eager loop (its plain version) on the same inputs."""
    traces, tix, caps, F, n_live, dl, bins, bucket = _option_case(case)

    def run(device):
        t = {k: torch.tensor(np.stack([a[k] for a in traces]),
                             device=device) for k in COLS}
        C = max(caps)
        masks = torch.tensor(np.stack([np.arange(C) < c for c in caps]),
                             device=device)
        beta = torch.full((len(tix),), POLICIES[policy].default_beta,
                          dtype=torch.float64, device=device)
        return E.simulate(t["fn_id"], t["arrival"], t["exec_time"],
                          t["cold_start"], t["evict"],
                          torch.tensor(tix, device=device), masks, beta,
                          0.1, kernel=POLICIES[policy], n_fns=F,
                          capacity=C, queue_cap=4096, stream=True,
                          n_live=n_live, deadlines=dl, tl_bins=bins,
                          tl_bucket=bucket)

    launches = K0.event_loop.launches
    card = run(cuda)
    torch.cuda.synchronize()
    assert K0.event_loop.launches == launches + 1
    cpu = run("cpu")
    assert sorted(card) == sorted(cpu)
    for k, v in cpu.items():
        assert torch.equal(card[k].cpu(), v), (case, policy, k)
    if n_live is not None:
        assert cpu["done"].tolist() == list(n_live)
    assert not cpu["stalled"].any()


@pytest.mark.cuda
def test_eager_loop_on_card_matches_kernel_with_options(cuda):
    """The plain version on the card with every option on (the timeline
    bin a true division there too) gives the kernel's bits."""
    a = _azure(50, 300, 3)
    t = {k: torch.tensor(a[k], dtype=torch.int64 if k == "fn_id"
                         else torch.float64, device=cuda)[None]
         for k in COLS}
    args = (t["fn_id"], t["arrival"], t["exec_time"], t["cold_start"],
            t["evict"], torch.zeros(2, dtype=torch.int64, device=cuda),
            torch.ones(2, 8, dtype=torch.bool, device=cuda),
            torch.ones(2, dtype=torch.float64, device=cuda), 0.1)
    kw = dict(kernel=KERNELS["esff"], n_fns=50, capacity=8, queue_cap=512,
              stream=False, tl_bins=7, tl_bucket=7.0,
              n_live=torch.tensor([300, 123], device=cuda),
              deadlines=torch.linspace(0.1, 1.0, 50, dtype=torch.float64,
                                       device=cuda))
    eager = E.simulate_eager(*args, **kw)
    card = K0.event_loop(*args, **kw)
    assert sorted(card) == sorted(eager)
    for k, v in eager.items():
        assert torch.equal(card[k], v), k


# ---------------------------- the K-node variant (dynamic cluster tier)
DELAYS4 = (0.0, 0.013, 0.027, 0.041)
# ragged packed lanes: (K, node capacities, delays)
CLUSTER_LANES = ((1, (8,), None), (4, (2,) * 4, None), (4, (2,) * 4, DELAYS4),
                 (3, (3, 1, 2), None), (32, (1,) * 32, None))


def _cluster_run(device, a, F, lanes, routers, router_ix, policy, stream,
                 queue_cap=4096, **opt):
    """Every (K, capacities, delays) lane of ``lanes`` over the trace
    ``a`` in one call of `cluster.engine.simulate_cluster` on
    ``device``."""
    from repro_torch.cluster.engine import simulate_cluster
    t = {k: torch.tensor(a[k], device=device)[None] for k in COLS}
    Kx = max(x[0] for x in lanes)
    C = max(max(x[1]) for x in lanes)
    masks = np.zeros((len(lanes), Kx, C), bool)
    delays = np.zeros((len(lanes), Kx))
    for li, (k, caps, d) in enumerate(lanes):
        for n, c in enumerate(caps):
            masks[li, n, :c] = True
        if d is not None:
            delays[li, :k] = d
    L = len(lanes)
    return simulate_cluster(
        t["fn_id"], t["arrival"], t["exec_time"], t["cold_start"],
        t["evict"], torch.zeros(L, dtype=torch.int64, device=device),
        torch.tensor(masks, device=device),
        torch.full((L,), POLICIES[policy].default_beta, dtype=torch.float64,
                   device=device), 0.1, kernel=POLICIES[policy],
        routers=routers, router_ix=torch.tensor(router_ix, device=device),
        n_nodes=torch.tensor([x[0] for x in lanes], device=device),
        seeds=torch.tensor([7 * li for li in range(L)], device=device),
        delays=torch.tensor(delays, device=device), n_fns=F, capacity=C,
        queue_cap=queue_cap, stream=stream, **opt)


def _assert_same(card, cpu, what):
    assert sorted(card) == sorted(cpu), what
    for k, v in cpu.items():
        assert torch.equal(card[k].cpu(), v), (what, k)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("router", ["jsq2", "cold_aware", "slo_aware"])
def test_cluster_kernel_bitwise_eager(cuda, policy, router):
    """The K-node variant of every policy under every built-in router, on
    ragged packed lanes (K = 1, 3, 4 and 32 in one launch, one lane with a
    delay), in exact mode, bitwise the eager K-node loop."""
    from repro_torch.cluster.routers import get_router
    a = _azure(20, 240, 4)
    args = (a, 20, CLUSTER_LANES, (get_router(router),),
            [0] * len(CLUSTER_LANES), policy, False)
    launches = K0.cluster_loop.launches
    card = _cluster_run(cuda, *args)
    torch.cuda.synchronize()
    assert K0.cluster_loop.launches == launches + 1
    cpu = _cluster_run("cpu", *args)
    _assert_same(card, cpu, (policy, router))
    assert "node_of" in cpu and not cpu["stalled"].any()
    assert cpu["node_done"].sum(1).tolist() == cpu["done"].tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("stream", [True, False])
def test_cluster_kernel_mixed_routers_and_options(cuda, stream):
    """Three routers side by side in one launch, with the engine options
    on (ragged n_live, deadlines, the timeline) and a delay on two lanes:
    bitwise the eager loop."""
    from repro_torch.cluster.routers import get_router
    lanes = CLUSTER_LANES + ((8, (2,) * 8, tuple(0.01 * k for k in range(8))),)
    routers = tuple(get_router(r) for r in ("jsq2", "cold_aware",
                                            "slo_aware"))
    args = (_azure(30, 400, 9), 30, lanes, routers,
            [i % 3 for i in range(len(lanes))], "esff", stream)
    opt = dict(n_live=torch.tensor([400, 250, 400, 0, 399, 137]),
               deadlines=torch.linspace(0.2, 2.0, 30, dtype=torch.float64),
               tl_bins=6, tl_bucket=40.0)
    card = _cluster_run(cuda, *args, **{
        k: v.to(cuda) if isinstance(v, torch.Tensor) else v
        for k, v in opt.items()})
    cpu = _cluster_run("cpu", *args, **opt)
    _assert_same(card, cpu, stream)
    assert cpu["done"].tolist() == opt["n_live"].tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_cluster_kernel_one_node_is_the_single_node_kernel(cuda, policy):
    """A K = 1 lane at zero delay is bitwise the single-node K0 on the same
    trace and capacity (the timer rail's chain included)."""
    from repro_torch.cluster.routers import get_router
    a = _azure(50, 600, 2)
    lanes = ((1, (4,), None), (1, (8,), None))
    card = _cluster_run(cuda, a, 50, lanes, (get_router("cold_aware"),),
                        [0, 0], policy, False)
    single = _event_loop_run(cuda, [a], 50, (4, 8), (
        POLICIES[policy].default_beta,), 4096, False, policy)
    for k, v in single.items():
        assert torch.equal(card[k], v), (policy, k)


@pytest.mark.cuda
def test_cluster_loop_library_layout_is_the_wrappers(cuda):
    """The built library reports every variant's K-node sizes as the
    wrapper plans them."""
    K0._CHECKED.clear()
    for variant in K0.VARIANTS:
        K0._check_layout(variant, cluster=True)
    assert K0._CHECKED == {(v, True, False) for v in K0.VARIANTS}


@pytest.mark.cuda
def test_cluster_kernel_overflow_at_queue_cap(cuda):
    """A backlog over queue_cap on one node: the drop is counted, the lane
    stalls, and the kernel still gives the eager loop's bits."""
    from repro_torch.cluster.routers import get_router
    a = overflow_trace()
    args = (a, 1, ((2, (1, 1), None),), (get_router("jsq2"),), [0],
            "esff", False, 2)
    card = _cluster_run(cuda, *args)
    cpu = _cluster_run("cpu", *args)
    _assert_same(card, cpu, "overflow")
    assert int(cpu["overflow"][0]) > 0


# ------------------- churn and time-varying delay on the K-node variant
def _churn_entries(span, router):
    """One lane a case, every case in one launch: K = 4 periodic churn
    (nodes 1..3, staggered), churn with constant delays, churn on top of
    a delay schedule, an all-down window at K = 2, and a lane of each
    without churn (a schedule alone; nothing) beside them."""
    from repro_torch.cluster import ClusterSpec, DelaySchedule, PeriodicChurn
    per = span / 3

    def periodic(k):
        return (None,) + tuple(PeriodicChurn(per, duty=0.7, phase=i * per / k)
                               for i in range(1, k))
    ds = DelaySchedule(times=(0.0, per / 2), values=(0.005, 0.08), period=per)
    win = ((0.3 * span, 0.45 * span),)
    return [ClusterSpec(n_nodes=4, router=router, churn=periodic(4)),
            ClusterSpec(n_nodes=3, router=router,
                        net_delay=(0.0, 0.013, 0.027),
                        churn=(None, ((0.3 * span, 0.6 * span),), None)),
            ClusterSpec(n_nodes=4, router=router,
                        net_delay=(0.0, 0.004, 0.008, 0.012),
                        delay_schedule=(None, ds, ds, ds), churn=periodic(4)),
            ClusterSpec(n_nodes=2, router=router, churn=(win, win)),
            ClusterSpec(n_nodes=3, router=router, net_delay=(0.0, 0.01, 0.0),
                        delay_schedule=(None, None, ds)),
            ClusterSpec(n_nodes=4, router=router)]


def _spec_run(device, a, F, entries, policy, stream, cap=8, queue_cap=4096,
              **opt):
    """The K-node engine over ``entries`` (port `ClusterSpec`s, one lane
    each, ``cap`` slots a node) on the trace ``a``, lowered as the runner
    lowers them (`pack_dynamic_lanes`), on ``device``."""
    from types import SimpleNamespace
    from repro_torch.cluster.engine import simulate_cluster
    from repro_torch.cluster.runner import pack_dynamic_lanes
    span = float(np.max(a["arrival"]))
    routers, lanes = pack_dynamic_lanes(
        SimpleNamespace(betas=None, capacities=(cap,)), entries, 1, span)
    t = {k: torch.tensor(a[k], device=device)[None] for k in COLS}
    L = len(lanes["trace_ix"])
    col = {k: torch.tensor(v, device=device) for k, v in lanes.items()}
    extra = {k: col[k] for k in ("churn_t", "dtimes", "dvals", "dper")
             if k in col}
    return simulate_cluster(
        t["fn_id"], t["arrival"], t["exec_time"], t["cold_start"],
        t["evict"], col["trace_ix"], col["cap_mask"],
        torch.full((L,), POLICIES[policy].default_beta, dtype=torch.float64,
                   device=device), 0.1, kernel=POLICIES[policy],
        routers=routers, router_ix=col["router_ix"], n_nodes=col["n_nodes"],
        seeds=col["seeds"], delays=col["delays"], n_fns=F,
        capacity=lanes["cap_mask"].shape[2], queue_cap=queue_cap,
        stream=stream, **extra, **opt)


CHURN_POLICIES = sorted(p for p in POLICIES if not POLICIES[p].has_timers)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", CHURN_POLICIES)
@pytest.mark.parametrize("router", ["jsq2", "cold_aware", "slo_aware"])
def test_churn_kernel_bitwise_eager(cuda, policy, router):
    """Churn (periodic, mid-flight windows, all-down), churn with constant
    and scheduled delays, a schedule alone and a plain lane, every
    non-timer policy under every built-in router, in one launch: exact
    mode, bitwise the eager K-node loop; every churn lane toggles and
    re-routes."""
    a = _azure(20, 300, 4)
    entries = _churn_entries(float(a["arrival"].max()), router)
    launches = K0.cluster_loop.launches
    card = _spec_run(cuda, a, 20, entries, policy, False)
    torch.cuda.synchronize()
    assert K0.cluster_loop.launches == launches + 1
    cpu = _spec_run("cpu", a, 20, entries, policy, False)
    _assert_same(card, cpu, (policy, router))
    assert (cpu["done"] == 300).all() and not cpu["stalled"].any()
    assert cpu["node_done"].sum(1).tolist() == cpu["done"].tolist()
    assert (cpu["toggles"][:4] > 0).all() and (cpu["reroutes"][:4] > 0).all()
    assert (cpu["toggles"][4:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["openwhisk_v2", "esff"])
@pytest.mark.parametrize("stream", [True, False])
def test_delay_schedule_kernel_bitwise_eager(cuda, policy, stream):
    """Delay schedules without churn (the timer rail on the node-local
    clock too), jsq2 and slo_aware side by side, with the engine options:
    bitwise the eager K-node loop."""
    from repro_torch.cluster import ClusterSpec, DelaySchedule
    a = _azure(20, 300, 5)
    span = float(a["arrival"].max())
    ds = DelaySchedule(times=(0.0, span / 8), values=(0.005, 0.08),
                       period=span / 4)
    entries = [ClusterSpec(n_nodes=3, router=r, net_delay=(0.0, 0.01, 0.0),
                           delay_schedule=(None, ds, ds))
               for r in ("jsq2", "slo_aware")]
    opt = dict(deadlines=torch.full((20,), 0.35, dtype=torch.float64),
               tl_bins=4, tl_bucket=span / 4)
    card = _spec_run(cuda, a, 20, entries, policy, stream, **{
        k: v.to(cuda) if isinstance(v, torch.Tensor) else v
        for k, v in opt.items()})
    cpu = _spec_run("cpu", a, 20, entries, policy, stream, **opt)
    _assert_same(card, cpu, (policy, stream))
    assert (cpu["done"] == 300).all()


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["esff", "sff"])
def test_churn_without_toggles_is_the_plain_kernel(cuda, policy):
    """A lane whose toggle row is all BIG (no toggle over the trace) and a
    one-step schedule run the plain K-node loop: bitwise the launch
    without those operands, K = 1 and K = 4."""
    from repro_torch.cluster import ClusterSpec
    a = _azure(20, 300, 6)
    entries = [ClusterSpec(n_nodes=1, router="jsq2"),
               ClusterSpec(n_nodes=4, router="cold_aware")]
    plain = _spec_run(cuda, a, 20, entries, policy, False)
    L, K = 2, 4
    big = torch.full((L, K, 3), E.BIG, dtype=torch.float64, device=cuda)
    steps = torch.zeros((L, K, 1), dtype=torch.float64, device=cuda)
    with_ops = _spec_run(cuda, a, 20, entries, policy, False, churn_t=big,
                         dtimes=steps, dvals=steps.clone(),
                         dper=torch.zeros((L, K), dtype=torch.float64,
                                          device=cuda))
    _assert_same(with_ops, {k: v.cpu() for k, v in plain.items()}, policy)


# -------------------------------- the resilience layer on the K-node variant
def _resil_ops(device, a, F, fail_prob=0.2, timeouts=8.0, attempts=3,
               mode=1, jitter=0.3):
    """The resilience keywords of `simulate_cluster` for the trace ``a``
    (as `ExperimentSpec.resilience_ops` lowers them) on ``device``, and
    the attempts' times in place of its exec times."""
    from repro_torch.core.resilience import plan_outcomes
    eff, nfail, tmo = plan_outcomes(a["fn_id"], a["exec_time"],
                                    fail_prob=fail_prob, timeouts=timeouts,
                                    max_attempts=attempts, n_fns=F, seed=99)
    n = len(a["fn_id"])
    kw = dict(rs_nfail=torch.tensor(nfail, device=device)[None],
              rs_tmo=torch.tensor(tmo, device=device)[None],
              rs_key=torch.arange(n, dtype=torch.int32, device=device)[None],
              resil=(attempts, mode, 0.05, 1.0, jitter, 99))
    return dict(a, exec_time=eff), kw


def _resil_spec_run(device, a, F, entries, policy, stream, mode=1,
                    fail_prob=0.2, cap=3, queue_cap=8, **opt):
    """`_spec_run` under tests/test_resilience.py's faults (``mode``: the
    shed mode), ``cap`` slots a node and ``queue_cap`` (``opt``: its other
    keywords)."""
    b, kw = _resil_ops(device, a, F, fail_prob=fail_prob, mode=mode)
    return _spec_run(device, b, F, entries, policy, stream, cap=cap,
                     queue_cap=queue_cap, **kw, **opt)


def _assert_conserves(out, n):
    tot = out["done"] + out["shed"] + out["failed_exhausted"]
    assert (tot == n).all() and not out["stalled"].any()
    assert out["node_done"].sum(1).tolist() == out["done"].tolist()


# the registered policies that the resilience layer admits
RESIL_POLICIES = ("esff", "esff_h", "sff", "openwhisk", "faascache")


@pytest.mark.cuda
@pytest.mark.parametrize("policy", RESIL_POLICIES)
@pytest.mark.parametrize("on_overflow", ["shed", "shed_oldest"])
def test_resil_single_node_and_static_tier_bitwise_eager(cuda, policy,
                                                         on_overflow):
    """The single node and the static tier (hash K = 2, round_robin K = 3
    with a delay) under faults, both shed modes, every policy the layer
    admits: their K = 1 lanes of the K-node variant, bitwise the eager
    K-node loop, exact mode."""
    import repro_torch.api as tapi
    from repro_torch.core.resilience import RetryPolicy
    spec = tapi.ExperimentSpec(
        traces=[tapi.ArrayTrace.from_arrays(_azure(12, 300, 3))],
        policies=(policy,), capacities=(3,), queue_cap=8, stream=False,
        keep_per_request=True, fail_prob=0.2, timeouts=8.0,
        retry=RetryPolicy(3, 0.05, 1.0, 0.3), on_overflow=on_overflow,
        fail_seed=99, cluster=(
            None, tapi.ClusterSpec(n_nodes=2, router="hash"),
            tapi.ClusterSpec(n_nodes=3, router="round_robin",
                             net_delay=0.003)))
    launches = K0.cluster_loop.launches
    card = tapi.run_experiment(spec, device="cuda").check()
    torch.cuda.synchronize()
    assert K0.cluster_loop.launches == launches + 2
    cpu = tapi.run_experiment(spec, device="cpu").check()
    assert sorted(card.data) == sorted(cpu.data)
    for k in cpu.data:
        np.testing.assert_array_equal(card[k], cpu[k], err_msg=k)
    assert int(cpu["shed"].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("policy", CHURN_POLICIES)
def test_resil_dynamic_kernel_bitwise_eager(cuda, policy):
    """jsq2, cold_aware and slo_aware with a delay a node, and jsq2 over
    mixed capacities, under faults in one launch: exact mode, bitwise the
    eager K-node loop, conserving every lane's requests."""
    from repro_torch.cluster import ClusterSpec
    a = _azure(12, 300, 4)
    entries = [ClusterSpec(n_nodes=4, router="jsq2"),
               ClusterSpec(n_nodes=4, router="cold_aware"),
               ClusterSpec(n_nodes=4, router="slo_aware",
                           net_delay=(0.0, 0.013, 0.027, 0.041)),
               ClusterSpec(n_nodes=4, router="jsq2",
                           node_capacity=(3, 1, 2, 1))]
    card = _resil_spec_run(cuda, a, 12, entries, policy, False,
                           queue_cap=3)
    cpu = _resil_spec_run("cpu", a, 12, entries, policy, False, queue_cap=3)
    _assert_same(card, cpu, policy)
    _assert_conserves(cpu, 300)
    assert int(cpu["retried"].sum()) > 0 and int(cpu["shed"].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["esff", "sff"])
@pytest.mark.parametrize("mode", [1, 2])
def test_resil_churn_kernel_bitwise_eager(cuda, policy, mode):
    """Churn (periodic, mid-flight, with delays and schedules, an all-down
    window) under faults and both shed modes: bitwise the eager K-node
    loop; drained attempts are given back."""
    a = _azure(12, 300, 5)
    entries = _churn_entries(float(a["arrival"].max()), "jsq2")
    card = _resil_spec_run(cuda, a, 12, entries, policy, True, mode=mode)
    cpu = _resil_spec_run("cpu", a, 12, entries, policy, True, mode=mode)
    _assert_same(card, cpu, (policy, mode))
    _assert_conserves(cpu, 300)
    assert (cpu["reroutes"][:4] > 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("inner", ["jsq2", "cold_aware"])
def test_resil_breaker_kernel_bitwise_eager(cuda, inner):
    """The circuit breaker around jsq2 or cold_aware at fail_prob 0.6
    beside the plain router: it trips, and the launch is bitwise the
    eager K-node loop."""
    from repro_torch.cluster import ClusterSpec
    from repro_torch.cluster.routers import (BreakerRouter, get_router,
                                             register_router,
                                             unregister_router)
    name = f"breaker_{inner}"
    register_router(name, BreakerRouter(get_router(inner), name, volume=10),
                    replace=True)
    try:
        a = _azure(12, 400, 6)
        entries = [ClusterSpec(n_nodes=4, router=name),
                   ClusterSpec(n_nodes=4, router=inner)]
        card = _resil_spec_run(cuda, a, 12, entries, "esff", False,
                               fail_prob=0.6, queue_cap=64)
        cpu = _resil_spec_run("cpu", a, 12, entries, "esff", False,
                              fail_prob=0.6, queue_cap=64)
    finally:
        unregister_router(name)
    _assert_same(card, cpu, inner)
    _assert_conserves(cpu, 400)
    assert int(cpu["breaker_trips"][0]) > 0
    assert int(cpu["breaker_trips"][1]) == 0


@pytest.mark.cuda
def test_resil_node_table_layout(cuda):
    """The library's node table (88 B a node: the breaker's window and
    reopen time) and resilience columns are the wrapper's, and
    fig_resilience's widest lane (K = 8 nodes of 4 slots, F = 200) keeps
    its per-(node, function) state in shared memory."""
    import ctypes
    from repro_torch.kernels import _build
    for variant, v in K0.VARIANTS.items():
        f = _build.c_entry(K0.CLUSTER_SOURCE[variant],
                           "event_loop_cluster_layout",
                           [ctypes.c_int, _build.PTR, ctypes.c_int])
        got = (ctypes.c_longlong * 12)()
        assert f(v["code"], got, 12) == 12
        assert tuple(got) == K0.cluster_layout(variant)
    assert K0.CLUSTER_NODE_BYTES == 88
    assert K0.cluster_layout_plan(200, 32, 8, "esff")["fn_in_shared"]


# ------------------------------------- the traced forms of K0 (telemetry)
def _traced(fn, n_lanes):
    """``fn()`` inside a collection scope: its result and each lane's
    event stream."""
    from repro_torch.telemetry import rail
    with rail.collect() as sink:
        out = fn()
        torch.cuda.synchronize()
    return out, [sink.lane_events(j) for j in range(n_lanes)]


def _assert_same_events(got, want, what):
    assert len(got) == len(want), what
    for lane, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w), what
        for f in w:
            np.testing.assert_array_equal(g[f], w[f],
                                          err_msg=f"{what} lane {lane} {f}")


def _eager_single(device, traces, F, caps, betas, queue_cap, stream, policy):
    """`_event_loop_run`'s lanes through the eager loop itself (K0's plain
    version) on ``device``, traced."""
    return E.simulate_eager(
        *_event_loop_inputs(device, traces, caps, betas), 0.1,
        kernel=POLICIES[policy], n_fns=F, capacity=max(caps),
        queue_cap=queue_cap, stream=stream, trace=True)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_traced_kernel_bitwise_traced_eager(cuda, policy):
    """The traced single-node form of every variant (three capacities, a
    queue small enough to overflow on one lane): its event
    streams bitwise the traced eager loop's on the card, one record a
    processed event (the last one's seq the lane's n_events), and its
    results bitwise the untraced launch's."""
    traces = [_azure(20, 100, 2)]
    args = (traces, 20, (2, 3, 5), (1.0,), 6, False)
    launches = dict(K0.event_loop.traced_launches)
    plain = _event_loop_run(cuda, *args, policy)
    card, ev = _traced(lambda: E.simulate(
        *_event_loop_inputs(cuda, traces, (2, 3, 5), (1.0,)), 0.1,
        kernel=POLICIES[policy], n_fns=20, capacity=5, queue_cap=6,
        stream=False, trace=True), 3)
    variant = K0.variant_of(POLICIES[policy])
    # OpenWhisk-v2's timers overrun the first capacity: one relaunch
    assert (K0.event_loop.traced_launches.get(variant, 0)
            == launches.get(variant, 0) + 1
            + K0.event_loop.last_trace["relaunches"])
    eager, ev_e = _traced(lambda: _eager_single(cuda, *args, policy), 3)
    _assert_same(card, {k: v.cpu() for k, v in plain.items()}, policy)
    _assert_same(card, {k: v.cpu() for k, v in eager.items()}, policy)
    _assert_same_events(ev, ev_e, policy)
    for lane, e in enumerate(ev):
        assert len(e["kind"]) == int(plain["n_events"][lane])
        assert e["seq"].tolist() == list(range(1, len(e["kind"]) + 1))
        assert (e["node"] == -1).all()


@pytest.mark.cuda
def test_traced_kernel_relaunch_with_small_capacity(cuda, monkeypatch):
    """A first capacity of 16 records a lane: every lane overruns it, the
    wrapper launches again with exact counts and hands over the same
    streams as a launch whose capacity fits."""
    traces = [_azure(20, 150, 2)]
    inputs = _event_loop_inputs(cuda, traces, (2, 4), (1.0,))
    kw = dict(kernel=POLICIES["esff"], n_fns=20, capacity=4, queue_cap=64,
              stream=True, trace=True)
    fit, ev_fit = _traced(lambda: K0.event_loop(*inputs, 0.1, **kw), 2)
    assert K0.event_loop.last_trace["relaunches"] == 0
    monkeypatch.setattr(K0, "trace_capacity", lambda n, *lane: 16)
    small, ev_small = _traced(lambda: K0.event_loop(*inputs, 0.1, **kw), 2)
    assert K0.event_loop.last_trace["relaunches"] == 1
    _assert_same(small, {k: v.cpu() for k, v in fit.items()}, "relaunch")
    _assert_same_events(ev_small, ev_fit, "relaunch")


def _traced_cluster_pair(device_fn, n_lanes):
    """A K-node call through the kernel (``device_fn(False)``) and through
    the eager K-node loop on the card (``device_fn(True)``), both traced,
    and the kernel's untraced launch."""
    from repro_torch.cluster import engine as CE
    card, ev = _traced(lambda: device_fn(False, True), n_lanes)
    plain = device_fn(False, False)
    orig = CE.has_cluster_loop
    CE.has_cluster_loop = lambda kernel, routers: False
    try:
        eager, ev_e = _traced(lambda: device_fn(True, True), n_lanes)
    finally:
        CE.has_cluster_loop = orig
    return card, ev, plain, eager, ev_e


@pytest.mark.cuda
@pytest.mark.parametrize("policy", CHURN_POLICIES)
def test_traced_cluster_kernel_bitwise_traced_eager(cuda, policy):
    """The traced K-node form of every non-timer variant on churn (with
    delays, schedules and an all-down window) under faults, in one
    launch: event streams (CHURN, REROUTE, NODE_ARRIVAL, RETRY, parks on
    node 0) bitwise the traced eager K-node loop on the card, results
    bitwise the untraced launch."""
    a = _azure(12, 80, 5)
    entries = _churn_entries(float(a["arrival"].max()), "jsq2")

    def run(eager, trace):
        return _resil_spec_run(cuda, a, 12, entries, policy, True,
                               trace=trace)
    card, ev, plain, eager, ev_e = _traced_cluster_pair(run, len(entries))
    _assert_same(card, {k: v.cpu() for k, v in plain.items()}, policy)
    _assert_same(card, {k: v.cpu() for k, v in eager.items()}, policy)
    _assert_same_events(ev, ev_e, policy)
    # the per-lane first window holds every record: no relaunch
    assert K0.cluster_loop.last_trace["relaunches"] == 0
    kinds = set(np.concatenate([e["kind"] for e in ev]).tolist())
    assert {5, 6, 7}.issubset(kinds), kinds   # NODE_ARRIVAL, REROUTE, CHURN
    for lane, e in enumerate(ev):
        assert len(e["kind"]) == int(plain["n_events"][lane])


@pytest.mark.cuda
@pytest.mark.parametrize("router", ["jsq2", "cold_aware", "slo_aware"])
def test_traced_cluster_kernel_timers_and_routers(cuda, router):
    """OpenWhisk-v2's timer rail and ESFF under each router, with delays
    and a schedule, traced: bitwise the traced eager K-node loop."""
    from repro_torch.cluster import ClusterSpec, DelaySchedule
    a = _azure(12, 80, 6)
    span = float(a["arrival"].max())
    ds = DelaySchedule(times=(0.0, span / 8), values=(0.005, 0.08),
                       period=span / 4)
    entries = [ClusterSpec(n_nodes=3, router=router,
                           net_delay=(0.0, 0.01, 0.0),
                           delay_schedule=(None, ds, None)),
               ClusterSpec(n_nodes=4, router=router)]
    for policy in ("openwhisk_v2", "esff"):
        def run(eager, trace):
            return _spec_run(cuda, a, 12, entries, policy, False, cap=3,
                             queue_cap=16, trace=trace)
        card, ev, plain, eager, ev_e = _traced_cluster_pair(run, 2)
        _assert_same(card, {k: v.cpu() for k, v in plain.items()}, policy)
        _assert_same(card, {k: v.cpu() for k, v in eager.items()}, policy)
        _assert_same_events(ev, ev_e, (router, policy))


@pytest.mark.cuda
def test_traced_single_node_under_faults_writes_node_minus_one(cuda):
    """`engine.simulate` under resilience runs K = 1 lanes of the traced
    K-node form: records carry node -1, as the single-node engine's, and
    match the traced eager K-node loop."""
    traces = [_azure(12, 100, 3)]
    b, kw = _resil_ops(cuda, traces[0], 12)
    inputs = _event_loop_inputs(cuda, [b], (2, 3), (1.0,))

    def run(eager, trace):
        return E.simulate(*inputs, 0.1, kernel=POLICIES["esff"], n_fns=12,
                          capacity=3, queue_cap=4, stream=True,
                          trace=trace, **kw)
    card, ev, plain, eager, ev_e = _traced_cluster_pair(run, 2)
    _assert_same(card, {k: v.cpu() for k, v in plain.items()}, "faults")
    _assert_same(card, {k: v.cpu() for k, v in eager.items()}, "faults")
    _assert_same_events(ev, ev_e, "faults")
    assert all((e["node"] == -1).all() for e in ev)
    assert any((e["kind"] == 4).any() for e in ev)   # RETRY


@pytest.mark.cuda
def test_traced_layouts_are_the_wrappers(cuda):
    """The traced libraries report the untraced forms' layouts."""
    K0._CHECKED.clear()
    for variant in K0.VARIANTS:
        K0._check_layout(variant, traced=True)
        K0._check_layout(variant, cluster=True, traced=True)
    assert K0._CHECKED == {(v, c, True) for v in K0.VARIANTS
                           for c in (False, True)}


# ------------------------------------------- the serving path's kernels
def _bf16_or_f32(shape, dtype, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(*shape, generator=g, device=device).to(dtype)


# f32: tests/test_kernels.py's TOL. bf16: chip_smoke.py's per-kernel
# limits (KERNEL_TOL): both sides round the output to bf16 once, so one
# ulp of it (rtol 1e-2) plus the f32 sums' order (atol); flash
# attention's tensor-core body also rounds its weights p to bf16, and
# its limit adds 2^-8 of the plain attention of |v|, which bounds that.
F32_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=1e-2, atol=1e-3)
P_ROUND = 2.0 ** -8


def _assert_within(got, want, dtype, abs_v=None):
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **F32_TOL)
        return
    g, w = got.float(), want.float()
    lim = BF16_TOL["atol"] + BF16_TOL["rtol"] * w.abs()
    if abs_v is not None:
        lim = lim + P_ROUND * abs_v
    use = ((g - w).abs() / lim).max().item()
    assert use <= 1.0, (f"max |kernel - plain| = {(g - w).abs().max()} "
                        f"is {use:.3g} of the limit")


@pytest.mark.cuda
@pytest.mark.parametrize("S,T,H,KVH,D,causal,dtype", [
    (128, 128, 4, 4, 64, True, torch.float32),
    (100, 180, 4, 2, 64, False, torch.float32),
    (100, 180, 4, 2, 32, True, torch.float32),
    (33, 33, 2, 1, 16, True, torch.float32),
    (256, 256, 8, 2, 128, True, torch.bfloat16),  # the tensor-core path
    (512, 512, 32, 8, 128, True, torch.bfloat16),
    (100, 180, 4, 2, 64, False, torch.bfloat16),  # ragged S and T
    (33, 33, 2, 1, 16, True, torch.bfloat16),
    (1024, 1024, 32, 32, 80, True, torch.bfloat16),  # Zamba2's shared block
    (100, 180, 4, 4, 80, False, torch.bfloat16),
    (100, 100, 4, 4, 80, True, torch.float32),
])
def test_flash_attention_kernel_matches_plain(cuda, S, T, H, KVH, D,
                                              causal, dtype):
    q = _bf16_or_f32((2, S, H, D), dtype, 0, cuda)
    k = _bf16_or_f32((2, T, KVH, D), dtype, 1, cuda)
    v = _bf16_or_f32((2, T, KVH, D), dtype, 2, cuda)
    launches = FA.flash_attention.launches
    got = FA.flash_attention(q, k, v, causal=causal)
    want = FA.flash_attention_plain(q, k, v, causal=causal)
    abs_v = FA.flash_attention_plain(q.float(), k.float(), v.float().abs(),
                                     causal=causal)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == launches + 1
    _assert_within(got, want, dtype, abs_v)


@pytest.mark.cuda
@pytest.mark.parametrize("T,H,KVH,D,length,dtype", [
    (512, 8, 2, 64, 200, torch.float32),
    (300, 4, 1, 64, 0, torch.float32),
    (64, 4, 2, 32, 100, torch.float32),
    (512, 8, 8, 128, 511, torch.bfloat16),
    (2560, 32, 8, 128, 1000, torch.bfloat16),
    (2560, 32, 8, 128, 2559, torch.bfloat16),   # split over 32 blocks
    (4096, 40, 8, 128, 3000, torch.bfloat16),   # G = 5
    (1000, 20, 20, 128, 999, torch.bfloat16),   # G = 1
    (700, 4, 2, 256, 650, torch.float32),
    (200, 4, 2, 16, 150, torch.bfloat16),
    (1280, 32, 32, 80, 1030, torch.bfloat16),   # Zamba2's shared block
    (1280, 32, 32, 80, 0, torch.bfloat16),
    (300, 4, 2, 80, 250, torch.float32),
])
def test_decode_attention_kernel_matches_plain(cuda, T, H, KVH, D, length,
                                               dtype):
    q = _bf16_or_f32((2, 1, H, D), dtype, 0, cuda)
    k = _bf16_or_f32((2, T, KVH, D), dtype, 1, cuda)
    v = _bf16_or_f32((2, T, KVH, D), dtype, 2, cuda)
    launches = DA.decode_attention.launches
    got = DA.decode_attention(q, k, v, length)
    want = DA.decode_attention_plain(q, k, v, length)
    torch.cuda.synchronize()
    assert DA.decode_attention.launches == launches + 1
    _assert_within(got, want, dtype)


def _limit_use(got, want, dtype, abs_v=None):
    """max |got - want| over _assert_within's limit (at most 1 within)."""
    g, w = got.float(), want.float()
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    lim = tol["atol"] + tol["rtol"] * w.abs()
    if abs_v is not None and dtype != torch.float32:
        lim = lim + P_ROUND * abs_v
    return ((g - w).abs() / lim).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("S,H,dtype", [
    (512, 128, torch.bfloat16), (2048, 16, torch.bfloat16),
    (300, 8, torch.bfloat16), (129, 4, torch.float32),
    (512, 16, torch.float32)])
def test_flash_attention_mla_head_dims_match_plain(cuda, S, H, dtype):
    """K2 at DeepSeek-V3's MLA head dims (q/k 192, v 128; H = KVH),
    causal, both bodies, against the plain version; a kernel that read
    only v's first 64 dims would be rejected. Unverified until a run on
    an H100 passes."""
    q = _bf16_or_f32((2, S, H, 192), dtype, 0, cuda)
    k = _bf16_or_f32((2, S, H, 192), dtype, 1, cuda)
    v = _bf16_or_f32((2, S, H, 128), dtype, 2, cuda)
    scale = 192 ** -0.5
    launches = (FA.flash_attention.launches,
                FA.flash_attention.value_dim_launches)
    got = FA.flash_attention(q, k, v, scale=scale)
    want = FA.flash_attention_plain(q, k, v, scale=scale)
    abs_v = FA.flash_attention_plain(q.float(), k.float(), v.float().abs(),
                                     scale=scale)
    torch.cuda.synchronize()
    assert got.shape == (2, S, H, 128)
    assert (FA.flash_attention.launches,
            FA.flash_attention.value_dim_launches) == (launches[0] + 1,
                                                       launches[1] + 1)
    assert torch.isfinite(got.float()).all()
    _assert_within(got, want, dtype, abs_v)
    short = v.clone()
    short[..., 64:] = 0
    fault = FA.flash_attention_plain(q, k, short, scale=scale)
    assert _limit_use(fault, want, dtype, abs_v) > 1.0


def _mla_f32(q_abs, q_rope, c_kv, k_rope, allowed, scale, value=None,
             rope=True):
    """The MLA decode attention in f32 over the positions ``allowed``
    (chip_smoke.mla_f32): K3-mla's planted faults and |c_kv|'s
    attention."""
    c = c_kv.float()
    s = torch.einsum("bshr,btr->bhst", q_abs.float(), c)
    if rope:
        s = s + torch.einsum("bshk,btk->bhst", q_rope.float(),
                             k_rope.float())
    p = torch.softmax((s * scale).masked_fill(~allowed, float("-inf")), -1)
    v = c if value is None else value.float()
    return torch.einsum("bhst,btr->bshr", p, v).to(q_abs.dtype)


# K3-mla's cases (B, T, H, length, dtype): the served rows, partial head
# groups (H 4, 20, 48), B = 2, length 0 and past the cache; the bf16 ones
# on both bodies (named through ``body=``), the f32 ones on the CUDA cores
MLA_DECODE_CASES = [
    (1, 2560, 128, 2559, torch.bfloat16), (1, 2560, 128, 511, torch.bfloat16),
    (1, 2560, 128, 0, torch.bfloat16), (2, 2560, 128, 2559, torch.bfloat16),
    (2, 700, 48, 650, torch.bfloat16), (1, 300, 4, 299, torch.bfloat16),
    (1, 2560, 128, 1000, torch.float32), (2, 300, 20, 0, torch.float32),
    (1, 100, 16, 150, torch.float32)]


def _mla_check(cuda, B, T, H, length, dtype, body):
    """K3-mla on ``body`` against its plain version at DeepSeek-V3's (R,
    DR) = (512, 64): one launch of that body, a repeated call bitwise
    equal, within the limit; the mask one position off and the rope term
    dropped rejected by it."""
    R, DR = 512, 64
    q_abs = _bf16_or_f32((B, 1, H, R), dtype, 0, cuda)
    q_rope = _bf16_or_f32((B, 1, H, DR), dtype, 1, cuda)
    c_kv = _bf16_or_f32((B, T, R), dtype, 2, cuda)
    k_rope = _bf16_or_f32((B, T, DR), dtype, 3, cuda)
    scale = 192 ** -0.5
    args = (q_abs, q_rope, c_kv, k_rope, length)
    assert DA.mla_body_for(*args[:4]) == (
        "mma" if dtype == torch.bfloat16 else "cuda_core")
    launches = DA.mla_decode_attention.launches
    bodies = dict(DA.mla_decode_attention.body_launches)
    got = DA.mla_decode_attention(*args, scale=scale, body=body)
    again = DA.mla_decode_attention(*args, scale=scale, body=body)
    want = DA.mla_decode_attention_plain(*args, scale=scale)
    torch.cuda.synchronize()
    assert DA.mla_decode_attention.launches == launches + 2
    bodies[body] += 2
    assert DA.mla_decode_attention.body_launches == bodies
    assert torch.equal(got, again)
    assert got.shape == (B, 1, H, R) and torch.isfinite(got.float()).all()
    pos = torch.arange(T, device=cuda)
    seen = pos <= length
    abs_v = _mla_f32(q_abs, q_rope, c_kv, k_rope, seen, scale,
                     value=c_kv.abs()).float()
    _assert_within(got, want, dtype, abs_v)
    if length + 1 < T:
        off = pos <= length + 1
    else:
        off = pos < min(length, T - 1)
    assert _limit_use(_mla_f32(q_abs, q_rope, c_kv, k_rope, off, scale),
                      want, dtype, abs_v) > 1.0
    if length > 0:
        assert _limit_use(_mla_f32(q_abs, q_rope, c_kv, k_rope, seen,
                                   scale, rope=False),
                          want, dtype, abs_v) > 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,length,dtype,body", [
    (*c, body) for c in MLA_DECODE_CASES
    for body in (("cuda_core", "mma") if c[-1] == torch.bfloat16
                 else ("cuda_core",))])
def test_mla_decode_kernel_matches_plain(cuda, B, T, H, length, dtype,
                                         body):
    """K3-mla (csrc/mla_decode.cu) against its plain version: one block's
    range and a cluster of 16, a partial head group (H 4, 20, 48), B =
    2, length past the cache, each bf16 case on both bodies; the mask one
    position off and the rope term dropped are rejected."""
    _mla_check(cuda, B, T, H, length, dtype, body)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,length", [
    (1, 1100, 128, 1000),   # ranges of 80 positions: 2.5 tiles of 32
    (1, 2560, 128, 960),    # a last range of one position
    (1, 127, 128, 126),     # a cluster of one block, the last tile 31
    (3, 200, 24, 150),      # B 3, a partial group: 6 clusters
])
def test_mla_decode_mma_body_edges(cuda, B, T, H, length):
    """The tensor-core body's own edges (tests/test_torch_attention.py
    pins their plans on 132 SMs): a range whose length is not a multiple
    of the tile, a one-position range, a cluster of one block; the body
    the rule picks for bf16, held as test_mla_decode_kernel_matches_plain
    holds it."""
    _mla_check(cuda, B, T, H, length, torch.bfloat16, "mma")
    args = [_bf16_or_f32(s, torch.bfloat16, i, cuda) for i, s in enumerate(
        ((B, 1, H, 512), (B, 1, H, 64), (B, T, 512), (B, T, 64)))]
    before = DA.mla_decode_attention.body_launches["mma"]
    DA.mla_decode_attention(*args, length, scale=0.1)
    assert DA.mla_decode_attention.body_launches["mma"] == before + 1


@pytest.mark.cuda
def test_mla_decode_mma_body_refuses_f32(cuda):
    """The tensor-core body takes bf16 only: named for f32 it raises (no
    launch, no fallback). Its shared memory lets two blocks share an
    SM."""
    args = [_bf16_or_f32(s, torch.float32, i, cuda) for i, s in enumerate(
        ((1, 1, 16, 512), (1, 1, 16, 64), (1, 64, 512), (1, 64, 64)))]
    launches = DA.mla_decode_attention.launches
    with pytest.raises(ValueError, match="bf16"):
        DA.mla_decode_attention(*args, 10, scale=0.1, body="mma")
    assert DA.mla_decode_attention.launches == launches
    info = DA.mla_kernel_info("mma")
    assert info["blocks_per_sm"] >= 2 and info["smem_bytes"] < 116 * 1024


@pytest.mark.cuda
@pytest.mark.parametrize("D", FA.HEAD_DIMS)
@pytest.mark.parametrize("S,T,H,KVH,causal", [
    (1, 1, 4, 4, True),         # one row of a 128-row tile
    (127, 127, 8, 1, True),     # G = 8, a ragged tile
    (129, 129, 4, 1, True),     # G = 4, one row into the second tile
    (2000, 2000, 8, 8, True),   # G = 1, ragged S past 16 tiles
    (100, 300, 8, 2, False),    # T > S, bidirectional
])
def test_flash_attention_wgmma_body_edges(cuda, D, S, T, H, KVH, causal):
    """The bf16 (TMA + wgmma) body at every head dim, at B = 2, against
    the plain version: ragged q and kv tiles (the TMA zero-fills them),
    a single row, every GQA group size."""
    q = _bf16_or_f32((2, S, H, D), torch.bfloat16, 3, cuda)
    k = _bf16_or_f32((2, T, KVH, D), torch.bfloat16, 4, cuda)
    v = _bf16_or_f32((2, T, KVH, D), torch.bfloat16, 5, cuda)
    launches = FA.flash_attention.launches
    got = FA.flash_attention(q, k, v, causal=causal)
    want = FA.flash_attention_plain(q, k, v, causal=causal)
    abs_v = FA.flash_attention_plain(q.float(), k.float(), v.float().abs(),
                                     causal=causal)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == launches + 1
    assert torch.isfinite(got.float()).all()
    _assert_within(got, want, torch.bfloat16, abs_v)


def _window_fault(q, k, v, window, kind):
    """The window's planted faults: ``wide``, the band one key too wide
    (W + 2 keys a row); ``edge``, the 64 keys at the band's far edge
    (i - W .. i - W + 63) dropped."""
    S, T = q.shape[1], k.shape[1]
    pos_q = torch.arange(S, device=q.device)[:, None]
    pos_k = torch.arange(T, device=q.device)[None, :]
    d = pos_q - pos_k
    if kind == "wide":
        ok = (d >= 0) & (d <= window + 1)
    else:
        ok = (d >= 0) & (d <= window - 64)
    g = q.shape[2] // k.shape[2]
    kf = k.repeat_interleave(g, dim=2).float()
    vf = v.repeat_interleave(g, dim=2).float()
    sc = torch.einsum("bshd,bthd->bhst", q.float(), kf) / q.shape[-1] ** 0.5
    p = torch.softmax(sc.masked_fill(~ok, float("-inf")), dim=-1)
    return torch.einsum("bhst,bthd->bshd", p, vf).to(q.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KVH,D,window", [
    (1, 6000, 32, 32, 80, 4096),    # Zamba2's shared block past its cache
    (1, 2048, 32, 8, 128, 1000),
    (2, 512, 8, 2, 64, 63),         # a small window: one key a large share
    (2, 512, 8, 2, 64, 64),
    (2, 300, 4, 4, 32, 0),          # a row sees itself only
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_window_matches_plain(cuda, B, S, H, KVH, D, window,
                                              dtype):
    """K2 with a sliding window, both bodies, against the plain version
    within the limits of `test_flash_attention_kernel_matches_plain`; the
    limit rejects the band one key too wide and the far edge's 64 keys
    dropped (window >= 64)."""
    q = _bf16_or_f32((B, S, H, D), dtype, 6, cuda)
    k = _bf16_or_f32((B, S, KVH, D), dtype, 7, cuda)
    v = _bf16_or_f32((B, S, KVH, D), dtype, 8, cuda)
    launches = FA.flash_attention.launches
    got = FA.flash_attention(q, k, v, window=window)
    want = FA.flash_attention_plain(q, k, v, window=window)
    abs_v = FA.flash_attention_plain(q.float(), k.float(), v.float().abs(),
                                     window=window)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == launches + 1
    assert torch.isfinite(got.float()).all()
    _assert_within(got, want, dtype, abs_v)
    for kind in ("wide", "edge") if window >= 64 else ("wide",):
        with pytest.raises(AssertionError):
            _assert_within(_window_fault(q, k, v, window, kind), want,
                           dtype, abs_v)


def _length_at_boundary(T, n_heads_kv, n_sms, last):
    """The first length >= T // 2 whose cluster plan leaves ``last``
    positions (1, or a whole range) in the last block."""
    for length in range(T // 2, T):
        n = length + 1
        per, n_splits = DA.cluster_plan(n, n_heads_kv, n_sms)
        if n_splits > 1 and n - per * (n_splits - 1) == (last or per):
            return length
    raise AssertionError("no such length")


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,KVH,D,length,dtype", [
    (2, 999, 32, 8, 128, 0, torch.bfloat16),      # length 0, T % 16 != 0
    (2, 1000, 32, 8, 128, "one", torch.bfloat16),  # last range: 1 position
    (2, 1000, 32, 8, 128, "full", torch.bfloat16),  # last range full
    (1, 2560, 32, 8, 128, "one", torch.bfloat16),
    (1, 2560, 32, 8, 128, "full", torch.bfloat16),
    (2, 1001, 4, 2, 256, 1000, torch.float32),     # D = 256 in f32
    (2, 1283, 32, 32, 80, 1282, torch.bfloat16),   # D = 80, B = 2
    (1, 32768, 32, 8, 128, 30000, torch.bfloat16),  # ranges in stages
    (1, 9000, 8, 2, 256, 8999, torch.float32),
])
def test_decode_attention_cluster_edges(cuda, B, T, H, KVH, D, length,
                                        dtype):
    """K3's one launch over clusters: the edges of its cluster plan and
    of its shared-memory staging, against the plain version."""
    if isinstance(length, str):
        n_sms = torch.cuda.get_device_properties(
            cuda).multi_processor_count
        length = _length_at_boundary(T, B * KVH, n_sms,
                                     1 if length == "one" else 0)
    q = _bf16_or_f32((B, 1, H, D), dtype, 6, cuda)
    k = _bf16_or_f32((B, T, KVH, D), dtype, 7, cuda)
    v = _bf16_or_f32((B, T, KVH, D), dtype, 8, cuda)
    launches = DA.decode_attention.launches
    got = DA.decode_attention(q, k, v, length)
    want = DA.decode_attention_plain(q, k, v, length)
    torch.cuda.synchronize()
    assert DA.decode_attention.launches == launches + 1
    _assert_within(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,wdtype,offset,body", [
    ((4, 128, 512), torch.float32, torch.float32, 0, "vector"),
    ((2, 300, 384), torch.bfloat16, torch.float32, 0, "vector"),
    ((2048, 2560), torch.bfloat16, torch.bfloat16, 0, "vector"),
    ((4096, 128), torch.bfloat16, torch.bfloat16, 0, "vector"),
    ((3, 8192), torch.float32, torch.bfloat16, 0, "vector"),
    # the served shapes: a decode step's hidden norm, q-norm and k-norm
    # (Qwen3-4B), Zamba2-2.7B's decode gate norm, Mamba2-780M's gate
    # norm over a 2,000-token prompt
    ((1, 2560), torch.bfloat16, torch.bfloat16, 0, "vector"),
    ((32, 128), torch.bfloat16, torch.bfloat16, 0, "vector"),
    ((8, 128), torch.bfloat16, torch.bfloat16, 0, "vector"),
    ((1, 5120), torch.bfloat16, torch.bfloat16, 0, "vector"),
    ((2000, 3072), torch.bfloat16, torch.bfloat16, 0, "vector"),
    ((2, 4096, 8192), torch.bfloat16, torch.float32, 0, "vector"),
    # the general body: odd widths, and contiguous views off 16 bytes
    ((1, 1), torch.float32, torch.float32, 0, "general"),
    ((5, 1001), torch.bfloat16, torch.bfloat16, 0, "general"),
    ((6, 2560), torch.bfloat16, torch.bfloat16, 1, "general"),
    ((6, 1024), torch.float32, torch.float32, 1, "general"),
])
def test_rmsnorm_kernels_match_plain(cuda, monkeypatch, shape, dtype,
                                     wdtype, offset, body):
    # x ``offset`` elements into its buffer (1: off 16 bytes)
    n = int(np.prod(shape))
    x = _bf16_or_f32((n + offset,), dtype, 0, cuda)[offset:].view(shape)
    r = _bf16_or_f32(shape, dtype, 1, cuda)
    w = (1.0 + 0.1 * _bf16_or_f32(shape[-1:], torch.float32, 2,
                                  cuda)).to(wdtype)
    entry, bodies = RN._entry(), []

    def spy(*a):
        # after the five pointers: R, D, the two dtype codes and the
        # vectors a thread, 0 for the general body
        bodies.append("general" if a[9] == 0 else "vector")
        return entry(*a)

    monkeypatch.setattr(RN, "_FN", spy)
    n0, n1 = RN.rmsnorm.launches, RN.rmsnorm_residual.launches
    got = RN.rmsnorm(x, w)
    got_n, got_r = RN.rmsnorm_residual(x, r, w)
    want = RN.rmsnorm_plain(x, w)
    want_n, want_r = RN.rmsnorm_residual_plain(x, r, w)
    torch.cuda.synchronize()
    assert bodies == [body, body]
    assert (RN.rmsnorm.launches, RN.rmsnorm_residual.launches) == (
        n0 + 1, n1 + 1)
    _assert_within(got, want, dtype)
    _assert_within(got_n, want_n, dtype)
    assert torch.equal(got_r, want_r)


@pytest.mark.cuda
@pytest.mark.parametrize("bad,exc", [
    ("x float16", TypeError), ("weight of 7", ValueError),
    ("x not contiguous", ValueError), ("D 8193", ValueError),
    ("residual bf16", TypeError), ("residual (2, 8)", ValueError),
    ("weight on the cpu", ValueError)])
def test_rmsnorm_wrappers_reject_on_the_card(cuda, bad, exc):
    """The common path on the card raises on every input the full
    checks reject (tests/test_torch_rmsnorm.py's cases, on CUDA)."""
    D = 8193 if bad == "D 8193" else 8
    x, r = torch.ones(4, D, device=cuda), torch.ones(4, D, device=cuda)
    w = torch.ones(D, device=cuda)
    x = {"x float16": x.half(),
         "x not contiguous": torch.ones(D, 4, device=cuda).t()}.get(bad, x)
    w = {"weight of 7": torch.ones(7, device=cuda),
         "weight on the cpu": torch.ones(D)}.get(bad, w)
    r = {"residual bf16": r.bfloat16(),
         "residual (2, 8)": torch.ones(2, 8, device=cuda)}.get(bad, r)
    n0, n1 = RN.rmsnorm.launches, RN.rmsnorm_residual.launches
    with pytest.raises(exc):
        if bad.startswith("residual"):
            RN.rmsnorm_residual(x, r, w)
        else:
            RN.rmsnorm(x, w)
    assert (RN.rmsnorm.launches, RN.rmsnorm_residual.launches) == (n0, n1)


# K5: f32 on both sides, sums in another order; tests/test_kernels.py's
# f32 TOL of the TPU kernel (3e-4 there), here 2e-4 for the CUDA-core
# body; the wgmma body is held to chip_smoke.py's KERNEL_TOL["ssd_chunk"]
SSD_TC_TOL = dict(rtol=1e-5, atol=3e-5)


def _ssd_inputs(b, nc, c, h, p, n, g, xdtype, device, seed,
                bcdtype=torch.float32, valid=None):
    """x in ``xdtype``, B and C in ``bcdtype``; ``valid`` zero-pads the
    tail as `ssd_chunked` pads a ragged length (cum flat there)."""
    r = np.random.default_rng(seed)
    f32 = torch.float32
    x = r.normal(size=(b, nc * c, h, p))
    dt = r.uniform(0.01, 0.2, (b, nc * c, h))
    A = -r.uniform(0.5, 2.0, (h,))
    B, C = r.normal(size=(2, b, nc * c, g, n))
    if valid is not None:
        for a in (x, dt, B, C):
            a[:, valid:] = 0.0
    dt = dt.reshape(b, nc, c, h)
    mk = lambda a, d=f32: torch.tensor(a, dtype=d, device=device)  # noqa
    return (mk(x.reshape(b, nc, c, h, p), xdtype), mk(dt),
            mk(np.cumsum(dt * A, axis=2)),
            mk(B.reshape(b, nc, c, g, n), bcdtype),
            mk(C.reshape(b, nc, c, g, n), bcdtype))


def _run_body(args, body):
    """K5 on ``args``, asserting that it launched once, through ``body``."""
    launches = K5.ssd_chunk.launches
    before = dict(K5.ssd_chunk.body_launches)
    got = K5.ssd_chunk(*args)
    torch.cuda.synchronize()
    assert K5.ssd_chunk.launches == launches + 1
    assert K5.ssd_chunk.body_launches == {
        k: v + (k == body) for k, v in before.items()}
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("b,nc,c,h,p,n,g,xdtype", [
    (1, 8, 256, 48, 64, 128, 1, torch.bfloat16),   # Mamba2-780M, S 2048
    (1, 4, 256, 80, 64, 64, 1, torch.bfloat16),    # Zamba2-2.7B, S 1024
    (1, 8, 256, 48, 64, 128, 1, torch.float32),
    (2, 3, 32, 8, 16, 16, 2, torch.float32),       # smoke shapes, g 2
    (1, 2, 100, 6, 40, 72, 3, torch.bfloat16),     # ragged tiles
])
def test_ssd_chunk_kernel_matches_plain(cuda, b, nc, c, h, p, n, g, xdtype):
    """B and C in f32: the CUDA-core body."""
    args = _ssd_inputs(b, nc, c, h, p, n, g, xdtype, cuda, c + h)
    got = _run_body(args, "cuda_core")
    want = K5.ssd_chunk_plain(*args)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, **F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,nc,c,h,p,n,g", [
    (1, 2, 32, 4, 16, 16, 1),                      # smoke widths
    (1, 2, 100, 6, 40, 72, 3),                     # ragged tiles
])
def test_ssd_chunk_cuda_core_body_takes_bf16_b_and_c(cuda, b, nc, c, h, p,
                                                     n, g):
    """x, B and C in bf16 at shapes outside the wgmma body's class (the
    bf16 smoke models): the CUDA-core body, as for f32 B and C."""
    bf16 = torch.bfloat16
    args = _ssd_inputs(b, nc, c, h, p, n, g, bf16, cuda, c + h + 1,
                       bcdtype=bf16)
    got = _run_body(args, "cuda_core")
    want = K5.ssd_chunk_plain(*args)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, **F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,nc,c,h,p,n,g,valid", [
    (1, 8, 256, 48, 64, 128, 1, None),    # Mamba2-780M, S 2048
    (1, 4, 256, 80, 64, 64, 1, None),     # Zamba2-2.7B, S 1024
    (1, 8, 256, 48, 64, 128, 1, 2000),    # ragged S 2000, padded
    (1, 8, 256, 48, 64, 128, 8, None),    # g 8
    (2, 3, 100, 6, 64, 256, 3, None),     # a ragged tile, n 256, b 2
    (1, 2, 64, 4, 64, 192, 2, None),      # one row tile, n 192
])
def test_ssd_chunk_wgmma_body_matches_plain(cuda, b, nc, c, h, p, n, g,
                                            valid):
    """x, B and C in bf16 (the served dtypes): the wgmma body, within
    the smoke's KERNEL_TOL of the plain version on the same values."""
    bf16 = torch.bfloat16
    args = _ssd_inputs(b, nc, c, h, p, n, g, bf16, cuda, c + h + g,
                       bcdtype=bf16, valid=valid)
    got = _run_body(args, "wgmma")
    want = K5.ssd_chunk_plain(*args)
    for a, w in zip(got, want):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, w, **SSD_TC_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("xdtype", [torch.bfloat16, torch.float32])
def test_ssd_chunk_large_decay_finite_on_card(cuda, xdtype):
    """cum down to about -560 over a chunk of 256 (dt 0.8, A = -e): no
    decay overflows and no weight's split turns into a NaN, in both
    bodies."""
    args = list(_ssd_inputs(1, 2, 256, 4, 64, 128, 1, xdtype, cuda, 3,
                            bcdtype=xdtype))
    args[1] = torch.full_like(args[1], 0.8)
    args[2] = torch.cumsum(args[1] * -np.e, dim=2)
    assert args[2].min() < -500
    body = "wgmma" if xdtype == torch.bfloat16 else "cuda_core"
    got = _run_body(args, body)
    want = K5.ssd_chunk_plain(*args)
    for a, w in zip(got, want):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, w, **SSD_TC_TOL)


@pytest.mark.cuda
def test_ssd_chunked_ragged_on_card_matches_cpu(cuda):
    """S = 2000 at Mamba2-780M's widths, padded to 8 chunks of 256. The
    card runs the f32 inputs; the CPU side, the oracle, runs the same
    numpy inputs in f64 (cast to f32 for the comparison): an f32 oracle
    on the CPU was itself up to 1.96e-3 from f64 in some first calls,
    where the card's output is 8.15e-5 from it."""
    from repro_torch.models.mamba import ssd_chunked
    r = np.random.default_rng(0)
    l, h, p, n = 2000, 48, 64, 128
    x = r.normal(size=(1, l, h, p))
    dt = r.uniform(0.01, 0.2, (1, l, h))
    A = -r.uniform(0.5, 2.0, (h,))
    B, C = r.normal(size=(2, 1, l, 1, n))
    outs = []
    for dev, dtype in (("cpu", torch.float64), (cuda, torch.float32)):
        t = [torch.tensor(a, dtype=dtype, device=dev)
             for a in (x, dt, A, B, C)]
        outs.append([o.cpu().to(torch.float32)
                     for o in ssd_chunked(*t, chunk=256)])
    for a, w in zip(outs[1], outs[0]):
        torch.testing.assert_close(a, w, **F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_ssd_chunk_bodies_repeat_bitwise(cuda, xdtype):
    """K5 called 20 times on the same inputs gives the same bits, through
    the CUDA-core body (f32, the shape of
    test_ssd_chunked_ragged_on_card_matches_cpu: 8 chunks of 256, 48
    heads of 64, state 128) and the wgmma body (x, B and C bf16, the
    same shape: Mamba2-780M's served one)."""
    args = _ssd_inputs(1, 8, 256, 48, 64, 128, 1, xdtype, cuda, 0,
                       bcdtype=xdtype, valid=2000)
    body = "wgmma" if xdtype == torch.bfloat16 else "cuda_core"
    first = [o.clone() for o in _run_body(args, body)]
    for _ in range(19):
        got = K5.ssd_chunk(*args)
        torch.cuda.synchronize()
        for a, w in zip(got, first):
            assert torch.equal(a, w)


# DeepSeek-V3's published head dims at the smoke size (chip_smoke's MLA
# model_parity rows): K2 at (192, 128), K3-mla at (512, 64)
MLA_HEADS = dict(qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
                 kv_lora_rank=512, head_dim=192)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-4b", "mamba2-780m", "zamba2-2.7b",
                                  "deepseek-moe-16b", "deepseek-v3-671b"])
def test_model_on_card_matches_cpu(cuda, arch):
    """The smoke-size model through the kernels on the card against the
    same weights through the plain versions on the CPU (f32);
    deepseek-v3-671b with its published head dims (its decode through
    K3-mla; unverified until a run on an H100 passes)."""
    cfg = get_arch(arch).smoke()
    if cfg.mla:
        cfg = cfg.replace(**MLA_HEADS)
    cpu = build_model(cfg, "cpu").init_weights(
        torch.Generator().manual_seed(0))
    card = build_model(cfg, cuda)
    card.load_state_dict(cpu.state_dict())
    toks = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 70)))
    attn = cfg.family != "ssm"
    launches = (FA.flash_attention.launches, DA.decode_attention.launches,
                K5.ssd_chunk.launches)
    mla_launches = DA.mla_decode_attention.launches
    outs = []
    for m, dev in ((cpu, "cpu"), (card, cuda)):
        cache = m.cache_spec(2, 80).zeros(dev)
        lg, cache = m.prefill({"tokens": toks.to(dev)}, cache)
        steps = [lg]
        for i in range(3):
            lg, cache = m.decode_step(toks[:, i:i + 1].to(dev), cache)
            steps.append(lg)
        outs.append([s.cpu() for s in steps])
    assert (FA.flash_attention.launches > launches[0]) == attn
    assert (DA.decode_attention.launches > launches[1]) == (
        attn and not cfg.mla)
    assert (DA.mla_decode_attention.launches > mla_launches) == cfg.mla
    assert (K5.ssd_chunk.launches > launches[2]) == (
        cfg.family in ("ssm", "hybrid"))
    for a, b in zip(*outs):
        torch.testing.assert_close(b, a, rtol=2e-4, atol=2e-4)


# ------------------------------------------- the training path's kernels
# The backward kernels against their plain backwards (autograd through
# the plain forwards), chip_smoke.py's limits: bf16 outputs rounded once
# by the kernel (rtol 1e-2) after f32 sums in another order (atol 1e-3),
# K2's backward also reading the forward's output o rounded to bf16
# (2^-9 of `FA.backward_o_terms`) and rounding P and dS to bf16 for its
# tensor-core products (2^-8 of `FA.backward_round_terms`); f32 at
# F32_TOL. Each case also holds a planted fault that the limit must
# reject, and two runs bitwise equal.
O_ROUND = 2.0 ** -9


def _use(got, want, tol, extra=None):
    g, w = got.float(), want.float()
    lim = tol["atol"] + tol["rtol"] * w.abs()
    if extra is not None:
        lim = lim + extra
    return ((g - w).abs() / lim).max().item()


def _grads_f32(fn, inputs, g):
    xs = [x.detach().float().requires_grad_() for x in inputs]
    with torch.enable_grad():
        return torch.autograd.grad(fn(*xs), xs, g.float())


BF = torch.bfloat16


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KVH,D,dtype,causal", [
    (2, 200, 4, 2, 32, torch.float32, True),
    (1, 130, 4, 4, 64, torch.float32, True),
    (2, 64, 8, 1, 128, torch.float32, True),    # G = 8, one tile
    (1, 1024, 32, 8, 128, BF, True),            # Qwen3-4B
    (4, 1024, 32, 8, 128, BF, True),            # the train phase's B
    (2, 1000, 32, 8, 128, BF, True),            # a ragged tile
    (1, 300, 4, 2, 32, BF, True),
    (1, 129, 8, 4, 64, BF, True),
    (1, 1000, 8, 8, 128, BF, True),             # G = 1
    (1, 300, 8, 1, 64, BF, True),               # G = 8
    (1, 129, 8, 2, 32, BF, True),               # G = 4
    (2, 1000, 32, 8, 128, BF, False),           # bidirectional
    (1, 300, 4, 4, 64, BF, False),
    (1, 129, 8, 1, 32, BF, False),
    (4, 1024, 32, 32, 80, BF, True),            # Zamba2's shared block
    (1, 300, 8, 2, 80, BF, True),
    (1, 200, 4, 4, 80, BF, False),
    (1, 130, 4, 2, 80, torch.float32, True),
    (1, 100, 4, 4, 80, torch.float32, False),
])
def test_flash_attention_backward_kernel_matches_plain(cuda, B, S, H, KVH,
                                                       D, dtype, causal):
    q, do = (_bf16_or_f32((B, S, H, D), dtype, s, cuda) for s in (10, 11))
    k, v = (_bf16_or_f32((B, S, KVH, D), dtype, s, cuda) for s in (12, 13))
    o = FA.flash_attention_plain(q, k, v, causal=causal).contiguous()
    _, lse = FA._forward(q, k, v, causal, None, True)
    launches = FA.flash_attention_backward.launches
    got = FA.flash_attention_backward(q, k, v, o, do, lse, causal=causal)
    again = FA.flash_attention_backward(q, k, v, o, do, lse, causal=causal)
    torch.cuda.synchronize()
    assert FA.flash_attention_backward.launches == launches + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = _grads_f32(lambda a, b, c: FA.flash_attention_plain(
        a, b, c, causal=causal), (q, k, v), do)
    pos = torch.arange(S, device=cuda)
    allowed = ~((pos >= S // 2) & (pos < S // 2 + 64))[None, :]
    if causal:
        allowed = allowed & (pos[:, None] >= pos[None, :])

    def dropped(a, b, c):
        g = a.shape[2] // b.shape[2]
        s = torch.einsum("bshd,bthd->bhst", a, b.repeat_interleave(g, 2)) \
            / D ** 0.5
        p = torch.softmax(s.masked_fill(~allowed, float("-inf")), -1)
        return torch.einsum("bhst,bthd->bshd", p, c.repeat_interleave(g, 2))
    fault = _grads_f32(dropped, (q, k, v), do)
    if dtype == torch.float32:
        tol, extras = F32_TOL, (None,) * 3
    else:
        tol = BF16_TOL
        extras = [O_ROUND * t + P_ROUND * u for t, u in zip(
            FA.backward_o_terms(q, k, v, o, do, causal=causal),
            FA.backward_round_terms(q, k, v, do, causal=causal))]
    uses = [_use(a, b, tol, x) for a, b, x in zip(got, want, extras)]
    assert max(uses) <= 1.0, uses
    assert max(_use(f, b, tol, x) for f, b, x in zip(fault, want,
                                                      extras)) > 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KVH,D,dtype", [
    (2, 200, 4, 2, 32, torch.float32), (1, 1024, 32, 8, 128, torch.bfloat16),
    (2, 77, 4, 4, 64, torch.bfloat16)])
def test_flash_attention_lse_and_serving_forward(cuda, B, S, H, KVH, D,
                                                 dtype):
    """The forward with the log-sum-exp writes the serving forward's
    output bitwise, and the log-sum-exp of the scaled scores."""
    q = _bf16_or_f32((B, S, H, D), dtype, 20, cuda)
    k, v = (_bf16_or_f32((B, S, KVH, D), dtype, s, cuda) for s in (21, 22))
    out, lse = FA._forward(q, k, v, True, None, True)
    serving = FA.flash_attention(q, k, v)
    s = torch.einsum("bshd,bthd->bhst", q.float(),
                     k.repeat_interleave(H // KVH, 2).float()) / D ** 0.5
    pos = torch.arange(S, device=cuda)
    want = torch.logsumexp(s.masked_fill(~(pos[:, None] >= pos[None, :]),
                                         float("-inf")), -1)
    torch.cuda.synchronize()
    assert torch.equal(out, serving)
    torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("R,D,dtype,residual,with_gres,offset,body", [
    (4096, 2560, torch.bfloat16, False, False, 0, "vector"),
    (4096 * 32, 128, torch.bfloat16, False, False, 0, "vector"),
    (4096 * 8, 128, torch.bfloat16, False, False, 0, "vector"),  # k-norm
    (4096, 2560, torch.bfloat16, True, True, 0, "vector"),
    (4096, 2560, torch.bfloat16, True, False, 0, "vector"),
    (7, 1001, torch.float32, False, False, 0, "general"),
    (33, 3000, torch.float32, True, True, 0, "vector"),
    (100, 96, torch.bfloat16, True, True, 0, "vector"),
    (65, 1001, torch.bfloat16, True, True, 0, "general"),  # an odd width
    (64, 2560, torch.bfloat16, True, True, 1, "general"),  # off 16 bytes
    (300, 128, torch.bfloat16, False, False, 3, "general"),
    (33, 2560, torch.float32, False, False, 0, "vector"),  # 3 vectors
])
def test_rmsnorm_backward_kernels_match_plain(cuda, R, D, dtype, residual,
                                              with_gres, offset, body):
    """``offset``: x is a contiguous view that many elements into its
    buffer (a pointer off 16 bytes: the general body); ``body`` the body
    the plan must pick."""
    x = _bf16_or_f32((R * D + offset,), dtype, 30, cuda)[offset:].view(R, D)
    g = _bf16_or_f32((R, D), dtype, 31, cuda)
    w = (1.0 + 0.1 * _bf16_or_f32((D,), torch.float32, 32, cuda)).to(dtype)
    r = _bf16_or_f32((R, D), dtype, 33, cuda) if residual else None
    gres = _bf16_or_f32((R, D), dtype, 34, cuda) if with_gres else None
    wrapper = RN.rmsnorm_residual_backward if residual else \
        RN.rmsnorm_backward
    launches, bodies = wrapper.launches, dict(RN.bwd_body_launches)
    if residual:
        got = RN.rmsnorm_residual_backward(x, r, w, g, gres)
        again = RN.rmsnorm_residual_backward(x, r, w, g, gres)
        want = RN.rmsnorm_residual_backward_plain(x, r, w, g, gres)
    else:
        got, again = (RN.rmsnorm_backward(x, w, g) for _ in range(2))
        want = RN.rmsnorm_backward_plain(x, w, g)
    torch.cuda.synchronize()
    assert wrapper.launches == launches + 2
    assert RN.bwd_body_launches[body] == bodies[body] + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    # the planted fault: the last D/8 of the row left out of the sum of
    # squares
    s = (x.float() + (0.0 if r is None else r.float())).requires_grad_()
    wf = w.float().requires_grad_()
    with torch.enable_grad():
        var = s[:, :D - D // 8].square().sum(-1, keepdim=True) / D
        dsf, dwf = torch.autograd.grad(s * torch.rsqrt(var + 1e-6) * wf,
                                       (s, wf), g.float())
    if gres is not None:
        dsf = dsf + gres.float()
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    assert max(_use(a, b, tol) for a, b in zip(got, want)) <= 1.0
    assert max(_use(f, b, tol) for f, b in zip((dsf, dwf), want)) > 1.0


@pytest.mark.cuda
def test_model_loss_on_card_matches_cpu(cuda):
    """The dense smoke model's loss and every gradient in f32 on the card
    (K2, K4a, K4b and their backward kernels) against the CPU (their plain
    versions), on the same weights; each kernel launched as the code
    counts (tests/test_torch_train.py)."""
    cfg = get_arch("qwen3-4b").smoke()
    cpu = build_model(cfg, "cpu", trainable=True)
    cpu.init_weights(torch.Generator().manual_seed(0))
    card = build_model(cfg, cuda, trainable=True)
    card.load_state_dict(cpu.state_dict())
    r = np.random.default_rng(0)
    toks = torch.tensor(r.integers(0, cfg.vocab_size, (2, 48)))
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    loss_c, _ = cpu.loss(batch)
    loss_c.backward()
    before = FA.flash_attention_backward.launches
    loss_g, _ = card.loss({k: v.to(cuda) for k, v in batch.items()})
    loss_g.backward()
    torch.cuda.synchronize()
    assert FA.flash_attention_backward.launches == before + cfg.n_layers
    torch.testing.assert_close(loss_g.cpu(), loss_c.detach(), **F32_TOL)
    for (name, pc), pg in zip(cpu.named_parameters(), card.parameters()):
        torch.testing.assert_close(pg.grad.cpu(), pc.grad, rtol=2e-4,
                                   atol=2e-5, msg=name)


# K5's backward against its plain backward (autograd through
# `ssd_chunk_plain` on the card) on the same inputs, widened exactly: the
# f32 sums differ only in order, and an output in bf16 (dx, dB, dC with
# bf16 inputs) is rounded once on each side, so the two may be one bf16
# ulp apart (2^-7 of the value). chip_smoke.py's KERNEL_TOL
# ["ssd_chunk_backward"] states the limit and its measurement.
SSD_BWD_TOL = dict(rtol=1e-5, atol=2e-3, out_round=2.0 ** -7)


def _ssd_bwd_use(got, want, tol):
    g, w = got.float(), want.float()
    lim = tol["atol"] + tol["rtol"] * w.abs()
    if got.dtype == torch.bfloat16:
        lim = lim + tol["out_round"] * w.abs()
    return ((g - w).abs() / lim).max().item()


def _ssd_fault_plain(x, dt, cum, B, C):
    """K5's plain forward without the tile pair s in [64, 128), t in [0,
    64): the planted fault of the backward (a dropped causal tile)."""
    c = x.shape[2]
    keep = torch.ones(c, c, dtype=torch.bool, device=x.device).tril()
    keep[64:128, :64] = False
    h, g = x.shape[3], B.shape[3]
    xf, Bf, Cf = x.float(), B.float(), C.float()
    Bh = Bf.repeat_interleave(h // g, 3)
    Ch = Cf.repeat_interleave(h // g, 3)
    diff = cum[:, :, :, None] - cum[:, :, None]
    diff = diff.masked_fill(~keep[:, :, None], float("-inf"))
    sc = torch.einsum("bcshn,bcthn->bcsth", Ch, Bh)
    y = torch.einsum("bcsth,bcth,bcthp->bcshp", sc * torch.exp(diff), dt, xf)
    w = torch.exp(cum[:, :, -1:] - cum) * dt
    S = torch.einsum("bcthn,bcth,bcthp->bchpn", Bh, w, xf)
    return y, S


@pytest.mark.cuda
@pytest.mark.parametrize("b,nc,c,h,p,n,g,xdtype,bcdtype,valid", [
    (4, 4, 256, 48, 64, 128, 1, BF, BF, None),      # Mamba2-780M, S 1024
    (4, 4, 256, 80, 64, 64, 1, BF, BF, None),       # Zamba2-2.7B, S 1024
    (4, 4, 256, 48, 64, 128, 1, BF, BF, 1000),      # ragged S 1000
    (1, 4, 256, 48, 64, 128, 8, BF, BF, None),      # g 8
    (1, 4, 256, 48, 64, 128, 1, BF, torch.float32, None),
    (1, 2, 256, 8, 64, 128, 2, torch.float32, torch.float32, None),
    (2, 3, 100, 6, 40, 72, 3, torch.float32, torch.float32, None),
    (2, 3, 32, 16, 16, 16, 1, torch.float32, torch.float32, None),  # smoke
])
def test_ssd_chunk_backward_kernel_matches_plain(cuda, b, nc, c, h, p, n, g,
                                                 xdtype, bcdtype, valid):
    """Each output within SSD_BWD_TOL of the plain backward, a dropped
    causal tile rejected (c > 128), two runs bitwise equal; x, B and C in
    bf16 at p = 64, n % 64 == 0 (the training shapes, ragged S 1000, g
    8) on the wgmma body, the rest on the CUDA-core body."""
    _check_ssd_backward(cuda, b, nc, c, h, p, n, g, xdtype, bcdtype, valid)


def _check_ssd_backward(cuda, b, nc, c, h, p, n, g, xdtype, bcdtype, valid):
    args = _ssd_inputs(b, nc, c, h, p, n, g, xdtype, cuda, c + h + g,
                       bcdtype=bcdtype, valid=valid)
    r = np.random.default_rng(n + p)
    dy = torch.tensor(r.normal(size=(b, nc, c, h, p)), dtype=torch.float32,
                      device=cuda)
    dS = torch.tensor(r.normal(size=(b, nc, h, p, n)), dtype=torch.float32,
                      device=cuda)
    body = ("wgmma" if xdtype == BF and bcdtype == BF and p == 64
            and n % 64 == 0 and c <= 256 else "cuda_core")
    launches = K5.ssd_chunk_backward.launches
    before = dict(K5.ssd_chunk_backward.body_launches)
    got = K5.ssd_chunk_backward(*args, dy, dS)
    again = K5.ssd_chunk_backward(*args, dy, dS)
    torch.cuda.synchronize()
    assert K5.ssd_chunk_backward.launches == launches + 2
    assert K5.ssd_chunk_backward.body_launches == {
        k: v + 2 * (k == body) for k, v in before.items()}
    assert all(torch.equal(a, w) for a, w in zip(got, again))
    want = K5.ssd_chunk_backward_plain(*args, dy, dS)
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and a.shape == w.shape
    uses = [_ssd_bwd_use(a, w, SSD_BWD_TOL) for a, w in zip(got, want)]
    assert max(uses) <= 1.0, uses
    if c > 128:
        ins = [t.detach().float().requires_grad_() for t in args]
        with torch.enable_grad():
            y, S = _ssd_fault_plain(*ins)
            fault = torch.autograd.grad((y, S), ins, (dy, dS))
        assert max(_ssd_bwd_use(f.to(w.dtype), w, SSD_BWD_TOL)
                   for f, w in zip(fault, want)) > 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("b,nc,c,h,p,n,g", [
    (1, 2, 100, 12, 64, 64, 1),     # c in part of a tile; slices 8 + 4
    (1, 1, 256, 8, 64, 192, 2),     # n 192: one block an SM
    (1, 1, 200, 3, 64, 256, 3),     # n 256, a head a group
])
def test_ssd_chunk_backward_wgmma_shape_classes(cuda, b, nc, c, h, p, n, g):
    """The wgmma body at the other shapes of its class: each output
    within SSD_BWD_TOL of the plain backward, two runs bitwise equal."""
    _check_ssd_backward(cuda, b, nc, c, h, p, n, g, BF, BF, None)


@pytest.mark.cuda
def test_ssd_chunk_backward_takes_none_gradients(cuda):
    args = _ssd_inputs(1, 2, 64, 4, 16, 16, 1, torch.float32, cuda, 3)
    dy = torch.randn(1, 2, 64, 4, 16, device=cuda)
    got = K5.ssd_chunk_backward(*args, dy, None)
    want = K5.ssd_chunk_backward(*args, dy, torch.zeros(
        1, 2, 4, 16, 16, device=cuda))
    assert all(torch.equal(a, w) for a, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-2.7b"])
def test_ssm_hybrid_loss_on_card_matches_cpu(cuda, arch):
    """The ssm and hybrid smoke models' loss and every gradient in f32 on
    the card (K5 and its backward kernel; K2 and K2-bwd in the shared
    block) against the CPU (their plain versions), on the same weights,
    at three chunks with a ragged tail; each backward kernel launched as
    the code counts (tests/test_torch_train.py)."""
    cfg = get_arch(arch).smoke()
    cpu = build_model(cfg, "cpu", trainable=True)
    cpu.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        m = cpu.blocks.mamba
        m.A_log.copy_(torch.empty_like(m.A_log).uniform_(0.01, 0.1).log())
        m.dt_bias.fill_(-3.0)
    card = build_model(cfg, cuda, trainable=True)
    card.load_state_dict(cpu.state_dict())
    r = np.random.default_rng(0)
    toks = torch.tensor(r.integers(0, cfg.vocab_size, (2, 80)))
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    loss_c, _ = cpu.loss(batch)
    loss_c.backward()
    before = (K5.ssd_chunk_backward.launches,
              FA.flash_attention_backward.launches)
    loss_g, _ = card.loss({k: v.to(cuda) for k, v in batch.items()})
    loss_g.backward()
    torch.cuda.synchronize()
    apps = cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else 0
    assert (K5.ssd_chunk_backward.launches - before[0],
            FA.flash_attention_backward.launches - before[1]) == (
        cfg.n_layers, apps)
    torch.testing.assert_close(loss_g.cpu(), loss_c.detach(), **F32_TOL)
    for (name, pc), pg in zip(cpu.named_parameters(), card.parameters()):
        torch.testing.assert_close(pg.grad.cpu(), pc.grad, rtol=2e-4,
                                   atol=2e-5, msg=name)
