"""The small modules of the port's main path against their JAX-package
counterparts on the same inputs: SSFS (the paper's offline optimum, §IV)
against `repro.core.ssfs` and its brute force, the scenario config
``paper_edge``, the windowed trace generator, the ESFF simulator facade
(against `repro.core.jax_sim`: counters exact, completions within rtol
1e-9) and `NpzTrace` on an npz written to a temporary directory."""
import numpy as np
import pytest
import torch

import repro.api as japi
import repro.core.ssfs as jssfs
import repro_torch.api as tapi
from repro.configs.registry import get_arch as jax_get_arch
from repro.core.jax_sim import simulate_esff_jax as jax_esff
from repro.core.jax_sim import simulate_jax_from_trace as jax_from_trace
from repro.traces import synth_azure_trace
from repro.traces import synth_azure_windows as jax_windows
from repro_torch.configs import get_arch
from repro_torch.core import sim, ssfs
from repro_torch.core.request import Trace
from repro_torch.traces import synth_azure_arrays, synth_azure_windows


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The eager loop's ops are tiny: one intra-op thread a test process
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


COLS = ("fn_id", "arrival", "exec_time", "cold_start", "evict")


def _instances(seed, count):
    rng = np.random.default_rng(seed)
    for _ in range(count):
        k = int(rng.integers(1, 4))
        ns = rng.integers(1, 4, k)
        while ns.sum() > 7:              # brute force is factorial
            ns[int(np.argmax(ns))] -= 1
        yield [(i, int(n), float(rng.uniform(0.01, 10)),
                float(rng.uniform(0, 3)), float(rng.uniform(0, 3)))
               for i, n in enumerate(ns)]


def test_ssfs_matches_the_jax_package_and_brute_force():
    for rows in _instances(0, 40):
        mine = [ssfs.SSFSFunction(*r) for r in rows]
        ref = [jssfs.SSFSFunction(*r) for r in rows]
        assert [f.weight for f in mine] == [f.weight for f in ref]
        order, cost = ssfs.ssfs_schedule(mine)
        assert (order, cost) == jssfs.ssfs_schedule(ref)
        seq, best = ssfs.brute_force_best(mine)
        assert best == jssfs.brute_force_best(ref)[1]
        assert ssfs.sequence_cost(mine, seq) == best
        assert cost == pytest.approx(best, rel=1e-9, abs=1e-9)
        expanded = [f for f in order for _ in range(rows[f][1])]
        assert ssfs.sequence_cost(mine, expanded) == \
            pytest.approx(cost, rel=1e-9)


def test_paper_edge_is_the_jax_packages():
    a, b = get_arch("paper_edge"), jax_get_arch("paper_edge")
    assert type(a).__name__ == type(b).__name__ == "EdgeServingConfig"
    assert {k: getattr(a, k) for k in a.__dataclass_fields__} == \
        {k: getattr(b, k) for k in b.__dataclass_fields__}
    assert a.n_requests == 60_000 and a.capacities[0] == 8


@pytest.mark.parametrize("window", [64, 500, 4096])
def test_synth_azure_windows_concatenate_to_the_arrays(window):
    kw = dict(n_functions=15, n_requests=1000, seed=4, utilization=0.3)
    whole = synth_azure_arrays(**kw)
    wins = list(synth_azure_windows(window=window, **kw))
    assert [w["base"] for w in wins] == list(range(0, 1000, window))
    for k in ("fn_id", "arrival", "exec_time"):
        np.testing.assert_array_equal(
            np.concatenate([w[k] for w in wins]), whole[k])
    for w, j in zip(wins, jax_windows(window=window, **kw)):
        assert w["base"] == j["base"]
        for k in COLS:
            np.testing.assert_array_equal(w[k], j[k], err_msg=k)


@pytest.mark.parametrize("capacity,beta", [(4, 1.0), (8, 2.0)])
def test_sim_facade_matches_jax(capacity, beta):
    tr = synth_azure_trace(n_functions=20, n_requests=300, seed=2,
                           utilization=0.25)
    a = tr.to_arrays()
    kw = dict(n_fns=20, capacity=capacity, queue_cap=512, beta=beta)
    jx = {k: np.asarray(v) for k, v in
          jax_esff(*(a[k] for k in COLS), **kw).items()}
    pt = {k: v.numpy() for k, v in
          sim.simulate_esff_jax(*(a[k] for k in COLS), device="cpu",
                                **kw).items()}
    assert sim.simulate_esff_jax is sim.simulate_esff
    for k in ("cold_starts", "evictions", "overflow", "stalled", "done",
              "resp_hist"):
        np.testing.assert_array_equal(pt[k], jx[k], err_msg=k)
    for k in ("completion", "start", "resp_sum"):
        np.testing.assert_allclose(pt[k], jx[k], rtol=1e-9, atol=1e-9)
    mine = sim.simulate_jax_from_trace(Trace.from_arrays(a), capacity,
                                       beta=beta, device="cpu")
    ref = jax_from_trace(tr, capacity, beta=beta)
    np.testing.assert_allclose(mine["response"], ref["response"],
                               rtol=1e-9, atol=1e-9)
    assert mine["mean_response"] == pytest.approx(ref["mean_response"],
                                                  rel=1e-9)


def test_npz_trace(tmp_path):
    tr = synth_azure_trace(n_functions=10, n_requests=200, seed=1)
    path = str(tmp_path / "slice.npz")
    Trace.from_arrays(tr.to_arrays()).save_npz(path)
    src = tapi.as_trace_source(path)
    assert isinstance(src, tapi.NpzTrace)
    assert src.label == japi.NpzTrace(path=path).label == "npz[slice.npz]"
    mine, ref = src.arrays(), japi.NpzTrace(path=path).arrays()
    for k in COLS:
        np.testing.assert_array_equal(mine[k], ref[k], err_msg=k)
    kw = dict(policies=("esff",), capacities=(4,), queue_cap=512,
              device="cpu")
    rs = tapi.run_experiment(tapi.ExperimentSpec(traces=path, **kw))
    inline = tapi.run_experiment(tapi.ExperimentSpec(
        traces=[tapi.ArrayTrace.from_arrays(tr.to_arrays())], **kw))
    assert rs.coords["trace"] == ["npz[slice.npz]"]
    for m in inline.metrics:
        np.testing.assert_array_equal(rs[m], inline[m], err_msg=m)
    with pytest.raises(FileNotFoundError, match="no npz"):
        tapi.NpzTrace(path=str(tmp_path / "missing.npz")).arrays()
