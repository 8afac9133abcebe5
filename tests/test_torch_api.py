"""The port's experiment API (`repro_torch.api`) against `repro.api`:
the same spec fields give equal coords and equal metrics (ints exact,
floats rtol 1e-9), the trace generator is bitwise the JAX package's,
and the ResultSet round-trips through npz."""
from dataclasses import replace

import numpy as np
import pytest
import torch

import repro.api as japi
import repro_torch.api as tapi
from repro.traces import synth_azure_arrays as j_synth
from repro_torch.traces import synth_azure_arrays as t_synth


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The eager loop's ops are tiny: one intra-op thread a test process
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TRACE = dict(n_functions=20, n_requests=250, seed=0, utilization=0.25)


def _run_both(**fields):
    j = japi.run_experiment(japi.ExperimentSpec(
        traces=[japi.SyntheticTrace.make(**TRACE)], **fields))
    t = tapi.run_experiment(tapi.ExperimentSpec(
        traces=[tapi.SyntheticTrace.make(**TRACE)], **fields),
        device="cpu")
    return j, t


def _assert_same(j, t):
    assert t.coords == j.coords
    for k in j.metrics:
        a, b = t[k], j[k]
        assert a.shape == b.shape, k
        if b.dtype.kind in "iub":
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=0,
                                       err_msg=k)


@pytest.mark.parametrize("stream", [True, False])
def test_run_experiment_matches_jax(stream):
    fields = dict(policies=("esff",), capacities=(4, 8), seeds=(0, 1),
                  queue_cap=256, stream=stream,
                  keep_per_request=not stream)
    j, t = _run_both(**fields)
    t.check()
    assert t["done"].min() == TRACE["n_requests"]
    _assert_same(j, t)


def test_array_trace_from_jax_arrays():
    """One trace fed to both packages through its columnar dict."""
    src = japi.SyntheticTrace.make(**TRACE)
    fields = dict(policies=("esff",), capacities=(6,), queue_cap=256)
    j = japi.run_experiment(japi.ExperimentSpec(traces=[src], **fields))
    t = tapi.run_experiment(tapi.ExperimentSpec(
        traces=[tapi.ArrayTrace.from_arrays(src.arrays(), src.label)],
        **fields), device="cpu")
    _assert_same(j, t)


@pytest.mark.parametrize("kw", [
    dict(n_functions=30, n_requests=500, seed=3),
    dict(n_functions=200, n_requests=5000, seed=0, utilization=0.2,
         exec_median=0.1, exec_sigma=1.4, burst_frac=0.3)])
def test_synth_azure_arrays_bitwise_equal(kw):
    a, b = j_synth(**kw), t_synth(**kw)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_result_set_npz_round_trip(tmp_path):
    rs = tapi.run_experiment(tapi.ExperimentSpec(
        traces=[tapi.SyntheticTrace.make(n_functions=8, n_requests=60)],
        capacities=(2, 3), queue_cap=64), device="cpu")
    path = tmp_path / "grid.npz"
    rs.save_npz(path)
    back = tapi.ResultSet.load_npz(path)
    assert back.coords == rs.coords and back.meta == rs.meta
    assert back.metrics == rs.metrics
    for k in rs.metrics:
        np.testing.assert_array_equal(back[k], rs[k])
    assert back.value("cold_starts", capacity=3) == \
        rs.value("cold_starts", capacity=3)
    rows = list(back.rows())
    assert [r["capacity"] for r in rows] == [2, 3]


@pytest.mark.parametrize("field,value", [
    ("timeouts", 1.0), ("fail_seed", 3), ("retry", tapi.RetryPolicy(2)),
    ("fail_prob", 0.1), ("on_overflow", "shed"), ("devices", 2),
    ("host_shard", (0, 2)), ("trace_events", True)])
def test_unported_spec_field_raises(field, value):
    """Every field of the JAX package's spec is ported and acts as there:
    the resilience layer's fields run, and a run with faults conserves
    its requests; a traced run attaches its event streams, its metrics the
    untraced run's; ``devices=2`` raises on the CPU (one device), and
    ``host_shard=(0, 2)`` runs the grid's one chunk on host 0."""
    kw = {field: value}
    if field == "retry":        # a retry policy needs a fault to act on
        kw["fail_prob"] = 0.1
    spec = tapi.ExperimentSpec(
        traces=[tapi.SyntheticTrace.make(n_functions=4, n_requests=10)],
        capacities=(2,), **kw)
    if field == "devices":
        with pytest.raises(ValueError, match="only 1 local device"):
            tapi.run_experiment(spec, device="cpu")
        return
    rs = tapi.run_experiment(spec, device="cpu").check()
    if field == "host_shard":
        assert rs.computed.all() and rs.meta["host_shard"] == [0, 2]
    if field == "trace_events":
        from dataclasses import replace
        plain = tapi.run_experiment(replace(spec, trace_events=False),
                                    device="cpu")
        assert plain.trace is None and rs.trace is not None
        assert sorted(rs.data) == sorted(plain.data)
        for k in plain.data:
            np.testing.assert_array_equal(rs[k], plain[k], err_msg=k)
        assert rs.trace.n_events == int(rs["n_events"].sum())
    if spec.resilience_active():
        tot = rs["done"] + rs["shed"] + rs["failed_exhausted"]
        assert (tot == 10).all() and "goodput" in rs.data
    else:
        assert int(rs.value("done")) == 10 and "shed" not in rs.data


@pytest.mark.parametrize("field,value", [("devices", 2),
                                         ("host_shard", (0, 2))])
def test_scale_out_fields_name_their_item(field, value):
    """``devices`` and ``host_shard`` are the experiment API's scale-out:
    the spec takes them as the JAX package's does, and a run refuses
    what the host cannot give (a second device on the CPU; a shard of a
    one-chunk grid that gets no chunk), with the JAX package's words."""
    spec = tapi.ExperimentSpec(
        traces=[tapi.SyntheticTrace.make(n_functions=4, n_requests=10)],
        **{field: value})
    spec.validate()
    japi.ExperimentSpec(
        traces=[japi.SyntheticTrace.make(n_functions=4, n_requests=10)],
        **{field: value}).validate()
    shard = dict(devices="local device", host_shard="no chunks")
    with pytest.raises(ValueError, match=shard[field]):
        tapi.run_experiment(replace(spec, host_shard=(1, 2))
                            if field == "host_shard" else spec,
                            device="cpu")


def test_unported_policy_raises():
    """Every policy of the JAX package is registered in the port, with
    the same default beta; a name the JAX package lacks raises."""
    from repro.core.jax_policies import KERNELS as JAX_KERNELS
    assert set(tapi.available_policies()) >= set(JAX_KERNELS)
    for name, k in JAX_KERNELS.items():
        assert tapi.get_kernel(name).default_beta == k.default_beta, name
    spec = tapi.ExperimentSpec(
        traces=[tapi.SyntheticTrace.make(n_functions=4, n_requests=10)],
        policies=tuple(JAX_KERNELS))
    spec.validate()
    spec.policies = ("sff", "lru_only")
    with pytest.raises(KeyError, match="lru_only"):
        spec.validate()


def test_register_policy_joins_the_spec():
    from repro_torch.core.policies import ESFFKernel
    k = tapi.register_policy("esff_copy", ESFFKernel("esff_copy"))
    try:
        assert "esff_copy" in tapi.available_policies()
        assert tapi.get_kernel("esff_copy") is k
        with pytest.raises(ValueError, match="already registered"):
            tapi.register_policy("esff_copy", k)
        with pytest.raises(TypeError):
            tapi.register_policy("bad", object())
        tapi.ExperimentSpec(
            traces=[tapi.SyntheticTrace.make(n_functions=4,
                                             n_requests=10)],
            policies=("esff", "esff_copy")).validate()
    finally:
        tapi.unregister_policy("esff_copy")
    with pytest.raises(KeyError):
        tapi.get_kernel("esff_copy")
