"""The experiment API's scale-out in the port (`repro_torch.api`):
``host_shard`` parts that `ResultSet.merge` joins into the full grid,
bitwise; the partial ResultSets against the JAX package's (the same
cells computed, the same zeros elsewhere); the readers that honour
``computed``; ``devices`` on the CPU (one device) and its validation;
and, on a card, the same sharding through the event-loop kernel.

The JAX package is imported inside the tests that compare against it,
so the card-only cases also run where JAX is absent (``--noconftest``).
"""
import numpy as np
import pytest
import torch

import repro_torch.api as tapi

TRACE = dict(n_functions=8, n_requests=150, seed=5, utilization=0.25)
GRID = dict(policies=("esff", "sff"), capacities=(3, 5), queue_cap=256)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread a test process: the eager loop's ops are tiny,
    and parallel test workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec(**kw):
    return tapi.ExperimentSpec(
        traces=[tapi.SyntheticTrace.make(**TRACE)], **GRID, **kw)


def _jax_spec(**kw):
    japi = pytest.importorskip("repro.api")
    return japi, japi.ExperimentSpec(
        traces=[japi.SyntheticTrace.make(**TRACE)], **GRID, **kw)


@pytest.fixture(scope="module")
def full():
    return tapi.run_experiment(_spec(lane_chunk=1), device="cpu").check()


@pytest.fixture(scope="module")
def parts():
    return [tapi.run_experiment(_spec(lane_chunk=1, host_shard=(i, 3)),
                                device="cpu") for i in range(3)]


def _assert_same(t, j):
    """The port's ResultSet ``t`` against the JAX package's ``j``: the
    same coords and computed mask, and on every metric of the JAX
    package's ints exact, floats within 1e-9."""
    assert t.coords == j.coords
    np.testing.assert_array_equal(t.computed, j.computed)
    assert set(j.data) <= set(t.data)
    for k in j.data:
        a, b = t[k], j[k]
        assert a.shape == b.shape, k
        if b.dtype.kind in "iub":
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=0, err_msg=k)


def test_host_shard_merge_matches_full_run(full, parts):
    """Three hosts' parts: disjoint, each refusing a cell it did not
    compute, merged bitwise the full run (data and ``computed``)."""
    for i, p in enumerate(parts):
        assert not p.computed.all() and p.computed.any()
        assert p.meta["host_shard"] == [i, 3]
        missing = np.argwhere(~p.computed)[0]
        with pytest.raises(ValueError, match="not computed"):
            p.value("mean_response",
                    policy=p.coords["policy"][missing[0]],
                    capacity=p.coords["capacity"][missing[2]])
    for a in range(3):
        for b in range(a + 1, 3):
            assert not (parts[a].computed & parts[b].computed).any()
    merged = parts[0].merge(*parts[1:])
    np.testing.assert_array_equal(merged.computed, full.computed)
    assert merged.computed.all()
    assert sorted(merged.data) == sorted(full.data)
    for k in full.data:
        np.testing.assert_array_equal(merged[k], full[k], err_msg=k)
    with pytest.raises(ValueError, match="more than one shard"):
        parts[0].merge(parts[0])


def test_host_shard_parts_match_jax(parts):
    """Each part is the JAX package's part: the same computed cells, its
    metrics within the parity bar there and the same zeros elsewhere."""
    japi, _ = _jax_spec()
    for i, p in enumerate(parts):
        _, js = _jax_spec(lane_chunk=1, host_shard=(i, 3))
        _assert_same(p, japi.run_experiment(js))


def test_host_shard_with_no_chunks_errors():
    with pytest.raises(ValueError, match="no chunks"):
        tapi.run_experiment(_spec(lane_chunk=64, host_shard=(50, 99)),
                            device="cpu")


def test_readers_honour_computed(parts, tmp_path):
    """`rows` and `to_csv` yield the computed cells only, `check` ignores
    a bad value in a cell that was not computed, and the npz round-trip
    keeps the mask."""
    p = parts[1]
    rows = list(p.rows())
    assert len(rows) == int(p.computed.sum())
    want = {(p.coords["policy"][c[0]], p.coords["capacity"][c[2]])
            for c in np.argwhere(p.computed)}
    assert {(r["policy"], r["capacity"]) for r in rows} == want
    csv = tmp_path / "part.csv"
    p.to_csv(csv)
    assert len(csv.read_text().splitlines()) == 1 + len(rows)
    bad = p.sel()
    bad.data["overflow"] = np.where(bad.computed, 0, 7).astype(
        bad.data["overflow"].dtype)
    bad.check()
    bad.data["overflow"][bad.computed] = 1
    with pytest.raises(RuntimeError, match="overflow"):
        bad.check()
    path = tmp_path / "part.npz"
    p.save_npz(path)
    back = tapi.ResultSet.load_npz(path)
    np.testing.assert_array_equal(back.computed, p.computed)
    for k in p.data:
        np.testing.assert_array_equal(back[k], p[k], err_msg=k)


def test_merge_refuses_other_grids(parts):
    other = tapi.run_experiment(tapi.ExperimentSpec(
        traces=[tapi.SyntheticTrace.make(**TRACE)], policies=("esff",),
        capacities=(3, 5), queue_cap=256, lane_chunk=1, host_shard=(0, 3)),
        device="cpu")
    with pytest.raises(ValueError, match="coords differ"):
        parts[1].merge(other)
    fewer = parts[2].sel()
    del fewer.data["cold_time"]
    with pytest.raises(ValueError, match="metric sets differ"):
        parts[1].merge(fewer)


def test_devices_on_the_cpu(full):
    """The CPU is one device: ``devices=1`` is bitwise the default run
    and the meta says so; more devices than there are raises."""
    one = tapi.run_experiment(_spec(lane_chunk=1, devices=1), device="cpu")
    assert one.meta["n_devices"] == 1 == full.meta["n_devices"]
    assert full.meta["host_shard"] == [0, 1]
    for k in full.data:
        np.testing.assert_array_equal(one[k], full[k], err_msg=k)
    with pytest.raises(ValueError, match="only 1 local device"):
        tapi.run_experiment(_spec(devices=2), device="cpu")


@pytest.mark.parametrize("kw,match", [
    (dict(host_shard=(3, 2)), "0 <= i < n"),
    (dict(host_shard=(0, 0)), "0 <= i < n"),
    (dict(host_shard=(-1, 2)), "0 <= i < n"),
    (dict(devices=0), "devices must be >= 1"),
    (dict(trace_events=True, host_shard=(1, 2)), "host_shard must stay"),
    (dict(trace_events=True, devices=2), "devices must be None or 1"),
    (dict(cluster=[None], host_shard=(0, 2)),
     "cluster runs do not support host_shard"),
    (dict(cluster=[None], devices=2), "cluster runs execute on the "
     "default device"),
])
def test_scale_out_validation_matches_jax(kw, match):
    """The JAX package's validation of ``host_shard`` and ``devices``,
    the traced rule and the cluster rule, message for message."""
    with pytest.raises(ValueError, match=match):
        _spec(**kw).validate()
    _, js = _jax_spec(**kw)
    with pytest.raises(ValueError, match=match):
        js.validate()


def test_valid_scale_out_fields_pass():
    for kw in (dict(host_shard=(1, 2)), dict(devices=1), dict(devices=4),
               dict(cluster=[None], devices=1), dict(trace_events=True,
                                                     devices=1)):
        _spec(**kw).validate()


@pytest.mark.cuda
def test_host_shard_merge_on_the_card():
    """On a card: three parts through the event-loop kernel merge
    bitwise to the full run; ``devices=1`` is bitwise the default, and
    more devices than the host has raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    full = tapi.run_experiment(_spec(lane_chunk=1), device="cuda").check()
    parts = [tapi.run_experiment(_spec(lane_chunk=1, host_shard=(i, 3)),
                                 device="cuda") for i in range(3)]
    merged = parts[0].merge(*parts[1:])
    np.testing.assert_array_equal(merged.computed, full.computed)
    for k in full.data:
        np.testing.assert_array_equal(merged[k], full[k], err_msg=k)
    one = tapi.run_experiment(_spec(lane_chunk=1, devices=1),
                              device="cuda")
    for k in full.data:
        np.testing.assert_array_equal(one[k], full[k], err_msg=k)
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match="local device"):
        tapi.run_experiment(_spec(devices=n + 1), device="cuda")
