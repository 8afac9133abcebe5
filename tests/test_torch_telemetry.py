"""The port's telemetry (`repro_torch.telemetry`, `ExperimentSpec(
trace_events=True)`) against the JAX package's (`repro.telemetry`) on
tests/test_telemetry.py's trace: the single node's traced runs event for
event, every field (integers exact; times within 1e-9, bitwise
expected), each policy in stream mode and ESFF in exact mode; tracing
leaves every metric bitwise; conservation and the span model; the
exporters (Perfetto, timeline, CSV, Prometheus, summary) equal to the JAX
functions' on the same stream; the TraceRun npz round trip; the sink and
the merge; the profiling hooks; the spec's rules. The cluster tiers are
tests/test_torch_telemetry_cluster.py's. On the CPU the traced runs go
through the eager loops (the event-loop kernel's plain version)."""
import json

import numpy as np
import pytest
import torch

import repro.api as japi
import repro.telemetry as jtel
import repro_torch.api as tapi
import repro_torch.telemetry as ttel
from repro_torch.telemetry import TraceKind, rail
from torch_telemetry_cases import assert_streams_match

SRC = dict(n_functions=12, n_requests=400, seed=3, utilization=0.25)
N = 400
POLICIES = ("esff", "esff_h", "sff", "openwhisk", "faascache",
            "openwhisk_v2")
BASE = dict(capacities=(3,), queue_cap=64, stream=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The eager loop's ops are tiny: one intra-op thread a test process
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(**kw):
    """The same traced spec through the JAX package and the port (CPU)."""
    jx = japi.run_experiment(japi.ExperimentSpec(
        traces=[japi.SyntheticTrace.make(**SRC)], trace_events=True, **kw))
    pt = tapi.run_experiment(tapi.ExperimentSpec(
        traces=[tapi.SyntheticTrace.make(**SRC)], trace_events=True,
        device="cpu", **kw))
    return jx, pt


@pytest.fixture(scope="module")
def single():
    return _both(policies=POLICIES, **BASE)


@pytest.fixture(scope="module")
def pair():
    """ESFF and SFF, traced and untraced through the port, and the JAX
    package's traced run (tests/test_telemetry.py's conservation case)."""
    kw = dict(policies=("esff", "sff"), **BASE)
    jx, pt = _both(**kw)
    plain = tapi.run_experiment(tapi.ExperimentSpec(
        traces=[tapi.SyntheticTrace.make(**SRC)], device="cpu", **kw))
    return jx, pt, plain


@pytest.mark.parametrize("policy", POLICIES)
def test_single_node_event_for_event(single, policy):
    jx, pt = single
    assert_streams_match(jx.trace, pt.trace)
    ev = pt.trace.events(policy=policy)
    assert (ev["node"] == -1).all()
    assert len(ev["kind"]) == int(pt.value("n_events", policy=policy))
    assert ev["seq"].tolist() == list(range(1, len(ev["kind"]) + 1))


def test_single_node_exact_mode_event_for_event():
    jx, pt = _both(policies=("esff",), capacities=(3,), queue_cap=64,
                   stream=False, keep_per_request=True)
    assert_streams_match(jx.trace, pt.trace)


def test_tracing_is_free_single_node(pair):
    _, pt, plain = pair
    assert plain.trace is None and pt.trace is not None
    assert sorted(pt.data) == sorted(plain.data)
    for m in plain.data:
        np.testing.assert_array_equal(pt[m], plain[m], err_msg=m)
    assert pt.meta["trace_events"] and not plain.meta["trace_events"]


def test_event_conservation_and_spans(pair):
    """As tests/test_telemetry.py's: one ARRIVAL a request, one EXEC a
    completion, one COLD a cold start; the spans reproduce resp_sum."""
    jx, pt, plain = pair
    assert_streams_match(jx.trace, pt.trace)
    for pol in ("esff", "sff"):
        ev = pt.trace.events(policy=pol)
        done = int(plain.value("done", policy=pol))
        assert int((ev["kind"] == TraceKind.ARRIVAL).sum()) == N
        assert int((ev["kind"] == TraceKind.EXEC).sum()) == done
        assert int((ev["kind"] == TraceKind.COLD).sum()) == int(
            plain.value("cold_starts", policy=pol))
        spans = pt.trace.spans(policy=pol)
        comp = [s for s in spans.values() if s.completion >= 0]
        assert len(comp) == done
        np.testing.assert_allclose(
            float(np.sum([s.response for s in comp])),
            float(plain.value("resp_sum", policy=pol)), rtol=1e-9)
        assert all(0 <= s.rid < N and 0 <= s.fn < 12 for s in comp)
        js = jx.trace.spans(policy=pol)
        assert sorted(js) == sorted(spans)
        for r, s in spans.items():
            assert vars(s) == vars(js[r]), r


def test_exporters_match_jax(pair, tmp_path):
    """events_to_trace, timeline (and ResultSet.timeline), timeline_to_csv,
    to_prometheus and events_summary: the JAX functions' output on the
    same stream."""
    jx, pt, _ = pair
    ev = pt.trace.events(policy="esff")
    jev = jx.trace.events(policy="esff")
    tr = ttel.events_to_trace(ev, label="x")
    assert json.dumps(tr) == json.dumps(jtel.events_to_trace(jev,
                                                             label="x"))
    assert ttel.validate_trace(tr) == jtel.validate_trace(tr) > N
    deadlines = np.full(12, 0.5)
    tl = ttel.timeline(ev, bucket=30.0, capacity=3, deadlines=deadlines)
    jtl = jtel.timeline(jev, bucket=30.0, capacity=3, deadlines=deadlines)
    assert sorted(tl) == sorted(jtl)
    for k in jtl:
        np.testing.assert_array_equal(tl[k], jtl[k], err_msg=k)
    rtl = pt.timeline(30.0, policy="esff")
    jrtl = jx.timeline(30.0, policy="esff")
    for k in jrtl:
        np.testing.assert_array_equal(rtl[k], jrtl[k], err_msg=k)
    ttel.timeline_to_csv(tl, tmp_path / "t.csv")
    jtel.timeline_to_csv(jtl, tmp_path / "j.csv")
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()
    assert ttel.events_summary(ev) == jtel.events_summary(jev)
    prom = ttel.to_prometheus(ev, tl=tl, labels={"policy": "esff"})
    assert prom == jtel.to_prometheus(jev, tl=jtl,
                                      labels={"policy": "esff"})
    ttel.save_trace(ev, tmp_path / "t.json")
    from repro_torch.telemetry.perfetto import load_trace
    assert load_trace(tmp_path / "t.json") == json.loads(
        json.dumps(jtel.events_to_trace(jev)))


def test_timeline_needs_a_traced_run(pair):
    _, _, plain = pair
    with pytest.raises(ValueError, match="trace_events"):
        plain.timeline(60.0, policy="esff")


def test_trace_run_npz_round_trip(pair, tmp_path):
    _, pt, _ = pair
    path = tmp_path / "trace.npz"
    pt.trace.save_npz(path)
    back = ttel.TraceRun.load_npz(path)
    assert back.coords == pt.trace.coords
    assert sorted(back.cells) == sorted(pt.trace.cells)
    for key, ev in pt.trace.cells.items():
        for f, v in ev.items():
            np.testing.assert_array_equal(back.cells[key][f], v)
    assert back.n_events == pt.trace.n_events
    assert "TraceRun(" in repr(back)
    # the ResultSet's own npz leaves the streams out, as the JAX package's
    pt.save_npz(tmp_path / "rs.npz")
    assert tapi.ResultSet.load_npz(tmp_path / "rs.npz").trace is None


def test_sink_blocks_lanes_and_merge():
    """Dense blocks (the eager loops') and per-lane windows (a traced
    launch's) read back in order with unused rows dropped; merge_events
    is the JAX package's stable (time, seq) merge; a scope's sink is the
    active one only inside it."""
    rng = np.random.default_rng(0)
    blk_i = rng.integers(0, 5, (2, 4, rail.TR_RI)).astype(np.int32)
    blk_i[0, 1, rail.TR_KIND] = -1
    blk_f = rng.random((2, 4, rail.TR_RF))
    win_i = rng.integers(0, 5, (5, rail.TR_RI)).astype(np.int32)
    win_f = rng.random((5, rail.TR_RF))
    with rail.collect() as sink:
        assert rail.active_sink() is sink
        sink.append(blk_i, blk_f)
        sink.append_lanes(win_i, win_f, [0, 2, 5])
    assert rail.active_sink() is None
    assert sink.n_lanes == 2
    e0, e1 = sink.lane_events(0), sink.lane_events(1)
    np.testing.assert_array_equal(
        e0["kind"], np.r_[blk_i[0, [0, 2, 3], 0], win_i[:2, 0]])
    np.testing.assert_array_equal(e1["t"], np.r_[blk_f[1, :, 0],
                                                 win_f[2:, 0]])
    evs = []
    for k in range(3):
        n = 6
        evs.append({f: rng.integers(0, 4, n).astype(np.int32)
                    for f in rail._FIELDS_I})
        evs[-1].update(t=np.round(rng.random(n), 1), dt=rng.random(n))
    got, want = rail.merge_events(evs), jtel.merge_events(evs)
    for f in want:
        np.testing.assert_array_equal(got[f], want[f])
    empty = rail.merge_events([])
    assert all(len(v) == 0 for v in empty.values())


def test_kernel_rail_codes_are_the_sinks():
    """The event-loop kernel's trace kinds and record widths (csrc/
    event_loop.cu) are `TraceKind`'s and the rail's; the traced units
    build the rail in (K0_TRACED) and are listed for nvcc."""
    import re
    from repro_torch.kernels import _build
    from repro_torch.kernels import event_loop as K0
    src = (_build.CSRC / "event_loop.cu").read_text()
    kinds = re.search(r"enum \{ (TK_ARRIVAL[^}]*)\}", src).group(1)
    assert [k.strip() for k in kinds.split(",")] == [
        "TK_" + n for n in TraceKind.NAMES]
    widths = re.search(r"constexpr int kTrI = (\d+), kTrF = (\d+);", src)
    assert (int(widths.group(1)), int(widths.group(2))) == (
        rail.TR_RI, rail.TR_RF) == (K0.TR_RI, K0.TR_RF)
    for unit in _build.TRACED_UNITS + _build.CLUSTER_TRACED_UNITS:
        text = (_build.CSRC / f"{unit}.cu").read_text()
        assert "#define K0_TRACED 1" in text and unit in _build.SOURCES
    assert set(K0.CLUSTER_TRACED_SOURCE.values()) == set(
        _build.CLUSTER_TRACED_UNITS)


def test_profiling_hooks():
    """spec_hash is the JAX package's; provenance names the torch build
    and the device; compile_run_split, PhaseTimer and call_breakdown
    (build, pack, launch, copy) time a port call."""
    from repro.telemetry.profiling import spec_hash as jax_hash
    meta = {"study": "telemetry", "n": 3}
    spec = tapi.ExperimentSpec(
        traces=[tapi.SyntheticTrace.make(n_functions=4, n_requests=30)],
        capacities=(2,), meta=meta, trace_events=True)
    jspec = japi.ExperimentSpec(
        traces=[japi.SyntheticTrace.make(n_functions=4, n_requests=30)],
        capacities=(2,), meta=meta)
    assert ttel.spec_hash(spec) == jax_hash(jspec)
    prov = ttel.provenance(spec, device="cpu", run="x")
    assert prov["backend"] == "cpu" and prov["device"] == "cpu"
    assert prov["torch_version"] == torch.__version__
    assert prov["trace_events"] is True and prov["run"] == "x"
    assert prov["spec_hash"] == ttel.spec_hash(spec)
    calls = []

    def fn(x):
        calls.append(x)
        return x + 1
    first, run, res = ttel.compile_run_split(fn, 1, repeats=2)
    assert res == 2 and len(calls) == 3 and first >= 0 and run >= 0
    pt = ttel.PhaseTimer()
    with pt.phase("a"):
        pass
    with pt.phase("a"):
        pass
    assert set(pt.report()) == {"a"} and pt.report(None)["a"] >= 0
    br = ttel.call_breakdown(tapi.run_experiment, spec, device="cpu")
    assert set(br) == {"build_s", "pack_s", "launch_s", "copy_s",
                       "other_s", "total_s", "built"}
    assert br["built"] == {}   # nothing to build on the CPU
    assert br["launch_s"] > 0 and br["copy_s"] > 0 and br["pack_s"] > 0
    assert br["total_s"] >= br["launch_s"] + br["copy_s"]
    with pytest.raises(RuntimeError, match="already"):
        ttel.call_breakdown(ttel.call_breakdown, lambda: None)


def test_trace_events_spec_validation():
    """The JAX package's rule: every lane on this host, one device."""
    kw = dict(traces=[tapi.SyntheticTrace.make(n_functions=4,
                                               n_requests=10)], **BASE)
    with pytest.raises(ValueError, match="host_shard"):
        tapi.ExperimentSpec(**kw, trace_events=True,
                            host_shard=(1, 2)).validate()
    with pytest.raises(ValueError, match="devices must be None or 1"):
        tapi.ExperimentSpec(**kw, trace_events=True, devices=2).validate()
    tapi.ExperimentSpec(**kw, trace_events=True, devices=1).validate()
    tapi.ExperimentSpec(**kw, trace_events=True).validate()
