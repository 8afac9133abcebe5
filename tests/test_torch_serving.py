"""The port's Python scheduling core and live serving engine.

* `repro_torch.core.simulator.simulate` against
  `repro.core.simulator.simulate`, bit for bit, for every registered
  policy on one synthetic trace.
* Both serving engines with `ModelInstance`'s timings replaced (in the
  test only) by the same deterministic values: identical per-request
  responses, cold starts and evictions.
* tests/test_serving.py's properties, on the CPU with real (tiny)
  models."""
import numpy as np
import pytest
import torch

import repro.serving.engine as jax_engine
import repro.serving.instance as jax_instance
import repro_torch.serving.engine as port_engine
import repro_torch.serving.instance as port_instance
from repro.core import POLICIES as JAX_POLICIES
from repro.core import simulate as jax_simulate
from repro.models.config import ModelConfig as JaxModelConfig
from repro.traces import synth_azure_trace as jax_trace
from repro_torch.core.policy import POLICIES
from repro_torch.core.simulator import simulate
from repro_torch.launch import serve
from repro_torch.models.config import ModelConfig
from repro_torch.traces import synth_azure_trace


def test_same_policies_registered():
    assert list(POLICIES) == list(JAX_POLICIES)


@pytest.mark.parametrize("policy", list(JAX_POLICIES))
def test_simulate_bitwise_the_jax_packages(policy):
    kw = dict(n_functions=30, n_requests=1500, utilization=0.2, seed=7)
    a = simulate(synth_azure_trace(**kw), policy, capacity=6)
    b = jax_simulate(jax_trace(**kw), policy, capacity=6)
    for field in ("responses", "slowdowns", "exec_times", "arrivals"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    assert (a.server.cold_starts, a.server.evictions, a.server.cold_time) \
        == (b.server.cold_starts, b.server.evictions, b.server.cold_time)
    assert a.meta["n_events"] == b.meta["n_events"]


def tiny(cls, name, layers=2, d=32, vocab=128):
    return cls(name=name, family="dense", n_layers=layers, d_model=d,
               n_heads=2, n_kv_heads=2, head_dim=d // 2, d_ff=d * 2,
               vocab_size=vocab, param_dtype="float32",
               compute_dtype="float32", attn_chunk=16)


def catalogue(pkg_engine, cls):
    return [pkg_engine.ServedFunction(0, tiny(cls, "srv-a"), prompt_len=8,
                                      gen_tokens=2, max_len=16),
            pkg_engine.ServedFunction(1, tiny(cls, "srv-b", layers=3),
                                      prompt_len=8, gen_tokens=2,
                                      max_len=16),
            pkg_engine.ServedFunction(2, tiny(cls, "srv-c"), prompt_len=8,
                                      gen_tokens=1, max_len=16)]


def _fake_timings(monkeypatch, instance_cls, attr):
    """Deterministic cold/exec/evict seconds; ``attr`` is the field the
    engine reads to tell a warm replica (JAX: params, port: model)."""
    def cold_start(self):
        setattr(self, attr, object())
        return 0.5 + 0.25 * self.fn.fn_id

    def execute(self, seed=0):
        return 0.01 * (1 + seed % 7) + 0.002 * self.fn.fn_id

    def evict(self):
        setattr(self, attr, None)
        return 0.0

    for name, f in (("cold_start", cold_start), ("execute", execute),
                    ("evict", evict)):
        monkeypatch.setattr(instance_cls, name, f)


@pytest.mark.parametrize("policy,straggler", [("esff", 0.0),
                                              ("esff", 0.5),
                                              ("openwhisk", 0.0)])
def test_engine_matches_jax_engine_on_the_same_timings(monkeypatch,
                                                       policy, straggler):
    _fake_timings(monkeypatch, jax_instance.ModelInstance, "params")
    _fake_timings(monkeypatch, port_instance.ModelInstance, "model")
    # the JAX instance builds its model in __init__; the fake needs none
    monkeypatch.setattr(jax_instance, "build_model", lambda cfg: None)
    results = []
    for pkg, cls, kw in ((jax_engine, JaxModelConfig, {}),
                         (port_engine, ModelConfig, dict(device="cpu"))):
        eng = pkg.EdgeServingEngine(catalogue(pkg, cls), capacity=2,
                                    policy=policy,
                                    straggler_factor=straggler, **kw)
        res = eng.run(eng.make_requests(40, duration=4.0, seed=1))
        results.append((res, eng.stragglers))
    (a, sa), (b, sb) = results
    np.testing.assert_array_equal(a.responses, b.responses)
    np.testing.assert_array_equal(a.exec_times, b.exec_times)
    assert (a.server.cold_starts, a.server.evictions) == \
        (b.server.cold_starts, b.server.evictions)
    assert a.server.cold_starts >= 1 and a.server.evictions >= 1
    assert sa == sb


# ---------------------------------------- tests/test_serving.py, ported
@pytest.fixture(scope="module")
def engine():
    fns = [port_engine.ServedFunction(0, tiny(ModelConfig, "srv-a"),
                                      prompt_len=8, gen_tokens=2,
                                      max_len=16),
           port_engine.ServedFunction(1, tiny(ModelConfig, "srv-b",
                                              layers=3), prompt_len=8,
                                      gen_tokens=2, max_len=16)]
    eng = port_engine.EdgeServingEngine(fns, capacity=2, policy="esff",
                                        device="cpu")
    eng.warm_profile()
    return eng


def test_profiles_measured(engine):
    for p in engine.profiles.values():
        assert p.cold_start > 0        # a real build and warm-up
        assert p.true_mean_exec > 1e-5


def test_all_requests_served(engine):
    reqs = engine.make_requests(10, duration=5.0, seed=3)
    res = engine.run(reqs)
    assert len(res.responses) == 10
    assert (res.responses > 0).all()
    assert res.server.cold_starts >= 1


def test_policies_share_engine_semantics(engine):
    for policy in ("esff", "openwhisk"):
        engine.policy_name = policy
        reqs = engine.make_requests(6, duration=3.0, seed=4)
        res = engine.run(reqs)
        assert len(res.responses) == 6
    engine.policy_name = "esff"


def test_straggler_speculation(engine):
    engine.straggler_factor = 0.5
    try:
        reqs = engine.make_requests(12, duration=6.0, seed=5)
        res = engine.run(reqs)
        assert len(engine.stragglers) >= 1
        assert len(res.responses) == 12
    finally:
        engine.straggler_factor = 0.0
        engine.stragglers.clear()


def test_instance_serves_the_model_it_built():
    fn = port_engine.ServedFunction(3, tiny(ModelConfig, "srv-d"),
                                    prompt_len=8, gen_tokens=3, max_len=16)
    inst = port_instance.ModelInstance(fn, "cpu")
    with pytest.raises(RuntimeError, match="not warm"):
        inst.execute()
    assert inst.cold_start() > 0
    first = inst.model.embed.clone()
    assert inst.execute(seed=1) > 0
    inst.evict()
    assert inst.model is None
    inst.cold_start()                   # the same seed: the same weights
    torch.testing.assert_close(inst.model.embed, first, rtol=0, atol=0)


def test_entry_points_without_cuda_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fns = catalogue(port_engine, ModelConfig)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_engine.EdgeServingEngine(fns, capacity=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_instance.ModelInstance(fns[0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--requests", "2"])


def test_serve_cli_on_cpu(capsys):
    serve.main(["--device", "cpu", "--requests", "6", "--duration", "2"])
    out = capsys.readouterr().out
    assert '"n_requests": 6' in out
