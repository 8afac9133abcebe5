"""Guards of the port's rules: it imports neither JAX nor the JAX
package, it never runs on the CPU unless asked to, and a kernel
wrapper given a non-CPU tensor launches or raises -- it never falls
back to the plain version."""
import os
import subprocess
import sys

import pytest
import torch

import repro_torch.api as tapi
from repro_torch.kernels import _build
from repro_torch.core.policies import ESFFKernel
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import event_loop as K0
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import frp_select as fs
from repro_torch.kernels import rmsnorm as RN
from repro_torch.kernels import ssd_chunk as K5

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
print(len(names), bad)
sys.exit(1 if bad else 0)
"""


def test_import_loads_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 80   # every submodule was imported


_NEW_SUBMODULES = ("repro_torch.cluster", "repro_torch.cluster.routers",
                   "repro_torch.cluster.spec", "repro_torch.cluster.static",
                   "repro_torch.cluster.runner", "repro_torch.cluster.engine",
                   "repro_torch.core.ssfs",
                   "repro_torch.core.sim", "repro_torch.configs.paper_edge",
                   "repro_torch.telemetry", "repro_torch.telemetry.rail",
                   "repro_torch.telemetry.spans",
                   "repro_torch.telemetry.perfetto",
                   "repro_torch.telemetry.metrics",
                   "repro_torch.telemetry.profiling",
                   "repro_torch.cluster.reference", "repro_torch.analysis",
                   "repro_torch.analysis.__main__",
                   "repro_torch.analysis.buffers",
                   "repro_torch.analysis.carries",
                   "repro_torch.analysis.dtypes",
                   "repro_torch.analysis.lint",
                   "repro_torch.analysis.markers",
                   "repro_torch.analysis.recompile",
                   "repro_torch.analysis.report",
                   "repro_torch.analysis.sass",
                   "repro_torch.analysis.telemetry_gate",
                   "repro_torch.configs.deepseek_moe_16b",
                   "repro_torch.configs.deepseek_v3_671b",
                   "repro_torch.models.layers", "repro_torch.models.model")


def test_cluster_and_small_modules_load_no_jax():
    """The static and dynamic cluster tiers, the reference cluster, SSFS,
    the simulator facade, the scenario config, the telemetry package and
    the audit, each with its submodules, imported, leave JAX and the JAX
    package out of sys.modules."""
    probe = ("import importlib, sys\n"
             f"for n in {_NEW_SUBMODULES!r}:\n"
             "    importlib.import_module(n)\n"
             "bad = sorted(m for m in sys.modules if m == 'jax' or "
             "m.startswith('jax.') or m == 'repro' or "
             "m.startswith('repro.'))\n"
             "print(bad)\n"
             "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", probe], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


_TRAINING_MODULES = ("repro_torch.train", "repro_torch.train.data",
                     "repro_torch.train.train_step", "repro_torch.optim",
                     "repro_torch.optim.adamw", "repro_torch.optim.schedules",
                     "repro_torch.checkpoint",
                     "repro_torch.checkpoint.checkpointer",
                     "repro_torch.distributed",
                     "repro_torch.distributed.compression",
                     "repro_torch.launch.train")


def test_training_modules_load_no_jax():
    """The training slice (data, train step, optimizer, checkpointer,
    compression, the trainer), imported, leaves JAX and the JAX package
    out of sys.modules."""
    probe = ("import importlib, sys\n"
             f"for n in {_TRAINING_MODULES!r}:\n"
             "    importlib.import_module(n)\n"
             "bad = sorted(m for m in sys.modules if m == 'jax' or "
             "m.startswith('jax.') or m == 'repro' or "
             "m.startswith('repro.'))\n"
             "print(bad)\n"
             "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", probe], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_run_experiment_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = tapi.ExperimentSpec(
        traces=[tapi.SyntheticTrace.make(n_functions=4, n_requests=10)],
        capacities=(2,))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.run_experiment(spec)
    spec.device = "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.run_experiment(spec)


def _lanes(device="meta", L=2, F=8, **override):
    f64, i32 = torch.float64, torch.int32
    a = dict(means=torch.ones(L, F, dtype=f64, device=device),
             t_cold=torch.ones(L, F, dtype=f64, device=device),
             t_evict=torch.ones(L, F, dtype=f64, device=device),
             nw=torch.ones(L, F, dtype=i32, device=device),
             K=torch.ones(L, F, dtype=i32, device=device),
             tv_j=torch.ones(L, dtype=f64, device=device),
             self_idx=torch.zeros(L, dtype=i32, device=device),
             beta=torch.ones(L, dtype=f64, device=device))
    a.update(override)
    return a


@pytest.fixture
def no_library(monkeypatch):
    """The kernel library cannot be had: every load raises."""
    def refuse(name):
        raise RuntimeError(f"no library {name}")
    monkeypatch.setattr(_build, "load_library", refuse)


@pytest.mark.parametrize("bad,exc", [
    (dict(means=torch.ones(2, 8, dtype=torch.float32, device="meta")),
     TypeError),
    (dict(nw=torch.ones(2, 8, dtype=torch.int64, device="meta")),
     TypeError),
    (dict(means=torch.ones(8, 2, dtype=torch.float64,
                           device="meta").t()), ValueError),
    (dict(beta=torch.ones(3, dtype=torch.float64, device="meta")),
     ValueError)])
def test_wrapper_rejects_what_the_kernel_does_not_take(no_library, bad,
                                                       exc):
    before = fs.frp_select_lanes.plain_calls
    with pytest.raises(exc):
        fs.frp_select_lanes(**_lanes(**bad))
    assert fs.frp_select_lanes.plain_calls == before


def test_wrapper_raises_without_library_instead_of_falling_back(
        no_library):
    before = (fs.frp_select_lanes.plain_calls,
              fs.frp_select_lanes.launches)
    with pytest.raises(RuntimeError, match="no library"):
        fs.frp_select_lanes(**_lanes())
    t = [torch.ones(8, dtype=torch.float32, device="meta")] * 3
    t += [torch.ones(8, dtype=torch.int32, device="meta")] * 2
    with pytest.raises(RuntimeError, match="no library"):
        fs.frp_select(*t, 1.0, 0)
    assert (fs.frp_select_lanes.plain_calls,
            fs.frp_select_lanes.launches) == before


def _meta(*shape, dtype=torch.float32):
    return torch.ones(*shape, dtype=dtype, device="meta")


NEW_WRAPPERS = {
    "flash_attention": (FA.flash_attention, lambda: FA.flash_attention(
        _meta(1, 8, 4, 32), _meta(1, 8, 2, 32), _meta(1, 8, 2, 32))),
    "decode_attention": (DA.decode_attention, lambda: DA.decode_attention(
        _meta(1, 1, 4, 32), _meta(1, 8, 2, 32), _meta(1, 8, 2, 32), 3)),
    "flash_attention_mla": (FA.flash_attention, lambda: FA.flash_attention(
        _meta(1, 8, 16, 192), _meta(1, 8, 16, 192), _meta(1, 8, 16, 128))),
    "mla_decode_attention": (
        DA.mla_decode_attention, lambda: DA.mla_decode_attention(
            _meta(1, 1, 16, 512), _meta(1, 1, 16, 64), _meta(1, 8, 512),
            _meta(1, 8, 64), 3, scale=0.1)),
    "rmsnorm": (RN.rmsnorm, lambda: RN.rmsnorm(_meta(4, 32),
                                               _meta(32))),
    "rmsnorm_residual": (RN.rmsnorm_residual, lambda: RN.rmsnorm_residual(
        _meta(4, 32, dtype=torch.bfloat16),
        _meta(4, 32, dtype=torch.bfloat16), _meta(32))),
    "event_loop": (K0.event_loop, lambda: K0.event_loop(
        _meta(1, 8, dtype=torch.int64), _meta(1, 8, dtype=torch.float64),
        _meta(1, 8, dtype=torch.float64), _meta(1, 4, dtype=torch.float64),
        _meta(1, 4, dtype=torch.float64), _meta(2, dtype=torch.int64),
        _meta(2, 3, dtype=torch.bool), _meta(2, dtype=torch.float64), 0.1,
        kernel=ESFFKernel(), n_fns=4, capacity=3, queue_cap=16)),
    "event_loop_traced": (K0.event_loop, lambda: K0.event_loop(
        _meta(1, 8, dtype=torch.int64), _meta(1, 8, dtype=torch.float64),
        _meta(1, 8, dtype=torch.float64), _meta(1, 4, dtype=torch.float64),
        _meta(1, 4, dtype=torch.float64), _meta(2, dtype=torch.int64),
        _meta(2, 3, dtype=torch.bool), _meta(2, dtype=torch.float64), 0.1,
        kernel=ESFFKernel(), n_fns=4, capacity=3, queue_cap=16,
        trace=True)),
    "flash_attention_backward": (
        FA.flash_attention_backward, lambda: FA.flash_attention_backward(
            _meta(1, 8, 4, 32), _meta(1, 8, 2, 32), _meta(1, 8, 2, 32),
            _meta(1, 8, 4, 32), _meta(1, 8, 4, 32), _meta(1, 4, 8))),
    "rmsnorm_backward": (RN.rmsnorm_backward, lambda: RN.rmsnorm_backward(
        _meta(4, 32), _meta(32), _meta(4, 32))),
    "rmsnorm_residual_backward": (
        RN.rmsnorm_residual_backward,
        lambda: RN.rmsnorm_residual_backward(
            _meta(4, 32), _meta(4, 32), _meta(32), _meta(4, 32),
            _meta(4, 32))),
    "ssd_chunk": (K5.ssd_chunk, lambda: K5.ssd_chunk(
        _meta(1, 2, 32, 4, 16, dtype=torch.bfloat16), _meta(1, 2, 32, 4),
        _meta(1, 2, 32, 4), _meta(1, 2, 32, 1, 16),
        _meta(1, 2, 32, 1, 16))),
    "ssd_chunk_backward": (
        K5.ssd_chunk_backward, lambda: K5.ssd_chunk_backward(
            _meta(1, 2, 32, 4, 16, dtype=torch.bfloat16),
            _meta(1, 2, 32, 4), _meta(1, 2, 32, 4),
            _meta(1, 2, 32, 1, 16, dtype=torch.bfloat16),
            _meta(1, 2, 32, 1, 16, dtype=torch.bfloat16),
            _meta(1, 2, 32, 4, 16), _meta(1, 2, 4, 16, 16))),
}


@pytest.mark.parametrize("name", sorted(NEW_WRAPPERS))
def test_new_wrappers_raise_without_library_instead_of_falling_back(
        no_library, name):
    wrapper, call = NEW_WRAPPERS[name]
    before = (wrapper.plain_calls, wrapper.launches)
    with pytest.raises(RuntimeError, match="no library"):
        call()
    assert (wrapper.plain_calls, wrapper.launches) == before


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_nvcc_flags_per_source_and_in_the_digest(monkeypatch):
    assert set(_build.SOURCES) == {"event_loop", "event_loop_cluster_esff",
                                   "event_loop_cluster_esff_lru",
                                   "event_loop_cluster_queue",
                                   "event_loop_cluster_faas",
                                   "event_loop_traced",
                                   "event_loop_cluster_traced_esff",
                                   "event_loop_cluster_traced_esff_lru",
                                   "event_loop_cluster_traced_queue",
                                   "event_loop_cluster_traced_faas",
                                   "frp_select", "rmsnorm",
                                   "decode_attention", "flash_attention",
                                   "ssd_chunk", "flash_attention_bwd",
                                   "rmsnorm_bwd", "ssd_chunk_bwd",
                                   "mla_decode"}
    for name in _build.SOURCES:
        assert "arch=compute_90a,code=sm_90a" in _build.nvcc_flags(name)
    # only the f64 engine bodies need contraction off (bitwise parity)
    assert "--fmad=false" in _build.nvcc_flags("frp_select")
    for name in _build.EVENT_LOOP_UNITS:
        assert "--fmad=false" in _build.nvcc_flags(name)
    # the K-node units include event_loop.cu: it is in their key
    monkeypatch.setattr(_build, "INCLUDES", {})
    b = _build._lib_path("event_loop_cluster_esff")
    monkeypatch.undo()
    assert _build._lib_path("event_loop_cluster_esff") != b
    assert "--fmad=false" not in _build.nvcc_flags("flash_attention")
    a = _build._lib_path("rmsnorm")
    monkeypatch.setitem(_build.EXTRA_FLAGS, "rmsnorm", ("--fmad=false",))
    assert _build._lib_path("rmsnorm") != a   # flags change the key
