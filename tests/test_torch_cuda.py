"""Card-only checks of the port: each CUDA kernel against its plain
PyTorch version, and the engine on the card against the engine on the
CPU. Every test skips without a CUDA device (a CUDA kernel has no CPU
mode). The file imports no JAX, so it runs on a machine without it
(``--noconftest`` skips tests/conftest.py, which imports JAX):

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import engine as E
from repro_torch.kernels import frp_select as fs
from repro_torch.traces import synth_azure_arrays

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
    launches = fs.frp_select_lanes.launches
    card, cpu = run(cuda), run("cpu")
    assert fs.frp_select_lanes.launches > launches
    for k, v in cpu.items():
        assert torch.equal(card[k].cpu(), v), k
