"""FRP selection (f32 contract): the port's `frp_select` against the JAX
package's Pallas kernel (interpret mode) and its pure-jnp oracle, on
the inputs of tests/test_kernels.py. The CUDA kernel's own check
against its plain version needs a card: tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import frp_select as fs


def _inputs(F, seed):
    r = np.random.default_rng(seed)
    return dict(t_e=r.uniform(0.001, 10, F).astype(np.float32),
                t_l=r.uniform(0.5, 1.5, F).astype(np.float32),
                t_v=r.uniform(0.5, 1.5, F).astype(np.float32),
                n_w=r.integers(0, 5, F).astype(np.int32),
                K=r.integers(0, 3, F).astype(np.int32))


def _port(a, tv_j, self_idx, device="cpu"):
    t = [torch.tensor(a[k], device=device)
         for k in ("t_e", "t_l", "t_v", "n_w", "K")]
    w, i = fs.frp_select(*t, tv_j, self_idx)
    return float(w), int(i)


def _cols(a):
    return [a[k] for k in ("t_e", "t_l", "t_v", "n_w", "K")]


@pytest.mark.parametrize("F,seed", [(16, 0), (100, 1), (1000, 2),
                                    (5000, 3)])
def test_frp_select_matches_pallas_and_ref(F, seed):
    a = _inputs(F, seed)
    tv_j, self_idx = 1.0, 3
    got_w, got_i = _port(a, tv_j, self_idx)
    pw, pi = ops.frp_select(*_cols(a), tv_j, self_idx, block=256,
                            interpret=True)
    rw, ri = ref.frp_select_ref(*_cols(a), tv_j, self_idx)
    assert got_i == int(pi) == int(ri)
    if got_i >= 0:
        # the tolerance of tests/test_kernels.py's frp_select check
        np.testing.assert_allclose(got_w, float(pw), rtol=1e-5)
        np.testing.assert_allclose(got_w, float(rw), rtol=1e-5)


def test_frp_select_all_invalid_returns_minus_one():
    a = _inputs(64, 7)
    a["n_w"][:] = 0
    w, i = _port(a, 1.0, 3)
    assert i == -1 == int(ref.frp_select_ref(*_cols(a), 1.0, 3)[1])
    assert w >= 1e30


def test_frp_select_tie_returns_first_index():
    a = _inputs(64, 8)
    a["n_w"][:] = 0
    for f in (9, 30, 50):
        a["t_e"][f], a["t_l"][f], a["t_v"][f] = 2.0, 1.0, 1.0
        a["n_w"][f], a["K"][f] = 3, 1
    _, i = _port(a, 1.0, 3)
    assert i == 9 == int(ref.frp_select_ref(*_cols(a), 1.0, 3)[1])
    # the finishing function itself never qualifies
    _, i = _port(a, 1.0, 9)
    assert i == 30


def test_frp_select_cpu_tensors_take_the_plain_version():
    before = (fs.frp_select.plain_calls, fs.frp_select.launches)
    _port(_inputs(16, 0), 1.0, 3)
    assert fs.frp_select.plain_calls == before[0] + 1
    assert fs.frp_select.launches == before[1]
