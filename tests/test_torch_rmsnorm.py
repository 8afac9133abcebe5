"""Fused RMSNorm (K4a, K4b): the port's wrappers on CPU tensors (their
plain versions) against the JAX package's Pallas kernels (interpret
mode) and its pure-jnp oracles, at the shapes of tests/test_kernels.py
and with its tolerances. The CUDA kernel's own check against its plain
version needs a card: tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import rmsnorm as RN

# tests/test_kernels.py's TOL
TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}


def _pair(a, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``
    (bf16 rounding done once, by JAX, then carried over exactly)."""
    j = jnp.asarray(a, jnp.dtype(dtype))
    return j, torch.tensor(np.asarray(j, np.float32)).to(
        getattr(torch, dtype))


def _np(x):
    return x.to(torch.float32).numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@pytest.mark.parametrize("shape,dtype", [
    ((4, 128, 512), "float32"),
    ((2, 300, 384), "bfloat16"),   # ragged rows
    ((1000, 256), "float32"),
    ((64, 128), "bfloat16"),       # qk-norm rows of head_dim 128
])
def test_rmsnorm_matches_pallas_and_ref(shape, dtype):
    r = np.random.default_rng(0)
    jx, tx = _pair(r.normal(size=shape), dtype)
    w = (r.normal(size=shape[-1:]) * 0.1 + 1.0).astype(np.float32)
    jw, tw = jnp.asarray(w), torch.tensor(w)
    before = RN.rmsnorm.plain_calls, RN.rmsnorm.launches
    got = RN.rmsnorm(tx, tw, eps=1e-6)
    assert (RN.rmsnorm.plain_calls, RN.rmsnorm.launches) == (
        before[0] + 1, before[1])
    assert got.dtype == tx.dtype and got.shape == tx.shape
    pallas = ops.rmsnorm(jx, jw, interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), **TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(ref.rmsnorm_ref(jx, jw)),
                               **TOL[dtype])


@pytest.mark.parametrize("shape,dtype", [
    ((3, 100, 256), "float32"),
    ((2, 300, 384), "bfloat16"),
    ((1, 1, 2560), "bfloat16"),    # the decode step's residual stream
])
def test_rmsnorm_residual_matches_pallas_and_ref(shape, dtype):
    r = np.random.default_rng(1)
    jx, tx = _pair(r.normal(size=shape), dtype)
    jr, tr = _pair(r.normal(size=shape), dtype)
    w = (r.normal(size=shape[-1:]) * 0.1 + 1.0).astype(np.float32)
    jw, tw = jnp.asarray(w), torch.tensor(w)
    got_n, got_r = RN.rmsnorm_residual(tx, tr, tw, eps=1e-6)
    pn, pr = ops.rmsnorm_residual(jx, jr, jw, interpret=True)
    wn, wr = ref.rmsnorm_residual_ref(jx, jr, jw)
    for want_n, want_r in ((pn, pr), (wn, wr)):
        np.testing.assert_allclose(_np(got_n), _np(want_n), **TOL[dtype])
        # the residual is one rounding of the f32 sum in both packages
        np.testing.assert_array_equal(_np(got_r), _np(want_r))


def test_rmsnorm_residual_stream_is_bitwise_the_bf16_add():
    """K4b's residual output equals the JAX model's bf16 ``h + y``."""
    r = np.random.default_rng(2)
    jx, tx = _pair(r.normal(size=(5, 2560)), "bfloat16")
    jr, tr = _pair(r.normal(size=(5, 2560)), "bfloat16")
    _, res = RN.rmsnorm_residual(tx, tr, torch.ones(2560))
    np.testing.assert_array_equal(_np(res), _np(jx + jr))


@pytest.mark.parametrize("bad,exc", [
    (dict(x=torch.ones(4, 8, dtype=torch.float16)), TypeError),
    (dict(w=torch.ones(7)), ValueError),
    (dict(x=torch.ones(8, 4).t()), ValueError),
    (dict(x=torch.ones(2, 8193), w=torch.ones(8193)), ValueError),
    (dict(r=torch.ones(4, 8, dtype=torch.bfloat16)), TypeError),
    (dict(r=torch.ones(2, 8)), ValueError),
])
def test_wrappers_reject_what_the_kernel_does_not_take(bad, exc):
    a = dict(x=torch.ones(4, 8), r=torch.ones(4, 8), w=torch.ones(8))
    a.update(bad)
    with pytest.raises(exc):
        if "r" in bad:
            RN.rmsnorm_residual(a["x"], a["r"], a["w"])
        else:
            RN.rmsnorm(a["x"], a["w"])
