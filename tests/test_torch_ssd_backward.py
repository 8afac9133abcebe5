"""K5's backward on the CPU against the JAX package, on the same inputs
(made with numpy), in f32: the plain backward `ssd_chunk_backward_plain`
against ``jax.vjp`` of `repro.kernels.ref.ssd_chunk_ref` (which takes B
and C repeated over the heads, so its dB and dC are summed over each
group here), and the port's chunked SSD, whose intra-chunk block goes
through `SSDChunk` (its backward the wrapper `ssd_chunk_backward`),
against ``jax.grad`` of `repro.models.mamba.ssd_chunked` over several
chunks with a ragged tail, so that the inter-chunk recurrence's gradient
counts. On CPU tensors the wrappers compute their plain versions (a CUDA
tensor launches the kernel: `tests/test_torch_cuda.py`). Tolerances are
the dense training tests' (tests/test_torch_train.py): rtol 1e-4, atol
1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import ssd_chunk_ref
from repro.models import mamba as JM
from repro_torch.kernels import ssd_chunk as K5
from repro_torch.models import mamba as M

GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _chunk_inputs(rng, b, nc, c, h, p, n, g, valid=None):
    """Inputs in the ranges of tests/test_kernels.py (dt in [0.01, 0.2],
    A in [-2, -0.5]: every (s, t) term counts) and the output gradients
    dy and dS; ``valid`` zero-pads the tail of the last chunk as
    `ssd_chunked` pads a ragged length (x, dt, B, C zero, cum flat)."""
    L = nc * c
    x = rng.normal(size=(b, L, h, p))
    dt = rng.uniform(0.01, 0.2, (b, L, h))
    A = -rng.uniform(0.5, 2.0, (h,))
    B, C = rng.normal(size=(2, b, L, g, n))
    if valid is not None:
        for a in (x, dt, B, C):
            a[:, valid:] = 0.0
    dt = dt.reshape(b, nc, c, h)
    cum = np.cumsum(dt * A, axis=2)
    dy = rng.normal(size=(b, nc, c, h, p))
    dS = rng.normal(size=(b, nc, h, p, n))
    f = lambda a: a.astype(np.float32)  # noqa: E731
    return (f(x.reshape(b, nc, c, h, p)), f(dt), f(cum),
            f(B.reshape(b, nc, c, g, n)), f(C.reshape(b, nc, c, g, n)),
            f(dy), f(dS))


def _jax_vjp(x, dt, cum, B, C, dy, dS):
    """``jax.vjp`` of the JAX oracle, B and C repeated over the heads,
    their gradients summed back over each group."""
    h, g = x.shape[3], B.shape[3]
    rep = h // g

    def f(x, dt, cum, B, C):
        return ssd_chunk_ref(x, dt, cum, jnp.repeat(B, rep, axis=3),
                             jnp.repeat(C, rep, axis=3))
    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (x, dt, cum, B, C)))
    dx, ddt, dcum, dB, dC = (np.asarray(a) for a in vjp(
        (jnp.asarray(dy), jnp.asarray(dS))))
    return dx, ddt, dcum, dB, dC


@pytest.mark.parametrize("b,nc,c,h,p,n,g,valid", [
    (1, 2, 32, 2, 16, 16, 1, None),
    (2, 2, 64, 4, 32, 64, 1, None),
    (1, 2, 48, 6, 16, 32, 2, None),     # two groups of three heads
    (1, 3, 32, 4, 16, 16, 2, 80),       # a ragged tail, padded
])
def test_ssd_chunk_backward_plain_matches_jax_vjp(b, nc, c, h, p, n, g,
                                                 valid):
    rng = np.random.default_rng(b * 100 + c + g)
    ins = _chunk_inputs(rng, b, nc, c, h, p, n, g, valid)
    want = _jax_vjp(*ins)
    before = K5.ssd_chunk_backward.plain_calls
    got = K5.ssd_chunk_backward(*(torch.tensor(a) for a in ins))
    assert K5.ssd_chunk_backward.plain_calls == before + 1
    names = ("dx", "ddt", "dcum", "dB", "dC")
    for name, a, w in zip(names, got, want):
        assert a.dtype == torch.float32 and a.shape == w.shape, name
        np.testing.assert_allclose(a.numpy(), w, err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("which", ["dy", "dS"])
def test_ssd_chunk_backward_one_gradient_is_none(which):
    """A missing output gradient counts as zero (the last chunk's state
    feeds only the final state, which a loss need not use)."""
    rng = np.random.default_rng(7)
    x, dt, cum, B, C, dy, dS = _chunk_inputs(rng, 1, 2, 32, 4, 16, 16, 1)
    zero_dy, zero_dS = np.zeros_like(dy), np.zeros_like(dS)
    if which == "dy":
        want = _jax_vjp(x, dt, cum, B, C, zero_dy, dS)
        args = (None, torch.tensor(dS))
    else:
        want = _jax_vjp(x, dt, cum, B, C, dy, zero_dS)
        args = (torch.tensor(dy), None)
    got = K5.ssd_chunk_backward(*(torch.tensor(a) for a in
                                  (x, dt, cum, B, C)), *args)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w, **GRAD_TOL)


def test_ssd_chunk_backward_keeps_input_dtypes():
    """x, B and C in bf16 (the served dtypes): dx, dB and dC come back in
    bf16, ddt and dcum in f32, each the f32 gradient rounded once."""
    rng = np.random.default_rng(3)
    x, dt, cum, B, C, dy, dS = (torch.tensor(a) for a in _chunk_inputs(
        rng, 1, 2, 32, 4, 16, 16, 1))
    bf = torch.bfloat16
    xb, Bb, Cb = x.to(bf), B.to(bf), C.to(bf)
    got = K5.ssd_chunk_backward(xb, dt, cum, Bb, Cb, dy, dS)
    want = K5.ssd_chunk_backward_plain(xb.float(), dt, cum, Bb.float(),
                                       Cb.float(), dy, dS)
    assert [a.dtype for a in got] == [bf, torch.float32, torch.float32,
                                      bf, bf]
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w.to(a.dtype), rtol=0, atol=0)


def test_ssd_chunk_backward_rejects_bad_gradients():
    rng = np.random.default_rng(4)
    x, dt, cum, B, C, dy, dS = (torch.tensor(a) for a in _chunk_inputs(
        rng, 1, 2, 32, 4, 16, 16, 1))
    with pytest.raises(ValueError, match="dy"):
        K5.ssd_chunk_backward(x, dt, cum, B, C, dy[:, :1].contiguous(), dS)
    with pytest.raises(TypeError, match="dS"):
        K5.ssd_chunk_backward(x, dt, cum, B, C, dy, dS.double())
    with pytest.raises(ValueError, match="dS: not contiguous"):
        K5.ssd_chunk_backward(x, dt, cum, B, C, dy, dS.transpose(3, 4))


def test_serving_call_takes_no_function():
    """Without a gradient K5 runs alone; with one, through `SSDChunk`."""
    rng = np.random.default_rng(5)
    ins = [torch.tensor(a) for a in _chunk_inputs(
        rng, 1, 2, 32, 4, 16, 16, 1)[:5]]
    y, _ = K5.ssd_chunk(*ins)
    assert y.grad_fn is None
    ins[0].requires_grad_()
    with torch.no_grad():
        assert K5.ssd_chunk(*ins)[0].grad_fn is None
    y, S = K5.ssd_chunk(*ins)
    assert type(y.grad_fn).__name__ == "SSDChunkBackward"
    before = K5.ssd_chunk_backward.plain_calls
    (y.sum() + S.sum()).backward()
    assert K5.ssd_chunk_backward.plain_calls == before + 1
    assert ins[0].grad.shape == ins[0].shape


@pytest.mark.parametrize("b,l,h,p,n,g,chunk,init", [
    (2, 80, 4, 16, 16, 1, 32, False),   # three chunks, ragged tail
    (1, 100, 6, 16, 32, 2, 32, True),   # four chunks, two groups, a state
    (1, 75, 2, 8, 16, 2, 16, False),    # five chunks, a group a head
])
def test_ssd_chunked_gradients_match_jax(b, l, h, p, n, g, chunk, init):
    """Every input's gradient of the port's ``ssd_chunked`` (K5 through
    `SSDChunk`, its backward the plain one on the CPU; the chunk sums,
    the recurrence and the inter-chunk term plain autograd) against
    ``jax.grad`` of the JAX package's, for y's and the final state's
    gradients drawn with numpy."""
    rng = np.random.default_rng(l + h)
    f32 = np.float32
    x = rng.normal(size=(b, l, h, p)).astype(f32)
    dt = rng.uniform(0.01, 0.2, (b, l, h)).astype(f32)
    A = (-rng.uniform(0.5, 2.0, (h,))).astype(f32)
    B, C = rng.normal(size=(2, b, l, g, n)).astype(f32)
    S0 = rng.normal(size=(b, h, p, n)).astype(f32) if init else None
    gy = rng.normal(size=(b, l, h, p)).astype(f32)
    gS = rng.normal(size=(b, h, p, n)).astype(f32)

    def jloss(x, dt, A, B, C, S0):
        y, S = JM.ssd_chunked(x, dt, A, B, C, chunk=chunk, init_state=S0)
        return jnp.sum(y * gy) + jnp.sum(S * gS)
    ins = (x, dt, A, B, C) + ((S0,) if init else ())
    argnums = tuple(range(len(ins)))
    want = jax.jit(jax.grad(
        lambda *a: jloss(*a[:5], a[5] if init else None),
        argnums=argnums))(*(jnp.asarray(a) for a in ins))
    ts = [torch.tensor(a, requires_grad=True) for a in ins]
    calls = (K5.ssd_chunk.plain_calls, K5.ssd_chunk_backward.plain_calls)
    y, S = M.ssd_chunked(*ts[:5], chunk=chunk,
                         init_state=ts[5] if init else None)
    ((y * torch.tensor(gy)).sum() + (S * torch.tensor(gS)).sum()).backward()
    assert (K5.ssd_chunk.plain_calls - calls[0],
            K5.ssd_chunk_backward.plain_calls - calls[1]) == (1, 1)
    for name, t, w in zip(("x", "dt", "A", "B", "C", "init_state"), ts,
                          want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   err_msg=name, **GRAD_TOL)
