"""K2's backward in bf16: the limit that holds the tensor-core body on the
card (chip_smoke.KERNEL_TOL["flash_attention_backward"] and
tests/test_torch_cuda.py) checked on the CPU. The body's arithmetic is
emulated in plain PyTorch at its rounding points (f32 products of the
bf16 inputs; P = exp(scale S - lse) and dS = P (dP - Dl) in f32; P
rounded to bf16 for dv = P^T do, dS rounded to bf16 for dk = scale dS^T
q and dq = scale dS k; each output rounded once) and held against
``jax.grad`` of the JAX model's ``chunked_attention`` on the same bf16
inputs widened to f32: within atol + rtol |want| + o_round
`backward_o_terms` + p_round `backward_round_terms`, while the planted
fault of the card checks (one kv tile of 64 positions dropped) lies
outside it. `backward_round_terms` is also held to its definition,
written out as loops."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels import flash_attention as FA

# chip_smoke.KERNEL_TOL["flash_attention_backward"]
TOL = dict(rtol=1e-2, atol=1e-3, o_round=2.0 ** -9, p_round=2.0 ** -8)


def _inputs(B, S, H, KVH, D, seed):
    """bf16 q, k, v, do drawn with numpy (N(0, 1), as the card checks)."""
    r = np.random.default_rng(seed)
    q, do = (torch.tensor(r.normal(size=(B, S, H, D)), dtype=torch.float32)
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.tensor(r.normal(size=(B, S, KVH, D)), dtype=torch.float32)
            .to(torch.bfloat16) for _ in range(2))
    return q, k, v, do


def _emulated(q, k, v, o, do, causal):
    """The bf16 body's (dq, dk, dv): f32 sums, P and dS rounded to bf16
    where the tensor cores take them, each output rounded once."""
    B, S, H, D = q.shape
    KVH = k.shape[2]
    g = H // KVH
    scale = 1.0 / D ** 0.5
    qf, dof, of = (x.float() for x in (q, do, o))
    kr = k.float().repeat_interleave(g, 2)
    vr = v.float().repeat_interleave(g, 2)
    s = torch.einsum("bshd,bthd->bhst", qf, kr) * scale
    if causal:
        pos = torch.arange(S)
        s = s.masked_fill(~(pos[:, None] >= pos[None, :]), float("-inf"))
    p = torch.exp(s - torch.logsumexp(s, -1, keepdim=True))
    dl = (dof * of).sum(-1).transpose(1, 2)[..., None]
    ds = p * (torch.einsum("bshd,bthd->bhst", dof, vr) - dl)
    pb, dsb = (x.to(torch.bfloat16).float() for x in (p, ds))
    dq = scale * torch.einsum("bhst,bthd->bshd", dsb, kr)
    dk = scale * torch.einsum("bhst,bshd->bthd", dsb, qf)
    dv = torch.einsum("bhst,bshd->bthd", pb, dof)
    dk, dv = (x.reshape(B, S, KVH, g, D).sum(3) for x in (dk, dv))
    return tuple(x.to(torch.bfloat16) for x in (dq, dk, dv))


def _jax_grads(q, k, v, do, causal, allowed=None):
    """jax.grad of the JAX model's attention (or, with ``allowed``, of
    the same attention over those key positions only: the fault) on the
    bf16 inputs widened to f32."""
    qj, kj, vj, doj = (jnp.asarray(x.float().numpy()) for x in (q, k, v,
                                                                   do))
    if allowed is None:
        def f(a, b, c):
            return jnp.sum(JL.chunked_attention(a, b, c, chunk=64,
                                                causal=causal) * doj)
    else:
        m = jnp.asarray(allowed.numpy())

        def f(a, b, c):
            g = a.shape[2] // b.shape[2]
            s = jnp.einsum("bshd,bthd->bhst", a, jnp.repeat(b, g, 2)) \
                / a.shape[-1] ** 0.5
            p = jax.nn.softmax(jnp.where(m, s, -jnp.inf), -1)
            return jnp.sum(jnp.einsum("bhst,bthd->bshd", p,
                                      jnp.repeat(c, g, 2)) * doj)
    return [torch.tensor(np.asarray(x)) for x in
            jax.jit(jax.grad(f, argnums=(0, 1, 2)))(qj, kj, vj)]


def _use(got, want, extra):
    lim = TOL["atol"] + TOL["rtol"] * want.abs() + extra
    return ((got.float() - want).abs() / lim).max().item()


@pytest.mark.parametrize("B,S,H,KVH,D,causal", [
    (1, 129, 4, 2, 32, True),
    (2, 100, 4, 4, 64, True),     # G = 1
    (1, 96, 8, 1, 128, True),     # G = 8
    (1, 129, 4, 1, 64, False),
    (1, 80, 8, 2, 128, False),
])
def test_round_terms_hold_the_emulated_body_and_reject_the_fault(
        B, S, H, KVH, D, causal):
    q, k, v, do = _inputs(B, S, H, KVH, D, seed=S + D)
    # the forward's output as the card checks make it: the plain
    # attention rounded once
    o = FA.flash_attention_plain(q, k, v, causal=causal)
    got = _emulated(q, k, v, o, do, causal)
    want = _jax_grads(q, k, v, do, causal)
    extras = [TOL["o_round"] * a + TOL["p_round"] * b for a, b in zip(
        FA.backward_o_terms(q, k, v, o, do, causal=causal),
        FA.backward_round_terms(q, k, v, do, causal=causal))]
    uses = [_use(a, b, x) for a, b, x in zip(got, want, extras)]
    assert max(uses) <= 1.0, uses
    pos = torch.arange(S)
    allowed = ~((pos >= S // 2) & (pos < S // 2 + 64))[None, :]
    if causal:
        allowed = allowed & (pos[:, None] >= pos[None, :])
    fault = _jax_grads(q, k, v, do, causal, allowed)
    assert max(_use(a, b, x) for a, b, x in zip(fault, want, extras)) > 1.0


@pytest.mark.parametrize("causal", [True, False])
def test_round_terms_match_their_definition(causal):
    """dq_i: scale sum_j |dS_ij| |k_j|; dk_j: scale sum over the group's
    heads and i of |dS_ij| |q_i|; dv_j: sum over the same of P_ij |do_i|
    (elementwise over d), written out as loops in f64."""
    B, S, H, KVH, D = 1, 6, 4, 2, 32
    q, k, v, do = _inputs(B, S, H, KVH, D, seed=3)
    t_dq, t_dk, t_dv = FA.backward_round_terms(q, k, v, do, causal=causal)
    qd, kd, vd, dod = (x.double()[0] for x in (q, k, v, do))
    scale = 1.0 / D ** 0.5
    g = H // KVH
    w_dq = torch.zeros(S, H, D, dtype=torch.float64)
    w_dk = torch.zeros(S, KVH, D, dtype=torch.float64)
    w_dv = torch.zeros(S, KVH, D, dtype=torch.float64)
    for h in range(H):
        kv = h // g
        for i in range(S):
            seen = [j for j in range(S) if not causal or j <= i]
            s = torch.stack([scale * qd[i, h] @ kd[j, kv] for j in seen])
            p = torch.softmax(s, 0)
            o = sum(p[n] * vd[j, kv] for n, j in enumerate(seen))
            dl = dod[i, h] @ o
            for n, j in enumerate(seen):
                ds = p[n] * (dod[i, h] @ vd[j, kv] - dl)
                w_dq[i, h] += scale * ds.abs() * kd[j, kv].abs()
                w_dk[j, kv] += scale * ds.abs() * qd[i, h].abs()
                w_dv[j, kv] += p[n] * dod[i, h].abs()
    for got, want in ((t_dq, w_dq), (t_dk, w_dk), (t_dv, w_dv)):
        np.testing.assert_allclose(got[0].numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-6)
