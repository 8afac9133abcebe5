"""The sliding window of K2 and the hybrid family's prefill past its
cache, against the JAX package.

`flash_attention_plain(window=W)` (what K2's wrapper runs on CPU
tensors) against `repro.models.layers.chunked_attention(window=W)`: GQA,
S > W, W not a multiple of the 64-row tile. Then the Zamba2 smoke model
with a prompt longer than its cache (W = the cache's length): the
prefill and 4 decode steps against the JAX model, at S % W != 0 and S %
W == 0. Logits within 2e-4, greedy tokens equal, and the shared block's
k/v cache equal to the JAX package's after the prefill and after each
step: this pins the port's decision to reproduce the reference's ring
(the prefill keeps the last W keys in slots 0..W-1 and the first decode
step overwrites slot S % W, the oldest key only when S % W == 0)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jax_get_arch
from repro.models import build_model as jax_build_model
from repro.models.layers import chunked_attention
from repro_torch.configs import get_arch
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import build_model
from repro_torch.models.convert import from_jax_params

F32_TOL = dict(rtol=2e-4, atol=2e-4)
ARCH = "zamba2-2.7b"
B, W, STEPS = 2, 32, 4


@pytest.mark.parametrize("S,window", [(200, 70), (160, 63), (130, 64),
                                      (96, 0)])
def test_plain_window_matches_chunked_attention(S, window):
    r = np.random.default_rng(S + window)
    H, KVH, D = 4, 2, 32
    q = r.normal(size=(2, S, H, D)).astype(np.float32)
    k = r.normal(size=(2, S, KVH, D)).astype(np.float32)
    v = r.normal(size=(2, S, KVH, D)).astype(np.float32)
    want = chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             chunk=64, window=window)
    before = FA.flash_attention.plain_calls
    got = FA.flash_attention(torch.tensor(q), torch.tensor(k),
                             torch.tensor(v), window=window)
    assert FA.flash_attention.plain_calls == before + 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    # a row sees W + 1 keys: the window changes every row past W
    full = FA.flash_attention_plain(torch.tensor(q), torch.tensor(k),
                                    torch.tensor(v))
    assert torch.equal(full[:, :window + 1], got[:, :window + 1])
    assert (full[:, window + 1:] - got[:, window + 1:]).abs().amax(
        (0, 2, 3)).min() > 0


def test_window_refusals():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="causal"):
        FA.flash_attention(q, q, q, causal=False, window=4)
    with pytest.raises(ValueError, match="window"):
        FA.flash_attention(q, q, q, window=-1)
    with pytest.raises(ValueError, match="backward"):
        FA.flash_attention(q.requires_grad_(), q, q, window=4)


# ------------------------------------------------------- hybrid past W
def _perturb(tree, rng):
    """As tests/test_torch_mamba.py: the SSM carries its state across
    chunks and every norm weight counts."""
    def walk(node):
        for k, a in node.items():
            if isinstance(a, dict):
                walk(a)
            elif k == "A_log":
                a[...] = np.log(rng.uniform(0.01, 0.1, a.shape))
            elif k == "dt_bias":
                a[...] = -3.0 + 0.1 * rng.normal(size=a.shape)
            elif k in ("D", "conv_b"):
                a[...] = rng.normal(size=a.shape) * (0.1 if k == "conv_b"
                                                     else 1.0)
            elif k in ("gate_norm", "norm1", "norm2", "final_norm"):
                a[...] = 1.0 + 0.1 * rng.normal(size=a.shape)
    walk(tree)


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg = jax_get_arch(ARCH).smoke()
    cfg = get_arch(ARCH).smoke()
    jm = jax_build_model(jcfg)
    params, _ = jm.init(jax.random.key(0))
    tree = jax.tree.map(lambda a: np.array(a, np.float32), params)
    rng = np.random.default_rng(17)
    _perturb(tree, rng)
    params = jax.tree.map(jnp.asarray, tree)
    model = build_model(cfg, "cpu")
    model.load_state_dict(from_jax_params(cfg, tree))
    return jm, params, model, rng.integers(0, cfg.vocab_size, (B, 96))


def _np(x):
    return x.to(torch.float32).numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@pytest.mark.parametrize("S", [80, 64])
def test_hybrid_prefill_past_the_cache_matches_jax(S):
    """S = 80 (S % W = 16: the first decode step overwrites slot 16, not
    the oldest key) and S = 64 (S % W = 0)."""
    jm, params, model, toks = _setup()
    tokens = toks[:, :S].astype(np.int32)
    jc = jm.cache_spec(B, W).zeros()
    jl, jc = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(tokens)},
                                 jc)
    tc = model.cache_spec(B, W).zeros("cpu")
    assert tc["k"].shape[2] == W < S
    before = FA.flash_attention.plain_calls
    tl, tc = model.prefill({"tokens": torch.tensor(tokens).long()}, tc)
    n_shared = model.cfg.n_layers // model.cfg.attn_every
    assert FA.flash_attention.plain_calls - before == n_shared
    dec = jax.jit(jm.decode_step)
    for step in range(STEPS + 1):
        np.testing.assert_allclose(_np(tl), _np(jl), **F32_TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(tc[name]), _np(jc[name]),
                                       **F32_TOL)
        if step == STEPS:
            break
        jt = jnp.argmax(jl[:, -1], -1)[:, None]
        tt = tl[:, -1].argmax(-1)[:, None]
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jl, jc = dec(params, jt, jc)
        tl, tc = model.decode_step(tt, tc)
    assert tc["length"] == int(jc["length"]) == S + STEPS
