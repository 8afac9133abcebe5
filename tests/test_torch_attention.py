"""Flash attention (K2) and decode attention (K3): the port's wrappers
on CPU tensors (their plain versions) against the JAX package's Pallas
kernels (interpret mode) and its pure-jnp oracles, at the shapes of
tests/test_kernels.py and with its tolerances. The CUDA kernels' own
checks against their plain versions need a card:
tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA

# tests/test_kernels.py's TOL
TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}


def _pair(r, shape, dtype):
    j = jnp.asarray(r.normal(size=shape), jnp.dtype(dtype))
    return j, torch.tensor(np.asarray(j, np.float32)).to(
        getattr(torch, dtype))


def _np(x):
    return x.to(torch.float32).numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@pytest.mark.parametrize("S,T,H,KVH,D,causal,dtype", [
    (128, 128, 4, 4, 64, True, "float32"),
    (128, 128, 4, 1, 64, True, "float32"),     # GQA group 4
    (256, 256, 8, 2, 128, True, "bfloat16"),
    (128, 128, 2, 2, 64, False, "float32"),    # bidirectional
    (100, 180, 4, 2, 64, False, "float32"),    # ragged S and T
    (100, 180, 4, 2, 32, True, "float32"),     # ragged, causal
])
def test_flash_attention_matches_pallas_and_ref(S, T, H, KVH, D, causal,
                                                dtype):
    r = np.random.default_rng(0)
    (jq, q), (jk, k), (jv, v) = (_pair(r, (2, S, H, D), dtype),
                                 _pair(r, (2, T, KVH, D), dtype),
                                 _pair(r, (2, T, KVH, D), dtype))
    before = FA.flash_attention.plain_calls
    got = FA.flash_attention(q, k, v, causal=causal)
    assert FA.flash_attention.plain_calls == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    pallas = ops.flash_attention(jq, jk, jv, causal=causal, block_q=64,
                                 block_k=64, interpret=True)
    want = ref.flash_attention_ref(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_np(got), _np(pallas), **TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("T,H,KVH,D,length,dtype", [
    (512, 8, 2, 64, 200, "float32"),
    (512, 8, 8, 128, 511, "bfloat16"),   # MHA, full cache
    (300, 4, 1, 64, 0, "float32"),       # length 0 (first token)
    (1024, 16, 2, 128, 700, "bfloat16"),
    (64, 4, 2, 32, 100, "float32"),      # length past the cache
])
def test_decode_attention_matches_pallas_and_ref(T, H, KVH, D, length,
                                                 dtype):
    r = np.random.default_rng(1)
    (jq, q), (jk, k), (jv, v) = (_pair(r, (2, 1, H, D), dtype),
                                 _pair(r, (2, T, KVH, D), dtype),
                                 _pair(r, (2, T, KVH, D), dtype))
    before = DA.decode_attention.plain_calls
    got = DA.decode_attention(q, k, v, length)
    assert DA.decode_attention.plain_calls == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    pallas = ops.decode_attention(jq, jk, jv, jnp.int32(length),
                                  block_k=128, interpret=True)
    want = ref.decode_attention_ref(jq, jk, jv, length)
    np.testing.assert_allclose(_np(got), _np(pallas), **TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


def test_decode_attention_ignores_positions_past_length():
    r = np.random.default_rng(2)
    q = torch.tensor(r.normal(size=(1, 1, 4, 32)), dtype=torch.float32)
    k = torch.tensor(r.normal(size=(1, 50, 2, 32)), dtype=torch.float32)
    v = torch.tensor(r.normal(size=(1, 50, 2, 32)), dtype=torch.float32)
    k2, v2 = k.clone(), v.clone()
    k2[:, 21:] = 1e4
    v2[:, 21:] = float("nan")
    torch.testing.assert_close(DA.decode_attention(q, k, v, 20),
                               DA.decode_attention(q, k2, v2, 20))


@pytest.mark.parametrize("bad,exc", [
    (dict(q=torch.ones(1, 8, 4, 48)), ValueError),          # head dim
    (dict(k=torch.ones(1, 8, 3, 32), v=torch.ones(1, 8, 3, 32)),
     ValueError),                                           # H % KVH
    (dict(v=torch.ones(1, 8, 2, 32, dtype=torch.bfloat16)), TypeError),
    (dict(q=torch.ones(1, 4, 8, 32).transpose(1, 2)), ValueError),
])
def test_flash_wrapper_rejects_what_the_kernel_does_not_take(bad, exc):
    a = dict(q=torch.ones(1, 8, 4, 32), k=torch.ones(1, 8, 2, 32),
             v=torch.ones(1, 8, 2, 32))
    a.update(bad)
    with pytest.raises(exc):
        FA.flash_attention(a["q"], a["k"], a["v"])


@pytest.mark.parametrize("bad,exc", [
    (dict(q=torch.ones(1, 2, 4, 32)), ValueError),          # two tokens
    (dict(length=torch.tensor(3)), TypeError),              # not an int
    (dict(length=-1), TypeError),
    (dict(q=torch.ones(1, 1, 4, 31), k=torch.ones(1, 8, 2, 31),
          v=torch.ones(1, 8, 2, 31)), ValueError),          # odd D
    (dict(q=torch.ones(1, 1, 4, 48), k=torch.ones(1, 8, 2, 48),
          v=torch.ones(1, 8, 2, 48)), ValueError),          # D not 2^k
])
def test_decode_wrapper_rejects_what_the_kernel_does_not_take(bad, exc):
    a = dict(q=torch.ones(1, 1, 4, 32), k=torch.ones(1, 8, 2, 32),
             v=torch.ones(1, 8, 2, 32), length=3)
    a.update(bad)
    with pytest.raises(exc):
        DA.decode_attention(a["q"], a["k"], a["v"], a["length"])


@pytest.mark.parametrize("n_valid", [1, 63, 64, 65, 1001, 2560, 100000])
@pytest.mark.parametrize("n_heads_kv,n_sms", [
    (8, 132),     # Qwen3-4B at B = 1: clusters of 16
    (64, 132),    # a batch that fills the card: small clusters
    (1, 4),
    (32, 132),    # Zamba2-2.7B's MHA block: clusters of 5
    (16, 132),    # Qwen3-4B at B = 2: clusters of 9
])
def test_decode_split_plan_covers_every_position_once(n_valid, n_heads_kv,
                                                      n_sms):
    """The cluster plan cuts the attended positions into contiguous
    ranges [i * per, min((i + 1) * per, n_valid)), one block each of a
    cluster: every position in exactly one range, none empty, the
    cluster within its size limit."""
    per, n_splits = DA.cluster_plan(n_valid, n_heads_kv, n_sms)
    assert per * n_splits >= n_valid > per * (n_splits - 1)
    assert per % DA.SPLIT_ALIGN == 0
    assert 1 <= n_splits <= DA.MAX_CLUSTER <= 16   # Hopper's cluster limit
    if n_splits > 1:
        assert per >= DA.MIN_SPLIT
        assert n_splits <= -(-n_sms // n_heads_kv)   # ~ a block an SM
    if n_valid <= 2560:
        seen = np.zeros(n_valid, np.int64)
        for i in range(n_splits):
            lo, hi = i * per, min((i + 1) * per, n_valid)
            assert hi > lo
            seen[lo:hi] += 1
        assert (seen == 1).all()
