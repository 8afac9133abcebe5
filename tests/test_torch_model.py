"""The port's dense model against the JAX package's, on the same
weights: `get_arch(...).smoke()` for qwen3-4b (qk-norm) and qwen1.5-4b
(qkv bias), JAX ``init`` -> numpy -> `from_jax_params`, then the
prefill logits and 4 decode steps through `Model.prefill` /
`decode_step` (whose kernels take their plain versions on the CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jax_get_arch
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_arch
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import rmsnorm as RN
from repro_torch.models import build_model
from repro_torch.models.convert import from_jax_params

ARCHS = ("qwen3-4b", "qwen1.5-4b")
B, S, T, STEPS = 2, 24, 32, 4


def _setup(arch, dtype):
    """Both models on the same weights. Biases and norm weights are
    drawn at random (JAX inits them to 0 and 1, which would leave the
    bias adds and weight products untested)."""
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    jcfg = jax_get_arch(arch).smoke().replace(**kw)
    cfg = get_arch(arch).smoke().replace(**kw)
    assert cfg == get_arch(arch).smoke().replace(**kw)
    jm = jax_build_model(jcfg)
    params, _ = jm.init(jax.random.key(0))
    tree = jax.tree.map(lambda a: np.array(a, np.float32), params)
    r = np.random.default_rng(3)
    for name in ("bq", "bk", "bv"):
        if name in tree["blocks"]["attn"]:
            a = tree["blocks"]["attn"][name]
            a[...] = r.normal(size=a.shape) * 0.1
    for parent, name in ((tree["blocks"], "norm1"), (tree["blocks"],
                         "norm2"), (tree, "final_norm"),
                         (tree["blocks"]["attn"], "q_norm"),
                         (tree["blocks"]["attn"], "k_norm")):
        if name in parent:
            a = parent[name]
            a[...] = 1.0 + r.normal(size=a.shape) * 0.1
    params = jax.tree.map(lambda a: jnp.asarray(a, jcfg.pdtype), tree)
    model = build_model(cfg, "cpu")
    model.load_state_dict(from_jax_params(cfg, tree))
    tokens = r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return jm, params, model, tokens


def _np(x):
    return x.to(torch.float32).numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _run(jm, params, model, tokens, *, follow_jax_tokens):
    """Prefill + STEPS decode steps in both. Returns the per-step logits
    of both and the greedy tokens of both. With ``follow_jax_tokens``
    both packages decode the JAX package's greedy tokens (so that one
    near-tie in bf16 cannot send them down different paths)."""
    jc = jm.cache_spec(B, T).zeros()
    jl, jc = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(tokens)},
                                 jc)
    tc = model.cache_spec(B, T).zeros("cpu")
    tl, tc = model.prefill({"tokens": torch.tensor(tokens).long()}, tc)
    logits, toks = [(_np(jl), _np(tl))], []
    dec = jax.jit(jm.decode_step)
    for _ in range(STEPS):
        jt = jnp.argmax(jl[:, -1], -1)[:, None]
        tt = tl[:, -1].argmax(-1)[:, None]
        toks.append((np.asarray(jt), tt.numpy()))
        if follow_jax_tokens:
            tt = torch.tensor(np.asarray(jt)).long()
        jl, jc = dec(params, jt, jc)
        tl, tc = model.decode_step(tt, tc)
        logits.append((_np(jl), _np(tl)))
    assert tc["length"] == int(jc["length"]) == S + STEPS
    return logits, toks, (jc, tc)


@pytest.mark.parametrize("arch", ARCHS)
def test_f32_model_matches_jax(arch):
    jm, params, model, tokens = _setup(arch, "float32")
    counts = (FA.flash_attention.plain_calls,
              DA.decode_attention.plain_calls, RN.rmsnorm.plain_calls,
              RN.rmsnorm_residual.plain_calls)
    logits, toks, (jc, tc) = _run(jm, params, model, tokens,
                                  follow_jax_tokens=False)
    for want, got in logits:
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    for jt, tt in toks:
        np.testing.assert_array_equal(tt, jt)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]),
                                   rtol=2e-4, atol=2e-4)
    # the model went through every kernel's wrapper
    n_layers = model.cfg.n_layers
    after = (FA.flash_attention.plain_calls,
             DA.decode_attention.plain_calls, RN.rmsnorm.plain_calls,
             RN.rmsnorm_residual.plain_calls)
    assert after[0] - counts[0] == n_layers
    assert after[1] - counts[1] == n_layers * STEPS
    assert after[2] > counts[2]
    assert after[3] - counts[3] == 2 * n_layers * (1 + STEPS)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_model_matches_jax_within_rounding(arch):
    """In bf16 the port rounds differently in three places (the norms
    multiply by the weight before their one cast, a fused norm reads the
    unrounded residual sum, decode attention keeps its softmax weights
    in f32), each about one bf16 ulp (2^-8 relative) of an activation,
    carried through the layers. Bound: 5e-2 of the largest |logit|."""
    jm, params, model, tokens = _setup(arch, "bfloat16")
    logits, _, _ = _run(jm, params, model, tokens, follow_jax_tokens=True)
    for want, got in logits:
        assert np.isfinite(got).all()
        bound = 5e-2 * np.abs(want).max()
        assert np.abs(got - want).max() <= bound


def test_decode_continues_prefill():
    """Prefill of S tokens then decoding token S gives the logits of a
    prefill of S + 1 tokens (the cache is written and read right)."""
    cfg = get_arch("qwen3-4b").smoke()
    model = build_model(cfg, "cpu").init_weights(
        torch.Generator().manual_seed(0))
    toks = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 9)))
    full, _ = model.prefill({"tokens": toks}, model.cache_spec(1, 16)
                            .zeros("cpu"))
    _, cache = model.prefill({"tokens": toks[:, :8]},
                             model.cache_spec(1, 16).zeros("cpu"))
    step, cache = model.decode_step(toks[:, 8:], cache)
    torch.testing.assert_close(step, full, rtol=2e-4, atol=2e-4)
    assert cache["length"] == 9


@pytest.mark.parametrize("name", ["internvl2-76b", "whisper-tiny"])
def test_other_families_name_their_roadmap_item(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_arch(name)


def test_dense_configs_are_the_jax_packages():
    for name in ("qwen3-4b", "qwen3-14b", "qwen1.5-4b", "internlm2-20b"):
        a, b = get_arch(name), jax_get_arch(name)
        assert {k: getattr(a, k) for k in a.__dataclass_fields__} == \
            {k: getattr(b, k) for k in b.__dataclass_fields__}


def test_moe_config_is_the_jax_packages():
    """deepseek-moe-16b builds in the port (the MoE family, ROADMAP Queue
    1, item 6.3), field for field the JAX package's config."""
    a, b = get_arch("deepseek-moe-16b"), jax_get_arch("deepseek-moe-16b")
    assert {k: getattr(a, k) for k in a.__dataclass_fields__} == \
        {k: getattr(b, k) for k in b.__dataclass_fields__}


def test_mla_config_is_the_jax_packages():
    """deepseek-v3-671b builds in the port (MLA and MTP in the MoE
    family, ROADMAP Queue 1, item 6.3), field for field the JAX
    package's config."""
    a, b = get_arch("deepseek-v3-671b"), jax_get_arch("deepseek-v3-671b")
    assert {k: getattr(a, k) for k in a.__dataclass_fields__} == \
        {k: getattr(b, k) for k in b.__dataclass_fields__}


def test_build_model_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(get_arch("qwen3-4b").smoke())
