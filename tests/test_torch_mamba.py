"""The port's ssm (Mamba2) and hybrid (Zamba2) models against the JAX
package's, on the same weights: `get_arch(...).smoke()` for mamba2-780m
and zamba2-2.7b, JAX ``init`` -> numpy -> `from_jax_params`, then the
prefill logits and 4 decode steps through `Model.prefill` /
`decode_step` (whose kernels take their plain versions on the CPU).

The JAX init leaves the SSM nearly memoryless (A_log = 1 and dt_bias = 0
decay the state by about e^-2 a token, so the inter-chunk state would
carry nothing and a broken one would pass), and its zeros and ones
leave the biases, skips and norm weights untested. So A_log is drawn
from log U(0.01, 0.1), dt_bias near -3, and D, conv_b, gate_norm and
every norm weight at random; each prompt spans several chunks (80
positions at the smoke chunk of 32)."""
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
from repro_torch.kernels import ssd_chunk as K5
from repro_torch.models import Model, build_model
from repro_torch.models.cache import cache_spec
from repro_torch.models.convert import from_jax_params

ARCHS = ("mamba2-780m", "zamba2-2.7b")
B, S, T, STEPS = 2, 80, 96, 4
F32_TOL = dict(rtol=2e-4, atol=2e-4)


def perturb(tree, rng):
    """Draw the SSM and norm leaves of a numpy parameter tree (nested, or
    flat with dotted names) in place, so that the state carries across
    chunks and every product counts."""
    def leaves(node):
        for k, v in node.items():
            if isinstance(v, dict):
                yield from leaves(v)
            else:
                yield k.rsplit(".", 1)[-1], v
    for name, a in leaves(tree):
        if name == "A_log":
            a[...] = np.log(rng.uniform(0.01, 0.1, a.shape))
        elif name == "dt_bias":
            a[...] = -3.0 + 0.1 * rng.normal(size=a.shape)
        elif name in ("D", "conv_b"):
            a[...] = rng.normal(size=a.shape) * (0.1 if name == "conv_b"
                                                 else 1.0)
        elif name in ("gate_norm", "norm1", "norm2", "final_norm"):
            a[...] = 1.0 + 0.1 * rng.normal(size=a.shape)


def _setup(arch, dtype):
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    jcfg = jax_get_arch(arch).smoke().replace(**kw)
    cfg = get_arch(arch).smoke().replace(**kw)
    jm = jax_build_model(jcfg)
    params, _ = jm.init(jax.random.key(0))
    tree = jax.tree.map(lambda a: np.array(a, np.float32), params)
    rng = np.random.default_rng(11)
    perturb(tree, rng)
    params = jax.tree.map(lambda a: jnp.asarray(a, jcfg.pdtype), tree)
    model = build_model(cfg, "cpu")
    model.load_state_dict(from_jax_params(cfg, tree))
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return jm, params, model, tokens


def _np(x):
    return x.to(torch.float32).numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _run(jm, params, model, tokens, *, follow_jax_tokens):
    """Prefill + STEPS decode steps in both; as in test_torch_model."""
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


def _counts():
    return (K5.ssd_chunk.plain_calls, FA.flash_attention.plain_calls,
            DA.decode_attention.plain_calls, RN.rmsnorm.plain_calls,
            RN.rmsnorm_residual.plain_calls)


@pytest.mark.parametrize("arch", ARCHS)
def test_f32_model_matches_jax(arch):
    jm, params, model, tokens = _setup(arch, "float32")
    before = _counts()
    logits, toks, (jc, tc) = _run(jm, params, model, tokens,
                                  follow_jax_tokens=False)
    for want, got in logits:
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **F32_TOL)
    for jt, tt in toks:
        np.testing.assert_array_equal(tt, jt)
    assert set(tc) == set(jc)
    for name in sorted(set(tc) - {"length"}):
        assert tc[name].dtype == (torch.float32 if name == "ssm"
                                  else model.cfg.cdtype)
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), **F32_TOL)
    # the model went through every kernel's wrapper: K5 once a layer a
    # prefill, K2 / K3 once a shared-block application
    cfg = model.cfg
    n_attn = cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
    d = [a - b for a, b in zip(_counts(), before)]
    assert d[0] == cfg.n_layers
    assert d[1] == n_attn and d[2] == n_attn * STEPS
    assert d[3] >= cfg.n_layers * (1 + STEPS)      # the gate norms
    assert d[4] == (cfg.n_layers + n_attn) * (1 + STEPS)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_model_matches_jax_within_rounding(arch):
    """bf16 rounds differently in the places test_torch_model names
    (norms, the fused residual norm, K3's f32 weights), each about one
    bf16 ulp of an activation. Bound: 5e-2 of the largest |logit|."""
    jm, params, model, tokens = _setup(arch, "bfloat16")
    logits, _, (jc, tc) = _run(jm, params, model, tokens,
                               follow_jax_tokens=True)
    assert tc["ssm"].dtype == torch.float32
    for want, got in logits:
        assert np.isfinite(got).all()
        assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max()


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_continues_prefill(arch):
    """Prefill of S tokens then decoding token S gives the logits of a
    prefill of S + 1 tokens (conv, SSM and k/v caches written and read
    right; S + 1 = 65 is ragged at the chunk of 32)."""
    cfg = get_arch(arch).smoke()
    model = build_model(cfg, "cpu")
    flat = {k: v.numpy().copy() for k, v in model.init_weights(
        torch.Generator().manual_seed(0)).state_dict().items()}
    perturb(flat, np.random.default_rng(2))
    model.load_state_dict(from_jax_params(cfg, flat))
    toks = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 65)))
    full, _ = model.prefill({"tokens": toks}, model.cache_spec(1, 72)
                            .zeros("cpu"))
    _, cache = model.prefill({"tokens": toks[:, :64]},
                             model.cache_spec(1, 72).zeros("cpu"))
    step, cache = model.decode_step(toks[:, 64:], cache)
    torch.testing.assert_close(step, full, **F32_TOL)
    assert cache["length"] == 65


def test_ssm_configs_are_the_jax_packages():
    for name in ARCHS:
        a, b = get_arch(name), jax_get_arch(name)
        assert {k: getattr(a, k) for k in a.__dataclass_fields__} == \
            {k: getattr(b, k) for k in b.__dataclass_fields__}


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_spec_is_the_jax_packages(arch):
    cfg = get_arch(arch)
    jspec = jax_build_model(jax_get_arch(arch)).cache_spec(2, 1280)
    spec = cache_spec(cfg, 2, 1280)
    assert spec.shapes == jspec.shapes
    assert {k: str(v).split(".")[-1] for k, v in spec.dtypes.items()} == \
        {k: jnp.dtype(v).name for k, v in jspec.dtypes.items()}


def test_hybrid_prompt_longer_than_the_cache_raises():
    """A hybrid prompt longer than the cache no longer raises: it is
    served through K2's sliding window (tests/test_torch_window.py holds
    it to the JAX package). What still raises is training through that
    window, which has no backward kernel (no JAX path trains with one)."""
    cfg = get_arch("zamba2-2.7b").smoke()
    model = build_model(cfg, "cpu").init_weights(
        torch.Generator().manual_seed(0))
    logits, cache = model.prefill(
        {"tokens": torch.zeros(1, 40, dtype=torch.long)},
        model.cache_spec(1, 32).zeros("cpu"))
    assert cache["length"] == 40 and torch.isfinite(logits).all()
    q = torch.zeros(1, 40, cfg.n_heads, cfg.head_dim, requires_grad=True)
    with pytest.raises(ValueError, match="backward"):
        FA.flash_attention(q, q, q, window=32)


def test_full_width_parameter_counts():
    """Mamba2-780M and Zamba2-2.7B at their published widths, counted
    on the meta device (nothing allocated): the JAX package's counts."""
    for arch, want in (("mamba2-780m", 857_403_648),
                       ("zamba2-2.7b", 2_435_777_440)):
        m = Model(get_arch(arch), "meta")
        assert sum(p.numel() for p in m.parameters()) == want


def test_serving_engine_serves_ssm_and_hybrid_functions():
    """The serving engine builds and serves either family through
    `build_model` / `cache_spec` alone (smoke widths, on the CPU)."""
    from repro_torch.core.request import Request
    from repro_torch.serving import EdgeServingEngine, ServedFunction
    fns = [ServedFunction(i, get_arch(a).smoke(), prompt_len=40,
                          gen_tokens=2, max_len=48)
           for i, a in enumerate(ARCHS)]
    eng = EdgeServingEngine(fns, capacity=1, policy="esff", device="cpu")
    reqs = [Request(i, i % 2, 0.25 * i, 0.0) for i in range(4)]
    before = K5.ssd_chunk.plain_calls
    res = eng.run(reqs)
    assert len(res.responses) == 4 and (res.responses > 0).all()
    assert res.server.cold_starts >= 2
    assert K5.ssd_chunk.plain_calls > before
