"""The port's MoE family (DeepSeek-MoE without MLA) against the JAX
package's, on the same weights: the layer functions (`router_probs`,
`moe_dispatch_indices`, `moe_apply_capacity` uncapped and dropping,
`moe_apply_dense`, the shared expert) on seeded numpy inputs, and the
smoke model (`get_arch("deepseek-moe-16b").smoke()`: 4 layers, the first
dense, 8 experts top-2, one shared) through `Model.prefill` and 4 decode
steps for both impls, JAX ``init`` -> numpy -> `from_jax_params`.

Bars: f32 within 2e-4 with the router's choices (``top_e``) and their
slots exact and the greedy tokens equal; bf16 within 5e-2 of the largest
logit, fed the JAX package's tokens (a 1-ulp difference in the router
can change an expert in bf16)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jax_get_arch
from repro.models import build_model as jax_build_model
from repro.models import layers as JL
from repro.models.model import _identity_sharder
from repro.models.model import _moe_capacity as jax_moe_capacity
from repro_torch.configs import get_arch
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models.cache import cache_spec
from repro_torch.models.convert import from_jax_params
from repro_torch.models.model import moe_capacity, moe_impl

ARCH = "deepseek-moe-16b"
B, S, T, STEPS = 2, 24, 32, 4
F32_TOL = dict(rtol=2e-4, atol=2e-4)


def _np(x):
    return x.to(torch.float32).numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _perturb(tree, r):
    """Norm weights drawn around 1 (JAX inits them to ones, which would
    leave the weight products untested); the router at 10x its init
    scale, so that its choices are not near ties; the experts' weights
    (L, E, d_in, d_out) N(0, 1 / d_in), the fan-in scale of every other
    weight and of chip_smoke.parity_weights (the JAX init scales them by
    1 / sqrt(E), which grows the residual stream a hundredfold a
    layer)."""
    def walk(node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v)
            elif k in ("norm1", "norm2", "final_norm"):
                v[...] = 1.0 + 0.1 * r.normal(size=v.shape)
            elif k == "router":
                v[...] = 0.2 * r.normal(size=v.shape)
            elif k in ("we_gate", "we_up", "we_down"):
                v[...] = r.normal(size=v.shape) / np.sqrt(v.shape[2])
    walk(tree)


@functools.lru_cache(maxsize=None)
def _setup(dtype="float32", **over):
    """Both models on the same weights (shared by the tests, which do not
    change them)."""
    kw = dict(param_dtype=dtype, compute_dtype=dtype, **over)
    jcfg = jax_get_arch(ARCH).smoke().replace(**kw)
    cfg = get_arch(ARCH).smoke().replace(**kw)
    jm = jax_build_model(jcfg)
    params, _ = jm.init(jax.random.key(0))
    tree = jax.tree.map(lambda a: np.array(a, np.float32), params)
    r = np.random.default_rng(5)
    _perturb(tree, r)
    params = jax.tree.map(lambda a: jnp.asarray(a, jcfg.pdtype), tree)
    model = build_model(cfg, "cpu")
    model.load_state_dict(from_jax_params(cfg, tree))
    tokens = r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, jm, params, tree, model, tokens


def _layer(tree, model, li=0):
    """Layer ``li``'s MoE params as the JAX subtree and the port's
    module (stacked; the port's functions take the index)."""
    p = jax.tree.map(lambda a: jnp.asarray(a[li]),
                     tree["moe_blocks"]["moe"])
    return p, model.moe_blocks.moe


def _x(d, n=S, seed=7):
    return np.random.default_rng(seed).normal(size=(B, n, d)).astype(
        np.float32)


# ---------------------------------------------------------------- layers
def test_router_and_dispatch_exact():
    jcfg, _, _, tree, model, _ = _setup()
    p, moe = _layer(tree, model)
    x = _x(jcfg.d_model)
    jp, jtp, jte = JL.router_probs(p, jcfg, jnp.asarray(x))
    tp, ttp, tte = L.router_probs(moe.router[0], moe.cfg, torch.tensor(x))
    np.testing.assert_array_equal(tte.numpy(), np.asarray(jte))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **F32_TOL)
    np.testing.assert_allclose(ttp.numpy(), np.asarray(jtp), **F32_TOL)
    for cap in (S * jcfg.topk, 3, 1):
        js, jw = JL.moe_dispatch_indices(jte, jtp, jcfg.n_experts, cap)
        ts, tw = L.moe_dispatch_indices(tte, ttp, jcfg.n_experts, cap)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **F32_TOL)
    ja = JL.moe_aux_loss(jp, jte, jcfg.n_experts)
    ta = L.moe_aux_loss(tp, tte, jcfg.n_experts)
    np.testing.assert_allclose(ta.item(), float(ja), **F32_TOL)


def test_top_k_breaks_ties_toward_the_lower_expert():
    """Equal router probabilities: the lower expert first, as
    ``lax.top_k``."""
    cfg = get_arch(ARCH).smoke()
    router = torch.zeros(cfg.d_model, cfg.n_experts)
    router[:, 5] = router[:, 2] = 1.0
    x = torch.ones(1, 3, cfg.d_model)
    _, _, te = L.router_probs(router, cfg, x)
    _, _, je = JL.router_probs({"router": jnp.asarray(router.numpy())},
                               jax_get_arch(ARCH).smoke(),
                               jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert te[0, 0].tolist() == [2, 5]


@pytest.mark.parametrize("cap", [None, 2])
def test_moe_apply_capacity_matches_jax(cap):
    """Uncapped (every choice kept) and at capacity 2 a row and expert,
    where most choices are dropped."""
    jcfg, _, _, tree, model, _ = _setup()
    p, moe = _layer(tree, model)
    x = _x(jcfg.d_model)
    cap = cap or S * jcfg.topk
    _, _, te = L.router_probs(moe.router[0], moe.cfg, torch.tensor(x))
    slot, _ = L.moe_dispatch_indices(te, te.float(), jcfg.n_experts, cap)
    assert ((slot == cap).sum() > 0) == (cap == 2)
    jy, ja = JL.moe_apply_capacity(p, jcfg, jnp.asarray(x),
                                   _identity_sharder, cap)
    ty, ta = L.moe_apply_capacity(moe, 0, torch.tensor(x), cap)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **F32_TOL)
    np.testing.assert_allclose(ta.item(), float(ja), **F32_TOL)


def test_moe_apply_dense_and_the_shared_expert_match_jax():
    jcfg, _, _, tree, model, _ = _setup()
    p, moe = _layer(tree, model)
    x = _x(jcfg.d_model)
    jy, ja = JL.moe_apply_dense(p, jcfg, jnp.asarray(x), _identity_sharder)
    ty, ta = L.moe_apply_dense(moe, 0, torch.tensor(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **F32_TOL)
    np.testing.assert_allclose(ta.item(), float(ja), **F32_TOL)
    js = JL._shared_expert(p, jcfg, jnp.asarray(x), _identity_sharder)
    ts = L._shared_expert(moe, 0, torch.tensor(x))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **F32_TOL)
    # the oracle and the uncapped capacity path compute one function
    tc, _ = L.moe_apply_capacity(moe, 0, torch.tensor(x), S * jcfg.topk)
    np.testing.assert_allclose(tc.numpy(), ty.numpy(), **F32_TOL)


def test_capacity_impl_and_cache_are_the_jax_packages():
    for name in (ARCH,):
        cfg, jcfg = get_arch(name), jax_get_arch(name)
        for n in (1, 7, 512, 2048):
            assert moe_capacity(cfg, n) == jax_moe_capacity(jcfg, n)
        assert moe_impl(cfg) == "ep" and moe_impl(cfg.smoke()) == "dense"
        jspec = jax_build_model(jcfg).cache_spec(2, 1280)
        spec = cache_spec(cfg, 2, 1280)
        assert spec.shapes == jspec.shapes
        assert spec.shapes["k"] == (28, 2, 1280, 16, 128)


# ----------------------------------------------------------------- model
def _copy(cache):
    return {k: v.clone() if isinstance(v, torch.Tensor) else v
            for k, v in cache.items()}


def _run(jm, params, model, tokens, *, follow_jax_tokens):
    """Prefill + STEPS decode steps in both, as test_torch_model."""
    jc = jm.cache_spec(B, T).zeros()
    jl, jc = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(tokens)},
                                 jc)
    tc = model.cache_spec(B, T).zeros("cpu")
    tl, tc = model.prefill({"tokens": torch.tensor(tokens).long()}, tc)
    # the port writes its cache in place: keep a copy of each step's
    logits, toks, caches = [(_np(jl), _np(tl))], [], [(jc, _copy(tc))]
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
        caches.append((jc, _copy(tc)))
    assert tc["length"] == int(jc["length"]) == S + STEPS
    return logits, toks, caches


@pytest.mark.parametrize("impl,cf", [("auto", 1.25), ("ep", 0.5)])
def test_f32_model_matches_jax(impl, cf):
    """``auto`` is the dense oracle at 8 experts; ``ep`` at capacity
    factor 0.5 drops choices in the prefill (capacity 3 of 24 tokens x 2
    choices over 8 experts)."""
    jcfg, jm, params, tree, model, tokens = _setup(
        moe_impl=impl, capacity_factor=cf)
    if impl == "ep":
        x = torch.tensor(_x(jcfg.d_model))
        _, _, te = L.router_probs(model.moe_blocks.moe.router[0],
                                  model.cfg, x)
        cap = moe_capacity(model.cfg, S)
        slot, _ = L.moe_dispatch_indices(te, te.float(), jcfg.n_experts,
                                         cap)
        assert cap == 3 and (slot == cap).any()
    before = (FA.flash_attention.plain_calls,
              DA.decode_attention.plain_calls)
    logits, toks, caches = _run(jm, params, model, tokens,
                                follow_jax_tokens=False)
    for want, got in logits:
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **F32_TOL)
    for jt, tt in toks:
        np.testing.assert_array_equal(tt, jt)
    for jc, tc in caches:
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(tc[name]), _np(jc[name]),
                                       **F32_TOL)
    n = model.cfg.n_layers
    assert FA.flash_attention.plain_calls - before[0] == n
    assert DA.decode_attention.plain_calls - before[1] == n * STEPS


def test_ep_prefill_drops_choices_in_the_model():
    """The ``ep`` case above really drops: the first MoE layer's input in
    the JAX prefill sends more than capacity choices to some expert."""
    jcfg, jm, params, tree, model, tokens = _setup(moe_impl="ep",
                                                    capacity_factor=0.5)
    cap = moe_capacity(model.cfg, S)
    seen = {}
    orig = L.moe_apply_capacity

    def spy(moe, l, x, capacity, aux=True):
        _, _, te = L.router_probs(moe.router[l], moe.cfg, x)
        slot, _ = L.moe_dispatch_indices(te, te.float(), moe.cfg.n_experts,
                                         capacity)
        seen.setdefault("dropped", 0)
        seen["dropped"] += int((slot == capacity).sum())
        return orig(moe, l, x, capacity, aux)

    L.moe_apply_capacity = spy
    try:
        model.prefill({"tokens": torch.tensor(tokens).long()},
                      model.cache_spec(B, T).zeros("cpu"))
    finally:
        L.moe_apply_capacity = orig
    assert cap == 3 and seen["dropped"] > 0


def test_bf16_model_matches_jax_within_rounding():
    """bf16: the norms' and the residual's roundings (test_torch_model);
    fed the JAX tokens. Bound: 5e-2 of the largest |logit|. The top-k is
    a step function: the two packages' bf16 roundings move a router
    logit by a few hundredths, which would swap two experts of a token
    whose logits are that close (none is, in this prompt at these
    weights); the choices themselves are held exactly in f32."""
    _, jm, params, _, model, tokens = _setup("bfloat16")
    logits, _, _ = _run(jm, params, model, tokens, follow_jax_tokens=True)
    for want, got in logits:
        assert np.isfinite(got).all()
        assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max()


def test_full_width_parameter_count_and_training_refusal():
    """DeepSeek-MoE-16B at its published widths on the meta device: the
    JAX package's count (16.4 B); `Model.loss` names its ROADMAP item,
    for the MLA smoke config too (MTP's loss comes with MoE training)."""
    from repro_torch.models import Model
    m = Model(get_arch(ARCH), "meta")
    assert sum(p.numel() for p in m.parameters()) == 16_375_728_128
    cfg = get_arch(ARCH).smoke()
    model = build_model(cfg, "cpu").init_weights(
        torch.Generator().manual_seed(0))
    tok = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(NotImplementedError, match=r"item 6\.3 \(MoE tr"):
        model.loss({"tokens": tok, "labels": tok})
    mla = build_model(get_arch("deepseek-v3-671b").smoke(), "cpu")
    with pytest.raises(NotImplementedError, match=r"MTP.*item 6\.3 \(MoE tr"):
        mla.loss({"tokens": tok, "labels": tok})
