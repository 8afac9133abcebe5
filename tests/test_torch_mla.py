"""The port's multi-head latent attention (DeepSeek-V3) against the JAX
package's, on the same seeded numpy inputs and weights:

* K2's plain version with a value head dim of its own against
  `chunked_attention` (and the wrapper on CPU tensors);
* K3-mla's plain version (`mla_decode_attention_plain`) against the
  attention core of `_decode_mla`, at length 0 and mid-cache;
* `layers.MLA.prefill` / ``decode`` against `mla_apply` / `_decode_mla`,
  at the ``.smoke()`` config and at the smoke size with the published
  head dims (qk_nope 128, qk_rope 64, v 128, kv_lora 512);
* the whole model (`Model.prefill` and 4 decode steps) against the JAX
  model, for the dense oracle and the capacity dispatch with a drop:
  f32 within 2e-4, greedy tokens and the latent caches equal after the
  prefill and every step; bf16 within 5e-2 of the largest logit, fed
  the JAX package's tokens;
* `from_jax_params` strict both ways, MTP's leaves included.
"""
import functools
import importlib.util
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jax_get_arch
from repro.models import build_model as jax_build_model
from repro.models import layers as JL
from repro.models.model import _decode_mla, _identity_sharder
from repro_torch.configs import get_arch
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models.convert import from_jax_params
from repro_torch.models.model import moe_capacity

def _load_chip_smoke():
    """chip_smoke.py (the repository root's), for its `parity_weights`."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _load_chip_smoke()
ARCH = "deepseek-v3-671b"
B, S, T, STEPS = 2, 24, 32, 4
F32_TOL = dict(rtol=2e-4, atol=2e-4)
# the smoke size with DeepSeek-V3's published head dims (chip_smoke's
# model_parity MLA rows)
PUBLISHED_HEADS = dict(qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
                       kv_lora_rank=512, head_dim=192)
CONFIGS = {"smoke": {}, "published heads": PUBLISHED_HEADS}


def _np(x):
    return x.to(torch.float32).numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@functools.lru_cache(maxsize=None)
def _setup(heads="smoke", dtype="float32", **over):
    """Both models on the same weights (shared by the tests, which do not
    change them): `chip_smoke.parity_weights`, numpy draws by the JAX
    parameter tree's shapes (norms around 1, every matrix at its fan-in
    scale, MLA's ``wo`` at 1/sqrt(h dv)), cast to the dtype."""
    kw = dict(CONFIGS[heads], param_dtype=dtype, compute_dtype=dtype,
              **over)
    jcfg = jax_get_arch(ARCH).smoke().replace(**kw)
    cfg = get_arch(ARCH).smoke().replace(**kw)
    jm = jax_build_model(jcfg)
    abstract = jm.init_abstract()[0]
    flat = {_path_name(p): leaf.shape for p, leaf in
            jax.tree_util.tree_flatten_with_path(abstract)[0]}
    w = cs.parity_weights(np, flat)
    tree = jax.tree_util.tree_map_with_path(
        lambda p, leaf: w[_path_name(p)], abstract)
    params = jax.tree.map(lambda a: jnp.asarray(a, jcfg.pdtype), tree)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    model = build_model(cfg, "cpu")
    model.load_state_dict(from_jax_params(cfg, tree))
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, jm, params, tree, model, tokens


def _path_name(path):
    return ".".join(k.key for k in path)


def _randn(r, *shape):
    return r.standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------ K2, Dv != D
@pytest.mark.parametrize("D,Dv", [(192, 128), (48, 32)])
def test_flash_attention_plain_with_own_value_dim_matches_jax(D, Dv):
    """K2's plain version (and its wrapper on CPU tensors, at the pair
    the kernel takes) with v's head dim its own, against
    `chunked_attention`, causal, at a ragged length
    and over a GQA group; the scale 1/sqrt(D) by default and MLA's
    explicit one."""
    r = np.random.default_rng(1)
    q, k = _randn(r, 2, 40, 4, D), _randn(r, 2, 40, 2, D)
    v = _randn(r, 2, 40, 2, Dv)
    for scale in (None, 1.0 / math.sqrt(D + 8)):
        want = JL.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), chunk=16,
                                    softmax_scale=scale)
        tq, tk, tv = (torch.tensor(x) for x in (q, k, v))
        got = FA.flash_attention_plain(tq, tk, tv, scale=scale)
        assert got.shape == (2, 40, 4, Dv)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **F32_TOL)
        if (D, Dv) not in FA.HEAD_DIM_PAIRS:
            continue
        before = FA.flash_attention.plain_calls
        np.testing.assert_array_equal(
            FA.flash_attention(tq, tk, tv, scale=scale).numpy(),
            got.numpy())
        assert FA.flash_attention.plain_calls == before + 1


def test_flash_attention_value_dim_refusals():
    """Pairs the kernel does not take raise; (192, 128) takes no window
    and no gradient (no backward kernel: no JAX path trains MLA here)."""
    q, k = torch.zeros(1, 8, 2, 192), torch.zeros(1, 8, 2, 192)
    with pytest.raises(ValueError, match=r"head dim \d+ \(v \d+\)"):
        FA.flash_attention(torch.zeros(1, 8, 2, 64),
                           torch.zeros(1, 8, 2, 64), torch.zeros(1, 8, 2, 32))
    with pytest.raises(ValueError, match="window"):
        FA.flash_attention(q, k, torch.zeros(1, 8, 2, 128), window=4)
    with pytest.raises(ValueError, match=r"head dim \d+ \(v \d+\)"):
        FA.flash_attention(q.requires_grad_(), k, torch.zeros(1, 8, 2, 128))


# --------------------------------------------------------------- K3-mla
@functools.partial(jax.jit, static_argnums=(4, 5))
def _jax_core(q_abs, q_rope, c_kv, k_rope, length, scale_div):
    """The attention core of `_decode_mla` (model.py:994-1003), its
    einsums as written there, each operand widened to f32 first: the
    products of bf16 values are exact in f32, so this is the
    ``preferred_element_type=f32`` product, which XLA's CPU runtime does
    not take for these batched bf16 operands outside the fused model."""
    jd = q_abs.dtype
    f32 = jnp.float32
    Tn = c_kv.shape[1]
    s_nope = jnp.einsum("bshr,btr->bhst", q_abs.astype(f32),
                        c_kv.astype(f32))
    s_rope = jnp.einsum("bshk,btk->bhst", q_rope.astype(f32),
                        k_rope.astype(f32))
    scores = (s_nope + s_rope) / scale_div
    valid = jnp.arange(Tn) <= length
    scores = jnp.where(valid[None, None, None, :], scores, -jnp.inf)
    p = jax.nn.softmax(scores, axis=-1)
    lat = jnp.einsum("bhst,btr->bshr", p.astype(jd).astype(f32),
                     c_kv.astype(f32))
    return lat.astype(jd)


def _jax_mla_core(q_abs, q_rope, c_kv, k_rope, length, scale_div, dtype):
    jd = jnp.dtype(dtype)
    return np.asarray(_jax_core(*(jnp.asarray(x, jd) for x in
                                  (q_abs, q_rope, c_kv, k_rope)),
                                length, scale_div), np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length", [0, 13, 31])
@pytest.mark.parametrize("R,DR,H", [(512, 64, 16), (32, 16, 4)])
def test_mla_decode_plain_matches_jax_core(dtype, length, R, DR, H):
    """At length 0, mid-cache and the full cache; f32 within 2e-4; bf16
    (the weights rounded to bf16 on both sides) within one bf16 ulp of
    the output plus the sums' order."""
    r = np.random.default_rng(length + R)
    q_abs, q_rope = _randn(r, 2, 1, H, R), _randn(r, 2, 1, H, DR)
    c_kv, k_rope = _randn(r, 2, T, R), _randn(r, 2, T, DR)
    div = math.sqrt(128 + DR)
    want = _jax_mla_core(q_abs, q_rope, c_kv, k_rope, length, div, dtype)
    td = getattr(torch, dtype)
    args = [torch.tensor(x).to(td) for x in (q_abs, q_rope, c_kv, k_rope)]
    got = DA.mla_decode_attention_plain(*args, length, scale=1.0 / div)
    assert got.shape == (2, 1, H, R) and got.dtype == td
    tol = F32_TOL if dtype == "float32" else dict(rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(_np(got), want, **tol)
    before = DA.mla_decode_attention.plain_calls
    np.testing.assert_array_equal(
        _np(DA.mla_decode_attention(*args, length, scale=1.0 / div)),
        _np(got))
    assert DA.mla_decode_attention.plain_calls == before + 1


def test_mla_decode_reads_no_position_past_length():
    """What lies past ``length`` cannot leak in (the kernel never reads
    it either)."""
    r = np.random.default_rng(3)
    args = [torch.tensor(_randn(r, *s)) for s in
            ((1, 1, 4, 32), (1, 1, 4, 16), (1, T, 32), (1, T, 16))]
    a = DA.mla_decode_attention_plain(*args, 9, scale=0.1)
    args[2][:, 10:] = float("nan")
    args[3][:, 10:] = float("nan")
    torch.testing.assert_close(
        DA.mla_decode_attention_plain(*args, 9, scale=0.1), a)


def test_mla_decode_wrapper_refusals():
    z = torch.zeros
    with pytest.raises(ValueError, match="must be"):
        DA.mla_decode_attention(z(1, 2, 4, 32), z(1, 2, 4, 16), z(1, 8, 32),
                                z(1, 8, 16), 3, scale=0.1)
    with pytest.raises(TypeError, match="length"):
        DA.mla_decode_attention(z(1, 1, 4, 32), z(1, 1, 4, 16), z(1, 8, 32),
                                z(1, 8, 16), 3.0, scale=0.1)
    with pytest.raises(TypeError, match="dtype"):
        DA.mla_decode_attention(z(1, 1, 4, 32), z(1, 1, 4, 16),
                                z(1, 8, 32, dtype=torch.float64),
                                z(1, 8, 16), 3, scale=0.1)


# ------------------------------------------------------------ the layer
def _layer(tree, li=0):
    return jax.tree.map(lambda a: jnp.asarray(a[li]),
                        tree["dense_blocks"]["attn"])


@pytest.mark.parametrize("heads", sorted(CONFIGS))
def test_mla_layer_prefill_and_decode_match_jax(heads):
    """`MLA.prefill` against `mla_apply` (output and latent cache), then
    `MLA.decode` against `_decode_mla` at length S (mid-cache) and at
    length 0 (an empty cache), the caches after the write included."""
    jcfg, jm, _, tree, model, _ = _setup(heads)
    p, attn = _layer(tree), model.dense_blocks.attn
    r = np.random.default_rng(11)
    x = _randn(r, B, S, jcfg.d_model)
    jcos, jsin = jm._rope(jnp.arange(S))
    y, (c_kv, k_rope) = jax.jit(functools.partial(
        JL.mla_apply, cfg=jcfg, sharder=_identity_sharder))(
        p, x=jnp.asarray(x), cos=jcos, sin=jsin)
    cos, sin = model._rope(torch.arange(S))
    ty, (tc, tr) = attn.prefill(0, torch.tensor(x), cos, sin)
    for got, want in ((ty, y), (tc, c_kv), (tr, k_rope)):
        np.testing.assert_allclose(_np(got), np.asarray(want), **F32_TOL)
    x1 = _randn(r, B, 1, jcfg.d_model)
    decode = jax.jit(functools.partial(_decode_mla, cfg=jcfg,
                                       sharder=_identity_sharder))
    for length in (S, 0):
        jc = np.zeros((B, T, jcfg.kv_lora_rank), np.float32)
        jr = np.zeros((B, T, jcfg.qk_rope_dim), np.float32)
        jc[:, :length], jr[:, :length] = (np.asarray(c_kv)[:, :length],
                                          np.asarray(k_rope)[:, :length])
        jcos1, jsin1 = jm._rope(jnp.arange(length, length + 1))
        y1, (jc1, jr1) = decode(p, x=jnp.asarray(x1), cos=jcos1, sin=jsin1,
                                ckv_cache=jnp.asarray(jc),
                                krope_cache=jnp.asarray(jr),
                                length=jnp.asarray(length))
        tc1, tr1 = torch.tensor(jc), torch.tensor(jr)
        cos1, sin1 = model._rope(torch.arange(length, length + 1))
        ty1 = attn.decode(0, torch.tensor(x1), cos1, sin1, tc1, tr1,
                          min(length, T - 1), length)
        for got, want in ((ty1, y1), (tc1, jc1), (tr1, jr1)):
            np.testing.assert_allclose(_np(got), np.asarray(want),
                                       **F32_TOL)


# ------------------------------------------------------------ the model
def _copy(cache):
    return {k: v.clone() if isinstance(v, torch.Tensor) else v
            for k, v in cache.items()}


def _run(jm, params, model, tokens, *, follow_jax_tokens):
    """Prefill + STEPS decode steps in both, as test_torch_moe."""
    B = tokens.shape[0]
    jc = jm.cache_spec(B, T).zeros()
    jl, jc = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(tokens)},
                                 jc)
    tc = model.cache_spec(B, T).zeros("cpu")
    tl, tc = model.prefill({"tokens": torch.tensor(tokens).long()}, tc)
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
@pytest.mark.parametrize("heads", sorted(CONFIGS))
def test_f32_model_matches_jax(heads, impl, cf):
    """``auto`` is the dense oracle at 8 experts; ``ep`` at capacity
    factor 0.5 drops choices in the prefill (capacity 3 of 24 tokens x 2
    choices over 8 experts, as test_torch_moe). K2 runs once a layer a
    prefill and K3-mla once a layer a step."""
    jcfg, jm, params, tree, model, tokens = _setup(
        heads, moe_impl=impl, capacity_factor=cf)
    seen = {"dropped": 0}
    orig = L.moe_dispatch_indices

    def spy(top_e, top_p, n_experts, capacity):
        slot, w = orig(top_e, top_p, n_experts, capacity)
        if top_e.shape[1] == S:                      # the prefill's
            seen["dropped"] += int((slot == capacity).sum())
        return slot, w

    before = (FA.flash_attention.plain_calls,
              DA.mla_decode_attention.plain_calls,
              DA.decode_attention.plain_calls)
    L.moe_dispatch_indices = spy
    try:
        logits, toks, caches = _run(jm, params, model, tokens,
                                    follow_jax_tokens=False)
    finally:
        L.moe_dispatch_indices = orig
    assert (seen["dropped"] > 0) == (impl == "ep")
    if impl == "ep":
        assert moe_capacity(model.cfg, S) == 3
    for want, got in logits:
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **F32_TOL)
    for jt, tt in toks:
        np.testing.assert_array_equal(tt, jt)
    for jc, tc in caches:
        assert set(tc) == {"c_kv", "k_rope", "length"}
        for name in ("c_kv", "k_rope"):
            assert tuple(tc[name].shape) == jc[name].shape
            np.testing.assert_allclose(_np(tc[name]), _np(jc[name]),
                                       **F32_TOL)
    n = model.cfg.n_layers
    assert FA.flash_attention.plain_calls - before[0] == n
    assert DA.mla_decode_attention.plain_calls - before[1] == n * STEPS
    assert DA.decode_attention.plain_calls == before[2]


def _jax_f32_steps(jcfg, params, tokens, jax_tokens):
    """The JAX model in f32 on the bf16 weights (widened exactly), fed
    ``tokens`` and then ``jax_tokens``: each step's logits."""
    jm = jax_build_model(jcfg.replace(param_dtype="float32",
                                      compute_dtype="float32"))
    pf = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    jc = jm.cache_spec(tokens.shape[0], T).zeros()
    jl, jc = jax.jit(jm.prefill)(pf, {"tokens": jnp.asarray(tokens)}, jc)
    out = [_np(jl)]
    dec = jax.jit(jm.decode_step)
    for jt in jax_tokens:
        jl, jc = dec(pf, jnp.asarray(jt), jc)
        out.append(_np(jl))
    return out


@pytest.mark.parametrize("row", [0, 1])
@pytest.mark.parametrize("heads", sorted(CONFIGS))
def test_bf16_model_matches_jax_within_rounding(heads, row):
    """bf16: the norms' and the residual's roundings (test_torch_model)
    and K3-mla's weights rounded under each block's running max where
    the JAX model rounds the normalized ones; fed the JAX tokens. Bound:
    5e-2 of the largest |logit| against the JAX model run in f32 on the
    same (bf16) weights and tokens; and against the JAX model's bf16
    run, 5e-2 plus that run's own distance from its f32 run (as
    test_torch_train adds the JAX package's f32 error): on these weights
    the JAX package's own bf16 logits lie up to 0.21 of the largest from
    its f32 ones (in sequence 0 of the smoke config its bf16 router
    picks another expert for a token), 2.6e-2 elsewhere, where the
    port's stay within 2.7e-2.
    One sequence a run: at B = 2 the JAX package's bf16 `_decode_mla`
    reaches a batched bf16 x bf16 -> f32 product that this JAX's CPU
    runtime does not execute ("Unsupported element type for
    DotThunk")."""
    jcfg, jm, params, _, model, tokens = _setup(heads, "bfloat16")
    tok = tokens[row:row + 1]
    logits, toks, _ = _run(jm, params, model, tok, follow_jax_tokens=True)
    exact = _jax_f32_steps(jcfg, params, tok, [jt for jt, _ in toks])
    for (want, got), f32 in zip(logits, exact):
        assert np.isfinite(got).all()
        amax = np.abs(f32).max()
        assert np.abs(got - f32).max() <= 5e-2 * amax
        own = np.abs(want - f32).max()
        assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max() + own


# -------------------------------------------------------------- weights
def test_from_jax_params_is_strict_both_ways_mtp_included():
    """Every JAX leaf, MTP's too, has its parameter and every parameter
    its leaf; a missing or an extra leaf fails the strict load; the
    layouts are the JAX package's."""
    jcfg, _, _, tree, model, _ = _setup()
    sd = from_jax_params(model.cfg, tree)
    assert set(sd) == set(model.state_dict())
    mtp = {k for k in sd if k.startswith("mtp.")}
    assert {"mtp.mtp_proj", "mtp.mtp_block.attn.wkv_a",
            "mtp.mtp_block.mlp.w_gate", "mtp.mtp_block.norm1"} <= mtp
    for k, v in model.state_dict().items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    assert tuple(sd["dense_blocks.attn.wq_b"].shape) == (
        jcfg.first_dense_layers, jcfg.q_lora_rank, jcfg.n_heads,
        jcfg.qk_nope_dim + jcfg.qk_rope_dim)
    fresh = build_model(model.cfg, "cpu")
    fresh.load_state_dict(sd)
    short = dict(sd)
    del short["mtp.mtp_proj"]
    with pytest.raises(RuntimeError, match="mtp.mtp_proj"):
        fresh.load_state_dict(short)
    with pytest.raises(RuntimeError, match="extra"):
        fresh.load_state_dict(dict(sd, **{"mtp.extra": torch.zeros(1)}))


def test_full_width_parameters_and_cache():
    """DeepSeek-V3-671B at published widths on the meta device: the JAX
    package's count at every depth cut (the 4 layers chip_smoke serves:
    3 dense + 1 MoE, MTP held), and the latent cache (kv_lora_rank +
    qk_rope_dim a token a layer) the JAX package's."""
    from repro_torch.models import Model
    jcfg = jax_get_arch(ARCH).replace(n_layers=4)
    cfg = get_arch(ARCH).replace(n_layers=4)
    m = Model(cfg, "meta")
    abstract = jax_build_model(jcfg).init_abstract()[0]
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(abstract))
    assert sum(p.numel() for p in m.parameters()) == want
    spec = m.cache_spec(2, 1024)
    jspec = jax_build_model(jcfg).cache_spec(2, 1024)
    assert spec.shapes == jspec.shapes
    assert spec.shapes == {"c_kv": (4, 2, 1024, 512),
                           "k_rope": (4, 2, 1024, 64)}
