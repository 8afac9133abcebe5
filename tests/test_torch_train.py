"""The port's training slice against the JAX package's, on the
same numpy weights (`from_jax_params`), in f32 on the CPU: `Model.loss`
and every gradient against ``jax.value_and_grad`` of the JAX
``Model.loss``; one train step (and one of 4 microbatches) against the
JAX ``make_train_step``; the plain backwards of K2, K4a and K4b against
``jax.grad`` of the JAX model's attention and norm; the launch counts a
training step makes through the kernels' wrappers; the data pipeline
bitwise; the refusals of what is not ported. The ssm (Mamba2) and
hybrid (Zamba2, also with a tail of layers after the last group) smoke
configs the same way, at a length of several SSM chunks with a ragged
tail (K5's plain backward: tests/test_torch_ssd_backward.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jax_get_arch
from repro.models import build_model as jax_build_model
from repro.models import layers as JL
from repro.optim import AdamWConfig as JAdamWConfig
from repro.train import TrainConfig as JTrainConfig
from repro.train import make_train_step as jax_make_train_step
from repro.train.data import synthetic_lm_batch as jax_batch
from repro.train.train_step import init_optimizer as jax_init_optimizer
from repro_torch.configs import get_arch
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import rmsnorm as RN
from repro_torch.kernels import ssd_chunk as K5
from repro_torch.launch.train import train
from repro_torch.models import build_model
from repro_torch.models.convert import from_jax_params
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, init_optimizer, make_train_step
from repro_torch.train.data import synthetic_lm_batch

TINY = dict(n_layers=2, d_model=64, d_ff=128, vocab_size=256)
# (arch, overrides of its smoke config): tests/test_train.py's tiny
# config, the qwen3-4b smoke config (qk-norm), qwen1.5-4b's (qkv bias)
CONFIGS = {"tiny": ("qwen3-4b", TINY), "smoke": ("qwen3-4b", {}),
           "qwen1.5 smoke": ("qwen1.5-4b", {}),
           "mamba2 smoke": ("mamba2-780m", {}),
           "zamba2 smoke": ("zamba2-2.7b", {}),
           # five layers at attn_every 2: two groups, then a tail layer
           "zamba2 tail": ("zamba2-2.7b", dict(n_layers=5))}
SSM_CONFIGS = ("mamba2 smoke", "zamba2 smoke", "zamba2 tail")
# the sequence length of the loss tests: three SSM chunks of the smoke's
# 32 with a ragged tail (80) for the ssm and hybrid configs
SEQ = {w: 80 if w in SSM_CONFIGS else 32 for w in CONFIGS}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small ops: one intra-op thread keeps parallel test workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(which, seed=0):
    """Both models on one numpy parameter set (the JAX init, norm
    weights redrawn around 1 and qkv biases around 0 so that their
    products and sums are tested; the Mamba2 leaves as
    ``chip_smoke.parity_weights`` draws them, A_log = log U(0.01, 0.1),
    dt_bias -3 + 0.1 z, D = z, conv_b 0.1 z, gate_norm 1 + 0.1 z: with
    the JAX init, A = -e, the state dies within a chunk)."""
    arch, overrides = CONFIGS[which]
    jcfg = jax_get_arch(arch).smoke().replace(**overrides)
    cfg = get_arch(arch).smoke().replace(**overrides)
    jm = jax_build_model(jcfg)
    params, _ = jm.init(jax.random.key(seed))
    tree = jax.tree.map(lambda a: np.array(a, np.float32), params)
    r = np.random.default_rng(seed + 1)
    attn = tree["blocks"].get("attn", {})
    shared = tree.get("shared_attn", {})
    for parent, name, base in ((tree["blocks"], "norm1", 1.0),
                               (shared, "norm1", 1.0),
                               (shared, "norm2", 1.0),
                               (tree["blocks"], "norm2", 1.0),
                               (tree, "final_norm", 1.0),
                               (attn, "q_norm", 1.0), (attn, "k_norm", 1.0),
                               (attn, "bq", 0.0), (attn, "bk", 0.0),
                               (attn, "bv", 0.0)):
        if name not in parent:
            continue
        a = parent[name]
        a[...] = base + 0.1 * r.normal(size=a.shape)
    mamba = tree["blocks"].get("mamba", {})
    for name, draw in (("A_log", lambda s: np.log(r.uniform(0.01, 0.1, s))),
                       ("dt_bias", lambda s: -3.0 + 0.1 * r.normal(size=s)),
                       ("D", lambda s: r.normal(size=s)),
                       ("conv_b", lambda s: 0.1 * r.normal(size=s)),
                       ("gate_norm", lambda s: 1.0 + 0.1 * r.normal(size=s))):
        if name in mamba:
            mamba[name][...] = draw(mamba[name].shape)
    model = build_model(cfg, "cpu", trainable=True)
    model.load_state_dict(from_jax_params(cfg, tree))
    return jcfg, jm, jax.tree.map(jnp.asarray, tree), cfg, model, tree


def _named_grads(jgrads):
    return {".".join(k.key for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]}


def _jax_f32_error(jcfg, tree, batch, want):
    """Per gradient, the JAX package's own f32 rounding error: the largest
    |g_f32 - g_f64| over its elements, g_f64 the same JAX loss and
    gradient with the parameters and activations in f64 (x64 on for this
    call only). The ssm and hybrid models' embedding gradient reaches
    ~1 (the first norm divides by the embeddings' rms, ~0.02), and both
    packages' f32 values of it lie ~2-4e-6 from the f64 one, above the
    dense limit's atol of 1e-6, so those configs add this to it. It is a
    leaf's largest value, applied to every element of that leaf: it
    reaches 2.14e-6 (mamba2 smoke), 2.25e-6 (zamba2 smoke) and 2.49e-6
    (zamba2 tail) on the embedding and at most 6.2e-7 on any other leaf;
    the port's worst element lies at most 8.3e-7 past the dense bar (the
    embedding's, zamba2 tail). An elementwise allowance (|g_f32 - g_f64|
    of each element times a small factor) does not hold: the port's and
    the JAX package's roundings are independent, and where JAX's error
    at an element is small the port's is not (9x it on mamba2's
    embedding)."""
    with jax.enable_x64():
        jm64 = jax_build_model(jcfg.replace(param_dtype="float64",
                                            compute_dtype="float64"))
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)
        g64 = _named_grads(jax.jit(jax.grad(
            lambda p: jm64.loss(p, {k: jnp.asarray(v)
                                    for k, v in batch.items()})[0]))(p64))
    return {n: float(np.abs(want[n] - g64[n]).max()) for n in want}


@pytest.mark.parametrize("which", sorted(CONFIGS))
def test_loss_and_gradients_match_jax(which):
    jcfg, jm, jparams, cfg, model, tree = _setup(which)
    batch = jax_batch(jcfg, 2, SEQ[which], 0)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True))(jparams)
    loss, met = model.loss({k: torch.tensor(v).long()
                            for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(met["ce"].item(), float(jmet["ce"]),
                               rtol=1e-5)
    assert float(met["aux"]) == float(jmet["aux"]) == 0.0
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    want = _named_grads(jg)
    assert sorted(got) == sorted(want)
    # dense: rtol 1e-4, atol 1e-6; ssm and hybrid: atol 1e-6 plus the JAX
    # package's own f32 error of that gradient (`_jax_f32_error`)
    noise = (_jax_f32_error(jcfg, tree, batch, want)
             if which in SSM_CONFIGS else {})
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                   atol=1e-6 + noise.get(name, 0.0),
                                   err_msg=name)


@pytest.mark.parametrize("mb", [1, 4])
def test_one_train_step_matches_jax(mb):
    """The parameters after one step (AdamW with its defaults: clip 1.0,
    weight decay 0.1) at tests/test_train.py's bar, rtol 1e-4 and atol
    1e-5, wherever the JAX step's clipped gradient is 0 or at least 100
    eps (1e-6). Between the two the first step's update lr g / (|g| + eps) is
    ill-conditioned: a gradient of ~1e-8 that the two packages compute a
    few 1e-9 apart (far inside the gradient test's atol of 1e-6) moves
    the update by up to lr; there both updates are held to at most lr
    (plus the weight decay's lr 0.1 |p|)."""
    _one_step_matches_jax("tiny", mb, seed=2, global_batch=8, seq_len=32)


@pytest.mark.parametrize("which", ["mamba2 smoke", "zamba2 smoke"])
def test_one_train_step_matches_jax_ssm_hybrid(which):
    """The ssm and hybrid smoke configs' first step at the dense step's
    bar (test_one_train_step_matches_jax), at 80 positions."""
    _one_step_matches_jax(which, 1, seed=2, global_batch=4, seq_len=80)


def _one_step_matches_jax(which, mb, seed, global_batch, seq_len):
    jcfg, jm, jparams, cfg, model, _ = _setup(which, seed=seed)
    batch = jax_batch(jcfg, global_batch, seq_len, 0)
    (_, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True))(jparams)
    jg = _named_grads(jg)
    jstep = jax.jit(jax_make_train_step(jm, JTrainConfig(
        microbatches=mb, optimizer=JAdamWConfig(lr=1e-3))))
    jp, _, jmet = jstep(jparams, jax_init_optimizer(JTrainConfig(
        optimizer=JAdamWConfig(lr=1e-3)), jparams),
        {k: jnp.asarray(v) for k, v in batch.items()})
    tcfg = TrainConfig(microbatches=mb, optimizer=AdamWConfig(lr=1e-3))
    params = dict(model.named_parameters())
    params, state, met = make_train_step(model, tcfg)(
        params, init_optimizer(tcfg, params), batch)
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-4)
    assert int(state["step"]) == 1
    want = {".".join(k.key for k in path): np.asarray(a)
            for path, a in jax.tree_util.tree_flatten_with_path(jp)[0]}
    before = {".".join(k.key for k in path): np.asarray(a)
              for path, a in jax.tree_util.tree_flatten_with_path(
                  jparams)[0]}
    clip = min(1.0, 1.0 / float(jmet["grad_norm"]))
    for name, p in params.items():
        got = p.detach().numpy()
        g = np.abs(jg[name] * clip)
        small = (g > 0) & (g < 1e-6)
        np.testing.assert_allclose(got[~small], want[name][~small],
                                   rtol=1e-4, atol=1e-5, err_msg=name)
        step = 1e-3 * (1.0 + 0.1 * np.abs(before[name][small])) + 1e-7
        assert (np.abs(got[small] - before[name][small]) <= step).all()
        assert (np.abs(want[name][small] - before[name][small])
                <= step).all()


@pytest.mark.parametrize("S,H,KVH,D", [(40, 4, 2, 32), (64, 4, 4, 64),
                                       (33, 8, 2, 128)])
def test_attention_plain_backward_matches_jax_grad(S, H, KVH, D):
    """K2's plain backward against ``jax.grad`` of the JAX model's
    ``chunked_attention`` (causal GQA; a chunk that does not divide S)."""
    r = np.random.default_rng(S + D)
    q, do = (r.normal(size=(2, S, H, D)).astype(np.float32)
             for _ in range(2))
    k, v = (r.normal(size=(2, S, KVH, D)).astype(np.float32)
            for _ in range(2))

    def f(q, k, v):
        return jnp.sum(JL.chunked_attention(q, k, v, chunk=16) * do)
    want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(q, k, v)
    before = FA.flash_attention_backward.plain_calls
    got = FA.flash_attention_backward(*(torch.tensor(x) for x in (q, k, v)),
                                      None, torch.tensor(do), None)
    assert FA.flash_attention_backward.plain_calls == before + 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


def test_attention_backward_refuses_other_head_dims():
    x = torch.zeros(1, 4, 2, 96)
    with pytest.raises(ValueError, match="head dim 96"):
        FA.flash_attention_backward(x, x, x, None, x, None)
    with pytest.raises(ValueError, match="head dim 16"):
        FA.flash_attention(*(torch.zeros(1, 4, 2, 16, requires_grad=True)
                             for _ in range(3)))


@pytest.mark.parametrize("shape", [(6, 128), (2, 5, 4, 32), (3, 1001)])
def test_rmsnorm_plain_backwards_match_jax_grad(shape):
    """K4a's and K4b's plain backwards against ``jax.grad`` of the JAX
    model's ``rms_norm`` (of x + r for K4b, whose new residual has its
    own gradient)."""
    r = np.random.default_rng(len(shape))
    x, res, g, gres = (r.normal(size=shape).astype(np.float32)
                       for _ in range(4))
    w = (1.0 + 0.1 * r.normal(size=shape[-1:])).astype(np.float32)
    eps = 1e-6

    def norm(x, w):
        return jnp.sum(JL.rms_norm(x, w, eps) * g)

    def norm_res(x, rr, w):
        s = x + rr
        return jnp.sum(JL.rms_norm(s, w, eps) * g) + jnp.sum(s * gres)
    t = [torch.tensor(a) for a in (x, res, w, g, gres)]
    dx, dw = RN.rmsnorm_backward(t[0], t[2], t[3], eps=eps)
    want = jax.grad(norm, argnums=(0, 1))(x, w)
    np.testing.assert_allclose(dx.numpy(), want[0], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), want[1], rtol=1e-4, atol=1e-5)
    dx, dw = RN.rmsnorm_residual_backward(*t, eps=eps)
    want = jax.grad(norm_res, argnums=(0, 1, 2))(x, res, w)
    np.testing.assert_allclose(dx.numpy(), want[0], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dx.numpy(), want[1], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), want[2], rtol=1e-4, atol=1e-5)


def _counts():
    return (FA.flash_attention.plain_calls,
            FA.flash_attention_backward.plain_calls,
            RN.rmsnorm.plain_calls, RN.rmsnorm_backward.plain_calls,
            RN.rmsnorm_residual.plain_calls,
            RN.rmsnorm_residual_backward.plain_calls,
            K5.ssd_chunk.plain_calls, K5.ssd_chunk_backward.plain_calls)


def test_training_step_goes_through_every_wrapper():
    """One loss and backward of L layers under per-layer checkpointing:
    K2 2L forward calls (the forward and the recomputation) and L
    backward; K4a 2(1 + 2L) forward (the first norm1, the q- and
    k-norms) and 1 + 2L backward; K4b 2(2L - 1) + 1 forward (each
    norm2, each later norm1, the final norm outside the checkpoints)
    and 2L backward. chip_smoke.py's train phase holds the card's
    launches to the same counts."""
    _, _, _, cfg, model, _ = _setup("smoke")
    batch = synthetic_lm_batch(cfg, 2, 16, 0)
    before = _counts()
    loss, _ = model.loss({k: torch.tensor(v).long()
                          for k, v in batch.items()})
    loss.backward()
    L = cfg.n_layers
    got = tuple(b - a for a, b in zip(before, _counts()))
    assert got == (2 * L, L, 2 * (1 + 2 * L), 1 + 2 * L,
                   2 * (2 * L - 1) + 1, 2 * L, 0, 0)


@pytest.mark.parametrize("which", SSM_CONFIGS)
def test_ssm_hybrid_step_goes_through_every_wrapper(which):
    """One loss and backward of L Mamba2 layers under per-layer
    checkpointing, A = L // attn_every shared-block applications (not
    checkpointed; 0 for the ssm family): K5 2L forward calls (the
    forward and the recomputation) and L backward; K2 A and A; K4a 2(1 +
    L) + A forward (the first norm1, each gate norm, the shared norm1)
    and 1 + L + A backward; K4b 2(L - 1) + A + 1 forward (each later
    norm1, the shared norm2, the final norm) and L + A backward.
    chip_smoke.py's train phase holds the card's launches to the same
    counts (its train_counts_want)."""
    _, _, _, cfg, model, _ = _setup(which)
    batch = synthetic_lm_batch(cfg, 2, 40, 0)
    before = _counts()
    loss, _ = model.loss({k: torch.tensor(v).long()
                          for k, v in batch.items()})
    loss.backward()
    L = cfg.n_layers
    A = L // cfg.attn_every if cfg.family == "hybrid" else 0
    got = tuple(b - a for a, b in zip(before, _counts()))
    assert got == (A, A, 2 * (1 + L) + A, 1 + L + A, 2 * (L - 1) + A + 1,
                   L + A, 2 * L, L)


def test_serving_forward_keeps_its_path():
    """Without a gradient the wrappers take their serving path: no
    autograd Function, no backward."""
    _, _, _, cfg, model, _ = _setup("tiny")
    before = _counts()
    with torch.no_grad():
        loss, _ = model.loss({"tokens": torch.zeros(1, 8, dtype=torch.long),
                              "labels": torch.zeros(1, 8,
                                                    dtype=torch.long)})
    assert loss.grad_fn is None
    got = tuple(b - a for a, b in zip(before, _counts()))
    assert got[1] == got[3] == got[5] == 0 and got[0] == cfg.n_layers


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-2.7b"])
def test_ssm_hybrid_loss_decreases(arch):
    """The port's trainer on the ssm and hybrid smoke configs on the CPU
    (launch.train --device cpu), at tests/test_train.py's bar."""
    _, losses = train(arch, steps=30, global_batch=8, seq_len=64, lr=1e-3,
                      device="cpu", log_every=100)
    assert losses[-1] < losses[0] - 0.5, losses[::10]


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (11, 3)])
def test_synthetic_batches_bitwise(seed, step):
    cfg = get_arch("qwen3-4b").smoke()
    jcfg = jax_get_arch("qwen3-4b").smoke()
    got = synthetic_lm_batch(cfg, 4, 48, step, seed)
    want = jax_batch(jcfg, 4, 48, step, seed)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_loss_decreases():
    """tests/test_train.py's bar for the port's trainer on the CPU."""
    _, losses = train("qwen3-4b", steps=30, global_batch=8, seq_len=64,
                      lr=1e-3, device="cpu", overrides=TINY, log_every=100)
    assert losses[-1] < losses[0] - 0.5, losses[::10]


def test_hybrid_tail_trains_but_does_not_serve():
    """A hybrid model whose layers are not whole groups builds and trains
    (the JAX package's trunk runs the tail without a shared block);
    serving refuses it, as the JAX package's hybrid prefill asserts."""
    cfg = get_arch("zamba2-2.7b").smoke().replace(n_layers=5)
    model = build_model(cfg, "cpu", trainable=True)
    model.init_weights(torch.Generator().manual_seed(0))
    toks = torch.zeros(1, 8, dtype=torch.long)
    loss, _ = model.loss({"tokens": toks, "labels": toks})
    assert torch.isfinite(loss)
    cache = model.cache_spec(1, 16).zeros("cpu")
    with pytest.raises(ValueError, match="multiple of attn_every"):
        model.prefill({"tokens": toks}, cache)
    with pytest.raises(ValueError, match="multiple of attn_every"):
        model.decode_step(toks[:, :1], cache)


def test_model_parallel_refused():
    with pytest.raises(NotImplementedError, match=r"item 6 \(sharding\)"):
        train("qwen3-4b", steps=1, model_parallel=2, device="cpu")


def test_trainer_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train("qwen3-4b", steps=1)
