"""The port's dense training slice against the JAX package's, on the
same numpy weights (`from_jax_params`), in f32 on the CPU: `Model.loss`
and every gradient against ``jax.value_and_grad`` of the JAX
``Model.loss``; one train step (and one of 4 microbatches) against the
JAX ``make_train_step``; the plain backwards of K2, K4a and K4b against
``jax.grad`` of the JAX model's attention and norm; the launch counts a
training step makes through the kernels' wrappers; the data pipeline
bitwise; the refusals of what is not ported."""
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
           "qwen1.5 smoke": ("qwen1.5-4b", {})}


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
    products and sums are tested)."""
    arch, overrides = CONFIGS[which]
    jcfg = jax_get_arch(arch).smoke().replace(**overrides)
    cfg = get_arch(arch).smoke().replace(**overrides)
    jm = jax_build_model(jcfg)
    params, _ = jm.init(jax.random.key(seed))
    tree = jax.tree.map(lambda a: np.array(a, np.float32), params)
    r = np.random.default_rng(seed + 1)
    attn = tree["blocks"]["attn"]
    for parent, name, base in ((tree["blocks"], "norm1", 1.0),
                               (tree["blocks"], "norm2", 1.0),
                               (tree, "final_norm", 1.0),
                               (attn, "q_norm", 1.0), (attn, "k_norm", 1.0),
                               (attn, "bq", 0.0), (attn, "bk", 0.0),
                               (attn, "bv", 0.0)):
        if name not in parent:
            continue
        a = parent[name]
        a[...] = base + 0.1 * r.normal(size=a.shape)
    model = build_model(cfg, "cpu", trainable=True)
    model.load_state_dict(from_jax_params(cfg, tree))
    return jcfg, jm, jax.tree.map(jnp.asarray, tree), cfg, model, tree


def _named_grads(jgrads):
    return {".".join(k.key for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]}


@pytest.mark.parametrize("which", sorted(CONFIGS))
def test_loss_and_gradients_match_jax(which):
    jcfg, jm, jparams, cfg, model, _ = _setup(which)
    batch = jax_batch(jcfg, 2, 32, 0)
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
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                   atol=1e-6, err_msg=name)


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
    jcfg, jm, jparams, cfg, model, _ = _setup("tiny", seed=2)
    batch = jax_batch(jcfg, 8, 32, 0)
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
    x = torch.zeros(1, 4, 2, 80)
    with pytest.raises(ValueError, match="head dim 80"):
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
            RN.rmsnorm_residual_backward.plain_calls)


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
                   2 * (2 * L - 1) + 1, 2 * L)


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


@pytest.mark.parametrize("arch,family", [("mamba2-780m", "ssm"),
                                         ("zamba2-2.7b", "hybrid")])
def test_loss_refuses_ssm_and_hybrid(arch, family):
    model = build_model(get_arch(arch).smoke(), "cpu", trainable=True)
    with pytest.raises(NotImplementedError,
                       match=r"ssm/hybrid training: K5's backward"):
        model.loss({"tokens": torch.zeros(1, 4, dtype=torch.long),
                    "labels": torch.zeros(1, 4, dtype=torch.long)})


def test_model_parallel_refused():
    with pytest.raises(NotImplementedError, match=r"item 6 \(sharding\)"):
        train("qwen3-4b", steps=1, model_parallel=2, device="cpu")


def test_trainer_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train("qwen3-4b", steps=1)
