"""The port's AdamW, LR schedule and gradient compression against the JAX
package's on equal inputs (numpy, f32, on the CPU): the update with f32
moments, with the int8 log-space second moment (its codes bitwise: both
round half to even) and with bf16 moments; the chunked in-place update
equal to the whole-leaf one; the int8 round trip and `compress_grads_int8`
bitwise; the cosine schedule; `psum_int8`'s refusal."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as JC
from repro.optim import adamw as JA
from repro.optim import cosine_schedule as jax_cosine
from repro_torch.distributed import compression as C
from repro_torch.optim import adamw as A
from repro_torch.optim import cosine_schedule

SHAPES = {"blocks.attn.wq": (3, 16, 4, 8), "blocks.norm1": (3, 16),
          "embed": (40, 16), "final_norm": (16,), "odd": (5, 130)}


def _tree(flat):
    """{"a.b": x} -> the JAX package's nested dict."""
    out = {}
    for name, v in flat.items():
        node = out
        *head, last = name.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _leaf(tree, name):
    for k in name.split("."):
        tree = tree[k]
    return tree


def _draw(seed, scale=1.0):
    r = np.random.default_rng(seed)
    return {k: (scale * r.normal(size=s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _tiny(g, seed):
    """``g`` with every third element replaced by a value of magnitude
    between 1e-9 and 1e-6 (random sign, log-uniform): where the first
    step's g / (|g| + eps) is least well conditioned."""
    r = np.random.default_rng(seed)
    out = {}
    for k, v in g.items():
        v = v.copy()
        flat = v.reshape(-1)
        n = flat[::3].size
        flat[::3] = (r.choice((-1.0, 1.0), n)
                     * 10.0 ** r.uniform(-9, -6, n)).astype(np.float32)
        out[k] = v
    return out


CASES = {
    "f32": dict(lr=1e-2, weight_decay=0.1),
    # gradients with elements between 1e-9 and 1e-6 (`_tiny`), at the
    # default clip (so 3e-11 to 3e-8 after it) and with no clip
    "tiny_grads": dict(lr=1e-2, weight_decay=0.1),
    "tiny_grads_no_clip": dict(lr=1e-3, grad_clip=0.0),
    "quantize_nu": dict(lr=1e-2, quantize_nu=True, nu_block=32),
    "bf16_moments": dict(lr=1e-2, moment_dtype="bfloat16"),
    "no_clip": dict(lr=3e-3, grad_clip=0.0, weight_decay=0.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_adamw_update_matches_jax(case):
    """Three steps from zero moments on equal parameters and gradients
    (clipped at the default 1.0 except ``no_clip``): the parameters
    within rtol 1e-5 (order of the f32 norm's sum), the moments too, the
    int8 codes of nu bitwise and its block maxima within rtol 1e-5. The
    ``tiny_grads`` cases hold every element to that bar, those whose
    gradient is 1e-9 to 1e-6 (before the clip) included: the bar that
    tests/test_torch_train.py's one-step test relaxes for small
    gradients."""
    kw = CASES[case]
    jcfg, cfg = JA.AdamWConfig(**kw), A.AdamWConfig(**kw)
    p0 = _draw(0)
    jp = _tree({k: jnp.asarray(v) for k, v in p0.items()})
    jst = JA.adamw_init(jcfg, jp)
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    tst = A.adamw_init(cfg, tp)
    jupdate = jax.jit(partial(JA.adamw_update, jcfg))
    for step in range(3):
        g = _draw(10 + step, scale=0.3 if case != "no_clip" else 1.0)
        if case.startswith("tiny_grads"):
            g = _tiny(g, 20 + step)
        jp, jst, jm = jupdate(jp, _tree(
            {k: jnp.asarray(v) for k, v in g.items()}), jst)
        tp, tst, tm = A.adamw_update(cfg, tp, {k: torch.tensor(v) for k, v
                                               in g.items()}, tst)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    assert int(tst["step"]) == int(jst["step"]) == 3
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(_leaf(jp, k)),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(
            tst["mu"][k].float().numpy(),
            np.asarray(_leaf(jst["mu"], k), np.float32), rtol=1e-5,
            atol=1e-8, err_msg=k)
        jnu = _leaf(jst["nu"], k)
        if cfg.quantize_nu:
            np.testing.assert_array_equal(tst["nu"][k]["q"].numpy(),
                                          np.asarray(jnu["q"]))
            np.testing.assert_allclose(tst["nu"][k]["scale"].numpy(),
                                       np.asarray(jnu["scale"]), rtol=1e-5)
        else:
            assert tst["nu"][k].dtype == A.moment_dtype(cfg)
            np.testing.assert_allclose(
                tst["nu"][k].float().numpy(), np.asarray(jnu, np.float32),
                rtol=1e-5, atol=1e-10, err_msg=k)


def test_adamw_reference_update():
    """tests/test_train.py's hand-worked first step: delta = g / |g|."""
    cfg = A.AdamWConfig(lr=0.1, b1=0.9, b2=0.999, weight_decay=0.0,
                        grad_clip=0.0)
    p = {"w": torch.ones(4, 4)}
    p2, _, _ = A.adamw_update(cfg, p, {"w": torch.full((4, 4), 0.5)},
                              A.adamw_init(cfg, p))
    np.testing.assert_allclose(p2["w"].numpy(), np.full((4, 4), 0.9),
                               rtol=1e-5)


def test_chunked_update_is_the_whole_update(monkeypatch):
    """The in-place update a chunk of the leading axis at a time is
    bitwise the update of whole leaves."""
    cfg = A.AdamWConfig(lr=1e-2, quantize_nu=True, nu_block=32)
    out = []
    for chunk in (1 << 25, 17):
        monkeypatch.setattr(A, "CHUNK_ELEMENTS", chunk)
        p = {k: torch.tensor(v) for k, v in _draw(0).items()}
        st = A.adamw_init(cfg, p)
        for step in range(2):
            g = {k: torch.tensor(v) for k, v in _draw(20 + step).items()}
            p, st, _ = A.adamw_update(cfg, p, g, st)
        out.append((p, st))
    (pa, sa), (pb, sb) = out
    for k in SHAPES:
        assert torch.equal(pa[k], pb[k])
        assert torch.equal(sa["mu"][k], sb["mu"][k])
        assert torch.equal(sa["nu"][k]["q"], sb["nu"][k]["q"])
        assert torch.equal(sa["nu"][k]["scale"], sb["nu"][k]["scale"])


@pytest.mark.parametrize("shape,block", [((64, 256), 128), ((3, 130), 32),
                                         ((7,), 128)])
def test_q8_codes_bitwise_jax(shape, block):
    x = np.abs(np.random.default_rng(4).normal(size=shape)).astype(
        np.float32) ** 3
    jq, js = JA._q8_encode(jnp.asarray(x), block)
    q, s = A._q8_encode(torch.tensor(x), block)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_allclose(A._q8_decode(q, s, block).numpy(),
                               np.asarray(JA._q8_decode(jq, js, block)),
                               rtol=1e-6)


def test_global_norm_matches_jax():
    g = _draw(3)
    want = JA.global_norm(_tree({k: jnp.asarray(v) for k, v in g.items()}))
    got = A.global_norm({k: torch.tensor(v) for k, v in g.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("n,block", [(10_240, 256), (1000, 256), (77, 16)])
def test_quantize_roundtrip_bitwise_jax(n, block):
    x = np.random.default_rng(n).normal(size=(n,)).astype(np.float32)
    want = np.asarray(JC.quantize_roundtrip(jnp.asarray(x), block))
    got = C.quantize_roundtrip(torch.tensor(x), block).numpy()
    np.testing.assert_array_equal(got, want)
    blocks = np.pad(x, (0, (-n) % block)).reshape(-1, block)
    bound = np.abs(blocks).max(1, keepdims=True) / 127.0
    err = np.abs(np.pad(got, (0, (-n) % block)).reshape(-1, block) - blocks)
    assert (err <= bound + 1e-7).all()


def test_compress_grads_int8_bitwise_jax():
    g = _draw(6)
    want = JC.compress_grads_int8(_tree({k: jnp.asarray(v)
                                         for k, v in g.items()}))
    got = C.compress_grads_int8({k: torch.tensor(v) for k, v in g.items()})
    for k in SHAPES:
        np.testing.assert_array_equal(got[k].numpy(),
                                      np.asarray(_leaf(want, k)))
    # leaves below one block pass unchanged
    assert torch.equal(got["final_norm"], torch.tensor(g["final_norm"]))


def test_psum_int8_refused():
    with pytest.raises(NotImplementedError, match=r"item 6 \(sharding\)"):
        C.psum_int8(torch.zeros(8), "data")


@pytest.mark.parametrize("step", [0, 3, 10, 55, 100, 130])
def test_cosine_schedule_matches_jax(step):
    kw = dict(peak_lr=3e-4, warmup=10, total=100, floor=0.1)
    want = jax_cosine(jnp.asarray(step, jnp.int32), **kw)
    got = cosine_schedule(torch.tensor(step, dtype=torch.int32), **kw)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
