"""The port's checkpointer: the eight cases of tests/test_checkpoint.py
restated for it (round trip, restore into shapes only, keep-N GC, async
save, corruption and fallback, a partial write invisible, a shape
mismatch, crash-restart continuity of `repro_torch.launch.train` on the
CPU, bitwise), and the on-disk format shared with the JAX package: a
checkpoint written by the JAX trainer resumes in the port and continues
to the JAX run's losses, one the port writes restores in JAX; restoring
with shardings is refused."""
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JaxCheckpointer
from repro.launch.train import train as jax_train
from repro_torch.checkpoint import Checkpointer, latest_step
from repro_torch.launch.train import train


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tree(seed=0):
    r = np.random.default_rng(seed)
    return {"params": {"w": torch.tensor(r.normal(size=(8, 16)),
                                         dtype=torch.float32),
                       "b": torch.tensor(r.normal(size=(16,)),
                                         dtype=torch.bfloat16)},
            "step": torch.tensor(seed, dtype=torch.int32)}


def _leaves(t):
    return [t["params"]["b"], t["params"]["w"], t["step"]]


def test_save_restore_roundtrip(tmp_path):
    ck = Checkpointer(tmp_path)
    t = tree(3)
    ck.save(3, t)
    restored, step = ck.restore(t)
    assert step == 3
    for a, b in zip(_leaves(t), _leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_restore_into_shapes_only(tmp_path):
    """Targets on the ``meta`` device (shapes and dtypes, no data, as the
    JAX test's ShapeDtypeStructs) get CPU tensors."""
    ck = Checkpointer(tmp_path)
    t = tree(1)
    ck.save(1, t)
    target = {"params": {k: torch.empty_like(v, device="meta")
                         for k, v in t["params"].items()},
              "step": torch.empty((), dtype=torch.int32, device="meta")}
    restored, _ = ck.restore(target)
    assert torch.equal(restored["params"]["w"], t["params"]["w"])
    assert restored["params"]["b"].device.type == "cpu"


def test_keep_n_gc(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, tree(s))
    steps = sorted(int(p.name.split("_")[1])
                   for p in Path(tmp_path).iterdir()
                   if p.name.startswith("step_"))
    assert steps == [3, 4]
    assert latest_step(tmp_path) == 4


def test_async_save(tmp_path):
    ck = Checkpointer(tmp_path)
    t = tree(7)
    ck.save(7, t, blocking=False)
    t["params"]["w"].zero_()     # the snapshot was taken at the call
    ck.wait()
    assert latest_step(tmp_path) == 7
    restored, _ = ck.restore(tree(0))
    assert torch.equal(restored["params"]["w"], tree(7)["params"]["w"])


def test_corruption_detected_and_fallback(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(1, tree(1))
    ck.save(2, tree(2))
    leaf = next((Path(tmp_path) / "step_2").glob("leaf_*.npy"))
    leaf.write_bytes(b"garbage")
    with pytest.raises(IOError, match="crc mismatch"):
        ck.restore(tree(0), step=2)
    _, step = ck.restore(tree(0), strict=False)
    assert step == 1


def test_partial_write_is_invisible(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(5, tree(5))
    (Path(tmp_path) / "tmp.step_9").mkdir()
    assert latest_step(tmp_path) == 5
    _, step = ck.restore(tree(0))
    assert step == 5


def test_shape_mismatch_raises(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(1, tree(1))
    bad = {"params": {"w": torch.zeros(4, 4), "b": torch.zeros(16)},
           "step": torch.zeros((), dtype=torch.int32)}
    with pytest.raises(ValueError, match="checkpoint shape"):
        ck.restore(bad, step=1)


def test_crash_restart_training_continuity(tmp_path):
    """Train 12 steps with a crash at 9 after a checkpoint at 8; the
    resumed run's parameters are bitwise the uninterrupted run's (the
    CPU's arithmetic is repeatable, the checkpoint exact)."""
    kw = dict(smoke=True, steps=12, global_batch=4, seq_len=32,
              ckpt_every=4, seed=11, log_every=100, device="cpu")
    with pytest.raises(RuntimeError, match="injected failure at step 9"):
        train("qwen3-4b", out=str(tmp_path / "a"), fail_at=9, **kw)
    assert latest_step(tmp_path / "a") == 8
    resumed, losses = train("qwen3-4b", out=str(tmp_path / "a"), **kw)
    assert len(losses) == 3
    clean, _ = train("qwen3-4b", out=str(tmp_path / "b"), **kw)
    for name in clean:
        assert torch.equal(resumed[name], clean[name]), name


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """A JAX training run (smoke config, f32) crashes at step 4 after its
    checkpoint at 3; the port resumes from that checkpoint and its losses
    at steps 4 and 5 are the uninterrupted JAX run's within rtol 1e-4."""
    kw = dict(smoke=True, steps=6, global_batch=4, seq_len=32, seed=3,
              log_every=100)
    with pytest.raises(RuntimeError):
        jax_train("qwen3-4b", ckpt_every=3, out=str(tmp_path / "j"),
                  fail_at=4, **kw)
    # its save at step 3 runs on the JAX trainer's own writer thread
    for _ in range(600):
        if latest_step(tmp_path / "j") == 3:
            break
        time.sleep(0.05)
    assert latest_step(tmp_path / "j") == 3
    _, want = jax_train("qwen3-4b", **kw)
    _, got = train("qwen3-4b", out=str(tmp_path / "j"), device="cpu", **kw)
    np.testing.assert_allclose(got, want[4:], rtol=1e-4)


def test_port_checkpoint_restores_in_jax(tmp_path):
    """The other way: a tree the port saves (f32, bf16, int8, int32
    leaves) restores bitwise through the JAX package's Checkpointer."""
    t = tree(2)
    t["q"] = torch.tensor(np.arange(-5, 5), dtype=torch.int8)
    Checkpointer(tmp_path).save(2, t)
    target = {"params": {"w": jnp.zeros((8, 16), jnp.float32),
                         "b": jnp.zeros((16,), jnp.bfloat16)},
              "q": jnp.zeros((10,), jnp.int8),
              "step": jnp.zeros((), jnp.int32)}
    restored, step = JaxCheckpointer(tmp_path).restore(target)
    assert step == 2
    np.testing.assert_array_equal(np.asarray(restored["params"]["w"]),
                                  t["params"]["w"].numpy())
    np.testing.assert_array_equal(
        np.asarray(restored["params"]["b"], np.float32),
        t["params"]["b"].float().numpy())
    np.testing.assert_array_equal(np.asarray(restored["q"]), t["q"].numpy())
    assert int(restored["step"]) == 2


def test_restore_with_shardings_refused(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(1, tree(1))
    with pytest.raises(NotImplementedError, match=r"item 6 \(sharding\)"):
        ck.restore(tree(0), shardings={})
    with pytest.raises(NotImplementedError, match=r"item 6 \(sharding\)"):
        ck.restore(tree(0), mesh=object())
