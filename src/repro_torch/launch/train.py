"""Training entry point of the port (counterpart of `repro.launch.train`):
checkpoint/restart fault tolerance and the synthetic data pipeline, on
one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \
        --full --steps 10 --global-batch 4 --seq-len 1024   # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-780m \
        --full --steps 10 --global-batch 4 --seq-len 1024   # ssm, the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b \
        --device cpu --steps 30 --seq-len 64                # hybrid smoke
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --steps 20 --ckpt-every 5 --out runs/demo

Runs on the card (`repro_torch.utils.device.resolve_device`) unless
``--device cpu`` / ``device="cpu"`` is given. Fault tolerance: resumes
from the latest valid checkpoint in ``out`` (atomic, crc-checked saves,
the JAX package's format); ``--fail-at N`` raises at step N to exercise
the path. The initial parameters come from a ``torch.Generator`` seeded
with ``seed`` on the device, or from a JAX parameter tree through
`repro_torch.models.convert.from_jax_params` (``params=``). The dense
(Qwen), ssm (Mamba2) and hybrid (Zamba2) families train (`Model.loss`);
``--model-parallel > 1`` waits for the sharding bullet (ROADMAP Queue 1,
item 6 (sharding)).
"""
from __future__ import annotations

import argparse
import contextlib
import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint import Checkpointer, latest_step
from repro_torch.checkpoint.checkpointer import nest
from repro_torch.configs import get_arch
from repro_torch.models import build_model
from repro_torch.models.convert import from_jax_params
from repro_torch.optim import AdamWConfig
from repro_torch.train import (TrainConfig, init_optimizer, make_train_step,
                               synthetic_lm_batches)
from repro_torch.utils import get_logger
from repro_torch.utils.device import resolve_device

log = get_logger("train")


def train_state(params, opt_state):
    """The checkpointed tree: the parameters and the moments nested by
    their names (the JAX tree's paths), and the step; its leaves are the
    live tensors themselves."""
    return {"params": nest(params),
            "opt": {"mu": nest(opt_state["mu"]), "nu": nest(opt_state["nu"]),
                    "step": opt_state["step"]}}


def _copy_into(dst, src) -> None:
    """Copy each leaf of ``src`` into the tensor at its place in ``dst``."""
    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    else:
        dst.copy_(src)


def train(arch: str, *, smoke: bool = True, steps: int = 100,
          global_batch: int = 8, seq_len: int = 128, lr: float = 3e-4,
          microbatches: int = 1, ckpt_every: int = 0, out: str = "",
          model_parallel: int = 1, fail_at: int = -1, seed: int = 0,
          log_every: int = 10, device=None, params=None,
          overrides: Optional[dict] = None,
          optimizer: Optional[AdamWConfig] = None,
          on_step: Optional[Callable] = None):
    """Train ``arch`` (its ``smoke()`` config, or at full width with
    ``smoke=False``; ``overrides`` replace config fields, e.g.
    ``n_layers``) for ``steps`` steps of ``global_batch`` sequences of
    ``seq_len`` tokens. ``params``: a JAX parameter tree to start from
    instead of the seeded init. ``on_step(step, metrics)`` is called
    after each step with its metrics as floats and ``seconds``, the
    step's host time (ending in a sync). Returns (the parameters by
    name, the losses of the steps this call ran)."""
    if model_parallel > 1:
        raise NotImplementedError(
            f"--model-parallel {model_parallel}: tensor-parallel training "
            "is not ported (ROADMAP Queue 1, item 6 (sharding))")
    dev = resolve_device(device)
    cfg = get_arch(arch)
    if smoke:
        cfg = cfg.smoke()
    if overrides:
        cfg = cfg.replace(**overrides)
    model = build_model(cfg, dev, trainable=True)
    if params is not None:
        model.load_state_dict(from_jax_params(cfg, params))
    else:
        model.init_weights(torch.Generator(device=dev).manual_seed(seed))

    tcfg = TrainConfig(microbatches=microbatches,
                       optimizer=optimizer or AdamWConfig(lr=lr))
    step_fn = make_train_step(model, tcfg)
    named = dict(model.named_parameters())
    opt_state = init_optimizer(tcfg, named)
    start = 0

    ckpt = Checkpointer(out) if out else None
    if ckpt and latest_step(out) is not None:
        live = train_state(named, opt_state)
        restored, s = ckpt.restore(live)
        with torch.no_grad():
            _copy_into(live, restored)
        start = s + 1
        log.info("resumed from step %d", s)

    losses = []
    t0 = time.perf_counter()
    data = synthetic_lm_batches(cfg, global_batch, seq_len, steps, seed=seed)
    try:
        for step, batch in enumerate(data):
            if step < start:
                continue
            if step == fail_at:
                raise RuntimeError(f"injected failure at step {step}")
            ts = time.perf_counter()
            named, opt_state, metrics = step_fn(named, opt_state, batch)
            loss = float(metrics["loss"])
            seconds = time.perf_counter() - ts
            losses.append(loss)
            if on_step is not None:
                on_step(step, dict({k: float(v) for k, v in metrics.items()},
                                   seconds=seconds))
            if step % log_every == 0:
                log.info("step %4d loss %.4f gnorm %.3f (%.2f s/step)",
                         step, loss, float(metrics["grad_norm"]),
                         (time.perf_counter() - t0) / max(len(losses), 1))
            if ckpt and ckpt_every and step and step % ckpt_every == 0:
                ckpt.save(step, train_state(named, opt_state),
                          blocking=False)
    except BaseException:
        # a failing run still lands the save it has in flight, so that a
        # restart in the same process finds it; the run's own error is the
        # one raised, whatever the writer's
        if ckpt:
            with contextlib.suppress(Exception):
                ckpt.wait()
        raise
    if ckpt:
        ckpt.save(steps - 1, train_state(named, opt_state), blocking=True)
    return named, losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--out", default="")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--fail-at", type=int, default=-1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    _, losses = train(args.arch, smoke=args.smoke, steps=args.steps,
                      global_batch=args.global_batch, seq_len=args.seq_len,
                      lr=args.lr, microbatches=args.microbatches,
                      ckpt_every=args.ckpt_every, out=args.out,
                      model_parallel=args.model_parallel,
                      fail_at=args.fail_at, seed=args.seed,
                      log_every=args.log_every, device=args.device)
    log.info("final loss %.4f (first %.4f)", losses[-1], losses[0])


if __name__ == "__main__":
    main()
