"""Make the JAX package's constants that ``chip_smoke.py``'s train phase
holds the port's f32 training against (``scripts/train_expected.json``).

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python scripts/train_expected.py \
        [--out scripts/train_expected.json]

The runs (RUNS below), one an arch: the ``qwen3-4b``, ``mamba2-780m``
and ``zamba2-2.7b`` smoke configs in f32 (qwen3-4b: 4 layers, d 128,
head dim 32, vocab 512; the ssm and hybrid ones: 16 SSM heads of 16,
state 16, chunk 32, Zamba2's shared block every 2 of its 4 layers) on the
weights ``chip_smoke.parity_weights`` draws with numpy (every leaf of the
JAX parameter tree by its dotted name), `repro.train.make_train_step`
with AdamW at ``lr`` (its other defaults: clip 1.0, weight decay 0.1),
``steps`` batches of `repro.train.data.synthetic_lm_batch`
(``global_batch`` x ``seq_len``, ``seed``); the ssm and hybrid runs at
80 positions, three chunks with a ragged tail. It writes, by arch, the
run's settings and each step's ``loss`` and ``grad_norm`` (Python's
float repr of the f32 value). About 40 s on a CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

RUN = dict(steps=5, global_batch=8, seq_len=64, lr=1e-3, seed=0)
RUNS = {"qwen3-4b": RUN, "mamba2-780m": dict(RUN, seq_len=80),
        "zamba2-2.7b": dict(RUN, seq_len=80)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "train_expected.json"))
    args = ap.parse_args(argv)
    import jax
    import jax.numpy as jnp

    import chip_smoke as cs
    from repro.configs.registry import get_arch
    from repro.models import build_model
    from repro.optim import AdamWConfig
    from repro.train import TrainConfig, make_train_step
    from repro.train.data import synthetic_lm_batches
    from repro.train.train_step import init_optimizer

    result = {}
    for arch, run in RUNS.items():
        cfg = get_arch(arch).smoke()
        model = build_model(cfg)
        abstract = model.init_abstract()[0]
        shapes = {".".join(k.key for k in path): leaf.shape for path, leaf
                  in jax.tree_util.tree_flatten_with_path(abstract)[0]}
        w = cs.parity_weights(np, shapes)
        params = jax.tree_util.tree_map_with_path(
            lambda path, leaf: jnp.asarray(w[".".join(k.key for k in path)]),
            abstract)
        tcfg = TrainConfig(optimizer=AdamWConfig(lr=run["lr"]))
        step = jax.jit(make_train_step(model, tcfg))
        opt = init_optimizer(tcfg, params)
        out = dict(arch=arch, **run, loss=[], grad_norm=[])
        for batch in synthetic_lm_batches(cfg, run["global_batch"],
                                          run["seq_len"], run["steps"],
                                          seed=run["seed"]):
            params, opt, m = step(params, opt, {k: jnp.asarray(v)
                                                for k, v in batch.items()})
            out["loss"].append(float(m["loss"]))
            out["grad_norm"].append(float(m["grad_norm"]))
        result[arch] = out
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
        f.write("\n")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
