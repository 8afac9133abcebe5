"""The JAX package's outputs for the model_parity rows of chip_smoke.py
that this script owns: the MoE family (DeepSeek-MoE-16B's smoke config)
and the hybrid family's prompt longer than its cache. Writes
``scripts/model_parity_expected.json``, which chip_smoke.py reads (the
machine with the card has no JAX).

Each row runs the JAX model on `chip_smoke.parity_weights` (drawn from
the JAX parameter tree's shapes) and `parity_tokens`: the prefill, then
``PARITY["steps"]`` greedy decode steps.

* ``f32`` rows keep the greedy tokens, the last step's logits[:16], their
  L2 norm and top-5, as chip_smoke.PARITY_CASES:
  - ``deepseek-moe-16b smoke f32``: the JAX package's auto impl (the
    dense oracle at 8 experts);
  - ``deepseek-moe-16b smoke f32 ep drop``: ``moe_impl="ep"`` at a
    capacity factor where the prefill drops choices; the script counts
    the dropped choices of every MoE layer of the prefill (a
    ``jax.debug.callback`` on ``moe_dispatch_indices``), asserts there is
    at least one and records the count, which the port must match;
  - ``zamba2-2.7b smoke f32 past the cache``: a prompt of 80 into a
    cache of 48 (S % W = 32, the sliding-window prefill and the ring).
* ``bf16`` rows keep each step's `chip_smoke.parity_step`, as
  PARITY_BF16_CASES: ``deepseek-moe-16b smoke bf16``.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python scripts/model_parity_expected.py

(~1 min on a CPU.)
"""
from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "model_parity_expected.json")
_BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
MOE = "deepseek-moe-16b"
# the rows: (arch, config overrides, prompt, max_len)
F32_ROWS = {
    f"{MOE} smoke f32": (MOE, {}, 16, 32),
    f"{MOE} smoke f32 ep drop": (MOE, dict(moe_impl="ep",
                                           capacity_factor=0.5), 16, 32),
    "zamba2-2.7b smoke f32 past the cache": ("zamba2-2.7b", {}, 80, 48),
}
BF16_ROWS = {f"{MOE} smoke bf16": (MOE, _BF16, 16, 32)}


def run(cs, arch, config, prompt_len, max_len):
    """The JAX model's greedy run: (per-step last logits as f64 numpy,
    tokens, choices dropped in the prefill's MoE dispatch)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.configs.registry import get_arch
    from repro.models import build_model
    from repro.models import layers as JL

    cfg = get_arch(arch).smoke().replace(**config)
    m = build_model(cfg)
    abstract = m.init_abstract()[0]
    flat = {".".join(k.key for k in path): leaf.shape for path, leaf
            in jax.tree_util.tree_flatten_with_path(abstract)[0]}
    w = cs.parity_weights(np, flat)
    params = jax.tree_util.tree_map_with_path(
        lambda path, leaf: jnp.asarray(w[".".join(k.key for k in path)],
                                       cfg.pdtype), abstract)
    toks = cs.parity_tokens(np, cfg.vocab_size, prompt_len)
    dropped = []
    orig = JL.moe_dispatch_indices

    def counting(top_e, top_p, n_experts, capacity):
        slot, w_ = orig(top_e, top_p, n_experts, capacity)
        jax.debug.callback(lambda n: dropped.append(int(n)),
                           (slot == capacity).sum())
        return slot, w_

    JL.moe_dispatch_indices = counting
    try:
        cache = m.cache_spec(1, max_len).zeros()
        logits, cache = m.prefill(params, {"tokens": jnp.asarray(toks)},
                                  cache)
        jax.effects_barrier()
        prefill_dropped = sum(dropped)
        steps = [np.asarray(logits[0, -1], np.float64)]
        out = [int(np.argmax(steps[-1]))]
        for _ in range(cs.PARITY["steps"]):
            logits, cache = m.decode_step(params, jnp.asarray([[out[-1]]]),
                                          cache)
            steps.append(np.asarray(logits[0, -1], np.float64))
            out.append(int(np.argmax(steps[-1])))
    finally:
        JL.moe_dispatch_indices = orig
    return steps, out, prefill_dropped


def main() -> int:
    sys.path.insert(0, os.path.dirname(HERE))
    import numpy as np
    import chip_smoke as cs
    rows = {"f32": {}, "bf16": {}}
    for name, (arch, config, prompt_len, max_len) in F32_ROWS.items():
        steps, out, dropped = run(cs, arch, config, prompt_len, max_len)
        last = steps[-1]
        if "drop" in name:
            assert dropped > 0, f"{name}: the JAX prefill drops nothing"
        rows["f32"][name] = dict(
            arch=arch, config=config, prompt_len=prompt_len,
            max_len=max_len, prefill_dropped=dropped,
            expected=dict(tokens=out, head=last[:16].tolist(),
                          l2=float(np.linalg.norm(last)),
                          top5=np.argsort(-last)[:5].tolist()))
    for name, (arch, config, prompt_len, max_len) in BF16_ROWS.items():
        steps, out, _ = run(cs, arch, config, prompt_len, max_len)
        rows["bf16"][name] = dict(
            arch=arch, config=config, prompt_len=prompt_len,
            max_len=max_len, steps=[cs.parity_step(np, s) for s in steps])
    with open(OUT, "w") as f:
        json.dump(rows, f, indent=1)
        f.write("\n")
    print(json.dumps({k: {n: r.get("prefill_dropped") for n, r in v.items()}
                      for k, v in rows.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
