"""The JAX package's outputs for the model_parity rows of chip_smoke.py
that this script owns: the MoE family (DeepSeek-MoE-16B's smoke config),
the hybrid family's prompt longer than its cache, and MLA (DeepSeek-V3's
smoke config with its published head dims). Writes
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
    cache of 48 (S % W = 32, the sliding-window prefill and the ring);
  - ``deepseek-v3-671b heads f32`` (the auto impl: the dense oracle) and
    ``... f32 ep drop`` (the capacity path, asserted to drop): the smoke
    size with DeepSeek-V3's published head dims (`MLA_HEADS`).
* ``bf16`` rows keep each step's `chip_smoke.parity_step`, as
  PARITY_BF16_CASES: ``deepseek-moe-16b smoke bf16`` and
  ``deepseek-v3-671b heads bf16``. The MLA row also keeps ``own``: each
  step's largest distance, at the logits the row compares (the top-5
  and logits[:8]), of the JAX package's bf16 run from its f32 run on the
  same weights (the bf16 ones, widened exactly) fed the same tokens:
  chip_smoke adds it to the row's bound (the MLA chain's roundings move
  the JAX package's own bf16 logits by about as much as the bound).

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
MLA = "deepseek-v3-671b"
# DeepSeek-V3's published head dims at the smoke size (d 128, 4 heads,
# q_lora 64, 8 experts top-2, 4 layers: 1 dense + 3 MoE)
MLA_HEADS = dict(qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
                 kv_lora_rank=512, head_dim=192)
F32_ROWS.update({
    f"{MLA} heads f32": (MLA, MLA_HEADS, 16, 32),
    f"{MLA} heads f32 ep drop": (MLA, dict(MLA_HEADS, moe_impl="ep",
                                           capacity_factor=0.5), 16, 32),
})
BF16_ROWS = {f"{MOE} smoke bf16": (MOE, _BF16, 16, 32),
             f"{MLA} heads bf16": (MLA, dict(MLA_HEADS, **_BF16), 16, 32)}


def run(cs, arch, config, prompt_len, max_len, feed=None, round_to=None):
    """The JAX model's greedy run: (per-step last logits as f64 numpy,
    tokens, choices dropped in the prefill's MoE dispatch). With ``feed``
    (tokens), those tokens are decoded in place of the greedy ones; with
    ``round_to`` (a dtype config), the weights are first rounded to its
    param dtype."""
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
    if round_to is not None:
        # the weights of the row in that dtype, widened back exactly
        w = {k: np.asarray(jnp.asarray(v, round_to["param_dtype"]),
                           np.float32) for k, v in w.items()}
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
        for i in range(cs.PARITY["steps"]):
            tok = out[-1] if feed is None else feed[i]
            logits, cache = m.decode_step(params, jnp.asarray([[tok]]),
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
        kept = [cs.parity_step(np, s) for s in steps]
        rows["bf16"][name] = dict(
            arch=arch, config=config, prompt_len=prompt_len,
            max_len=max_len, steps=kept)
        if arch == MLA:
            # the same weights (parity_weights, rounded to bf16: `run`
            # casts them) widened to f32 and the same tokens, in f32
            wide = dict(config, param_dtype="float32",
                        compute_dtype="float32")
            exact, _, _ = run(cs, arch, wide, prompt_len, max_len,
                              feed=out[:-1], round_to=_BF16)
            rows["bf16"][name]["own"] = [
                round(float(max(np.abs(np.asarray(k[4]) - e[k[3]]).max(),
                                np.abs(s[:8] - e[:8]).max())), 4)
                for k, s, e in zip(kept, steps, exact)]
    with open(OUT, "w") as f:
        json.dump(rows, f, indent=1)
        f.write("\n")
    print(json.dumps({k: {n: r.get("prefill_dropped") for n, r in v.items()}
                      for k, v in rows.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
