"""Synthetic LM data pipeline (a copy of `repro.train.data`: the same
numpy draws, so its batches are bitwise the JAX package's).

Deterministic and seekable (step -> batch). The batches are numpy
arrays; the trainer moves them to its device.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def synthetic_lm_batch(cfg, global_batch: int, seq_len: int, step: int,
                       seed: int = 0) -> Dict[str, np.ndarray]:
    """Markov-ish synthetic token stream (not uniform noise: a learnable
    bigram structure, so the training loss falls)."""
    rng = np.random.default_rng(seed + step * 9973)
    V = cfg.vocab_size
    # latent bigram table (fixed by seed, not step)
    trng = np.random.default_rng(seed)
    hot = trng.integers(0, V, size=256)
    toks = np.empty((global_batch, seq_len + 1), np.int32)
    toks[:, 0] = rng.integers(0, V, global_batch)
    noise = rng.random((global_batch, seq_len))
    rnd = rng.integers(0, V, (global_batch, seq_len))
    for t in range(seq_len):
        follow = hot[toks[:, t] % 256]
        toks[:, t + 1] = np.where(noise[:, t] < 0.7, follow, rnd[:, t])
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    if cfg.family == "vlm":
        n = cfg.n_patches
        batch["tokens"] = batch["tokens"][:, :seq_len - n]
        batch["patch_embeds"] = rng.standard_normal(
            (global_batch, n, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (global_batch, cfg.n_enc_positions, cfg.d_model)
        ).astype(np.float32)
    return batch


def synthetic_lm_batches(cfg, global_batch: int, seq_len: int,
                         steps: int, seed: int = 0
                         ) -> Iterator[Dict[str, np.ndarray]]:
    for s in range(steps):
        yield synthetic_lm_batch(cfg, global_batch, seq_len, s, seed)
