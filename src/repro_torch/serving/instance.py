"""A resident model replica: the serving-side realisation of the
paper's "function instance" (counterpart of `repro.serving.instance`).

Cold start is real: `ModelInstance.cold_start` builds the model on the
device, fills its weights from a generator seeded with the function's
id, runs one warm-up prefill and decode step and synchronises; the
scheduler sees the measured seconds as the paper's t_j^l. `execute`
serves one request (prefill plus ``gen_tokens`` greedy decode steps,
synchronised before the clock stops) and returns its seconds, t_i^e.
`evict` drops the model and returns its seconds, t_j^v. Weights are
random (nothing is downloaded), as in the JAX package, whose instances
draw theirs from ``jax.random.key(fn_id)``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.utils.device import resolve_device
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig


@dataclass
class ServedFunction:
    """A deployable serverless function = model config + request shape."""

    fn_id: int
    cfg: ModelConfig
    prompt_len: int = 32
    gen_tokens: int = 8
    batch: int = 1
    max_len: int = 64
    name: str = ""

    def __post_init__(self):
        if not self.name:
            self.name = self.cfg.name


class ModelInstance:
    """One resident replica of a ServedFunction on ``device`` (CUDA
    unless "cpu" is asked for)."""

    def __init__(self, fn: ServedFunction, device=None):
        self.fn = fn
        self.device = resolve_device(device)
        self.model = None
        self.cold_time: Optional[float] = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------- lifecycle
    def cold_start(self) -> float:
        """Build + init + warm-up; returns measured seconds (t_j^l)."""
        t0 = time.perf_counter()
        model = build_model(self.fn.cfg, self.device)
        gen = torch.Generator(self.device).manual_seed(self.fn.fn_id)
        self.model = model.init_weights(gen)
        self._serve(self._dummy_batch(), gen_tokens=1)
        self._sync()
        self.cold_time = time.perf_counter() - t0
        return self.cold_time

    def evict(self) -> float:
        t0 = time.perf_counter()
        self.model = None
        return time.perf_counter() - t0

    # ------------------------------------------------------- execution
    def _dummy_batch(self, seed: int = 0) -> Dict[str, Any]:
        fn = self.fn
        rng = np.random.default_rng(seed)
        tokens = rng.integers(0, fn.cfg.vocab_size,
                              (fn.batch, fn.prompt_len))
        return {"tokens": torch.tensor(tokens, dtype=torch.long,
                                       device=self.device)}

    def _serve(self, batch, gen_tokens: int) -> None:
        """Prefill, then ``gen_tokens`` greedy decode steps, on a fresh
        cache; the tokens stay on the device (no sync in the loop)."""
        model = self.model
        cache = model.cache_spec(self.fn.batch,
                                 self.fn.max_len).zeros(self.device)
        logits, cache = model.prefill(batch, cache)
        tok = logits[:, -1].argmax(-1)[:, None]
        for _ in range(gen_tokens):
            logits, cache = model.decode_step(tok, cache)
            tok = logits[:, -1].argmax(-1)[:, None]

    def execute(self, seed: int = 0) -> float:
        """Serve one request (prefill + gen_tokens decode steps);
        returns measured seconds (the request's t_i^e)."""
        if self.model is None:
            raise RuntimeError("instance not warm: call cold_start first")
        t0 = time.perf_counter()
        self._serve(self._dummy_batch(seed), self.fn.gen_tokens)
        self._sync()
        return time.perf_counter() - t0
