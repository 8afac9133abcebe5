"""Decode-time KV cache of the dense family (counterpart of
`repro.models.cache`).

Per-layer tensors are stacked on a leading ``layers`` axis: k and v are
(L, B, T, KVH, hd) in the compute dtype, keys already rotary-encoded
(rope applied at write time), as in the JAX package. ``length`` is a
Python int, so the decode loop never reads the device to know where it
writes. Unlike the JAX package, whose functions return rewritten
arrays, the port's prefill and decode step write into these tensors in
place and return the same dict.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch


@dataclass
class CacheSpec:
    """Shapes and dtypes of every cache tensor of a config."""

    shapes: Dict[str, Tuple[int, ...]]
    dtypes: Dict[str, torch.dtype]

    def zeros(self, device) -> dict:
        out = {k: torch.zeros(s, dtype=self.dtypes[k], device=device)
               for k, s in self.shapes.items()}
        out["length"] = 0
        return out


def cache_spec(cfg, batch: int, max_len: int) -> CacheSpec:
    """The dense family's cache: k and v (L, batch, max_len, KVH, hd)."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"cache of family {cfg.family!r}: only 'dense' is ported "
            "(ROADMAP Queue 1, item 11; ssm/hybrid: Queue 2, K5)")
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim_)
    return CacheSpec({"k": shape, "v": shape},
                     {"k": cfg.cdtype, "v": cfg.cdtype})
