"""Decode-time caches of the dense, moe, ssm and hybrid families
(counterpart of `repro.models.cache`).

Per-layer tensors are stacked on a leading ``layers`` axis, as in the
JAX package:

* dense and moe (no MLA): k and v (L, B, T, KVH, hd) in the compute
  dtype, keys already rotary-encoded (rope applied at write time); the
  moe family's first dense layers first, then its MoE layers;
* moe with MLA (DeepSeek-V3): the latent ``c_kv`` (L, B, T,
  kv_lora_rank) and the shared rotary key ``k_rope`` (L, B, T,
  qk_rope_dim), rotary-encoded, in the compute dtype, dense layers
  first: kv_lora_rank + qk_rope_dim values a token a layer (1,152 bytes
  in bf16 at published widths, where MHA's k and v would take 64 KB);
* ssm: ``conv`` (L, B, K-1, d_inner + 2 g n), the last K-1 inputs of
  each layer's causal conv, in the compute dtype, and ``ssm`` (L, B, h,
  p, n), the state, in f32 whatever the compute dtype;
* hybrid: those two, plus k and v (L / attn_every, B, T, KVH, hd) for
  the shared attention block's applications.

T, the attention length, is ``min(max_len, window)`` when a window is
given (sliding-window serving), else ``max_len``.

``length`` is a Python int, so the decode loop never reads the device
to know where it writes. Unlike the JAX package, whose functions return
rewritten arrays, the port's prefill and decode step write into these
tensors in place and return the same dict.
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


# the families the JAX package serves that the port does not, and the
# ROADMAP item that ports each
NOT_PORTED = {
    "encdec": "ROADMAP Queue 1, item 6.3 (enc-dec)",
    "vlm": "ROADMAP Queue 1, item 6.3 (VLM)",
}


def cache_spec(cfg, batch: int, max_len: int, window=None) -> CacheSpec:
    """The cache of ``cfg``'s family for ``batch`` sequences of at most
    ``max_len`` positions, the attention cache bounded by ``window``."""
    if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        raise NotImplementedError(
            f"cache of family {cfg.family!r}: not ported "
            f"({NOT_PORTED.get(cfg.family, 'ROADMAP Queue 1, item 6')})")
    shapes, dtypes = {}, {}
    L = cfg.n_layers
    attn_len = min(max_len, window) if window else max_len
    if cfg.family != "ssm":
        kv = (batch, attn_len, cfg.n_kv_heads, cfg.head_dim_)
    if cfg.mla:
        shapes["c_kv"] = (L, batch, attn_len, cfg.kv_lora_rank)
        shapes["k_rope"] = (L, batch, attn_len, cfg.qk_rope_dim)
    elif cfg.family in ("dense", "moe"):
        shapes["k"] = shapes["v"] = (L,) + kv
    else:
        conv_c = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
        shapes["conv"] = (L, batch, cfg.ssm_conv - 1, conv_c)
        shapes["ssm"] = (L, batch, cfg.ssm_heads, cfg.ssm_headdim,
                         cfg.ssm_state)
        dtypes["ssm"] = torch.float32
        if cfg.family == "hybrid":
            shapes["k"] = shapes["v"] = (L // cfg.attn_every,) + kv
    for k in shapes:
        dtypes.setdefault(k, cfg.cdtype)
    return CacheSpec(shapes, dtypes)
