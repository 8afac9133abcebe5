"""Carry a JAX parameter tree across to the port.

`from_jax_params` turns the tree of `repro.models.Model.init` (nested
dicts whose leaves are numpy arrays, or anything ``np.asarray`` takes;
the ``blocks`` leaves stacked on a leading layer axis; the dense, ssm
and hybrid trees: ``blocks.norm1``, ``blocks.attn.*`` / ``blocks.mlp.*``
or ``blocks.mamba.*``, and the hybrid's ``shared_attn.{shared_in,
norm1, norm2, attn.*, mlp.*}``; the moe tree: ``dense_blocks.*`` and
``moe_blocks.{norm1, norm2, attn.*, moe.*}``, with MLA the ``attn.*``
leaves ``wq_a``, ``q_a_norm``, ``wq_b``, ``wkv_a``, ``kv_a_norm``,
``wk_b``, ``wv_b`` and ``wo``, and with MTP ``mtp.{mtp_proj,
mtp_block.*}``) into the state dict of
`repro_torch.models.Model`: the module tree mirrors the JAX tree, so a
leaf's path joined by dots is its parameter's name and its layout is
the same. Load it with ``model.load_state_dict(...)`` (strict:
a missing or extra leaf raises), and both packages compute the same
function.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.models.cache import NOT_PORTED
from repro_torch.models.model import FAMILIES


def from_jax_params(cfg, tree) -> Dict[str, torch.Tensor]:
    """State dict (CPU tensors in ``cfg.pdtype``) of the JAX tree."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported ("
            f"{NOT_PORTED.get(cfg.family, 'ROADMAP Queue 1, item 6')})")
    out: Dict[str, torch.Tensor] = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(prefix + (k,), v)
            return
        # via f32: numpy has no bf16 of its own, and bf16 -> f32 -> bf16
        # is exact
        arr = np.asarray(node, dtype=np.float32)
        out[".".join(prefix)] = torch.tensor(arr).to(cfg.pdtype)

    walk((), tree)
    return out
