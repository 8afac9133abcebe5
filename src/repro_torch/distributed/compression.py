"""Gradient compression (counterpart of `repro.distributed.compression`).

int8 block quantisation of the gradients: a round trip through the
format a compressed data-parallel all-reduce would carry (1 byte an
element plus an f32 scale a block of ``block``), which bounds the
optimizer's input precision. `psum_int8`, the explicit int8-payload
all-reduce, needs a collective and waits for the sharding bullet (ROADMAP
Queue 1, item 6 (sharding)).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def _q8(x, block: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    b = flat.reshape(-1, block)
    scale = b.abs().amax(dim=1, keepdim=True).clamp_min(1e-12)
    q = torch.round(b / scale * 127.0).clamp(-127, 127).to(torch.int8)
    return q, scale


def _dq8(q, scale, shape, size: int):
    flat = (q.to(torch.float32) * scale / 127.0).reshape(-1)[:size]
    return flat.reshape(shape)


def quantize_roundtrip(x, block: int = 256):
    """x quantised to int8 blocks and back (f32 of x's shape)."""
    q, s = _q8(x, block)
    return _dq8(q, s, x.shape, x.numel())


def compress_grads_int8(grads: Dict[str, torch.Tensor],
                        block: int = 256) -> Dict[str, torch.Tensor]:
    """The round trip on every gradient leaf of at least ``block``
    elements (smaller leaves pass unchanged)."""
    return {k: quantize_roundtrip(g, block) if g.numel() >= block else g
            for k, g in grads.items()}


def psum_int8(x, axis_name=None, block: int = 256):
    """The int8-payload all-reduce of the JAX package: not ported."""
    raise NotImplementedError(
        "psum_int8 needs a collective across devices: not ported (ROADMAP "
        "Queue 1, item 6 (sharding))")
