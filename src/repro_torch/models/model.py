"""Model assembly of the port: the dense family (counterpart of
`repro.models.model`).

`Model` is an ``nn.Module`` whose module tree mirrors the JAX parameter
tree (``embed``, ``unembed``, ``final_norm``, ``blocks.norm1``,
``blocks.attn.wq``, ...; block leaves stacked on a leading layer axis).
``build_model(cfg, device)`` allocates it on the device without filling
it; ``init_weights(generator)`` fills it in place, and
`convert.from_jax_params` loads the JAX package's weights instead.

The serving methods follow `repro.models.model.Model.prefill` and
``decode_step`` for the dense family, with the hand-written kernels at
the places where the JAX package computes what a TPU kernel computes:

* prefill attention: K2 (`kernels.flash_attention`), one launch a layer;
* decode attention over the cache: K3 (`kernels.decode_attention`), one
  launch a layer a token; slot ``min(length, T - 1)``, positions
  ``<= length`` attended, scale ``1/sqrt(hd)``;
* the first norm1 and the qk-norm: K4a (`kernels.rmsnorm.rmsnorm`);
* every residual add with the norm after it -- each norm2, each later
  norm1 and the final norm -- K4b (`kernels.rmsnorm.rmsnorm_residual`).

Numbers: in f32 this is the JAX model's arithmetic up to the order of
sums. In bf16 three places round differently: the norms multiply by the
weight in f32 before their one cast (the JAX model casts first); a
fused norm reads the f32 sum of the residual add, not its bf16 rounding
(the residual stream itself is bitwise the JAX ``h + y``); and K3 keeps
the softmax weights in f32 where the JAX model casts them to bf16
before the value product.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.utils.device import resolve_device
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.rmsnorm import rmsnorm_residual
from repro_torch.models import layers as L
from repro_torch.models.cache import CacheSpec, cache_spec
from repro_torch.models.config import ModelConfig


class DenseBlocks(nn.Module):
    """The stacked dense blocks: norm1, attention, norm2, MLP."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        n, d = cfg.n_layers, cfg.d_model
        self.norm1 = L.stacked(n, d, dtype=cfg.pdtype, device=device)
        self.norm2 = L.stacked(n, d, dtype=cfg.pdtype, device=device)
        self.attn = L.Attention(cfg, n, device)
        self.mlp = L.MLP(cfg, n, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.norm1.fill_(1.0)
        self.norm2.fill_(1.0)
        self.attn.reset_parameters(gen)
        self.mlp.reset_parameters(gen)


class Model(nn.Module):
    """A dense decoder-only LM on one device."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r}: only 'dense' is ported (ROADMAP "
                "Queue 1, item 11; ssm/hybrid: Queue 2, K5)")
        if cfg.window is not None or cfg.mla or cfg.n_experts:
            raise NotImplementedError(
                "sliding windows, MLA and MoE are not ported (ROADMAP "
                "Queue 1, item 11)")
        self.cfg = cfg
        self.device = torch.device(device)
        v, d = cfg.padded_vocab, cfg.d_model
        kw = dict(dtype=cfg.pdtype, device=self.device)
        self.embed = nn.Parameter(torch.empty(v, d, **kw),
                                  requires_grad=False)
        if not cfg.tie_embeddings:
            self.unembed = nn.Parameter(torch.empty(d, v, **kw),
                                        requires_grad=False)
        self.final_norm = nn.Parameter(torch.empty(d, **kw),
                                       requires_grad=False)
        self.blocks = DenseBlocks(cfg, self.device)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> "Model":
        """Fill every parameter in place with the JAX package's init
        distributions (N(0, 1) times its scale, ones, zeros) from
        ``gen``, a generator on the model's device."""
        cfg = self.cfg
        L.init_normal_(self.embed, gen, 0.02)
        if not cfg.tie_embeddings:
            L.init_normal_(self.unembed, gen, cfg.d_model ** -0.5)
        self.final_norm.fill_(1.0)
        self.blocks.reset_parameters(gen)
        return self

    def cache_spec(self, batch: int, max_len: int) -> CacheSpec:
        return cache_spec(self.cfg, batch, max_len)

    # --------------------------------------------------------- helpers
    def _head(self):
        return self.embed.T if self.cfg.tie_embeddings else self.unembed

    def _rope(self, positions):
        return L.rope_angles(positions, self.cfg.head_dim_,
                             self.cfg.rope_theta)

    def _logits(self, y, h):
        """Final norm of the last residual add (K4b), then the head."""
        x, _ = rmsnorm_residual(y.contiguous(), h.contiguous(),
                                self.final_norm, eps=self.cfg.norm_eps)
        return L.logits_from_hidden(self._head(), self.cfg, x)

    # ---------------------------------------------------------- serving
    @torch.no_grad()
    def prefill(self, batch, cache):
        """Full-sequence forward that fills the cache. ``batch`` is
        ``{"tokens": (B, S) int}``. Writes the last ``min(S, T)``
        positions' k and v into cache slots ``0..``, sets ``length`` to
        S and returns (last-position logits (B, 1, V), cache)."""
        cfg, blk = self.cfg, self.blocks
        tokens = batch["tokens"]
        S = tokens.shape[1]
        h = L.embed_tokens(self.embed, cfg, tokens)
        cos, sin = self._rope(torch.arange(S, device=h.device))
        n = min(S, cache["k"].shape[2])
        x = L.rms_norm(h, blk.norm1[0], cfg.norm_eps)
        for li in range(cfg.n_layers):
            y, (k, v) = blk.attn(li, x, cos, sin)
            cache["k"][li, :, :n] = k[:, S - n:]
            cache["v"][li, :, :n] = v[:, S - n:]
            x, h = rmsnorm_residual(y, h, blk.norm2[li], eps=cfg.norm_eps)
            y = blk.mlp(li, x)
            if li + 1 < cfg.n_layers:
                x, h = rmsnorm_residual(y, h, blk.norm1[li + 1],
                                        eps=cfg.norm_eps)
        cache["length"] = S
        return self._logits(y[:, -1:], h[:, -1:]), cache

    @torch.no_grad()
    def decode_step(self, tokens, cache):
        """One-token decode against the cache. tokens (B, 1). Returns
        (logits (B, 1, V), cache) with ``length`` one further."""
        cfg, blk = self.cfg, self.blocks
        length = cache["length"]
        T = cache["k"].shape[2]
        slot = min(length, T - 1)
        h = L.embed_tokens(self.embed, cfg, tokens)
        # the position as a device arange: no host-to-device copy
        cos, sin = self._rope(torch.arange(length, length + 1,
                                           device=h.device))
        x = L.rms_norm(h, blk.norm1[0], cfg.norm_eps)
        for li in range(cfg.n_layers):
            q, k, v = blk.attn.qkv(li, x, cos, sin)
            k_l, v_l = cache["k"][li], cache["v"][li]
            k_l[:, slot] = k[:, 0]
            v_l[:, slot] = v[:, 0]
            y = blk.attn.out(li, decode_attention(q, k_l, v_l, length))
            x, h = rmsnorm_residual(y, h, blk.norm2[li], eps=cfg.norm_eps)
            y = blk.mlp(li, x)
            if li + 1 < cfg.n_layers:
                x, h = rmsnorm_residual(y, h, blk.norm1[li + 1],
                                        eps=cfg.norm_eps)
        cache["length"] = length + 1
        return self._logits(y, h), cache


def build_model(cfg: ModelConfig, device=None) -> Model:
    """Allocate ``cfg``'s model on ``device`` (CUDA unless "cpu" is
    asked for), its parameters not yet filled: call ``init_weights`` or
    load a state dict."""
    return Model(cfg, resolve_device(device))
