"""Transformer layers of the port (counterpart of the dense subset of
`repro.models.layers`).

Parameters keep the JAX package's names and layouts (``wq`` (d, h, hd),
``wo`` (h, hd, d), ``w_gate`` (d, f), ...), stacked on a leading layer
axis as the JAX package stacks them for its scan, so that a JAX
parameter tree maps onto the port's state one leaf to one tensor
(`repro_torch.models.convert`). A layer's forward takes its index ``l``
and reads its slice of every stacked tensor, or (a training forward,
`Model.loss`) a dict of the layer's tensors, unbound from the stacked
parameters once a forward.

Where the TPU package has a kernel, the port calls its hand-written one:
`rms_norm` is K4a (`kernels.rmsnorm`) and full-sequence attention K2
(`kernels.flash_attention`), with gradients each through its autograd
Function and backward kernel (the model calls K4b itself). Projections,
the MLP and `cross_entropy` are plain torch ops, as the JAX package
leaves them to XLA. MoE, MLA, LayerNorm/GELU blocks and the shard_map
tensor-parallel paths are not ported (ROADMAP Queue 1, item 6).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm


def stacked(n_layers, *shape, dtype, device) -> nn.Parameter:
    """An uninitialised (n_layers, *shape) parameter on ``device`` (just
    ``shape`` when ``n_layers`` is None: a block that is not stacked,
    such as the hybrid family's shared one): allocated, not filled, so
    that a full-width model is built in place on the card
    (`init_normal_` and friends fill it). It requires no gradient until
    the model is made trainable (``build_model(..., trainable=True)``)."""
    lead = () if n_layers is None else (n_layers,)
    return nn.Parameter(torch.empty(*lead, *shape, dtype=dtype,
                                    device=device), requires_grad=False)


def at(mod: nn.Module, name: str, l):
    """Layer ``l``'s tensor ``name`` of ``mod``: the stacked parameter's
    slice ``l``; the parameter itself when ``l`` is None (a block that is
    not stacked); ``l[name]`` when ``l`` is a dict of the layer's
    tensors (a training forward unbinds the stacked parameters once:
    the backward of a slice would allocate the whole stacked tensor)."""
    if isinstance(l, dict):
        return l[name]
    p = getattr(mod, name)
    return p if l is None else p[l]


def init_normal_(p: torch.Tensor, gen: torch.Generator,
                 scale: float) -> None:
    """N(0, 1) * scale in place, as `repro.models.layers.ParamSet`'s
    "normal" init (other numbers: the generators differ)."""
    p.normal_(generator=gen).mul_(scale)


# ---------------------------------------------------------------- norms
def rms_norm(x, scale, eps: float):
    """RMSNorm over the last dim through K4a. The weight product is in
    f32 before the one cast (the TPU kernel's contract); the JAX model
    casts before the product, one bf16 rounding apart."""
    return rmsnorm(x, scale, eps=eps)


# ---------------------------------------------------------------- rotary
def rope_angles(positions, dim: int, theta: float):
    """positions (...,) -> cos/sin (..., dim/2), f32."""
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                          device=positions.device) / dim))
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x (..., S, H, D); cos/sin (..., S, D/2) broadcast over heads, cast
    to x's dtype before the products (half-split layout)."""
    x1, x2 = x.chunk(2, dim=-1)
    c = cos[..., None, :].to(x1.dtype)
    s = sin[..., None, :].to(x1.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# ------------------------------------------------------------- attention
class Attention(nn.Module):
    """Grouped-query self-attention of ``n_layers`` layers (one block,
    not stacked, when None; its methods then take ``l=None``), with the
    optional qkv bias (qwen1.5) and per-head qk RMSNorm (qwen3)."""

    def __init__(self, cfg, n_layers, device):
        super().__init__()
        self.cfg = cfg
        d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
            cfg.head_dim_
        kw = dict(dtype=cfg.pdtype, device=device)
        self.wq = stacked(n_layers, d, h, hd, **kw)
        self.wk = stacked(n_layers, d, kv, hd, **kw)
        self.wv = stacked(n_layers, d, kv, hd, **kw)
        self.wo = stacked(n_layers, h, hd, d, **kw)
        if cfg.qkv_bias:
            self.bq = stacked(n_layers, h, hd, **kw)
            self.bk = stacked(n_layers, kv, hd, **kw)
            self.bv = stacked(n_layers, kv, hd, **kw)
        if cfg.qk_norm:
            self.q_norm = stacked(n_layers, hd, **kw)
            self.k_norm = stacked(n_layers, hd, **kw)

    def reset_parameters(self, gen: torch.Generator) -> None:
        cfg = self.cfg
        d, hhd = cfg.d_model, cfg.n_heads * cfg.head_dim_
        for p in (self.wq, self.wk, self.wv):
            init_normal_(p, gen, 1.0 / math.sqrt(d))
        init_normal_(self.wo, gen, 1.0 / math.sqrt(hhd))
        if cfg.qkv_bias:
            for p in (self.bq, self.bk, self.bv):
                p.zero_()
        if cfg.qk_norm:
            self.q_norm.fill_(1.0)
            self.k_norm.fill_(1.0)

    def qkv(self, l: int, x, cos, sin):
        """Projections of x (B, S, d) for layer ``l``: q (B, S, h, hd)
        and k, v (B, S, kv, hd), with bias, qk-norm and rope applied."""
        cfg = self.cfg
        B, S, d = x.shape
        h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        q = (x @ at(self, "wq", l).view(d, h * hd)).view(B, S, h, hd)
        k = (x @ at(self, "wk", l).view(d, kv * hd)).view(B, S, kv, hd)
        v = (x @ at(self, "wv", l).view(d, kv * hd)).view(B, S, kv, hd)
        if cfg.qkv_bias:
            q = q + at(self, "bq", l)
            k = k + at(self, "bk", l)
            v = v + at(self, "bv", l)
        if cfg.qk_norm:
            q = rms_norm(q, at(self, "q_norm", l), cfg.norm_eps)
            k = rms_norm(k, at(self, "k_norm", l), cfg.norm_eps)
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v

    def out(self, l: int, y):
        """Output projection of the heads y (B, S, h, hd) -> (B, S, d)."""
        B, S, h, hd = y.shape
        return y.reshape(B, S, h * hd) @ at(self, "wo", l).view(h * hd, -1)

    def forward(self, l: int, x, cos, sin):
        """Causal full-sequence attention (prefill) through K2. Returns
        (y, (k, v)) with k already rotary-encoded."""
        q, k, v = self.qkv(l, x, cos, sin)
        y = flash_attention(q, k, v, causal=True)
        return self.out(l, y), (k, v)


# ------------------------------------------------------------------ MLP
class MLP(nn.Module):
    """SwiGLU MLP of ``n_layers`` layers (one, not stacked, when None):
    (silu(x Wg) * x Wu) Wd."""

    def __init__(self, cfg, n_layers, device):
        super().__init__()
        self.cfg = cfg
        d, f = cfg.d_model, cfg.d_ff
        kw = dict(dtype=cfg.pdtype, device=device)
        self.w_gate = stacked(n_layers, d, f, **kw)
        self.w_up = stacked(n_layers, d, f, **kw)
        self.w_down = stacked(n_layers, f, d, **kw)

    def reset_parameters(self, gen: torch.Generator) -> None:
        cfg = self.cfg
        init_normal_(self.w_gate, gen, 1.0 / math.sqrt(cfg.d_model))
        init_normal_(self.w_up, gen, 1.0 / math.sqrt(cfg.d_model))
        init_normal_(self.w_down, gen, 1.0 / math.sqrt(cfg.d_ff))

    def forward(self, l: int, x):
        return (F.silu(x @ at(self, "w_gate", l)) * (x @ at(self, "w_up", l))) \
            @ at(self, "w_down", l)


# ----------------------------------------------------------- embeddings
def embed_tokens(embed, cfg, tokens):
    """Rows of the (padded vocab, d) table for tokens (B, S), in the
    compute dtype."""
    return embed[tokens].to(cfg.cdtype)


def logits_from_hidden(head, cfg, x):
    """Logits over the padded vocab from the final-normed hidden state
    x (B, S, d); ``head`` is ``unembed`` (d, V), or ``embed.T`` when the
    embeddings are tied. The final norm itself runs in the trunk, fused
    with the last residual add (K4b)."""
    return x @ head.to(cfg.cdtype)


def cross_entropy(logits, labels, vocab_size: int):
    """Mean CE over positions with 0 <= label < vocab_size (the padded
    vocab's tail and negative labels masked), as
    `repro.models.layers.cross_entropy`: the f32 log-sum-exp over the
    whole padded vocab minus the gold logit."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(-1, labels.clamp(0, lf.shape[-1] - 1)[..., None])[..., 0]
    mask = (labels >= 0) & (labels < vocab_size)
    loss = torch.where(mask, lse - gold, torch.zeros_like(lse))
    return loss.sum() / mask.sum().clamp_min(1)
