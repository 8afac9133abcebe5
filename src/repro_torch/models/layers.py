"""Transformer layers of the port (counterpart of the dense and MoE
subset of `repro.models.layers`).

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
Function and backward kernel (the model calls K4b itself). DeepSeek-V3's
multi-head latent attention (`MLA`) runs its prefill through K2 at head
dims (192, 128) and its decode through K3-mla
(`kernels.decode_attention.mla_decode_attention`), the attention of the
JAX package's `_decode_mla`, which has no TPU kernel. Projections,
the MLP, the MoE layer's router, dispatch and expert products and
`cross_entropy` are plain torch ops, as the JAX package leaves them to
XLA (its expert products are einsums; here ``torch.bmm`` over the
expert axis). LayerNorm/GELU blocks (ROADMAP Queue 1, item 6.3,
enc-dec) and the shard_map tensor-parallel paths, the expert-parallel
``moe_apply_ep_shardmap`` among them (item 6.4), are not ported.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.decode_attention import mla_decode_attention
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

    def forward(self, l: int, x, cos, sin, window=None):
        """Causal full-sequence attention (prefill) through K2, with the
        sliding ``window`` (row i sees keys i - window..i) when given.
        Returns (y, (k, v)) with k already rotary-encoded."""
        q, k, v = self.qkv(l, x, cos, sin)
        y = flash_attention(q, k, v, causal=True, window=window)
        return self.out(l, y), (k, v)


# ------------------------------------------------------------------ MLA
class MLA(nn.Module):
    """DeepSeek multi-head latent attention of ``n_layers`` layers (one,
    not stacked, when None), `repro.models.layers.init_mla` / `mla_apply`
    and `repro.models.model._decode_mla`: ``wq_a`` (d, qr), ``q_a_norm``
    (qr,), ``wq_b`` (qr, h, dn + dr), ``wkv_a`` (d, kvr + dr),
    ``kv_a_norm`` (kvr,), ``wk_b`` (kvr, h, dn), ``wv_b`` (kvr, h, dv),
    ``wo`` (h, dv, d). The cache keeps the latent ``c_kv`` (kvr) and the
    one shared rotary key ``k_rope`` (dr) a token.

    ``c_kv`` and ``k_rope`` are column slices of the (B, S, kvr + dr)
    ``wkv_a`` product; K4a takes contiguous rows, so ``c_kv`` is copied
    once before its norm (one (B, S, kvr) copy a layer a prefill or
    decode step)."""

    def __init__(self, cfg, n_layers, device):
        super().__init__()
        self.cfg = cfg
        d, h = cfg.d_model, cfg.n_heads
        qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
        dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        kw = dict(dtype=cfg.pdtype, device=device)
        self.wq_a = stacked(n_layers, d, qr, **kw)
        self.q_a_norm = stacked(n_layers, qr, **kw)
        self.wq_b = stacked(n_layers, qr, h, dn + dr, **kw)
        self.wkv_a = stacked(n_layers, d, kvr + dr, **kw)
        self.kv_a_norm = stacked(n_layers, kvr, **kw)
        self.wk_b = stacked(n_layers, kvr, h, dn, **kw)
        self.wv_b = stacked(n_layers, kvr, h, dv, **kw)
        self.wo = stacked(n_layers, h, dv, d, **kw)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """The JAX package's scales: 1/sqrt(first dim) for every matrix
        but ``wo`` (1/sqrt(h dv)); the norms' weights ones."""
        cfg = self.cfg
        d, qr, kvr = cfg.d_model, cfg.q_lora_rank, cfg.kv_lora_rank
        for p, fan_in in ((self.wq_a, d), (self.wq_b, qr), (self.wkv_a, d),
                          (self.wk_b, kvr), (self.wv_b, kvr)):
            init_normal_(p, gen, 1.0 / math.sqrt(fan_in))
        init_normal_(self.wo, gen, 1.0 / math.sqrt(cfg.n_heads
                                                   * cfg.v_head_dim))
        self.q_a_norm.fill_(1.0)
        self.kv_a_norm.fill_(1.0)

    @property
    def scale(self) -> float:
        cfg = self.cfg
        return 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)

    def _query(self, l, x, cos, sin):
        """q_nope (B, S, h, dn) and the rotary-encoded q_rope (B, S, h,
        dr) of x (B, S, d): the LoRA, K4a on ``q_a_norm``, ``wq_b``."""
        cfg = self.cfg
        B, S, _ = x.shape
        h, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
        q = rms_norm(x @ at(self, "wq_a", l), at(self, "q_a_norm", l),
                     cfg.norm_eps)
        q = (q @ at(self, "wq_b", l).reshape(cfg.q_lora_rank,
                                             h * (dn + dr))
             ).view(B, S, h, dn + dr)
        return q[..., :dn], apply_rope(q[..., dn:], cos, sin)

    def _latent(self, l, x, cos, sin):
        """c_kv (B, S, kvr), K4a on ``kv_a_norm``, and the rotary-encoded
        shared key k_rope (B, S, dr) of x (B, S, d)."""
        cfg = self.cfg
        kvr = cfg.kv_lora_rank
        kv = x @ at(self, "wkv_a", l)
        c_kv = rms_norm(kv[..., :kvr].contiguous(), at(self, "kv_a_norm", l),
                        cfg.norm_eps)
        k_rope = apply_rope(kv[:, :, None, kvr:], cos, sin)[:, :, 0]
        return c_kv, k_rope

    def prefill(self, l, x, cos, sin):
        """The decompressed path (`mla_apply`): causal attention of q
        ``[q_nope, q_rope]`` (192 dims a head at published widths) over
        k ``[c_kv wk_b, k_rope]`` (the shared rotary key broadcast over
        the heads) and v ``c_kv wv_b`` (128) through K2, scale 1/sqrt(dn
        + dr), then ``wo``. Returns (y (B, S, d), (c_kv, k_rope))."""
        cfg = self.cfg
        B, S, _ = x.shape
        h, kvr = cfg.n_heads, cfg.kv_lora_rank
        dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        q_nope, q_rope = self._query(l, x, cos, sin)
        c_kv, k_rope = self._latent(l, x, cos, sin)
        k_nope = (c_kv @ at(self, "wk_b", l).reshape(kvr, h * dn)
                  ).view(B, S, h, dn)
        v = (c_kv @ at(self, "wv_b", l).reshape(kvr, h * dv)
             ).view(B, S, h, dv)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, h, dr)],
                      dim=-1)
        y = flash_attention(torch.cat([q_nope, q_rope], dim=-1), k, v,
                            causal=True, scale=self.scale)
        y = y.reshape(B, S, h * dv) @ at(self, "wo", l).reshape(h * dv, -1)
        return y, (c_kv, k_rope)

    def decode(self, l, x, cos, sin, c_kv_l, k_rope_l, slot: int,
               length: int):
        """One token (`_decode_mla`, weight absorption): writes the new
        c_kv and k_rope into ``slot`` of the layer's caches (B, T, kvr)
        and (B, T, dr), attends the positions ``<= length`` through
        K3-mla with the absorbed query ``q_nope wk_b``, and decompresses
        the latent result through ``wv_b``, then ``wo``. Returns y (B,
        1, d)."""
        cfg = self.cfg
        B = x.shape[0]
        h, dv = cfg.n_heads, cfg.v_head_dim
        q_nope, q_rope = self._query(l, x, cos, sin)
        q_abs = torch.einsum("bshk,rhk->bshr", q_nope,
                             at(self, "wk_b", l)).contiguous()
        c_new, kr_new = self._latent(l, x, cos, sin)
        c_kv_l[:, slot] = c_new[:, 0]
        k_rope_l[:, slot] = kr_new[:, 0]
        lat = mla_decode_attention(q_abs, q_rope, c_kv_l, k_rope_l, length,
                                   scale=self.scale)
        out = torch.einsum("bshr,rhk->bshk", lat, at(self, "wv_b", l))
        return out.reshape(B, 1, h * dv) @ at(self, "wo", l).reshape(
            h * dv, -1)


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


# ------------------------------------------------------------------ MoE
def router_probs(router, cfg, x):
    """Softmax router over experts in f32, then top-k, renormalized:
    (probs (B, T, E), top_p (B, T, K) f32, top_e (B, T, K) int64). The
    top-k is a stable descending sort, so equal probabilities go to the
    lower expert first, as ``lax.top_k`` breaks ties."""
    logits = x.to(torch.float32) @ router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :cfg.topk], top_e[..., :cfg.topk]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, top_p, top_e


def moe_aux_loss(probs, top_e, n_experts: int):
    """Switch-style load-balancing loss: E * sum_e (share of the choices
    that went to e) * (mean router probability of e)."""
    density = F.one_hot(top_e, n_experts).to(torch.float32).mean((0, 1, 2))
    mean_prob = probs.mean((0, 1))
    return n_experts * (density * mean_prob).sum()


def moe_dispatch_indices(top_e, top_p, n_experts: int, capacity: int):
    """Capacity-based dispatch: (slot, weight), slot (B, T, K) the
    choice's place in its expert's buffer, from a per-row cumsum over the
    T * K choices in token-major order, or ``capacity`` where the buffer
    was full (the choice is dropped, its weight 0)."""
    B, T, K = top_e.shape
    flat_e = top_e.reshape(B, T * K)
    onehot = F.one_hot(flat_e, n_experts).to(torch.int32)
    pos = onehot.cumsum(1) - 1                    # place within its expert
    slot = pos.gather(-1, flat_e[..., None])[..., 0].reshape(B, T, K)
    keep = slot < capacity
    return (torch.where(keep, slot, torch.full_like(slot, capacity)),
            torch.where(keep, top_p, torch.zeros_like(top_p)))


def _expert_ffn(buf, we_gate, we_up, we_down):
    """The E expert FFNs on their buffers (E, N, d) -> (E, N, d): three
    ``torch.bmm`` over the expert axis."""
    h = F.silu(torch.bmm(buf, we_gate)) * torch.bmm(buf, we_up)
    return torch.bmm(h, we_down)


def _shared_expert(moe, l, x):
    """The shared experts as one SwiGLU MLP of width moe_d_ff *
    n_shared_experts (0 when there are none)."""
    if not moe.cfg.n_shared_experts:
        return 0.0
    return (F.silu(x @ at(moe, "ws_gate", l)) * (x @ at(moe, "ws_up", l))) \
        @ at(moe, "ws_down", l)


def moe_apply_capacity(moe, l, x, capacity: int, aux: bool = True):
    """Capacity-dropping MoE: each row's tokens scattered into (B, E,
    capacity + 1, d) buffers (row ``capacity`` the dropped choices',
    discarded), every expert's FFN over its buffer, and the results
    gathered back with the combine weights. Returns (y, aux), aux None
    when not asked for (serving: the JAX package computes it and XLA
    drops it unused). Every expert's buffer is computed, as in the JAX
    package."""
    cfg = moe.cfg
    B, T, d = x.shape
    E = cfg.n_experts
    probs, top_p, top_e = router_probs(at(moe, "router", l), cfg, x)
    slot, w = moe_dispatch_indices(top_e, top_p, E, capacity)
    buf = torch.zeros(B, E, capacity + 1, d, dtype=x.dtype, device=x.device)
    bidx = torch.arange(B, device=x.device)[:, None, None].expand_as(top_e)
    buf.index_put_((bidx, top_e, slot),
                   x[:, :, None, :] * (w[..., None] > 0).to(x.dtype),
                   accumulate=True)
    buf = buf[:, :, :capacity].transpose(0, 1).reshape(E, B * capacity, d)
    y_buf = _expert_ffn(buf, at(moe, "we_gate", l), at(moe, "we_up", l),
                        at(moe, "we_down", l))
    y_buf = y_buf.reshape(E, B, capacity, d).transpose(0, 1)
    y_buf = F.pad(y_buf, (0, 0, 0, 1))            # the drop slot: zeros
    y = torch.einsum("btkd,btk->btd", y_buf[bidx, top_e, slot],
                     w.to(x.dtype))
    return (y + _shared_expert(moe, l, x),
            moe_aux_loss(probs, top_e, E) if aux else None)


def moe_apply_dense(moe, l, x, aux: bool = True):
    """The O(E) oracle: every expert on every token, combined with the
    top-k weights (the JAX package's impl when n_experts <= 8). Returns
    (y, aux), aux as `moe_apply_capacity`'s."""
    cfg = moe.cfg
    B, T, d = x.shape
    E = cfg.n_experts
    probs, top_p, top_e = router_probs(at(moe, "router", l), cfg, x)
    y_e = _expert_ffn(x.reshape(1, B * T, d).expand(E, B * T, d),
                      at(moe, "we_gate", l), at(moe, "we_up", l),
                      at(moe, "we_down", l)).reshape(E, B, T, d)
    combine = (F.one_hot(top_e, E).to(x.dtype)
               * top_p.to(x.dtype)[..., None]).sum(2)      # (B, T, E)
    y = torch.einsum("ebtd,bte->btd", y_e, combine)
    return (y + _shared_expert(moe, l, x),
            moe_aux_loss(probs, top_e, E) if aux else None)


class MoE(nn.Module):
    """The routed and shared experts of ``n_layers`` MoE layers, stacked
    on the layer axis: ``router`` (d, E), ``we_gate`` / ``we_up`` (E, d,
    f), ``we_down`` (E, f, d), and (with shared experts) ``ws_gate`` /
    ``ws_up`` (d, f * n_shared), ``ws_down`` (f * n_shared, d); f is
    ``moe_d_ff``."""

    def __init__(self, cfg, n_layers, device):
        super().__init__()
        self.cfg = cfg
        d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff or cfg.d_ff
        kw = dict(dtype=cfg.pdtype, device=device)
        self.router = stacked(n_layers, d, e, **kw)
        self.we_gate = stacked(n_layers, e, d, f, **kw)
        self.we_up = stacked(n_layers, e, d, f, **kw)
        self.we_down = stacked(n_layers, e, f, d, **kw)
        if cfg.n_shared_experts:
            fs = f * cfg.n_shared_experts
            self.ws_gate = stacked(n_layers, d, fs, **kw)
            self.ws_up = stacked(n_layers, d, fs, **kw)
            self.ws_down = stacked(n_layers, fs, d, **kw)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """The JAX package's init: the router N(0, 0.02^2), every other
        weight N(0, 1 / its first unstacked dim) (E for the expert
        weights, as `repro.models.layers.ParamSet`'s default scale)."""
        init_normal_(self.router, gen, 0.02)
        for name, p in self.named_parameters(recurse=False):
            if name != "router":
                init_normal_(p, gen, 1.0 / math.sqrt(p.shape[1]))

    def forward(self, l, x, impl: str, capacity: int, aux: bool = True):
        """(y, aux) of layer ``l`` on x (B, T, d): ``impl`` "dense" (the
        oracle) or "ep" (`moe_apply_capacity` at ``capacity``); aux None
        unless asked for."""
        if impl == "dense":
            return moe_apply_dense(self, l, x, aux)
        return moe_apply_capacity(self, l, x, capacity, aux)


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
