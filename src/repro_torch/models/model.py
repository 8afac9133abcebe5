"""Model assembly of the port: the dense, MoE (with or without MLA), ssm
and hybrid families (counterpart of `repro.models.model`).

`Model` is an ``nn.Module`` whose module tree mirrors the JAX parameter
tree (``embed``, ``unembed``, ``final_norm``; dense: ``blocks.norm1``,
``blocks.attn.wq``, ...; moe: ``dense_blocks.*`` (the first
``first_dense_layers`` layers, MLP width ``d_ff``) and ``moe_blocks.*``
(norm1, norm2, attn, ``moe.router``, ``moe.we_gate``, ...), and with
MTP ``mtp.mtp_proj`` and ``mtp.mtp_block.*``; ssm and hybrid:
``blocks.norm1``,
``blocks.mamba.w_xz``, ...; hybrid also ``shared_attn.shared_in``,
``shared_attn.attn.wq``, ...; block leaves stacked on a leading layer
axis, the shared block's not). ``build_model(cfg, device)`` allocates it
on the device without filling it; ``init_weights(generator)`` fills it
in place, and `convert.from_jax_params` loads the JAX package's weights
instead.

The serving methods follow `repro.models.model.Model.prefill` and
``decode_step``, with the hand-written kernels at the places where the
JAX package computes what a TPU kernel computes:

* prefill attention: K2 (`kernels.flash_attention`), one launch a layer
  (dense, moe) or a shared-block application (hybrid, head_dim 80, with
  the sliding window of the cache's length);
* decode attention over the cache: K3 (`kernels.decode_attention`), one
  launch a layer (or application) a token; the dense and moe families
  write slot ``min(length, T - 1)``, the hybrid its ring slot ``length
  % T``, and all attend the positions ``<= min(length, T - 1)`` (all
  of them once the ring is full, as the JAX ring mask), scale
  ``1/sqrt(hd)``;
* the SSD intra-chunk block of each Mamba2 layer's prefill: K5
  (`kernels.ssd_chunk`), one launch a layer (`models.mamba`); decode is
  the plain per-token recurrence;
* the first norm1, the qk-norm, the Mamba2 gate norm and the shared
  block's first norm: K4a (`kernels.rmsnorm.rmsnorm`);
* every residual add with the norm after it -- each norm2, each later
  norm1 and the final norm -- K4b (`kernels.rmsnorm.rmsnorm_residual`).

The hybrid family (Zamba2) runs, after every ``attn_every`` Mamba2
layers, one shared attention block on ``concat(h, h0) @ shared_in``
(``h0`` the token embeddings): K4a, attention, K4b, the MLP, and the
block's output is added to ``h``; each of its ``L / attn_every``
applications has its own k/v cache layer. The JAX order of adds is
kept (``z = z + mlp``, then ``h = h + z``), so the residual stream is
the JAX one.

A hybrid prompt longer than the cache (S > W, W the cache's length)
runs the shared block's K2 with ``window=W``, the JAX package's
``window = cache["k"].shape[2]``: query i sees keys i - W..i, W + 1 of
them (the JAX mask ``(aq - ak) <= window``), and the prefill keeps the
last W keys in slots 0..W-1. Decode then writes the ring slot
``length % W`` and attends all W slots. So the first decode step
overwrites slot ``S % W``, which is the oldest key only when ``S % W ==
0``: the port reproduces this caveat of the reference on purpose (the
parity bar holds the port to the JAX package's results), and
`tests/test_torch_window.py` pins it, the caches equal to the JAX
package's after the prefill and each step, at S % W != 0 and == 0. At S
<= W the window is passed too and changes nothing.

The MoE family (DeepSeek-MoE; DeepSeek-V3 with MLA) runs
``first_dense_layers`` dense layers and then the MoE layers, each
norm1, attention (K2 / K3), norm2 and `layers.MoE`: the router, the
capacity dispatch and the experts' products as ``torch.bmm`` (plain
ops, as the JAX package's einsums).
The impl is the JAX package's ``_moe_impl``: the O(E) ``dense`` oracle
when n_experts <= 8, else ``ep`` (`layers.moe_apply_capacity`; the port
has no mesh, so never ``ep_shardmap``), at the capacity of S tokens a row
in the prefill and of one in a decode step (`moe_capacity`).

With ``cfg.mla`` (DeepSeek-V3) every layer's attention is `layers.MLA`:
the prefill's K2 at head dims (192, 128), writing the latent ``c_kv``
and the shared rotary key ``k_rope`` of the last ``min(S, T)``
positions into cache slots ``0..``; a decode step writes slot
``min(length, T - 1)`` and runs K3-mla over the positions ``<=
length``; the rotary tables are built at ``qk_rope_dim``. With
``cfg.mtp`` the model holds
the multi-token-prediction module ``mtp`` (``mtp_proj`` and one dense
block with MLA at ``d_ff``), initialised as the JAX package's; only the
JAX ``Model.loss`` reads it, and serving never does.

Training: `Model.loss` is the JAX ``Model.loss`` with the dense, ssm
and hybrid branches of its ``_trunk`` (the MoE family's raises, MTP's
loss with it: ROADMAP Queue 1, item 6.3 (MoE training)): the embedding,
each layer under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)`` (the JAX
package's per-layer ``jax.checkpoint``), the final K4b, the head and
`layers.cross_entropy`. A dense layer is norm1, attention, norm2 and
the MLP; an ssm or hybrid layer norm1 and the Mamba2 mixer. The hybrid
family runs the shared block after each whole group of ``attn_every``
layers, not checkpointed, as the JAX package's ``group_body``, and the
``n_layers % attn_every`` layers of the tail after the last group with
no shared block (only serving needs whole groups). K2, K4a, K4b and K5
run through their autograd Functions, so a step launches each forward
twice for a checkpointed layer (the forward and the recomputation) and
once outside one, and each backward once. The stacked parameters are
unbound once a forward (`Model.layer_tensors`). Build a trainable model
with ``build_model(cfg, device, trainable=True)``.

Numbers: in f32 this is the JAX model's arithmetic up to the order of
sums. In bf16 three places round differently: the norms multiply by the
weight in f32 before their one cast (the JAX model casts first); a
fused norm reads the f32 sum of the residual add, not its bf16 rounding
(the residual stream itself is bitwise the JAX ``h + y``); and K3 keeps
the softmax weights in f32 where the JAX model casts them to bf16
before the value product.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.rmsnorm import rmsnorm_residual
from repro_torch.models import layers as L
from repro_torch.models.cache import NOT_PORTED, CacheSpec, cache_spec
from repro_torch.models.config import ModelConfig
from repro_torch.models.mamba import Mamba
from repro_torch.utils.device import resolve_device

FAMILIES = ("dense", "moe", "ssm", "hybrid")


def moe_capacity(cfg: ModelConfig, tokens_per_row: int) -> int:
    """Expert capacity a (batch row, expert): the dispatch slots are a
    per-row cumsum, so it scales with the row's tokens (the JAX package's
    ``_moe_capacity``)."""
    cap = int(cfg.capacity_factor * tokens_per_row * cfg.topk
              / max(cfg.n_experts, 1))
    return max(cap, 1)


def moe_impl(cfg: ModelConfig) -> str:
    """``cfg.moe_impl`` unless "auto": then "dense" (the oracle) for
    n_experts <= 8, else "ep" (the JAX package's ``_moe_impl`` without a
    mesh)."""
    if cfg.moe_impl != "auto":
        return cfg.moe_impl
    return "dense" if cfg.n_experts <= 8 else "ep"


def attention_of(cfg: ModelConfig):
    """The attention module of cfg's blocks: `layers.MLA` with
    ``cfg.mla``, else `layers.Attention`."""
    return L.MLA if cfg.mla else L.Attention


class DenseBlocks(nn.Module):
    """The stacked dense blocks: norm1, attention, norm2, MLP; ``n``
    layers (default: all of cfg's; the moe family's first dense layers,
    whose MLP width is ``cfg.d_ff`` as every dense block's); one block,
    not stacked, with ``stacked=False`` (MTP's ``mtp_block``)."""

    def __init__(self, cfg: ModelConfig, device, n=None, stacked=True):
        super().__init__()
        n, d = (n or cfg.n_layers) if stacked else None, cfg.d_model
        self.norm1 = L.stacked(n, d, dtype=cfg.pdtype, device=device)
        self.norm2 = L.stacked(n, d, dtype=cfg.pdtype, device=device)
        self.attn = attention_of(cfg)(cfg, n, device)
        self.mlp = L.MLP(cfg, n, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.norm1.fill_(1.0)
        self.norm2.fill_(1.0)
        self.attn.reset_parameters(gen)
        self.mlp.reset_parameters(gen)


class MoEBlocks(nn.Module):
    """The stacked MoE blocks: norm1, attention, norm2, MoE."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        n, d = cfg.n_layers - cfg.first_dense_layers, cfg.d_model
        self.norm1 = L.stacked(n, d, dtype=cfg.pdtype, device=device)
        self.norm2 = L.stacked(n, d, dtype=cfg.pdtype, device=device)
        self.attn = attention_of(cfg)(cfg, n, device)
        self.moe = L.MoE(cfg, n, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.norm1.fill_(1.0)
        self.norm2.fill_(1.0)
        self.attn.reset_parameters(gen)
        self.moe.reset_parameters(gen)


class MambaBlocks(nn.Module):
    """The stacked Mamba2 blocks of the ssm and hybrid families: norm1,
    then the mixer."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.norm1 = L.stacked(cfg.n_layers, cfg.d_model, dtype=cfg.pdtype,
                               device=device)
        self.mamba = Mamba(cfg, cfg.n_layers, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.norm1.fill_(1.0)
        self.mamba.reset_parameters(gen)


class SharedAttention(nn.Module):
    """The hybrid family's one shared attention block (not stacked):
    ``shared_in`` (2d, d), norm1, attention, norm2, MLP."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d = cfg.d_model
        kw = dict(dtype=cfg.pdtype, device=device)
        self.shared_in = L.stacked(None, 2 * d, d, **kw)
        self.norm1 = L.stacked(None, d, **kw)
        self.norm2 = L.stacked(None, d, **kw)
        self.attn = L.Attention(cfg, None, device)
        self.mlp = L.MLP(cfg, None, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        L.init_normal_(self.shared_in, gen, 1.0 / math.sqrt(
            self.shared_in.shape[0]))
        self.norm1.fill_(1.0)
        self.norm2.fill_(1.0)
        self.attn.reset_parameters(gen)
        self.mlp.reset_parameters(gen)


class MTP(nn.Module):
    """DeepSeek-V3's multi-token-prediction module (depth 1):
    ``mtp_proj`` (2d, d) and ``mtp_block``, one dense block (not
    stacked) with MLA at ``d_ff``. Only the JAX package's ``Model.loss``
    reads it (``_mtp_loss``); serving never calls it, and the port's
    training of the moe family, which would, is not ported."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d = cfg.d_model
        self.mtp_proj = L.stacked(None, 2 * d, d, dtype=cfg.pdtype,
                                  device=device)
        self.mtp_block = DenseBlocks(cfg, device, stacked=False)

    def reset_parameters(self, gen: torch.Generator) -> None:
        L.init_normal_(self.mtp_proj, gen, 1.0 / math.sqrt(
            self.mtp_proj.shape[0]))
        self.mtp_block.reset_parameters(gen)


class Model(nn.Module):
    """A decoder-only LM of the dense, moe, ssm or hybrid family on one
    device."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported ("
                f"{NOT_PORTED.get(cfg.family, 'ROADMAP Queue 1, item 6')})")
        if (cfg.mla or cfg.mtp) and cfg.family != "moe":
            raise NotImplementedError(
                f"MLA and MTP in family {cfg.family!r}: the port serves "
                "them in the moe family (DeepSeek-V3), the only family of "
                "a config of the JAX package that has them")
        if cfg.family == "hybrid" and cfg.attn_every < 1:
            raise ValueError(f"hybrid attn_every {cfg.attn_every} < 1")
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
        if cfg.family == "dense":
            self.blocks = DenseBlocks(cfg, self.device)
        elif cfg.family == "moe":
            if cfg.first_dense_layers:
                self.dense_blocks = DenseBlocks(cfg, self.device,
                                                cfg.first_dense_layers)
            self.moe_blocks = MoEBlocks(cfg, self.device)
            if cfg.mtp:
                self.mtp = MTP(cfg, self.device)
        else:
            self.blocks = MambaBlocks(cfg, self.device)
        if cfg.family == "hybrid":
            self.shared_attn = SharedAttention(cfg, self.device)

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
        for blk in self._stacks():
            blk.reset_parameters(gen)
        if hasattr(self, "mtp"):
            self.mtp.reset_parameters(gen)
        if cfg.family == "hybrid":
            self.shared_attn.reset_parameters(gen)
        return self

    def cache_spec(self, batch: int, max_len: int,
                   window=None) -> CacheSpec:
        return cache_spec(self.cfg, batch, max_len, window)

    def _stacks(self):
        """The stacked block modules in layer order."""
        if self.cfg.family == "moe":
            return [m for m in (getattr(self, "dense_blocks", None),
                                self.moe_blocks) if m is not None]
        return [self.blocks]

    def _attn_layers(self):
        """The dense and moe families' layers in order: (stacked blocks,
        index in them)."""
        return [(blk, li) for blk in self._stacks()
                for li in range(blk.norm1.shape[0])]

    # --------------------------------------------------------- training
    def layer_tensors(self):
        """Each layer's tensors as a dict (leaf name -> tensor), the
        stacked block parameters unbound once: the backward of ``unbind``
        is one ``stack``, where each layer's ``p[l]`` would allocate a
        zero tensor the size of the whole stacked parameter in the
        backward."""
        leaves = {}
        # dense: norm1, norm2 and the attention's and MLP's leaves; ssm and
        # hybrid: norm1 and the Mamba2 mixer's (the names do not collide)
        for mod in self.blocks.modules():
            for name, p in mod.named_parameters(recurse=False):
                leaves[name] = p.unbind(0)
        return [{name: t[li] for name, t in leaves.items()}
                for li in range(self.cfg.n_layers)]

    def _train_layer(self, p, y, h, cos, sin):
        """One dense layer of the training trunk: the residual add of the
        previous layer's MLP output ``y`` and its norm1 (K4b; the first
        layer's norm1 K4a on the embeddings, ``y`` None), attention, K4b,
        the MLP. Returns (the MLP's output, the residual stream)."""
        cfg, blk = self.cfg, self.blocks
        if y is None:
            x = L.rms_norm(h, p["norm1"], cfg.norm_eps)
        else:
            x, h = rmsnorm_residual(y, h, p["norm1"], eps=cfg.norm_eps)
        y, _ = blk.attn(p, x, cos, sin)
        x, h = rmsnorm_residual(y, h, p["norm2"], eps=cfg.norm_eps)
        return blk.mlp(p, x), h

    def _train_mamba(self, p, y, h):
        """One Mamba2 layer of the training trunk: the residual add of
        the previous mixer's (or shared block's) output ``y`` and norm1
        (K4b; the first layer's K4a on the embeddings, ``y`` None), then
        the mixer. Returns (the mixer's output, the residual stream)."""
        if y is None:
            x = L.rms_norm(h, p["norm1"], self.cfg.norm_eps)
        else:
            x, h = rmsnorm_residual(y, h, p["norm1"], eps=self.cfg.norm_eps)
        return self.blocks.mamba(p, x)[0], h

    def loss(self, batch):
        """The training loss of ``batch`` (``tokens`` and ``labels`` (B,
        S) int on the model's device): (loss, {"ce", "aux"}), loss = ce
        (+ router_aux_coef * aux, 0 for these families), differentiable
        through every trainable parameter."""
        cfg = self.cfg
        if cfg.family == "moe":
            raise NotImplementedError(
                "training the moe family, and MTP's loss with it, is not "
                "ported (ROADMAP Queue 1, item 6.3 (MoE training))")
        tokens, labels = batch["tokens"], batch["labels"]
        h = L.embed_tokens(self.embed, cfg, tokens)
        S = tokens.shape[1]
        if cfg.family != "ssm":
            cos, sin = self._rope(torch.arange(S, device=h.device))
        y = None
        if cfg.family == "dense":
            for p in self.layer_tensors():
                y, h = checkpoint(self._train_layer, p, y, h, cos, sin,
                                  use_reentrant=False)
        else:
            h0 = h

            def attend(x):
                return self.shared_attn.attn(None, x, cos, sin)[0]
            for li, p in enumerate(self.layer_tensors()):
                y, h = checkpoint(self._train_mamba, p, y, h,
                                  use_reentrant=False)
                if self._shared_after(li):
                    # the shared block after a whole group, not
                    # checkpointed (the JAX package's group_body)
                    h = h + y
                    y = self._shared_block(h, h0, attend)
        x, _ = rmsnorm_residual(y, h, self.final_norm, eps=cfg.norm_eps)
        logits = L.logits_from_hidden(self._head(), cfg, x)
        ce = L.cross_entropy(logits, labels, cfg.vocab_size)
        aux = torch.zeros((), dtype=torch.float32, device=ce.device)
        return ce + cfg.router_aux_coef * aux, {"ce": ce, "aux": aux}

    # --------------------------------------------------------- helpers
    def _head(self):
        return self.embed.T if self.cfg.tie_embeddings else self.unembed

    def _rope(self, positions):
        cfg = self.cfg
        dim = cfg.qk_rope_dim if cfg.mla else cfg.head_dim_
        return L.rope_angles(positions, dim, cfg.rope_theta)

    def _logits(self, y, h):
        """Final norm of the last residual add (K4b), then the head."""
        x, _ = rmsnorm_residual(y.contiguous(), h.contiguous(),
                                self.final_norm, eps=self.cfg.norm_eps)
        return L.logits_from_hidden(self._head(), self.cfg, x)

    def _shared_after(self, li: int) -> bool:
        """Whether the shared attention block runs after layer ``li``."""
        k = self.cfg.attn_every
        return self.cfg.family == "hybrid" and (li + 1) % k == 0

    # ---------------------------------------------------------- serving
    @torch.no_grad()
    def prefill(self, batch, cache):
        """Full-sequence forward that fills the cache. ``batch`` is
        ``{"tokens": (B, S) int}``. Sets ``length`` to S and returns
        (last-position logits (B, 1, V), cache). Dense and moe: writes
        the last ``min(S, T)`` positions' k and v into cache slots
        ``0..``. ssm and hybrid: writes each layer's conv and SSM state,
        and (hybrid) the shared block's last ``min(S, W)`` keys and
        values into slots ``0..``, W the cache's length."""
        if self.cfg.family in ("dense", "moe"):
            return self._prefill_attn(batch, cache)
        self._check_groups()
        return self._prefill_ssm(batch, cache)

    @torch.no_grad()
    def decode_step(self, tokens, cache):
        """One-token decode against the cache. tokens (B, 1). Returns
        (logits (B, 1, V), cache) with ``length`` one further."""
        if self.cfg.family in ("dense", "moe"):
            return self._decode_attn(tokens, cache)
        self._check_groups()
        return self._decode_ssm(tokens, cache)

    def _check_groups(self) -> None:
        """Hybrid serving needs whole groups (the JAX package asserts it
        in its hybrid prefill): each shared-block application has its own
        cache layer. Training takes a tail of n_layers % attn_every."""
        cfg = self.cfg
        if cfg.family == "hybrid" and cfg.n_layers % cfg.attn_every:
            raise ValueError(f"hybrid serving needs n_layers "
                             f"({cfg.n_layers}) a multiple of attn_every "
                             f"({cfg.attn_every})")

    def _ffn(self, blk, li, x, impl, capacity):
        """The layer's MLP (a dense block) or MoE (a moe block)."""
        if isinstance(blk, MoEBlocks):
            return blk.moe(li, x, impl, capacity, aux=False)[0]
        return blk.mlp(li, x)

    def _run_attn_layers(self, h, attend, capacity):
        """The dense and moe families' trunk on the embeddings ``h``:
        each layer's norm1 (K4a on the first, then K4b fused with the
        previous layer's residual add), ``attend(blk, li, gi, x)`` (gi
        the layer's cache index), K4b and the MLP or MoE. Returns the
        last layer's output and the residual stream, for `_logits`."""
        cfg = self.cfg
        impl = moe_impl(cfg)
        layers = self._attn_layers()
        x = L.rms_norm(h, layers[0][0].norm1[layers[0][1]], cfg.norm_eps)
        for gi, (blk, li) in enumerate(layers):
            y = attend(blk, li, gi, x)
            x, h = rmsnorm_residual(y, h, blk.norm2[li], eps=cfg.norm_eps)
            y = self._ffn(blk, li, x, impl, capacity)
            if gi + 1 < len(layers):
                nb, nl = layers[gi + 1]
                x, h = rmsnorm_residual(y, h, nb.norm1[nl],
                                        eps=cfg.norm_eps)
        return y, h

    def _prefill_attn(self, batch, cache):
        cfg = self.cfg
        tokens = batch["tokens"]
        S = tokens.shape[1]
        h = L.embed_tokens(self.embed, cfg, tokens)
        cos, sin = self._rope(torch.arange(S, device=h.device))
        names = ("c_kv", "k_rope") if cfg.mla else ("k", "v")
        n = min(S, cache[names[0]].shape[2])

        def attend(blk, li, gi, x):
            if cfg.mla:
                y, kv = blk.attn.prefill(li, x, cos, sin)
            else:
                y, kv = blk.attn(li, x, cos, sin)
            for name, t in zip(names, kv):
                cache[name][gi, :, :n] = t[:, S - n:]
            return y

        y, h = self._run_attn_layers(h, attend, moe_capacity(cfg, S))
        cache["length"] = S
        return self._logits(y[:, -1:], h[:, -1:]), cache

    def _decode_attn(self, tokens, cache):
        cfg = self.cfg
        length = cache["length"]
        T = cache["c_kv" if cfg.mla else "k"].shape[2]
        slot = min(length, T - 1)
        h = L.embed_tokens(self.embed, cfg, tokens)
        # the position as a device arange: no host-to-device copy
        cos, sin = self._rope(torch.arange(length, length + 1,
                                           device=h.device))

        def attend(blk, li, gi, x):
            if cfg.mla:
                return blk.attn.decode(li, x, cos, sin, cache["c_kv"][gi],
                                       cache["k_rope"][gi], slot, length)
            q, k, v = blk.attn.qkv(li, x, cos, sin)
            k_l, v_l = cache["k"][gi], cache["v"][gi]
            k_l[:, slot] = k[:, 0]
            v_l[:, slot] = v[:, 0]
            return blk.attn.out(li, decode_attention(q, k_l, v_l, length))

        y, h = self._run_attn_layers(h, attend, moe_capacity(cfg, 1))
        cache["length"] = length + 1
        return self._logits(y, h), cache

    def _shared_block(self, h, h0, attend):
        """The hybrid family's shared block on the residual stream ``h``
        (the last Mamba2 layer's output already added) and the
        embeddings ``h0``: ``attend(x)`` is the attention of the normed
        input. Returns z, the block's output, to be added to ``h``."""
        cfg, sh = self.cfg, self.shared_attn
        z = torch.cat([h, h0], dim=-1) @ sh.shared_in
        x = L.rms_norm(z, sh.norm1, cfg.norm_eps)
        x, z = rmsnorm_residual(attend(x), z, sh.norm2, eps=cfg.norm_eps)
        return z + sh.mlp(None, x)

    def _prefill_ssm(self, batch, cache):
        cfg, blk = self.cfg, self.blocks
        tokens = batch["tokens"]
        S = tokens.shape[1]
        h = L.embed_tokens(self.embed, cfg, tokens)
        if cfg.family == "hybrid":
            # the window of the JAX package: the cache's length W; the
            # last n = min(S, W) keys go to slots 0..n-1
            W = cache["k"].shape[2]
            n = min(S, W)
            cos, sin = self._rope(torch.arange(S, device=h.device))
        h0 = h

        def attend(ai):
            def run(x):
                y, (k, v) = self.shared_attn.attn(None, x, cos, sin,
                                                  window=W)
                cache["k"][ai, :, :n] = k[:, S - n:]
                cache["v"][ai, :, :n] = v[:, S - n:]
                return y
            return run

        x = L.rms_norm(h, blk.norm1[0], cfg.norm_eps)
        for li in range(cfg.n_layers):
            y, (conv, ssm) = blk.mamba(li, x)
            cache["conv"][li] = conv
            cache["ssm"][li] = ssm
            if self._shared_after(li):
                h = h + y
                y = self._shared_block(h, h0,
                                       attend(li // cfg.attn_every))
            if li + 1 < cfg.n_layers:
                x, h = rmsnorm_residual(y, h, blk.norm1[li + 1],
                                        eps=cfg.norm_eps)
        cache["length"] = S
        return self._logits(y[:, -1:], h[:, -1:]), cache

    def _decode_ssm(self, tokens, cache):
        cfg, blk = self.cfg, self.blocks
        length = cache["length"]
        h = L.embed_tokens(self.embed, cfg, tokens)
        if cfg.family == "hybrid":
            T = cache["k"].shape[2]
            cos, sin = self._rope(torch.arange(length, length + 1,
                                               device=h.device))
        h0 = h

        def attend(ai):
            def run(x):
                attn = self.shared_attn.attn
                q, k, v = attn.qkv(None, x, cos, sin)
                k_l, v_l = cache["k"][ai], cache["v"][ai]
                # the ring of the JAX package: slot length % T, every
                # position valid once it is full
                k_l[:, length % T] = k[:, 0]
                v_l[:, length % T] = v[:, 0]
                return attn.out(None, decode_attention(
                    q, k_l, v_l, min(length, T - 1)))
            return run

        x = L.rms_norm(h, blk.norm1[0], cfg.norm_eps)
        for li in range(cfg.n_layers):
            y, (conv, ssm) = blk.mamba.decode(li, x, cache["conv"][li],
                                              cache["ssm"][li])
            cache["conv"][li] = conv
            cache["ssm"][li] = ssm
            if self._shared_after(li):
                h = h + y
                y = self._shared_block(h, h0,
                                       attend(li // cfg.attn_every))
            if li + 1 < cfg.n_layers:
                x, h = rmsnorm_residual(y, h, blk.norm1[li + 1],
                                        eps=cfg.norm_eps)
        cache["length"] = length + 1
        return self._logits(y, h), cache


def build_model(cfg: ModelConfig, device=None,
                trainable: bool = False) -> Model:
    """Allocate ``cfg``'s model on ``device`` (CUDA unless "cpu" is
    asked for), its parameters not yet filled: call ``init_weights`` or
    load a state dict. With ``trainable`` every parameter requires a
    gradient (`Model.loss`)."""
    return Model(cfg, resolve_device(device)).requires_grad_(trainable)
