"""Unified model configuration (counterpart of `repro.models.config`).

The same frozen dataclass, fields and `smoke()` as the JAX package, so
one config describes a model in both packages; `pdtype`/`cdtype` give
`torch.dtype`s. The port's model runs the ``dense``, ``ssm`` and
``hybrid`` families (`repro_torch.models.model`); the other families'
fields are kept so that every config of the JAX package can be
expressed. ``use_pallas``
is an inert field here as it is in the JAX package: on CUDA tensors the
hand-written kernels always run. Architecture instances live in
``repro_torch/configs/<id>.py``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"       # dense | moe | ssm | hybrid | encdec | vlm

    # ---- transformer trunk ----
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0           # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 1000
    qk_norm: bool = False       # qwen3-style per-head RMSNorm on q,k
    qkv_bias: bool = False      # qwen1.5-style bias on qkv projections
    tie_embeddings: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    window: Optional[int] = None          # sliding-window attention size
    long_context_window: int = 4096       # window used for long_* shapes

    # ---- MoE ----
    n_experts: int = 0
    n_shared_experts: int = 0
    topk: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001
    moe_impl: str = "auto"      # auto | dense | ep  (dense = tiny oracle)

    # ---- MLA (deepseek) ----
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # ---- MTP (deepseek-v3 multi-token prediction) ----
    mtp: bool = False
    mtp_coef: float = 0.3

    # ---- SSM / Mamba2 ----
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    ssm_ngroups: int = 1

    # ---- hybrid (zamba2) ----
    attn_every: int = 0         # shared attention block every k ssm layers

    # ---- encoder-decoder (whisper) ----
    enc_layers: int = 0
    dec_layers: int = 0
    n_enc_positions: int = 1500
    enc_d_model: int = 0        # 0 -> d_model

    # ---- VLM (internvl) ----
    n_patches: int = 0          # prefix patch embeddings (frontend stub)

    # ---- numerics / layout ----
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    vocab_pad_multiple: int = 16
    attn_chunk: int = 1024      # kv-chunk for online-softmax attention
    use_pallas: bool = False    # inert, as in the JAX package

    # ------------------------------------------------------------- derived
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def is_encdec(self) -> bool:
        return self.family == "encdec"

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (SSM / hybrid-with-window)."""
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------- reduced smoke config
    def smoke(self) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        kw = dict(
            n_layers=min(self.n_layers, 4),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) or 2,
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            param_dtype="float32",
            compute_dtype="float32",
            attn_chunk=64,
        )
        if self.n_experts:
            kw.update(n_experts=8,
                      n_shared_experts=min(self.n_shared_experts, 1),
                      topk=min(self.topk, 2), moe_d_ff=64,
                      first_dense_layers=min(self.first_dense_layers, 1))
        if self.mla:
            kw.update(q_lora_rank=64, kv_lora_rank=32, qk_nope_dim=16,
                      qk_rope_dim=16, v_head_dim=32)
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_headdim=16, ssm_chunk=32,
                      d_model=128)
        if self.attn_every:
            kw.update(attn_every=2, n_layers=4)
        if self.is_encdec:
            kw.update(enc_layers=2, dec_layers=2, n_enc_positions=64)
        if self.n_patches:
            kw.update(n_patches=8)
        return self.replace(**kw)
