"""Qwen3-14B [hf:Qwen/Qwen3-14B family]: 40L, d=5120, 40H (GQA kv=8),
d_ff=17408, vocab=151936, qk-norm (per-head RMSNorm on q,k)."""
from repro_torch.configs.registry import ARCHS
from repro_torch.models.config import ModelConfig


@ARCHS.register("qwen3-14b")
def qwen3_14b() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=17408,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1e6,
    )
