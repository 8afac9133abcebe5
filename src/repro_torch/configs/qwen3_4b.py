"""Qwen3-4B [hf:Qwen/Qwen3-4B family]: 36L, d=2560, 32H (GQA kv=8,
head_dim=128 > d_model/H as in Qwen3), d_ff=9728, vocab=151936, qk-norm."""
from repro_torch.configs.registry import ARCHS
from repro_torch.models.config import ModelConfig


@ARCHS.register("qwen3-4b")
def qwen3_4b() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b",
        family="dense",
        n_layers=36,
        d_model=2560,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=9728,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1e6,
    )
