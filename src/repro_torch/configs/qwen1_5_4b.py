"""Qwen1.5-4B [hf:Qwen/Qwen1.5-4B family]: 40L, d=2560, 20H (kv=20, MHA),
d_ff=6912, vocab=151936, bias on QKV projections."""
from repro_torch.configs.registry import ARCHS
from repro_torch.models.config import ModelConfig


@ARCHS.register("qwen1.5-4b")
def qwen1_5_4b() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-4b",
        family="dense",
        n_layers=40,
        d_model=2560,
        n_heads=20,
        n_kv_heads=20,
        head_dim=128,
        d_ff=6912,
        vocab_size=151936,
        qkv_bias=True,
        rope_theta=1e6,
    )
