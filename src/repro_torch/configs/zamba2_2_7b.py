"""Zamba2-2.7B [arXiv:2411.15242; hf]: 54 Mamba2 layers, d=2560
(ssm_state=64), plus a SHARED attention block (32H, d_ff=10240) applied
every 6 layers on concat(hidden, embeddings); vocab=32000. Sliding-window
(long_context_window) attention for the long_500k cell."""
from repro_torch.configs.registry import ARCHS
from repro_torch.models.config import ModelConfig


@ARCHS.register("zamba2-2.7b")
def zamba2_2_7b() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b",
        family="hybrid",
        n_layers=54,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        head_dim=80,
        d_ff=10240,
        vocab_size=32000,
        ssm_state=64,
        ssm_expand=2,
        ssm_headdim=64,
        ssm_conv=4,
        ssm_chunk=256,
        ssm_ngroups=1,
        attn_every=6,
        long_context_window=4096,
    )
