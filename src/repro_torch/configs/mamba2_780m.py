"""Mamba2-780M [arXiv:2405.21060]: 48L, d=1536 (attention-free SSD),
ssm_state=128, expand=2 (d_inner=3072, 48 heads x headdim 64),
vocab=50280."""
from repro_torch.configs.registry import ARCHS
from repro_torch.models.config import ModelConfig


@ARCHS.register("mamba2-780m")
def mamba2_780m() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m",
        family="ssm",
        n_layers=48,
        d_model=1536,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        ssm_state=128,
        ssm_expand=2,
        ssm_headdim=64,
        ssm_conv=4,
        ssm_chunk=256,
        ssm_ngroups=1,
    )
