"""DeepSeekMoE-16B [arXiv:2401.06066; hf]: 28L, d=2048, 16H (MHA kv=16),
fine-grained MoE: 64 routed experts (top-6) + 2 shared, expert d_ff=1408,
first layer dense (d_ff 10944), vocab=102400."""
from repro_torch.configs.registry import ARCHS
from repro_torch.models.config import ModelConfig


@ARCHS.register("deepseek-moe-16b")
def deepseek_moe_16b() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b",
        family="moe",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=10944,
        vocab_size=102400,
        n_experts=64,
        n_shared_experts=2,
        topk=6,
        moe_d_ff=1408,
        first_dense_layers=1,
        rope_theta=1e4,
    )
