"""DeepSeek-V3-671B [arXiv:2412.19437; hf]: 61L, d=7168, 128H MLA,
MoE 256 routed (top-8) + 1 shared expert (d_ff 2048 each), first 3 layers
dense (d_ff 18432), vocab=129280, multi-token prediction (depth 1)."""
from repro_torch.configs.registry import ARCHS
from repro_torch.models.config import ModelConfig


@ARCHS.register("deepseek-v3-671b")
def deepseek_v3_671b() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=128,
        n_kv_heads=128,          # MLA: all heads share the latent cache
        d_ff=18432,              # dense layers / shared-expert unit is moe_d_ff
        vocab_size=129280,
        n_experts=256,
        n_shared_experts=1,
        topk=8,
        moe_d_ff=2048,
        first_dense_layers=3,
        mla=True,
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
        head_dim=192,            # qk_nope + qk_rope
        mtp=True,
        rope_theta=1e4,
    )
