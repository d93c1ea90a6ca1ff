"""deepseek-moe-16b [moe] — fine-grained MoE, 2 shared + 64 routed top-6
[arXiv:2401.06066; hf].

28L d_model=2048 16H (MHA kv=16) expert d_ff=1408 vocab=102400; first layer
is a dense FFN (d_ff=10944).
"""
from repro_torch.config import ModelConfig, MoEConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b",
        family="moe",
        num_layers=28,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        vocab_size=102400,
        mlp_kind="swiglu",
        norm_kind="rmsnorm",
        moe=MoEConfig(num_experts=64, num_shared=2, top_k=6, expert_ff=1408,
                      first_moe_layer=1, dense_ff=10944),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-smoke",
        family="moe",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=32,
        vocab_size=128,
        moe=MoEConfig(num_experts=8, num_shared=2, top_k=2, expert_ff=32,
                      first_moe_layer=1, dense_ff=128),
    )


register("deepseek-moe-16b", full, smoke)
