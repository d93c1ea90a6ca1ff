"""deepseek-v2-236b [moe] — MLA (kv_lora=512) + 2 shared + 160 routed top-6
[arXiv:2405.04434; hf].

60L d_model=5120 128H expert d_ff=1536 vocab=102400; first layer dense
(d_ff=12288). The MLA compressed KV cache (512+64 per token, all heads) is
what makes the 32k/500k decode shapes cheap.
"""
from repro_torch.config import MLAConfig, ModelConfig, MoEConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        num_layers=60,
        d_model=5120,
        num_heads=128,
        num_kv_heads=128,
        d_ff=1536,
        vocab_size=102400,
        mlp_kind="swiglu",
        norm_kind="rmsnorm",
        mla=MLAConfig(kv_lora_rank=512, rope_head_dim=64, nope_head_dim=128,
                      v_head_dim=128),
        moe=MoEConfig(num_experts=160, num_shared=2, top_k=6, expert_ff=1536,
                      first_moe_layer=1, dense_ff=12288),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-smoke",
        family="moe",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        vocab_size=128,
        mla=MLAConfig(kv_lora_rank=32, rope_head_dim=8, nope_head_dim=16,
                      v_head_dim=16),
        moe=MoEConfig(num_experts=8, num_shared=2, top_k=2, expert_ff=32,
                      first_moe_layer=1, dense_ff=128),
    )


register("deepseek-v2-236b", full, smoke)
