"""mamba2-780m [ssm] — SSD state-space duality [arXiv:2405.21060].

48L d_model=1536, attention-free, vocab=50280, ssm_state=128.
"""
from repro_torch.config import ModelConfig, SSMConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m",
        family="ssm",
        num_layers=48,
        d_model=1536,
        num_heads=48,             # d_inner / head_dim = 3072 / 64
        num_kv_heads=48,
        d_ff=0,
        vocab_size=50280,
        attn_kind="none",
        norm_kind="rmsnorm",
        tie_embeddings=True,
        ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4,
                      chunk=256),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke",
        family="ssm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        vocab_size=128,
        attn_kind="none",
        tie_embeddings=True,
        ssm=SSMConfig(state_dim=16, head_dim=32, expand=2, conv_width=4,
                      chunk=16),
    )


register("mamba2-780m", full, smoke)
