"""stablelm-12b [dense] — GQA [hf:stabilityai/stablelm-2-12b].

40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352.
"""
from repro_torch.config import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="stablelm-12b",
        family="dense",
        num_layers=40,
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        head_dim=160,
        d_ff=13824,
        vocab_size=100352,
        mlp_kind="swiglu",
        norm_kind="layernorm",
        qk_norm=True,            # stablelm-2 uses per-head qk layernorm
        rope_theta=10_000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="stablelm-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=128,
        norm_kind="layernorm",
        qk_norm=True,
    )


register("stablelm-12b", full, smoke)
