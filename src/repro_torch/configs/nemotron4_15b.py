"""nemotron-4-15b [dense] — GQA, squared-ReLU MLP [arXiv:2402.16819].

32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000.
"""
from repro_torch.config import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b",
        family="dense",
        num_layers=32,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        vocab_size=256000,
        mlp_kind="squared_relu",
        norm_kind="layernorm",
        rope_theta=10_000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="nemotron-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=128,
        mlp_kind="squared_relu",
        norm_kind="layernorm",
    )


register("nemotron-4-15b", full, smoke)
