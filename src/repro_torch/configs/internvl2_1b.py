"""internvl2-1b [vlm] — InternViT + Qwen2-0.5B backbone [arXiv:2404.16821; hf].

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655. The InternViT vision
frontend is a STUB: ``input_specs`` provides precomputed patch embeddings.
"""
from repro_torch.config import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b",
        family="vlm",
        num_layers=24,
        d_model=896,
        num_heads=14,
        num_kv_heads=2,
        head_dim=64,
        d_ff=4864,
        vocab_size=151655,
        mlp_kind="swiglu",
        norm_kind="rmsnorm",
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        frontend="vision",
        frontend_tokens=256,      # 448x448 / 14px patches, pixel-shuffled
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internvl2-smoke",
        family="vlm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=128,
        tie_embeddings=True,
        frontend="vision",
        frontend_tokens=8,
    )


register("internvl2-1b", full, smoke)
