"""recurrentgemma-2b [hybrid] — RG-LRU + local attention 1:2 (Griffin)
[arXiv:2402.19427; hf].

26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000, window 2048.
26 layers = 8 full (rec, rec, attn) groups + a (rec, rec) tail.
Bounded state -> ``long_500k`` runs.
"""
from repro_torch.config import ModelConfig, RGLRUConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        num_layers=26,
        d_model=2560,
        num_heads=10,
        num_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab_size=256000,
        attn_kind="local",
        window_size=2048,
        mlp_kind="gelu",
        norm_kind="rmsnorm",
        tie_embeddings=True,
        embedding_scale=True,
        rglru=RGLRUConfig(lru_width=2560, conv_width=4,
                          block_pattern=("recurrent", "recurrent", "attention")),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-smoke",
        family="hybrid",
        num_layers=5,  # 1 full group + (rec, rec) tail
        d_model=64,
        num_heads=4,
        num_kv_heads=1,
        head_dim=16,
        d_ff=128,
        vocab_size=128,
        attn_kind="local",
        window_size=8,
        mlp_kind="gelu",
        tie_embeddings=True,
        rglru=RGLRUConfig(lru_width=64, conv_width=4,
                          block_pattern=("recurrent", "recurrent", "attention")),
    )


register("recurrentgemma-2b", full, smoke)
