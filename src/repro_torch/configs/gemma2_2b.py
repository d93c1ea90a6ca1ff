"""gemma2-2b [dense] — local+global alternating attention, logit softcaps
[arXiv:2408.00118; hf].

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.
``long_500k`` is SKIPPED for this arch: the global layers are full
quadratic attention (see DESIGN.md §Arch-applicability).
"""
from repro_torch.config import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b",
        family="dense",
        num_layers=26,
        d_model=2304,
        num_heads=8,
        num_kv_heads=4,
        head_dim=256,
        d_ff=9216,
        vocab_size=256000,
        attn_kind="local_global",
        window_size=4096,
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        mlp_kind="gelu",
        norm_kind="rmsnorm",
        tie_embeddings=True,
        embedding_scale=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma2-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=128,
        attn_kind="local_global",
        window_size=8,
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        mlp_kind="gelu",
        tie_embeddings=True,
        embedding_scale=True,
    )


register("gemma2-2b", full, smoke)
