"""seamless-m4t-large-v2 [audio] — enc-dec multimodal backbone
[arXiv:2308.11596; hf].

24L(enc)+24L(dec) d_model=1024 16H d_ff=8192 vocab=256206. The speech
frontend (w2v-BERT conformer feature extractor) is a STUB: ``input_specs``
provides precomputed frame embeddings for the encoder.
"""
from repro_torch.config import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2",
        family="audio",
        is_encoder_decoder=True,
        num_layers=24,
        num_encoder_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        head_dim=64,
        d_ff=8192,
        vocab_size=256206,
        mlp_kind="gelu",
        norm_kind="layernorm",
        frontend="speech",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="seamless-smoke",
        family="audio",
        is_encoder_decoder=True,
        num_layers=2,
        num_encoder_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=128,
        mlp_kind="gelu",
        norm_kind="layernorm",
        frontend="speech",
    )


register("seamless-m4t-large-v2", full, smoke)
