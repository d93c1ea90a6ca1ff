"""Encoder-decoder backbone (SeamlessM4T-v2 style): speech-embedding encoder
(bidirectional) + causal text decoder with cross-attention, as the
reference's ``src/repro/models/encdec.py``.

The speech frontend is a stub, as in the reference: ``enc_embeds`` are
precomputed frame embeddings (B, S_enc, D); the encoder is the transformer
stack on top of them. Every decoder layer computes its cross-attention
(k, v) from the encoder states on every call, decode steps included, as
the reference's scan body does.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models.transformer import (Stack, build_params, layer_slice,
                                            logits_of, make_block,
                                            positions_for, run_stack,
                                            stacks_for)


def _enc_stack(cfg: ModelConfig) -> Stack:
    return Stack("enc_layers", cfg.num_encoder_layers, "gqa", "mlp", cfg.d_ff)


def build_encdec_params(make, cfg: ModelConfig):
    p: Dict[str, Any] = {}
    # encoder: its own stack (bidirectional attention)
    enc = _enc_stack(cfg)

    def enc_make(path, shape, names, *a, **kw):
        return make(path, (enc.n,) + tuple(shape), ("layers",) + tuple(names),
                    *a, **kw)

    p["encoder"] = make_block(enc_make, "encoder", cfg, enc)
    p["enc_final_norm"] = L.make_norm(make, "enc_final_norm", cfg.d_model,
                                      cfg.norm_kind)
    # decoder: standard stacks + cross attention
    p.update(build_params(make, cfg, cross_attn=True, with_embed=True))
    return p


def apply_block_bidir(p, x, positions, cfg: ModelConfig):
    """Encoder block: non-causal self-attention + MLP."""
    h = L.apply_norm(p["ln_mix"], x, cfg.norm_kind)
    out, _ = attn.gqa_attention(p["mix"], h, positions, cfg, causal=False)
    x = x + out
    h = L.apply_norm(p["ln_ffn"], x, cfg.norm_kind)
    return x + L.apply_mlp(p["ffn"], h, cfg.mlp_kind)


def encode(params, enc_embeds, cfg: ModelConfig):
    """enc_embeds: (B, S_enc, D) frontend stub output -> (encoder states,
    their (B, S_enc) positions)."""
    b, s, _ = enc_embeds.shape
    positions = positions_for(b, s, None, enc_embeds.device)
    x = enc_embeds.to(L.dtype_of(cfg.dtype))
    for i in range(_enc_stack(cfg).n):
        x = apply_block_bidir(layer_slice(params["encoder"], i), x,
                              positions, cfg)
    return L.apply_norm(params["enc_final_norm"], x, cfg.norm_kind), positions


def encdec_forward(params, tokens, enc_embeds, cfg: ModelConfig, *,
                   caches=None, enc_out=None, start_index=None,
                   features_only=False):
    """Full enc-dec forward.

    tokens: decoder input (B, S_dec). enc_embeds: (B, S_enc, D) stub frames.
    enc_out: optionally the (states, positions) of an earlier ``encode``
    (decode steps reuse it). caches are written in place.
    Returns (logits, new_caches, aux, enc_out).
    """
    if enc_out is None:
        enc_out = encode(params, enc_embeds, cfg)
    enc_states, enc_positions = enc_out

    x = L.embed(params["embed"], tokens, cfg)
    b, s, _ = x.shape
    positions = positions_for(b, s, start_index, x.device)

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches: Dict[str, Any] = {}
    for stack in stacks_for(cfg):
        x, new_c, aux = run_stack(
            params[stack.name], x, positions, cfg, stack, [0] * stack.n,
            caches.get(stack.name) if caches is not None else None,
            lambda lp: attn.encode_cross_kv(lp["cross"], enc_states, cfg),
            enc_positions)
        if new_c is not None:
            new_caches[stack.name] = new_c
        aux_total = aux_total + aux

    x = L.apply_norm(params["final_norm"], x, cfg.norm_kind)
    if features_only:
        return x, new_caches, aux_total, enc_out
    return logits_of(params, x, cfg), new_caches, aux_total, enc_out
