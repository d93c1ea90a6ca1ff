"""Encoder-decoder backbone (SeamlessM4T-v2 style): speech-embedding encoder
(bidirectional) + causal text decoder with cross-attention, as the
reference's ``src/repro/models/encdec.py``.

The speech frontend is a stub, as in the reference: ``enc_embeds`` are
precomputed frame embeddings (B, S_enc, D); the encoder is the transformer
stack on top of them. Every decoder layer computes its cross-attention
(k, v) from the encoder states on every call, decode steps included, as
the reference's scan body does. Under remat (``cfg.remat`` not ``none``,
training only) each encoder layer runs under ``torch.utils.checkpoint``, and
the decoder's stacks follow ``transformer.remat_policy``: the memory the
reference's policies keep differs, the numbers do not.

Under a step that splits its products over ``model`` (``parallel.fsdp``)
both stacks run as the decoder-only stacks do (``transformer._on_block``):
the encoder's residual in sequence blocks, its non-causal GQA heads and
MLP columns split; the decoder's embedding vocab-parallel. Cross-attention
is a split segment: the rank's q heads, the cross k and v of the kv heads
they read and ``wo``'s rows. Its k and v come from the whole encoder
states, which ``encode`` gathers once a forward (``fsdp.seq_gather``,
whose backward reduce-scatters), so ``encode`` always returns them whole,
as a prefill hands them to its decode steps. Where a sequence does not
split (a decode step's one token), its residual is whole and each split
segment ends in ``fsdp.model_sum``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.parallel import fsdp
from repro_torch.parallel.fsdp import gathered
from repro_torch.models.transformer import (Stack, _mlp_segment, _on_block,
                                            build_params, logits_of,
                                            make_block, positions_for,
                                            remat_policy, run_stack,
                                            stacks_for, unstack)


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
    """Encoder block: non-causal self-attention + MLP, each a segment on
    the residual ``x`` (``transformer._on_block``: split where the step's
    act rules split its heads or columns)."""
    split = fsdp.splits("heads", cfg.num_heads)
    mix = gathered(p["mix"], keep=split)
    out, _ = _on_block(x, gathered(p["ln_mix"]), cfg, lambda h: (
        attn.gqa_attention(mix, h, positions, cfg, causal=False)[0], None),
        split)
    x = x + out
    return x + _mlp_segment(p["ln_ffn"], p["ffn"], x, cfg, cfg.d_ff)


def encode(params, enc_embeds, cfg: ModelConfig):
    """enc_embeds: (B, S_enc, D) frontend stub output -> (encoder states,
    their (B, S_enc) positions), the states whole along the sequence
    (module docstring)."""
    b, s, _ = enc_embeds.shape
    positions = positions_for(b, s, None, enc_embeds.device)
    x = enc_embeds.to(L.dtype_of(cfg.dtype))
    remat = remat_policy(cfg, None, params["encoder"]) != "none"
    with fsdp.residual(s) as seq_split:
        if seq_split:
            x = fsdp.seq_block(x)
        for lp in unstack(params["encoder"], _enc_stack(cfg).n):
            if remat:
                x = checkpoint(apply_block_bidir, lp, x, positions, cfg,
                               use_reentrant=False)
            else:
                x = apply_block_bidir(lp, x, positions, cfg)
        x = L.apply_norm(gathered(params["enc_final_norm"]), x,
                         cfg.norm_kind)
        if seq_split:
            x = fsdp.seq_gather(x)
    return x, positions


def _cross_kv_params(cp, cfg: ModelConfig):
    """A decoder layer's cross-attention parameters that ``encode_cross_kv``
    reads: wk and wv as their ``model`` blocks where the step splits the
    heads and ``model`` divides the kv heads, else whole."""
    kv = {k: cp[k] for k in ("wk", "wv", "k_norm") if k in cp}
    if not (fsdp.splits("heads", cfg.num_heads)
            and fsdp.splits("kv_heads", cfg.num_kv_heads)):
        return gathered(kv)
    return {k: gathered(v, keep=k != "k_norm") for k, v in kv.items()}


def encdec_forward(params, tokens, enc_embeds, cfg: ModelConfig, *,
                   caches=None, enc_out=None, start_index=None,
                   features_only=False):
    """Full enc-dec forward.

    tokens: decoder input (B, S_dec). enc_embeds: (B, S_enc, D) stub frames.
    enc_out: optionally the (states, positions) of an earlier ``encode``
    (decode steps reuse it). caches are written in place.
    Returns (logits, new_caches, aux, enc_out). Under a step that splits
    over ``model``, the features and logits are this rank's sequence
    block, or whole where the decoder's positions do not split, as
    ``transformer.lm_forward``'s are.
    """
    if enc_out is None:
        enc_out = encode(params, enc_embeds, cfg)
    enc_states, enc_positions = enc_out

    split = fsdp.splits("vocab", cfg.padded_vocab)
    x = L.embed(gathered(params["embed"], keep=split), tokens, cfg)
    b, s, _ = x.shape
    positions = positions_for(b, s, start_index, x.device)

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches: Dict[str, Any] = {}
    with fsdp.residual(s) as seq_split:
        if seq_split:
            x = fsdp.seq_scatter(x) if split else fsdp.seq_block(x)
        elif split:
            x = fsdp.model_sum(x)
        for stack in stacks_for(cfg):
            x, new_c, aux = run_stack(
                params[stack.name], x, positions, cfg, stack, [0] * stack.n,
                caches.get(stack.name) if caches is not None else None,
                lambda lp: attn.encode_cross_kv(
                    _cross_kv_params(lp["cross"], cfg), enc_states, cfg),
                enc_positions)
            if new_c is not None:
                new_caches[stack.name] = new_c
            aux_total = aux_total + aux

        x = L.apply_norm(gathered(params["final_norm"]), x, cfg.norm_kind)
        if features_only:
            return x, new_caches, aux_total, enc_out
        return logits_of(params, x, cfg), new_caches, aux_total, enc_out
