"""Decoder-only LM assembly: stacks of structurally identical layers.

An architecture is a sequence of *stacks*; each stack is N identical layers
whose parameters carry a leading (N, ...) layer dim, as the reference's do,
so the two parameter trees map key for key. ``run_stacks`` runs the layers
one by one (the reference's ``lax.scan``). Per-layer *value* variation
inside a stack (gemma-2's local/global alternation) comes from
``window_schedule``.

The port runs the ``dense`` and ``vlm`` families (GQA attention and a dense
MLP). The ``moe`` (with MLA), ``ssm``, ``hybrid`` and ``audio`` (enc-dec)
families raise ``NotImplementedError``: they are ROADMAP item 17(b).
The encoder-decoder's cross-attention plumbing comes with 17(b), remat
with the training slice (17(c)), the MoE auxiliary loss with the moe
family (``aux`` is 0 here).
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L

#: the families this slice builds
PORTED_FAMILIES = ("dense", "vlm")


def unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: the moe (MLA), ssm, hybrid and audio "
        f"(enc-dec) families are ROADMAP item 17(b); the port runs "
        f"{', '.join(PORTED_FAMILIES)}")


# ---------------------------------------------------------------------------
# Stack descriptors
# ---------------------------------------------------------------------------

class Stack(NamedTuple):
    name: str
    n: int              # number of layers
    mixer: str          # gqa
    ffn: str            # mlp
    d_ff: int           # ffn hidden size


def stacks_for(cfg: ModelConfig) -> List[Stack]:
    if cfg.family not in PORTED_FAMILIES or cfg.is_encoder_decoder:
        raise unported(f"family {cfg.family!r} ({cfg.name})")
    return [Stack("layers", cfg.num_layers, "gqa", "mlp", cfg.d_ff)]


# ---------------------------------------------------------------------------
# Single block (one layer) param build + apply
# ---------------------------------------------------------------------------

def make_block(make, path: str, cfg: ModelConfig, stack: Stack):
    d = cfg.d_model
    return {
        "ln_mix": L.make_norm(make, f"{path}.ln_mix", d, cfg.norm_kind),
        "mix": attn.make_gqa(make, f"{path}.mix", cfg),
        "ln_ffn": L.make_norm(make, f"{path}.ln_ffn", d, cfg.norm_kind),
        "ffn": L.make_mlp(make, f"{path}.ffn", d, stack.d_ff, cfg.mlp_kind)}


def apply_block(p, x, positions, cfg: ModelConfig, window: int, cache):
    """Apply one layer. window: 0 = global. Returns (x, new_cache)."""
    new_cache: Dict[str, Any] = {}
    h = L.apply_norm(p["ln_mix"], x, cfg.norm_kind)
    out, nc = attn.gqa_attention(p["mix"], h, positions, cfg, causal=True,
                                 window=window,
                                 cache=cache.get("kv") if cache else None)
    if nc is not None:
        new_cache["kv"] = nc
    x = x + out
    h = L.apply_norm(p["ln_ffn"], x, cfg.norm_kind)
    return x + L.apply_mlp(p["ffn"], h, cfg.mlp_kind), new_cache


# ---------------------------------------------------------------------------
# Per-layer value variation (windows)
# ---------------------------------------------------------------------------

def window_schedule(cfg: ModelConfig, stack: Stack) -> torch.Tensor:
    """(n,) int32 window per layer, on the host; 0 = global attention."""
    if cfg.attn_kind == "local":
        return torch.full((stack.n,), cfg.window_size, dtype=torch.int32)
    if cfg.attn_kind == "local_global":
        # gemma-2: even layers local, odd layers global
        ids = torch.arange(stack.n, dtype=torch.int32)
        return torch.where(ids % 2 == 0, cfg.window_size, 0).to(torch.int32)
    return torch.zeros((stack.n,), dtype=torch.int32)


# ---------------------------------------------------------------------------
# Full decoder-only LM
# ---------------------------------------------------------------------------

def build_params(make, cfg: ModelConfig):
    """Parameter tree for the decoder (stacked per stack)."""
    p: Dict[str, Any] = {"embed": L.make_embedding(make, "embed",
                                                   cfg.padded_vocab,
                                                   cfg.d_model)}
    for stack in stacks_for(cfg):
        def stacked_make(path, shape, names, *a, _n=stack.n, **kw):
            return make(path, (_n,) + tuple(shape),
                        ("layers",) + tuple(names), *a, **kw)

        p[stack.name] = make_block(stacked_make, stack.name, cfg, stack)
    p["final_norm"] = L.make_norm(make, "final_norm", cfg.d_model,
                                  cfg.norm_kind)
    if not cfg.tie_embeddings:
        p["unembed"] = {"table": make(
            "unembed.table", (cfg.padded_vocab, cfg.d_model),
            ("vocab", "embed"), cfg.d_model ** -0.5)}
    return p


def _layer(tree, i: int):
    """Layer ``i``'s slice of a stacked tree (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, attn.KVCache):
        return attn.KVCache(*(t[i] for t in tree))
    return tree[i]


def run_stacks(params, x, positions, cfg: ModelConfig, caches=None):
    """Run every stack. caches: {stack_name: stacked cache} or None; a
    stacked cache is written in place. Returns (x, new_caches, aux)."""
    new_caches: Dict[str, Any] = {}
    for stack in stacks_for(cfg):
        sp = params[stack.name]
        windows = window_schedule(cfg, stack).tolist()
        cache = caches.get(stack.name) if caches is not None else None
        indices = []
        for i in range(stack.n):
            x, new_c = apply_block(
                _layer(sp, i), x, positions, cfg, windows[i],
                _layer(cache, i) if cache is not None else None)
            if cache is not None:
                indices.append(new_c["kv"].index)
        if cache is not None:
            new_caches[stack.name] = {"kv": cache["kv"]._replace(
                index=torch.stack(indices))}
    return x, new_caches, torch.zeros((), dtype=torch.float32)


def lm_forward(params, tokens, cfg: ModelConfig, *, caches=None,
               positions=None, frontend_embeds=None, start_index=None,
               features_only=False):
    """Decoder-only forward.

    tokens: (B, S) int. frontend_embeds: (B, F, D) prepended (VLM).
    caches: per-stack stacked caches (decode), written in place.
    start_index: the cache fill (a host int). features_only: return final
    hidden states instead of logits.
    Returns (logits_or_features, new_caches, aux).
    """
    x = L.embed(params["embed"], tokens, cfg)
    if frontend_embeds is not None:
        x = torch.cat([frontend_embeds.to(x.dtype), x], dim=1)
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
        if start_index is not None:
            positions = positions + int(start_index)
        positions = positions[None, :].expand(b, s)
    x, new_caches, aux = run_stacks(params, x, positions, cfg, caches=caches)
    x = L.apply_norm(params["final_norm"], x, cfg.norm_kind)
    if features_only:
        return x, new_caches, aux
    table = (params["embed"]["table"] if cfg.tie_embeddings
             else params["unembed"]["table"])
    logits = L.unembed({"table": table}, x, cfg)
    return logits, new_caches, aux


# ---------------------------------------------------------------------------
# Cache init (stacked per stack)
# ---------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch: int, max_len: int, dtype, device):
    caches: Dict[str, Any] = {}
    for stack in stacks_for(cfg):
        win = max_len
        if cfg.attn_kind == "local":
            win = min(max_len, cfg.window_size)
        caches[stack.name] = {"kv": attn.init_kv_cache(
            cfg, batch, win, stack.n, dtype, device)}
    return caches
