"""Decoder-only LM assembly: stacks of structurally identical layers.

An architecture is a sequence of *stacks*; each stack is N identical
layers (or griffin groups) whose parameters carry a leading (N, ...) layer
dim, as the reference's do, so the two parameter trees map key for key.
``run_stacks`` runs the layers one by one (the reference's ``lax.scan``).
Per-layer *value* variation inside a stack (gemma-2's local/global
alternation) comes from ``windows_of``; *structural* variation
(dense-vs-MoE first layer, griffin's rec/rec/attn pattern) becomes
separate stacks or grouped layers.

Every family of the reference runs: ``dense`` and ``vlm`` (GQA + MLP),
``moe`` (GQA or MLA + a dense first stack and MoE stacks), ``ssm``
(Mamba-2), ``hybrid`` (griffin groups of RG-LRU and local attention) and
the ``audio`` decoder with cross-attention (``models/encdec.py``). Remat
waits for the training slice (ROADMAP item 17(c)).
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod


# ---------------------------------------------------------------------------
# Stack descriptors
# ---------------------------------------------------------------------------

class Stack(NamedTuple):
    name: str
    n: int              # number of units (layers or groups)
    mixer: str          # gqa | mla | ssm | griffin_group
    ffn: str            # mlp | moe | none
    d_ff: int           # ffn hidden size (dense path)
    pattern: tuple = ()  # griffin group pattern (per-stack)


def stacks_for(cfg: ModelConfig) -> List[Stack]:
    fam = cfg.family
    if fam == "ssm":
        return [Stack("layers", cfg.num_layers, "ssm", "none", 0)]
    if fam == "hybrid":
        pat = cfg.rglru.block_pattern
        n_full = cfg.num_layers // len(pat)
        out = [Stack("groups", n_full, "griffin_group", "mlp", cfg.d_ff,
                     pattern=tuple(pat))]
        rem = cfg.num_layers - n_full * len(pat)
        if rem:  # e.g. recurrentgemma-2b: 26 = 8*(r,r,a) + (r,r)
            out.append(Stack("tail_group", 1, "griffin_group", "mlp",
                             cfg.d_ff, pattern=tuple(pat[:rem])))
        return out
    if fam == "moe":
        mixer = "mla" if cfg.mla is not None else "gqa"
        first = cfg.moe.first_moe_layer
        out = []
        if first > 0:
            out.append(Stack("dense_layers", first, mixer, "mlp",
                             cfg.moe.dense_ff or cfg.d_ff))
        out.append(Stack("moe_layers", cfg.num_layers - first, mixer, "moe",
                         0))
        return out
    # dense / vlm / audio-decoder
    return [Stack("layers", cfg.num_layers, "gqa", "mlp", cfg.d_ff)]


# ---------------------------------------------------------------------------
# Single block (one layer) param build + apply
# ---------------------------------------------------------------------------

def make_block(make, path: str, cfg: ModelConfig, stack: Stack,
               cross_attn: bool = False):
    p: Dict[str, Any] = {}
    d = cfg.d_model
    if stack.mixer == "gqa":
        p["ln_mix"] = L.make_norm(make, f"{path}.ln_mix", d, cfg.norm_kind)
        p["mix"] = attn.make_gqa(make, f"{path}.mix", cfg)
    elif stack.mixer == "mla":
        p["ln_mix"] = L.make_norm(make, f"{path}.ln_mix", d, cfg.norm_kind)
        p["mix"] = attn.make_mla(make, f"{path}.mix", cfg)
    elif stack.mixer == "ssm":
        p["ln_mix"] = L.make_norm(make, f"{path}.ln_mix", d, cfg.norm_kind)
        p["mix"] = ssm_mod.make_ssm(make, f"{path}.mix", cfg)
    elif stack.mixer == "griffin_group":
        for j, kind in enumerate(stack.pattern or cfg.rglru.block_pattern):
            p[f"g{j}_ln_mix"] = L.make_norm(make, f"{path}.g{j}.ln_mix", d,
                                            cfg.norm_kind)
            if kind == "recurrent":
                p[f"g{j}_mix"] = rglru_mod.make_rglru(make, f"{path}.g{j}.mix",
                                                      cfg)
            else:
                p[f"g{j}_mix"] = attn.make_gqa(make, f"{path}.g{j}.mix", cfg)
            p[f"g{j}_ln_ffn"] = L.make_norm(make, f"{path}.g{j}.ln_ffn", d,
                                            cfg.norm_kind)
            p[f"g{j}_ffn"] = L.make_mlp(make, f"{path}.g{j}.ffn", d,
                                        stack.d_ff, cfg.mlp_kind)
    if cross_attn:
        p["ln_cross"] = L.make_norm(make, f"{path}.ln_cross", d,
                                    cfg.norm_kind)
        p["cross"] = attn.make_gqa(make, f"{path}.cross", cfg)

    if stack.mixer != "griffin_group":
        if stack.ffn == "mlp":
            p["ln_ffn"] = L.make_norm(make, f"{path}.ln_ffn", d,
                                      cfg.norm_kind)
            p["ffn"] = L.make_mlp(make, f"{path}.ffn", d, stack.d_ff,
                                  cfg.mlp_kind)
        elif stack.ffn == "moe":
            p["ln_ffn"] = L.make_norm(make, f"{path}.ln_ffn", d,
                                      cfg.norm_kind)
            p["ffn"] = moe_mod.make_moe(make, f"{path}.ffn", cfg)
    return p


def _griffin_group(p, x, positions, cfg: ModelConfig, stack: Stack, cache):
    new_cache: Dict[str, Any] = {}
    for j, kind in enumerate(stack.pattern or cfg.rglru.block_pattern):
        h = L.apply_norm(p[f"g{j}_ln_mix"], x, cfg.norm_kind)
        sub = cache.get(f"g{j}") if cache else None
        if kind == "recurrent":
            out, nc = rglru_mod.apply_rglru(p[f"g{j}_mix"], h, cfg, sub)
        else:
            out, nc = attn.gqa_attention(
                p[f"g{j}_mix"], h, positions, cfg, causal=True,
                window=cfg.window_size, cache=sub)
        if nc is not None:
            new_cache[f"g{j}"] = nc
        x = x + out
        h = L.apply_norm(p[f"g{j}_ln_ffn"], x, cfg.norm_kind)
        x = x + L.apply_mlp(p[f"g{j}_ffn"], h, cfg.mlp_kind)
    return x, new_cache


def apply_block(p, x, positions, cfg: ModelConfig, stack: Stack,
                window: int, cache, cross_kv=None, enc_positions=None):
    """Apply one layer. window: 0 = global. Returns (x, new_cache, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if stack.mixer == "griffin_group":
        x, new_cache = _griffin_group(p, x, positions, cfg, stack, cache)
        return x, new_cache, aux
    new_cache: Dict[str, Any] = {}

    # --- mixer ---
    h = L.apply_norm(p["ln_mix"], x, cfg.norm_kind)
    if stack.mixer == "gqa":
        out, nc = attn.gqa_attention(p["mix"], h, positions, cfg, causal=True,
                                     window=window,
                                     cache=cache.get("kv") if cache else None)
        key = "kv"
    elif stack.mixer == "mla":
        out, nc = attn.mla_attention(p["mix"], h, positions, cfg,
                                     cache=cache.get("mla") if cache else None)
        key = "mla"
    else:
        out, nc = ssm_mod.apply_ssm(p["mix"], h, cfg,
                                    cache=cache.get("ssm") if cache else None)
        key = "ssm"
    if nc is not None:
        new_cache[key] = nc
    x = x + out

    # --- cross attention (enc-dec decoder) ---
    if cross_kv is not None:
        h = L.apply_norm(p["ln_cross"], x, cfg.norm_kind)
        x = x + attn.cross_attention(p["cross"], h, cross_kv, positions,
                                     enc_positions, cfg)

    # --- ffn ---
    if stack.ffn == "mlp":
        h = L.apply_norm(p["ln_ffn"], x, cfg.norm_kind)
        x = x + L.apply_mlp(p["ffn"], h, cfg.mlp_kind)
    elif stack.ffn == "moe":
        h = L.apply_norm(p["ln_ffn"], x, cfg.norm_kind)
        out, aux_l = moe_mod.apply_moe(p["ffn"], h, cfg)
        x = x + out
        aux = aux + aux_l
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# Per-layer value variation (windows)
# ---------------------------------------------------------------------------

def windows_of(cfg: ModelConfig, stack: Stack) -> List[int]:
    """The window of each layer as host ints; 0 = global attention."""
    if cfg.attn_kind == "local":
        return [cfg.window_size] * stack.n
    if cfg.attn_kind == "local_global":
        # gemma-2: even layers local, odd layers global
        return [cfg.window_size if i % 2 == 0 else 0 for i in range(stack.n)]
    return [0] * stack.n


# ---------------------------------------------------------------------------
# Full decoder-only LM
# ---------------------------------------------------------------------------

def build_params(make, cfg: ModelConfig, cross_attn: bool = False,
                 with_embed: bool = True):
    """Parameter tree for the decoder (stacked per stack)."""
    p: Dict[str, Any] = {}
    if with_embed:
        p["embed"] = L.make_embedding(make, "embed", cfg.padded_vocab,
                                      cfg.d_model)
    for stack in stacks_for(cfg):
        def stacked_make(path, shape, names, *a, _n=stack.n, **kw):
            return make(path, (_n,) + tuple(shape),
                        ("layers",) + tuple(names), *a, **kw)

        p[stack.name] = make_block(stacked_make, stack.name, cfg, stack,
                                   cross_attn=cross_attn)
    p["final_norm"] = L.make_norm(make, "final_norm", cfg.d_model,
                                  cfg.norm_kind)
    if not cfg.tie_embeddings and with_embed:
        p["unembed"] = {"table": make(
            "unembed.table", (cfg.padded_vocab, cfg.d_model),
            ("vocab", "embed"), cfg.d_model ** -0.5)}
    return p


def layer_slice(tree, i: int):
    """Layer ``i``'s slice of a stacked parameter or cache tree (views; a
    cache's host ``index`` is shared by every layer)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(t[i] if isinstance(t, torch.Tensor) else t
                            for t in tree))
    return tree[i]


def _restack(stacked, last):
    """The stacked cache after its layers wrote their slices in place, with
    the last layer's new ``index``."""
    if isinstance(stacked, dict):
        return {k: _restack(v, last[k]) for k, v in stacked.items()}
    if "index" in getattr(stacked, "_fields", ()):
        return stacked._replace(index=last.index)
    return stacked


def run_stacks(params, x, positions, cfg: ModelConfig, caches=None,
               cross_kv=None, enc_positions=None):
    """Run every stack. caches: {stack_name: stacked cache} or None; a
    stacked cache is written in place. Returns (x, new_caches, aux): aux
    the float32 sum of the MoE layers' losses."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches: Dict[str, Any] = {}
    for stack in stacks_for(cfg):
        x, new_c, aux = run_stack(params[stack.name], x, positions, cfg,
                                  stack, windows_of(cfg, stack),
                                  caches.get(stack.name) if caches is not None
                                  else None,
                                  lambda lp: cross_kv, enc_positions)
        if new_c is not None:
            new_caches[stack.name] = new_c
        aux_total = aux_total + aux
    return x, new_caches, aux_total


def run_stack(sp, x, positions, cfg: ModelConfig, stack: Stack, windows,
              cache, cross_kv_of, enc_positions=None):
    """The layers of one stack in order: ``sp`` its stacked parameters,
    ``cache`` its stacked cache or None, ``cross_kv_of(layer params)`` the
    layer's cross-attention (k, v) or None. Returns (x, new stacked cache or
    None, the stack's summed aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_c = None
    for i in range(stack.n):
        lp = layer_slice(sp, i)
        x, new_c, aux_l = apply_block(
            lp, x, positions, cfg, stack, windows[i],
            layer_slice(cache, i) if cache is not None else None,
            cross_kv=cross_kv_of(lp), enc_positions=enc_positions)
        aux = aux + aux_l
    if cache is None:
        return x, None, aux
    return x, _restack(cache, new_c), aux


def positions_for(b: int, s: int, start_index, device) -> torch.Tensor:
    """(B,S) int32 positions from ``start_index`` (a host int; None = 0)."""
    positions = torch.arange(s, dtype=torch.int32, device=device)
    if start_index is not None:
        positions = positions + int(start_index)
    return positions[None, :].expand(b, s)


def logits_of(params, x, cfg: ModelConfig):
    table = (params["embed"]["table"] if cfg.tie_embeddings
             else params["unembed"]["table"])
    return L.unembed({"table": table}, x, cfg)


def lm_forward(params, tokens, cfg: ModelConfig, *, caches=None,
               positions=None, frontend_embeds=None, cross_kv=None,
               enc_positions=None, start_index=None, features_only=False):
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
        positions = positions_for(b, s, start_index, x.device)
    x, new_caches, aux = run_stacks(params, x, positions, cfg, caches=caches,
                                    cross_kv=cross_kv,
                                    enc_positions=enc_positions)
    x = L.apply_norm(params["final_norm"], x, cfg.norm_kind)
    if features_only:
        return x, new_caches, aux
    return logits_of(params, x, cfg), new_caches, aux


# ---------------------------------------------------------------------------
# Cache init (stacked per stack)
# ---------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch: int, max_len: int, dtype, device):
    caches: Dict[str, Any] = {}
    for stack in stacks_for(cfg):
        if stack.mixer == "gqa":
            win = max_len
            if cfg.attn_kind == "local":
                win = min(max_len, cfg.window_size)
            caches[stack.name] = {"kv": attn.init_kv_cache(
                cfg, batch, win, stack.n, dtype, device)}
        elif stack.mixer == "mla":
            caches[stack.name] = {"mla": attn.init_mla_cache(
                cfg, batch, max_len, stack.n, dtype, device)}
        elif stack.mixer == "ssm":
            caches[stack.name] = {"ssm": ssm_mod.init_ssm_cache(
                cfg, batch, stack.n, dtype, device)}
        elif stack.mixer == "griffin_group":
            sub: Dict[str, Any] = {}
            for j, kind in enumerate(stack.pattern or cfg.rglru.block_pattern):
                if kind == "recurrent":
                    sub[f"g{j}"] = rglru_mod.init_rglru_cache(
                        cfg, batch, stack.n, dtype, device)
                else:
                    sub[f"g{j}"] = attn.init_kv_cache(
                        cfg, batch, min(max_len, cfg.window_size), stack.n,
                        dtype, device)
            caches[stack.name] = sub
    return caches
