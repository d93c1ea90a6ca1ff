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
the ``audio`` decoder with cross-attention (``models/encdec.py``).

Remat (``cfg.remat``, the reference's ``_remat_wrap``) applies where a
forward builds a graph and writes no cache: ``full`` runs each layer under
``torch.utils.checkpoint`` (recomputed in the backward); ``selective``
checkpoints each block's mixer and its FFN as two segments, so only the
tensors between segments are kept (the residual stream, ``mix_out`` and
``ffn_out``: the reference's ``SAVE_NAMES``); ``none`` keeps everything.
The policies differ in memory only, never in a number.

Every read of a parameter goes through ``parallel.fsdp.gathered`` (the
identity outside a sharded train step): a layer's segments gather their
own parameters, so a sharded step gathers one layer at a time, and again
where a remat segment recomputes it.

A step that splits its products over ``model`` (``fsdp.Layout.split``:
the train step and the serving steps) carries the residual stream as
this rank's block of the sequence (``_on_block``): each segment
normalises its block, gathers the sequence, and either reduce-scatters
its partial sums (GQA, MLA and cross-attention segments whose heads
split, MLP segments whose columns split, MoE segments whose routed
experts split, with the shared experts' columns, SSD segments whose heads
split, RG-LRU segments whose channels split) or keeps its own block of a
whole result (any segment whose dim the act rules leave whole, as
``model`` = 16 leaves recurrentgemma-2b's 10 attention heads). The
embedding ends in the same reduce-scatter, and the final norm runs on
the block. Where a serving step's positions do
not split (a decode step's one), the residual is whole on every rank: a
split segment's partial sums are all-reduced and any other segment keeps
its whole output (``fsdp.residual``).
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.parallel import fsdp
from repro_torch.parallel.fsdp import gathered, mark_slices
from repro_torch.tree import tree_leaves


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


def _segment(remat: bool, fn, *args):
    """``fn(*args)``; under ``torch.utils.checkpoint`` when ``remat``, so
    the segment's inside is recomputed in the backward and only its inputs
    and outputs are kept."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _on_block(x, ln, cfg: ModelConfig, fn, split: bool):
    """A segment on the residual ``x``: ``fn`` (returning (out, extra)) of
    the normalised ``x``. Under a split step ``x`` is this rank's sequence
    block: it is normalised, the sequence gathered, and ``fn``'s ``out``
    either reduce-scattered (``split``: it is this rank's partial sum) or
    cut to this rank's block (``fn`` computed the whole of it). Where the
    residual is whole on every rank (``fsdp.whole_seq``), a partial sum is
    all-reduced and a whole result kept as it is."""
    if fsdp.whole_seq():
        out, extra = fn(L.apply_norm(ln, x, cfg.norm_kind))
        return (fsdp.model_sum(out) if split else out), extra
    h = fsdp.seq_gather(L.apply_norm(ln, x, cfg.norm_kind))
    out, extra = fn(h)
    return (fsdp.seq_scatter(out) if split else fsdp.seq_block(out)), extra


def _whole_kv(mix):
    """A GQA segment's wk and wv gathered whole, on demand (a split bulk
    prefill writes every kv head of its cache block)."""
    return lambda: gathered((mix["wk"], mix["wv"]))


def _mlp_segment(ln, mlp, x, cfg: ModelConfig, d_ff: int):
    """An MLP segment, its columns split where the step splits ``mlp``."""
    split = fsdp.splits("mlp", d_ff)
    ln, mlp = gathered(ln), gathered(mlp, keep=split)
    return _on_block(x, ln, cfg,
                     lambda h: (L.apply_mlp(mlp, h, cfg.mlp_kind), None),
                     split)[0]


def _moe_segment(ln, moe_p, x, cfg: ModelConfig):
    """An MoE segment, its experts and the shared experts' columns split
    where the step splits them (``moe.moe_splits``); the router is read
    whole, so every rank routes alike. Returns (out, aux)."""
    split = moe_mod.moe_splits(cfg)
    fp = {k: gathered(v, keep=split and k != "router")
          for k, v in moe_p.items()}
    return _on_block(x, gathered(ln), cfg,
                     lambda h: moe_mod.apply_moe(fp, h, cfg), split)


def _griffin_group(p, x, positions, cfg: ModelConfig, stack: Stack, cache,
                   selective: bool):
    new_cache: Dict[str, Any] = {}
    for j, kind in enumerate(stack.pattern or cfg.rglru.block_pattern):
        sub = cache.get(f"g{j}") if cache else None

        def mixer(x, j=j, kind=kind, sub=sub):
            split = (rglru_mod.rglru_splits(cfg) if kind == "recurrent"
                     else fsdp.splits("heads", cfg.num_heads))
            ln = gathered(p[f"g{j}_ln_mix"])
            mix = gathered(p[f"g{j}_mix"], keep=split)

            def fn(h):
                if kind == "recurrent":
                    return rglru_mod.apply_rglru(mix, h, cfg, sub)
                return attn.gqa_attention(mix, h, positions, cfg,
                                          causal=True, window=cfg.window_size,
                                          cache=sub,
                                          whole_kv=_whole_kv(p[f"g{j}_mix"]))

            return _on_block(x, ln, cfg, fn, split)

        def ffn(x, j=j):
            return _mlp_segment(p[f"g{j}_ln_ffn"], p[f"g{j}_ffn"], x, cfg,
                                stack.d_ff)

        out, nc = _segment(selective, mixer, x)
        if nc is not None:
            new_cache[f"g{j}"] = nc
        x = x + out
        x = x + _segment(selective, ffn, x)
    return x, new_cache


def apply_block(p, x, positions, cfg: ModelConfig, stack: Stack,
                window: int, cache, cross_kv=None, enc_positions=None,
                selective: bool = False):
    """Apply one layer. window: 0 = global. ``selective``: checkpoint the
    mixer, the cross-attention and the FFN as segments (module
    docstring). Returns (x, new_cache, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if stack.mixer == "griffin_group":
        x, new_cache = _griffin_group(p, x, positions, cfg, stack, cache,
                                      selective)
        return x, new_cache, aux
    new_cache: Dict[str, Any] = {}
    key = {"gqa": "kv", "mla": "mla"}.get(stack.mixer, "ssm")
    sub = cache.get(key) if cache else None

    def mixer(x):
        ln = gathered(p["ln_mix"])
        if stack.mixer == "ssm":
            split = ssm_mod.ssm_splits(cfg)
            mix = ssm_mod.gathered_ssm(p["mix"], split)
        else:
            split = fsdp.splits("heads", cfg.num_heads)
            mix = gathered(p["mix"], keep=split)

        def fn(h):
            if stack.mixer == "gqa":
                return attn.gqa_attention(mix, h, positions, cfg,
                                          causal=True, window=window,
                                          cache=sub,
                                          whole_kv=_whole_kv(p["mix"]))
            if stack.mixer == "mla":
                return attn.mla_attention(mix, h, positions, cfg, cache=sub)
            return ssm_mod.apply_ssm(mix, h, cfg, cache=sub)

        return _on_block(x, ln, cfg, fn, split)

    def cross(x):
        split = fsdp.splits("heads", cfg.num_heads)
        ln, cp = gathered(p["ln_cross"]), gathered(p["cross"], keep=split)
        return _on_block(x, ln, cfg, lambda h: (attn.cross_attention(
            cp, h, cross_kv, positions, enc_positions, cfg), None),
            split)[0]

    def ffn(x):
        if stack.ffn == "mlp":
            return _mlp_segment(p["ln_ffn"], p["ffn"], x, cfg,
                                stack.d_ff), None
        out, aux_l = _moe_segment(p["ln_ffn"], p["ffn"], x, cfg)
        # every rank of the split computed the whole sequence's aux
        return out, fsdp.model_share(aux_l)

    # --- mixer ---
    out, nc = _segment(selective, mixer, x)
    if nc is not None:
        new_cache[key] = nc
    x = x + out

    # --- cross attention (enc-dec decoder) ---
    if cross_kv is not None:
        x = x + _segment(selective, cross, x)

    # --- ffn ---
    if stack.ffn != "none":
        out, aux_l = _segment(selective, ffn, x)
        x = x + out
        if aux_l is not None:
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
    """Layer ``i``'s slice of a stacked cache tree (views; a cache's host
    ``index`` is shared by every layer). A placed leaf's slice carries its
    spec without the layer entry (``parallel.kvcache``)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(mark_slices([t[i]], t)[0]
                            if isinstance(t, torch.Tensor) else t
                            for t in tree))
    return mark_slices([tree[i]], tree)[0]


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


def unstack(tree, n: int) -> List[Any]:
    """The ``n`` layer slices of a stacked parameter tree, each leaf split
    by one ``unbind`` (views), so its gradient is one stack of the layers'
    gradients. A sharded leaf's slices keep its spec (``mark_slices``)."""
    if isinstance(tree, dict):
        per_key = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return mark_slices(list(tree.unbind(0)), tree)


def remat_policy(cfg: ModelConfig, cache, params) -> str:
    """``cfg.remat`` where the forward writes no cache and builds a graph
    for a gradient of ``params`` (a tree of tensors), else ``"none"``: a
    serving forward has nothing to recompute."""
    if (cache is None and torch.is_grad_enabled()
            and any(t.requires_grad for t in tree_leaves(params))):
        return cfg.remat
    return "none"


def run_stack(sp, x, positions, cfg: ModelConfig, stack: Stack, windows,
              cache, cross_kv_of, enc_positions=None):
    """The layers of one stack in order: ``sp`` its stacked parameters,
    ``cache`` its stacked cache or None, ``cross_kv_of(layer params)`` the
    layer's cross-attention (k, v) or None; remat by ``remat_policy``.
    Returns (x, new stacked cache or None, the stack's summed aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_c = None
    policy = remat_policy(cfg, cache, sp)
    for i, lp in enumerate(unstack(sp, stack.n)):
        args = (lp, x, positions, cfg, stack, windows[i],
                layer_slice(cache, i) if cache is not None else None,
                cross_kv_of(lp), enc_positions, policy == "selective")
        x, new_c, aux_l = _segment(policy == "full", apply_block, *args)
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
    """The logits of the final features ``x``. Under a step that splits
    over ``model``, as the reference places them: where the residual is in
    sequence blocks, ``seq`` takes ``model`` and ``vocab`` does not, so a
    rank unembeds its own block with the whole table and the logits stay
    in sequence blocks; where it is whole (decode), ``vocab`` takes
    ``model``: a rank computes its vocab columns (``L.unembed`` on its
    table block) and gathers every rank's."""
    table = (params["embed"]["table"] if cfg.tie_embeddings
             else params["unembed"]["table"])
    if fsdp.whole_seq() and fsdp.splits("vocab", cfg.padded_vocab):
        return fsdp.split_gather(L.unembed(
            {"table": gathered(table, keep=True)}, x, cfg), -1)
    return L.unembed({"table": gathered(table)}, x, cfg)


def lm_forward(params, tokens, cfg: ModelConfig, *, caches=None,
               positions=None, frontend_embeds=None, cross_kv=None,
               enc_positions=None, start_index=None, features_only=False):
    """Decoder-only forward.

    tokens: (B, S) int. frontend_embeds: (B, F, D) prepended (VLM).
    caches: per-stack stacked caches (decode), written in place.
    start_index: the cache fill (a host int). features_only: return final
    hidden states instead of logits.
    Returns (logits_or_features, new_caches, aux). Under a step that
    splits its products over ``model`` the embedding is vocab-parallel and
    the features are this rank's block of the sequence, or, where a
    serving step's positions do not split, the whole sequence on every
    rank (module docstring); so are the logits, but for a whole residual's,
    which are gathered from every rank's vocab block (``logits_of``).
    """
    split = fsdp.splits("vocab", cfg.padded_vocab)
    x = L.embed(gathered(params["embed"], keep=split), tokens, cfg)
    if frontend_embeds is not None:
        front = frontend_embeds.to(x.dtype)
        if split and fsdp.split_rank()[1]:
            # x is a partial sum over the vocab blocks: one rank adds them
            front = torch.zeros_like(front)
        x = torch.cat([front, x], dim=1)
    b, s, _ = x.shape
    if positions is None:
        positions = positions_for(b, s, start_index, x.device)
    with fsdp.residual(s) as seq_split:
        if seq_split:
            x = fsdp.seq_scatter(x) if split else fsdp.seq_block(x)
        elif split:
            x = fsdp.model_sum(x)
        x, new_caches, aux = run_stacks(params, x, positions, cfg,
                                        caches=caches, cross_kv=cross_kv,
                                        enc_positions=enc_positions)
        x = L.apply_norm(gathered(params["final_norm"]), x, cfg.norm_kind)
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
