"""Input specs and the placements of sharded steps, as the reference's
``src/repro/launch/specs.py``: the batch (``input_specs``,
``batch_shardings``), the decode caches (``cache_specs``,
``cache_shardings`` under ``DECODE_RULES``) and the step builders
(``build_train``, ``build_decode``, ``build_prefill``).

Everything here allocates nothing: shapes are tensors on the ``meta``
device (``Model.shapes()``, ``cache_specs``), where the reference uses
``ShapeDtypeStruct``. A builder returns the step, its arguments as meta
tensors, their shardings and ``{"out_shardings": ...}``; the reference's
``donate_argnums`` has no counterpart, because the port's steps update
their parameters, optimizer state and caches in place. The serving steps
run each rank on its blocks of the caches and, like the train step, split
their products over ``model`` (``parallel.kvcache``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.config import (ModelConfig, OptimizerConfig, ParallelConfig,
                                ShapeConfig)
from repro_torch.models.layers import dtype_of
from repro_torch.models.model import Model
from repro_torch.models.transformer import init_caches
from repro_torch.optim.adamw import OptState
from repro_torch.core.distributed import mesh_device
from repro_torch.data.tokens import BATCH_NAMES
from repro_torch.parallel import kvcache
from repro_torch.parallel.sharding import (ACT_RULES, PARAM_RULES,
                                           NamedSharding, build_spec,
                                           current_act_rules, mesh_shape,
                                           rules_without_fsdp, spec_axes)
from repro_torch.train.train_step import make_train_step
from repro_torch.tree import tree_map


def sds(shape, dtype) -> torch.Tensor:
    """A shape-and-dtype stand-in (a ``meta`` tensor)."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """The batch of a train/prefill step as meta tensors."""
    b, s = shape.global_batch, shape.seq_len
    out: Dict[str, Any] = {}
    if cfg.frontend == "vision" and cfg.frontend_tokens:
        out["tokens"] = sds((b, s - cfg.frontend_tokens), torch.int32)
        out["frontend_embeds"] = sds((b, cfg.frontend_tokens, cfg.d_model),
                                     torch.float32)
    elif cfg.is_encoder_decoder:
        out["tokens"] = sds((b, s), torch.int32)
        out["enc_embeds"] = sds((b, s, cfg.d_model), torch.float32)
    else:
        out["tokens"] = sds((b, s), torch.int32)
    return out


def batch_shardings(batch_specs, mesh):
    rules = current_act_rules()
    return {k: NamedSharding(mesh, build_spec(v.shape, BATCH_NAMES[k], mesh,
                                              rules))
            for k, v in batch_specs.items()}


def batch_ranks(shape: ShapeConfig, mesh, rules=None) -> int:
    """The ranks that split a step's batch on ``mesh`` (a ``DeviceMesh`` or
    a stand-in) as ``data.tokens.shard_batch`` places it
    (``ACT_RULES["batch"]``, or ``rules``' batch entry)."""
    spec = build_spec((shape.global_batch,), ("batch",), mesh,
                      rules or ACT_RULES)
    sizes = mesh_shape(mesh)
    return math.prod(sizes[a] for a in spec_axes(spec[0]))


def _model_device(mesh):
    """This rank's device on a ``DeviceMesh``; the CPU for a stand-in (the
    builders then only describe the step)."""
    return mesh_device(mesh) if hasattr(mesh, "device_type") else "cpu"


# ---------------------------------------------------------------------------
# Cache specs + shardings
# ---------------------------------------------------------------------------

#: logical names per cache leaf field, keyed by (field, ndim)
_CACHE_NAMES = {
    ("k", 5): ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
    ("v", 5): ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
    ("pos", 2): ("layers", "kv_seq"),
    ("index", 1): ("layers",),
    ("c_kv", 4): ("layers", "batch", "kv_seq", None),
    ("k_rope", 4): ("layers", "batch", "kv_seq", None),
    ("state", 5): ("layers", "batch", "heads", "head_dim", "state"),
    ("state", 3): ("layers", "batch", "mlp"),     # rg-lru h
    ("h", 3): ("layers", "batch", "mlp"),
    ("conv", 4): ("layers", "batch", None, "mlp"),
}

#: decode rules: KV-cache sequence dim sharded over `model` (SP decode)
DECODE_RULES = dict(ACT_RULES)
DECODE_RULES["kv_seq"] = "model"
DECODE_RULES["heads"] = "model"


def cache_specs(cfg: ModelConfig, batch: int, max_len: int):
    """The decode caches as meta tensors (``init_caches`` on the ``meta``
    device: nothing allocated). A cache's ``index`` is the host int 0."""
    return init_caches(cfg, batch, max_len, dtype_of(cfg.dtype), "meta")


def _cache_field(path):
    """The reference's rule: the innermost NamedTuple field of the path
    (entries ("attr", field) or ("key", dict key)), or failing one, an
    innermost dict key ``conv`` or ``h``."""
    for kind, name in reversed(path):
        if kind == "attr" or name in ("conv", "h"):
            return name
    return None


def cache_shardings(cache_tree, mesh, rules=None):
    """The tree of each cache leaf's ``NamedSharding`` under ``rules``
    (``DECODE_RULES`` unless given), named by its field (``k``, ``v``,
    ``pos``, ``c_kv``, ``k_rope``, ``state``, ``conv``, ``h``) and ndim.

    A cache's ``index`` is a host int here (the tokens written so far, the
    same on every rank), not the reference's (layers,) int32 array, so it
    takes no sharding (None): the reference's ``("index", 1)`` entry, which
    leaves that array whole, has nothing to place."""
    rules = rules or DECODE_RULES

    def build(tree, path):
        if isinstance(tree, dict):
            return {k: build(v, path + (("key", str(k)),))
                    for k, v in tree.items()}
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*(build(v, path + (("attr", n),))
                                for n, v in zip(tree._fields, tree)))
        if not isinstance(tree, torch.Tensor):
            return None
        names = _CACHE_NAMES.get((_cache_field(path), tree.dim()),
                                 (None,) * tree.dim())
        return NamedSharding(mesh, build_spec(tree.shape, names, mesh,
                                              rules))

    return build(cache_tree, ())


def build_train(arch_cfg: ModelConfig, shape: ShapeConfig, mesh,
                opt_cfg: Optional[OptimizerConfig] = None,
                parallel: Optional[ParallelConfig] = None,
                zero1: bool = False):
    """Returns (step_fn, (params, opt_state, batch) as meta tensors,
    (param, opt-state, batch) shardings, {"out_shardings": ...}), as the
    reference's tuple (its ``donate_argnums`` has no counterpart: the step
    updates in place).

    zero1: parameters are TP-sharded only (whole over ``data``); the
    optimizer's moments and master stay fully sharded, and each
    microbatch's gradients are cut to those placements (ZeRO-1): the step
    sums the gradients over the batch's ranks, updates its blocks and
    all-gathers the parameters' blocks back.

    An MoE FFN and a loss mask keep the reference's whole-batch values
    however the batch splits (``train_step``); the step's batch is placed
    by ``data.tokens.shard_batch`` with its microbatches.

    Where ``model`` splits no batch, the step splits its products over it
    as the reference's GSPMD step does (``parallel.fsdp``): GQA heads, MLP
    columns, MLA heads, an MoE layer's experts (and its shared experts'
    columns), SSD heads, RG-LRU channels, the audio enc-dec's encoder and
    cross-attention heads, the vocab, and the residual's sequence; a
    segment whose dim the act rules leave whole computes in full on its
    sequence blocks. The serving builders split the same products
    (``build_prefill``, ``build_decode``).
    """
    batch = input_specs(arch_cfg, shape)
    batch_sh = batch_shardings(batch, mesh)
    model = Model(arch_cfg, mesh_device(mesh))
    opt_cfg = opt_cfg or OptimizerConfig()

    params = model.shapes()
    prules = rules_without_fsdp(PARAM_RULES) if zero1 else PARAM_RULES
    param_sh = tree_map(lambda s: NamedSharding(mesh, s),
                        model.specs(mesh, rules=prules))
    opt_param_sh = (tree_map(lambda s: NamedSharding(mesh, s),
                             model.specs(mesh))
                    if zero1 else param_sh)
    step_fn = make_train_step(model, opt_cfg, parallel,
                              grad_shardings=opt_param_sh if zero1 else None)
    low_precision = dtype_of(arch_cfg.param_dtype) != torch.float32
    f32_like = tree_map(lambda p: sds(p.shape, torch.float32), params)
    opt_state = OptState(
        step=sds((), torch.int32),
        m=f32_like, v=f32_like,
        master=f32_like if low_precision else None)
    opt_sh = OptState(
        step=NamedSharding(mesh, ()),
        m=opt_param_sh, v=opt_param_sh,
        master=opt_param_sh if low_precision else None)

    repl = NamedSharding(mesh, ())
    metrics_sh = {"loss": repl, "aux": repl, "lr": repl, "grad_norm": repl}
    return (step_fn, (params, opt_state, batch),
            (param_sh, opt_sh, batch_sh),
            {"out_shardings": (param_sh, opt_sh, metrics_sh)})


def _serve_setup(arch_cfg: ModelConfig, b: int, max_len: int, mesh):
    """(model, parameter shapes and shardings, cache specs and shardings,
    the caches' rows: the batch entry of every cache leaf's spec, the rows
    each rank's caches hold and its steps compute) of a serving step.
    Where those rows split the batch, an MoE FFN routes over every rank's
    rows, as the reference routes the whole batch; the rows never take
    ``model``, over which the step splits its products wherever it has more
    than one rank (``kvcache.serving``)."""
    rows = build_spec((b,), ("batch",), mesh, DECODE_RULES)[0]
    model = Model(arch_cfg, _model_device(mesh))
    params = model.shapes()
    param_sh = tree_map(lambda s: NamedSharding(mesh, s), model.specs(mesh))
    caches = cache_specs(arch_cfg, b, max_len)
    caches_sh = cache_shardings(caches, mesh)
    return model, params, param_sh, caches, caches_sh, rows


def build_decode(arch_cfg: ModelConfig, shape: ShapeConfig, mesh):
    """serve_step: one new token against a ``shape.seq_len`` cache.

    Returns (step_fn, (params, tok, caches, index[, enc_out]) as meta
    tensors, their shardings, {"out_shardings": (logits, caches)}), as the
    reference's tuple. ``index`` is a host int (the position of the new
    token), so it takes no sharding (None). The step is ``serve_step(params,
    tok, caches, index[, enc_out]) -> (logits, caches)``: the parameters,
    the token, the caches and an enc-dec model's ``enc_out`` (its encoder
    states and their positions, ``min(seq_len, 4096)`` of them) are each
    rank's blocks (``parallel.kvcache.place`` / ``init_blocks``); the caches
    are written in place (the reference donates them); the logits come
    back as the rows of the token's split, marked with their spec.

    On a mesh whose ``model`` has more than one rank the step splits its
    products over it, as the reference's GSPMD step does: this rank's GQA
    heads (q of every head gathered for split-KV over its cache slots, the
    combined output reduce-scattered back to its heads), its MLP columns
    and its vocab block of the embedding and the logits, which it gathers
    (rows x vocab). The token's one position does not split, so the
    residual is whole on every rank (``fsdp.residual``). MLA splits its
    heads as GQA does, an MoE layer its experts and shared columns, an SSD
    layer its heads and an RG-LRU layer its channels (each rank reads and
    writes its part of their states), and the enc-dec's cross-attention
    its heads over the whole ``enc_out``, ending in a sum over
    ``model``."""
    b, max_len = shape.global_batch, shape.seq_len
    tok_spec = build_spec((b, 1), ("batch", None), mesh, ACT_RULES)
    model, params, param_sh, caches, caches_sh, rows = _serve_setup(
        arch_cfg, b, max_len, mesh)
    tok = sds((b, 1), torch.int32)
    tok_sh = NamedSharding(mesh, tok_spec)
    logits_sh = NamedSharding(mesh, (tok_spec[0], None, None))
    args = (params, tok, caches, 0)
    shardings = (param_sh, tok_sh, caches_sh, None)
    if arch_cfg.is_encoder_decoder:
        enc_len = min(max_len, 4096)
        args += ((sds((b, enc_len, arch_cfg.d_model),
                      dtype_of(arch_cfg.dtype)),
                  sds((b, enc_len), torch.int32)),)
        shardings += ((NamedSharding(mesh, build_spec(
            (b, enc_len, arch_cfg.d_model), ("batch", None, None), mesh,
            ACT_RULES)),
            NamedSharding(mesh, build_spec((b, enc_len), ("batch", None),
                                           mesh, ACT_RULES))),)
    rules = current_act_rules()

    def serve_step(params, tok, caches, index, enc_out=None):
        with kvcache.serving(mesh, rules, rows):
            extras = None if enc_out is None else {"enc_out": tuple(
                kvcache.to_rows(t, rows) for t in enc_out)}
            logits, caches = model.decode_step(
                params, {"tokens": kvcache.to_rows(tok, rows)}, caches,
                index, extras)
            return kvcache.from_rows(logits, rows, tok), caches

    return (serve_step, args, shardings,
            {"out_shardings": (logits_sh, caches_sh)})


def build_prefill(arch_cfg: ModelConfig, shape: ShapeConfig, mesh):
    """prefill step: the full prompt through the model, filling caches.

    Returns (step_fn, (params, batch, caches) as meta tensors, their
    shardings, {"out_shardings": (logits, caches)}), as the reference's
    tuple; the batch is placed by the current activation rules, the caches
    (``shape.seq_len`` slots) by ``DECODE_RULES``. The step is
    ``prefill_step(params, batch, caches) -> (logits, caches)``; it also
    takes caches of more slots than the prompt (``build_decode``'s), which
    it fills as the engine's prefill does.

    Under ``DP_ACT_RULES`` the batch's entries split the batch over
    ``model`` too, more finely than the caches' rows: the step gathers each
    entry's rows over the axes the caches do not split (an all-gather of
    the prompt's tokens) and computes the caches' rows.

    On a mesh whose ``model`` has more than one rank the step splits its
    products over it, as the reference's GSPMD step does: this rank's GQA
    heads (the kv heads repeated where ``model`` does not divide them),
    its MLP columns and its vocab block of the embedding, and, where
    ``model`` divides the prompt's positions, the residual in sequence
    blocks. The logits then leave the step in those blocks, each rank
    unembedding its own positions with the whole table, marked ``(rows,
    "model", None)``: the caches' rows, nothing gathered. Otherwise they
    come back whole as the rows of the tokens' split (a slice), marked
    with their spec. A rank writes every kv head of its own cache slots,
    projected on those slots' positions. MLA splits its heads (its
    latent cache has no head dim: a rank writes its slots of the whole
    latent), an MoE layer its experts and shared columns, an SSD layer its
    heads, an RG-LRU layer its channels, and the enc-dec its encoder (in
    sequence blocks) and cross-attention heads."""
    b, s = shape.global_batch, shape.seq_len
    batch = input_specs(arch_cfg, shape)
    batch_sh = batch_shardings(batch, mesh)
    tok_rows = batch_sh["tokens"].spec[0]
    model, params, param_sh, caches, caches_sh, rows = _serve_setup(
        arch_cfg, b, s, mesh)
    rules = current_act_rules()
    seq = kvcache.prefill_seq_axis(mesh, rules, rows, s)
    logits_sh = NamedSharding(mesh, (rows, seq, None) if seq
                              else (tok_rows, None, None))

    def prefill_step(params, batch, caches):
        with kvcache.serving(mesh, rules, rows):
            logits, caches, _ = model.prefill(
                params, {k: kvcache.to_rows(v, rows)
                         for k, v in batch.items()}, caches)
            return kvcache.from_rows(logits, rows, batch["tokens"],
                                     seq), caches

    return (prefill_step, (params, batch, caches),
            (param_sh, batch_sh, caches_sh),
            {"out_shardings": (logits_sh, caches_sh)})
