"""Input specs and the placements of a sharded train step, as the
reference's ``src/repro/launch/specs.py`` (``input_specs``,
``batch_shardings``, ``build_train``).

Everything here allocates nothing: shapes are tensors on the ``meta``
device (``Model.shapes()``), where the reference uses
``ShapeDtypeStruct``. The reference's serving steps
(``build_decode``, ``build_prefill``, the cache specs) are not ported
(ROADMAP).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.config import (ModelConfig, OptimizerConfig, ParallelConfig,
                                ShapeConfig)
from repro_torch.models.layers import dtype_of
from repro_torch.models.model import Model
from repro_torch.optim.adamw import OptState
from repro_torch.core.distributed import mesh_device
from repro_torch.data.tokens import BATCH_NAMES
from repro_torch.parallel.sharding import (ACT_RULES, PARAM_RULES,
                                           NamedSharding, build_spec,
                                           current_act_rules, mesh_shape,
                                           rules_without_fsdp, spec_axes)
from repro_torch.train.train_step import check_split_batch, make_train_step
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


def batch_ranks(shape: ShapeConfig, mesh) -> int:
    """The ranks that split a step's batch on ``mesh`` (a ``DeviceMesh`` or
    a stand-in) as ``data.tokens.shard_batch`` places it
    (``ACT_RULES["batch"]``)."""
    spec = build_spec((shape.global_batch,), ("batch",), mesh, ACT_RULES)
    sizes = mesh_shape(mesh)
    return math.prod(sizes[a] for a in spec_axes(spec[0]))


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

    Raises a ``ValueError`` where the batch's split would change the
    step's values (``train_step.check_split_batch``).
    """
    batch = input_specs(arch_cfg, shape)
    batch_sh = batch_shardings(batch, mesh)
    check_split_batch(arch_cfg, batch_ranks(shape, mesh))
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

