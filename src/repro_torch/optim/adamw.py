"""AdamW + LR schedules, as the reference's ``src/repro/optim/adamw.py``.

The optimizer state mirrors the parameter tree (``m``, ``v`` and, for
low-precision parameters, a float32 ``master`` copy). Trees are nested
dicts of tensors, walked in JAX's order (``repro_torch.tree``), so the
global norm sums its leaves in the reference's order. ``adamw_update``
runs under ``torch.no_grad()`` in float32 and writes the parameters and
the state in place; it returns them, as the reference returns its new
trees.

Every division the reference makes in float32 divides by a 0-d tensor
(``device.scalar``): torch on the card turns ``tensor / python_float`` into
a multiplication by the reciprocal.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.config import OptimizerConfig
from repro_torch.device import scalar
from repro_torch.tree import tree_leaves, tree_map


class OptState(NamedTuple):
    step: torch.Tensor    # 0-d int32, the updates made
    m: Any
    v: Any
    master: Any = None    # float32 master weights when params are low precision


def init_opt_state(params) -> OptState:
    leaves = tree_leaves(params)
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    low_precision = any(x.dtype != torch.float32 for x in leaves)
    master = (tree_map(lambda p: p.detach().float().clone(), params)
              if low_precision else None)
    return OptState(step=torch.zeros((), dtype=torch.int32,
                                     device=leaves[0].device),
                    m=zeros, v=tree_map(torch.clone, zeros), master=master)


def lr_at(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (0-d tensor) as a float32 0-d tensor:
    linear warmup, then constant, linear or cosine decay."""
    step = step.float()
    warm = torch.clamp_max(step / scalar(max(cfg.warmup_steps, 1), step),
                           1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    frac = torch.clamp((step - cfg.warmup_steps)
                       / scalar(max(cfg.total_steps - cfg.warmup_steps, 1),
                                step), 0.0, 1.0)
    if cfg.schedule == "linear":
        decay = 1.0 - frac
    else:  # cosine
        decay = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.lr * warm * decay


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads, max_norm: float, norm_fn=global_norm):
    """(grads scaled to a global norm of at most ``max_norm``, the norm);
    ``norm_fn`` computes the norm (a sharded step's sums over every
    rank's blocks)."""
    norm = norm_fn(grads)
    scale = torch.clamp_max(scalar(max_norm, norm)
                            / torch.clamp_min(norm, 1e-12), 1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, params, grads, state: OptState,
                 norm_fn=global_norm
                 ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """Returns (params, state, metrics), the parameters and the state
    updated in place. ``norm_fn``: the gradients' global norm (a sharded
    step passes its own, which reduces over every block).

    Mixed precision: when the model params are bfloat16 the update is
    applied to the float32 master copy in ``state.master`` and the
    parameters are re-derived from it.
    """
    grads = tree_map(lambda g: g.float(), grads)
    if cfg.grad_clip:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, norm_fn)
    else:
        gnorm = norm_fn(grads)
    step = state.step + 1
    lr = lr_at(cfg, step)
    b1, b2, eps = cfg.b1, cfg.b2, cfg.eps
    bc1 = 1.0 - torch.pow(scalar(b1, lr), step.float())
    bc2 = 1.0 - torch.pow(scalar(b2, lr), step.float())

    def upd(p, g, m, v, master=None):
        p32 = master if master is not None else p.float()
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(g * (1 - b2) * g)
        denom = (v / bc2).sqrt_().add_(eps)
        delta = (m / bc1).div_(denom).add_(cfg.weight_decay * p32)
        delta.mul_(lr)
        if master is not None:
            p.copy_(master.sub_(delta))
        elif p.dtype == torch.float32:
            p.sub_(delta)
        else:
            p.copy_(p32 - delta)

    masters = (state.master if state.master is not None
               else tree_map(lambda p: None, params))
    tree_map(upd, params, grads, state.m, state.v, masters)
    metrics = {"lr": lr, "grad_norm": gnorm}
    return params, state._replace(step=step), metrics
