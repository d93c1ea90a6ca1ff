"""Train step: loss, gradients, microbatch accumulation, AdamW, as the
reference's ``src/repro/train/train_step.py``.

The gradients are ``torch.autograd.grad`` of the loss with respect to the
parameter leaves, never accumulated into ``.grad`` (torch would sum a
bfloat16 parameter's there in bfloat16). Microbatch gradients are summed
into float32 buffers in order and divided by the count, as the reference's
scan sums them. The metrics stay on the device: the trainer reads the loss
once a step. The reference's ``grad_shardings`` waits for the parallel
slice (ROADMAP item 17(d)).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.config import OptimizerConfig, ParallelConfig
from repro_torch.device import scalar
from repro_torch.models.model import Model, chunked_lm_loss
from repro_torch.optim.adamw import OptState, adamw_update
from repro_torch.tree import tree_leaves, tree_unflatten


def make_loss_fn(model: Model):
    """Fused feature -> chunked-CE loss (never materializes full logits):
    ``loss_fn(params, batch) -> (loss + aux, {"loss", "aux"})``."""

    def loss_fn(params, batch):
        feats, aux = model.forward(params, batch, features_only=True)
        # next-token prediction: position t predicts token t+1
        tokens = batch["tokens"]
        if model.cfg.frontend == "vision":
            # frontend tokens are prepended; slice back to the text region
            feats = feats[:, model.cfg.frontend_tokens:]
        loss = chunked_lm_loss(feats[:, :-1], model.unembed_table(params),
                               tokens[:, 1:], model.cfg,
                               batch.get("loss_mask", None))
        return loss + aux, {"loss": loss, "aux": aux}

    return loss_fn


def _split_microbatches(batch: Dict[str, Any], n: int):
    """Every entry (B, ...) as (n, B / n, ...)."""
    def split(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} not divisible by {n} microbatches")
        return x.reshape(n, b // n, *x.shape[1:])

    return {k: split(v) for k, v in batch.items()}


def _grads(loss_fn, params, batch):
    """(metrics, the gradient of each leaf in ``tree_leaves`` order, zeros
    where a leaf takes none)."""
    leaves = tree_leaves(params)
    total, metrics = loss_fn(params, batch)
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    return metrics, [torch.zeros_like(p) if g is None else g
                     for p, g in zip(leaves, grads)]


def make_train_step(model: Model, opt_cfg: OptimizerConfig,
                    parallel: Optional[ParallelConfig] = None):
    """Returns ``train_step(params, opt_state, batch) -> (params, state,
    metrics)``; the parameters (leaves that require a gradient) and the
    state are updated in place."""
    loss_fn = make_loss_fn(model)
    micro = parallel.microbatches if parallel else 1

    def train_step(params, opt_state: OptState, batch):
        if micro > 1:
            mb = _split_microbatches(batch, micro)
            gsum = [torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device)
                    for p in tree_leaves(params)]
            device = gsum[0].device
            msum = {k: torch.zeros((), dtype=torch.float32, device=device)
                    for k in ("loss", "aux")}
            for i in range(micro):
                m, g = _grads(loss_fn, params,
                              {k: v[i] for k, v in mb.items()})
                for acc, gi in zip(gsum, g):
                    acc.add_(gi)
                del g
                msum = {k: msum[k] + m[k].detach() for k in msum}
            n = scalar(micro, gsum[0])
            grads = [g.div_(n) for g in gsum]
            metrics = {k: v / n for k, v in msum.items()}
        else:
            metrics, grads = _grads(loss_fn, params, batch)
            metrics = {k: v.detach() for k, v in metrics.items()}
        _, opt_state, opt_metrics = adamw_update(
            opt_cfg, params, tree_unflatten(params, grads), opt_state)
        return params, opt_state, dict(metrics, **opt_metrics)

    return train_step


def make_eval_step(model: Model):
    loss_fn = make_loss_fn(model)

    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = loss_fn(params, batch)
        return metrics

    return eval_step
