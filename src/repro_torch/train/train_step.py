"""Train step: loss, gradients, microbatch accumulation, AdamW, as the
reference's ``src/repro/train/train_step.py``.

The gradients are ``torch.autograd.grad`` of the loss with respect to the
parameter leaves, never accumulated into ``.grad`` (torch would sum a
bfloat16 parameter's there in bfloat16). Microbatch gradients are summed
into float32 buffers in order and divided by the count, as the reference's
scan sums them. The metrics stay on the device: the trainer reads the loss
once a step.

Sharded parameters (``parallel.fsdp.place``, run under
``parallel.sharding.use_mesh``; ``launch.specs.build_train`` gives their
placements): the model gathers them layer by layer, and each rank's
gradients come back as its blocks, summed over the ranks that split the
batch. Each rank's loss is the mean over its own sequences, so the sums
are divided by the microbatches times those ranks, the loss and aux are
averaged over them, and the global norm sums every block once.

A statistic of the whole batch is the reference's on a split batch too:
an MoE FFN routes over every rank's tokens (``models.moe``: the capacity,
the drops and the aux of the whole batch) and a loss mask divides by the
whole batch's mask sum (``models.model.chunked_lm_loss``). Each rank
reads such a term through ``fsdp.Layout.whole_batch``: its value is the
whole batch's, and its gradient with respect to the rank's own share is
``batch_n`` times that share's, so the sum over ranks divided by
``batch_n`` is the whole batch's gradient; a rank's aux, and its masked
loss, hold the whole batch's value, and so does their mean over the
ranks.
The reference's microbatch i is the global rows [i B / n, (i + 1) B /
n); a split batch must come placed so that each rank's microbatch i is
its block of those rows (``data.tokens.shard_batch(..., microbatches=n)``),
which the step checks.

Where ``model`` splits no batch, the products are split over it as
well (``parallel.fsdp``): GQA and MLA heads, MLP columns, an MoE
layer's experts and shared columns, SSD heads, RG-LRU channels, the
enc-dec's encoder and cross-attention, the vocab, the residual's
sequence. Each rank's loss is still its rows' whole loss, and its gradients come back as its blocks, summed over the
batch ranks and, for a leaf that every rank of ``model`` reads whole,
over ``model``.

``grad_shardings`` (ZeRO-1): each microbatch's gradients are cut to
those placements (the optimizer state's, finer than the parameters'), the
update runs on the matching blocks of the parameters, and the parameters'
blocks are gathered back. On a mesh of one rank all of this is the
identity, and the step gives the plain step's bits.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch

from repro_torch.config import OptimizerConfig, ParallelConfig
from repro_torch.data.tokens import placed_microbatches
from repro_torch.device import scalar
from repro_torch.models.model import Model, chunked_lm_loss
from repro_torch.optim.adamw import OptState, adamw_update, global_norm
from repro_torch.parallel import fsdp
from repro_torch.parallel import sharding as S
from repro_torch.tree import tree_leaves, tree_unflatten


def make_loss_fn(model: Model):
    """Fused feature -> chunked-CE loss (never materializes full logits):
    ``loss_fn(params, batch) -> (loss + aux, {"loss", "aux"})``."""

    def loss_fn(params, batch):
        feats, aux = model.forward(params, batch, features_only=True)
        # a step split over `model` holds a block of the sequence: the loss
        # reads it whole, against this rank's vocab block
        feats = fsdp.seq_gather(feats)
        # next-token prediction: position t predicts token t+1
        tokens = batch["tokens"]
        if model.cfg.frontend == "vision":
            # frontend tokens are prepended; slice back to the text region
            feats = feats[:, model.cfg.frontend_tokens:]
        table = fsdp.gathered(
            model.unembed_table(params),
            keep=fsdp.splits("vocab", model.cfg.padded_vocab))
        loss = chunked_lm_loss(feats[:, :-1], table, tokens[:, 1:],
                               model.cfg, batch.get("loss_mask", None))
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


def check_placement(batch, micro: int, layout) -> None:
    """Raise a ``ValueError`` where a batch split over ranks is not placed
    for ``micro`` microbatches (``data.tokens.shard_batch``): a rank's
    microbatch would then not be its block of the reference's."""
    if layout is None or layout.batch_n == 1 or micro == 1:
        return
    placed = placed_microbatches(batch["tokens"])
    if placed != micro:
        raise ValueError(
            f"the batch's rows are placed for {placed} microbatches and the "
            f"step takes {micro}: place it with shard_batch(..., "
            f"microbatches={micro})")


def make_train_step(model: Model, opt_cfg: OptimizerConfig,
                    parallel: Optional[ParallelConfig] = None,
                    grad_shardings=None):
    """Returns ``train_step(params, opt_state, batch) -> (params, state,
    metrics)``; the parameters (leaves that require a gradient) and the
    state are updated in place.

    grad_shardings: optional tree of ``NamedSharding``s (the parameters'
    structure) to which each microbatch's gradients are cut; with ZeRO-1
    (parameters whole over ``data``) the optimizer's placements.
    On sharded parameters the step splits its products over ``model``
    (``parallel.fsdp``)."""
    loss_fn = make_loss_fn(model)
    micro = parallel.microbatches if parallel else 1
    gsh = None if grad_shardings is None else tree_leaves(grad_shardings)

    def train_step(params, opt_state: OptState, batch):
        leaves = tree_leaves(params)
        layout = fsdp.layout_of(params, batch, split=True)
        check_placement(batch, micro, layout)
        # the gradient sums' count: microbatches x ranks splitting the batch
        count = micro * (layout.batch_n if layout is not None else 1)
        extra = mesh = None
        if gsh is not None:
            mesh = gsh[0].mesh
            extra = [fsdp.extra_spec(fsdp.spec_of(p), sh.spec, p.dim())
                     for p, sh in zip(leaves, gsh)]

        def cut(g):
            if extra is None:
                return g
            return [S.shard_of(gi, e, mesh) for gi, e in zip(g, extra)]

        with fsdp.use_layout(layout):
            if count > 1:  # repro-lint: disable=traced-branch — a host int
                mb = _split_microbatches(batch, micro)
                gsum = [torch.zeros(p.shape if extra is None else
                                    S.local_shape(p.shape, extra[i], mesh),
                                    dtype=torch.float32, device=p.device)
                        for i, p in enumerate(leaves)]
                device = gsum[0].device
                msum = {k: torch.zeros((), dtype=torch.float32,
                                       device=device)
                        for k in ("loss", "aux")}
                for i in range(micro):
                    m, g = _grads(loss_fn, params,
                                  {k: v[i] for k, v in mb.items()})
                    for acc, gi in zip(gsum, cut(g)):
                        acc.add_(gi)
                    del g
                    msum = {k: msum[k] + m[k].detach() for k in msum}
                n = scalar(count, gsum[0])
                grads = [g.div_(n) for g in gsum]
                metrics = {k: v / scalar(micro, v) for k, v in msum.items()}
            else:
                metrics, grads = _grads(loss_fn, params, batch)
                grads = cut(grads)
                metrics = {k: v.detach() for k, v in metrics.items()}
        norm_fn, upd = global_norm, params
        if layout is not None:
            metrics = {k: layout.batch_mean(v) for k, v in metrics.items()}
            specs = ([sh.spec for sh in gsh] if gsh is not None
                     else [fsdp.spec_of(p) for p in leaves])
            norm_fn = functools.partial(layout.global_norm, specs=specs)
        if extra is not None:
            with torch.no_grad():
                blocks = [S.shard_of(p, e, mesh)
                          for p, e in zip(leaves, extra)]
            upd = tree_unflatten(params, blocks)
        _, opt_state, opt_metrics = adamw_update(
            opt_cfg, upd, tree_unflatten(params, grads), opt_state, norm_fn)
        if extra is not None:
            with torch.no_grad():
                for p, b, e in zip(leaves, blocks, extra):
                    if b.numel() != p.numel():
                        p.copy_(S.gather_shards(b, e, mesh))
        return params, opt_state, dict(metrics, **opt_metrics)

    return train_step


def make_eval_step(model: Model):
    loss_fn = make_loss_fn(model)

    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = loss_fn(params, batch)
        return metrics

    return eval_step
