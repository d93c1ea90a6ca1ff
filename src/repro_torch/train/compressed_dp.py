"""Cross-pod data parallelism with int8 error-feedback gradient compression,
as the reference's ``src/repro/train/compressed_dp.py``.

The ``pod`` axis crosses the slow inter-pod links, so its gradient
all-reduce is the one worth compressing. Each pod rank computes gradients
on its share of the batch (the batch's rows split over the pod axis, the
reference's ``P(pod)``), the pod mean is taken with the int8
error-feedback collective (``parallel.collectives.compressed_psum``), and
the residual quantization error is carried beside the optimizer state so
the update stays unbiased over time. Parameters and state are whole on
every pod rank, and every rank applies the same update.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.config import OptimizerConfig
from repro_torch.models.model import Model
from repro_torch.optim.adamw import OptState, adamw_update
from repro_torch.parallel.collectives import compressed_psum, psum_mean
from repro_torch.parallel.sharding import mesh_shape
from repro_torch.train.train_step import _grads, make_loss_fn
from repro_torch.tree import tree_map, tree_unflatten


class CompressedState(NamedTuple):
    opt: OptState
    error: Any          # error-feedback residual tree (float32, like params)


def init_compressed_state(params, opt_state: OptState) -> CompressedState:
    err = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params)
    return CompressedState(opt=opt_state, error=err)


def make_compressed_train_step(model: Model, opt_cfg: OptimizerConfig,
                               mesh, pod_axis: str = "pod"):
    """``train_step(params, CompressedState, batch)`` with int8-EF pod
    sync; ``batch`` is the global batch, of which this rank takes its pod
    share of rows. Parameters and state are updated in place."""
    loss_fn = make_loss_fn(model)
    n = mesh_shape(mesh)[pod_axis]
    me = mesh.get_local_rank(pod_axis)

    def step(params, state: CompressedState, batch):
        def share(x):
            rows = x.shape[0] // n
            return x[me * rows:(me + 1) * rows]

        metrics, grads = _grads(loss_fn, params,
                                {k: share(v) for k, v in batch.items()})
        # pod mean with int8 error feedback (slow-link compression)
        mean_grads, new_err = compressed_psum(
            tree_unflatten(params, grads), pod_axis, state.error, mesh)
        _, new_opt, opt_metrics = adamw_update(opt_cfg, params, mean_grads,
                                               state.opt)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics = {**metrics, **opt_metrics,
                   "loss": psum_mean(metrics["loss"], pod_axis, mesh)}
        return params, CompressedState(opt=new_opt, error=new_err), metrics

    return step
