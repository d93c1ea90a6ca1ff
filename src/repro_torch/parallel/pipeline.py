"""Pipeline parallelism: the GPipe schedule over a mesh axis, as the
reference's ``src/repro/parallel/pipeline.py``.

Each rank along the ``stage`` axis runs one stage's parameters;
microbatches stream through the ring of stages, each step's output sent to
the next rank (``dist.batch_isend_irecv``, the reference's ``ppermute``).

    y = pipeline_apply(stage_fn, stage_params, x_microbatches, mesh, "stage")

``stage_params`` leaves are stacked (n_stages, ...), every rank given the
whole stack as the reference's caller gives it (its ``shard_map`` hands
stage i its slice); rank i of the axis runs slice i.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import mesh_shape
from repro_torch.tree import tree_map


def _ring_send(h: torch.Tensor, axis: str, mesh) -> torch.Tensor:
    """``h`` sent to the next rank of the axis's ring; returns the previous
    rank's. A ring of one keeps ``h`` (a rank's send to itself would
    deadlock under NCCL)."""
    n = mesh_shape(mesh)[axis]
    if n == 1:
        return h
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    me = mesh.get_local_rank(axis)
    out = torch.empty_like(h)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, h.contiguous(), ranks[(me + 1) % n], group),
        dist.P2POp(dist.irecv, out, ranks[(me - 1) % n], group)])
    for r in reqs:
        r.wait()
    return out


def pipeline_apply(stage_fn: Callable, stage_params: Any, x: torch.Tensor,
                   mesh, axis: str = "stage"):
    """Run x through n_stages stages with a GPipe schedule.

    stage_fn(params_slice, h) -> h  (one stage's computation)
    stage_params: tree, leaves (n_stages, ...)
    x: (n_micro, mb, ...) microbatched input (stage 0 consumes it; the
       output collects stage n-1's results).
    Returns (n_micro, mb, ...) outputs, the same on every rank.
    """
    n_stages = mesh_shape(mesh)[axis]
    n_micro = x.shape[0]
    total = n_micro + n_stages - 1
    stage = mesh.get_local_rank(axis)
    params_local = tree_map(lambda p: p[stage], stage_params)
    carry = torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    outs = torch.zeros_like(x)
    for t in range(total):
        # stage 0 injects microbatch t (while in range)
        h_in = x[t] if stage == 0 and t < n_micro else carry
        h_out = stage_fn(params_local, h_in)
        # the last stage commits microbatch t - n_stages + 1
        out_idx = t - (n_stages - 1)
        if stage == n_stages - 1 and out_idx >= 0:
            outs[out_idx] = h_out
        carry = _ring_send(h_out, axis, mesh)
    if n_stages == 1:
        return outs
    # only the last stage commits outputs (the others' stay zero, the
    # reference's mask): their sum gives every stage the same value
    dist.all_reduce(outs, group=mesh.get_group(axis))
    return outs
