"""Distributed-optimization collectives: gradient compression, pod-level
DP, as the reference's ``src/repro/parallel/collectives.py``.

int8 error-feedback compression for the cross-pod gradient all-reduce:
pods are joined by the slowest links, so the pod-axis all-reduce is the
one worth compressing. Per-tensor scale, int8 quantize, all-reduce in
int32 (exact), dequantize, and feed the quantization error back into the
next step's gradient (error feedback keeps SGD/Adam convergence).

Where the reference names a ``shard_map`` axis, the port takes the axis
of a mesh (``mesh.get_group(axis)``; the current mesh unless one is
given). A group of one rank takes no collective. Every division the
reference makes in float32 divides by a 0-d tensor (``device.scalar``).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import scalar
from repro_torch.parallel.sharding import current_mesh, mesh_shape
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.amax(torch.abs(x)) / scalar(127.0, x) + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _psum(t: torch.Tensor, axis: str, mesh) -> torch.Tensor:
    """``t`` summed over the ranks of ``axis`` (in place)."""
    if mesh_shape(mesh)[axis] > 1:
        dist.all_reduce(t, group=mesh.get_group(axis))
    return t


def compressed_psum(grads, axis: str, error: Optional[Any] = None,
                    mesh=None):
    """int8 error-feedback all-reduce over ``axis``.

    Returns (mean_grads, new_error). ``error`` is the residual tree from
    the previous step (or None); the new residual is written into its
    buffers (a full-width error tree is a copy of the parameters in
    float32, so a second one would not fit beside them).
    """
    mesh = mesh or current_mesh()
    n = mesh_shape(mesh)[axis]

    def one(g, e):
        g32 = g.float()
        if e is not None:
            g32 = g32 + e
        q, scale = quantize_int8(g32)
        new_e = torch.sub(g32, dequantize_int8(q, scale),
                          out=e if e is not None else None)
        del g32
        total = _psum(q.to(torch.int32), axis, mesh)
        scale_sum = _psum(scale.clone(), axis, mesh)  # conservative shared scale
        mean = total.float().mul_(scale_sum / scalar(n, scale_sum))
        mean = mean.div_(scalar(n, mean))
        return mean.to(g.dtype), new_e

    flat_g = tree_leaves(grads)
    flat_e = tree_leaves(error) if error is not None else [None] * len(flat_g)
    out = [one(g, e) for g, e in zip(flat_g, flat_e)]
    return (tree_unflatten(grads, [o[0] for o in out]),
            tree_unflatten(grads, [o[1] for o in out]))


def psum_mean(tree, axis: str, mesh=None):
    mesh = mesh or current_mesh()
    n = mesh_shape(mesh)[axis]
    return tree_map(
        lambda x: _psum(x.clone(), axis, mesh) / scalar(n, x), tree)
