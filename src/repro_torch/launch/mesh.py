"""Production meshes and the fake world they are built on, as the
reference's ``src/repro/launch/mesh.py``.

Single pod: (data=16, model=16) = 256 ranks. Multi-pod: (pod=2, data=16,
model=16) = 512 ranks; the ``pod`` axis is pure data parallelism. These are
the reference's logical shapes (one TPU v5e pod slice and two). They are
not a statement about any cluster of H100s: the port uses them to ask what
each rank of such a mesh would hold, compute and send
(``launch.dryrun``).

A ``DeviceMesh`` needs a process group of its size. ``fake_world(n)``
starts torch's fake process group of ``n`` ranks in this one process, as
rank 0: every collective returns at once and moves no data, so a step on
``meta`` tensors runs the control flow and the collectives' shapes of rank
0 of an ``n``-rank job without any device.

Functions, not module constants: importing this module starts no group.
"""
from __future__ import annotations

import contextlib
import math
from typing import Sequence

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

#: (shape, axis names) of the single-pod and multi-pod meshes
SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = "cpu") -> DeviceMesh:
    """A mesh of ``shape`` (row-major over the group's ranks) with the dim
    names ``axes`` over the current process group, which must hold exactly
    ``prod(shape)`` ranks (e.g. ``((2, 4), ("data", "model"))``)."""
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    if not dist.is_initialized():
        raise RuntimeError(f"a {shape} mesh needs a process group of "
                           f"{math.prod(shape)} ranks; none is running "
                           "(see fake_world)")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks, "
                         f"but the process group holds {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu") -> DeviceMesh:
    """(16, 16) over ("data", "model"), or with ``multi_pod`` (2, 16, 16)
    over ("pod", "data", "model"), over the current process group of 256
    or 512 ranks. Raises on any other group size: it never shrinks the
    mesh."""
    shape, axes = MULTI_POD if multi_pod else SINGLE_POD
    return make_mesh(shape, axes, device_type)


def _fake_backend():
    """torch's fake process group's store (importing it registers the
    ``fake`` backend), or a loud failure."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "this torch has no fake process group "
            "(torch.testing._internal.distributed.fake_pg); the dry run "
            "needs it to build meshes of hundreds of ranks") from e
    if "fake" not in dist.Backend.backend_list:
        raise RuntimeError("torch's fake backend did not register")
    return FakeStore()


@contextlib.contextmanager
def fake_world(world_size: int):
    """Context: a fake process group of ``world_size`` ranks in this
    process, as rank 0, destroyed on exit. Raises if a group is already
    running or the fake backend is missing; it never falls back to a world
    of one."""
    if world_size < 1:
        raise ValueError(f"a world needs at least one rank, got {world_size}")
    if dist.is_initialized():
        raise RuntimeError("a process group is already running; the fake "
                           "world needs the process to itself")
    store = _fake_backend()
    dist.init_process_group("fake", store=store, rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
