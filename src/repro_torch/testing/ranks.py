"""Run a function on every rank of a fresh ``torch.distributed`` group.

``run_ranks(fn, world, mesh_shape, backend, tmpdir, *args)`` spawns
``world`` processes, each of which runs one thread of torch (torch on the
CPU orders colliding ``index_put_(accumulate=True)`` adds differently
once it runs several threads, and a spawned child does not inherit the
parent's setting), joins the group through a ``FileStore`` under
``tmpdir`` (no port to clash with another run), builds the
``DeviceMesh`` of ``mesh_shape`` (row-major) with the dim names ``axes``
(``("data", "model")`` unless given: ``("pod",)``, ``("stage",)``, ...),
calls ``fn(mesh, *args)`` and writes the dict of numpy arrays it returns
to a file. The parent returns those dicts, one per rank, in rank order.

``fn`` must be importable by its module path (spawn imports it anew in
every child), and so must its arguments be picklable. The backend follows
the device: NCCL puts rank r on card r and needs a card a rank; gloo runs
on the CPU. A rank that raises fails the run: the others are stopped and
the parent raises; a collective that waits longer than
``COLLECTIVE_TIMEOUT`` raises in its rank.
"""
from __future__ import annotations

import datetime
import os
import tempfile
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core.distributed import AXES

#: backend -> the device type of its ranks
BACKEND_DEVICES = {"nccl": "cuda", "gloo": "cpu"}
#: how long a rank waits in one collective before it fails the run (a rank
#: that never joins would otherwise hang the others for good)
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=5)


def check_world(world: int, backend: str) -> None:
    """Raise unless ``backend`` can run ``world`` ranks here: NCCL needs a
    card a rank (two ranks on one card are refused)."""
    if backend not in BACKEND_DEVICES:
        raise ValueError(f"unknown backend {backend!r}; expected "
                         f"{sorted(BACKEND_DEVICES)}")
    if world < 1:
        raise ValueError(f"need at least one rank, got {world}")
    if backend == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if world > cards:
            raise RuntimeError(
                f"{world} ranks on the card need {world} CUDA devices, but "
                f"{cards} are available (NCCL runs one rank a card; use "
                "--device cpu for gloo ranks on the CPU)")


def _rank_main(rank: int, fn: Callable, world: int,
               mesh_shape: Sequence[int], backend: str,
               run_dir: str, args, axes: Sequence[str] = AXES) -> None:
    torch.set_num_threads(1)
    device_type = BACKEND_DEVICES[backend]
    if device_type == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"file://{run_dir}/store",
                            rank=rank, world_size=world,
                            timeout=COLLECTIVE_TIMEOUT)
    try:
        mesh = DeviceMesh(device_type,
                          torch.arange(world).reshape(tuple(mesh_shape)),
                          mesh_dim_names=tuple(axes))
        result = fn(mesh, *args) or {}
        np.savez(os.path.join(run_dir, f"rank{rank}.npz"), **result)
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, mesh_shape: Sequence[int],
              backend: str, tmpdir, *args, axes: Sequence[str] = AXES
              ) -> List[Dict[str, np.ndarray]]:
    """``fn(mesh, *args)`` on ``world`` spawned ranks of a mesh with dim
    names ``axes``; returns each rank's dict of numpy arrays, in rank
    order."""
    check_world(world, backend)
    if int(np.prod(mesh_shape)) != world:
        raise ValueError(f"mesh {tuple(mesh_shape)} does not hold {world} "
                         "ranks")
    if len(axes) != len(mesh_shape):
        raise ValueError(f"mesh {tuple(mesh_shape)} needs {len(mesh_shape)} "
                         f"dim names, got {tuple(axes)}")
    run_dir = tempfile.mkdtemp(prefix="ranks_", dir=str(tmpdir))
    mp.start_processes(_rank_main, args=(fn, world, mesh_shape, backend,
                                         run_dir, args, tuple(axes)),
                       nprocs=world, join=True, start_method="spawn")
    out = []
    for rank in range(world):
        with np.load(os.path.join(run_dir, f"rank{rank}.npz"),
                     allow_pickle=False) as f:
            out.append({k: f[k] for k in f.files})
    return out
