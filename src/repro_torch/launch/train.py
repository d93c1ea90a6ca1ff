"""Training launcher of the PyTorch/CUDA port:

    python -m repro_torch.launch.train --arch gemma2-2b --smoke --device cpu
    python -m repro_torch.launch.train --arch gemma2-2b --smoke   # card
    python -m repro_torch.launch.train --arch gemma2-2b --smoke --mesh 2x2 \\
        --device cpu                                # 4 gloo ranks

Resolves the arch config, applies ``--set`` overrides and runs the
fault-tolerant ``Trainer``, the counterpart of the reference's
``repro.launch.train``: the same flags, plus ``--device`` (default
``cuda``; raises without a card instead of falling back). ``--ckpt-dir``
defaults to ``config.default_ckpt_dir()`` (under ``TMPDIR``), and a run
resumes from the latest checkpoint there.

``--mesh DxM`` (or ``D``) trains on a ``(data, model)`` mesh of D*M ranks
that the launcher starts itself (``testing.ranks.run_ranks``): NCCL with
one card a rank on ``--device cuda`` (more ranks than cards raise; there
is no fallback to gloo), gloo ranks on ``--device cpu``. Every rank runs
the ``Trainer`` on the mesh; rank 0 prints. Any config trains on any
mesh: an MoE FFN routes over the whole batch however the mesh splits it,
as the reference's step does (``train.train_step``):

    python -m repro_torch.launch.train --arch deepseek-moe-16b --smoke \
        --mesh 4x2 --device cpu                     # 8 gloo ranks
"""
from __future__ import annotations

import argparse
import math
import tempfile

import numpy as np

from repro_torch.config import (CheckpointConfig, OptimizerConfig, SHAPES,
                                ShapeConfig, TrainConfig, apply_overrides,
                                default_ckpt_dir, get_config, list_archs)
from repro_torch.core.distributed import backend_for
from repro_torch.device import resolve_device
from repro_torch.testing.ranks import check_world, run_ranks
from repro_torch.train.trainer import Trainer, TrainResult

#: the mesh's dim names, in the reference launcher's order
MESH_AXES = ("data", "model")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=list(list_archs()))
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: repro_torch_ckpt "
                         "under the temp directory)")
    ap.add_argument("--mesh", default=None,
                    help="e.g. 4x2 -> (data=4, model=2) ranks")
    ap.add_argument("--set", nargs="*", default=[],
                    help="config overrides key=value")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs on the host)")
    return ap


def build_config(args) -> TrainConfig:
    model_cfg = get_config(args.arch, smoke=args.smoke)
    if model_cfg.family == "lartpc":
        raise SystemExit("use repro_torch.launch.sim for the lartpc workload")
    overrides = dict(kv.split("=", 1) for kv in args.set)
    if overrides:
        model_cfg = apply_overrides(model_cfg, overrides)
    shape = (SHAPES[args.shape] if args.shape
             else ShapeConfig("cli", "train", args.seq, args.batch))
    return TrainConfig(
        model=model_cfg, shape=shape,
        optimizer=OptimizerConfig(total_steps=args.steps),
        checkpoint=CheckpointConfig(
            directory=args.ckpt_dir or default_ckpt_dir()),
    )


def _done(result: TrainResult) -> None:
    print(f"done: {result.steps_run} steps, final loss "
          f"{result.losses[-1]:.4f}, stragglers {result.straggler_steps}")


def train_rank(mesh, args):
    """One rank of a ``--mesh`` run: the ``Trainer`` on ``mesh``; rank 0
    prints the ``done:`` line. Returns the run's numbers."""
    result = Trainer(build_config(args), mesh=mesh).run(max_steps=args.steps)
    if mesh.get_rank() == 0:
        _done(result)
    return {"steps_run": np.int64(result.steps_run),
            "final_step": np.int64(result.final_step),
            "losses": np.asarray(result.losses),
            "straggler_steps": np.int64(result.straggler_steps),
            "resumed_from": np.int64(-1 if result.resumed_from is None
                                     else result.resumed_from)}


def mesh_dims(spec: str):
    dims = tuple(int(x) for x in spec.split("x"))
    if not 1 <= len(dims) <= len(MESH_AXES) or min(dims) < 1:
        raise ValueError(f"--mesh {spec}: expected D or DxM")
    return dims


def main(argv=None) -> TrainResult:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if not args.mesh:
        result = Trainer(build_config(args), device).run(
            max_steps=args.steps)
        _done(result)
        return result
    build_config(args)    # refuse a bad config before any rank starts
    dims = mesh_dims(args.mesh)
    world, backend = math.prod(dims), backend_for(device)
    check_world(world, backend)
    with tempfile.TemporaryDirectory(prefix="train_ranks_") as tmp:
        out = run_ranks(train_rank, world, dims, backend, tmp, args,
                        axes=MESH_AXES[:len(dims)])[0]
    resumed = int(out["resumed_from"])
    return TrainResult(steps_run=int(out["steps_run"]),
                       final_step=int(out["final_step"]),
                       losses=[float(x) for x in out["losses"]],
                       straggler_steps=int(out["straggler_steps"]),
                       resumed_from=None if resumed < 0 else resumed)


if __name__ == "__main__":
    main()
