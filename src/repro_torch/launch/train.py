"""Training launcher of the PyTorch/CUDA port:

    python -m repro_torch.launch.train --arch gemma2-2b --smoke --device cpu
    python -m repro_torch.launch.train --arch gemma2-2b --smoke   # card

Resolves the arch config, applies ``--set`` overrides and runs the
fault-tolerant ``Trainer``, the counterpart of the reference's
``repro.launch.train``: the same flags, plus ``--device`` (default
``cuda``; raises without a card instead of falling back). ``--ckpt-dir``
defaults to ``config.default_ckpt_dir()`` (under ``TMPDIR``), and a run
resumes from the latest checkpoint there. ``--mesh`` is refused: the
parallel layer is ROADMAP item 17(d).
"""
from __future__ import annotations

import argparse

from repro_torch.config import (CheckpointConfig, OptimizerConfig, SHAPES,
                                ShapeConfig, TrainConfig, apply_overrides,
                                default_ckpt_dir, get_config, list_archs)
from repro_torch.device import resolve_device
from repro_torch.train.trainer import Trainer, TrainResult


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
                    help="refused: the parallel layer is ROADMAP item 17(d)")
    ap.add_argument("--set", nargs="*", default=[],
                    help="config overrides key=value")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs on the host)")
    return ap


def main(argv=None) -> TrainResult:
    args = build_parser().parse_args(argv)
    if args.mesh:
        raise ValueError(f"--mesh {args.mesh}: the port's parallel layer "
                         "(meshes, sharded parameters) is ROADMAP item "
                         "17(d), not ported yet")
    device = resolve_device(args.device)
    model_cfg = get_config(args.arch, smoke=args.smoke)
    if model_cfg.family == "lartpc":
        raise SystemExit("use repro_torch.launch.sim for the lartpc workload")
    overrides = dict(kv.split("=", 1) for kv in args.set)
    if overrides:
        model_cfg = apply_overrides(model_cfg, overrides)

    shape = (SHAPES[args.shape] if args.shape
             else ShapeConfig("cli", "train", args.seq, args.batch))
    cfg = TrainConfig(
        model=model_cfg, shape=shape,
        optimizer=OptimizerConfig(total_steps=args.steps),
        checkpoint=CheckpointConfig(
            directory=args.ckpt_dir or default_ckpt_dir()),
    )
    result = Trainer(cfg, device).run(max_steps=args.steps)
    print(f"done: {result.steps_run} steps, final loss "
          f"{result.losses[-1]:.4f}, stragglers {result.straggler_steps}")
    return result


if __name__ == "__main__":
    main()
