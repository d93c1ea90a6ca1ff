"""Fault-tolerant training loop, as the reference's
``src/repro/train/trainer.py``.

* auto-resume from the latest checkpoint (params, optimizer, data position)
* periodic async checkpoints, atomic publish, keep-N
* preemption handling: SIGTERM triggers a final checkpoint before exit
* straggler mitigation: a per-step wall-clock deadline; steps that exceed
  it are counted
* one host read a step: the loss
* elastic: with a mesh, the step is ``launch.specs.build_train``'s, the
  parameters and optimizer state are placed by its shardings (each rank
  holds its blocks), batches come as each rank's share (placed for the
  step's microbatches), checkpoints hold
  full arrays and a restore re-shards onto the current mesh, whatever its
  size; only rank 0 prints and writes

The parameters are drawn from ``cfg.seed`` through the port's threefry
(``prng.key``), the reference's parameters, whole on every rank before
they are placed.
"""
from __future__ import annotations

import contextlib
import signal
import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch.distributed as dist

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.config import TrainConfig
from repro_torch.core import prng
from repro_torch.core.distributed import mesh_device
from repro_torch.data.tokens import DataPipeline
from repro_torch.models.model import Model
from repro_torch.optim.adamw import init_opt_state
from repro_torch.parallel.fsdp import mark_tree, place
from repro_torch.parallel.sharding import (act_rules_for, current_mesh,
                                           use_mesh)
from repro_torch.train.train_step import make_train_step


@dataclass
class TrainResult:
    steps_run: int
    final_step: int
    losses: List[float] = field(default_factory=list)
    straggler_steps: int = 0
    resumed_from: Optional[int] = None


class Trainer:
    def __init__(self, cfg: TrainConfig, device="cuda", mesh=None,
                 param_shardings=None):
        self.cfg = cfg
        self.mesh = mesh
        self.param_shardings = param_shardings
        self.model = Model(cfg.model, device if mesh is None
                           else mesh_device(mesh))
        self.ckpt = CheckpointManager(cfg.checkpoint.directory,
                                      keep=cfg.checkpoint.keep,
                                      async_save=cfg.checkpoint.async_save)
        self._preempted = False

    def _install_signal_handler(self):
        def handler(signum, frame):
            self._preempted = True

        try:
            signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass  # not on main thread (tests)

    def run(self, max_steps: Optional[int] = None) -> TrainResult:
        mesh = self.mesh
        if mesh is None or current_mesh() is mesh:
            ctx = contextlib.nullcontext()
        else:
            ctx = use_mesh(mesh, act_rules_for(self.cfg.model, mesh))
        with ctx:
            return self._run(max_steps)

    def _load(self, params, shardings):
        """Register ``params`` on the model as trainable leaves (marked
        with ``shardings`` under a mesh)."""
        params = self.model.load_params(params, trainable=True)
        return params if shardings is None else mark_tree(params, shardings)

    def _run(self, max_steps: Optional[int]) -> TrainResult:
        from repro_torch.launch.specs import build_train

        cfg = self.cfg
        self._install_signal_handler()
        mesh = self.mesh
        params = self.model.init(prng.key(cfg.seed), trainable=True)
        opt_state = init_opt_state(params)
        shardings = None
        if mesh is not None:
            step_fn, _, (psh, osh, _), _ = build_train(
                cfg.model, cfg.shape, mesh, cfg.optimizer, cfg.parallel)
            psh = self.param_shardings or psh
            shardings = {"params": psh, "opt": osh}
            params = self._load(place(params, psh), psh)
            opt_state = place(opt_state, osh)
        else:
            step_fn = make_train_step(self.model, cfg.optimizer,
                                      cfg.parallel)
        start_step = 0
        resumed_from = None

        latest = self.ckpt.latest_step()
        if latest is not None:
            restored, extra = self.ckpt.restore(
                latest, {"params": params, "opt": opt_state}, shardings)
            params = self._load(restored["params"],
                                shardings and shardings["params"])
            opt_state = restored["opt"]
            start_step = int(extra.get("step", latest))
            resumed_from = latest

        pipeline = DataPipeline(cfg.model, cfg.shape, seed=cfg.seed,
                                start_step=start_step,
                                device=self.model.device, mesh=mesh,
                                microbatches=cfg.parallel.microbatches)
        rank0 = not dist.is_initialized() or dist.get_rank() == 0

        total = max_steps if max_steps is not None else cfg.optimizer.total_steps
        losses: List[float] = []
        stragglers = 0
        step = start_step
        try:
            while step < total:
                batch = next(pipeline)
                t0 = time.monotonic()
                params, opt_state, metrics = step_fn(params, opt_state, batch)
                loss = float(metrics["loss"])   # the step's one host read
                dt = time.monotonic() - t0
                if cfg.straggler_deadline_s and dt > cfg.straggler_deadline_s:
                    stragglers += 1
                losses.append(loss)
                step += 1
                if step % cfg.log_every == 0 and rank0:
                    print(f"step {step} loss {loss:.4f} "
                          f"({dt*1e3:.0f} ms)", flush=True)
                if step % cfg.checkpoint.every_steps == 0 or self._preempted:
                    self.ckpt.save(step, {"params": params, "opt": opt_state},
                                   extra={"step": step,
                                          "data_state": pipeline.state()})
                if self._preempted:
                    break
        finally:
            pipeline.close()
            self.ckpt.wait()
        return TrainResult(steps_run=step - start_step, final_step=step,
                           losses=losses, straggler_steps=stragglers,
                           resumed_from=resumed_from)
