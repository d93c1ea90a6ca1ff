"""Gradient-based detector calibration driver of the PyTorch/CUDA port:

    python -m repro_torch.launch.fit --smoke       # fit gate: recover 2
                                                   # seeded params to < 5 %
    python -m repro_torch.launch.fit --gradcheck   # per-stage FD gradchecks
    python -m repro_torch.launch.fit --grad-smoke --devices N  # sharded
                                                   # gradient == one rank's
    python -m repro_torch.launch.fit --params electron_lifetime_us,recombination \\
                               [--steps N] [--lr LR] [--optimizer adam|bfgs] \\
                               [--events E] [--perturb F] [--tol T] \\
                               [--seed S] [--set key=value ...] [--device D]

Self-calibration throughout: targets are ADC waveforms of the default
(bit-exact, int16) graph at the config's true physics; the fit starts each
free parameter away from the truth (``--perturb``, or the smoke inits) and
descends the differentiable graph's loss with the targets' per-event keys,
so the loss is exactly zero at the truth and the minimiser recovers the
parameters instead of fitting noise. Runs on the card unless ``--device
cpu``. The exit status is the gate: 0 on success, 1 on a violation.

``--grad-smoke`` checks the loss gradient with the event batch split over
``--devices`` ranks (``repro_torch.testing.ranks``: NCCL, one card a rank,
or gloo on the CPU) against the one-rank gradient: each rank takes the
gradient of its events' share of the mean loss, ``all_reduce`` sums them,
and rank 0 also computes the gradient over every event.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.config import apply_overrides, get_config
from repro_torch.core import prng
from repro_torch.core.batch import PhysicalEventBatch
from repro_torch.core.distributed import (backend_for, flat_index,
                                          mesh_device, num_shards)
from repro_torch.core.fit import (FitParam, FitSpec, FitTargets, calibrate,
                                  make_fit_loss, make_fit_targets,
                                  value_and_grad)
from repro_torch.core.gradcheck import stage_gradcheck_suite
from repro_torch.device import resolve_device
from repro_torch.testing.ranks import check_world, run_ranks

#: the --smoke scenario: seeded truth, deliberately wrong starting points
SMOKE_TRUTH = {"electron_lifetime_us": 60.0, "recombination": 0.75}
SMOKE_INITS = {"electron_lifetime_us": 150.0, "recombination": 0.5}
SMOKE_BOUNDS = {"electron_lifetime_us": (5.0, 500.0),
                "recombination": (0.2, 1.0)}


def _overrides(cfg, overrides):
    if overrides:
        cfg = apply_overrides(cfg, dict(kv.split("=", 1) for kv in overrides))
    return cfg


def smoke_config(overrides=()):
    """The smoke truth config: seeded physics on the smoke grid, with
    deposits large enough that the ADC imprint of a few-percent parameter
    change clears the quantization."""
    cfg = get_config("lartpc-uboone", smoke=True)
    return _overrides(dataclasses.replace(cfg, electrons_per_depo=150_000.0,
                                          **SMOKE_TRUTH), overrides)


def _print_step(step, loss, values):
    vals = " ".join(f"{k}={v:.5g}" for k, v in values.items())
    print(f"  step {step:4d}  loss {loss:.6g}  {vals}", flush=True)


def run_smoke(args, device) -> int:
    """The fit gate: recover the seeded smoke parameters to < --tol."""
    cfg = smoke_config(args.set)
    t0 = time.time()
    targets = make_fit_targets(cfg, prng.key(args.seed),
                               num_events=args.events, device=device)
    spec = FitSpec(params=tuple(
        FitParam(name, init=SMOKE_INITS[name], lo=lo, hi=hi)
        for name, (lo, hi) in SMOKE_BOUNDS.items()))
    print(f"fit-smoke: {spec.n} free params over {args.events} events "
          f"({targets.batch.max_depos} depos each), optimizer "
          f"{args.optimizer}, {args.steps} steps, device {device}")
    res = calibrate(cfg, spec, targets, steps=args.steps, lr=args.lr,
                    optimizer=args.optimizer, log_every=args.log_every,
                    callback=_print_step, device=device)
    ok = True
    for name, err in res.relative_errors(SMOKE_TRUTH).items():
        line = (f"  {name:<22s} truth {SMOKE_TRUTH[name]:<10.5g} "
                f"fit {res.values[name]:<10.5g} rel_err {err:.3%}")
        if err > args.tol:
            line += f"  EXCEEDS tol {args.tol:.0%}"
            ok = False
        print(line)
    print(f"fit-smoke: loss {res.loss:.6g} after {res.steps} steps, "
          f"{time.time() - t0:.1f} s -> {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


def run_gradcheck(args, device) -> int:
    """Per-stage finite-difference gradient checks (the gradcheck gate)."""
    t0 = time.time()
    results = stage_gradcheck_suite(seed=args.seed, device=device)
    for r in results:
        print(r)
    n_fail = sum(not r.ok for r in results)
    print(f"gradcheck: {len(results) - n_fail}/{len(results)} ok, "
          f"{time.time() - t0:.1f} s, device {device}")
    return 0 if n_fail == 0 else 1


def grad_smoke_rank(mesh, overrides, events: int, seed: int):
    """One rank of ``--grad-smoke``: the gradient of this rank's events'
    share of the mean ADC loss, summed over the ranks; rank 0 adds the
    gradient over every event on its own."""
    dev = mesh_device(mesh)
    n, me = num_shards(mesh), flat_index(mesh)
    cfg = smoke_config(overrides)
    num_events = max(events, n)
    num_events -= num_events % n  # the event axis must split evenly
    targets = make_fit_targets(cfg, prng.key(seed), num_events=num_events,
                               device=dev)
    spec = FitSpec(params=(FitParam("electron_lifetime_us"),
                           FitParam("recombination")))
    theta0 = torch.tensor([50.0, 0.6], dtype=torch.float32, device=dev)
    k = num_events // n
    mine = slice(me * k, (me + 1) * k)
    part = FitTargets(
        batch=PhysicalEventBatch(*(x[mine] for x in targets.batch[:-1]),
                                 n_depos=targets.batch.n_depos[mine]),
        keys=targets.keys[mine], adc=targets.adc[mine])
    loss_mine = make_fit_loss(cfg, spec, part, device=dev)
    _, grad = value_and_grad(lambda th: loss_mine(th) * (k / num_events),
                             theta0)
    dist.all_reduce(grad)
    out = {"sharded": grad.cpu().numpy(), "events": np.asarray(num_events)}
    if me == 0:
        _, single = value_and_grad(make_fit_loss(cfg, spec, targets,
                                                 device=dev), theta0)
        out["single"] = single.cpu().numpy()
    return out


def run_grad_smoke(args) -> int:
    """The sharded gradient against the one-rank gradient (gate: rel <
    1e-3)."""
    backend = backend_for(args.device)
    check_world(args.devices, backend)
    with tempfile.TemporaryDirectory(prefix="repro_torch_grad_") as tmp:
        res = run_ranks(grad_smoke_rank, args.devices, (args.devices, 1),
                        backend, tmp, args.set, args.events, args.seed)[0]
    single, sharded = res["single"], res["sharded"]
    diff = float(np.max(np.abs(single - sharded)))
    rel = diff / (float(np.max(np.abs(single))) + 1e-12)
    print(f"grad-smoke: {int(res['events'])} events over {args.devices} "
          f"{backend} ranks ({args.device})")
    print(f"  single-rank grad {[float(x) for x in single]}")
    print(f"  sharded grad     {[float(x) for x in sharded]}")
    print(f"  max abs diff {diff:.3e} (rel {rel:.3e})")
    ok = rel < 1e-3
    print(f"grad-smoke: {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


def run_fit(args, device) -> int:
    """General self-calibration: fit --params of the current config from
    inits at --perturb x truth."""
    cfg = _overrides(get_config("lartpc-uboone", smoke=True), args.set)
    names = [n for n in args.params.split(",") if n]
    truth = {n: float(getattr(cfg, n)) for n in names}
    params = []
    for n in names:
        v = truth[n]
        if v <= 0:
            raise SystemExit(
                f"--params {n}: current value {v} is not positive; seed a "
                f"truth with --set {n}=<value> to make it fittable")
        params.append(FitParam(n, init=v * args.perturb, lo=v / 8.0,
                               hi=v * 8.0))
    spec = FitSpec(params=tuple(params))
    targets = make_fit_targets(cfg, prng.key(args.seed),
                               num_events=args.events, device=device)
    print(f"fit: {names} from {args.perturb}x truth over {args.events} "
          f"events, device {device}")
    res = calibrate(cfg, spec, targets, steps=args.steps, lr=args.lr,
                    optimizer=args.optimizer, log_every=args.log_every,
                    callback=_print_step, device=device)
    ok = True
    for name, err in res.relative_errors(truth).items():
        print(f"  {name:<22s} truth {truth[name]:<10.5g} "
              f"fit {res.values[name]:<10.5g} rel_err {err:.3%}")
        ok = ok and err <= args.tol
    print(f"fit: loss {res.loss:.6g} -> {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="gradient-based detector calibration")
    ap.add_argument("--smoke", action="store_true",
                    help="fit gate: recover the seeded smoke parameters")
    ap.add_argument("--gradcheck", action="store_true",
                    help="run the per-stage FD gradient checks")
    ap.add_argument("--grad-smoke", action="store_true",
                    help="sharded-vs-one-rank gradient agreement")
    ap.add_argument("--devices", type=int, default=2,
                    help="ranks for --grad-smoke (one card a rank on cuda)")
    ap.add_argument("--params", default="electron_lifetime_us,recombination",
                    help="comma-separated config fields to fit")
    ap.add_argument("--events", type=int, default=2)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--lr", type=float, default=0.2)
    ap.add_argument("--optimizer", choices=["adam", "bfgs"], default="adam")
    ap.add_argument("--perturb", type=float, default=1.5,
                    help="start each param at perturb x truth")
    ap.add_argument("--tol", type=float, default=0.05,
                    help="max relative recovery error")
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--set", nargs="*", default=[],
                    help="config overrides key=value")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no silent fallback")
    args = ap.parse_args(argv)

    if args.grad_smoke:
        return run_grad_smoke(args)
    device = resolve_device(args.device)
    if args.gradcheck:
        return run_gradcheck(args, device)
    if args.smoke:
        return run_smoke(args, device)
    return run_fit(args, device)


if __name__ == "__main__":
    sys.exit(main())
