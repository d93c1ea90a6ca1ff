"""LArTPC simulation launcher of the PyTorch/CUDA port:

    python -m repro_torch.launch.sim [--smoke] [--events N] [--depos N]
                                     [--planes P] [--seed S] [--recon]
                                     [--device cuda|cpu]
                                     [--set key=value ...]

Each event ``ev`` uses the key ``fold_in(key(seed), ev)`` and the depos
``generate_depos`` draws from it, as the reference launcher does, and runs
as one launch of the fig4 chain. Multi-plane configs (``--planes 3``: the
MicroBooNE U, V and Y planes) hand the event's physical depos to the graph,
whose drift stage projects them onto every plane. ``--recon`` appends the
deconvolve and hit_find stages, and each event (and each plane) reports the
hits stored and the runs found. Prints one ``event N: ...`` line per event,
naming the dtype of the patches the charge grid rasterises (``--set
charge_grid_strategy=unfused_bf16``: bfloat16), and one line per plane of
it, and a ``total:`` line. Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import torch

from repro_torch.config import (LArTPCConfig, apply_overrides, get_config,
                                plane_specs)
from repro_torch.core import prng
from repro_torch.core.depo import generate_depos, generate_physical_depos
from repro_torch.core.pipeline import make_sim_fn
from repro_torch.device import resolve_device


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_events(cfg: LArTPCConfig, num_events: int, seed: int = 0,
               device="cuda", sim=None,
               on_event: Optional[Callable] = None) -> dict:
    """Simulate ``num_events`` events, one launch each.

    ``on_event(ev, out, seconds)`` sees every event's ``SimOutput``. Raises
    if the charge-grid binning dropped any (depo, tile) entry. Returns
    {"events", "depos", "wall_s", "event_s": [...]}; ``depos`` counts each
    event's depos once, whatever the number of planes; ``wall_s`` includes
    depo generation, ``event_s`` is the simulation alone (for multi-plane
    configs it includes the drift onto the planes).
    """
    dev = resolve_device(device)
    sim = sim if sim is not None else make_sim_fn(cfg, device=dev)
    generate = (generate_physical_depos if cfg.num_planes > 1
                else generate_depos)
    base = prng.key(seed)
    stats = {"events": 0, "depos": 0, "wall_s": 0.0, "event_s": []}
    t_start = time.perf_counter()
    for ev in range(num_events):
        k = prng.fold_in(base, ev)
        depos = generate(k, cfg, device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        out = sim(k, depos)
        _sync(dev)
        dt = time.perf_counter() - t0
        dropped = int(out.dropped) if out.dropped is not None else 0
        if dropped:
            raise RuntimeError(f"event {ev}: the tile binning dropped "
                               f"{dropped} (depo, tile) entries; raise k_max")
        stats["events"] += 1
        stats["depos"] += depos.n
        stats["event_s"].append(dt)
        if on_event is not None:
            on_event(ev, out, dt)
    stats["wall_s"] = time.perf_counter() - t_start
    return stats


def patch_dtype_name(cfg: LArTPCConfig) -> str:
    """The dtype of the patches the config's charge-grid strategy
    rasterises: bfloat16 for ``unfused_bf16``, float32 for the fused
    kernels (which ignore ``patch_dtype``), else ``cfg.patch_dtype``."""
    name = cfg.charge_grid_strategy
    if name == "unfused_bf16":
        return "bfloat16"
    return "float32" if name.startswith("fused") else cfg.patch_dtype


def max_dev(adc: torch.Tensor, cfg: LArTPCConfig) -> int:
    """Largest |ADC - baseline| of an event."""
    return int((adc.to(torch.int32) - int(cfg.adc_baseline)).abs().max())


def hit_counts(hits, plane: Optional[int] = None):
    """(stored, found) hits of a HitSet: of one plane of a multi-plane
    HitSet, or summed over its planes."""
    mask, found = hits.mask, hits.n_hits
    if plane is not None:
        mask, found = mask[plane], found[plane]
    return int(mask.sum()), int(found.sum())


def hit_text(hits, plane: Optional[int] = None) -> str:
    """``", S hits stored, F found"`` for a recon output, else ``""``."""
    if hits is None:
        return ""
    stored, found = hit_counts(hits, plane)
    return f", {stored} hits stored, {found} found"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--events", type=int, default=2)
    ap.add_argument("--depos", type=int, default=0)
    ap.add_argument("--planes", type=int, default=0,
                    help="readout planes per event (3: U, V, Y)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--recon", action="store_true",
                    help="append the deconvolve + hit_find recon stages")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no silent fallback")
    ap.add_argument("--set", nargs="*", default=[])
    args = ap.parse_args(argv)

    cfg = get_config("lartpc-uboone", smoke=args.smoke)
    if args.depos:
        cfg = apply_overrides(cfg, {"num_depos": args.depos})
    if args.planes:
        cfg = apply_overrides(cfg, {"num_planes": args.planes})
    if args.set:
        cfg = apply_overrides(cfg, dict(kv.split("=", 1) for kv in args.set))

    patches = patch_dtype_name(cfg)

    def report(ev, out, dt):
        n = cfg.num_depos
        if cfg.num_planes == 1:
            print(f"event {ev}: {n} depos -> {tuple(out.adc.shape)} ADC in "
                  f"{dt*1e3:.0f} ms ({n/dt:.3g} depos/s), "
                  f"max dev {max_dev(out.adc, cfg)}, patches {patches}"
                  f"{hit_text(out.hits)}")
            return
        print(f"event {ev}: {n} depos x {cfg.num_planes} planes -> "
              f"{tuple(out.adc.shape)} ADC in {dt*1e3:.0f} ms "
              f"({n * cfg.num_planes / dt:.3g} plane-depos/s), patches "
              f"{patches}, dropped {int(out.dropped)}{hit_text(out.hits)}")
        for spec in plane_specs(cfg):
            print(f"event {ev} plane {spec.index} ({spec.kind}, "
                  f"{spec.angle_deg:g} deg): max dev "
                  f"{max_dev(out.adc[spec.index], cfg)}"
                  f"{hit_text(out.hits, spec.index)}")

    device = resolve_device(args.device)
    sim = make_sim_fn(cfg, device=device, recon=args.recon)
    stats = run_events(cfg, args.events, seed=args.seed, device=device,
                       sim=sim, on_event=report)
    ev_s = stats["events"] / stats["wall_s"]
    dp_s = stats["depos"] / stats["wall_s"]
    print(f"total: {stats['events']} events / {stats['depos']} depos in "
          f"{stats['wall_s']:.2f} s ({ev_s:.3g} events/s, {dp_s:.3g} depos/s)")


if __name__ == "__main__":
    main()
