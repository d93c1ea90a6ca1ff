"""Multi-rank LArTPC simulation of the PyTorch/CUDA port: depo-parallel
rasterisation, a reduce-scatter (or halo) scatter-add and the
pencil-decomposed FFT, the distributed executor of the same stage graph the
single-event and batched paths run (``repro_torch.core.distributed``):

    python -m repro_torch.launch.distributed --devices N [--smoke]
        [--planes 3] [--recon] [--scatter-reduction psum_scatter|halo]
        [--device cuda|cpu]

The launcher starts its own N ranks (``repro_torch.testing.ranks``): NCCL
with one card a rank on ``--device cuda`` (the default; more ranks than
cards raise), gloo on the CPU with ``--device cpu``. The mesh is (N // 2,
2) for even N, else (N, 1). Every rank draws the same event from key 0
(detector-frame depos on one plane, physical depos on several, or
pre-drifted per-plane depos for three-plane ``halo``), takes its block and
runs the event; the outputs are gathered and rank 0's copy is reported:
one line per plane and ``OK``. ``--scatter-reduction halo`` bins the depos
by wire strip over the mesh's first axis (``bin_depos_by_wire``); on three
planes it runs with stacked plane batching and per-plane binning.
``--recon`` adds the pencil-FFT deconvolution and the per-shard hit scan.
The exit status is non-zero when a rank fails or a plane reads empty.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import tempfile
from typing import Dict

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import interop
from repro_torch.config import LArTPCConfig
from repro_torch.core import prng
from repro_torch.core.depo import (generate_depos, generate_physical_depos,
                                   generate_plane_depos)
from repro_torch.core.distributed import (AXES, backend_for, bin_depos_by_wire,
                                          gather_outputs, make_distributed_sim,
                                          mesh_device, num_shards,
                                          padded_grid_shape, shard_depos)
from repro_torch.core.response import (make_distributed_plane_responses,
                                       make_distributed_response)
from repro_torch.core.stages import SimOutput
from repro_torch.testing.ranks import check_world, run_ranks


def mesh_shape(n: int):
    """The launcher's (data, model) mesh of ``n`` ranks."""
    return (n // 2, 2) if n % 2 == 0 else (n, 1)


def launcher_config(smoke: bool, planes: int) -> LArTPCConfig:
    """The reference example's configs: smoke 128 x 512 with 512 depos,
    else 256 x 1024 with 4096."""
    if smoke:
        cfg = LArTPCConfig(num_wires=128, num_ticks=512, num_depos=512,
                           response_wires=11, response_ticks=64)
    else:
        cfg = LArTPCConfig(num_wires=256, num_ticks=1024, num_depos=4096,
                           response_wires=11, response_ticks=64)
    return dataclasses.replace(cfg, num_planes=planes)


def event_inputs(mesh, cfg: LArTPCConfig, depos,
                 scatter_reduction: str = "psum_scatter"):
    """(the responses at the distributed grid of ``mesh``, this rank's block
    of the whole event's ``depos``), the depos first binned by wire strip
    over the mesh's first axis for ``halo``."""
    nshards = num_shards(mesh)
    if scatter_reduction == "halo":
        nshards = max(nshards, mesh.size(0))
    w_pad = padded_grid_shape(cfg, nshards)[0]
    dev = mesh_device(mesh)
    if scatter_reduction == "halo":
        depos = bin_depos_by_wire(depos, mesh.size(0), w_pad)
    resp = (make_distributed_plane_responses(cfg, w_pad, device=dev)
            if cfg.num_planes > 1
            else make_distributed_response(cfg, w_pad, device=dev))
    return resp, shard_depos(depos, mesh)


def distributed_event(mesh, cfg: LArTPCConfig, key: torch.Tensor, depos,
                      scatter_reduction: str = "psum_scatter",
                      add_noise: bool = True,
                      recon: bool = False) -> SimOutput:
    """One event on ``mesh`` from the whole event's ``depos`` (the same on
    every rank): this rank's block run, the outputs gathered onto every
    rank."""
    resp, block = event_inputs(mesh, cfg, depos, scatter_reduction)
    sim = make_distributed_sim(mesh, cfg, resp,
                               scatter_reduction=scatter_reduction,
                               add_noise=add_noise, recon=recon)
    return gather_outputs(sim(key, block), mesh)


def event_depos(cfg: LArTPCConfig, key: torch.Tensor,
                scatter_reduction: str, device):
    """The launcher's event: detector-frame depos on one plane; physical
    depos on several, or pre-drifted per-plane depos for ``halo``."""
    if cfg.num_planes == 1:
        return generate_depos(key, cfg, device=device)
    if scatter_reduction == "halo":
        return generate_plane_depos(key, cfg, device=device)
    return generate_physical_depos(key, cfg, device=device)


def launcher_rank(mesh, cfg: LArTPCConfig, scatter_reduction: str,
                  recon: bool) -> Dict[str, np.ndarray]:
    """The launcher's work on one rank: rank 0 returns the gathered ADC
    (and hits)."""
    key = prng.key(0)
    depos = event_depos(cfg, key, scatter_reduction, mesh_device(mesh))
    out = distributed_event(mesh, cfg, key, depos, scatter_reduction,
                            recon=recon)
    if torch.distributed.get_rank() != 0:
        return {}
    arrays = interop.to_numpy(out)
    return {k: v for k, v in arrays.items()
            if k == "adc" or k.startswith("hits.")}


def run_cases(mesh, cases) -> Dict[str, np.ndarray]:
    """Several events on one group, each a dict: ``name``, ``cfg``,
    ``key`` (key data), ``depos`` (``(kind, arrays)``, kind "detector",
    "physical" or "planes": (P, N) pre-drifted), ``scatter_reduction``,
    ``add_noise``, ``recon`` and ``mesh`` (a (data, model) shape on the
    group's first ranks; None: the whole ``mesh``). Rank 0 returns every
    case's gathered outputs as ``<name>/<field>``."""
    dev = mesh_device(mesh)
    results = {}
    for case in cases:
        sub = mesh
        if case.get("mesh") is not None:
            shape = tuple(case["mesh"])
            sub = DeviceMesh(mesh.device_type,
                             torch.arange(int(np.prod(shape))).reshape(shape),
                             mesh_dim_names=AXES)
            if torch.distributed.get_rank() >= int(np.prod(shape)):
                continue
        kind, arrays = case["depos"]
        make = (interop.physical_depos_from_numpy if kind == "physical"
                else interop.depos_from_numpy)
        depos = make(*arrays, device=dev)
        out = distributed_event(sub, case["cfg"],
                                interop.key_from_data(case["key"]), depos,
                                case["scatter_reduction"], case["add_noise"],
                                case["recon"])
        if torch.distributed.get_rank() == 0:
            results.update({f"{case['name']}/{k}": v for k, v in
                            interop.to_numpy(out).items()})
    return results


def report(out: Dict[str, np.ndarray], cfg: LArTPCConfig) -> bool:
    """Print the per-plane lines of a gathered event; False when a plane
    reads empty or recon stored no hit."""
    ok = True
    if "hits.mask" in out:
        mask = out["hits.mask"]
        stored, found = int(mask.sum()), int(out["hits.n_hits"].sum())
        if stored:
            wires = out["hits.wire"][mask]
            print(f"hits: {stored} stored / {found} found (wires "
                  f"{int(wires.min())}..{int(wires.max())})")
        else:
            print("hits: none")
            ok = False
    adc = out["adc"][..., :cfg.num_wires, :]
    for p, plane in enumerate(adc.reshape((-1,) + adc.shape[-2:])):
        dev = np.abs(plane.astype(np.int32) - int(cfg.adc_baseline))
        hit = int((dev > 5).sum())
        print(f"plane {p}: signal deviation max {int(dev.max())} counts; "
              f"{hit} hit pixels")
        ok = ok and hit > 0
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="multi-rank LArTPC simulation")
    ap.add_argument("--devices", type=int, default=8,
                    help="ranks: one a card on cuda, gloo processes on cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="small grid and depo count")
    ap.add_argument("--planes", type=int, default=1,
                    help="readout planes (1, or 3 for U/V/W)")
    ap.add_argument("--recon", action="store_true",
                    help="also deconvolve and find hits, per shard")
    ap.add_argument("--scatter-reduction", default="psum_scatter",
                    choices=["psum_scatter", "halo"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default, NCCL) or cpu (gloo); no fallback")
    args = ap.parse_args(argv)

    backend = backend_for(args.device)
    check_world(args.devices, backend)
    cfg = launcher_config(args.smoke, args.planes)
    shape = mesh_shape(args.devices)
    print(f"mesh: {{'data': {shape[0]}, 'model': {shape[1]}}} over "
          f"{args.devices} {backend} ranks ({args.device})", flush=True)
    with tempfile.TemporaryDirectory(prefix="repro_torch_dist_") as tmp:
        out = run_ranks(launcher_rank, args.devices, shape, backend, tmp,
                        cfg, args.scatter_reduction, args.recon)[0]
    print(f"ADC out: {out['adc'].shape} {out['adc'].dtype}, gathered from "
          f"{args.devices} wire shards")
    if not report(out, cfg):
        print("FAILED: an empty readout plane or no hits")
        return 1
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
