"""Energy depositions ("depos"): the input of the signal simulation.

``generate_physical_depos`` is the stand-in for Geant4 output: straight
tracks of correlated physical depos, drawn from the same threefry streams
as the reference generator. ``generate_depos`` adds the drift stage;
``generate_plane_depos`` drifts onto every readout plane, giving a
``DepoSet`` whose fields carry a leading plane axis (P, N).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.config import LArTPCConfig
from repro_torch.core import prng
from repro_torch.device import resolve_device


class DepoSet(NamedTuple):
    """Structure-of-arrays depo container (float32, shape (N,), or (P, N)
    with one row per readout plane).

    wire/tick: centre in wire-pitch / tick units; sigma_w/sigma_t: Gaussian
    widths in the same units; charge: mean ionisation electrons.
    """

    wire: torch.Tensor
    tick: torch.Tensor
    sigma_w: torch.Tensor
    sigma_t: torch.Tensor
    charge: torch.Tensor

    @property
    def n(self) -> int:
        return self.wire.shape[-1]

    def to(self, device) -> "DepoSet":
        return DepoSet(*(x.to(device) for x in self))


def generate_physical_depos(k: torch.Tensor, cfg: LArTPCConfig,
                            n: int | None = None, device="cuda"):
    """Synthetic cosmic-ray-like physical depos in the anode drift frame."""
    from repro_torch.core.drift import PhysicalDepoSet

    dev = resolve_device(device)
    n = n or cfg.num_depos
    n_tracks = max(1, n // 512)
    k1, k2, k3, k4, k5 = prng.split(k, 5)

    entry_w = prng.uniform(k1, (n_tracks,), 0.0, cfg.num_wires - 1.0, dev)
    entry_t = prng.uniform(k2, (n_tracks,), 0.0, cfg.num_ticks - 1.0, dev)
    theta = prng.uniform(k3, (n_tracks,), -1.2, 1.2, dev)

    per = n // n_tracks + 1
    s = torch.arange(per, dtype=torch.float32, device=dev)[None, :]
    wires = entry_w[:, None] + torch.sin(theta)[:, None] * s * 0.5
    ticks = entry_t[:, None] + torch.cos(theta)[:, None] * s * 2.0
    wires = torch.clamp(wires.reshape(-1)[:n].abs(), 0, cfg.num_wires - 1)
    ticks = torch.clamp(ticks.reshape(-1)[:n].abs(), 0, cfg.num_ticks - 1)

    # along-wire position z [mm]; read by the rotated planes
    k5a, k5b = prng.split(k5)
    z_extent = cfg.num_wires * cfg.wire_pitch_mm
    entry_z = prng.uniform(k5a, (n_tracks,), 0.0, z_extent, dev)
    dz = prng.uniform(k5b, (n_tracks,), -2.0, 2.0, dev)
    zs = (entry_z[:, None] + dz[:, None] * s).reshape(-1)[:n]
    zs = torch.clamp(zs.abs(), 0, z_extent)

    # long-tailed (lognormal) charge per depo
    charge = cfg.electrons_per_depo * torch.exp(0.3 * prng.normal(k4, (n,), dev))
    return PhysicalDepoSet(
        x=ticks * cfg.tick_us,                 # drift time [us]
        y=wires,                               # wire-pitch units
        z=zs,
        t=torch.zeros((n,), dtype=torch.float32, device=dev),
        q=charge,
    )


def generate_depos(k: torch.Tensor, cfg: LArTPCConfig, n: int | None = None,
                   device="cuda") -> DepoSet:
    """Physical depo generation + drift transport, as one DepoSet."""
    from repro_torch.core.drift import transport

    return transport(generate_physical_depos(k, cfg, n, device), cfg)


def generate_plane_depos(k: torch.Tensor, cfg: LArTPCConfig,
                         n: int | None = None, device="cuda") -> DepoSet:
    """Physical depo generation + multi-plane transport: one DepoSet with a
    leading plane axis (num_planes, N)."""
    from repro_torch.core.drift import transport_planes

    return transport_planes(generate_physical_depos(k, cfg, n, device), cfg)


def depo_patch_origin(depos: DepoSet, cfg: LArTPCConfig):
    """Integer (wire, tick) origin of each depo's patch, clipped to the grid
    (``torch.round`` rounds half to even, as ``jnp.round`` does)."""
    w0 = torch.round(depos.wire).to(torch.int32) - cfg.patch_wires // 2
    t0 = torch.round(depos.tick).to(torch.int32) - cfg.patch_ticks // 2
    w0 = torch.clamp(w0, 0, cfg.num_wires - cfg.patch_wires)
    t0 = torch.clamp(t0, 0, cfg.num_ticks - cfg.patch_ticks)
    return w0, t0
