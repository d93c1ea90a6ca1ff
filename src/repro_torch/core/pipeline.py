"""The fig4 executor and the registered ``charge_grid`` strategies.

fig4 is the batched, device-resident pipeline of the paper: every depo of
the event goes through one chain of device work (drift, charge grid,
convolve, noise, digitize), with one upload of the depos and the ADC grid
left on the device. The chain itself is ``repro_torch.core.stages``.

Charge-grid strategies (each returns ``(grid, dropped)``):

  unfused              : rasterize -> threefry fluctuation -> window scatter
  fused_pallas         : the fused CUDA kernel over the dense tile grid
  fused_pallas_compact : the fused CUDA kernel over occupied tiles only

The fused names keep the reference's strategy names, so one config selects
the same path in both packages.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import LArTPCConfig
from repro_torch.core import fluctuate as fl
from repro_torch.core.depo import DepoSet
from repro_torch.core.rasterize import rasterize
from repro_torch.core.response import DetectorResponse
from repro_torch.core.scatter import scatter_add
from repro_torch.core.stages import SimOutput, build_sim_graph
from repro_torch.tune.registry import register_strategy, set_default

__all__ = ["SimOutput", "simulate_fig4", "make_sim_fn", "simulate",
           "charge_grid_unfused", "charge_grid_fused",
           "charge_grid_fused_compact"]


def _no_drops(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int64, device=device)


@register_strategy("charge_grid", "unfused",
                   note="rasterize -> fluctuate -> scatter_add")
def charge_grid_unfused(k: torch.Tensor, depos: DepoSet, cfg: LArTPCConfig):
    patches, w0, t0 = rasterize(depos, cfg)
    if cfg.fluctuate and cfg.rng_strategy == "counter":
        patches = fl.fluctuate_counter(k, patches, depos.charge)
    return scatter_add(patches, w0, t0, cfg), _no_drops(patches.device)


def _fused_key(k: torch.Tensor, cfg: LArTPCConfig) -> Optional[torch.Tensor]:
    """The in-kernel RNG key, or None when the config wants no fluctuation."""
    if cfg.fluctuate and cfg.rng_strategy == "counter":
        return k
    if cfg.fluctuate and cfg.rng_strategy in ("pool", "relaxed"):
        raise ValueError(
            "fused charge-grid strategies draw in-kernel counter randomness "
            "and cannot reproduce the pre-computed pool/relaxed streams; use "
            "rng_strategy='counter'/'none' or charge_grid_strategy='unfused'")
    return None


@register_strategy("charge_grid", "fused_pallas",
                   note="fused rasterize+fluctuate+scatter CUDA kernel",
                   differentiable=False)
def charge_grid_fused(k: torch.Tensor, depos: DepoSet, cfg: LArTPCConfig):
    from repro_torch.kernels.fused_sim.ops import simulate_charge_grid

    return simulate_charge_grid(depos, cfg, key=_fused_key(k, cfg))


@register_strategy("charge_grid", "fused_pallas_compact",
                   note="fused kernel over occupied tiles only",
                   differentiable=False)
def charge_grid_fused_compact(k: torch.Tensor, depos: DepoSet,
                              cfg: LArTPCConfig):
    from repro_torch.kernels.fused_sim.ops import simulate_charge_grid_compact

    return simulate_charge_grid_compact(depos, cfg, key=_fused_key(k, cfg))


set_default("charge_grid", "unfused")


def simulate_fig4(key: torch.Tensor, depos, resp=None,
                  cfg: Optional[LArTPCConfig] = None, add_noise: bool = True,
                  device="cuda") -> SimOutput:
    """One run of the canonical stage chain for one event. ``depos`` may be
    a detector-frame ``DepoSet`` or a ``PhysicalDepoSet``."""
    if cfg is None:
        raise TypeError("simulate_fig4() missing required argument: 'cfg'")
    return build_sim_graph(cfg, resp, add_noise=add_noise,
                           device=device).run(key, depos)


def make_sim_fn(cfg: LArTPCConfig, resp: Optional[DetectorResponse] = None,
                add_noise: bool = True, device="cuda"):
    """The single-event executor: a ``SimGraph`` called as
    ``sim(key, depos) -> SimOutput``, built once (response spectrum
    included) and reused for every event."""
    return build_sim_graph(cfg, resp, add_noise=add_noise, device=device)


def simulate(key: torch.Tensor, depos, cfg: LArTPCConfig, resp=None,
             add_noise: bool = True, device="cuda") -> SimOutput:
    return simulate_fig4(key, depos, resp, cfg, add_noise=add_noise,
                         device=device)
