"""Drift/transport: physical depos -> detector-frame depos (single plane).

``PhysicalDepoSet`` uses the anode drift frame of the reference: ``x`` is
the drift time to the readout plane [us], ``y`` the transverse position in
wire-pitch units, ``z`` the along-wire position [mm] (unused by one plane),
``t`` the deposition time [us] and ``q`` the ionisation electrons.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.config import LArTPCConfig
from repro_torch.core.depo import DepoSet
from repro_torch.tune.registry import register_strategy, resolve, set_default


class PhysicalDepoSet(NamedTuple):
    """Structure-of-arrays physical depo container (float32, shape (N,))."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    t: torch.Tensor
    q: torch.Tensor

    @property
    def n(self) -> int:
        return self.x.shape[-1]

    def to(self, device) -> "PhysicalDepoSet":
        return PhysicalDepoSet(*(x.to(device) for x in self))


@register_strategy("drift", "jnp",
                   note="vectorised diffusion/attenuation/recombination")
def drift_depos(pdepos: PhysicalDepoSet, cfg: LArTPCConfig) -> DepoSet:
    """Transport physical depos to the readout plane: arrival tick, widths
    growing like sqrt(drift time) with floors and the patch clip, charge
    scaled by recombination and (when enabled) lifetime attenuation."""
    t_drift = pdepos.x
    tick = (pdepos.t + t_drift) / cfg.tick_us
    wire = pdepos.y

    sigma_t = torch.sqrt(2.0 * cfg.diffusion_long * t_drift) / (
        cfg.drift_speed_mm_us * cfg.tick_us
    ) * cfg.diffusion_scale + cfg.sigma_t_floor
    sigma_w = torch.sqrt(2.0 * cfg.diffusion_tran * t_drift) / (
        cfg.wire_pitch_mm) * cfg.diffusion_scale + cfg.sigma_w_floor
    sigma_w = torch.clamp(sigma_w, min(0.3, cfg.sigma_w_floor),
                          (cfg.patch_wires / 2 - 1) / cfg.nsigma)
    sigma_t = torch.clamp(sigma_t, min(0.3, cfg.sigma_t_floor),
                          (cfg.patch_ticks / 2 - 1) / cfg.nsigma)

    q = pdepos.q * cfg.recombination
    if cfg.electron_lifetime_us > 0.0:
        q = q * torch.exp(-t_drift / cfg.electron_lifetime_us)

    return DepoSet(wire=wire, tick=tick, sigma_w=sigma_w, sigma_t=sigma_t,
                   charge=q)


set_default("drift", "jnp")


def transport(pdepos: PhysicalDepoSet, cfg: LArTPCConfig) -> DepoSet:
    """Dispatch physical depos -> detector depos through the registry."""
    if cfg.num_planes != 1:
        raise NotImplementedError(
            "the port transports single-plane configs only (num_planes=1)")
    return resolve("drift", cfg.drift_strategy).fn(pdepos, cfg)
