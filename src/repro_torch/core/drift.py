"""Drift/transport: physical depos -> detector-frame depos, on one readout
plane (``transport``) or on every plane at once (``transport_planes``).

``PhysicalDepoSet`` uses the anode drift frame of the reference: ``x`` is
the drift time to the readout plane [us], ``y`` the transverse position in
wire-pitch units, ``z`` the along-wire position [mm] (read by rotated
planes), ``t`` the deposition time [us] and ``q`` the ionisation electrons.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.config import LArTPCConfig, PlaneSpec, plane_specs
from repro_torch.core.depo import DepoSet
from repro_torch.device import scalar
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
    tick = (pdepos.t + t_drift) / scalar(cfg.tick_us, t_drift)
    wire = pdepos.y

    sigma_t = torch.sqrt(2.0 * cfg.diffusion_long * t_drift) / scalar(
        cfg.drift_speed_mm_us * cfg.tick_us, t_drift
    ) * cfg.diffusion_scale + cfg.sigma_t_floor
    sigma_w = torch.sqrt(2.0 * cfg.diffusion_tran * t_drift) / scalar(
        cfg.wire_pitch_mm, t_drift) * cfg.diffusion_scale + cfg.sigma_w_floor
    sigma_w = torch.clamp(sigma_w, min(0.3, cfg.sigma_w_floor),
                          (cfg.patch_wires / 2 - 1) / cfg.nsigma)
    sigma_t = torch.clamp(sigma_t, min(0.3, cfg.sigma_t_floor),
                          (cfg.patch_ticks / 2 - 1) / cfg.nsigma)

    q = pdepos.q * cfg.recombination
    if cfg.electron_lifetime_us > 0.0:
        q = q * torch.exp(-t_drift / scalar(cfg.electron_lifetime_us,
                                            t_drift))

    return DepoSet(wire=wire, tick=tick, sigma_w=sigma_w, sigma_t=sigma_t,
                   charge=q)


set_default("drift", "jnp")


def transport(pdepos: PhysicalDepoSet, cfg: LArTPCConfig) -> DepoSet:
    """Dispatch physical depos -> detector depos through the registry."""
    return resolve("drift", cfg.drift_strategy).fn(pdepos, cfg)


def project_to_plane(pdepos: PhysicalDepoSet, spec: PlaneSpec,
                     cfg: LArTPCConfig) -> PhysicalDepoSet:
    """Project the transverse position onto one plane's pitch direction.

    A plane whose wires are rotated by ``spec.angle_deg`` from vertical
    indexes ``wire_p = y * cw + z * cz + off_p`` with
    ``cw = cos(angle) * wire_pitch_mm / pitch_p``, ``cz = sin(angle) /
    pitch_p``, and ``off_p`` centring the plane on the detector's
    transverse box (the reference's convention). The angle-0
    reference-pitch plane passes through untouched.
    """
    rad = math.radians(spec.angle_deg)
    cos_, sin_ = math.cos(rad), math.sin(rad)
    cw = cos_ * cfg.wire_pitch_mm / spec.pitch_mm
    cz = sin_ / spec.pitch_mm
    y_max = (cfg.num_wires - 1.0) * cfg.wire_pitch_mm
    z_max = cfg.num_wires * cfg.wire_pitch_mm
    lo = min(0.0, y_max * cos_) + min(0.0, z_max * sin_)
    hi = max(0.0, y_max * cos_) + max(0.0, z_max * sin_)
    off = (cfg.num_wires - 1.0) / 2.0 - (lo + hi) / (2.0 * spec.pitch_mm)
    if abs(off) < 1e-6:
        off = 0.0
    if cw == 1.0 and cz == 0.0 and off == 0.0:
        return pdepos
    # a float32 tensor times a Python float rounds the float to float32, as
    # the reference's jnp.float32 constants are
    y = pdepos.y * cw
    if cz != 0.0:
        y = y + pdepos.z * cz
    if off != 0.0:
        y = y + off
    return pdepos._replace(y=y)


def transport_planes(pdepos: PhysicalDepoSet, cfg: LArTPCConfig,
                     planes: Optional[Sequence[int]] = None) -> DepoSet:
    """Transport physical depos onto every readout plane (or the plane
    indices ``planes``) at once: a ``DepoSet`` with a leading plane axis
    (P, N). Per plane the transverse position is projected
    (``project_to_plane``) and the drift runs with that plane's pitch."""
    specs = plane_specs(cfg)
    if planes is not None:
        specs = tuple(specs[p] for p in planes)
    per_plane = [
        transport(project_to_plane(pdepos, spec, cfg),
                  dataclasses.replace(cfg, wire_pitch_mm=spec.pitch_mm))
        for spec in specs]
    return DepoSet(*(torch.stack(xs) for xs in zip(*per_plane)))
