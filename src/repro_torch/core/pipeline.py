"""The fig4 executor and the registered ``charge_grid`` strategies.

fig4 is the batched, device-resident pipeline of the paper: every depo of
the event goes through one chain of device work (drift, charge grid,
convolve, noise, digitize), with one upload of the depos and the ADC grid
left on the device. The chain itself is ``repro_torch.core.stages``.

Charge-grid strategies (each returns ``(grid, dropped)``):

  unfused              : rasterize -> threefry fluctuation -> scatter_add
                         (``cfg.scatter_strategy``: xla, sort_segment, or the
                         owner-computes CUDA kernels pallas, pallas_compact)
  unfused_bf16         : the same chain with bfloat16 patches
  fused_pallas         : the fused CUDA kernel over the dense tile grid
  fused_pallas_compact : the fused CUDA kernel over occupied tiles only

and for multi-plane configs, taking the full (P, N) depos of one event:

  fused_pallas_multiplane         : one fused launch for every plane
  fused_pallas_multiplane_compact : the same over occupied tiles only
  multiplane_xla                  : the planes as one flat depo batch,
                                    counter-hash fluctuation, one scatter

The names keep the reference's strategy names, so one config selects the
same path in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.config import LArTPCConfig, plane_specs
from repro_torch.core import fluctuate as fl
from repro_torch.core.depo import DepoSet
from repro_torch.core.rasterize import rasterize
from repro_torch.core.response import DetectorResponse
from repro_torch.core.scatter import scatter_add
from repro_torch.core.stages import SimOutput, build_sim_graph, \
    plane_fold_keys
from repro_torch.tune.registry import register_strategy, set_default

__all__ = ["SimOutput", "simulate_fig4", "make_sim_fn", "simulate",
           "charge_grid_unfused", "charge_grid_unfused_bf16",
           "charge_grid_fused",
           "charge_grid_fused_compact", "charge_grid_fused_multiplane",
           "charge_grid_fused_multiplane_compact",
           "charge_grid_multiplane_xla"]


@register_strategy("charge_grid", "unfused",
                   note="rasterize -> fluctuate -> scatter_add")
def charge_grid_unfused(k: torch.Tensor, depos: DepoSet, cfg: LArTPCConfig):
    patches, w0, t0 = rasterize(depos, cfg)
    if cfg.fluctuate and cfg.rng_strategy == "counter":
        patches = fl.fluctuate_counter(k, patches, depos.charge)
    return scatter_add(patches, w0, t0, cfg)


@register_strategy("charge_grid", "unfused_bf16",
                   note="unfused chain with bfloat16 patches (f32 accumulate)")
def charge_grid_unfused_bf16(k: torch.Tensor, depos: DepoSet,
                             cfg: LArTPCConfig):
    """``unfused`` with bfloat16 patches. With fluctuation on, the patches
    meet the float32 charge and reach the scatter as float32 (bfloat16
    means, bfloat16 normals), as in the reference; without it the scatter
    takes the bfloat16 patches and adds them in float32."""
    return charge_grid_unfused(
        k, depos, dataclasses.replace(cfg, patch_dtype="bfloat16"))


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


def _plane_grid_keys(k: torch.Tensor, cfg: LArTPCConfig):
    """Stacked per-plane in-kernel RNG subkeys ``fold_in(k, p)`` (P, 2), or
    None when the config wants no fluctuation."""
    if _fused_key(k, cfg) is None:
        return None
    return plane_fold_keys(k, plane_specs(cfg))


def _require_plane_axis(depos: DepoSet, cfg: LArTPCConfig) -> None:
    if depos.wire.ndim < 2 or depos.wire.shape[0] != cfg.num_planes:
        raise ValueError(
            "multi-plane charge_grid strategies take the FULL stacked "
            f"(num_planes={cfg.num_planes}, N) depos of one event (got "
            f"shape {tuple(depos.wire.shape)}); they are dispatched by the "
            "stacked plane-batching path, not per plane")


@register_strategy("charge_grid", "fused_pallas_multiplane",
                   note="one fused CUDA launch rasterises ALL planes",
                   differentiable=False)
def charge_grid_fused_multiplane(k: torch.Tensor, depos: DepoSet,
                                 cfg: LArTPCConfig):
    from repro_torch.kernels.fused_sim.ops import \
        simulate_charge_grid_multiplane

    _require_plane_axis(depos, cfg)
    return simulate_charge_grid_multiplane(depos, cfg,
                                           keys=_plane_grid_keys(k, cfg))


@register_strategy("charge_grid", "fused_pallas_multiplane_compact",
                   note="multi-plane fused kernel over occupied tiles only",
                   differentiable=False)
def charge_grid_fused_multiplane_compact(k: torch.Tensor, depos: DepoSet,
                                         cfg: LArTPCConfig):
    from repro_torch.kernels.fused_sim.ops import \
        simulate_charge_grid_multiplane_compact

    _require_plane_axis(depos, cfg)
    return simulate_charge_grid_multiplane_compact(
        depos, cfg, keys=_plane_grid_keys(k, cfg))


@register_strategy("charge_grid", "multiplane_xla",
                   note="plane-flattened chain; counter-hash fluctuation",
                   differentiable=False)
def charge_grid_multiplane_xla(k: torch.Tensor, depos: DepoSet,
                               cfg: LArTPCConfig):
    """All planes as ONE flat depo batch: rasterise (P*N) patches, draw
    counter-hash normals (seeded per plane from ``fold_in(k, p)``, streamed
    per plane-local depo, countered per patch pixel, one hash and an erfinv
    per draw), and land them with one scatter into a plane-major (P*W, T)
    grid. A different bit stream than ``unfused``."""
    from repro_torch.kernels.fused_sim.ref import C_DEPO

    _require_plane_axis(depos, cfg)
    n_planes, n = depos.wire.shape
    flat = DepoSet(*(x.reshape(n_planes * n) for x in depos))
    patches, w0, t0 = rasterize(flat, cfg)
    dev = patches.device
    keys = _plane_grid_keys(k, cfg)
    if keys is not None:
        seeds = keys.to(dev).repeat_interleave(n, dim=0)[:, :, None, None]
        d_id = torch.arange(n, device=dev).repeat(n_planes)
        stream = fl.mul32(d_id, C_DEPO)[:, None, None]
        pw, pt = patches.shape[1:]
        pix = (torch.arange(pw, device=dev)[:, None] * pt
               + torch.arange(pt, device=dev)[None, :])[None]
        normals = fl.counter_normals_erfinv(seeds[:, 0], seeds[:, 1], stream,
                                            pix)
        patches = fl.binomial_normal_approx(patches, flat.charge, normals)
    # plane-major wire offsets turn P scatters into one
    off = torch.arange(n_planes, dtype=w0.dtype,
                       device=dev).repeat_interleave(n) * cfg.num_wires
    tall = dataclasses.replace(cfg, num_wires=n_planes * cfg.num_wires)
    grid, dropped = scatter_add(patches, w0 + off, t0, tall, strategy="xla")
    return grid.reshape(n_planes, cfg.num_wires, cfg.num_ticks), dropped


set_default("charge_grid", "unfused")


def simulate_fig4(key: torch.Tensor, depos, resp=None,
                  cfg: Optional[LArTPCConfig] = None, add_noise: bool = True,
                  device="cuda", recon: bool = False) -> SimOutput:
    """One run of the canonical stage chain for one event. ``depos`` may be
    a detector-frame ``DepoSet`` (with a leading plane axis for multi-plane
    configs) or a ``PhysicalDepoSet``; ``resp`` one response, one per
    plane, or None for the config's defaults. ``recon=True`` appends the
    deconvolve and hit_find stages and fills ``SimOutput.decon``/``hits``."""
    if cfg is None:
        raise TypeError("simulate_fig4() missing required argument: 'cfg'")
    return build_sim_graph(cfg, resp, add_noise=add_noise, device=device,
                           recon=recon).run(key, depos)


def make_sim_fn(cfg: LArTPCConfig, resp: Optional[DetectorResponse] = None,
                add_noise: bool = True, device="cuda", recon: bool = False):
    """The single-event executor: a ``SimGraph`` called as
    ``sim(key, depos) -> SimOutput``, built once (response spectra and, with
    ``recon``, the deconvolution filters included) and reused for every
    event."""
    return build_sim_graph(cfg, resp, add_noise=add_noise, device=device,
                           recon=recon)


def simulate(key: torch.Tensor, depos, cfg: LArTPCConfig, resp=None,
             add_noise: bool = True, device="cuda",
             recon: bool = False) -> SimOutput:
    return simulate_fig4(key, depos, resp, cfg, add_noise=add_noise,
                         device=device, recon=recon)
