"""The fig3 and fig4 pipelines and the registered ``charge_grid`` strategies.

fig4 is the batched, device-resident pipeline of the paper: every depo of
the event goes through one chain of device work (drift, charge grid,
convolve, noise, digitize), with one upload of the depos and the ADC grid
left on the device. The chain itself is ``repro_torch.core.stages``.

fig3 is the paper's deliberately naive baseline: a host loop with one
dispatch per depo, each patch copied back to the host and accumulated
there, the grid uploaded once for the convolution, noise and digitisation.
``simulate`` dispatches on ``cfg.pipeline``.

Charge-grid strategies (each returns ``(grid, dropped)``; ``n_valid``, the
valid depo count of a padded row, limits ``dropped`` to the valid depos;
``pool`` is the pre-computed normal pool of ``rng_strategy="pool"``):

  unfused              : rasterize -> fluctuation (threefry ``counter``, its
                         differentiable form ``relaxed``, or the ``pool``)
                         -> scatter_add
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

Only the two unfused strategies take the pool; the others draw their
normals in kernel or from the counter hash and refuse that stream.

The names keep the reference's strategy names, so one config selects the
same path in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.config import LArTPCConfig, PlaneSpec, plane_specs
from repro_torch.core import fluctuate as fl
from repro_torch.core import prng
from repro_torch.core.depo import DepoSet, depo_patch_origin
from repro_torch.core.fft_conv import digitize, fft_convolve
from repro_torch.core.noise import simulate_noise
from repro_torch.core.rasterize import rasterize, rasterize_one
from repro_torch.core.response import DetectorResponse, make_response
from repro_torch.core.scatter import scatter_add
from repro_torch.core.stages import SimOutput, build_sim_graph, \
    plane_fold_keys
from repro_torch.device import resolve_device, scalar
from repro_torch.tune.autotune import resolve_config
from repro_torch.tune.registry import register_strategy, set_default

__all__ = ["SimOutput", "simulate_fig3", "simulate_fig4", "make_sim_fn",
           "simulate",
           "charge_grid_unfused", "charge_grid_unfused_bf16",
           "charge_grid_fused",
           "charge_grid_fused_compact", "charge_grid_fused_multiplane",
           "charge_grid_fused_multiplane_compact",
           "charge_grid_multiplane_xla"]


@register_strategy("charge_grid", "unfused",
                   note="rasterize -> fluctuate -> scatter_add")
def charge_grid_unfused(k: torch.Tensor, depos: DepoSet, cfg: LArTPCConfig,
                        n_valid: Optional[int] = None,
                        pool: Optional[torch.Tensor] = None):
    patches, w0, t0 = rasterize(depos, cfg)
    return scatter_add(_fluctuate(k, patches, depos.charge, cfg, pool), w0,
                       t0, cfg, n_valid=n_valid)


def _fluctuate(k: torch.Tensor, patches: torch.Tensor, charge: torch.Tensor,
               cfg: LArTPCConfig,
               pool: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The unfused chain's fluctuation step for ``cfg.rng_strategy``:
    ``counter``, its differentiable form ``relaxed`` (the same bits), the
    pre-computed ``pool`` (which must be given), or none."""
    if not cfg.fluctuate or cfg.rng_strategy == "none":
        return patches
    if cfg.rng_strategy == "pool":
        if pool is None:
            raise ValueError("pool strategy requires a pre-computed pool")
        return fl.fluctuate_pool(pool, patches, charge)
    if cfg.rng_strategy == "relaxed":
        return fl.fluctuate_counter_relaxed(k, patches, charge)
    if cfg.rng_strategy == "counter":
        return fl.fluctuate_counter(k, patches, charge)
    raise NotImplementedError(
        f"the port has no {cfg.rng_strategy!r} fluctuation stream")


@register_strategy("charge_grid", "unfused_bf16",
                   note="unfused chain with bfloat16 patches (f32 accumulate)")
def charge_grid_unfused_bf16(k: torch.Tensor, depos: DepoSet,
                             cfg: LArTPCConfig,
                             n_valid: Optional[int] = None,
                             pool: Optional[torch.Tensor] = None):
    """``unfused`` with bfloat16 patches. With fluctuation on, the patches
    meet the float32 charge and reach the scatter as float32 (bfloat16
    means; bfloat16 normals, or the pool's float32 ones), as in the
    reference; without it the scatter takes the bfloat16 patches and adds
    them in float32."""
    return charge_grid_unfused(
        k, depos, dataclasses.replace(cfg, patch_dtype="bfloat16"), n_valid,
        pool)


def _fused_viable(ctx) -> bool:
    # the fused kernel draws counter-style fluctuation in kernel, so it
    # competes in the physics-default config; the pre-computed "pool" and
    # "relaxed" streams cannot be reproduced in kernel, and off the card
    # the plain version makes production grids prohibitive
    cfg = ctx.cfg
    if cfg is None or (cfg.fluctuate
                       and cfg.rng_strategy in ("pool", "relaxed")):
        return False
    if ctx.backend == "cuda":
        return True
    cells = ctx.shape.get("num_wires", 0) * ctx.shape.get("num_ticks", 0)
    return cells <= (1 << 21)


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


@register_strategy("charge_grid", "fused_pallas", available=_fused_viable,
                   note="fused rasterize+fluctuate+scatter CUDA kernel",
                   differentiable=False)
def charge_grid_fused(k: torch.Tensor, depos: DepoSet, cfg: LArTPCConfig,
                      n_valid: Optional[int] = None,
                      pool: Optional[torch.Tensor] = None):
    from repro_torch.kernels.fused_sim.ops import simulate_charge_grid

    return simulate_charge_grid(depos, cfg, key=_fused_key(k, cfg),
                                n_valid=n_valid)


@register_strategy("charge_grid", "fused_pallas_compact",
                   available=_fused_viable,
                   note="fused kernel over occupied tiles only",
                   differentiable=False)
def charge_grid_fused_compact(k: torch.Tensor, depos: DepoSet,
                              cfg: LArTPCConfig,
                              n_valid: Optional[int] = None,
                              pool: Optional[torch.Tensor] = None):
    from repro_torch.kernels.fused_sim.ops import simulate_charge_grid_compact

    return simulate_charge_grid_compact(depos, cfg, key=_fused_key(k, cfg),
                                        n_valid=n_valid)


def _fused_mp_viable(ctx) -> bool:
    # the multi-plane kernels need a plane axis to batch over; fluctuation
    # constraints match the single-plane fused kernels, and off the card
    # the plain version's cost scales with the planes it rasterises
    cfg = ctx.cfg
    if cfg is None or cfg.num_planes < 2:
        return False
    if cfg.fluctuate and cfg.rng_strategy in ("pool", "relaxed"):
        return False
    if ctx.backend == "cuda":
        return True
    cells = (ctx.shape.get("num_wires", 0) * ctx.shape.get("num_ticks", 0)
             * cfg.num_planes)
    return cells <= (1 << 21)


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
                   available=_fused_mp_viable,
                   note="one fused CUDA launch rasterises ALL planes",
                   differentiable=False)
def charge_grid_fused_multiplane(k: torch.Tensor, depos: DepoSet,
                                 cfg: LArTPCConfig,
                                 n_valid: Optional[int] = None,
                                 pool: Optional[torch.Tensor] = None):
    from repro_torch.kernels.fused_sim.ops import \
        simulate_charge_grid_multiplane

    _require_plane_axis(depos, cfg)
    return simulate_charge_grid_multiplane(depos, cfg,
                                           keys=_plane_grid_keys(k, cfg),
                                           n_valid=n_valid)


@register_strategy("charge_grid", "fused_pallas_multiplane_compact",
                   available=_fused_mp_viable,
                   note="multi-plane fused kernel over occupied tiles only",
                   differentiable=False)
def charge_grid_fused_multiplane_compact(k: torch.Tensor, depos: DepoSet,
                                         cfg: LArTPCConfig,
                                         n_valid: Optional[int] = None,
                                         pool: Optional[torch.Tensor] = None):
    from repro_torch.kernels.fused_sim.ops import \
        simulate_charge_grid_multiplane_compact

    _require_plane_axis(depos, cfg)
    return simulate_charge_grid_multiplane_compact(
        depos, cfg, keys=_plane_grid_keys(k, cfg), n_valid=n_valid)


def _mp_xla_viable(ctx) -> bool:
    # plane-flattened chain: needs a plane axis to amortise, and its
    # counter-hash fluctuation cannot reproduce the pool/relaxed streams.
    # No cell cap: plain torch ops scale to production grids everywhere.
    cfg = ctx.cfg
    if cfg is None or cfg.num_planes < 2:
        return False
    return not (cfg.fluctuate and cfg.rng_strategy in ("pool", "relaxed"))


@register_strategy("charge_grid", "multiplane_xla", available=_mp_xla_viable,
                   note="plane-flattened chain; counter-hash fluctuation",
                   differentiable=False)
def charge_grid_multiplane_xla(k: torch.Tensor, depos: DepoSet,
                               cfg: LArTPCConfig,
                               n_valid: Optional[int] = None,
                               pool: Optional[torch.Tensor] = None):
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


#: the fused strategies -> (compact, one-plane rows): over a batch they
#: hand every (event, plane) row to the fused kernel at once
FUSED_ROWS = {"fused_pallas": (False, True),
              "fused_pallas_compact": (True, True),
              "fused_pallas_multiplane": (False, False),
              "fused_pallas_multiplane_compact": (True, False)}


def charge_grid_fused_rows(name: str, kfs: Sequence[torch.Tensor],
                           depos: Sequence[DepoSet], cfg: LArTPCConfig,
                           specs: Sequence[PlaneSpec],
                           n_valid: Sequence[Optional[int]]):
    """The fused strategy ``name`` over the events of a batch, all their
    (event, plane) rows in ceil(rows / 16) launches (the port's counterpart
    of the reference's ``vmap`` of the fused ``pallas_call``).

    Event e has the charge-grid key ``kfs[e]``, the depos ``depos[e]``
    ((N,), or one row per plane of ``specs`` for a multi-plane config) and
    the valid depo count ``n_valid[e]``. Each row carries the seed the
    per-event run gives it: ``kf_e`` for one plane, ``fold_in(kf_e,
    spec.index)`` for several. Returns each event's ``(grid, dropped)`` as
    the per-event charge-grid stage returns it, bit for bit."""
    from repro_torch.kernels.fused_sim.ops import simulate_charge_grid_rows

    compact, one_plane = FUSED_ROWS[name]
    multi = cfg.num_planes > 1
    rows = [d if multi else DepoSet(*(x[None] for x in d)) for d in depos]
    per_event = rows[0].wire.shape[0]
    keys = None
    if _fused_key(kfs[0], cfg) is not None:
        keys = torch.cat([plane_fold_keys(k, specs) if multi else k[None]
                          for k in kfs])
    grid, dropped = simulate_charge_grid_rows(
        DepoSet(*(torch.cat(x) for x in zip(*rows))), cfg, compact=compact,
        one_plane=one_plane, keys=keys,
        n_valid=[n for n in n_valid for _ in range(per_event)])
    grid = grid.view(len(rows), per_event, *grid.shape[1:])
    dropped = dropped.view(len(rows), per_event).sum(1)
    return [(g if multi else g[0], d) for g, d in zip(grid, dropped)]


set_default("charge_grid", "unfused")


def simulate_fig4(key: torch.Tensor, depos, resp=None,
                  cfg: Optional[LArTPCConfig] = None, add_noise: bool = True,
                  device="cuda", recon: bool = False,
                  pool: Optional[torch.Tensor] = None) -> SimOutput:
    """One run of the canonical stage chain for one event. ``depos`` may be
    a detector-frame ``DepoSet`` (with a leading plane axis for multi-plane
    configs) or a ``PhysicalDepoSet``; ``resp`` one response, one per
    plane, or None for the config's defaults. ``recon=True`` appends the
    deconvolve and hit_find stages and fills ``SimOutput.decon``/``hits``.
    ``pool``: the normals of ``rng_strategy="pool"`` (default: the
    graph's standard pool)."""
    if cfg is None:
        raise TypeError("simulate_fig4() missing required argument: 'cfg'")
    return build_sim_graph(cfg, resp, add_noise=add_noise, device=device,
                           recon=recon, pool=pool).run(key, depos)


def _fig3_normals(pool_h: np.ndarray, i: int, pw: int, pt: int):
    """Depo ``i``'s (pw, pt) normals from the host pool: the slice starting
    at ``(i * pw * pt) % P``; where that slice would run past the pool's
    end, the reference does not wrap but takes ``np.resize(pool, (pw,
    pt))``, the pool's first pw * pt values."""
    start = (i * pw * pt) % pool_h.shape[0]
    if start + pw * pt <= pool_h.shape[0]:
        return pool_h[start:start + pw * pt].reshape(pw, pt)
    return np.resize(pool_h, (pw, pt))


def simulate_fig3(key: torch.Tensor, depos: DepoSet, resp: DetectorResponse,
                  cfg: LArTPCConfig, pool: Optional[torch.Tensor] = None,
                  add_noise: bool = True, max_depos: Optional[int] = None,
                  device="cuda") -> SimOutput:
    """The per-depo host-loop pipeline (paper Fig. 3), deliberately naive.

    One dispatch per depo (``rasterize_one``, then, with fluctuation on,
    the binomial draw on the depo's slice of the normal pool, taken from
    the pool even under the default ``counter`` strategy), the patch
    copied to the host every depo and accumulated there into a float32
    grid, and one upload of the grid; the convolution, the noise (key
    ``fold_in(key, 1)``) and the digitisation run on ``device``. The
    default pool is ``make_pool(fold_in(key, 7), 2**16)``, copied to the
    host once. ``max_depos`` truncates the depos."""
    dev = resolve_device(device)
    pw, pt = cfg.patch_wires, cfg.patch_ticks
    fluctuate = cfg.fluctuate and cfg.rng_strategy != "none"
    w0s, t0s = depo_patch_origin(depos, cfg)
    n = depos.n if max_depos is None else min(depos.n, max_depos)
    host_grid = np.zeros((cfg.num_wires, cfg.num_ticks), np.float32)
    w0s_h, t0s_h = w0s.cpu().numpy(), t0s.cpu().numpy()
    w0f, t0f = w0s.to(torch.float32), t0s.to(torch.float32)
    if fluctuate:
        if pool is None:
            pool = fl.make_pool(prng.fold_in(key, 7), 1 << 16, device=dev)
        pool_h = pool.cpu().numpy()
    for i in range(n):
        patch = rasterize_one(depos.wire[i], depos.tick[i], depos.sigma_w[i],
                              depos.sigma_t[i], depos.charge[i], w0f[i],
                              t0f[i], pw, pt)
        if fluctuate:
            normals = torch.from_numpy(_fig3_normals(pool_h, i, pw, pt)).to(
                dev)
            patch = fl.binomial_normal_approx(
                patch[None], depos.charge[i:i + 1], normals[None])[0]
        w0, t0 = w0s_h[i], t0s_h[i]
        host_grid[w0:w0 + pw, t0:t0 + pt] += patch.cpu().numpy()
    grid = torch.from_numpy(host_grid).to(dev)
    signal = fft_convolve(grid, resp, cfg.fft_strategy)
    if add_noise:
        noise = simulate_noise(prng.fold_in(key, 1), cfg, device=dev)
        signal = signal + noise / torch.clamp_min(
            scalar(cfg.adc_per_electron, noise), 1e-30)
    return SimOutput(adc=digitize(signal, cfg), signal=signal,
                     charge_grid=grid)


def make_sim_fn(cfg: LArTPCConfig, resp: Optional[DetectorResponse] = None,
                add_noise: bool = True, device="cuda", recon: bool = False,
                pool: Optional[torch.Tensor] = None):
    """The single-event executor: a ``SimGraph`` called as
    ``sim(key, depos) -> SimOutput``, built once (response spectra and, with
    ``recon``, the deconvolution filters included) and reused for every
    event. ``"auto"`` strategy fields resolve first, from the tuning cache
    or the device's defaults (``repro_torch.tune``), so every event runs
    the same strategies. The graph is fig4's whatever ``cfg.pipeline``
    says; ``simulate`` is the entry point that dispatches on it."""
    cfg = resolve_config(cfg, device=device)
    return build_sim_graph(cfg, resp, add_noise=add_noise, device=device,
                           recon=recon, pool=pool)


def simulate(key: torch.Tensor, depos, cfg: LArTPCConfig, resp=None,
             add_noise: bool = True, device="cuda", **kw) -> SimOutput:
    """One event through the pipeline ``cfg.pipeline`` names: ``fig3``
    (one plane only; takes ``pool`` and ``max_depos``) or ``fig4`` (takes
    ``pool`` and ``recon``)."""
    if cfg.pipeline == "fig3":
        if cfg.num_planes > 1:
            raise ValueError(
                "the fig3 per-depo host-loop baseline is single-plane only; "
                "use pipeline='fig4' for multi-plane configs")
        resp = resp if resp is not None else make_response(cfg, device=device)
        return simulate_fig3(key, depos, resp, cfg, add_noise=add_noise,
                             device=device, **kw)
    return simulate_fig4(key, depos, resp, cfg, add_noise=add_noise,
                         device=device, **kw)
