"""Scatter-add: accumulate all depo patches into the readout grid S(t, x).

Four strategies, the reference's names, each returning ``(grid,
dropped)``:

  xla           : one ``index_put_(accumulate=True)`` over the flat pixel
                  indices of all patches (the reference's scatter HLO).
  sort_segment  : sort the pixel contributions by destination, sum each
                  run of equal destinations, write the run totals once.
  pallas        : the owner-computes tile kernel (``kernels/scatter_add``):
                  every tile sums its binned depos' patches in list order,
                  deterministic and without atomics.
  pallas_compact: the same kernel over occupied tiles only.

Patches arrive float32 or bfloat16 (``cfg.patch_dtype``); every strategy
widens each value to float32 before its add and returns a float32 grid.
``dropped`` (a 0-d tensor) counts the (depo, tile) entries the tile
binning could not fit, of depos below ``n_valid`` (the valid depos of a
padded row; every depo when None); the library strategies drop nothing.
``depo_patch_origin`` clips every origin so no window leaves the grid.
"""
from __future__ import annotations

import torch

from repro_torch.config import LArTPCConfig
from repro_torch.tune import autotune, registry
from repro_torch.tune.registry import register_strategy, set_default


def flat_pixel_indices(w0: torch.Tensor, t0: torch.Tensor, pw: int, pt: int,
                       num_ticks: int) -> torch.Tensor:
    """Flat destination index of every patch pixel: (N, pw, pt) int64."""
    dw = torch.arange(pw, device=w0.device)[None, :, None]
    dt = torch.arange(pt, device=w0.device)[None, None, :]
    return ((w0.long()[:, None, None] + dw) * num_ticks
            + (t0.long()[:, None, None] + dt))


def _no_drops(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int64, device=device)


def _flat_contributions(patches, w0, t0, cfg: LArTPCConfig):
    n, pw, pt = patches.shape
    if pw > cfg.num_wires or pt > cfg.num_ticks:
        raise ValueError(f"patch ({pw}, {pt}) larger than the readout grid "
                         f"({cfg.num_wires}, {cfg.num_ticks})")
    idx = flat_pixel_indices(w0, t0, pw, pt, cfg.num_ticks).reshape(-1)
    return idx, patches.reshape(-1).to(torch.float32)


@register_strategy("scatter_add", "xla", note="one index_put_ accumulate")
def scatter_xla(patches: torch.Tensor, w0: torch.Tensor, t0: torch.Tensor,
                cfg: LArTPCConfig, n_valid=None):
    idx, vals = _flat_contributions(patches, w0, t0, cfg)
    grid = torch.zeros(cfg.num_wires * cfg.num_ticks, dtype=torch.float32,
                       device=patches.device)
    grid.index_put_((idx,), vals, accumulate=True)
    return grid.reshape(cfg.num_wires, cfg.num_ticks), _no_drops(grid.device)


@register_strategy("scatter_add", "sort_segment",
                   note="sort by destination, segment sums, one write")
def scatter_sort_segment(patches: torch.Tensor, w0: torch.Tensor,
                         t0: torch.Tensor, cfg: LArTPCConfig, n_valid=None):
    idx, vals = _flat_contributions(patches, w0, t0, cfg)
    idx_s, order = torch.sort(idx, stable=True)
    dest, run = torch.unique_consecutive(idx_s, return_inverse=True)
    totals = torch.zeros(dest.shape[0], dtype=torch.float32,
                         device=vals.device)
    # index_put_ with accumulate sorts its indices stably on the card and
    # adds each run of equal indices in order, so the totals are the same
    # bits run to run; index_add_ adds with atomics there, whose order
    # changes from run to run
    totals.index_put_((run,), vals[order], accumulate=True)
    grid = torch.zeros(cfg.num_wires * cfg.num_ticks, dtype=torch.float32,
                       device=patches.device)
    grid[dest] = totals
    return grid.reshape(cfg.num_wires, cfg.num_ticks), _no_drops(grid.device)


def _pallas_viable(ctx) -> bool:
    # compiled on the card; elsewhere the wrapper runs the plain version,
    # a correctness tool: keep it out of the tuner's candidates once the
    # grid is big enough that it would never win, only slow tuning down
    if ctx.backend == "cuda":
        return True
    cells = ctx.shape.get("num_wires", 0) * ctx.shape.get("num_ticks", 0)
    return cells <= (1 << 21)


@register_strategy("scatter_add", "pallas", available=_pallas_viable,
                   note="owner-computes tile CUDA kernel",
                   differentiable=False)
def scatter_pallas(patches: torch.Tensor, w0: torch.Tensor, t0: torch.Tensor,
                   cfg: LArTPCConfig, n_valid=None):
    from repro_torch.kernels.scatter_add.ops import scatter_add_tiles

    return scatter_add_tiles(patches, w0, t0, num_wires=cfg.num_wires,
                             num_ticks=cfg.num_ticks, n_valid=n_valid)


@register_strategy("scatter_add", "pallas_compact", available=_pallas_viable,
                   note="owner-computes kernel over occupied tiles only",
                   differentiable=False)
def scatter_pallas_compact(patches: torch.Tensor, w0: torch.Tensor,
                           t0: torch.Tensor, cfg: LArTPCConfig, n_valid=None):
    from repro_torch.kernels.scatter_add.ops import scatter_add_tiles_compact

    return scatter_add_tiles_compact(patches, w0, t0,
                                     num_wires=cfg.num_wires,
                                     num_ticks=cfg.num_ticks, n_valid=n_valid)


set_default("scatter_add", "xla")


def scatter_add(patches, w0, t0, cfg: LArTPCConfig,
                strategy: str | None = None, n_valid: int | None = None):
    """Dispatch to a registered scatter strategy; returns ``(grid,
    dropped)``. ``strategy`` (or ``cfg.scatter_strategy``) may be a
    concrete name or ``"auto"``, which resolves through the tuning cache or
    the default of the patches' device (``repro_torch.tune``)."""
    strategy = strategy or cfg.scatter_strategy
    if strategy == "auto":
        shape = autotune.op_shape("scatter_add", cfg)
        shape["num_depos"] = int(patches.shape[0])
        strategy = autotune.resolve("scatter_add", cfg, shape=shape,
                                    device=patches.device).strategy
    return registry.get_strategy("scatter_add", strategy).fn(
        patches, w0, t0, cfg, n_valid=n_valid)
