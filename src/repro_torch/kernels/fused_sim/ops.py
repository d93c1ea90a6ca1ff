"""Depos -> charge grid through the fused kernels, with the tile binning.

``simulate_charge_grid``         : dense tile grid (one CTA per tile)
``simulate_charge_grid_compact`` : occupied tiles only (one CTA per
                                   occupied tile, bucketed to a power of 2)

Both take an optional threefry ``key``: given, the kernel fluctuates each
(depo, tile) contribution in kernel with counter-hash normals seeded from
the key's raw words; ``None`` gives the deterministic mean grid. Both
return ``(grid, dropped)``, where ``dropped`` (a 0-d tensor) counts the
(depo, tile) entries the binning could not fit; callers insist on 0.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.config import LArTPCConfig
from repro_torch.core.depo import DepoSet, depo_patch_origin
from repro_torch.core.prng import key_data
from repro_torch.kernels.fused_sim.kernel import (
    fused_rasterize_scatter, fused_rasterize_scatter_compact)
from repro_torch.kernels.scatter_add.ops import (active_tile_cap,
                                                 bin_depos_to_tiles,
                                                 bin_depos_to_tiles_compact,
                                                 default_k_max, next_pow2,
                                                 tile_counts)


def _seed(key: Optional[torch.Tensor]):
    return None if key is None else tuple(int(v) for v in key_data(key))


def _k_max(k_max: int, n: int, cfg: LArTPCConfig, tw: int, tt: int) -> int:
    return k_max or default_k_max(n, cfg.num_wires, cfg.num_ticks, tw, tt)


def simulate_charge_grid(depos: DepoSet, cfg: LArTPCConfig, tw: int = 64,
                         tt: int = 256, k_max: int = 0,
                         key: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused depos -> S(t, x) over the dense tile grid."""
    w0, t0 = depo_patch_origin(depos, cfg)
    k_max = _k_max(k_max, depos.n, cfg, tw, tt)
    # bin by the TRUE patch extent (the kernel masks to [w0, w0+pw))
    ids, _, dropped = bin_depos_to_tiles(
        w0, t0, cfg.patch_wires, cfg.patch_ticks, cfg.num_wires,
        cfg.num_ticks, tw, tt, k_max)
    grid = fused_rasterize_scatter(
        depos.wire, depos.tick, depos.sigma_w, depos.sigma_t, depos.charge,
        w0, t0, ids, num_wires=cfg.num_wires, num_ticks=cfg.num_ticks,
        tw=tw, tt=tt, k_max=k_max, pw=cfg.patch_wires, pt=cfg.patch_ticks,
        seed=_seed(key), fluctuate=key is not None)
    return grid, dropped


def simulate_charge_grid_compact(depos: DepoSet, cfg: LArTPCConfig,
                                 tw: int = 64, tt: int = 256, k_max: int = 0,
                                 key: Optional[torch.Tensor] = None,
                                 n_active: Optional[int] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused depos -> S(t, x) over the OCCUPIED tiles only.

    The occupancy is counted on the host (one read) and bucketed to a power
    of two unless ``n_active`` gives it. Bit-identical to
    ``simulate_charge_grid`` for the same key: the RNG streams key on the
    global tile id, which compaction keeps.
    """
    w0, t0 = depo_patch_origin(depos, cfg)
    k_max = _k_max(k_max, depos.n, cfg, tw, tt)
    if n_active is not None:
        n_cap = min(tile_counts(cfg.num_wires, cfg.num_ticks, tw, tt)[2],
                    next_pow2(n_active))
    else:
        n_cap = active_tile_cap(w0, cfg.patch_wires, cfg.patch_ticks,
                                cfg.num_wires, cfg.num_ticks, tw, tt, t0=t0)
    active, ids, dropped = bin_depos_to_tiles_compact(
        w0, t0, cfg.patch_wires, cfg.patch_ticks, cfg.num_wires,
        cfg.num_ticks, tw, tt, k_max, n_cap)
    grid = fused_rasterize_scatter_compact(
        depos.wire, depos.tick, depos.sigma_w, depos.sigma_t, depos.charge,
        w0, t0, active, ids, num_wires=cfg.num_wires,
        num_ticks=cfg.num_ticks, tw=tw, tt=tt, k_max=k_max,
        pw=cfg.patch_wires, pt=cfg.patch_ticks, seed=_seed(key),
        fluctuate=key is not None)
    return grid, dropped
