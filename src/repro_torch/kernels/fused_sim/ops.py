"""Depos -> charge grid through the fused kernels, with the tile binning.

``simulate_charge_grid``         : dense tile grid (one CTA per tile)
``simulate_charge_grid_compact`` : occupied tiles only (one CTA per
                                   occupied tile, bucketed to a power of 2)
``simulate_charge_grid_multiplane[_compact]`` : the same for (P, N) depos,
                                   every plane in one launch

Each takes an optional threefry ``key`` (per-plane ``keys`` for the
multi-plane forms): given, the kernel fluctuates each (depo, tile)
contribution in kernel with counter-hash normals seeded from the key's raw
words; ``None`` gives the deterministic mean grid. Each returns ``(grid,
dropped)``, where ``dropped`` (a 0-d tensor) counts the (depo, tile) entries
the binning could not fit, over all planes; callers insist on 0.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.config import LArTPCConfig
from repro_torch.core.depo import DepoSet, depo_patch_origin
from repro_torch.core.prng import key_data
from repro_torch.kernels.fused_sim.kernel import (
    fused_rasterize_scatter, fused_rasterize_scatter_compact,
    fused_rasterize_scatter_multiplane,
    fused_rasterize_scatter_multiplane_compact)
from repro_torch.kernels.scatter_add.ops import (bin_depos_to_tiles,
                                                 bin_depos_to_tiles_compact,
                                                 compact_n_cap, default_k_max)


def _seed(key: Optional[torch.Tensor]):
    return None if key is None else tuple(int(v) for v in key_data(key))


def _seeds(keys: Optional[torch.Tensor]):
    return None if keys is None else [tuple(row) for row in
                                      key_data(keys).tolist()]


def _k_max(k_max: int, n: int, cfg: LArTPCConfig, tw: int, tt: int) -> int:
    return k_max or default_k_max(n, cfg.num_wires, cfg.num_ticks, tw, tt)


def _n_cap(n_active: Optional[int], w0s, t0s, cfg: LArTPCConfig, tw: int,
           tt: int) -> int:
    return compact_n_cap(n_active, w0s, t0s, cfg.patch_wires,
                         cfg.patch_ticks, cfg.num_wires, cfg.num_ticks, tw, tt)


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
    n_cap = _n_cap(n_active, [w0], [t0], cfg, tw, tt)
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


def simulate_charge_grid_multiplane(depos: DepoSet, cfg: LArTPCConfig,
                                    tw: int = 64, tt: int = 256,
                                    k_max: int = 0,
                                    keys: Optional[torch.Tensor] = None
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused (P, N) depos -> (P, W, T) grids, ONE launch for all planes.

    Each plane is binned on its own (plane-local depo ids) and the lists
    are concatenated plane-major; ``keys`` (P, 2) are the per-plane subkeys
    ``fold_in(kf, p)``. Plane p equals ``simulate_charge_grid`` on plane
    p's depos with plane p's key, bit for bit.
    """
    num_planes, n = depos.wire.shape
    w0, t0 = depo_patch_origin(depos, cfg)
    k_max = _k_max(k_max, n, cfg, tw, tt)
    binned = [bin_depos_to_tiles(w0[p], t0[p], cfg.patch_wires,
                                 cfg.patch_ticks, cfg.num_wires,
                                 cfg.num_ticks, tw, tt, k_max)
              for p in range(num_planes)]
    grid = fused_rasterize_scatter_multiplane(
        *depos, w0, t0, torch.cat([ids for ids, _, _ in binned]),
        num_planes=num_planes, num_wires=cfg.num_wires,
        num_ticks=cfg.num_ticks, tw=tw, tt=tt, k_max=k_max,
        pw=cfg.patch_wires, pt=cfg.patch_ticks, seeds=_seeds(keys),
        fluctuate=keys is not None)
    return grid, torch.stack([d for _, _, d in binned]).sum()


def simulate_charge_grid_multiplane_compact(
        depos: DepoSet, cfg: LArTPCConfig, tw: int = 64, tt: int = 256,
        k_max: int = 0, keys: Optional[torch.Tensor] = None,
        n_active: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused (P, N) depos -> (P, W, T) grids over each plane's OCCUPIED
    tiles, one launch. Every plane gets the same slot count ``n_cap`` (the
    largest plane's occupancy, bucketed) so the launch stays rectangular.
    Bit-identical to ``simulate_charge_grid_multiplane`` for the same keys.
    """
    num_planes, n = depos.wire.shape
    w0, t0 = depo_patch_origin(depos, cfg)
    k_max = _k_max(k_max, n, cfg, tw, tt)
    n_cap = _n_cap(n_active, w0, t0, cfg, tw, tt)
    binned = [bin_depos_to_tiles_compact(
        w0[p], t0[p], cfg.patch_wires, cfg.patch_ticks, cfg.num_wires,
        cfg.num_ticks, tw, tt, k_max, n_cap) for p in range(num_planes)]
    grid = fused_rasterize_scatter_multiplane_compact(
        *depos, w0, t0, torch.cat([a for a, _, _ in binned]),
        torch.cat([ids for _, ids, _ in binned]), num_planes=num_planes,
        num_wires=cfg.num_wires, num_ticks=cfg.num_ticks, tw=tw, tt=tt,
        k_max=k_max, pw=cfg.patch_wires, pt=cfg.patch_ticks,
        seeds=_seeds(keys), fluctuate=keys is not None)
    return grid, torch.stack([d for _, _, d in binned]).sum()
