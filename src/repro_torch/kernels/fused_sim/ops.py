"""Depos -> charge grid through the fused kernels, with the tile binning.

``simulate_charge_grid``         : dense tile grid (one CTA per tile)
``simulate_charge_grid_compact`` : occupied tiles only (one CTA per
                                   occupied tile, bucketed to a power of 2)
``simulate_charge_grid_multiplane[_compact]`` : the same for (P, N) depos,
                                   every plane in one launch
``simulate_charge_grid_rows``    : any (R, N) rows (the (event, plane) rows
                                   of a batch), ceil(R / MAX_ROWS) launches

Each takes an optional threefry ``key`` (per-row ``keys`` for the
multi-row forms): given, the kernel fluctuates each (depo, tile)
contribution in kernel with counter-hash normals seeded from the key's raw
words; ``None`` gives the deterministic mean grid. Each returns ``(grid,
dropped)``, where ``dropped`` counts the (depo, tile) entries of depos
below ``n_valid`` (every depo when None) the binning could not fit: a 0-d
tensor over all planes, or one count per row for the rows form; callers
insist on 0.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.config import LArTPCConfig
from repro_torch.core.depo import DepoSet, depo_patch_origin
from repro_torch.core.prng import key_data
from repro_torch.kernels.fused_sim import kernel
from repro_torch.kernels.scatter_add.ops import (bin_depos_to_tiles,
                                                 bin_depos_to_tiles_compact,
                                                 compact_n_cap, default_k_max)


def _seeds(keys: Optional[torch.Tensor]):
    return None if keys is None else [tuple(row) for row in
                                      key_data(keys).tolist()]


def _one_row(depos: DepoSet) -> DepoSet:
    return DepoSet(*(x[None] for x in depos))


def _k_max(k_max: int, n: int, cfg: LArTPCConfig, tw: int, tt: int) -> int:
    return k_max or default_k_max(n, cfg.num_wires, cfg.num_ticks, tw, tt)


def _n_cap(n_active: Optional[int], w0s, t0s, cfg: LArTPCConfig, tw: int,
           tt: int) -> int:
    return compact_n_cap(n_active, w0s, t0s, cfg.patch_wires,
                         cfg.patch_ticks, cfg.num_wires, cfg.num_ticks, tw, tt)


def simulate_charge_grid(depos: DepoSet, cfg: LArTPCConfig, tw: int = 64,
                         tt: int = 256, k_max: int = 0,
                         key: Optional[torch.Tensor] = None,
                         n_valid: Optional[int] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused depos -> S(t, x) over the dense tile grid: the rows form on
    one row."""
    grid, dropped = simulate_charge_grid_rows(
        _one_row(depos), cfg, compact=False, one_plane=True,
        keys=None if key is None else key[None], n_valid=[n_valid], tw=tw,
        tt=tt, k_max=k_max)
    return grid[0], dropped[0]


def simulate_charge_grid_compact(depos: DepoSet, cfg: LArTPCConfig,
                                 tw: int = 64, tt: int = 256, k_max: int = 0,
                                 key: Optional[torch.Tensor] = None,
                                 n_active: Optional[int] = None,
                                 n_valid: Optional[int] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused depos -> S(t, x) over the OCCUPIED tiles only.

    The occupancy is counted on the host (one read) and bucketed to a power
    of two unless ``n_active`` gives it. Bit-identical to
    ``simulate_charge_grid`` for the same key: the RNG streams key on the
    global tile id, which compaction keeps.
    """
    grid, dropped = simulate_charge_grid_rows(
        _one_row(depos), cfg, compact=True, one_plane=True,
        keys=None if key is None else key[None], n_valid=[n_valid], tw=tw,
        tt=tt, k_max=k_max, n_active=n_active)
    return grid[0], dropped[0]


def simulate_charge_grid_rows(depos: DepoSet, cfg: LArTPCConfig, *,
                              compact: bool, one_plane: bool,
                              keys: Optional[torch.Tensor] = None,
                              n_valid: Optional[Sequence] = None,
                              tw: int = 64, tt: int = 256, k_max: int = 0,
                              n_active: Optional[int] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused (R, N) rows -> ((R, W, T) grids, (R,) dropped), the rows split
    into ceil(R / MAX_ROWS) launches of the plane-aware kernel (the split
    happens here on every device).

    Each row is binned on its own (row-local depo ids), with its own valid
    count ``n_valid[r]``; ``keys`` (R, 2) are the rows' seed keys. The
    compact layout gives every row the slots of the most occupied row,
    counted in one host read for all rows. Row r equals
    ``simulate_charge_grid[_compact]`` on row r's depos and key, bit for
    bit. ``one_plane`` counts the launches under the one-plane wrappers'
    names (rows 1-2), else under the multi-plane ones (rows 3-4).
    """
    num_rows, n = depos.wire.shape
    n_valid = list(n_valid) if n_valid is not None else [None] * num_rows
    w0, t0 = depo_patch_origin(depos, cfg)
    k_max = _k_max(k_max, n, cfg, tw, tt)
    binning = (cfg.patch_wires, cfg.patch_ticks, cfg.num_wires,
               cfg.num_ticks, tw, tt, k_max)
    if compact:
        n_cap = _n_cap(n_active, w0, t0, cfg, tw, tt)
        binned = [bin_depos_to_tiles_compact(w0[r], t0[r], *binning, n_cap,
                                             n_valid[r])
                  for r in range(num_rows)]
    else:
        binned = [bin_depos_to_tiles(w0[r], t0[r], *binning, n_valid[r])
                  for r in range(num_rows)]
    launch = (kernel.fused_rasterize_scatter_multiplane_compact if compact
              else kernel.fused_rasterize_scatter_multiplane)
    seeds = _seeds(keys)
    geom = dict(num_wires=cfg.num_wires, num_ticks=cfg.num_ticks, tw=tw,
                tt=tt, k_max=k_max, pw=cfg.patch_wires, pt=cfg.patch_ticks,
                fluctuate=keys is not None)
    grids = []
    for lo in range(0, num_rows, kernel.MAX_ROWS):
        hi = min(lo + kernel.MAX_ROWS, num_rows)
        lists = ([torch.cat([b[0] for b in binned[lo:hi]])] if not compact
                 else [torch.cat([b[i] for b in binned[lo:hi]])
                       for i in (0, 1)])
        grids.append(launch(*(x[lo:hi] for x in depos), w0[lo:hi],
                            t0[lo:hi], *lists, num_planes=hi - lo,
                            seeds=None if seeds is None else seeds[lo:hi],
                            one_plane=one_plane, **geom))
    grid = grids[0] if len(grids) == 1 else torch.cat(grids)
    return grid, torch.stack([b[-1] for b in binned])


def simulate_charge_grid_multiplane(depos: DepoSet, cfg: LArTPCConfig,
                                    tw: int = 64, tt: int = 256,
                                    k_max: int = 0,
                                    keys: Optional[torch.Tensor] = None,
                                    n_valid: Optional[int] = None
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused (P, N) depos -> (P, W, T) grids, ONE launch for all planes.

    Each plane is binned on its own (plane-local depo ids) and the lists
    are concatenated plane-major; ``keys`` (P, 2) are the per-plane subkeys
    ``fold_in(kf, p)``. Plane p equals ``simulate_charge_grid`` on plane
    p's depos with plane p's key, bit for bit.
    """
    grid, dropped = simulate_charge_grid_rows(
        depos, cfg, compact=False, one_plane=False, keys=keys,
        n_valid=[n_valid] * depos.wire.shape[0], tw=tw, tt=tt, k_max=k_max)
    return grid, dropped.sum()


def simulate_charge_grid_multiplane_compact(
        depos: DepoSet, cfg: LArTPCConfig, tw: int = 64, tt: int = 256,
        k_max: int = 0, keys: Optional[torch.Tensor] = None,
        n_active: Optional[int] = None,
        n_valid: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused (P, N) depos -> (P, W, T) grids over each plane's OCCUPIED
    tiles, one launch. Every plane gets the same slot count ``n_cap`` (the
    largest plane's occupancy, bucketed) so the launch stays rectangular.
    Bit-identical to ``simulate_charge_grid_multiplane`` for the same keys.
    """
    grid, dropped = simulate_charge_grid_rows(
        depos, cfg, compact=True, one_plane=False, keys=keys,
        n_valid=[n_valid] * depos.wire.shape[0], tw=tw, tt=tt, k_max=k_max,
        n_active=n_active)
    return grid, dropped.sum()
