"""Plain PyTorch versions of the fused charge-grid kernels.

Same function as ``csrc/fused_sim.cu``, vectorised over the in-tile patch
pixels of every binned (tile, depo) entry: per pixel its tile, its in-tile
counter and its stream, then the fluctuation. The sums are taken one list
position at a time (``scatter_add.ref.add_in_list_order``), so each pixel
receives its contributions in list order, as in the kernel. A multi-plane
launch is, by definition, the one-plane function run per plane with that
plane's parameters, lists and seed. The CPU path and the tests use these;
on the card they serve only as the kernels' comparison.
"""
from __future__ import annotations

import torch

from repro_torch.core.fluctuate import (MASK32, binomial_normal_approx,
                                        counter_normals, mul32)
from repro_torch.core.rasterize import SQRT2
from repro_torch.kernels.scatter_add.ref import (add_in_list_order,
                                                 in_tile_pixels, list_entries)

#: stream-id mixing constants of the (depo, tile) counter streams
C_DEPO = 0x9E3779B9
C_TILE = 0x7FEB352D


def _axis(edges: torch.Tensor, center: torch.Tensor,
          den: torch.Tensor) -> torch.Tensor:
    lo = torch.special.erf((edges - center) / den)
    hi = torch.special.erf((edges + 1.0 - center) / den)
    return torch.clamp_min(0.5 * (hi - lo), 0.0)


def tile_contributions(params, entry_tile: torch.Tensor,
                       entry_depo: torch.Tensor, *, tiles_t: int, tw: int,
                       tt: int, pw: int, pt: int, seed, fluctuate: bool):
    """Contributions of binned (tile, depo) entries, restricted to each
    entry's tile: returns (tile-local flat pixel index row*tt + col, entry
    index, value) of every in-support, in-tile pixel, entry-major."""
    wire, tick, sigma_w, sigma_t, charge, w0, t0 = params
    e, i, j, pix = in_tile_pixels(w0, t0, entry_tile, entry_depo,
                                  tiles_t=tiles_t, tw=tw, tt=tt, pw=pw, pt=pt)
    d = entry_depo.long()
    dev = wire.device
    aw = w0.long()[d][:, None] + torch.arange(pw, device=dev)[None, :]
    at = t0.long()[d][:, None] + torch.arange(pt, device=dev)[None, :]
    ww = _axis(aw.to(torch.float32), wire[d][:, None],
               (sigma_w[d] * SQRT2)[:, None])                # (E, pw)
    wt = _axis(at.to(torch.float32), tick[d][:, None],
               (sigma_t[d] * SQRT2)[:, None])                # (E, pt)
    q = charge[d]
    vals = q[e] * ww[e, i] * wt[e, j]
    if fluctuate:
        stream = mul32(d, C_DEPO) ^ mul32(entry_tile.long(), C_TILE)
        normals = counter_normals(int(seed[0]), int(seed[1]),
                                  stream[e], pix & MASK32)
        vals = binomial_normal_approx(vals[:, None, None], q[e],
                                      normals[:, None, None])[:, 0, 0]
    return pix, e, vals


def fused_rasterize_scatter_ref(params, tile_ids: torch.Tensor, *,
                                tiles_w: int, tiles_t: int, tw: int, tt: int,
                                k_max: int, pw: int, pt: int, seed,
                                fluctuate: bool) -> torch.Tensor:
    """Dense layout: the padded grid (tiles_w*tw, tiles_t*tt)."""
    tile, rank, depo = list_entries(tile_ids, k_max)
    pix, e, vals = tile_contributions(
        params, tile, depo, tiles_t=tiles_t, tw=tw, tt=tt, pw=pw, pt=pt,
        seed=seed, fluctuate=fluctuate)
    t_id = tile[e]
    dest = (((t_id // tiles_t) * tw + pix // tt) * (tiles_t * tt)
            + (t_id % tiles_t) * tt + pix % tt)
    out = torch.zeros(tiles_w * tw * tiles_t * tt, dtype=torch.float32,
                      device=tile_ids.device)
    add_in_list_order(out, dest, rank[e], vals)
    return out.reshape(tiles_w * tw, tiles_t * tt)


def fused_rasterize_scatter_compact_ref(params, active_tiles: torch.Tensor,
                                        tile_ids: torch.Tensor, *,
                                        tiles_t: int, tw: int, tt: int,
                                        k_max: int, pw: int, pt: int, seed,
                                        fluctuate: bool) -> torch.Tensor:
    """Compact layout: (n_cap, tw, tt) blocks, one per active-list slot
    (zero for -1 slots)."""
    n_cap = active_tiles.shape[0]
    slot, rank, depo = list_entries(tile_ids, k_max)
    tile = active_tiles.long()[slot]
    live = tile >= 0
    slot, rank, depo, tile = slot[live], rank[live], depo[live], tile[live]
    pix, e, vals = tile_contributions(
        params, tile, depo, tiles_t=tiles_t, tw=tw, tt=tt, pw=pw, pt=pt,
        seed=seed, fluctuate=fluctuate)
    out = torch.zeros(n_cap * tw * tt, dtype=torch.float32,
                      device=tile_ids.device)
    add_in_list_order(out, slot[e] * (tw * tt) + pix, rank[e], vals)
    return out.reshape(n_cap, tw, tt)


def fused_rasterize_scatter_multiplane_ref(params, tile_ids: torch.Tensor, *,
                                           tiles_w: int, seeds, **geom
                                           ) -> torch.Tensor:
    """Dense multi-plane layout: (P, tiles_w*tw, tiles_t*tt), plane p the
    dense one-plane function on plane p's parameters, lists and seed."""
    lists = tile_ids.chunk(len(seeds))
    return torch.stack([
        fused_rasterize_scatter_ref(tuple(x[p] for x in params), lists[p],
                                    tiles_w=tiles_w, seed=seed, **geom)
        for p, seed in enumerate(seeds)])


def fused_rasterize_scatter_multiplane_compact_ref(
        params, active_tiles: torch.Tensor, tile_ids: torch.Tensor, *,
        seeds, **geom) -> torch.Tensor:
    """Compact multi-plane layout: (P*n_cap, tw, tt) blocks, plane p's
    n_cap slots the compact one-plane function on plane p."""
    actives = active_tiles.chunk(len(seeds))
    lists = tile_ids.chunk(len(seeds))
    return torch.cat([
        fused_rasterize_scatter_compact_ref(tuple(x[p] for x in params),
                                            actives[p], lists[p], seed=seed,
                                            **geom)
        for p, seed in enumerate(seeds)])
