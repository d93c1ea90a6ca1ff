"""Plain PyTorch versions of the fused charge-grid kernels.

Same function as ``csrc/fused_sim.cu``, vectorised over the (entry, pw, pt)
patch pixels of every binned (tile, depo) entry: per pixel its tile, its
in-tile counter and its stream, then the fluctuation. The sums are taken
one list position at a time: entries at one position sit in distinct tiles,
so their pixels are distinct and one indexed add lands them exactly; each
pixel therefore receives its contributions in list order, as in the kernel,
and the result does not depend on how a library orders colliding adds. The
CPU path and the tests use these; on the card they serve only as the
kernels' comparison.
"""
from __future__ import annotations

import torch

from repro_torch.core.fluctuate import (MASK32, binomial_normal_approx,
                                        counter_normals, mul32)
from repro_torch.core.rasterize import SQRT2

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
    d = entry_depo.long()
    t_id = entry_tile.long()
    dev = wire.device
    tile_w0 = (t_id // tiles_t) * tw
    tile_t0 = (t_id % tiles_t) * tt
    aw = w0.long()[d][:, None] + torch.arange(pw, device=dev)[None, :]
    at = t0.long()[d][:, None] + torch.arange(pt, device=dev)[None, :]
    row = aw - tile_w0[:, None]                        # (E, pw) tile-local
    col = at - tile_t0[:, None]                        # (E, pt)
    in_r = (row >= 0) & (row < tw)
    in_c = (col >= 0) & (col < tt)
    ww = _axis(aw.to(torch.float32), wire[d][:, None],
               (sigma_w[d] * SQRT2)[:, None])
    wt = _axis(at.to(torch.float32), tick[d][:, None],
               (sigma_t[d] * SQRT2)[:, None])
    q = charge[d]
    vals = q[:, None, None] * ww[:, :, None] * wt[:, None, :]  # (E, pw, pt)
    pix = row[:, :, None] * tt + col[:, None, :]
    keep = in_r[:, :, None] & in_c[:, None, :]
    e_idx, i_idx, j_idx = torch.nonzero(keep, as_tuple=True)
    vals = vals[e_idx, i_idx, j_idx]
    pix = pix[e_idx, i_idx, j_idx]
    if fluctuate:
        stream = mul32(d, C_DEPO) ^ mul32(t_id, C_TILE)
        normals = counter_normals(int(seed[0]), int(seed[1]),
                                  stream[e_idx], pix & MASK32)
        vals = binomial_normal_approx(vals[:, None, None], q[e_idx],
                                      normals[:, None, None])[:, 0, 0]
    return pix, e_idx, vals


def _entries(tile_ids: torch.Tensor, k_max: int):
    """(list slot, list position, depo) of every filled entry, slot-major."""
    pos = torch.nonzero(tile_ids >= 0, as_tuple=True)[0]
    return pos // k_max, pos % k_max, tile_ids[pos]


def _add_in_list_order(out: torch.Tensor, dest: torch.Tensor,
                       rank: torch.Tensor, vals: torch.Tensor) -> None:
    """out[dest] += vals, one list position (rank) after another."""
    order = torch.argsort(rank, stable=True)
    dest, vals = dest[order], vals[order]
    sizes = torch.bincount(rank).tolist()
    start = 0
    for size in sizes:
        sl = slice(start, start + size)
        out[dest[sl]] += vals[sl]
        start += size


def fused_rasterize_scatter_ref(params, tile_ids: torch.Tensor, *,
                                tiles_w: int, tiles_t: int, tw: int, tt: int,
                                k_max: int, pw: int, pt: int, seed,
                                fluctuate: bool) -> torch.Tensor:
    """Dense layout: the padded grid (tiles_w*tw, tiles_t*tt)."""
    tile, rank, depo = _entries(tile_ids, k_max)
    pix, e, vals = tile_contributions(
        params, tile, depo, tiles_t=tiles_t, tw=tw, tt=tt, pw=pw, pt=pt,
        seed=seed, fluctuate=fluctuate)
    t_id = tile[e]
    dest = (((t_id // tiles_t) * tw + pix // tt) * (tiles_t * tt)
            + (t_id % tiles_t) * tt + pix % tt)
    out = torch.zeros(tiles_w * tw * tiles_t * tt, dtype=torch.float32,
                      device=tile_ids.device)
    _add_in_list_order(out, dest, rank[e], vals)
    return out.reshape(tiles_w * tw, tiles_t * tt)


def fused_rasterize_scatter_compact_ref(params, active_tiles: torch.Tensor,
                                        tile_ids: torch.Tensor, *,
                                        tiles_t: int, tw: int, tt: int,
                                        k_max: int, pw: int, pt: int, seed,
                                        fluctuate: bool) -> torch.Tensor:
    """Compact layout: (n_cap, tw, tt) blocks, one per active-list slot
    (zero for -1 slots)."""
    n_cap = active_tiles.shape[0]
    slot, rank, depo = _entries(tile_ids, k_max)
    tile = active_tiles.long()[slot]
    live = tile >= 0
    slot, rank, depo, tile = slot[live], rank[live], depo[live], tile[live]
    pix, e, vals = tile_contributions(
        params, tile, depo, tiles_t=tiles_t, tw=tw, tt=tt, pw=pw, pt=pt,
        seed=seed, fluctuate=fluctuate)
    out = torch.zeros(n_cap * tw * tt, dtype=torch.float32,
                      device=tile_ids.device)
    _add_in_list_order(out, slot[e] * (tw * tt) + pix, rank[e], vals)
    return out.reshape(n_cap, tw, tt)
