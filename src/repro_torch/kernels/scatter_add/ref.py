"""Plain PyTorch versions of the owner-computes scatter-add kernels.

Same function as ``csrc/scatter_add.cu``: every tile adds the patches of
the depos in its list, in list order, restricted to the tile. The sums are
taken one list position at a time: entries at one position sit in distinct
tiles, so their pixels are distinct and one indexed add lands them exactly;
each pixel therefore receives its contributions in list order, as in the
kernel, and the result does not depend on how a library orders colliding
adds. bfloat16 patches are widened to float32 before their adds (exact),
so they give the float32 sums of ``patches.float()``, as the reference's
kernels do. The helpers here also serve the fused kernels' plain
versions. The CPU path and the tests use these; on the card they serve
only as the kernels' comparison.
"""
from __future__ import annotations

import torch


def list_entries(tile_ids: torch.Tensor, k_max: int):
    """(list slot, list position, depo) of every filled entry, slot-major."""
    pos = torch.nonzero(tile_ids >= 0, as_tuple=True)[0]
    return pos // k_max, pos % k_max, tile_ids[pos]


def in_tile_pixels(w0: torch.Tensor, t0: torch.Tensor,
                   entry_tile: torch.Tensor, entry_depo: torch.Tensor, *,
                   tiles_t: int, tw: int, tt: int, pw: int, pt: int):
    """The patch pixels of binned (tile, depo) entries that fall inside the
    entry's tile: (entry, patch row, patch column, tile-local flat pixel
    row*tt + col), entry-major."""
    d = entry_depo.long()
    t_id = entry_tile.long()
    dev = w0.device
    row = (w0.long()[d][:, None] + torch.arange(pw, device=dev)[None, :]
           - ((t_id // tiles_t) * tw)[:, None])             # (E, pw)
    col = (t0.long()[d][:, None] + torch.arange(pt, device=dev)[None, :]
           - ((t_id % tiles_t) * tt)[:, None])              # (E, pt)
    keep = (((row >= 0) & (row < tw))[:, :, None]
            & ((col >= 0) & (col < tt))[:, None, :])
    e, i, j = torch.nonzero(keep, as_tuple=True)
    return e, i, j, row[e, i] * tt + col[e, j]


def add_in_list_order(out: torch.Tensor, dest: torch.Tensor,
                      rank: torch.Tensor, vals: torch.Tensor) -> None:
    """out[dest] += vals, one list position (rank) after another, each value
    widened to ``out``'s float32 first."""
    order = torch.argsort(rank, stable=True)
    dest, vals = dest[order], vals[order].to(out.dtype)
    start = 0
    for size in torch.bincount(rank).tolist():
        sl = slice(start, start + size)
        out[dest[sl]] += vals[sl]
        start += size


def scatter_add_ref(patches: torch.Tensor, w0: torch.Tensor,
                    t0: torch.Tensor, tile_ids: torch.Tensor, *,
                    tiles_w: int, tiles_t: int, tw: int, tt: int,
                    k_max: int) -> torch.Tensor:
    """Dense layout: the padded grid (tiles_w*tw, tiles_t*tt)."""
    _, pw, pt = patches.shape
    tile, rank, depo = list_entries(tile_ids, k_max)
    e, i, j, pix = in_tile_pixels(w0, t0, tile, depo, tiles_t=tiles_t, tw=tw,
                                  tt=tt, pw=pw, pt=pt)
    t_id = tile[e]
    dest = (((t_id // tiles_t) * tw + pix // tt) * (tiles_t * tt)
            + (t_id % tiles_t) * tt + pix % tt)
    out = torch.zeros(tiles_w * tw * tiles_t * tt, dtype=torch.float32,
                      device=patches.device)
    add_in_list_order(out, dest, rank[e], patches[depo.long()[e], i, j])
    return out.reshape(tiles_w * tw, tiles_t * tt)


def scatter_add_compact_ref(patches: torch.Tensor, w0: torch.Tensor,
                            t0: torch.Tensor, active_tiles: torch.Tensor,
                            tile_ids: torch.Tensor, *, tiles_t: int, tw: int,
                            tt: int, k_max: int) -> torch.Tensor:
    """Compact layout: (n_cap, tw, tt) blocks, one per active-list slot
    (zero for -1 slots)."""
    _, pw, pt = patches.shape
    n_cap = active_tiles.shape[0]
    slot, rank, depo = list_entries(tile_ids, k_max)
    tile = active_tiles.long()[slot]
    live = tile >= 0
    slot, rank, depo, tile = slot[live], rank[live], depo[live], tile[live]
    e, i, j, pix = in_tile_pixels(w0, t0, tile, depo, tiles_t=tiles_t, tw=tw,
                                  tt=tt, pw=pw, pt=pt)
    out = torch.zeros(n_cap * tw * tt, dtype=torch.float32,
                      device=patches.device)
    add_in_list_order(out, slot[e] * (tw * tt) + pix, rank[e],
                      patches[depo.long()[e], i, j])
    return out.reshape(n_cap, tw, tt)
