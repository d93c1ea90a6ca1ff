"""Tile binning shared by the owner-computes charge-grid kernels, and the
scatter-add wrappers that bin and then launch the scatter kernels.

The readout grid is cut into (tw, tt) tiles. A patch at (w0, t0) spanning
[w0, w0+pw) x [t0, t0+pt) overlaps at most 4 tiles when tile >= patch; each
depo is appended to every tile it touches. A STABLE sort by tile keeps each
tile's list in ascending depo order, as in the reference, so a kernel that
walks a list in order sums every pixel in the reference's order.

Two layouts:

  dense   : (n_tiles * k_max,) depo ids, -1 padded, one run per tile.
  compact : the occupied tiles only, as an (n_cap,) active list of global
            tile ids plus (n_cap * k_max,) depo ids, both -1 padded.

Entries past ``k_max`` (or past ``n_cap`` occupied tiles) do not fit; the
reference drops them silently, the port drops them too and returns their
count so the caller can insist on 0. The binning's boolean-mask writes and
the compact occupancy read wait for the card: each runs in a
``sim.bin.mask`` wait span. A padded row (``repro_torch.core.batch``)
gives its valid depo count ``n_valid``: only the entries of depos below it
count as dropped. Padding depos sit at wire 0, tick 0 and have the highest
ids, so the stable sort puts them after every real depo of the corner tile
and they are the first entries to overflow; what they drop is zero charge.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import spans

#: the wait span of the binning's host reads (``repro_torch.spans``)
BIN_WAIT = "sim.bin.mask"


def next_pow2(n: int, lo: int = 8) -> int:
    """Smallest power of two >= max(n, lo)."""
    n = max(int(n), lo)
    return 1 << (n - 1).bit_length()


def tile_counts(num_wires: int, num_ticks: int, tw: int, tt: int):
    """(tiles_w, tiles_t, n_tiles) covering the grid."""
    tiles_w = (num_wires + tw - 1) // tw
    tiles_t = (num_ticks + tt - 1) // tt
    return tiles_w, tiles_t, tiles_w * tiles_t


def _candidate_tiles(w0, t0, pw_pad: int, pt_pad: int, tiles_w: int,
                     tiles_t: int, tw: int, tt: int):
    """Per-depo candidate tile ids (N, 4) + first-occurrence mask (N, 4):
    the tiles of the patch's 4 corners, with the far corner clamped to the
    last tile row/column."""
    w0 = w0.long()
    t0 = t0.long()
    cw0 = w0 // tw
    ct0 = t0 // tt
    cw1 = torch.clamp_max((w0 + pw_pad - 1) // tw, tiles_w - 1)
    ct1 = torch.clamp_max((t0 + pt_pad - 1) // tt, tiles_t - 1)
    cand_w = torch.stack([cw0, cw0, cw1, cw1], 1)
    cand_t = torch.stack([ct0, ct1, ct0, ct1], 1)
    tile = cand_w * tiles_t + cand_t
    first = torch.ones_like(tile, dtype=torch.bool)
    for a in range(1, 4):
        dup = torch.zeros_like(first[:, 0])
        for b in range(a):
            dup = dup | (tile[:, a] == tile[:, b])
        first[:, a] = ~dup
    return tile, first


def _sorted_tile_runs(w0, t0, pw_pad: int, pt_pad: int, num_wires: int,
                      num_ticks: int, tw: int, tt: int):
    """Sort (tile, depo) pairs by tile (stable) and annotate the runs.

    Returns (tile_s, depo_s, is_first, rank, seg_id, n_tiles): invalid
    entries carry tile id ``n_tiles`` and sort last; ``rank`` is the
    position within the tile's run, ``seg_id`` the 0-based run index.
    """
    n = w0.shape[0]
    tiles_w, tiles_t, n_tiles = tile_counts(num_wires, num_ticks, tw, tt)
    tile, first = _candidate_tiles(w0, t0, pw_pad, pt_pad, tiles_w, tiles_t,
                                   tw, tt)
    depo_id = torch.arange(n, device=w0.device)[:, None].expand(n, 4)
    tile_flat = torch.where(first, tile, torch.full_like(tile, n_tiles))
    tile_s, order = torch.sort(tile_flat.reshape(-1), stable=True)
    depo_s = depo_id.reshape(-1)[order]
    idx = torch.arange(tile_s.shape[0], device=w0.device)
    is_first = torch.ones_like(tile_s, dtype=torch.bool)
    is_first[1:] = tile_s[1:] != tile_s[:-1]
    run_start = torch.where(is_first, idx, torch.zeros_like(idx))
    run_start = torch.cummax(run_start, dim=0).values
    rank = idx - run_start
    seg_id = torch.cumsum(is_first.long(), dim=0) - 1
    return tile_s, depo_s, is_first, rank, seg_id, n_tiles


def _dropped(real, valid, depo_s, n_valid: Optional[int]) -> torch.Tensor:
    """0-d count of the entries that did not fit, of depos below
    ``n_valid`` only (every depo when None)."""
    lost = real & ~valid
    if n_valid is not None:
        lost = lost & (depo_s < n_valid)
    return lost.sum()


def bin_depos_to_tiles(w0, t0, pw_pad: int, pt_pad: int, num_wires: int,
                       num_ticks: int, tw: int, tt: int, k_max: int,
                       n_valid: Optional[int] = None):
    """Per-tile depo id lists -> (ids (n_tiles*k_max,) int32 -1 padded,
    n_tiles, dropped): ``dropped`` is a 0-d tensor counting the (depo, tile)
    entries of depos below ``n_valid`` that did not fit in ``k_max``."""
    tile_s, depo_s, _, rank, _, n_tiles = _sorted_tile_runs(
        w0, t0, pw_pad, pt_pad, num_wires, num_ticks, tw, tt)
    real = tile_s < n_tiles
    valid = real & (rank < k_max)
    slot = torch.where(valid, tile_s * k_max + rank,
                       torch.full_like(rank, n_tiles * k_max))
    ids = torch.full((n_tiles * k_max + 1,), -1, dtype=torch.int32,
                     device=w0.device)
    with spans.wait(BIN_WAIT, reads=2):
        ids[slot[valid]] = depo_s[valid].to(torch.int32)
    return ids[:-1], n_tiles, _dropped(real, valid, depo_s, n_valid)


def bin_depos_to_tiles_compact(w0, t0, pw_pad: int, pt_pad: int,
                               num_wires: int, num_ticks: int, tw: int,
                               tt: int, k_max: int, n_cap: int,
                               n_valid: Optional[int] = None):
    """Compacted binning -> (active (n_cap,) int32 global tile ids,
    ids (n_cap*k_max,) int32 depo ids, dropped), all lists -1 padded;
    ``dropped`` counts as in ``bin_depos_to_tiles``."""
    tile_s, depo_s, is_first, rank, seg_id, n_tiles = _sorted_tile_runs(
        w0, t0, pw_pad, pt_pad, num_wires, num_ticks, tw, tt)
    real = tile_s < n_tiles
    valid = real & (rank < k_max) & (seg_id < n_cap)
    ids = torch.full((n_cap * k_max,), -1, dtype=torch.int32,
                     device=w0.device)
    with spans.wait(BIN_WAIT, reads=2):
        ids[(seg_id * k_max + rank)[valid]] = depo_s[valid].to(torch.int32)
    head = is_first & real & (seg_id < n_cap)
    active = torch.full((n_cap,), -1, dtype=torch.int32, device=w0.device)
    with spans.wait(BIN_WAIT, reads=2):
        active[seg_id[head]] = tile_s[head].to(torch.int32)
    return active, ids, _dropped(real, valid, depo_s, n_valid)


def count_active_tiles(w0, t0, *, pw_pad: int, pt_pad: int, num_wires: int,
                       num_ticks: int, tw: int, tt: int) -> torch.Tensor:
    """Number of tiles touched by at least one patch (0-d tensor)."""
    tile_s, _, is_first, _, _, n_tiles = _sorted_tile_runs(
        w0, t0, pw_pad, pt_pad, num_wires, num_ticks, tw, tt)
    return (is_first & (tile_s < n_tiles)).sum()


def active_tile_cap(w0, pw_pad: int, pt_pad: int, num_wires: int,
                    num_ticks: int, tw: int, tt: int, t0) -> int:
    """Occupancy bucket of the compact layout: the measured count of
    occupied tiles rounded up to a power of two (one host read)."""
    return compact_n_cap(None, [w0], [t0], pw_pad, pt_pad, num_wires,
                         num_ticks, tw, tt)


def compact_n_cap(n_active: int | None, w0s, t0s, pw_pad: int, pt_pad: int,
                  num_wires: int, num_ticks: int, tw: int, tt: int) -> int:
    """The compact layout's slots per row: ``n_active`` bucketed to a power
    of two, or the most occupied tiles of any row (plane, or event and
    plane of a batch) in ``w0s``/``t0s``, counted on the device and read in
    ONE host read for all rows, bucketed; never more than the tile count."""
    n_tiles = tile_counts(num_wires, num_ticks, tw, tt)[2]
    if n_active is None:
        most = torch.stack([count_active_tiles(
            w0, t0, pw_pad=pw_pad, pt_pad=pt_pad, num_wires=num_wires,
            num_ticks=num_ticks, tw=tw, tt=tt)
            for w0, t0 in zip(w0s, t0s)]).max()
        with spans.wait(BIN_WAIT, reads=1):
            n_active = int(most)
    return min(n_tiles, next_pow2(n_active))


def default_k_max(n: int, num_wires: int, num_ticks: int, tw: int,
                  tt: int) -> int:
    """Per-tile list length: expected uniform occupancy x8, as a power of
    two (the reference's heuristic)."""
    _, _, tiles = tile_counts(num_wires, num_ticks, tw, tt)
    return next_pow2(int(4 * n / tiles * 8))


def scatter_add_tiles(patches, w0, t0, *, num_wires: int, num_ticks: int,
                      tw: int = 64, tt: int = 256, k_max: int = 0,
                      n_valid: Optional[int] = None):
    """Owner-computes scatter-add, dense layout: bin, then accumulate.

    Tiles are widened to cover a patch (``tw = max(tw, pw)``, the
    reference's rule). Returns ((num_wires, num_ticks) f32 grid, dropped),
    ``dropped`` counting the entries of depos below ``n_valid``.
    """
    from repro_torch.kernels.scatter_add.kernel import scatter_add_pallas

    n, pw, pt = patches.shape
    tw, tt = max(tw, pw), max(tt, pt)
    k_max = k_max or default_k_max(n, num_wires, num_ticks, tw, tt)
    ids, _, dropped = bin_depos_to_tiles(w0, t0, pw, pt, num_wires,
                                         num_ticks, tw, tt, k_max, n_valid)
    grid = scatter_add_pallas(patches, w0.to(torch.int32),
                              t0.to(torch.int32), ids, num_wires=num_wires,
                              num_ticks=num_ticks, tw=tw, tt=tt, k_max=k_max)
    return grid[:num_wires, :num_ticks], dropped


def scatter_add_tiles_compact(patches, w0, t0, *, num_wires: int,
                              num_ticks: int, tw: int = 64, tt: int = 256,
                              k_max: int = 0, n_active: int | None = None,
                              n_valid: Optional[int] = None):
    """Owner-computes scatter-add over the OCCUPIED tiles only.

    The occupancy is counted on the host (one read) and bucketed to a power
    of two unless ``n_active`` gives it. On the card the kernel writes each
    occupied tile in place into a grid zeroed once (no blocks buffer, no
    placement copy). Bit-identical to ``scatter_add_tiles``. Returns
    ((num_wires, num_ticks) grid, dropped), counted as there.
    """
    from repro_torch.kernels.scatter_add.kernel import (
        scatter_add_pallas_compact)

    n, pw, pt = patches.shape
    tw, tt = max(tw, pw), max(tt, pt)
    k_max = k_max or default_k_max(n, num_wires, num_ticks, tw, tt)
    n_cap = compact_n_cap(n_active, [w0], [t0], pw, pt, num_wires, num_ticks,
                          tw, tt)
    active, ids, dropped = bin_depos_to_tiles_compact(
        w0, t0, pw, pt, num_wires, num_ticks, tw, tt, k_max, n_cap, n_valid)
    grid = scatter_add_pallas_compact(
        patches, w0.to(torch.int32), t0.to(torch.int32), active, ids,
        num_wires=num_wires, num_ticks=num_ticks, tw=tw, tt=tt, k_max=k_max,
        layout="grid")
    return grid[:num_wires, :num_ticks], dropped
