"""What the tile kernels share: their CTA launch order and the placement
of compact blocks.

The fused charge-grid kernels (``csrc/fused_sim.cu``) and the scatter-add
kernel (``csrc/scatter_add.cu``) both walk per-tile depo lists, one CTA per
list, and both start their CTAs longest list first: ``launch_order`` (and
``lengths_and_order``, which also returns the lengths the kernels split
long lists by) sorts the slots by descending filled length, stable, by two
small kernels on the card (compiled with ``csrc/fused_sim.cu``, entry
``fused_sim_launch_order``) and by ``launch_order_ref`` on the CPU. On the
card both kernels write the compact layout in place into the grid; on the
CPU path ``scatter_tiles_to_grid[_planes]`` places the plain versions'
blocks, and ``tiles_of_grid`` takes the blocks back out of a grid.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import (check_tensor, declare, kernel_device,
                                 load_library, raise_on)

#: argument types of ``fused_sim_launch_order`` (csrc/fused_sim.cu): ids,
#: n_slots, k_max, lengths, order, stream
ORDER_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [
    ctypes.c_void_p] * 3


def _library() -> ctypes.CDLL:
    lib = load_library("fused_sim")
    declare(lib, "fused_sim_launch_order", ORDER_ARGS)
    return lib


def launch_order_ref(tile_ids: torch.Tensor, k_max: int) -> torch.Tensor:
    """Slots of ``k_max``-long lists by descending filled length (the run
    before the first -1), stable: (n_slots,) int32."""
    filled = (tile_ids.view(-1, k_max) >= 0).to(torch.int32)
    lengths = torch.cumprod(filled, 1).sum(1)
    return torch.sort(lengths, descending=True,
                      stable=True).indices.to(torch.int32)


def launch_order(tile_ids: torch.Tensor, k_max: int) -> torch.Tensor:
    """The CTA launch order of ``k_max``-long per-slot lists: the slots
    sorted by descending list length (entries up to the first -1), stable,
    so slots of equal length keep their order. (n_slots,) int32 on the
    lists' device: computed by two kernels on the card, by the plain
    version on the CPU. Not counted in ``LAUNCHES``."""
    dev = kernel_device(tile_ids)
    n_slots = tile_ids.numel() // k_max
    check_tensor("tile_ids", tile_ids, torch.int32, (n_slots * k_max,), dev)
    if dev.type == "cpu":
        return launch_order_ref(tile_ids, k_max)
    return lengths_and_order(tile_ids, k_max)[1]


def lengths_and_order(tile_ids: torch.Tensor, k_max: int):
    """The lists' filled lengths and launch order on the card, by the two
    kernels."""
    dev = tile_ids.device
    scratch = torch.empty((2, tile_ids.numel() // k_max), dtype=torch.int32,
                          device=dev)
    with torch.cuda.device(dev):
        err = _library().fused_sim_launch_order(
            tile_ids.data_ptr(), scratch.shape[1], k_max,
            scratch[0].data_ptr(), scratch[1].data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, "fused_sim_launch_order")
    return scratch[0], scratch[1]


def scatter_tiles_to_grid_planes(blocks: torch.Tensor,
                                 active_tiles: torch.Tensor, num_planes: int,
                                 tiles_w: int, tiles_t: int, tw: int,
                                 tt: int) -> torch.Tensor:
    """Place (P*n_cap, tw, tt) blocks into (P, tiles_w*tw, tiles_t*tt)
    grids: ``active_tiles`` holds plane-LOCAL tile ids in plane-major runs
    of n_cap slots; -1 slots are dropped, unoccupied tiles stay zero."""
    n_tiles = tiles_w * tiles_t
    n_cap = active_tiles.shape[0] // num_planes
    offs = torch.arange(num_planes, device=active_tiles.device
                        ).repeat_interleave(n_cap) * n_tiles
    # -1 slots land in one extra row that is cut off (no host sync)
    dest = torch.where(active_tiles >= 0, active_tiles.long() + offs,
                       torch.full_like(offs, num_planes * n_tiles))
    full = torch.zeros((num_planes * n_tiles + 1, tw, tt), dtype=blocks.dtype,
                       device=blocks.device)
    full.index_copy_(0, dest, blocks)
    return full[:-1].reshape(num_planes, tiles_w, tiles_t, tw, tt).transpose(
        2, 3).reshape(num_planes, tiles_w * tw, tiles_t * tt)


def scatter_tiles_to_grid(blocks: torch.Tensor, active_tiles: torch.Tensor,
                          tiles_w: int, tiles_t: int, tw: int,
                          tt: int) -> torch.Tensor:
    """Place (n_cap, tw, tt) blocks into the padded (tiles_w*tw,
    tiles_t*tt) grid; -1 slots are dropped, unoccupied tiles stay zero."""
    return scatter_tiles_to_grid_planes(blocks, active_tiles, 1, tiles_w,
                                        tiles_t, tw, tt)[0]


def tiles_of_grid(grid: torch.Tensor, active_tiles: torch.Tensor,
                  tiles_w: int, tiles_t: int, tw: int,
                  tt: int) -> torch.Tensor:
    """The (n_cap, tw, tt) blocks of the padded (tiles_w*tw, tiles_t*tt)
    grid at the global tile ids ``active_tiles``, zero for -1 slots: the
    inverse of ``scatter_tiles_to_grid`` on its occupied tiles."""
    slot = active_tiles.clamp_min(0).long()
    blocks = grid.view(tiles_w, tw, tiles_t, tt)[slot // tiles_t, :,
                                                 slot % tiles_t, :]
    return blocks.masked_fill_((active_tiles < 0)[:, None, None], 0.0)
