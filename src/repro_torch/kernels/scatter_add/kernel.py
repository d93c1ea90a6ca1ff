"""Wrappers of the owner-computes scatter-add CUDA kernel.

``scatter_add_pallas`` (dense tile grid) and ``scatter_add_pallas_compact``
(occupied tiles only) replace the reference's Pallas kernels of the same
names (``src/repro/kernels/scatter_add/kernel.py:97`` and ``:140``) and
return what they return: the padded (tiles_w*tw, tiles_t*tt) grid, or one
(tw, tt) block per active slot. The compact wrapper can instead write each
occupied tile in place into the padded grid (``layout="grid"``), which is
what the ``pallas_compact`` strategy runs. On CUDA tensors each wrapper
launches ``scatter_add_launch`` from ``csrc/scatter_add.cu`` (CTAs longest
list first, by ``kernels/tiles.py``) or raises; the kernel always writes
the grid, and the compact blocks are gathered from it. On CPU tensors each
wrapper runs the plain PyTorch version in ``ref.py``.
``LAUNCHES`` counts kernel launches per wrapper, and ``BF16_LAUNCHES``
those on bfloat16 patches (plain-version calls do not count). Patches are
float32 or bfloat16, as the reference takes them; a bfloat16 value is
widened to float32 before its add, so the grid is the one float32
``patches.float()`` gives, bit for bit. Any other dtype raises.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import (check_tensor, declare, kernel_device,
                                 load_library, plain_version, raise_on)
from repro_torch.kernels.scatter_add import ref
from repro_torch.kernels.scatter_add.ops import tile_counts
from repro_torch.kernels.tiles import (lengths_and_order,
                                       scatter_tiles_to_grid, tiles_of_grid)

#: kernel launches per wrapper since the last ``reset_launches``
LAUNCHES: Dict[str, int] = {"scatter_add_pallas": 0,
                            "scatter_add_pallas_compact": 0}
#: of those, the launches on bfloat16 patches (the kernel's bfloat16
#: instantiation)
BF16_LAUNCHES: Dict[str, int] = dict.fromkeys(LAUNCHES, 0)

#: the compact wrapper's outputs: the reference's blocks, or the padded
#: grid written in place
LAYOUTS = ("blocks", "grid")
#: the C entry point's modes: dense lists, or compact ones with tile ids
_DENSE, _COMPACT = 0, 1
#: the patch dtypes the kernel reads, and the C entry point's codes for them
PATCH_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        BF16_LAUNCHES[name] = 0


#: the C entry point of csrc/scatter_add.cu and its argument types:
#: patches, w0, t0, active, ids, order, lengths, n_depos, pw, pt, n_slots,
#: tiles_t, tw, tt, k_max, mode, patch dtype code, out, stream
SIGNATURES = {"scatter_add_launch": [_P] * 7 + [_I] * 10 + [_P, _P]}


def _library() -> ctypes.CDLL:
    lib = load_library("scatter_add")
    for name, argtypes in SIGNATURES.items():
        declare(lib, name, argtypes)
    return lib


def _checked(patches, w0, t0):
    dev = kernel_device(patches)
    if patches.ndim != 3:
        raise ValueError(f"patches: expected (N, pw, pt), got "
                         f"{tuple(patches.shape)}")
    if patches.dtype not in PATCH_DTYPES:
        raise ValueError(f"patches: expected one of {list(PATCH_DTYPES)}, "
                         f"got {patches.dtype}")
    check_tensor("patches", patches, patches.dtype, tuple(patches.shape), dev)
    check_tensor("w0", w0, torch.int32, (patches.shape[0],), dev)
    check_tensor("t0", t0, torch.int32, (patches.shape[0],), dev)
    return dev


def _launch(name: str, patches, w0, t0, active, tile_ids, *, n_slots: int,
            tiles_t: int, tw: int, tt: int, k_max: int, mode: int,
            out: torch.Tensor) -> None:
    """Launch the kernel over ``n_slots`` lists, longest first."""
    dev = patches.device
    n, pw, pt = patches.shape
    lengths, order = lengths_and_order(tile_ids, k_max)
    with torch.cuda.device(dev):
        err = _library().scatter_add_launch(
            patches.data_ptr(), w0.data_ptr(), t0.data_ptr(),
            0 if active is None else active.data_ptr(), tile_ids.data_ptr(),
            order.data_ptr(), lengths.data_ptr(), n, pw, pt, n_slots,
            tiles_t, tw, tt, k_max, mode, PATCH_DTYPES[patches.dtype],
            out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, "scatter_add_launch")
    LAUNCHES[name] += 1
    if patches.dtype == torch.bfloat16:
        BF16_LAUNCHES[name] += 1


def scatter_add_pallas(patches, w0, t0, tile_ids, *, num_wires: int,
                       num_ticks: int, tw: int, tt: int,
                       k_max: int) -> torch.Tensor:
    """Owner-computes scatter-add over the dense tile grid.

    patches: (N, pw, pt) f32 or bf16; w0, t0: (N,) int32 patch origins;
    tile_ids: (n_tiles*k_max,) int32 depo lists per tile, -1 padded.
    Returns the padded (tiles_w*tw, tiles_t*tt) f32 grid.
    """
    dev = _checked(patches, w0, t0)
    tiles_w, tiles_t, n_tiles = tile_counts(num_wires, num_ticks, tw, tt)
    check_tensor("tile_ids", tile_ids, torch.int32, (n_tiles * k_max,), dev)
    if dev.type == "cpu":
        with plain_version("scatter_add_pallas"):
            return ref.scatter_add_ref(patches, w0, t0, tile_ids,
                                       tiles_w=tiles_w, tiles_t=tiles_t,
                                       tw=tw, tt=tt, k_max=k_max)
    out = torch.empty((tiles_w * tw, tiles_t * tt), dtype=torch.float32,
                      device=dev)
    _launch("scatter_add_pallas", patches, w0, t0, None, tile_ids,
            n_slots=n_tiles, tiles_t=tiles_t, tw=tw, tt=tt, k_max=k_max,
            mode=_DENSE, out=out)
    return out


def scatter_add_pallas_compact(patches, w0, t0, active_tiles, tile_ids, *,
                               num_wires: int, num_ticks: int, tw: int,
                               tt: int, k_max: int,
                               layout: str = "blocks") -> torch.Tensor:
    """Owner-computes scatter-add over the OCCUPIED tiles only.

    active_tiles: (n_cap,) int32 global tile ids, -1 padded; tile_ids:
    (n_cap*k_max,) int32 depo lists per active slot. ``layout="blocks"``
    returns the reference's (n_cap, tw, tt) blocks (zero for -1 slots),
    which ``tiles.scatter_tiles_to_grid`` places into the grid;
    ``layout="grid"`` returns that padded (tiles_w*tw, tiles_t*tt) grid. On
    the card the kernel writes the grid in place into a grid zeroed once,
    and the blocks are its tiles at ``active_tiles``.
    """
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {sorted(LAYOUTS)}, got "
                         f"{layout!r}")
    dev = _checked(patches, w0, t0)
    tiles_w, tiles_t, _ = tile_counts(num_wires, num_ticks, tw, tt)
    n_cap = active_tiles.shape[0]
    check_tensor("active_tiles", active_tiles, torch.int32, (n_cap,), dev)
    check_tensor("tile_ids", tile_ids, torch.int32, (n_cap * k_max,), dev)
    if dev.type == "cpu":
        with plain_version("scatter_add_pallas_compact"):
            blocks = ref.scatter_add_compact_ref(
                patches, w0, t0, active_tiles, tile_ids, tiles_t=tiles_t,
                tw=tw, tt=tt, k_max=k_max)
            if layout == "blocks":
                return blocks
            return scatter_tiles_to_grid(blocks, active_tiles, tiles_w,
                                         tiles_t, tw, tt)
    grid = torch.zeros((tiles_w * tw, tiles_t * tt), dtype=torch.float32,
                       device=dev)
    _launch("scatter_add_pallas_compact", patches, w0, t0, active_tiles,
            tile_ids, n_slots=n_cap, tiles_t=tiles_t, tw=tw, tt=tt,
            k_max=k_max, mode=_COMPACT, out=grid)
    if layout == "grid":
        return grid
    return tiles_of_grid(grid, active_tiles, tiles_w, tiles_t, tw, tt)
