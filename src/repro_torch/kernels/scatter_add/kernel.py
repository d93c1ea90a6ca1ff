"""Wrappers of the owner-computes scatter-add CUDA kernels.

``scatter_add_pallas`` (dense tile grid) and ``scatter_add_pallas_compact``
(occupied tiles only) replace the reference's Pallas kernels of the same
names (``src/repro/kernels/scatter_add/kernel.py:97`` and ``:140``) and
return what they return: the padded (tiles_w*tw, tiles_t*tt) grid, or one
(tw, tt) block per active slot. On CUDA tensors each wrapper launches its
kernel from ``csrc/scatter_add.cu`` or raises; on CPU tensors it runs the
plain PyTorch version in ``ref.py``. ``LAUNCHES`` counts kernel launches
per wrapper (plain-version calls do not count). Patches are float32; the
reference's bfloat16 patch input is not ported yet.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import (check_tensor, declare, kernel_device,
                                 load_library, raise_on)
from repro_torch.kernels.scatter_add import ref
from repro_torch.kernels.scatter_add.ops import tile_counts

#: kernel launches per wrapper since the last ``reset_launches``
LAUNCHES: Dict[str, int] = {"scatter_add_pallas": 0,
                            "scatter_add_pallas_compact": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _library() -> ctypes.CDLL:
    lib = load_library("scatter_add")
    # patches, w0, t0, ids, pw, pt, n_tiles, tiles_t, tw, tt, k_max, out,
    # stream
    declare(lib, "scatter_add_dense", [_P] * 4 + [_I] * 7 + [_P, _P])
    # patches, w0, t0, active, ids, pw, pt, n_cap, tiles_t, tw, tt, k_max,
    # blocks, stream
    declare(lib, "scatter_add_compact", [_P] * 5 + [_I] * 7 + [_P, _P])
    return lib


def _checked(patches, w0, t0):
    dev = kernel_device(patches)
    if patches.ndim != 3:
        raise ValueError(f"patches: expected (N, pw, pt), got "
                         f"{tuple(patches.shape)}")
    check_tensor("patches", patches, torch.float32, tuple(patches.shape), dev)
    check_tensor("w0", w0, torch.int32, (patches.shape[0],), dev)
    check_tensor("t0", t0, torch.int32, (patches.shape[0],), dev)
    return dev


def _call(entry: str, name: str, patches, *ints_and_ptrs) -> None:
    dev = patches.device
    with torch.cuda.device(dev):
        err = getattr(_library(), entry)(
            *ints_and_ptrs, torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, entry)
    LAUNCHES[name] += 1


def scatter_add_pallas(patches, w0, t0, tile_ids, *, num_wires: int,
                       num_ticks: int, tw: int, tt: int,
                       k_max: int) -> torch.Tensor:
    """Owner-computes scatter-add over the dense tile grid.

    patches: (N, pw, pt) f32; w0, t0: (N,) int32 patch origins; tile_ids:
    (n_tiles*k_max,) int32 depo lists per tile, -1 padded. Returns the
    padded (tiles_w*tw, tiles_t*tt) grid.
    """
    dev = _checked(patches, w0, t0)
    _, pw, pt = patches.shape
    tiles_w, tiles_t, n_tiles = tile_counts(num_wires, num_ticks, tw, tt)
    check_tensor("tile_ids", tile_ids, torch.int32, (n_tiles * k_max,), dev)
    if dev.type == "cpu":
        return ref.scatter_add_ref(patches, w0, t0, tile_ids, tiles_w=tiles_w,
                                   tiles_t=tiles_t, tw=tw, tt=tt, k_max=k_max)
    out = torch.empty((tiles_w * tw, tiles_t * tt), dtype=torch.float32,
                      device=dev)
    _call("scatter_add_dense", "scatter_add_pallas", patches,
          patches.data_ptr(), w0.data_ptr(), t0.data_ptr(),
          tile_ids.data_ptr(), pw, pt, n_tiles, tiles_t, tw, tt, k_max,
          out.data_ptr())
    return out


def scatter_add_pallas_compact(patches, w0, t0, active_tiles, tile_ids, *,
                               num_wires: int, num_ticks: int, tw: int,
                               tt: int, k_max: int) -> torch.Tensor:
    """Owner-computes scatter-add over the OCCUPIED tiles only.

    active_tiles: (n_cap,) int32 global tile ids, -1 padded; tile_ids:
    (n_cap*k_max,) int32 depo lists per active slot. Returns (n_cap, tw, tt)
    blocks (zero for -1 slots), which ``fused_sim.kernel.
    scatter_tiles_to_grid`` places into the grid.
    """
    dev = _checked(patches, w0, t0)
    _, pw, pt = patches.shape
    _, tiles_t, _ = tile_counts(num_wires, num_ticks, tw, tt)
    n_cap = active_tiles.shape[0]
    check_tensor("active_tiles", active_tiles, torch.int32, (n_cap,), dev)
    check_tensor("tile_ids", tile_ids, torch.int32, (n_cap * k_max,), dev)
    if dev.type == "cpu":
        return ref.scatter_add_compact_ref(patches, w0, t0, active_tiles,
                                           tile_ids, tiles_t=tiles_t, tw=tw,
                                           tt=tt, k_max=k_max)
    blocks = torch.empty((n_cap, tw, tt), dtype=torch.float32, device=dev)
    _call("scatter_add_compact", "scatter_add_pallas_compact", patches,
          patches.data_ptr(), w0.data_ptr(), t0.data_ptr(),
          active_tiles.data_ptr(), tile_ids.data_ptr(), pw, pt, n_cap,
          tiles_t, tw, tt, k_max, blocks.data_ptr())
    return blocks
