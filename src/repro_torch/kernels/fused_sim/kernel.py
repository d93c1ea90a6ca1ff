"""Wrappers of the fused rasterize + fluctuate + scatter CUDA kernels.

``fused_rasterize_scatter`` (dense tile grid) and
``fused_rasterize_scatter_compact`` (occupied tiles only) replace the
reference's Pallas kernels of the same names
(``src/repro/kernels/fused_sim/kernel.py:262`` and ``:300``). On CUDA
tensors each wrapper launches its kernel from ``csrc/fused_sim.cu`` or
raises; on CPU tensors it runs the plain PyTorch version in ``ref.py``.
``LAUNCHES`` counts kernel launches per wrapper (plain-version calls do not
count).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence

import torch

from repro_torch.kernels import declare, load_library
from repro_torch.kernels.fused_sim import ref
from repro_torch.kernels.scatter_add.ops import tile_counts

#: kernel launches per wrapper since the last ``reset_launches``
LAUNCHES: Dict[str, int] = {"fused_rasterize_scatter": 0,
                            "fused_rasterize_scatter_compact": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
_PARAM_ARGS = [_P] * 7  # wire, tick, sigma_w, sigma_t, charge, w0, t0
_TAIL_ARGS = [_U, _U, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P]


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _library() -> ctypes.CDLL:
    lib = load_library("fused_sim")
    declare(lib, "fused_sim_dense", _PARAM_ARGS + [_P] + _TAIL_ARGS)
    declare(lib, "fused_sim_compact", _PARAM_ARGS + [_P, _P] + _TAIL_ARGS)
    return lib


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, numel: int,
           device: torch.device) -> None:
    if x.dtype != dtype or x.device != device or x.dim() != 1 \
            or x.numel() != numel or not x.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous ({numel},) {dtype} tensor on "
            f"{device}, got {tuple(x.shape)} {x.dtype} on {x.device}"
            f"{'' if x.is_contiguous() else ' (non-contiguous)'}")


def _checked_params(wire, tick, sigma_w, sigma_t, charge, w0, t0):
    n = wire.shape[0]
    dev = wire.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    for nm, x in (("wire", wire), ("tick", tick), ("sigma_w", sigma_w),
                  ("sigma_t", sigma_t), ("charge", charge)):
        _check(nm, x, torch.float32, n, dev)
    _check("w0", w0, torch.int32, n, dev)
    _check("t0", t0, torch.int32, n, dev)
    return (wire, tick, sigma_w, sigma_t, charge, w0, t0), dev


def _seed_words(seed: Optional[Sequence[int]]):
    if seed is None:
        return 0, 0
    s0, s1 = (int(v) & 0xFFFFFFFF for v in seed)
    return s0, s1


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError_t {err}")


def fused_rasterize_scatter(wire, tick, sigma_w, sigma_t, charge, w0, t0,
                            tile_ids, *, num_wires: int, num_ticks: int,
                            tw: int, tt: int, k_max: int, pw: int, pt: int,
                            seed=None, fluctuate: bool = False
                            ) -> torch.Tensor:
    """Depos -> (num_wires, num_ticks) charge grid over the dense tile grid.

    tile_ids: (n_tiles*k_max,) int32 per-tile depo lists (-1 padded);
    seed: the two raw words of the charge-grid key (read when fluctuate).
    """
    params, dev = _checked_params(wire, tick, sigma_w, sigma_t, charge, w0,
                                  t0)
    tiles_w, tiles_t, n_tiles = tile_counts(num_wires, num_ticks, tw, tt)
    _check("tile_ids", tile_ids, torch.int32, n_tiles * k_max, dev)
    s0, s1 = _seed_words(seed)
    if dev.type == "cpu":
        out = ref.fused_rasterize_scatter_ref(
            params, tile_ids, tiles_w=tiles_w, tiles_t=tiles_t, tw=tw, tt=tt,
            k_max=k_max, pw=pw, pt=pt, seed=(s0, s1), fluctuate=fluctuate)
        return out[:num_wires, :num_ticks]
    out = torch.empty((tiles_w * tw, tiles_t * tt), dtype=torch.float32,
                      device=dev)
    with torch.cuda.device(dev):
        err = _library().fused_sim_dense(
            *(x.data_ptr() for x in params), tile_ids.data_ptr(), s0, s1,
            int(fluctuate), n_tiles, tiles_t, tw, tt, pw, pt, k_max,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "fused_sim_dense")
    LAUNCHES["fused_rasterize_scatter"] += 1
    return out[:num_wires, :num_ticks]


def fused_rasterize_scatter_compact(wire, tick, sigma_w, sigma_t, charge,
                                    w0, t0, active_tiles, tile_ids, *,
                                    num_wires: int, num_ticks: int, tw: int,
                                    tt: int, k_max: int, pw: int, pt: int,
                                    seed=None, fluctuate: bool = False
                                    ) -> torch.Tensor:
    """Depos -> charge grid over the OCCUPIED tiles only.

    active_tiles: (n_cap,) int32 global tile ids (-1 padded);
    tile_ids: (n_cap*k_max,) int32 depo lists per active slot. Bit-identical
    to ``fused_rasterize_scatter`` for the same depos and seed.
    """
    params, dev = _checked_params(wire, tick, sigma_w, sigma_t, charge, w0,
                                  t0)
    tiles_w, tiles_t, _ = tile_counts(num_wires, num_ticks, tw, tt)
    n_cap = active_tiles.shape[0]
    _check("active_tiles", active_tiles, torch.int32, n_cap, dev)
    _check("tile_ids", tile_ids, torch.int32, n_cap * k_max, dev)
    s0, s1 = _seed_words(seed)
    if dev.type == "cpu":
        blocks = ref.fused_rasterize_scatter_compact_ref(
            params, active_tiles, tile_ids, tiles_t=tiles_t, tw=tw, tt=tt,
            k_max=k_max, pw=pw, pt=pt, seed=(s0, s1), fluctuate=fluctuate)
    else:
        blocks = torch.empty((n_cap, tw, tt), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            err = _library().fused_sim_compact(
                *(x.data_ptr() for x in params), active_tiles.data_ptr(),
                tile_ids.data_ptr(), s0, s1, int(fluctuate), n_cap, tiles_t,
                tw, tt, pw, pt, k_max, blocks.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(err, "fused_sim_compact")
        LAUNCHES["fused_rasterize_scatter_compact"] += 1
    return scatter_tiles_to_grid(blocks, active_tiles, tiles_w, tiles_t, tw,
                                 tt)[:num_wires, :num_ticks]


def scatter_tiles_to_grid(blocks: torch.Tensor, active_tiles: torch.Tensor,
                          tiles_w: int, tiles_t: int, tw: int,
                          tt: int) -> torch.Tensor:
    """Place (n_cap, tw, tt) blocks into the padded (tiles_w*tw,
    tiles_t*tt) grid; -1 slots are dropped, unoccupied tiles stay zero."""
    n_tiles = tiles_w * tiles_t
    # -1 slots land in one extra row that is cut off (no host sync)
    dest = torch.where(active_tiles >= 0, active_tiles,
                       torch.full_like(active_tiles, n_tiles)).long()
    full = torch.zeros((n_tiles + 1, tw, tt), dtype=blocks.dtype,
                       device=blocks.device)
    full.index_copy_(0, dest, blocks)
    return full[:n_tiles].reshape(tiles_w, tiles_t, tw, tt).transpose(
        1, 2).reshape(tiles_w * tw, tiles_t * tt)
