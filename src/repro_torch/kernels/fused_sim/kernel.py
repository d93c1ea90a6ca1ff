"""Wrappers of the fused rasterize + fluctuate + scatter CUDA kernels.

``fused_rasterize_scatter`` (dense tile grid),
``fused_rasterize_scatter_compact`` (occupied tiles only) and their
multi-plane forms ``fused_rasterize_scatter_multiplane`` and
``fused_rasterize_scatter_multiplane_compact`` (every plane in one launch)
replace the reference's Pallas kernels of the same names
(``src/repro/kernels/fused_sim/kernel.py:262``, ``:300``, ``:340`` and
``:392``). On CUDA tensors each wrapper launches its kernel from
``csrc/fused_sim.cu`` or raises; on CPU tensors it runs the plain PyTorch
version in ``ref.py``. ``LAUNCHES`` counts kernel launches per wrapper
(plain-version calls do not count).

The kernel's plane axis takes any independent rows, up to ``MAX_ROWS`` a
launch: the planes of one event, or the (event, plane) rows of a batch
(``repro_torch.core.batch``, the port's counterpart of the reference's
``vmap`` over events). A launch of one-plane rows (``one_plane=True``)
counts under the one-plane wrapper's name.

The CTAs start longest list first (``kernels/tiles.py``, whose two small
kernels this source compiles), and on the card the compact layout writes
each occupied tile in place into a grid zeroed once
(``tiles.scatter_tiles_to_grid_planes`` places the plain version's blocks
on the CPU path).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import (check_tensor, declare, kernel_device,
                                 load_library, plain_version, raise_on)
from repro_torch.kernels.fused_sim import ref
from repro_torch.kernels.scatter_add.ops import tile_counts
from repro_torch.kernels.tiles import (ORDER_ARGS, lengths_and_order,
                                       scatter_tiles_to_grid_planes)

#: kernel launches per wrapper since the last ``reset_launches``
LAUNCHES: Dict[str, int] = {"fused_rasterize_scatter": 0,
                            "fused_rasterize_scatter_compact": 0,
                            "fused_rasterize_scatter_multiplane": 0,
                            "fused_rasterize_scatter_multiplane_compact": 0}

#: the most rows (planes) one launch takes: ``kMaxPlanes`` of
#: csrc/fused_sim.cu, whose seed words travel by value
MAX_ROWS = 16

_P = ctypes.c_void_p
_I = ctypes.c_int
_PARAM_ARGS = [_P] * 7  # wire, tick, sigma_w, sigma_t, charge, w0, t0
# order, seeds, num_planes, n_depos, fluctuate, per_plane, n_tiles,
# tiles_t, tw, tt, pw, pt, k_max, lengths, out, stream
_TAIL_ARGS = [_P, _P] + [_I] * 11 + [_P, _P, _P]
#: the C entry points of csrc/fused_sim.cu and their argument types
SIGNATURES = {
    "fused_sim_dense": _PARAM_ARGS + [_P] + _TAIL_ARGS,  # + ids
    "fused_sim_compact": _PARAM_ARGS + [_P, _P] + _TAIL_ARGS,  # + active, ids
    "fused_sim_launch_order": ORDER_ARGS}  # wrapped by kernels/tiles.py

Seed = Tuple[int, int]


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _library() -> ctypes.CDLL:
    lib = load_library("fused_sim")
    for name, argtypes in SIGNATURES.items():
        declare(lib, name, argtypes)
    return lib


def _checked_params(wire, tick, sigma_w, sigma_t, charge, w0, t0,
                    num_planes: Optional[int] = None):
    """The seven depo parameters, checked to share one (N,) shape, or
    (num_planes, N) when ``num_planes`` is given; returns (params,
    device)."""
    dev = kernel_device(wire)
    lead = () if num_planes is None else (num_planes,)
    shape = lead + tuple(wire.shape[-1:])
    for nm, x in (("wire", wire), ("tick", tick), ("sigma_w", sigma_w),
                  ("sigma_t", sigma_t), ("charge", charge)):
        check_tensor(nm, x, torch.float32, shape, dev)
    check_tensor("w0", w0, torch.int32, shape, dev)
    check_tensor("t0", t0, torch.int32, shape, dev)
    return (wire, tick, sigma_w, sigma_t, charge, w0, t0), dev


def _seed_words(seed: Optional[Sequence[int]]) -> Seed:
    if seed is None:
        return 0, 0
    s0, s1 = (int(v) & 0xFFFFFFFF for v in seed)
    return s0, s1


def _launch(entry: str, name: str, params, lists, seeds: Sequence[Seed], *,
            per_plane: int, n_tiles: int, fluctuate: bool, tiles_t: int,
            tw: int, tt: int, pw: int, pt: int, k_max: int,
            out: torch.Tensor) -> None:
    """Launch ``entry`` over len(seeds) planes of ``per_plane`` slots,
    longest list first; the last of ``lists`` holds the depo lists."""
    dev = out.device
    lengths, order = lengths_and_order(lists[-1], k_max)
    words = (ctypes.c_uint32 * (2 * len(seeds)))(*(w for s in seeds
                                                     for w in s))
    with torch.cuda.device(dev):
        err = getattr(_library(), entry)(
            *(x.data_ptr() for x in params), *(x.data_ptr() for x in lists),
            order.data_ptr(), ctypes.addressof(words), len(seeds),
            params[0].shape[-1], int(fluctuate), per_plane, n_tiles, tiles_t,
            tw, tt, pw, pt, k_max, lengths.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, entry)
    LAUNCHES[name] += 1


def _check_rows(num_rows: int) -> None:
    """Raise unless one launch can take ``num_rows`` rows (on every device,
    so the CPU path holds callers to the card's limit)."""
    if not 1 <= num_rows <= MAX_ROWS:
        raise ValueError(f"{num_rows} rows in one launch; the fused kernel "
                         f"takes 1 to {MAX_ROWS} (split the rows)")


def _dense(name: str, params, tile_ids, seeds: Sequence[Seed], *,
           num_wires: int, num_ticks: int, tw: int, tt: int, k_max: int,
           pw: int, pt: int, fluctuate: bool = False) -> torch.Tensor:
    """The dense layout over len(seeds) planes of (P, N) parameters:
    (P, num_wires, num_ticks), counted under ``name``."""
    _check_rows(len(seeds))
    dev = params[0].device
    tiles_w, tiles_t, n_tiles = tile_counts(num_wires, num_ticks, tw, tt)
    check_tensor("tile_ids", tile_ids, torch.int32,
                 (len(seeds) * n_tiles * k_max,), dev)
    geom = dict(tiles_t=tiles_t, tw=tw, tt=tt, pw=pw, pt=pt, k_max=k_max)
    if dev.type == "cpu":
        with plain_version(name):
            out = ref.fused_rasterize_scatter_multiplane_ref(
                params, tile_ids, tiles_w=tiles_w, seeds=seeds,
                fluctuate=fluctuate, **geom)
    else:
        out = torch.empty((len(seeds), tiles_w * tw, tiles_t * tt),
                          dtype=torch.float32, device=dev)
        _launch("fused_sim_dense", name, params, [tile_ids], seeds,
                per_plane=n_tiles, n_tiles=n_tiles, fluctuate=fluctuate,
                out=out, **geom)
    return out[:, :num_wires, :num_ticks]


def _compact(name: str, params, active_tiles, tile_ids,
             seeds: Sequence[Seed], *, num_wires: int, num_ticks: int,
             tw: int, tt: int, k_max: int, pw: int, pt: int,
             fluctuate: bool = False) -> torch.Tensor:
    """The compact layout over len(seeds) planes of (P, N) parameters:
    (P, num_wires, num_ticks), counted under ``name``. On the card each
    occupied tile is written in place into a grid zeroed once."""
    _check_rows(len(seeds))
    dev = params[0].device
    num_planes = len(seeds)
    tiles_w, tiles_t, n_tiles = tile_counts(num_wires, num_ticks, tw, tt)
    n_slots = active_tiles.shape[0]
    if n_slots % num_planes:
        raise ValueError(f"{n_slots} active slots do not split into "
                         f"{num_planes} planes")
    check_tensor("active_tiles", active_tiles, torch.int32, (n_slots,), dev)
    check_tensor("tile_ids", tile_ids, torch.int32, (n_slots * k_max,), dev)
    geom = dict(tiles_t=tiles_t, tw=tw, tt=tt, pw=pw, pt=pt, k_max=k_max)
    if dev.type == "cpu":
        with plain_version(name):
            out = scatter_tiles_to_grid_planes(
                ref.fused_rasterize_scatter_multiplane_compact_ref(
                    params, active_tiles, tile_ids, seeds=seeds,
                    fluctuate=fluctuate, **geom),
                active_tiles, num_planes, tiles_w, tiles_t, tw, tt)
    else:
        out = torch.zeros((num_planes, tiles_w * tw, tiles_t * tt),
                          dtype=torch.float32, device=dev)
        _launch("fused_sim_compact", name, params, [active_tiles, tile_ids],
                seeds, per_plane=n_slots // num_planes, n_tiles=n_tiles,
                fluctuate=fluctuate, out=out, **geom)
    return out[:, :num_wires, :num_ticks]


def fused_rasterize_scatter(wire, tick, sigma_w, sigma_t, charge, w0, t0,
                            tile_ids, *, seed=None, **geom) -> torch.Tensor:
    """Depos -> (num_wires, num_ticks) charge grid over the dense tile grid.

    tile_ids: (n_tiles*k_max,) int32 per-tile depo lists (-1 padded);
    seed: the two raw words of the charge-grid key (read when fluctuate);
    geom: num_wires, num_ticks, tw, tt, k_max, pw, pt, fluctuate.
    """
    params, _ = _checked_params(wire, tick, sigma_w, sigma_t, charge, w0, t0)
    return _dense("fused_rasterize_scatter", tuple(x[None] for x in params),
                  tile_ids, [_seed_words(seed)], **geom)[0]


def fused_rasterize_scatter_compact(wire, tick, sigma_w, sigma_t, charge,
                                    w0, t0, active_tiles, tile_ids, *,
                                    seed=None, **geom) -> torch.Tensor:
    """Depos -> charge grid over the OCCUPIED tiles only.

    active_tiles: (n_cap,) int32 global tile ids (-1 padded);
    tile_ids: (n_cap*k_max,) int32 depo lists per active slot; seed and
    geom as for ``fused_rasterize_scatter``, to which it is bit-identical
    for the same depos and seed.
    """
    params, _ = _checked_params(wire, tick, sigma_w, sigma_t, charge, w0, t0)
    return _compact("fused_rasterize_scatter_compact",
                    tuple(x[None] for x in params), active_tiles, tile_ids,
                    [_seed_words(seed)], **geom)[0]


def _plane_seeds(seeds, num_planes: int):
    words = [_seed_words(None)] * num_planes if seeds is None else [
        _seed_words(s) for s in seeds]
    if len(words) != num_planes:
        raise ValueError(f"got {len(words)} seeds for {num_planes} planes")
    return words


def fused_rasterize_scatter_multiplane(wire, tick, sigma_w, sigma_t, charge,
                                       w0, t0, tile_ids, *, num_planes: int,
                                       seeds=None, one_plane: bool = False,
                                       **geom) -> torch.Tensor:
    """All P planes' charge grids in ONE launch (dense tile layout).

    Depo parameters are (P, N); tile_ids is each plane's dense
    (n_tiles*k_max,) list (plane-LOCAL depo ids) concatenated plane-major;
    seeds holds P pairs of raw key words (``fold_in(kf, p)``). Returns
    (P, num_wires, num_ticks), plane p bit-identical to
    ``fused_rasterize_scatter`` with plane p's parameters and seed.
    ``one_plane`` marks the rows as one-plane events (a batch's) and counts
    the launch as ``fused_rasterize_scatter``.
    """
    params, _ = _checked_params(wire, tick, sigma_w, sigma_t, charge, w0,
                                t0, num_planes)
    return _dense("fused_rasterize_scatter" if one_plane
                  else "fused_rasterize_scatter_multiplane", params,
                  tile_ids, _plane_seeds(seeds, num_planes), **geom)


def fused_rasterize_scatter_multiplane_compact(
        wire, tick, sigma_w, sigma_t, charge, w0, t0, active_tiles, tile_ids,
        *, num_planes: int, seeds=None, one_plane: bool = False,
        **geom) -> torch.Tensor:
    """Multi-plane fused kernel over each plane's OCCUPIED tiles.

    active_tiles: (P*n_cap,) int32 plane-LOCAL tile ids, n_cap slots per
    plane (-1 padded); tile_ids: (P*n_cap*k_max,) plane-local depo ids.
    Returns (P, num_wires, num_ticks), bit-identical per plane to
    ``fused_rasterize_scatter_multiplane``; ``one_plane`` counts the launch
    as ``fused_rasterize_scatter_compact``.
    """
    params, _ = _checked_params(wire, tick, sigma_w, sigma_t, charge, w0,
                                t0, num_planes)
    return _compact("fused_rasterize_scatter_compact" if one_plane
                    else "fused_rasterize_scatter_multiplane_compact",
                    params, active_tiles, tile_ids,
                    _plane_seeds(seeds, num_planes), **geom)

