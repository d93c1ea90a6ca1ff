"""Wrapper of the per-wire hit-scan CUDA kernel.

``hitfind_pallas`` replaces the reference's Pallas kernel of the same name
(``src/repro/kernels/hitfind/kernel.py:40``) and returns what it returns:
counts (W, 1) int32 and charge, tick, peak (W, cap) float32. On a CUDA
tensor it launches ``hitfind_scan`` from ``csrc/hitfind.cu`` or raises; on a
CPU tensor it runs the plain PyTorch version in ``ref.py``. ``LAUNCHES``
counts kernel launches (plain-version calls do not count).
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import (check_tensor, declare, kernel_device,
                                 load_library, raise_on)
from repro_torch.kernels.hitfind import ref

#: kernel launches per wrapper since the last ``reset_launches``
LAUNCHES: Dict[str, int] = {"hitfind_pallas": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _library() -> ctypes.CDLL:
    lib = load_library("hitfind")
    # decon, num_wires, num_ticks, threshold, cap, counts, charge, tick,
    # peak, stream
    declare(lib, "hitfind_scan",
            [_P, _I, _I, ctypes.c_float, _I] + [_P] * 5)
    return lib


def hitfind_pallas(decon: torch.Tensor, *, threshold: float, cap: int):
    """Scan every wire of a (W, T) float32 grid for runs of samples >
    ``threshold`` (compared in float32). Returns (counts (W, 1) int32,
    charge (W, cap), tick (W, cap), peak (W, cap)): the total run count per
    wire and the first ``cap`` runs, zero past them."""
    dev = kernel_device(decon)
    if decon.ndim != 2:
        raise ValueError(f"decon: expected (W, T), got {tuple(decon.shape)}")
    check_tensor("decon", decon, torch.float32, tuple(decon.shape), dev)
    if cap < 1:
        raise ValueError(f"cap must be >= 1, got {cap}")
    if dev.type == "cpu":
        return ref.hitfind_ref(decon, threshold=threshold, cap=cap)
    w, t = decon.shape
    counts = torch.empty((w, 1), dtype=torch.int32, device=dev)
    charge, tick, peak = (torch.empty((w, cap), dtype=torch.float32,
                                      device=dev) for _ in range(3))
    with torch.cuda.device(dev):
        err = _library().hitfind_scan(
            decon.data_ptr(), w, t, threshold, cap, counts.data_ptr(),
            charge.data_ptr(), tick.data_ptr(), peak.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, "hitfind_scan")
    LAUNCHES["hitfind_pallas"] += 1
    return counts, charge, tick, peak
