"""Plain PyTorch version of the hit-scan kernel.

The same function as ``csrc/hitfind.cu``: the run scanner of
``repro_torch.core.hitfind`` (vectorised over wires, one step per tick),
returned in the kernel's layout. The CPU path and the tests use it; on the
card it serves only as the kernel's comparison.
"""
from __future__ import annotations

import torch

from repro_torch.core.hitfind import wire_scan


def hitfind_ref(decon: torch.Tensor, *, threshold: float, cap: int):
    """(W, T) grid -> (counts (W, 1) int32, charge, tick, peak (W, cap))."""
    counts, charge, tick, peak = wire_scan(decon, threshold, cap)
    return counts[:, None], charge, tick, peak
