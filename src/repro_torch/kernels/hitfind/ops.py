"""Wrapper of the per-wire hit-scan kernel in the ``hit_find`` strategy
layout."""
from __future__ import annotations

import torch

from repro_torch.kernels.hitfind.kernel import hitfind_pallas


def find_wire_hits_pallas(decon: torch.Tensor, *, threshold: float,
                          cap: int):
    """(W, T) deconvolved grid -> per-wire candidates (counts (W,) int32,
    charge/tick/peak (W, cap) float32), the layout (and the bits) of the
    ``scan`` strategy."""
    counts, charge, tick, peak = hitfind_pallas(
        decon.to(torch.float32).contiguous(), threshold=threshold, cap=cap)
    return counts[:, 0], charge, tick, peak
