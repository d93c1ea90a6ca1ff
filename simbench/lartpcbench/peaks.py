"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit)."""
from __future__ import annotations

#: float32 operations a second outside the tensor cores
F32_OPS_S = 67e12
#: HBM3 bytes a second
HBM_BYTES_S = 3.35e12


def bound_s(ops: float, nbytes: float) -> float:
    """The least time of a piece of work: the larger of its operations
    over the float32 rate and its bytes over the memory rate."""
    return max(ops / F32_OPS_S, nbytes / HBM_BYTES_S)
