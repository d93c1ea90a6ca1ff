"""Device selection for the port's entry points.

Every entry point runs on the card unless the caller asks for the CPU: the
default is ``"cuda"``, and a missing card raises instead of falling back.

``scalar`` makes the divisor of an IEEE division: torch on the card turns
``tensor / python_float`` into a multiplication by the reciprocal (one ULP
off where the reference divides), and ``python_float / tensor`` is a
reciprocal times the scalar on every device. Dividing by (or into) a
float32 0-d tensor on the value's device is a true division everywhere.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    card is present (pass ``device="cpu"`` to run on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev


def scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a float32 0-d tensor on ``like``'s device: the operand
    of a division the reference takes in float32. Made by a fill on that
    device, not copied from the host, so the card's stream is not
    synchronised."""
    return torch.full((), value, dtype=torch.float32, device=like.device)
