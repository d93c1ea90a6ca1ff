"""Threefry-2x32 random streams, written out in plain PyTorch integer ops.

The simulator's random numbers are defined by JAX's partitionable threefry
streams: a key is two 32-bit words, ``split`` and ``fold_in`` derive keys,
and a draw of n elements hashes the 64-bit element index. This module
computes those streams from their definition (Salmon et al., "Parallel
random numbers: as easy as 1, 2, 3", SC 2011; JAX's ``threefry2x32`` with
``jax_threefry_partitionable``), so the benchmark can draw what the
simulator should have drawn without running any of its code.

Words are held in int64 tensors masked to 32 bits.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
KS_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k0: int, k1: int, x0, x1):
    """20 rounds of Threefry-2x32 on count words ``x0``/``x1`` (ints or
    int64 tensors of one shape) under the key words ``k0``/``k1``."""
    ks = (k0, k1, k0 ^ k1 ^ KS_PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = x0 ^ _rotl(x1, r)
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


Key = Tuple[int, int]


def key(seed: int) -> Key:
    """The key of a seed: words (0, seed mod 2**32)."""
    return 0, int(seed) & MASK32


def fold_in(k: Key, data: int) -> Key:
    return threefry2x32(k[0], k[1], 0, int(data) & MASK32)


def split(k: Key, num: int = 2) -> Sequence[Key]:
    return [threefry2x32(k[0], k[1], i >> 32, i & MASK32)
            for i in range(num)]


def random_bits(k: Key, shape: Sequence[int], device) -> torch.Tensor:
    """32 random bits an element (int64 in [0, 2**32)): ``b0 ^ b1`` of the
    cipher over the element's 64-bit index."""
    shape = tuple(int(s) for s in shape)
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(k[0], k[1], idx >> 32, idx & MASK32)
    return (b0 ^ b1).reshape(shape)


def _f32(x: float) -> float:
    return float(np.float32(x))


def uniform(k: Key, shape: Sequence[int], lo: float, hi: float,
            device) -> torch.Tensor:
    """float32 uniforms in [lo, hi): 23 random mantissa bits under exponent
    0 give u in [1, 2); ``(u - 1) * (hi - lo) + lo`` rounded once, as one
    fused multiply-add (the product and sum are exact in float64)."""
    bits = random_bits(k, shape, device)
    unit = (((bits >> 9) | 0x3F800000).to(torch.int32)
            .view(torch.float32) - 1.0)
    lo32 = _f32(lo)
    span = _f32(np.float32(hi) - np.float32(lo))
    wide = unit.to(torch.float64) * span + lo32
    return torch.clamp_min(wide.to(torch.float32), lo32)


#: the largest float32 below -1's successor: erfinv's lower input bound
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
SQRT2_F32 = _f32(math.sqrt(2.0))


def normal(k: Key, shape: Sequence[int], device) -> torch.Tensor:
    """float32 standard normals: ``sqrt(2) * erfinv(u)``, u uniform in
    [nextafter(-1, 0), 1)."""
    return torch.erfinv(uniform(k, shape, NORMAL_LO, 1.0, device)) \
        * SQRT2_F32
