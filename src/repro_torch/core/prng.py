"""Bit-exact threefry2x32 in the reference's partitionable mode.

The JAX package draws every random number through ``jax.random`` with
``jax_threefry_partitionable=True``; this module reproduces those draws bit
for bit: ``key``, ``split``, ``fold_in``, ``key_data``, ``random_bits`` and
``uniform`` in float32 and bfloat16, ``normal`` in float32 up to the ULPs
of ``erfinv``, and ``normal`` in bfloat16 bit for bit.

A key is a CPU int64 tensor of shape (2,) holding two uint32 words. Keys are
derived on the host (a handful of scalar hashes, no device launch); the bulk
draws run on the device their caller names. All 32-bit arithmetic runs in int64
masked to 32 bits, because torch on the CPU has no ``>>`` for uint32.
"""
from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA

Word = Union[int, torch.Tensor]


def _rotl(x: Word, r: int) -> Word:
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k0: int, k1: int, x0: Word, x1: Word) -> Tuple[Word, Word]:
    """The Threefry-2x32 block cipher (20 rounds) on int64 words < 2**32.

    ``k0``/``k1`` are the key words (Python ints); ``x0``/``x1`` the count
    words, tensors of one shape or Python ints.
    """
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = x0 ^ _rotl(x1, r)
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def key(seed: int) -> torch.Tensor:
    """``jax.random.key(seed)``: the raw key words ``[0, seed mod 2**32]``
    (the reference runs with x64 off, so the seed is a 32-bit integer)."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64)


def key_data(k: torch.Tensor) -> torch.Tensor:
    """The raw uint32 words of a key, as int64 (shape (..., 2))."""
    return k


def _words(k: torch.Tensor) -> Tuple[int, int]:
    if k.shape != (2,):
        raise ValueError(f"expected one key of shape (2,), got {tuple(k.shape)}")
    k0, k1 = k.tolist()
    return int(k0), int(k1)


def _iota_2x32(n: int, device, offset=0) -> Tuple[torch.Tensor, torch.Tensor]:
    """High and low words of the 64-bit iota of ``n`` elements from ``offset``."""
    counts = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
    return counts >> 32, counts & MASK32


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(k, num)`` -> (num, 2) keys (fold-like split)."""
    k0, k1 = _words(k)
    hi, lo = _iota_2x32(num, "cpu")
    b0, b1 = threefry2x32(k0, k1, hi, lo)
    return torch.stack([b0, b1], dim=-1)


def fold_in(k: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(k, data)``."""
    k0, k1 = _words(k)
    y0, y1 = threefry2x32(k0, k1, 0, int(data) & MASK32)
    return torch.tensor([y0, y1], dtype=torch.int64)


def random_bits(k: torch.Tensor, shape: Sequence[int],
                device, offset: int = 0) -> torch.Tensor:
    """32 random bits per element (int64 in [0, 2**32)), partitionable mode:
    ``bits1 ^ bits2`` of threefry over the 64-bit element index, the
    elements from ``offset`` on: a draw taken in ranges equals one draw."""
    k0, k1 = _words(k)
    hi, lo = _iota_2x32(math.prod(shape := tuple(map(int, shape))), device, offset)
    b0, b1 = threefry2x32(k0, k1, hi, lo)
    return (b0 ^ b1).reshape(shape)


def _f32(x: float) -> float:
    return float(np.float32(x))


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> float32 in [0, 1): random mantissa under exponent 0."""
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return fbits.view(torch.float32) - 1.0


def _bf16(x: float) -> float:
    """``x`` rounded to the nearest bfloat16, as a Python float."""
    return float(torch.tensor(x, dtype=torch.bfloat16))


def _bits_to_unit_bf16(bits: torch.Tensor) -> torch.Tensor:
    """The low 8 bits -> bfloat16 in [0, 1): 7 random mantissa bits under
    exponent 0 (``jax.random`` draws 8 bits for a type of fewer than 8
    mantissa bits and shifts one out)."""
    fbits = (((bits & 0xFF) >> 1) | 0x3F80).to(torch.int16)
    return fbits.view(torch.bfloat16) - 1.0


def _uniform_bf16(bits: torch.Tensor, minval: float,
                  maxval: float) -> torch.Tensor:
    """Random bits -> bfloat16 uniforms in [minval, maxval): the bounds,
    their difference, the product and the sum each rounded to bfloat16, as
    the reference's ops are."""
    lo = _bf16(minval)
    span = _bf16(_bf16(maxval) - lo)
    return torch.clamp_min(_bits_to_unit_bf16(bits) * span + lo, lo)


def uniform(k: torch.Tensor, shape: Sequence[int], minval: float, maxval: float,
            device, dtype=torch.float32, offset: int = 0) -> torch.Tensor:
    """``jax.random.uniform(k, shape, dtype, minval, maxval)``, bit exact,
    for ``dtype`` float32 or bfloat16 (``offset`` as in ``random_bits``)."""
    if dtype == torch.bfloat16:
        return _uniform_bf16(random_bits(k, shape, device, offset), minval, maxval)
    if dtype != torch.float32:
        raise NotImplementedError(f"uniform draws float32 or bfloat16, "
                                  f"not {dtype}")
    lo = _f32(minval)
    span = _f32(np.float32(maxval) - np.float32(minval))
    floats = _bits_to_unit(random_bits(k, shape, device, offset))
    # the reference's XLA contracts floats * span + lo into one FMA; the
    # product and the sum are exact in float64 (floats is a multiple of
    # 2**-23 below 1), so one rounding to float32 reproduces the FMA
    wide = floats.to(torch.float64) * span + lo  # repro-lint: disable=f64-literal — exact FMA emulation, rounded to f32 below
    return torch.clamp_min(wide.to(torch.float32), lo)


#: float32 nextafter(-1, 0): the reference's lower bound for erfinv inputs
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
SQRT2_F32 = _f32(np.sqrt(2.0))
#: the same bound and scale in bfloat16: nextafter(-1, 0) = -0.99609375 and
#: sqrt(2) rounded to 1.4140625
NORMAL_LO_BF16 = -1.0 + 2.0 ** -8
SQRT2_BF16 = _bf16(math.sqrt(2.0))


@functools.lru_cache(maxsize=None)
def _bf16_normal_table(device: str) -> torch.Tensor:
    """The 128 values a bfloat16 normal can take, indexed by its 7 random
    bits, as the reference holds them inside a jitted computation: ``erfinv``
    of the bfloat16 uniform, rounded to bfloat16, times ``SQRT2_BF16`` kept
    in float32 (a product of two bfloat16 values is exact in float32).
    Computed once on the CPU and copied to ``device``, so every device
    draws the same bits."""
    u = _uniform_bf16(torch.arange(0, 256, 2), NORMAL_LO_BF16, 1.0)
    erfinv = torch.erfinv(u.to(torch.float32)).to(torch.bfloat16)
    return (erfinv.to(torch.float32) * SQRT2_BF16).to(device)


def normal_bf16_wide(k: torch.Tensor, shape: Sequence[int], device,
                     offset: int = 0) -> torch.Tensor:
    """The bfloat16 normals of ``jax.random.normal(k, shape, bfloat16)`` as a
    jitted computation that consumes them holds them: float32, the last
    product not rounded to bfloat16 (``fluctuate_counter`` on bfloat16
    patches). Bit exact on every device: a table lookup of 7 random bits."""
    index = (random_bits(k, shape, device, offset) & 0xFF) >> 1
    return _bf16_normal_table(str(torch.device(device)))[index]


def normal(k: torch.Tensor, shape: Sequence[int], device,
           dtype=torch.float32, offset: int = 0) -> torch.Tensor:
    """``jax.random.normal(k, shape, dtype)``: ``sqrt(2) * erfinv(u)`` with
    ``u`` uniform in [nextafter(-1, 0), 1) of ``dtype``. bfloat16 normals
    are bit exact; float32 ones agree up to the ULPs of ``erfinv``.
    ``offset`` as in ``random_bits``."""
    if dtype == torch.bfloat16:
        return normal_bf16_wide(k, shape, device, offset).to(torch.bfloat16)
    u = uniform(k, shape, NORMAL_LO, 1.0, device, dtype, offset)
    return torch.erfinv(u) * SQRT2_F32
