"""Charge fluctuation: the binomial draw as its normal approximation.

The observed electron count of a patch pixel with mean ``p = q*w`` is
Binomial(q, w); the simulation draws N(p, p*(1 - p/q)) instead, clamped at
zero. ``counter`` fluctuation draws its normals from the threefry stream of
the charge-grid key (``fluctuate_counter``; ``fluctuate_counter_relaxed``
is its differentiable form, the same bits forward); ``pool`` fluctuation
takes them from a pre-computed pool indexed by pixel id (``make_pool``,
``fluctuate_pool``); the fused kernel draws
them from the stateless counter hash below, seeded per (depo, tile), and the
plane-flattened ``multiplane_xla`` charge grid from its one-hash erfinv
form (``counter_normals_erfinv``).

The counter hash is uint32 arithmetic carried in int64 tensors masked to 32
bits (torch on the CPU has no ``>>`` for uint32); the 32x32-bit multiplies
are split into 16-bit halves so no intermediate leaves int64.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import prng
from repro_torch.device import resolve_device

MASK32 = prng.MASK32
#: fmix32 multipliers (murmur3's 32-bit finalizer)
FMIX_C1 = 0x85EBCA6B
FMIX_C2 = 0xC2B2AE35
#: 2*pi as the float32 the reference's weak-typed Python float rounds to
TWO_PI_F32 = float(torch.tensor(2.0 * math.pi, dtype=torch.float32))


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add.

    The product of two float32 values is exact in float64. Their float64
    sum is taken with rounding to odd (round to nearest, then the last bit
    forced odd when the sum was inexact), which makes the final rounding to
    float32 correct: float64 carries more than 24 + 2 bits.
    """
    p = a.to(torch.float64) * b.to(torch.float64)  # repro-lint: disable=f64-literal — exact product for the FMA
    cd = c.to(torch.float64)  # repro-lint: disable=f64-literal — exact FMA emulation, rounded to f32 below
    s = p + cd
    # TwoSum: the exact rounding error of s
    bv = s - p
    err = (p - (s - bv)) + (cd - bv)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


class _FusedMulAdd(torch.autograd.Function):
    """``fma_f32`` forward; the derivative of ``a * b + c`` backward, so the
    relaxed bfloat16 draw carries a gradient whatever autograd makes of
    ``fma_f32``'s bit views and ``nextafter``."""

    @staticmethod
    def forward(ctx, a, b, c):
        ctx.save_for_backward(a, b)
        ctx.c_dtype = c.dtype
        return fma_f32(a, b, c)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        return ((grad * b).to(a.dtype), (grad * a).to(b.dtype),
                grad.to(ctx.c_dtype))


def _moments(patches: torch.Tensor, charge: torch.Tensor) -> torch.Tensor:
    """The binomial variance p*(1 - p/q) of each patch pixel, >= 0."""
    q = torch.clamp_min(charge[:, None, None], 1.0)
    p = torch.clamp(patches / q, 0.0, 1.0)
    return torch.clamp_min(patches * (1.0 - p), 0.0)


def binomial_normal_approx(patches: torch.Tensor, charge: torch.Tensor,
                           normals: torch.Tensor) -> torch.Tensor:
    """patches (N, pw, pt) mean counts, charge (N,) totals, normals like
    patches -> fluctuated float32 patches.

    bfloat16 patches meet the float32 charge and widen to float32, as in
    the reference. For them the last step is the jitted reference's: XLA
    contracts ``patches + sqrt(var) * normals`` into one fused multiply-add
    (``fma_f32``) after a correctly rounded square root (torch's float32
    ``sqrt`` on the CPU is not always one; the root of a float32 through
    float64 is). float32 patches keep the separately rounded form.
    """
    var = _moments(patches, charge)
    if patches.dtype == torch.bfloat16:
        sd = torch.sqrt(var.to(torch.float64)).to(torch.float32)  # repro-lint: disable=f64-literal — correctly rounded float32 root
        return torch.clamp_min(fma_f32(sd, normals, patches), 0.0)
    return torch.clamp_min(patches + torch.sqrt(var) * normals, 0.0)


def binomial_normal_relaxed(patches: torch.Tensor, charge: torch.Tensor,
                            normals: torch.Tensor) -> torch.Tensor:
    """The reparameterised (differentiable) form of
    ``binomial_normal_approx``, bit for bit the same forward in both its
    float32 and its bfloat16 (fused multiply-add) forms: the zero-variance
    pixels are masked before the square root, so the gradient through
    padding depos and empty pixels is 0, not NaN. The normals are fixed
    noise; gradients flow through the mean and the standard deviation."""
    var = _moments(patches, charge)
    pos = var > 0.0
    safe = torch.where(pos, var, 1.0)
    if patches.dtype == torch.bfloat16:
        root = torch.sqrt(safe.to(torch.float64)).to(torch.float32)  # repro-lint: disable=f64-literal — correctly rounded float32 root
        sd = torch.where(pos, root, 0.0)
        return torch.clamp_min(_FusedMulAdd.apply(sd, normals, patches), 0.0)
    std = torch.where(pos, torch.sqrt(safe), 0.0)
    return torch.clamp_min(patches + std * normals, 0.0)


def _counter_normals(k: torch.Tensor, patches: torch.Tensor) -> torch.Tensor:
    """Threefry normals from key ``k`` in ``patches.dtype``: bfloat16
    patches draw bfloat16 normals, held in float32 as the jitted reference
    holds them (``prng.normal_bf16_wide``)."""
    if patches.dtype == torch.bfloat16:
        return prng.normal_bf16_wide(k, patches.shape, patches.device)
    return prng.normal(k, patches.shape, patches.device, patches.dtype)


def fluctuate_counter(k: torch.Tensor, patches: torch.Tensor,
                      charge: torch.Tensor) -> torch.Tensor:
    """Fluctuate with threefry normals drawn from key ``k``; bfloat16
    patches come out float32."""
    return binomial_normal_approx(patches, charge, _counter_normals(k, patches))


def fluctuate_counter_relaxed(k: torch.Tensor, patches: torch.Tensor,
                              charge: torch.Tensor) -> torch.Tensor:
    """``fluctuate_counter`` with finite gradients (``rng_strategy=
    "relaxed"``): the same normals from the same key, the same forward
    bits; the calibration loss (``repro_torch.core.fit``) needs it when
    ``cfg.fluctuate``."""
    return binomial_normal_relaxed(patches, charge,
                                   _counter_normals(k, patches))


def make_pool(k: torch.Tensor, pool_size: int = 1 << 20,
              device="cuda") -> torch.Tensor:
    """The pre-computed pool of ``pool_size`` float32 standard normals drawn
    from key ``k`` (``rng_strategy="pool"``, the paper's ref-CUDA/Kokkos
    design): ``jax.random.normal(k, (pool_size,))``, its threefry bits
    exact and its normals up to the ULPs of ``erfinv``."""
    return prng.normal(k, (pool_size,), resolve_device(device))


def fluctuate_pool(pool: torch.Tensor, patches: torch.Tensor,
                   charge: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """Fluctuate with the normals of ``pool`` indexed by flat pixel id,
    ``(i + offset) mod pool.numel()``: no random draw in the loop. The
    normals stay float32 for bfloat16 patches too, which therefore take
    ``binomial_normal_approx``'s fused multiply-add form."""
    # the reference indexes in uint32; a full-width event has 100 000 x 400
    # = 4e7 pixels, below 2**31, so the int64 index is the same number
    idx = (torch.arange(patches.numel(), dtype=torch.int64,
                        device=patches.device) + offset) % pool.numel()
    normals = pool[idx].reshape(patches.shape)
    del idx  # 320 MB at full width: gone before the moments are formed
    return binomial_normal_approx(patches, charge, normals)


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 ``x`` < 2**32 and a 32-bit constant ``c``,
    without leaving int64: the product is taken in 16-bit halves of ``c``."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def hash_u32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 on int64 words < 2**32."""
    x = x ^ (x >> 16)
    x = mul32(x, FMIX_C1)
    x = x ^ (x >> 13)
    x = mul32(x, FMIX_C2)
    return x ^ (x >> 16)


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> float32 uniform in [0, 1) from the top 24 bits."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def box_muller(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Two uniforms -> one standard normal."""
    r = torch.sqrt(-2.0 * torch.log(torch.clamp_min(u1, 1e-12)))
    return r * torch.cos(TWO_PI_F32 * u2)


def counter_normals(seed0: int, seed1: int, stream: torch.Tensor,
                    counters: torch.Tensor) -> torch.Tensor:
    """Standard normals from (seed words, stream, per-pixel counter).

    ``seed0``/``seed1`` are the raw key words; ``stream`` (broadcastable to
    ``counters``) names the (depo, tile) pair; ``counters`` the pixels.
    """
    base = (hash_u32(torch.as_tensor(seed1, dtype=torch.int64,
                                     device=counters.device) ^ stream)
            + seed0) & MASK32
    two_c = (2 * counters) & MASK32
    b1 = hash_u32(base ^ hash_u32(two_c))
    b2 = hash_u32(base ^ hash_u32((two_c + 1) & MASK32))
    return box_muller(1.0 - uniform_from_bits(b1), uniform_from_bits(b2))


def counter_normals_erfinv(seed0, seed1, stream: torch.Tensor,
                           counters: torch.Tensor) -> torch.Tensor:
    """``counter_normals`` with ONE hash per draw and the inverse-CDF
    transform ``sqrt(2) * erfinv(max(2u - 1, nextafter(-1, 0)))`` that
    ``prng.normal`` applies to its uniforms: the same (seed, stream,
    counter) contract, a different bit stream. ``seed0``/``seed1`` are ints
    or int64 tensors broadcastable to ``counters``."""
    base = (hash_u32(torch.as_tensor(seed1, dtype=torch.int64,
                                     device=counters.device) ^ stream)
            + seed0) & MASK32
    u = uniform_from_bits(hash_u32(base ^ hash_u32(counters & MASK32)))
    return prng.SQRT2_F32 * torch.special.erfinv(
        torch.clamp_min(2.0 * u - 1.0, prng.NORMAL_LO))
