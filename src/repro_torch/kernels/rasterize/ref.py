"""Plain PyTorch version of the rasterize kernel.

The same function as ``csrc/rasterize.cu``: per depo, the bin-integrated
Gaussian patch ``(q * ww) * wt`` over the (pw, pt) support of a (pw_pad,
pt_pad) block, zero in the padding, then (``fluctuate``) the binomial
normal approximation with Box-Muller normals from the uniform pools u1, u2.

The reference's XLA on the CPU contracts the last step, ``patch +
sqrt(var) * normal``, into one fused multiply-add (one rounding), so this
version computes it as one too (``fma_f32``) and the kernel uses
``__fmaf_rn``; every other product and sum is rounded on its own, as in
the reference. The CPU path and the tests use this; on the card it serves
only as the kernel's comparison.
"""
from __future__ import annotations

import torch

from repro_torch.core.fluctuate import TWO_PI_F32
from repro_torch.core.rasterize import axis_weights

#: depos per step of the plain version (bounds its float64 temporaries)
CHUNK = 4096


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


def _block(wire, tick, sigma_w, sigma_t, charge, w0, t0, u1, u2, *, pw: int,
           pt: int, pw_pad: int, pt_pad: int, fluctuate: bool):
    ww = axis_weights(wire, sigma_w, w0, pw)                  # (B, pw)
    wt = axis_weights(tick, sigma_t, t0, pt)                  # (B, pt)
    ww = torch.nn.functional.pad(ww, (0, pw_pad - pw))
    wt = torch.nn.functional.pad(wt, (0, pt_pad - pt))
    q = charge[:, None, None]
    patch = q * ww[:, :, None] * wt[:, None, :]
    if fluctuate:
        u1c = torch.clamp_min(u1, 1e-12)
        normal = (torch.sqrt(-2.0 * torch.log(u1c))
                  * torch.cos(TWO_PI_F32 * u2))
        p = torch.clamp(patch / torch.clamp_min(q, 1.0), 0.0, 1.0)
        var = torch.clamp_min(patch * (1.0 - p), 0.0)
        patch = torch.clamp_min(fma_f32(torch.sqrt(var), normal, patch), 0.0)
    return patch


def rasterize_ref(wire, tick, sigma_w, sigma_t, charge, w0, t0, u1, u2, *,
                  pw: int, pt: int, pw_pad: int = 0, pt_pad: int = 128,
                  fluctuate: bool = True) -> torch.Tensor:
    """(N,) depo parameters (w0, t0 int32 patch origins), u1/u2 (N, pw_pad,
    pt_pad) uniforms (unused without ``fluctuate``) -> (N, pw_pad, pt_pad)
    float32 patches, zero in the padding."""
    n = wire.shape[0]
    pw_pad = pw_pad or ((pw + 7) // 8 * 8)
    out = torch.empty((n, pw_pad, pt_pad), dtype=torch.float32,
                      device=wire.device)
    for lo in range(0, n, CHUNK):
        sl = slice(lo, lo + CHUNK)
        out[sl] = _block(
            wire[sl], tick[sl], sigma_w[sl], sigma_t[sl], charge[sl], w0[sl],
            t0[sl], u1[sl] if fluctuate else None,
            u2[sl] if fluctuate else None, pw=pw, pt=pt, pw_pad=pw_pad,
            pt_pad=pt_pad, fluctuate=fluctuate)
    return out
