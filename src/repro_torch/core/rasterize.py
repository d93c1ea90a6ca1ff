"""Batched rasterisation: depo -> (patch_wires x patch_ticks) charge patch.

Patch pixel (i, j) receives the bin-integrated Gaussian mass, an outer
product of per-axis erf differences:

    q * [Phi((i+1-mu_w)/s_w) - Phi((i-mu_w)/s_w)] * [same along ticks]
"""
from __future__ import annotations

import torch

from repro_torch.config import LArTPCConfig
from repro_torch.core.depo import DepoSet, depo_patch_origin

#: sqrt(2); a float32 tensor times this Python float rounds it to float32,
#: as the reference's weak-typed constant is
SQRT2 = 1.4142135623730951


def _axis_weights(center: torch.Tensor, sigma: torch.Tensor,
                  origin: torch.Tensor, npix: int) -> torch.Tensor:
    """Bin-integrated Gaussian weights along one axis: (N,) -> (N, npix)."""
    edges = (origin[:, None].to(torch.float32)
             + torch.arange(npix + 1, dtype=torch.float32,
                            device=center.device)[None, :])
    z = (edges - center[:, None]) / (sigma[:, None] * SQRT2)
    cdf = torch.special.erf(z)  # 2*Phi - 1; the 0.5 factors cancel
    # clamp: float32 erf differences in the far tail can go ~-1e-8
    return torch.clamp_min(0.5 * (cdf[:, 1:] - cdf[:, :-1]), 0.0)


def rasterize(depos: DepoSet, cfg: LArTPCConfig):
    """All-depo rasterisation -> (patches (N, pw, pt) f32, w0, t0 int32)."""
    if cfg.patch_dtype != "float32":
        raise NotImplementedError("the port rasterizes float32 patches only")
    w0, t0 = depo_patch_origin(depos, cfg)
    ww = _axis_weights(depos.wire, depos.sigma_w, w0, cfg.patch_wires)
    wt = _axis_weights(depos.tick, depos.sigma_t, t0, cfg.patch_ticks)
    patches = depos.charge[:, None, None] * ww[:, :, None] * wt[:, None, :]
    return patches, w0, t0
