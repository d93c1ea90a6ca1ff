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
#: the patch dtypes the port rasterizes (``cfg.patch_dtype``)
PATCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def axis_weights(center: torch.Tensor, sigma: torch.Tensor,
                  origin: torch.Tensor, npix: int) -> torch.Tensor:
    """Bin-integrated Gaussian weights along one axis: (N,) -> (N, npix)."""
    edges = (origin[:, None].to(torch.float32)
             + torch.arange(npix + 1, dtype=torch.float32,
                            device=center.device)[None, :])
    z = (edges - center[:, None]) / (sigma[:, None] * SQRT2)
    cdf = torch.special.erf(z)  # 2*Phi - 1; the 0.5 factors cancel
    # clamp: float32 erf differences in the far tail can go ~-1e-8
    return torch.clamp_min(0.5 * (cdf[:, 1:] - cdf[:, :-1]), 0.0)


def patch_dtype(cfg: LArTPCConfig) -> torch.dtype:
    """The torch dtype of ``cfg.patch_dtype``: float32 or bfloat16; any
    other raises ``NotImplementedError``."""
    if cfg.patch_dtype not in PATCH_DTYPES:
        raise NotImplementedError(
            f"the port rasterizes patch_dtype {sorted(PATCH_DTYPES)} only "
            f"(got {cfg.patch_dtype!r})")
    return PATCH_DTYPES[cfg.patch_dtype]


def rasterize(depos: DepoSet, cfg: LArTPCConfig):
    """All-depo rasterisation -> (patches (N, pw, pt) in ``cfg.patch_dtype``,
    w0, t0 int32). The weights are float32; a bfloat16 patch is the float32
    one rounded to nearest even, as XLA's convert rounds."""
    dtype = patch_dtype(cfg)
    w0, t0 = depo_patch_origin(depos, cfg)
    ww = axis_weights(depos.wire, depos.sigma_w, w0, cfg.patch_wires)
    wt = axis_weights(depos.tick, depos.sigma_t, t0, cfg.patch_ticks)
    patches = depos.charge[:, None, None] * ww[:, :, None] * wt[:, None, :]
    return patches.to(dtype), w0, t0


def rasterize_one(wire: torch.Tensor, tick: torch.Tensor,
                  sigma_w: torch.Tensor, sigma_t: torch.Tensor,
                  charge: torch.Tensor, w0: torch.Tensor, t0: torch.Tensor,
                  pw: int, pt: int) -> torch.Tensor:
    """One depo's (pw, pt) float32 patch (the fig3 per-depo dispatch unit):
    0-d float32 depo fields and patch origin in, the same erf differences
    and product order as the batched ``rasterize``."""
    dev = wire.device
    edges_w = w0 + torch.arange(pw + 1, dtype=torch.float32, device=dev)
    edges_t = t0 + torch.arange(pt + 1, dtype=torch.float32, device=dev)
    cw = torch.special.erf((edges_w - wire) / (sigma_w * SQRT2))
    ct = torch.special.erf((edges_t - tick) / (sigma_t * SQRT2))
    ww = torch.clamp_min(0.5 * (cw[1:] - cw[:-1]), 0.0)
    wt = torch.clamp_min(0.5 * (ct[1:] - ct[:-1]), 0.0)
    return charge * ww[:, None] * wt[None, :]
