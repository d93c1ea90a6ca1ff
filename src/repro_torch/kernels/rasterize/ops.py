"""Public wrapper of the rasterize kernel: DepoSet -> padded patches."""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.config import LArTPCConfig
from repro_torch.core import prng
from repro_torch.core.depo import DepoSet, depo_patch_origin
from repro_torch.device import resolve_device
from repro_torch.kernels.rasterize.kernel import rasterize_pallas


def pad_depos(depos: DepoSet, block: int):
    """Pad the depos to a multiple of ``block`` with sigma 1 and charge 0
    (their patches are zero); returns (padded, original count)."""
    n = depos.n
    pad = -n % block
    if pad == 0:
        return depos, n

    def padf(x: torch.Tensor, fill: float) -> torch.Tensor:
        return torch.nn.functional.pad(x, (0, pad), value=fill)

    return DepoSet(wire=padf(depos.wire, 0.0), tick=padf(depos.tick, 0.0),
                   sigma_w=padf(depos.sigma_w, 1.0),
                   sigma_t=padf(depos.sigma_t, 1.0),
                   charge=padf(depos.charge, 0.0)), n


def uniform_pools(key: torch.Tensor, shape: Sequence[int], device):
    """The Box-Muller uniform pools u1, u2 of ``split(key)``, drawn as
    ``jax.random.uniform`` draws them (bit exact)."""
    k1, k2 = prng.split(key)
    return (prng.uniform(k1, shape, 0.0, 1.0, device),
            prng.uniform(k2, shape, 0.0, 1.0, device))


def rasterize_depos(key: torch.Tensor, depos: DepoSet, cfg: LArTPCConfig,
                    depo_block: int = 256, fluctuate: bool = True,
                    device="cuda"):
    """Rasterize (and fluctuate) every depo with the rasterize kernel on
    ``device``.

    The depos are padded to a multiple of ``depo_block`` and the uniform
    pools drawn over the padded shape, so they are the reference's bits.
    Returns (patches (N, pw_pad, pt_pad), w0, t0) for the original N.
    """
    dev = resolve_device(device)
    padded, n = pad_depos(depos.to(dev), depo_block)
    w0, t0 = depo_patch_origin(padded, cfg)
    pw_pad = (cfg.patch_wires + 7) // 8 * 8
    pt_pad = cfg.pad_ticks
    u1 = u2 = None
    if fluctuate:
        u1, u2 = uniform_pools(key, (padded.n, pw_pad, pt_pad), dev)
    patches = rasterize_pallas(
        *padded, w0, t0, u1, u2, pw=cfg.patch_wires, pt=cfg.patch_ticks,
        pw_pad=pw_pad, pt_pad=pt_pad, depo_block=depo_block,
        fluctuate=fluctuate)
    return patches[:n], w0[:n], t0[:n]
