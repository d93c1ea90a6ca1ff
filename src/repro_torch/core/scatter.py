"""Scatter-add: accumulate all depo patches into the readout grid S(t, x).

The ``"xla"`` strategy of the reference is one scatter-add of every patch
window; here it is one ``index_put_(accumulate=True)`` over the flat pixel
indices of all patches. ``depo_patch_origin`` clips every origin so no
window leaves the grid.
"""
from __future__ import annotations

import torch

from repro_torch.config import LArTPCConfig
from repro_torch.tune.registry import register_strategy, resolve, set_default


def flat_pixel_indices(w0: torch.Tensor, t0: torch.Tensor, pw: int, pt: int,
                       num_ticks: int) -> torch.Tensor:
    """Flat destination index of every patch pixel: (N, pw, pt) int64."""
    dw = torch.arange(pw, device=w0.device)[None, :, None]
    dt = torch.arange(pt, device=w0.device)[None, None, :]
    return ((w0.long()[:, None, None] + dw) * num_ticks
            + (t0.long()[:, None, None] + dt))


@register_strategy("scatter_add", "xla", note="one index_put_ accumulate")
def scatter_xla(patches: torch.Tensor, w0: torch.Tensor, t0: torch.Tensor,
                cfg: LArTPCConfig) -> torch.Tensor:
    n, pw, pt = patches.shape
    if pw > cfg.num_wires or pt > cfg.num_ticks:
        raise ValueError(f"patch ({pw}, {pt}) larger than the readout grid "
                         f"({cfg.num_wires}, {cfg.num_ticks})")
    idx = flat_pixel_indices(w0, t0, pw, pt, cfg.num_ticks).reshape(-1)
    grid = torch.zeros(cfg.num_wires * cfg.num_ticks, dtype=torch.float32,
                       device=patches.device)
    grid.index_put_((idx,), patches.reshape(-1).to(torch.float32),
                    accumulate=True)
    return grid.reshape(cfg.num_wires, cfg.num_ticks)


set_default("scatter_add", "xla")


def scatter_add(patches, w0, t0, cfg: LArTPCConfig,
                strategy: str | None = None) -> torch.Tensor:
    """Dispatch to a registered scatter strategy (``"auto"``: the default)."""
    return resolve("scatter_add", strategy or cfg.scatter_strategy).fn(
        patches, w0, t0, cfg)
