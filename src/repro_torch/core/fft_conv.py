"""Frequency-domain convolution and digitisation.

    S(t,x) --rfft2--> S(w) ; M(w) = R(w) S(w) ; M(w) --irfft2--> M(t,x)

Zero padding to the response's linear-convolution size avoids circular
wrap. The transforms go to cuFFT through ``torch.fft`` on the card, as the
reference leaves them to XLA.
"""
from __future__ import annotations

import torch

from repro_torch.config import LArTPCConfig
from repro_torch.core.response import DetectorResponse
from repro_torch.tune.registry import register_strategy, resolve, set_default


def _pad_grid(grid: torch.Tensor, resp: DetectorResponse) -> torch.Tensor:
    """Zero-pad the grid to the response's linear-convolution size, widening
    narrow dtypes to float32 (the FFT takes f32/f64 only)."""
    w, t = grid.shape
    wp, tp = resp.pad_shape
    if grid.dtype not in (torch.float32, torch.float64):  # repro-lint: disable=f64-literal — a dtype check, not a cast
        grid = grid.to(torch.float32)
    out = torch.zeros((wp, tp), dtype=grid.dtype, device=grid.device)
    out[:w, :t] = grid
    return out


@register_strategy("fft_convolve", "rfft2", note="real-input half-spectrum FFT")
def fft_convolve_rfft2(grid: torch.Tensor, resp: DetectorResponse) -> torch.Tensor:
    w, t = grid.shape
    wp, tp = resp.pad_shape
    freq = torch.fft.rfft2(_pad_grid(grid, resp))
    out = torch.fft.irfft2(freq * resp.freq, s=(wp, tp))
    return out[:w, :t]


set_default("fft_convolve", "rfft2")


def fft_convolve(grid: torch.Tensor, resp: DetectorResponse,
                 strategy: str | None = None) -> torch.Tensor:
    """Linear 2-D convolution of the charge grid with the response."""
    return resolve("fft_convolve", strategy or "auto").fn(grid, resp)


def digitize(signal: torch.Tensor, cfg: LArTPCConfig) -> torch.Tensor:
    """Voltage -> 12-bit ADC counts (int16), or the float straight-through
    form when ``cfg.digitize_ste`` (same forward values)."""
    adc = cfg.adc_baseline + cfg.adc_per_electron * signal
    if cfg.digitize_ste:
        clipped = torch.clamp(adc, 0.0, 4095.0)
        return clipped + (torch.round(clipped) - clipped).detach()
    return torch.clamp(torch.round(adc), 0, 4095).to(torch.int16)
