"""Frequency-domain convolution and digitisation.

    S(t,x) --rfft2--> S(w) ; M(w) = R(w) S(w) ; M(w) --irfft2--> M(t,x)

Zero padding to the response's linear-convolution size avoids circular
wrap. The transforms go to cuFFT through ``torch.fft`` on the card, as the
reference leaves them to XLA. Two strategies, the reference's: ``rfft2``
(real-input half spectrum) and ``fft2`` (full complex spectrum, rebuilt from
the stored half by Hermitian symmetry). Each convolves one plane's (W, T)
grid; multi-plane stages call them once per plane.
"""
from __future__ import annotations

import torch

from repro_torch.config import LArTPCConfig
from repro_torch.core.response import DetectorResponse
from repro_torch.tune import autotune, registry
from repro_torch.tune.registry import register_strategy, set_default


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


def _full_spectrum(half: torch.Tensor, tp: int) -> torch.Tensor:
    """Full complex spectrum of a real signal from its rfft2 half spectrum:
    F[k1, k2] = conj(F[-k1 mod W, tp - k2])."""
    wp = half.shape[0]
    ncopy = tp - half.shape[1]
    rows = (-torch.arange(wp, device=half.device)) % wp
    cols = ncopy - torch.arange(ncopy, device=half.device)
    tail = torch.conj(half[rows][:, cols])
    return torch.cat([half, tail], dim=1)


@register_strategy("fft_convolve", "fft2",
                   note="full complex FFT; identical math, different layout")
def fft_convolve_fft2(grid: torch.Tensor, resp: DetectorResponse) -> torch.Tensor:
    w, t = grid.shape
    _, tp = resp.pad_shape
    padded = _pad_grid(grid, resp)
    freq = torch.fft.fft2(padded.to(torch.complex64))
    out = torch.fft.ifft2(freq * _full_spectrum(resp.freq, tp)).real
    return out[:w, :t].to(padded.dtype)


set_default("fft_convolve", "rfft2")


def resolve_spectrum_strategy(op: str, strategy: str | None, grid_shape,
                              resp: DetectorResponse, device) -> str:
    """A plane's strategy name for ``op`` (``fft_convolve`` or
    ``deconvolve``): None is the default of ``device``, ``"auto"`` the
    tuning cache's decision for the plane's grid and response dims and its
    kind (induction and collection transforms are different problems to
    the tuner), else that default; other names pass through."""
    if strategy is None:
        return registry.default_strategy(op, torch.device(device).type)
    if strategy == "auto":
        shape = {"num_wires": int(grid_shape[0]),
                 "num_ticks": int(grid_shape[1]),
                 "response_wires": int(resp.kernel.shape[0]),
                 "response_ticks": int(resp.kernel.shape[1]),
                 "plane": resp.plane}
        return autotune.resolve(op, None, shape=shape, device=device).strategy
    return strategy


def dispatch(op: str, strategy: str):
    """The registered function of ``strategy`` for ``op``; unknown names
    raise ``ValueError`` with the valid list."""
    try:
        return registry.get_strategy(op, strategy).fn
    except KeyError:
        valid = sorted(registry.strategies(op)) + ["auto"]
        raise ValueError(f"unknown {op} strategy {strategy!r}; valid: "
                         f"{valid}") from None


def fft_convolve(grid: torch.Tensor, resp: DetectorResponse,
                 strategy: str | None = None) -> torch.Tensor:
    """Linear 2-D convolution of the charge grid with the response.

    ``strategy`` may be None (the default of the grid's device), ``"auto"``
    (tuning cache, keyed by shape and plane kind, else that default) or a
    registered name; unknown names raise ``ValueError``."""
    name = resolve_spectrum_strategy("fft_convolve", strategy, grid.shape,
                                     resp, grid.device)
    return dispatch("fft_convolve", name)(grid, resp)


def digitize(signal: torch.Tensor, cfg: LArTPCConfig) -> torch.Tensor:
    """Voltage -> 12-bit ADC counts (int16), or the float straight-through
    form when ``cfg.digitize_ste`` (same forward values)."""
    adc = cfg.adc_baseline + cfg.adc_per_electron * signal
    if cfg.digitize_ste:
        clipped = torch.clamp(adc, 0.0, 4095.0)
        return clipped + (torch.round(clipped) - clipped).detach()
    return torch.clamp(torch.round(adc), 0, 4095).to(torch.int16)
