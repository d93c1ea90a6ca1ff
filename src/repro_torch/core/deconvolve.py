"""Signal-processing deconvolution: the recon half of the sim -> recon loop.

    M(w) = R(w) S(w) + N(w)      (convolve stage + noise stage)
    S^(w) = G(w) M(w)            (this module)

A bare inverse 1/R blows up where |R| -> 0 (the bipolar induction response
integrates to ~0). Both filters regularise the inversion:

  wiener   : G = conj(R) / (|R|^2 + lam * max|R|^2), the gain bounded by
             1 / (2 sqrt(lam * max|R|^2)) however small |R| gets.
  gaussian : the same bounded inverse times a Gaussian low-pass along the
             time-frequency axis, whose DC gain is exactly 1.

A filter is a ``DetectorResponse`` (``freq = G`` at the response's
``pad_shape``), so applying it is the convolve stage's math. Two strategies
of the ``deconvolve`` op, as in the reference: ``rfft2`` (the half-spectrum
convolution) and ``fft_reuse`` (through ``fft_convolve``'s own strategy
table; the port has no autotuner, so ``"auto"`` is its default). The FFTs
are ``torch.fft`` calls, cuFFT on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import LArTPCConfig
from repro_torch.core.fft_conv import (dispatch, fft_convolve,
                                      fft_convolve_rfft2,
                                      resolve_spectrum_strategy)
from repro_torch.core.response import DetectorResponse, make_plane_responses
from repro_torch.device import scalar
from repro_torch.tune.registry import register_strategy, set_default

#: filter families ``make_deconv_filter`` accepts
DECONV_FILTERS = ("wiener", "gaussian")


def measured_signal(adc: torch.Tensor, cfg: LArTPCConfig) -> torch.Tensor:
    """ADC counts -> measured signal in electrons: the inverse of
    ``digitize``'s affine map (baseline shift, then a division by the
    gain); the rounding and clipping are not recoverable."""
    denom = torch.clamp_min(scalar(cfg.adc_per_electron, adc), 1e-30)
    return (adc.to(torch.float32) - cfg.adc_baseline) / denom


def _bounded_inverse(freq: torch.Tensor, lam: float) -> torch.Tensor:
    """conj(R) / (|R|^2 + lam * max|R|^2), the inverse both filters share;
    |R| = 0 maps to gain 0."""
    power = torch.real(freq * torch.conj(freq))
    floor = lam * torch.max(power)
    return torch.conj(freq) / (power + floor)


def make_deconv_filter(resp: DetectorResponse, cfg: LArTPCConfig,
                       kind: Optional[str] = None,
                       wiener_lambda: Optional[float] = None,
                       gauss_cut: Optional[float] = None) -> DetectorResponse:
    """The inverse filter G of ``resp`` as a ``DetectorResponse`` at
    ``resp.pad_shape`` with ``resp``'s kernel and plane kind.
    ``kind``/``wiener_lambda``/``gauss_cut`` default to the config."""
    kind = kind if kind is not None else cfg.deconv_filter
    lam = (wiener_lambda if wiener_lambda is not None
           else cfg.deconv_wiener_lambda)
    if kind not in DECONV_FILTERS:
        raise ValueError(
            f"unknown deconv filter {kind!r}; valid: {list(DECONV_FILTERS)}")
    g = _bounded_inverse(resp.freq, lam)
    if kind == "gaussian":
        cut = gauss_cut if gauss_cut is not None else cfg.deconv_gauss_cut
        # rfft half spectrum: column k is time-frequency index k; the window
        # exp(-(k / (cut * Nyquist))^2 / 2) is real and exactly 1 at k = 0
        nyq = max(resp.pad_shape[1] // 2, 1)
        k = torch.arange(g.shape[1], dtype=torch.float32, device=g.device)
        x = k / scalar(cut * nyq, k)
        window = torch.exp(-0.5 * (x * x))
        g = g * window[None, :]
    return DetectorResponse(kernel=resp.kernel, freq=g.to(torch.complex64),
                            pad_shape=resp.pad_shape, plane=resp.plane)


def make_plane_deconv_filters(cfg: LArTPCConfig, resps=None, device="cuda"):
    """One inverse filter per readout plane, in plane order, from ``resps``
    (default: ``make_plane_responses(cfg, device)``)."""
    if resps is None:
        resps = make_plane_responses(cfg, device=device)
    return tuple(make_deconv_filter(r, cfg) for r in resps)


# ---------------------------------------------------------------------------
# Strategies: the registry's ``deconvolve`` op
# ---------------------------------------------------------------------------


@register_strategy("deconvolve", "rfft2",
                   note="direct half-spectrum inverse-filter multiply")
def deconvolve_rfft2(meas: torch.Tensor,
                     filt: DetectorResponse) -> torch.Tensor:
    # pad -> rfft2 -> multiply G -> irfft2 -> crop
    return fft_convolve_rfft2(meas, filt)


@register_strategy("deconvolve", "fft_reuse",
                   note="the fft_convolve layout the tuning cache chose")
def deconvolve_fft_reuse(meas: torch.Tensor,
                         filt: DetectorResponse) -> torch.Tensor:
    # "auto" resolves from the fft_convolve cache (plane-keyed): the layout
    # that won the forward convolve of this plane kind runs here too
    return fft_convolve(meas, filt, strategy="auto")


set_default("deconvolve", "rfft2")


def deconvolve(meas: torch.Tensor, filt: DetectorResponse,
               strategy: Optional[str] = None) -> torch.Tensor:
    """Apply the inverse filter: measured signal (electrons, (W, T)) ->
    charge estimate in the charge grid's layout. ``strategy`` None is the
    default of the signal's device, ``"auto"`` the tuning cache's decision
    (keyed by shape and plane kind like the forward convolve), else that
    default; unknown names raise ``ValueError`` with the valid list."""
    name = resolve_spectrum_strategy("deconvolve", strategy, meas.shape,
                                     filt, meas.device)
    return dispatch("deconvolve", name)(meas, filt)
