"""Electronics noise N(t,x): frequency-shaped Gaussian noise per wire.

A synthetic 1/f-plus-plateau amplitude spectrum with random Gaussian
phases, inverse-FFT'd per wire. ``noise_spectrum`` scales it so the expected
time-domain RMS is ``cfg.noise_rms_adc`` (Parseval, with the self-conjugate
DC and even-n Nyquist bins carrying no imaginary part). The spectra of
every plane of an event are drawn by one launch of ``kernels/noise``
(``csrc/noise.cu``) on the card, by its plain version on the CPU.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.config import LArTPCConfig
from repro_torch.core import prng
from repro_torch.device import resolve_device, scalar
from repro_torch.kernels.noise import kernel as noise_kernel


def _parseval_weights(num_ticks: int, device) -> torch.Tensor:
    """Per-rfft-bin weight: 2 for interior bins, 0.5 for DC (and the
    Nyquist bin when ``num_ticks`` is even). Made by a select on the
    device: writing a Python number into one element of a card tensor
    copies it from the host and waits for the card."""
    nfreq = num_ticks // 2 + 1
    bins = torch.arange(nfreq, device=device)
    edge = (bins == 0) | ((bins == nfreq - 1) & (num_ticks % 2 == 0))
    return torch.where(edge, 0.5, 2.0).to(torch.float32)


def noise_spectrum(cfg: LArTPCConfig, device="cuda") -> torch.Tensor:
    """Amplitude spectrum (num_ticks//2+1,): 1/f + white, shaped."""
    device = resolve_device(device)
    n = cfg.num_ticks
    nfreq = n // 2 + 1
    f = torch.arange(nfreq, dtype=torch.float32, device=device) + 1.0
    amp = scalar(1.0, f) / torch.sqrt(f) + 0.3
    r = f / scalar(nfreq, f)
    amp = amp * torch.exp(-(r * r) * 2.0)
    w = _parseval_weights(n, device)
    norm = scalar(cfg.noise_rms_adc * n, amp) / torch.sqrt(
        torch.sum(w * (amp * amp)) + 1e-30)
    return amp * norm


def plane_key_words(k: torch.Tensor) -> Tuple[int, int, int, int]:
    """The key words a plane's spectrum is drawn with: ``split(k)``'s first
    key for the real parts, its second for the imaginary parts."""
    k1, k2 = prng.split_words(k)
    return k1 + k2


def sample_noise_planes(keys: Sequence[torch.Tensor], n_rows: int,
                        amp: torch.Tensor, num_ticks: int) -> torch.Tensor:
    """(len(keys), n_rows, num_ticks) realisations of the amplitude spectrum
    ``amp``, one a key: every plane's spectrum in one launch of the
    noise-spectrum kernel on the card (the plain version on the CPU), then
    one inverse transform over all planes (on the card, the bits of one
    transform a plane)."""
    spec = noise_kernel.noise_spectrum([plane_key_words(k) for k in keys],
                                       n_rows, amp, num_ticks)
    return torch.fft.irfft(spec, n=num_ticks, dim=-1)


def simulate_noise_planes(keys: Sequence[torch.Tensor], cfg: LArTPCConfig,
                          device="cuda") -> torch.Tensor:
    """(len(keys), num_wires, num_ticks) correlated noise, one realisation a
    key."""
    return sample_noise_planes(keys, cfg.num_wires,
                               noise_spectrum(cfg, device), cfg.num_ticks)


def simulate_noise(k: torch.Tensor, cfg: LArTPCConfig,
                   device="cuda") -> torch.Tensor:
    """(num_wires, num_ticks) correlated noise realisation."""
    return simulate_noise_planes([k], cfg, device)[0]
