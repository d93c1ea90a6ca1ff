"""Detector response R(t, x): field response x electronics shaping.

A synthetic response with MicroBooNE's structure: a wire-direction
induction profile times a time response (bipolar field response convolved
with a semi-Gaussian shaper), transformed once at the padded grid shape.
Induction planes get the bipolar field response, the collection plane the
unipolar one (``make_plane_responses``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.config import LArTPCConfig, plane_specs
from repro_torch.device import resolve_device, scalar


class DetectorResponse(NamedTuple):
    """A frequency-domain transfer function over the padded readout grid."""

    kernel: torch.Tensor    # (response_wires, response_ticks) real space
    freq: torch.Tensor      # rfft2 of the kernel at pad_shape (complex64)
    pad_shape: tuple        # (W_pad, T_pad) for linear convolution
    plane: str = "induction"


def _semigaussian(t_us: torch.Tensor, shaping_us=2.0) -> torch.Tensor:
    """CR-(RC)^4 semi-Gaussian electronics shaping response."""
    x = torch.clamp_min(t_us / scalar(shaping_us, t_us), 0.0)
    x2 = x * x
    h = (x2 * x2) * torch.exp(-4 * x)
    return h / (torch.max(h) + 1e-30)


def _field_time(t_us: torch.Tensor, plane: str) -> torch.Tensor:
    """Field-response time shape: bipolar (induction) or unipolar."""
    if plane == "collection":
        z = (t_us - 1.0) / scalar(0.5, t_us)
        return torch.exp(-0.5 * (z * z))
    z = (t_us - 1.5) / scalar(0.6, t_us)
    return -(t_us - 1.5) * torch.exp(-0.5 * (z * z))


def _convolve_head(a: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """First ``n`` samples of the full linear convolution of ``a`` and ``b``,
    as an explicit float32 product-and-sum (no convolution library call, so
    no TF32 path on the card)."""
    i = torch.arange(n, device=a.device)
    j = torch.arange(a.shape[0], device=a.device)
    lag = i[:, None] - j[None, :]                       # (n, len(a))
    ok = (lag >= 0) & (lag < b.shape[0])
    terms = a[None, :] * b[lag.clamp(0, b.shape[0] - 1)]
    return torch.where(ok, terms, torch.zeros_like(terms)).sum(dim=1)


def next_fast_len(n: int) -> int:
    """Smallest 2^a * 3^b * 5^c >= n (FFT-friendly size)."""
    if n <= 1:
        return 1
    best = 1 << (n - 1).bit_length()
    m5 = 1
    while m5 < best:
        m53 = m5
        while m53 < best:
            m = m53
            while m < n:
                m *= 2
            best = min(best, m)
            m53 *= 3
        m5 *= 5
    return best


def make_response(cfg: LArTPCConfig, plane: str = "induction",
                  device="cuda") -> DetectorResponse:
    dev = resolve_device(device)
    rw, rt = cfg.response_wires, cfg.response_ticks
    t_us = torch.arange(rt, dtype=torch.float32, device=dev) * cfg.tick_us
    time_resp = _field_time(t_us, plane)
    elec = _semigaussian(t_us, shaping_us=cfg.response_shaping_us)
    tr = _convolve_head(time_resp, elec, rt)
    tr = tr / (torch.max(torch.abs(tr)) + 1e-30)

    dw = torch.arange(rw, dtype=torch.float32, device=dev) - (rw - 1) / 2.0
    z = dw / scalar(rw / 6.0, dw)
    wire_prof = torch.exp(-0.5 * (z * z))
    wire_prof = wire_prof / torch.sum(wire_prof)

    kernel = wire_prof[:, None] * tr[None, :]
    # always applied (exact at 1.0), so a fitted gain has a gradient there
    kernel = kernel * scalar(cfg.response_gain, kernel)

    w_pad = next_fast_len(cfg.num_wires + rw - 1)
    t_pad = next_fast_len(cfg.num_ticks + rt - 1)
    kpad = torch.zeros((w_pad, t_pad), dtype=torch.float32, device=dev)
    kpad[:rw, :rt] = kernel
    # centre the wire axis so the output is aligned
    kpad = torch.roll(kpad, shifts=-(rw // 2), dims=0)
    freq = torch.fft.rfft2(kpad)
    return DetectorResponse(kernel=kernel, freq=freq, pad_shape=(w_pad, t_pad),
                            plane=plane)


def make_plane_responses(cfg: LArTPCConfig, device="cuda"):
    """One ``DetectorResponse`` per readout plane of ``cfg``, in plane order
    (bipolar for induction planes, unipolar for the collection plane)."""
    return tuple(make_response(cfg, plane=s.kind, device=device)
                 for s in plane_specs(cfg))


def make_distributed_response(cfg: LArTPCConfig, w_pad: int,
                              plane: str = "induction",
                              device="cuda") -> DetectorResponse:
    """The response transform at the distributed grid shape (``w_pad``,
    ``num_ticks``): cyclic convolution at the readout size, Wire-Cell's own
    convention (the response support is tiny beside the readout window, and
    the wrap lands in the pre-trigger padding). The kernel sits at the
    origin, rolled by ``-(rw // 2)`` along wires, then ``rfft2``."""
    base = make_response(cfg, plane, device=device)
    rw, rt = base.kernel.shape
    kpad = torch.zeros((w_pad, cfg.num_ticks), dtype=torch.float32,
                       device=base.kernel.device)
    kpad[:rw, :rt] = base.kernel
    kpad = torch.roll(kpad, shifts=-(rw // 2), dims=0)
    return DetectorResponse(kernel=base.kernel, freq=torch.fft.rfft2(kpad),
                            pad_shape=(w_pad, cfg.num_ticks), plane=plane)


def make_distributed_plane_responses(cfg: LArTPCConfig, w_pad: int,
                                     device="cuda"):
    """Per-plane responses at the distributed grid shape, in plane order."""
    return tuple(make_distributed_response(cfg, w_pad, plane=s.kind,
                                           device=device)
                 for s in plane_specs(cfg))
