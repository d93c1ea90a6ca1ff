"""The LArTPC signal simulation and its recon, written out plainly.

One event, from its key to its ADC and hits, in plain PyTorch on any
device, with no kernel, no batching and no tiling of the work:

    generate tracks -> drift onto each plane -> charge grid (Gaussian
    patches, binomial fluctuation) -> convolve with the response ->
    noise -> digitize [-> deconvolve -> threshold-scan hits]

What it computes is what the configuration file states; the random
numbers follow the simulator's stream definitions: threefry keys
(``threefry.py``) for the tracks and the noise, and a stateless counter
hash for the fluctuation, whose stream is named by (depo, readout tile)
and whose counter is the pixel's place inside that tile. The tile size is
part of that definition and is read from the configuration file.

``dtype`` selects the precision every float tensor is held in: float32
as configured, or bfloat16 for the benchmark's control (the FFTs, which
take no bfloat16, run in float32 on bfloat16-rounded operands and their
results are rounded back). The charge grid is summed in float64 at
float32 so that it does not depend on the order of the adds.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from plainref import threefry as tf

MASK32 = tf.MASK32
FMIX_C1 = 0x85EBCA6B
FMIX_C2 = 0xC2B2AE35
C_DEPO = 0x9E3779B9
C_TILE = 0x7FEB352D
SQRT2 = 1.4142135623730951
TWO_PI_F32 = float(np.float32(2.0 * math.pi))


class Plane(NamedTuple):
    index: int
    kind: str
    angle_deg: float
    pitch_mm: float


class Depos(NamedTuple):
    """One plane's depos, float32 (N,): centre (wire, tick), widths and
    electrons."""

    wire: torch.Tensor
    tick: torch.Tensor
    sigma_w: torch.Tensor
    sigma_t: torch.Tensor
    charge: torch.Tensor


class Hits(NamedTuple):
    """Every above-threshold run of one plane, wire-major then in time:
    wire (int64), tick (charge-weighted mean), charge (sum), peak (max),
    the sums in float64."""

    wire: torch.Tensor
    tick: torch.Tensor
    charge: torch.Tensor
    peak: torch.Tensor


def _div(x: torch.Tensor, v: float) -> torch.Tensor:
    """``x / v`` as a true float32 division (a tensor divided by a Python
    float may be turned into a product with the reciprocal)."""
    return x / torch.full((), v, dtype=x.dtype, device=x.device)


def planes(cfg: dict) -> List[Plane]:
    n = int(cfg["num_planes"])
    if n == 1:
        return [Plane(0, "induction", 0.0, float(cfg["wire_pitch_mm"]))]
    pitches = cfg["plane_pitches_mm"] or [cfg["wire_pitch_mm"]] * n
    return [Plane(p, cfg["plane_types"][p], float(cfg["plane_angles_deg"][p]),
                  float(pitches[p])) for p in range(n)]


# ---------------------------------------------------------------------------
# Depos: straight tracks, drifted onto each plane
# ---------------------------------------------------------------------------


def generate_tracks(k, cfg: dict, device) -> Dict[str, torch.Tensor]:
    """``num_depos`` depos on ``num_depos // 512`` straight tracks in the
    anode frame: x drift time [us], y transverse position [wire pitches],
    z along-wire position [mm], t deposition time, q electrons (lognormal
    about ``electrons_per_depo``)."""
    n = int(cfg["num_depos"])
    nw, nt = int(cfg["num_wires"]), int(cfg["num_ticks"])
    n_tracks = max(1, n // 512)
    k1, k2, k3, k4, k5 = tf.split(k, 5)
    entry_w = tf.uniform(k1, (n_tracks,), 0.0, nw - 1.0, device)
    entry_t = tf.uniform(k2, (n_tracks,), 0.0, nt - 1.0, device)
    theta = tf.uniform(k3, (n_tracks,), -1.2, 1.2, device)
    per = n // n_tracks + 1
    s = torch.arange(per, dtype=torch.float32, device=device)[None, :]
    wires = entry_w[:, None] + torch.sin(theta)[:, None] * s * 0.5
    ticks = entry_t[:, None] + torch.cos(theta)[:, None] * s * 2.0
    wires = torch.clamp(wires.reshape(-1)[:n].abs(), 0, nw - 1)
    ticks = torch.clamp(ticks.reshape(-1)[:n].abs(), 0, nt - 1)
    k5a, k5b = tf.split(k5)
    z_extent = nw * cfg["wire_pitch_mm"]
    entry_z = tf.uniform(k5a, (n_tracks,), 0.0, z_extent, device)
    dz = tf.uniform(k5b, (n_tracks,), -2.0, 2.0, device)
    zs = (entry_z[:, None] + dz[:, None] * s).reshape(-1)[:n]
    zs = torch.clamp(zs.abs(), 0, z_extent)
    q = cfg["electrons_per_depo"] * torch.exp(0.3 * tf.normal(k4, (n,),
                                                              device))
    return {"x": ticks * cfg["tick_us"], "y": wires, "z": zs,
            "t": torch.zeros((n,), dtype=torch.float32, device=device),
            "q": q}


def project(tracks: Dict[str, torch.Tensor], plane: Plane,
            cfg: dict) -> torch.Tensor:
    """The transverse coordinate in the plane's wire pitches: the wires
    rotated by the plane's angle, centred on the detector's box."""
    rad = math.radians(plane.angle_deg)
    cos_, sin_ = math.cos(rad), math.sin(rad)
    pitch0 = cfg["wire_pitch_mm"]
    cw = cos_ * pitch0 / plane.pitch_mm
    cz = sin_ / plane.pitch_mm
    nw = int(cfg["num_wires"])
    y_max = (nw - 1.0) * pitch0
    z_max = nw * pitch0
    lo = min(0.0, y_max * cos_) + min(0.0, z_max * sin_)
    hi = max(0.0, y_max * cos_) + max(0.0, z_max * sin_)
    off = (nw - 1.0) / 2.0 - (lo + hi) / (2.0 * plane.pitch_mm)
    if abs(off) < 1e-6:
        off = 0.0
    y = tracks["y"]
    if cw == 1.0 and cz == 0.0 and off == 0.0:
        return y
    y = y * cw
    if cz != 0.0:
        y = y + tracks["z"] * cz
    if off != 0.0:
        y = y + off
    return y


def drift(tracks: Dict[str, torch.Tensor], plane: Plane,
          cfg: dict) -> Depos:
    """Arrival tick, diffusion widths growing as sqrt(drift time) above
    their floors and clipped to the patch, charge after recombination and
    lifetime."""
    t_drift = tracks["x"]
    tick = _div(tracks["t"] + t_drift, cfg["tick_us"])
    sigma_t = _div(torch.sqrt(2.0 * cfg["diffusion_long"] * t_drift),
                   cfg["drift_speed_mm_us"] * cfg["tick_us"]) \
        * cfg["diffusion_scale"] + cfg["sigma_t_floor"]
    sigma_w = _div(torch.sqrt(2.0 * cfg["diffusion_tran"] * t_drift),
                   plane.pitch_mm) * cfg["diffusion_scale"] \
        + cfg["sigma_w_floor"]
    sigma_w = torch.clamp(sigma_w, min(0.3, cfg["sigma_w_floor"]),
                          (cfg["patch_wires"] / 2 - 1) / cfg["nsigma"])
    sigma_t = torch.clamp(sigma_t, min(0.3, cfg["sigma_t_floor"]),
                          (cfg["patch_ticks"] / 2 - 1) / cfg["nsigma"])
    q = tracks["q"] * cfg["recombination"]
    if cfg["electron_lifetime_us"] > 0.0:
        q = q * torch.exp(-_div(t_drift, cfg["electron_lifetime_us"]))
    return Depos(project(tracks, plane, cfg), tick, sigma_w, sigma_t, q)


def event_depos(k, cfg: dict, device) -> List[Depos]:
    """One event's depos on every plane."""
    tracks = generate_tracks(k, cfg, device)
    return [drift(tracks, p, cfg) for p in planes(cfg)]


# ---------------------------------------------------------------------------
# Charge grid
# ---------------------------------------------------------------------------


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, FMIX_C1)
    x = x ^ (x >> 13)
    x = _mul32(x, FMIX_C2)
    return x ^ (x >> 16)


def counter_normals(seed: Tuple[int, int], stream: torch.Tensor,
                    counter: torch.Tensor) -> torch.Tensor:
    """One standard normal per (stream, counter): two hashed uniforms of
    24 bits through Box-Muller."""
    base = (_fmix32(seed[1] ^ stream) + seed[0]) & MASK32
    two_c = (2 * counter) & MASK32
    b1 = _fmix32(base ^ _fmix32(two_c))
    b2 = _fmix32(base ^ _fmix32((two_c + 1) & MASK32))
    u1 = 1.0 - (b1 >> 8).to(torch.float32) * (1.0 / (1 << 24))
    u2 = (b2 >> 8).to(torch.float32) * (1.0 / (1 << 24))
    r = torch.sqrt(-2.0 * torch.log(torch.clamp_min(u1, 1e-12)))
    return r * torch.cos(TWO_PI_F32 * u2)


def patch_origin(d: Depos, cfg: dict):
    pw, pt = int(cfg["patch_wires"]), int(cfg["patch_ticks"])
    w0 = torch.round(d.wire).to(torch.int64) - pw // 2
    t0 = torch.round(d.tick).to(torch.int64) - pt // 2
    w0 = torch.clamp(w0, 0, int(cfg["num_wires"]) - pw)
    t0 = torch.clamp(t0, 0, int(cfg["num_ticks"]) - pt)
    return w0, t0


def _axis_weights(center, sigma, origin, npix: int):
    """Gaussian mass in each of ``npix`` unit bins from ``origin``."""
    edges = (origin[:, None] + torch.arange(npix, device=center.device)
             [None, :]).to(torch.float32)
    den = (sigma * SQRT2)[:, None]
    lo = torch.special.erf((edges - center[:, None]) / den)
    hi = torch.special.erf((edges + 1.0 - center[:, None]) / den)
    return torch.clamp_min(0.5 * (hi - lo), 0.0)


def charge_grid(d: Depos, seed: Optional[Tuple[int, int]], cfg: dict,
                dtype=torch.float32, block: int = 32768) -> torch.Tensor:
    """(W, T) electrons: each depo's patch of bin-integrated Gaussian mass,
    each pixel drawn from N(m, m (1 - m / q)) clamped at 0 when ``seed``
    is given (the counter stream of (depo, tile), counted by the pixel's
    place in its tile), summed over depos."""
    nw, nt = int(cfg["num_wires"]), int(cfg["num_ticks"])
    pw, pt = int(cfg["patch_wires"]), int(cfg["patch_ticks"])
    tw, tt = int(cfg["tile_wires"]), int(cfg["tile_ticks"])
    tiles_t = -(-nt // tt)
    dev = d.wire.device
    acc_dtype = torch.float64 if dtype == torch.float32 else dtype
    grid = torch.zeros(nw * nt, dtype=acc_dtype, device=dev)
    w0s, t0s = patch_origin(d, cfg)
    n = d.wire.shape[0]
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        w0, t0 = w0s[lo:hi], t0s[lo:hi]
        ww = _axis_weights(d.wire[lo:hi], d.sigma_w[lo:hi], w0, pw)
        wt = _axis_weights(d.tick[lo:hi], d.sigma_t[lo:hi], t0, pt)
        q = d.charge[lo:hi]
        ww, wt, q = ww.to(dtype), wt.to(dtype), q.to(dtype)
        vals = q[:, None, None] * ww[:, :, None] * wt[:, None, :]
        wire = w0[:, None, None] + torch.arange(pw, device=dev)[None, :, None]
        tick = t0[:, None, None] + torch.arange(pt, device=dev)[None, None, :]
        if seed is not None:
            depo = torch.arange(lo, hi, device=dev)[:, None, None]
            tile = (wire // tw) * tiles_t + tick // tt
            stream = _mul32(depo, C_DEPO) ^ _mul32(tile, C_TILE)
            counter = (wire % tw) * tt + tick % tt
            normals = counter_normals(seed, stream, counter).to(dtype)
            qc = torch.clamp_min(q, 1.0)[:, None, None]
            p = torch.clamp(vals / qc, 0.0, 1.0)
            var = torch.clamp_min(vals * (1.0 - p), 0.0)
            vals = torch.clamp_min(vals + torch.sqrt(var) * normals, 0.0)
        grid.index_add_(0, (wire * nt + tick).reshape(-1),
                        vals.reshape(-1).to(acc_dtype))
    return grid.to(dtype).to(torch.float32).reshape(nw, nt)


# ---------------------------------------------------------------------------
# Response, convolution, noise, digitization
# ---------------------------------------------------------------------------


def next_fast_len(n: int) -> int:
    """Smallest 2^a 3^b 5^c >= n."""
    best = 1 << max(n - 1, 0).bit_length()
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


def pad_shape(cfg: dict) -> Tuple[int, int]:
    return (next_fast_len(int(cfg["num_wires"]) + int(cfg["response_wires"])
                          - 1),
            next_fast_len(int(cfg["num_ticks"]) + int(cfg["response_ticks"])
                          - 1))


def response_kernel(cfg: dict, kind: str, device) -> torch.Tensor:
    """(response_wires, response_ticks): a Gaussian profile across wires
    times the field response's time shape (bipolar on induction planes,
    unipolar on collection) convolved with a CR-(RC)^4 shaper, peak 1."""
    rw, rt = int(cfg["response_wires"]), int(cfg["response_ticks"])
    t_us = torch.arange(rt, dtype=torch.float32, device=device) \
        * cfg["tick_us"]
    if kind == "collection":
        z = _div(t_us - 1.0, 0.5)
        field = torch.exp(-0.5 * (z * z))
    else:
        z = _div(t_us - 1.5, 0.6)
        field = -(t_us - 1.5) * torch.exp(-0.5 * (z * z))
    x = torch.clamp_min(_div(t_us, cfg["response_shaping_us"]), 0.0)
    x2 = x * x
    h = (x2 * x2) * torch.exp(-4 * x)
    shaper = h / (torch.max(h) + 1e-30)
    i = torch.arange(rt, device=device)
    lag = i[:, None] - i[None, :]
    ok = lag >= 0
    terms = field[None, :] * shaper[lag.clamp(0, rt - 1)]
    time_resp = torch.where(ok, terms, torch.zeros_like(terms)).sum(dim=1)
    time_resp = time_resp / (torch.max(torch.abs(time_resp)) + 1e-30)
    dw = torch.arange(rw, dtype=torch.float32, device=device) \
        - (rw - 1) / 2.0
    z = _div(dw, rw / 6.0)
    prof = torch.exp(-0.5 * (z * z))
    prof = prof / torch.sum(prof)
    kern = prof[:, None] * time_resp[None, :]
    return kern * torch.full((), cfg["response_gain"], dtype=torch.float32,
                             device=device)


def response_spectrum(cfg: dict, kind: str, device) -> torch.Tensor:
    """rfft2 of the kernel zero-padded to ``pad_shape`` for a linear
    convolution, its wire axis centred on the depo's wire."""
    kern = response_kernel(cfg, kind, device)
    rw, rt = kern.shape
    kpad = torch.zeros(pad_shape(cfg), dtype=torch.float32, device=device)
    kpad[:rw, :rt] = kern
    kpad = torch.roll(kpad, shifts=-(rw // 2), dims=0)
    return torch.fft.rfft2(kpad)


def _rounded(x: torch.Tensor, dtype) -> torch.Tensor:
    return x if dtype == torch.float32 else x.to(dtype).to(torch.float32)


def apply_spectrum(grid: torch.Tensor, spectrum: torch.Tensor,
                   cfg: dict, dtype=torch.float32) -> torch.Tensor:
    """Linear 2-D convolution through the padded half spectrum."""
    w, t = grid.shape
    wp, tp = pad_shape(cfg)
    padded = torch.zeros((wp, tp), dtype=torch.float32, device=grid.device)
    padded[:w, :t] = grid
    if dtype != torch.float32:
        spectrum = torch.complex(_rounded(spectrum.real, dtype),
                                 _rounded(spectrum.imag, dtype))
    out = torch.fft.irfft2(torch.fft.rfft2(padded) * spectrum, s=(wp, tp))
    return _rounded(out[:w, :t].contiguous(), dtype)


def noise_amplitude(cfg: dict, device) -> torch.Tensor:
    """1/sqrt(f) plus a plateau, rolled off, scaled so the expected RMS of
    a wire's waveform is ``noise_rms_adc`` (Parseval over rfft bins)."""
    n = int(cfg["num_ticks"])
    nfreq = n // 2 + 1
    f = torch.arange(nfreq, dtype=torch.float32, device=device) + 1.0
    amp = torch.full((), 1.0, device=device) / torch.sqrt(f) + 0.3
    r = _div(f, float(nfreq))
    amp = amp * torch.exp(-(r * r) * 2.0)
    bins = torch.arange(nfreq, device=device)
    edge = (bins == 0) | ((bins == nfreq - 1) & (n % 2 == 0))
    w = torch.where(edge, 0.5, 2.0).to(torch.float32)
    norm = torch.full((), cfg["noise_rms_adc"] * n, dtype=torch.float32,
                      device=device) / torch.sqrt(
        torch.sum(w * (amp * amp)) + 1e-30)
    return amp * norm


def noise(k, cfg: dict, device, dtype=torch.float32) -> torch.Tensor:
    """(W, T) noise in ADC counts: Gaussian real and imaginary parts of
    every rfft bin of every wire (the DC and Nyquist bins real), shaped by
    ``noise_amplitude``."""
    nw, nt = int(cfg["num_wires"]), int(cfg["num_ticks"])
    nfreq = nt // 2 + 1
    amp = _rounded(noise_amplitude(cfg, device), dtype)
    k1, k2 = tf.split(k)
    re = _rounded(tf.normal(k1, (nw, nfreq), device), dtype)
    im = _rounded(tf.normal(k2, (nw, nfreq), device), dtype)
    im[:, 0] = 0.0
    if nt % 2 == 0:
        im[:, -1] = 0.0
    scale = 0.7071067811865476
    spec = torch.complex(_rounded(re * amp[None, :] * scale, dtype),
                         _rounded(im * amp[None, :] * scale, dtype))
    return _rounded(torch.fft.irfft(spec, n=nt, dim=-1), dtype)


def digitize(signal: torch.Tensor, cfg: dict,
             dtype=torch.float32) -> torch.Tensor:
    """Electrons -> int16 ADC counts on the baseline, clipped to 12 bits."""
    adc = _rounded(cfg["adc_baseline"]
                   + _rounded(cfg["adc_per_electron"] * signal, dtype), dtype)
    return torch.clamp(torch.round(adc), 0, 4095).to(torch.int16)


# ---------------------------------------------------------------------------
# Recon: deconvolution and hits
# ---------------------------------------------------------------------------


def deconv_filter(spectrum: torch.Tensor, cfg: dict) -> torch.Tensor:
    """The bounded inverse conj(R) / (|R|^2 + lam max|R|^2), times a
    Gaussian low-pass in time frequency for the ``gaussian`` filter."""
    power = torch.real(spectrum * torch.conj(spectrum))
    g = torch.conj(spectrum) / (power + cfg["deconv_wiener_lambda"]
                                * torch.max(power))
    if cfg["deconv_filter"] == "gaussian":
        nyq = max(pad_shape(cfg)[1] // 2, 1)
        kk = torch.arange(g.shape[1], dtype=torch.float32, device=g.device)
        x = _div(kk, cfg["deconv_gauss_cut"] * nyq)
        g = g * torch.exp(-0.5 * (x * x))[None, :]
    elif cfg["deconv_filter"] != "wiener":
        raise ValueError(f"unknown deconv_filter {cfg['deconv_filter']!r}")
    return g.to(torch.complex64)


def deconvolve(adc: torch.Tensor, filt: torch.Tensor, cfg: dict,
               dtype=torch.float32) -> torch.Tensor:
    """ADC counts -> electrons (baseline off, gain divided) -> filtered."""
    meas = _rounded(_div(adc.to(torch.float32) - cfg["adc_baseline"],
                         max(cfg["adc_per_electron"], 1e-30)), dtype)
    return apply_spectrum(meas, filt, cfg, dtype)


def find_hits(decon: torch.Tensor, threshold: float) -> Hits:
    """Every run of consecutive ticks above ``threshold`` on each wire."""
    w, t = decon.shape
    v = decon.to(torch.float32)
    above = v > torch.tensor(threshold, dtype=torch.float32,
                             device=v.device)
    prev = torch.zeros_like(above)
    prev[:, 1:] = above[:, :-1]
    start = (above & ~prev).reshape(-1)
    flat_above = above.reshape(-1)
    run = torch.cumsum(start.to(torch.int64), 0) - 1
    n_runs = int(start.sum())
    idx = torch.nonzero(flat_above, as_tuple=True)[0]
    rid = run[idx]
    vals = v.reshape(-1)[idx].to(torch.float64)
    ticks = (idx % t).to(torch.float64)
    dev = v.device
    q = torch.zeros(n_runs, dtype=torch.float64, device=dev)
    q.index_add_(0, rid, vals)
    qt = torch.zeros(n_runs, dtype=torch.float64, device=dev)
    qt.index_add_(0, rid, vals * ticks)
    peak = torch.full((n_runs,), -math.inf, dtype=torch.float64, device=dev)
    peak = peak.scatter_reduce(0, rid, vals, reduce="amax")
    wire = torch.nonzero(start, as_tuple=True)[0] // t
    return Hits(wire, qt / torch.clamp_min(q, 1e-30), q, peak)


# ---------------------------------------------------------------------------
# One event
# ---------------------------------------------------------------------------


class Detector:
    """What an event needs that does not depend on it: each plane's
    response spectrum and, for recon, its inverse filter."""

    def __init__(self, cfg: dict, device, recon: bool = False):
        self.cfg = cfg
        self.device = torch.device(device)
        self.planes = planes(cfg)
        self.spectra = [response_spectrum(cfg, p.kind, self.device)
                        for p in self.planes]
        self.filters = ([deconv_filter(s, cfg) for s in self.spectra]
                        if recon else None)


def event_keys(event_key):
    """(charge-grid key, noise key) of an event."""
    kf, kn = tf.split(event_key)
    return kf, kn


def simulate(det: Detector, event_key, depos: Sequence[Depos], *,
             add_noise: bool, dtype=torch.float32) -> torch.Tensor:
    """(P, W, T) int16 ADC of one event's per-plane depos."""
    cfg = det.cfg
    kf, kn = event_keys(event_key)
    adcs = []
    for plane, d, spec in zip(det.planes, depos, det.spectra):
        seed = tf.fold_in(kf, plane.index) if cfg["fluctuate"] else None
        grid = charge_grid(d, seed, cfg, dtype)
        signal = apply_spectrum(grid, spec, cfg, dtype)
        if add_noise:
            n = noise(tf.fold_in(kn, plane.index), cfg, det.device, dtype)
            signal = _rounded(signal + _rounded(
                _div(n, max(cfg["adc_per_electron"], 1e-30)), dtype), dtype)
        adcs.append(digitize(signal, cfg, dtype))
        del grid, signal
    return torch.stack(adcs)


def recon(det: Detector, adc: torch.Tensor,
          dtype=torch.float32) -> List[Hits]:
    """Each plane's hits from its (W, T) ADC."""
    return [find_hits(deconvolve(adc[p], det.filters[p], det.cfg, dtype),
                      float(det.cfg["hit_threshold"]))
            for p in range(adc.shape[0])]
