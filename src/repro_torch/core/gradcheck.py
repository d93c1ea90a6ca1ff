"""Finite-difference gradient verification for the differentiable simulation
(the reference's ``repro.core.gradcheck``).

Central-difference numerical gradients checked against autograd for scalar
losses routed through each stage of the chain, at smoke size; shared by
``tests/test_torch_gradcheck.py`` and ``launch/fit.py --gradcheck``.

Tolerances are float32-grade by design: a central difference carries
O(h^2) truncation error plus O(ulp/h) roundoff from the float32 forward, so
each case has its own step and a relative tolerance of a few percent,
tight enough to catch a wrong, zero or NaN gradient path. The quantized
digitiser is checked end to end through the MSE fit loss, whose averaging
over the readout grid smooths the staircase.

Every case routes theta's elements into the config with
``dataclasses.replace``: that is the calibration contract under test.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional, Sequence

import torch

from repro_torch.config import LArTPCConfig, get_config
from repro_torch.core import prng
from repro_torch.core.depo import generate_depos, generate_physical_depos
from repro_torch.device import resolve_device


class GradcheckResult(NamedTuple):
    """Outcome of one analytic-vs-numeric gradient comparison."""

    name: str
    fields: tuple          # parameter names, theta order
    analytic: tuple        # autograd, per parameter
    numeric: tuple         # central differences, per parameter
    max_abs_err: float
    max_rel_err: float     # |a - n| / max(|a|, |n|, atol) per element, maxed
    ok: bool

    def __str__(self) -> str:  # the table row --gradcheck prints
        mark = "ok " if self.ok else "FAIL"
        return (f"[{mark}] {self.name:<44s} rel_err={self.max_rel_err:.3e} "
                f"abs_err={self.max_abs_err:.3e}")


def finite_difference_grad(f: Callable, theta: torch.Tensor,
                           eps: float = 1e-3) -> torch.Tensor:
    """Central-difference gradient of scalar ``f`` at ``theta``.

    Per-element step ``h_i = eps * max(|theta_i|, 1)``; theta is perturbed
    in float32 and the difference quotient taken in float64 on the host."""
    theta = torch.as_tensor(theta, dtype=torch.float32).detach()
    grads = []
    with torch.no_grad():
        for i in range(theta.shape[0]):
            h = eps * max(abs(float(theta[i])), 1.0)
            step = torch.zeros_like(theta)
            step[i] = h
            fp = float(f(theta + step))
            fm = float(f(theta - step))
            grads.append((fp - fm) / (2.0 * h))
    return torch.tensor(grads, dtype=torch.float32)


def gradcheck(f: Callable, theta, *, name: str = "",
              fields: Sequence[str] = (), eps: float = 1e-3,
              rtol: float = 5e-2, atol: float = 1e-4) -> GradcheckResult:
    """Compare autograd's gradient of ``f`` with central differences at
    ``theta``. Passes when every element satisfies
    ``|analytic - numeric| <= atol + rtol * max(|analytic|, |numeric|)``;
    a non-finite analytic gradient fails outright."""
    theta = torch.as_tensor(theta, dtype=torch.float32).detach()
    req = theta.clone().requires_grad_(True)
    (analytic,) = torch.autograd.grad(f(req), req)
    analytic = analytic.detach().cpu()
    if not bool(torch.isfinite(analytic).all()):
        return GradcheckResult(name=name, fields=tuple(fields),
                               analytic=tuple(map(float, analytic)),
                               numeric=(float("nan"),) * theta.shape[0],
                               max_abs_err=float("inf"),
                               max_rel_err=float("inf"), ok=False)
    numeric = finite_difference_grad(f, theta, eps)
    abs_err = (analytic - numeric).abs()
    mag = torch.maximum(analytic.abs(), numeric.abs())
    rel_err = abs_err / torch.clamp_min(mag, atol)
    return GradcheckResult(
        name=name, fields=tuple(fields),
        analytic=tuple(float(x) for x in analytic),
        numeric=tuple(float(x) for x in numeric),
        max_abs_err=float(abs_err.max()), max_rel_err=float(rel_err.max()),
        ok=bool((abs_err <= atol + rtol * mag).all()))


# ---------------------------------------------------------------------------
# The per-stage suite
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GradcheckCase:
    """One named scalar-loss gradient check.

    ``build(cfg, key, device)`` returns ``(f, theta0)``: the scalar loss over
    the raw (identity-transform) parameter vector and the point to check
    at, on ``device``."""

    name: str
    fields: tuple
    build: Callable
    eps: float = 1e-3
    rtol: float = 5e-2
    atol: float = 1e-4


def _base_cfg(cfg: Optional[LArTPCConfig]) -> LArTPCConfig:
    from repro_torch.core.fit import fit_config

    if cfg is None:
        cfg = get_config("lartpc-uboone", smoke=True)
    return fit_config(cfg)


def _weights(k: torch.Tensor, shape, device) -> torch.Tensor:
    """A fixed random projection: ``sum(x * w)`` probes the whole Jacobian,
    not the row sum (which charge conservation can make flat)."""
    return prng.normal(k, shape, device)


def _theta(values, device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=device)


def _drift_case(cfg: LArTPCConfig, key: torch.Tensor, device):
    from repro_torch.core.drift import transport

    pdepos = generate_physical_depos(key, cfg, device=device)
    w = _weights(prng.fold_in(key, 1), (pdepos.n,), device)

    def f(theta):
        tcfg = dataclasses.replace(cfg, electron_lifetime_us=theta[0],
                                   recombination=theta[1])
        return torch.sum(transport(pdepos, tcfg).charge * w) / pdepos.n

    return f, _theta([50.0, 0.7], device)


def _charge_grid_case(cfg: LArTPCConfig, key: torch.Tensor, device):
    from repro_torch.core.drift import transport
    from repro_torch.core.stages import compute_charge_grid

    pdepos = generate_physical_depos(key, cfg, device=device)
    kf = prng.fold_in(key, 2)
    w = _weights(prng.fold_in(key, 1), (cfg.num_wires, cfg.num_ticks),
                 device)

    def f(theta):
        tcfg = dataclasses.replace(cfg, diffusion_scale=theta[0])
        grid, _ = compute_charge_grid(kf, transport(pdepos, tcfg), tcfg)
        return torch.sum(grid * w) / grid.numel()

    return f, _theta([cfg.diffusion_scale], device)


def _response_case(cfg: LArTPCConfig, key: torch.Tensor, device):
    from repro_torch.core.fft_conv import fft_convolve
    from repro_torch.core.response import make_response
    from repro_torch.core.stages import compute_charge_grid

    depos = generate_depos(key, cfg, device=device)
    grid, _ = compute_charge_grid(prng.fold_in(key, 2), depos, cfg)
    w = _weights(prng.fold_in(key, 1), tuple(grid.shape), device)

    def f(theta):
        tcfg = dataclasses.replace(cfg, response_gain=theta[0],
                                   response_shaping_us=theta[1])
        resp = make_response(tcfg, device=device)
        return torch.sum(fft_convolve(grid, resp, tcfg.fft_strategy) * w
                         ) / grid.numel()

    return f, _theta([1.3, 1.7], device)


def _noise_case(cfg: LArTPCConfig, key: torch.Tensor, device):
    from repro_torch.core.noise import simulate_noise

    kn = prng.fold_in(key, 3)
    w = _weights(prng.fold_in(key, 1), (cfg.num_wires, cfg.num_ticks),
                 device)

    def f(theta):
        tcfg = dataclasses.replace(cfg, noise_rms_adc=theta[0])
        noise = simulate_noise(kn, tcfg, device=device)
        return torch.sum(noise * w) / noise.numel()

    return f, _theta([cfg.noise_rms_adc], device)


def _deconvolve_case(cfg: LArTPCConfig, key: torch.Tensor, device):
    from repro_torch.core.deconvolve import (deconvolve, make_deconv_filter,
                                             measured_signal)
    from repro_torch.core.response import make_response
    from repro_torch.core.stages import build_sim_graph

    graph = build_sim_graph(cfg, None, device=device)
    pdepos = generate_physical_depos(prng.fold_in(key, 7), cfg,
                                     device=device)
    with torch.no_grad():
        adc = graph.run(key, pdepos).adc
    w = _weights(prng.fold_in(key, 1), tuple(adc.shape), device)

    def f(theta):
        tcfg = dataclasses.replace(cfg, adc_per_electron=theta[0],
                                   adc_baseline=theta[1])
        filt = make_deconv_filter(make_response(tcfg, device=device), tcfg)
        decon = deconvolve(measured_signal(adc, tcfg), filt,
                           tcfg.deconv_strategy)
        return torch.sum(decon * w) / (decon.numel() * 1e3)

    return f, _theta([cfg.adc_per_electron, cfg.adc_baseline], device)


def _end_to_end_case(cfg: LArTPCConfig, key: torch.Tensor, device):
    """The full chain, STE digitiser included, through the fit loss itself.
    Deposits 30x the smoke default, so a few-percent parameter change moves
    the waveform by many ADC counts (otherwise the finite difference
    measures staircase crossings, not the smooth STE derivative)."""
    from repro_torch.core.fit import (FitParam, FitSpec, make_fit_loss,
                                      make_fit_targets)

    cfg = dataclasses.replace(cfg,
                              electrons_per_depo=30 * cfg.electrons_per_depo)
    spec = FitSpec(params=(FitParam("recombination"),
                           FitParam("adc_per_electron")))
    targets = make_fit_targets(cfg, key, num_events=1, device=device)
    loss = make_fit_loss(cfg, spec, targets, device=device)
    truth = _theta([cfg.recombination, cfg.adc_per_electron], device)

    def f(mult):
        # multiplier coordinates keep every component O(1), so the step is
        # a uniform ~2 % relative perturbation
        return loss(mult * truth)

    # away from the truth, where the loss floor is 0 and both gradients vanish
    return f, _theta([0.9, 1.1], device)


def _recon_loss_case(cfg: LArTPCConfig, key: torch.Tensor, device):
    """The fit loss with the deconvolved-charge term: gradients flow through
    digitize -> measured_signal -> deconvolve as well."""
    from repro_torch.core.fit import (FitParam, FitSpec, make_fit_loss,
                                      make_fit_targets)

    spec = FitSpec(params=(FitParam("response_gain"),))
    targets = make_fit_targets(cfg, key, num_events=1, recon=True,
                               device=device)
    loss = make_fit_loss(cfg, spec, targets, decon_weight=1e-4,
                         device=device)
    return loss, _theta([1.15], device)


def stage_gradcheck_cases() -> List[GradcheckCase]:
    """The per-stage check matrix, with the reference's steps and
    tolerances."""
    return [
        GradcheckCase("drift/lifetime+recombination",
                      ("electron_lifetime_us", "recombination"),
                      _drift_case, eps=1e-3, rtol=2e-2),
        GradcheckCase("charge_grid/diffusion_scale",
                      ("diffusion_scale",),
                      _charge_grid_case, eps=1e-4, rtol=5e-2),
        GradcheckCase("convolve/response_gain+shaping",
                      ("response_gain", "response_shaping_us"),
                      _response_case, eps=1e-3, rtol=3e-2),
        GradcheckCase("noise/noise_rms_adc",
                      ("noise_rms_adc",),
                      _noise_case, eps=1e-3, rtol=2e-2),
        GradcheckCase("deconvolve/adc_gain+baseline",
                      ("adc_per_electron", "adc_baseline"),
                      _deconvolve_case, eps=1e-4, rtol=5e-2),
        GradcheckCase("e2e/fit_loss (STE digitize)",
                      ("recombination", "adc_per_electron"),
                      _end_to_end_case, eps=2e-2, rtol=2e-1, atol=1e-3),
        GradcheckCase("e2e/fit_loss+decon term",
                      ("response_gain",),
                      _recon_loss_case, eps=2e-2, rtol=2e-1, atol=1e-3),
    ]


def stage_gradcheck_suite(cfg: Optional[LArTPCConfig] = None, *,
                          seed: int = 0,
                          cases: Optional[Sequence[GradcheckCase]] = None,
                          device="cuda") -> List[GradcheckResult]:
    """Run the (or a) case matrix on ``device``; one result per case.
    ``cfg`` defaults to the smoke config, and goes through ``fit_config``.
    Case i draws its inputs from ``fold_in(key(seed), i)``, the reference's
    keys. All green is the gate: ``all(r.ok for r in results)``."""
    dev = resolve_device(device)
    base = _base_cfg(cfg)
    key = prng.key(seed)
    results = []
    for i, case in enumerate(stage_gradcheck_cases() if cases is None
                             else cases):
        f, theta0 = case.build(base, prng.fold_in(key, i), dev)
        results.append(gradcheck(f, theta0, name=case.name,
                                 fields=case.fields, eps=case.eps,
                                 rtol=case.rtol, atol=case.atol))
    return results
