"""Gradient-based detector calibration: fit physics fields of ``LArTPCConfig``
to target ADC waveforms by differentiating through the simulation chain
with autograd (the reference's ``repro.core.fit``).

Three things make the stage graph differentiable without touching the
default bit-exact path:

  * ``rng_strategy="relaxed"``: the counter fluctuation draw with the
    zero-variance square root masked (``repro_torch.core.fluctuate``); the
    forward is bit for bit ``"counter"``'s.
  * ``cfg.digitize_ste=True``: a straight-through estimator around the ADC
    round and clip; the forward equals the quantized ADC, as float32, with
    pass-through gradients inside the rails.
  * the config rebuilt inside the loss: ``dataclasses.replace`` with 0-d
    tensor fields on the loss's device, so the response, the noise
    spectrum, the drift attenuation and the digitiser gain are functions of
    theta (each consumer takes a tensor field as the reference takes a
    traced one).

Self-calibration contract: a loss from ``make_fit_loss`` against targets
from ``make_fit_targets`` uses the targets' per-event keys, so the noise
and fluctuation realisations match and the loss is exactly zero at the true
parameters.

The kernel strategies have no backward (the registry marks them
``differentiable=False``); ``fit_config`` routes every op to its
differentiable fallback, so the fit runs on the card through torch ops,
autograd and cuFFT.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.config import LArTPCConfig
from repro_torch.core import prng
from repro_torch.core.batch import (PhysicalEventBatch, event_keys,
                                    pack_physical_events)
from repro_torch.core.depo import generate_physical_depos
from repro_torch.core.stages import SimGraph, build_sim_graph
from repro_torch.device import resolve_device
from repro_torch.tune import registry

#: config fields the differentiable graph supports as free fit parameters
FITTABLE_FIELDS = (
    "electron_lifetime_us",
    "recombination",
    "diffusion_scale",
    "noise_rms_adc",
    "adc_per_electron",
    "adc_baseline",
    "response_gain",
    "response_shaping_us",
)

#: (registry op, config strategy field, differentiable fallback)
_STRATEGY_FIELDS = (
    ("drift", "drift_strategy", "jnp"),
    ("charge_grid", "charge_grid_strategy", "unfused"),
    ("scatter_add", "scatter_strategy", "xla"),
    ("fft_convolve", "fft_strategy", "rfft2"),
    ("deconvolve", "deconv_strategy", "rfft2"),
)


# ---------------------------------------------------------------------------
# FitSpec: which fields are free, with bounds and transforms
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FitParam:
    """One free parameter of a fit.

    field     : ``LArTPCConfig`` field name (one of ``FITTABLE_FIELDS``).
    init      : starting value (None: the config's current value).
    lo / hi   : optional bounds, kept by the transform (not by clipping).
    transform : the map from the optimiser's coordinate theta to the value:
                  identity : value = theta
                  log      : value = lo + exp(theta)
                  sigmoid  : value = lo + (hi - lo) * sigmoid(theta)
                None picks one: both bounds sigmoid, a lower bound alone
                log, no bound identity.
    """

    field: str
    init: Optional[float] = None
    lo: Optional[float] = None
    hi: Optional[float] = None
    transform: Optional[str] = None

    def __post_init__(self):
        if self.field not in FITTABLE_FIELDS:
            raise ValueError(
                f"{self.field!r} is not a fittable config field; supported: "
                f"{list(FITTABLE_FIELDS)}")
        kind = self.resolved_transform
        if kind not in ("identity", "log", "sigmoid"):
            raise ValueError(f"unknown transform {kind!r} for {self.field!r}; "
                             "valid: identity | log | sigmoid")
        if kind == "sigmoid" and (self.lo is None or self.hi is None
                                  or not self.hi > self.lo):
            raise ValueError(f"sigmoid transform for {self.field!r} needs "
                             "bounds with hi > lo")

    @property
    def resolved_transform(self) -> str:
        if self.transform is not None:
            return self.transform
        if self.lo is not None and self.hi is not None:
            return "sigmoid"
        if self.lo is not None:
            return "log"
        return "identity"

    def to_value(self, theta: torch.Tensor) -> torch.Tensor:
        kind = self.resolved_transform
        if kind == "log":
            return (self.lo or 0.0) + torch.exp(theta)
        if kind == "sigmoid":
            return self.lo + (self.hi - self.lo) * torch.sigmoid(theta)
        return theta

    def to_theta(self, value: float) -> float:
        kind = self.resolved_transform
        if kind == "log":
            return math.log(max(value - (self.lo or 0.0), 1e-12))
        if kind == "sigmoid":
            u = (value - self.lo) / (self.hi - self.lo)
            u = min(max(u, 1e-6), 1.0 - 1e-6)
            return math.log(u / (1.0 - u))
        return float(value)


@dataclasses.dataclass(frozen=True)
class FitSpec:
    """The free-parameter set of a calibration fit: the map between the
    optimiser's float32 theta vector (one entry per param, in declaration
    order) and config field values."""

    params: Tuple[FitParam, ...]

    def __post_init__(self):
        names = [p.field for p in self.params]
        if not names:
            raise ValueError("FitSpec needs at least one FitParam")
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate fit fields: {names}")

    @property
    def fields(self) -> Tuple[str, ...]:
        return tuple(p.field for p in self.params)

    @property
    def n(self) -> int:
        return len(self.params)

    def _theta(self, values, device) -> torch.Tensor:
        return torch.tensor([p.to_theta(v) for p, v in zip(self.params,
                                                          values)],
                            dtype=torch.float32, device=resolve_device(device))

    def init_theta(self, cfg: LArTPCConfig, device="cuda") -> torch.Tensor:
        """Starting theta on ``device``: each param's ``init`` (or the
        config's value) through its inverse transform."""
        return self._theta([p.init if p.init is not None
                            else getattr(cfg, p.field)
                            for p in self.params], device)

    def true_theta(self, cfg: LArTPCConfig, device="cuda") -> torch.Tensor:
        """Theta at the config's current values (ignores ``init``): the
        ground truth of a self-calibration test."""
        return self._theta([getattr(cfg, p.field) for p in self.params],
                           device)

    def unpack(self, theta: torch.Tensor) -> Dict[str, torch.Tensor]:
        """theta -> {field: 0-d value tensor}, keeping autograd history."""
        return {p.field: p.to_value(theta[i])
                for i, p in enumerate(self.params)}

    def values(self, theta) -> Dict[str, float]:
        """{field: float} view of theta (host-side logging)."""
        theta = torch.as_tensor(theta, dtype=torch.float32).detach()
        return {k: float(v) for k, v in self.unpack(theta).items()}

    def apply(self, cfg: LArTPCConfig, theta: torch.Tensor) -> LArTPCConfig:
        """``cfg`` with the theta-valued fields as 0-d tensors (the frozen
        dataclass carries them; it stops being hashable, which the loss
        never needs)."""
        return dataclasses.replace(cfg, **self.unpack(theta))


def spec_from_names(names: Sequence[str], cfg: LArTPCConfig,
                    rel_bounds: float = 4.0) -> FitSpec:
    """A FitSpec boxing each named field to [value / rel_bounds, value *
    rel_bounds] around the config's current value (positive fields), with
    the identity transform for fields at zero."""
    params = []
    for name in names:
        v = float(getattr(cfg, name))
        if v > 0:
            params.append(FitParam(name, lo=v / rel_bounds,
                                   hi=v * rel_bounds))
        else:
            params.append(FitParam(name))
    return FitSpec(params=tuple(params))


# ---------------------------------------------------------------------------
# Differentiable-config plumbing
# ---------------------------------------------------------------------------


def fit_config(cfg: LArTPCConfig) -> LArTPCConfig:
    """The differentiable variant of ``cfg``: the STE digitiser, the relaxed
    fluctuation draw, and the registry's differentiable fallback for every
    strategy field that is ``"auto"`` or names a kernel without a backward.
    Its forward values equal the default graph's (as float32)."""
    if cfg.fluctuate and cfg.rng_strategy == "pool":
        raise ValueError(
            "the paper-faithful 'pool' fluctuation stream has no "
            "reparameterised form; calibrate with rng_strategy='counter' "
            "(mapped to 'relaxed') or 'none'")
    updates: Dict[str, object] = {"digitize_ste": True}
    if cfg.fluctuate and cfg.rng_strategy in ("counter", "relaxed"):
        updates["rng_strategy"] = "relaxed"
    for op, field, fallback in _STRATEGY_FIELDS:
        cur = getattr(cfg, field)
        if cur == "auto" or not registry.is_differentiable(op, cur):
            updates[field] = fallback
    return dataclasses.replace(cfg, **updates)


def assert_differentiable_config(cfg: LArTPCConfig) -> None:
    """Raise unless every strategy and flag of ``cfg`` supports autograd
    (the precondition of ``make_fit_loss``)."""
    problems = []
    if cfg.fluctuate and cfg.rng_strategy not in ("relaxed", "none"):
        problems.append(
            f"rng_strategy={cfg.rng_strategy!r} (need 'relaxed' or 'none')")
    if not cfg.digitize_ste:
        problems.append("digitize_ste=False (the quantizer has zero "
                        "gradient almost everywhere)")
    for op, field, _ in _STRATEGY_FIELDS:
        cur = getattr(cfg, field)
        if cur == "auto" or not registry.is_differentiable(op, cur):
            problems.append(f"{field}={cur!r} (non-differentiable candidate "
                            f"of op {op!r})")
    if problems:
        raise ValueError("config is not differentiable: "
                         + "; ".join(problems)
                         + " — pass it through repro_torch.core.fit.fit_config")


def _drop_stage(graph: SimGraph, name: str) -> SimGraph:
    return SimGraph([s for s in graph.stages if s.name != name], graph.device)


def _run_events(graph: SimGraph, keys: torch.Tensor,
                batch: PhysicalEventBatch):
    """``graph.run`` on each padded event row with its key, the outputs'
    ADC (and decon) stacked along a leading event axis: the reference's
    ``vmap(graph.run)``."""
    outs = [graph.run(keys[e], batch.event(e))
            for e in range(batch.num_events)]
    adc = torch.stack([o.adc for o in outs])
    decon = (torch.stack([o.decon for o in outs])
             if outs[0].decon is not None else None)
    return adc, decon


# ---------------------------------------------------------------------------
# Targets and loss
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FitTargets:
    """Self-generated calibration targets: the inputs and reference outputs
    of a fit, made by the default (bit-exact, int16) graph at the true
    config."""

    batch: PhysicalEventBatch
    keys: torch.Tensor                     # (E, 2) per-event keys (host)
    adc: torch.Tensor                      # (E, W, T) int16
    decon: Optional[torch.Tensor] = None   # (E, W, T) deconvolved charge


def make_fit_targets(cfg: LArTPCConfig, key: torch.Tensor,
                     num_events: int = 2, num_depos: Optional[int] = None,
                     add_noise: bool = True, recon: bool = False,
                     device="cuda") -> FitTargets:
    """Generate events on ``device`` and run the default graph at ``cfg``'s
    (true) physics, without autograd. The per-event keys are the fit's too:
    reusing them makes the loss's realisations match the targets', so the
    loss is zero at the true parameters."""
    dev = resolve_device(device)
    kgen, krun = prng.split(key)
    events = [generate_physical_depos(prng.fold_in(kgen, e), cfg,
                                      n=num_depos, device=dev)
              for e in range(num_events)]
    batch = pack_physical_events(events)
    keys = event_keys(krun, range(num_events))
    graph = build_sim_graph(cfg, None, add_noise=add_noise, device=dev,
                            recon=recon)
    if recon:
        graph = _drop_stage(graph, "hit_find")
    with torch.no_grad():
        adc, decon = _run_events(graph, keys, batch)
    return FitTargets(batch=batch, keys=keys, adc=adc, decon=decon)


def make_fit_loss(cfg: LArTPCConfig, spec: FitSpec, targets: FitTargets,
                  add_noise: bool = True, decon_weight: float = 0.0,
                  device="cuda") -> Callable[[torch.Tensor], torch.Tensor]:
    """The scalar loss ``theta -> mean squared ADC error`` over the target
    events, on ``device`` (the targets are moved there once).

    Every call rebuilds the config from ``spec.apply(fit_config(cfg),
    theta)`` and, from it, the graph (responses, noise spectrum, filters),
    runs each target event with its key, and returns

        mean((adc - target_adc)^2)
          [+ decon_weight * mean((decon - target_decon)^2)]

    The deconvolved-charge term (``decon_weight > 0``) needs targets made
    with ``recon=True``."""
    dev = resolve_device(device)
    fcfg = fit_config(cfg)
    assert_differentiable_config(fcfg)
    use_decon = decon_weight > 0.0
    if use_decon and targets.decon is None:
        raise ValueError("decon_weight > 0 needs targets built with "
                         "make_fit_targets(..., recon=True)")
    batch = PhysicalEventBatch(*(x.to(dev) for x in targets.batch[:-1]),
                               n_depos=targets.batch.n_depos)
    target_adc = targets.adc.to(dev, torch.float32)
    target_decon = targets.decon.to(dev) if use_decon else None

    def loss(theta: torch.Tensor) -> torch.Tensor:
        tcfg = spec.apply(fcfg, theta.to(dev))
        graph = build_sim_graph(tcfg, None, add_noise=add_noise, device=dev,
                                recon=use_decon)
        if use_decon:
            graph = _drop_stage(graph, "hit_find")
        adc, decon = _run_events(graph, targets.keys, batch)
        val = torch.mean((adc - target_adc) ** 2)
        if use_decon:
            val = val + decon_weight * torch.mean((decon - target_decon) ** 2)
        return val

    return loss


def value_and_grad(loss_fn: Callable[[torch.Tensor], torch.Tensor],
                   theta: torch.Tensor):
    """(loss, d loss / d theta) at ``theta``, the loss detached."""
    theta = theta.detach().requires_grad_(True)
    val = loss_fn(theta)
    (grad,) = torch.autograd.grad(val, theta)
    return val.detach(), grad


# ---------------------------------------------------------------------------
# Optimiser drivers
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FitResult:
    """Outcome of a fit run."""

    theta: torch.Tensor              # final unconstrained coordinates
    values: Dict[str, float]         # final physical parameter values
    loss: float                      # final loss
    history: List[Tuple[int, float]]  # (step, loss) log
    steps: int

    def relative_errors(self, truth: Dict[str, float]) -> Dict[str, float]:
        """|fit - truth| / max(|truth|, eps) per field."""
        return {k: abs(self.values[k] - v) / max(abs(v), 1e-12)
                for k, v in truth.items()}


def _run_bfgs(loss_fn, spec: FitSpec, theta: torch.Tensor, steps: int,
              callback) -> FitResult:
    from scipy.optimize import minimize

    def fun(x):
        val, grad = value_and_grad(loss_fn, torch.as_tensor(
            x, dtype=torch.float32, device=theta.device))
        return float(val), grad.cpu().numpy().astype(float)

    l0 = float(loss_fn(theta))
    history = [(0, l0)]
    if callback:
        callback(0, l0, spec.values(theta))
    res = minimize(fun, theta.cpu().numpy().astype(float), jac=True,
                   method="BFGS", options={"maxiter": steps})
    theta = torch.as_tensor(res.x, dtype=torch.float32, device=theta.device)
    lf, n_steps = float(res.fun), int(res.nit)
    history.append((n_steps, lf))
    if callback:
        callback(n_steps, lf, spec.values(theta))
    return FitResult(theta=theta, values=spec.values(theta), loss=lf,
                     history=history, steps=n_steps)


def run_fit(loss_fn: Callable, spec: FitSpec, theta0, *,
            steps: int = 200, lr: float = 0.05, optimizer: str = "adam",
            b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
            log_every: int = 0,
            callback: Optional[Callable[[int, float, Dict[str, float]], None]]
            = None) -> FitResult:
    """Minimise ``loss_fn`` over theta, on ``theta0``'s device.

    optimizer="adam" : Adam on the unconstrained theta, the reference's
                       update line for line in float32, ``steps``
                       loss-and-gradient evaluations with per-step
                       (step, loss) history.
    optimizer="bfgs" : ``scipy.optimize.minimize(method="BFGS",
                       jac=True)`` on the host over float64 theta, each
                       evaluation a loss and gradient on theta's device;
                       history holds the start and end points. The
                       reference uses ``jax.scipy.optimize.minimize``,
                       whose line search differs: the two are held to the
                       same recovery, not the same iterates.

    ``callback(step, loss, values)`` fires every ``log_every`` steps (and on
    the last) when set."""
    theta = torch.as_tensor(theta0, dtype=torch.float32).detach()
    if optimizer == "bfgs":
        return _run_bfgs(loss_fn, spec, theta, steps, callback)
    if optimizer != "adam":
        raise ValueError(f"unknown optimizer {optimizer!r}; "
                         "valid: adam | bfgs")
    history: List[Tuple[int, float]] = []
    m = torch.zeros_like(theta)
    v = torch.zeros_like(theta)
    val = float("nan")
    for step in range(1, steps + 1):
        val_t, g = value_and_grad(loss_fn, theta)
        val = float(val_t)
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * g * g
        mhat = m / torch.tensor(1.0 - b1 ** step, dtype=torch.float32,
                                device=theta.device)
        vhat = v / torch.tensor(1.0 - b2 ** step, dtype=torch.float32,
                                device=theta.device)
        theta = theta - lr * mhat / (torch.sqrt(vhat) + eps)
        history.append((step, val))
        if callback and (step == steps
                         or (log_every and step % log_every == 0)):
            callback(step, val, spec.values(theta))
    return FitResult(theta=theta, values=spec.values(theta), loss=val,
                     history=history, steps=steps)


def calibrate(cfg: LArTPCConfig, spec: FitSpec, targets: FitTargets, *,
              steps: int = 200, lr: float = 0.05, optimizer: str = "adam",
              add_noise: bool = True, decon_weight: float = 0.0,
              log_every: int = 0, callback=None,
              device="cuda") -> FitResult:
    """Build the loss for ``targets`` on ``device`` and fit from ``spec``'s
    init values. ``cfg`` supplies the truth only through ``targets``."""
    dev = resolve_device(device)
    loss_fn = make_fit_loss(cfg, spec, targets, add_noise=add_noise,
                            decon_weight=decon_weight, device=dev)
    return run_fit(loss_fn, spec, spec.init_theta(cfg, device=dev),
                   steps=steps, lr=lr, optimizer=optimizer,
                   log_every=log_every, callback=callback)
