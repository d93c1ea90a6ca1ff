"""Stage-graph simulation core: the single-plane fig4 chain as one module.

    drift -> charge_grid -> convolve -> noise -> digitize

``SimGraph`` is an ``nn.Module`` holding the ordered stages (the convolve
stage holds the response spectrum as a buffer). ``run`` executes the chain
for one event; ``timed`` runs it stage by stage and times each stage with
CUDA events on the card (host clock on the CPU); ``replace`` swaps stages.

RNG contract (the reference's): the event key is split once,
``kf, kn = split(key)``; the charge-grid stage draws from ``kf``, the noise
stage from ``kn``.
"""
from __future__ import annotations

import statistics
import time
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.config import LArTPCConfig
from repro_torch.core import prng
from repro_torch.core.depo import DepoSet
from repro_torch.core.fft_conv import digitize, fft_convolve
from repro_torch.core.noise import simulate_noise
from repro_torch.core.response import DetectorResponse, make_response
from repro_torch.device import resolve_device

#: canonical stage order of the simulation chain
STAGE_ORDER = ("drift", "charge_grid", "convolve", "noise", "digitize")


class SimOutput(NamedTuple):
    """Simulation result of one event (single plane).

    ``dropped`` counts the (depo, tile) entries the fused strategies' tile
    binning could not fit (0-d tensor; always 0 for ``unfused``)."""

    adc: torch.Tensor          # (num_wires, num_ticks) int16
    signal: torch.Tensor       # (num_wires, num_ticks) float32
    charge_grid: torch.Tensor  # S(t,x) after the charge-grid stage
    dropped: Optional[torch.Tensor] = None


class SimState(NamedTuple):
    """What the stages thread through the chain."""

    key: torch.Tensor                    # unsplit event key
    kf: torch.Tensor                     # charge-grid subkey
    kn: torch.Tensor                     # noise subkey
    depos: object                        # PhysicalDepoSet | DepoSet
    grid: Optional[torch.Tensor] = None
    signal: Optional[torch.Tensor] = None
    adc: Optional[torch.Tensor] = None
    dropped: Optional[torch.Tensor] = None


class Stage(nn.Module):
    """One named step: ``fn(SimState) -> SimState``; ``op`` names the
    registry hot op it dispatches (None for fixed-function stages)."""

    def __init__(self, name: str, fn: Callable[[SimState], SimState],
                 op: Optional[str] = None):
        super().__init__()
        self.name = name
        self.fn = fn
        self.op = op

    def forward(self, state: SimState) -> SimState:
        return self.fn(state)


class SimGraph(nn.Module):
    """An ordered stage chain with one executor (``run``) and one timing
    point per stage boundary (``timed``)."""

    def __init__(self, stages, device):
        super().__init__()
        self.stages = nn.ModuleList(stages)
        self.device = torch.device(device)

    @property
    def stage_names(self) -> Tuple[str, ...]:
        return tuple(s.name for s in self.stages)

    def replace(self, **overrides) -> "SimGraph":
        """A new graph with named stages replaced by a ``Stage`` or a
        ``SimState -> SimState`` function."""
        unknown = set(overrides) - set(self.stage_names)
        if unknown:
            raise KeyError(f"unknown stages {sorted(unknown)}; "
                           f"graph has {self.stage_names}")
        stages = []
        for s in self.stages:
            new = overrides.get(s.name, s)
            stages.append(new if isinstance(new, Stage)
                          else Stage(s.name, new, s.op))
        return SimGraph(stages, self.device)

    def init_state(self, key: torch.Tensor, depos) -> SimState:
        kf, kn = prng.split(key)
        return SimState(key=key, kf=kf, kn=kn, depos=depos.to(self.device))

    @staticmethod
    def output(state: SimState) -> SimOutput:
        return SimOutput(adc=state.adc, signal=state.signal,
                         charge_grid=state.grid, dropped=state.dropped)

    def run(self, key: torch.Tensor, depos) -> SimOutput:
        """Execute the full chain for one event."""
        state = self.init_state(key, depos)
        for stage in self.stages:
            state = stage(state)
        return self.output(state)

    forward = run

    def timed(self, key: torch.Tensor, depos, *, warmup: int = 1,
              iters: int = 3) -> Tuple[SimOutput, Dict[str, float]]:
        """Run stage by stage, each ``warmup + iters`` times on the same
        input state; returns (output, {stage: median seconds}). On the card
        each run is bracketed by CUDA events."""
        state = self.init_state(key, depos)
        timings: Dict[str, float] = {}
        cuda = self.device.type == "cuda"
        for stage in self.stages:
            out = stage(state)
            for _ in range(max(warmup - 1, 0)):
                stage(state)
            times = []
            for _ in range(iters):
                if cuda:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    stage(state)
                    end.record()
                    end.synchronize()
                    times.append(start.elapsed_time(end) / 1e3)
                else:
                    t0 = time.perf_counter()
                    stage(state)
                    times.append(time.perf_counter() - t0)
            timings[stage.name] = statistics.median(times)
            state = out
        return self.output(state), timings


def drift_stage(cfg: LArTPCConfig) -> Stage:
    """Transport physical depos to the readout plane; pass a DepoSet that
    already arrived straight through."""
    from repro_torch.core.drift import transport

    def fn(state: SimState) -> SimState:
        if isinstance(state.depos, DepoSet):
            return state
        return state._replace(depos=transport(state.depos, cfg))

    return Stage("drift", fn, op="drift")


def compute_charge_grid(k: torch.Tensor, depos: DepoSet, cfg: LArTPCConfig):
    """Dispatch depos -> (S(t,x), dropped) through the registered strategy."""
    from repro_torch.tune.registry import resolve

    return resolve("charge_grid", cfg.charge_grid_strategy).fn(k, depos, cfg)


def charge_grid_stage(cfg: LArTPCConfig) -> Stage:
    """depos -> S(t,x): rasterize + fluctuate + scatter-add, or the fused
    kernel, dispatched through the ``charge_grid`` registry."""

    def fn(state: SimState) -> SimState:
        grid, dropped = compute_charge_grid(state.kf, state.depos, cfg)
        return state._replace(grid=grid, dropped=dropped)

    return Stage("charge_grid", fn, op="charge_grid")


def convolve_stage(cfg: LArTPCConfig, resp: DetectorResponse) -> Stage:
    """S(t,x) -> M(t,x): frequency-domain convolution with the response,
    whose spectrum the stage holds as the buffer ``response_freq``."""
    stage = Stage("convolve", None, op="fft_convolve")
    stage.register_buffer("response_freq", resp.freq)

    def fn(state: SimState) -> SimState:
        r = resp._replace(freq=stage.response_freq)
        return state._replace(
            signal=fft_convolve(state.grid, r, cfg.fft_strategy))

    stage.fn = fn
    return stage


def noise_stage(cfg: LArTPCConfig) -> Stage:
    """Add frequency-shaped electronics noise to the signal."""
    denom = max(cfg.adc_per_electron, 1e-30)

    def fn(state: SimState) -> SimState:
        noise = simulate_noise(state.kn, cfg, device=state.signal.device)
        return state._replace(signal=state.signal + noise / denom)

    return Stage("noise", fn)


def digitize_stage(cfg: LArTPCConfig) -> Stage:
    """M(t,x) -> int16 ADC counts."""

    def fn(state: SimState) -> SimState:
        return state._replace(adc=digitize(state.signal, cfg))

    return Stage("digitize", fn)


def check_supported(cfg: LArTPCConfig) -> None:
    """Raise for config features the port does not run yet."""
    unsupported = {
        "num_planes": (cfg.num_planes, 1),
        "pipeline": (cfg.pipeline, "fig4"),
        "patch_dtype": (cfg.patch_dtype, "float32"),
        "check_finite": (cfg.check_finite, False),
    }
    for name, (value, supported) in unsupported.items():
        if value != supported:
            raise NotImplementedError(
                f"the port runs {name}={supported!r} only (got {value!r})")
    if cfg.rng_strategy not in ("counter", "none"):
        raise NotImplementedError(
            f"the port runs rng_strategy 'counter' or 'none' only "
            f"(got {cfg.rng_strategy!r})")


def build_sim_graph(cfg: LArTPCConfig, resp: Optional[DetectorResponse] = None,
                    add_noise: bool = True, device="cuda") -> SimGraph:
    """Assemble the canonical ``drift -> charge_grid -> convolve -> noise ->
    digitize`` chain on ``device`` (the one place the order is written).
    ``add_noise=False`` drops the noise stage."""
    check_supported(cfg)
    dev = resolve_device(device)
    if resp is None:
        resp = make_response(cfg, device=dev)
    stages = [drift_stage(cfg), charge_grid_stage(cfg),
              convolve_stage(cfg, resp)]
    if add_noise:
        stages.append(noise_stage(cfg))
    stages.append(digitize_stage(cfg))
    return SimGraph(stages, dev)
