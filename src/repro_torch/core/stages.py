"""Stage-graph simulation core: the fig4 chain as one module.

    drift -> charge_grid -> convolve -> noise -> digitize
          [-> deconvolve -> hit_find]      (``recon=True``)

``SimGraph`` is an ``nn.Module`` holding the ordered stages (the convolve
stage holds the response spectra as a buffer). ``run`` executes the chain
for one event; ``timed`` runs it stage by stage and times each stage with
CUDA events on the card (host clock on the CPU); ``replace`` swaps stages.

RNG contract (the reference's): the event key is split once,
``kf, kn = split(key)``; the charge-grid stage draws from ``kf``, the noise
stage from ``kn``. Under ``rng_strategy="pool"`` the charge grid takes its
normals from one pre-computed pool instead, from offset 0 for every event
and plane.

Multi-plane configs (``cfg.num_planes > 1``) run every readout stage for
each plane, drawing from the plane-folded subkeys ``fold_in(kf, index)``
and ``fold_in(kn, index)``, and carry a leading plane axis on every state
leaf. Every stage runs one plane at a time, except that ``plane_batching``
``stacked`` (the default for several planes) hands a multi-plane
charge-grid strategy all planes in one launch; ``loop`` dispatches its
single-plane form per plane. Both give the same bits. ``planes`` restricts
a multi-plane graph to some plane indices.

``run_batch`` is the batched executor (the port's counterpart of the
reference's ``vmap`` over events, ``repro_torch.core.batch``): it runs the
same stages over the events of a batch, stage by stage. A stage with a
``batch_fn`` takes all the batch's events at once: the charge-grid stage
of the fused strategies hands every (event, plane) row to the fused kernel
in ceil(rows / 16) launches. Every other stage runs one event (and within
it one plane) at a time, so each event equals ``run`` on the same padded
row, bit for bit. ``n_valid`` gives a padded row's valid depo count, so
the tile binning does not count its padding as dropped. Each stage of a
batch runs in a ``sim.stage.<name>`` span (``repro_torch.spans``), with
CUDA events at its entry and exit on the card.

``cfg.check_finite`` turns on the reference's sentinel: after each float
stage the graph ANDs ``isfinite(...).all()`` of the stage's output into
``finite_ok``, a 0-d bool tensor left on the device (no host read).
"""
from __future__ import annotations

import statistics
import time
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import torch
from torch import nn

from repro_torch import spans
from repro_torch.config import LArTPCConfig, PlaneSpec, plane_specs
from repro_torch.core import prng
from repro_torch.core.depo import DepoSet
from repro_torch.core.fft_conv import digitize, fft_convolve, \
    resolve_spectrum_strategy
from repro_torch.core.fluctuate import make_pool
from repro_torch.core.noise import simulate_noise
from repro_torch.core.rasterize import patch_dtype
from repro_torch.core.response import DetectorResponse, make_response
from repro_torch.device import resolve_device, scalar
from repro_torch.tune import autotune
from repro_torch.tune.registry import get_strategy

#: canonical stage order of the simulation chain
STAGE_ORDER = ("drift", "charge_grid", "convolve", "noise", "digitize")
#: the recon stages ``build_sim_graph(..., recon=True)`` appends
RECON_STAGE_ORDER = ("deconvolve", "hit_find")
#: the full sim -> recon chain
FULL_STAGE_ORDER = STAGE_ORDER + RECON_STAGE_ORDER
#: charge_grid strategies that rasterise ALL planes in one launch: they take
#: the unsplit charge-grid subkey and the full (P, N) depos and fold the
#: per-plane subkeys themselves
MULTIPLANE_CHARGE_GRID = ("fused_pallas_multiplane",
                          "fused_pallas_multiplane_compact",
                          "multiplane_xla")


class SimOutput(NamedTuple):
    """Simulation result of one event. Multi-plane configs carry a leading
    plane axis on adc, signal and charge_grid: (P, num_wires, num_ticks).

    ``dropped`` counts the (depo, tile) entries of valid depos the tile
    binning of the kernel strategies could not fit, over all planes (0-d
    tensor; always 0 for the library strategies). ``decon`` and ``hits``
    are set only by recon graphs (``build_sim_graph(..., recon=True)``);
    multi-plane hits stack their leaves to (P, max_hits). ``finite_ok``
    (0-d bool) is set only with ``cfg.check_finite``: True when every
    float stage output was finite. The batched executor stacks every leaf
    along a leading event axis."""

    adc: torch.Tensor          # (num_wires, num_ticks) int16
    signal: torch.Tensor       # (num_wires, num_ticks) float32
    charge_grid: torch.Tensor  # S(t,x) after the charge-grid stage
    dropped: Optional[torch.Tensor] = None
    decon: Optional[torch.Tensor] = None  # S^(t,x) after deconvolve
    hits: Optional[object] = None         # HitSet after hit_find
    finite_ok: Optional[torch.Tensor] = None  # check_finite sentinel


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
    decon: Optional[torch.Tensor] = None
    hits: Optional[object] = None
    n_valid: Optional[int] = None        # valid depos of a padded row
    finite_ok: Optional[torch.Tensor] = None  # check_finite accumulator


class Stage(nn.Module):
    """One named step: ``fn(SimState) -> SimState``; ``op`` names the
    registry hot op it dispatches (None for fixed-function stages).
    ``batch_fn`` (optional) runs the step over the states of a batch's
    events at once, with each state's result bit for bit ``fn``'s.
    ``finite_field`` names the state field the ``check_finite`` sentinel
    inspects after the step (None: no check)."""

    def __init__(self, name: str, fn: Callable[[SimState], SimState],
                 op: Optional[str] = None,
                 batch_fn: Optional[Callable[[List[SimState]],
                                             List[SimState]]] = None):
        super().__init__()
        self.name = name
        self.span_name = spans.STAGE + name
        self.fn = fn
        self.op = op
        self.batch_fn = batch_fn
        self.finite_field: Optional[str] = None

    def forward(self, state: SimState) -> SimState:
        return self._checked(self.fn(state))

    def run_rows(self, states: List[SimState]) -> List[SimState]:
        """The step over the states of a batch: ``batch_fn`` where the stage
        has one, else ``fn`` one state at a time."""
        out = (self.batch_fn(states) if self.batch_fn is not None
               else [self.fn(s) for s in states])
        return [self._checked(s) for s in out]

    def _checked(self, state: SimState) -> SimState:
        if self.finite_field is None:
            return state
        ok = state.finite_ok
        for leaf in _tensor_leaves(getattr(state, self.finite_field)):
            if leaf.is_floating_point():
                flag = torch.isfinite(leaf).all()
                ok = flag if ok is None else ok & flag
        return state._replace(finite_ok=ok)


def _tensor_leaves(value):
    if isinstance(value, torch.Tensor):
        return [value]
    return [x for x in value if isinstance(x, torch.Tensor)]


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
        """A new graph with named stages replaced by a ``Stage`` (taken as
        it is) or a ``SimState -> SimState`` function, which keeps the
        replaced stage's name, op and ``check_finite`` field."""
        unknown = set(overrides) - set(self.stage_names)
        if unknown:
            raise KeyError(f"unknown stages {sorted(unknown)}; "
                           f"graph has {self.stage_names}")
        stages = []
        for s in self.stages:
            new = overrides.get(s.name, s)
            if not isinstance(new, Stage):
                new = Stage(s.name, new, s.op)
                new.finite_field = s.finite_field
            stages.append(new)
        return SimGraph(stages, self.device)

    def init_state(self, key: torch.Tensor, depos,
                   n_valid: Optional[int] = None) -> SimState:
        kf, kn = prng.split(key)
        return SimState(key=key, kf=kf, kn=kn, depos=depos.to(self.device),
                        n_valid=n_valid)

    @staticmethod
    def output(state: SimState) -> SimOutput:
        return SimOutput(adc=state.adc, signal=state.signal,
                         charge_grid=state.grid, dropped=state.dropped,
                         decon=state.decon, hits=state.hits,
                         finite_ok=state.finite_ok)

    def run(self, key: torch.Tensor, depos,
            n_valid: Optional[int] = None) -> SimOutput:
        """Execute the full chain for one event (a padded row: give its
        valid depo count ``n_valid``)."""
        state = self.init_state(key, depos, n_valid)
        for stage in self.stages:
            state = stage(state)
        return self.output(state)

    forward = run

    def run_batch(self, keys: torch.Tensor, rows: Sequence,
                  n_valid: Optional[Sequence[Optional[int]]] = None
                  ) -> SimOutput:
        """Execute the chain for the events of a batch, stage by stage:
        ``keys`` (E, 2), one event key per row of ``rows`` (each a padded
        ``DepoSet`` or ``PhysicalDepoSet``), ``n_valid`` their valid depo
        counts. Event e equals ``run(keys[e], rows[e], n_valid[e])`` bit for
        bit; every output leaf gains a leading event axis."""
        if n_valid is None:
            n_valid = [None] * len(rows)
        states = [self.init_state(k, d, n)
                  for k, d, n in zip(keys, rows, n_valid)]
        for stage in self.stages:
            with spans.span(stage.span_name, device=self.device):
                states = stage.run_rows(states)
        return join_outputs([self.output(s) for s in states])

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
                    times.append(start.elapsed_time(end) / 1e3)  # torch-lint: disable=scalar-division — a Python float
                else:
                    t0 = time.perf_counter()
                    stage(state)
                    times.append(time.perf_counter() - t0)
            timings[stage.name] = statistics.median(times)
            state = out
        return self.output(state), timings


def join_outputs(outs: Sequence[SimOutput], join=torch.stack) -> SimOutput:
    """Outputs joined leaf by leaf (a ``HitSet`` leaf by leaf; absent
    fields stay None): per-event outputs stacked along a new leading event
    axis, or with ``join=torch.cat`` batched outputs concatenated along
    theirs."""

    def joined(values):
        first = values[0]
        if first is None:
            return None
        if isinstance(first, torch.Tensor):
            return join(values)
        return type(first)(*(join(x) for x in zip(*values)))

    return SimOutput(*(joined([getattr(o, f) for o in outs])
                       for f in SimOutput._fields))


def resolve_plane_batching(cfg: LArTPCConfig) -> str:
    """``cfg.plane_batching`` as "loop" or "stacked" ("auto": stacked for
    several planes)."""
    mode = cfg.plane_batching
    if mode not in ("auto", "loop", "stacked"):
        raise ValueError(f"unknown plane_batching {mode!r}; expected 'auto', "
                         "'loop' or 'stacked'")
    if mode == "auto":
        return "stacked" if cfg.num_planes > 1 else "loop"
    return mode


def plane_fold_keys(key: torch.Tensor,
                    specs: Sequence[PlaneSpec]) -> torch.Tensor:
    """Stacked per-plane subkeys ``fold_in(key, spec.index)``: (P, 2)."""
    return torch.stack(_plane_keys(key, specs))


def _plane_keys(key: torch.Tensor, specs: Sequence[PlaneSpec]):
    return [prng.fold_in(key, s.index) for s in specs]


def _selected_specs(cfg: LArTPCConfig,
                    planes: Optional[Tuple[int, ...]]) -> Tuple[PlaneSpec, ...]:
    specs = plane_specs(cfg)
    return specs if planes is None else tuple(specs[p] for p in planes)


def _as_plane_responses(cfg: LArTPCConfig, resp, planes, device):
    """One response per selected plane: None builds the defaults (one per
    plane kind); a single ``DetectorResponse`` serves one plane only."""
    specs = _selected_specs(cfg, planes)
    if resp is None:
        return tuple(make_response(cfg, plane=s.kind, device=device)
                     for s in specs)
    if isinstance(resp, DetectorResponse):
        if len(specs) != 1:
            raise ValueError(
                f"config has {len(specs)} selected planes but got a single "
                "DetectorResponse; pass make_plane_responses(cfg) (or None "
                "to build the per-plane defaults)")
        return (resp,)
    resps = tuple(resp)
    if len(resps) != len(specs):
        raise ValueError(f"got {len(resps)} responses for {len(specs)} "
                         "selected planes")
    return resps


def drift_stage(cfg: LArTPCConfig,
                planes: Optional[Tuple[int, ...]] = None) -> Stage:
    """Transport physical depos to the readout plane(s); pass a DepoSet that
    already arrived straight through. Multi-plane configs project each
    physical depo onto every selected plane; pre-drifted multi-plane input
    carries the full plane axis, from which the selected planes are taken."""
    from repro_torch.core.drift import PhysicalDepoSet, transport, \
        transport_planes

    multi = cfg.num_planes > 1

    def fn(state: SimState) -> SimState:
        if isinstance(state.depos, PhysicalDepoSet):
            depos = (transport_planes(state.depos, cfg, planes=planes)
                     if multi else transport(state.depos, cfg))
            return state._replace(depos=depos)
        if multi:
            if state.depos.wire.ndim < 2:
                raise ValueError(
                    "multi-plane config fed a planeless DepoSet; pass a "
                    "PhysicalDepoSet (the drift stage projects it onto "
                    "every plane) or a DepoSet with a leading plane axis "
                    "(e.g. generate_plane_depos)")
            n_in = state.depos.wire.shape[-2]
            if n_in != cfg.num_planes:
                raise ValueError(
                    f"pre-drifted depos carry {n_in} planes but the config "
                    f"has num_planes={cfg.num_planes}; pre-drifted input "
                    "always carries the FULL plane axis")
            if planes is not None:
                return state._replace(depos=DepoSet(
                    *(x[list(planes)] for x in state.depos)))
        return state

    return Stage("drift", fn, op="drift")


def compute_charge_grid(k: torch.Tensor, depos: DepoSet, cfg: LArTPCConfig,
                        n_valid: Optional[int] = None,
                        strategy: Optional[str] = None,
                        pool: Optional[torch.Tensor] = None):
    """Dispatch depos -> (S(t,x), dropped) through the registered strategy
    ``strategy`` (default: ``cfg.charge_grid_strategy``, where ``"auto"``
    takes the tuning cache's decision or the default of the depos'
    device); ``dropped`` counts entries of depos below ``n_valid`` only.
    ``pool`` is the normal pool of ``rng_strategy="pool"``."""
    if strategy is None:
        strategy = autotune.resolve("charge_grid", cfg,
                                    device=depos.wire.device).strategy
    return get_strategy("charge_grid", strategy).fn(k, depos, cfg,
                                                    n_valid=n_valid,
                                                    pool=pool)


def charge_grid_stage(cfg: LArTPCConfig,
                      planes: Optional[Tuple[int, ...]] = None,
                      device="cuda",
                      pool: Optional[torch.Tensor] = None) -> Stage:
    """depos -> S(t,x): rasterize + fluctuate + scatter-add, or a fused
    kernel, dispatched through the ``charge_grid`` registry.

    Multi-plane: plane i draws from ``fold_in(kf, index_i)`` and the grids
    stack to (P, W, T). ``stacked`` hands all planes of a full graph to a
    multi-plane strategy in one call; otherwise the stage dispatches per
    plane (a multi-plane strategy through its single-plane form). The
    ``pool`` stream gives every plane, and every event, the one pool from
    offset 0, the paper's fixed pre-computed pool.

    Over a batch, a fused strategy takes every (event, plane) row of the
    batch at once, each row with the seed the per-event run gives it
    (``repro_torch.core.pipeline.charge_grid_fused_rows``); the other
    strategies run one event at a time. An ``"auto"`` strategy resolves
    once, here, for ``device``."""
    specs = _selected_specs(cfg, planes)
    multi = cfg.num_planes > 1
    stacked = multi and resolve_plane_batching(cfg) == "stacked"
    name = autotune.resolve("charge_grid", cfg, device=device).strategy
    get_strategy("charge_grid", name)  # an unknown name fails at build
    whole_stack = stacked and len(specs) == cfg.num_planes

    def per_plane(keys, depos: DepoSet, n_valid):
        outs = [compute_charge_grid(k, DepoSet(*(x[i] for x in depos)), cfg,
                                    n_valid, name, pool)
                for i, k in enumerate(keys)]
        return (torch.stack([g for g, _ in outs]),
                torch.stack([d for _, d in outs]).sum())

    def fn(state: SimState) -> SimState:
        if not multi:
            grid, dropped = compute_charge_grid(state.kf, state.depos, cfg,
                                                state.n_valid, name, pool)
        elif name in MULTIPLANE_CHARGE_GRID and whole_stack:
            grid, dropped = get_strategy("charge_grid", name).fn(
                state.kf, state.depos, cfg, n_valid=state.n_valid, pool=pool)
        else:
            grid, dropped = per_plane(_plane_keys(state.kf, specs),
                                      state.depos, state.n_valid)
        return state._replace(grid=grid, dropped=dropped)

    def batch_fn(states: List[SimState]) -> List[SimState]:
        from repro_torch.core.pipeline import (FUSED_ROWS,
                                               charge_grid_fused_rows)

        if name not in FUSED_ROWS or (name in MULTIPLANE_CHARGE_GRID
                                      and not whole_stack):
            return [fn(s) for s in states]
        outs = charge_grid_fused_rows(
            name, [s.kf for s in states], [s.depos for s in states], cfg,
            specs, [s.n_valid for s in states])
        return [s._replace(grid=g, dropped=d)
                for s, (g, d) in zip(states, outs)]

    return Stage("charge_grid", fn, op="charge_grid", batch_fn=batch_fn)


def _spectra_stage(name: str, op: str, buffer: str, resps,
                   apply: Callable[[torch.Tensor, DetectorResponse, str],
                                   torch.Tensor],
                   source: Callable[[SimState], torch.Tensor], target: str,
                   cfg: LArTPCConfig, strategy: Optional[str],
                   device) -> Stage:
    """A stage applying one spectrum per plane (held as the buffer
    ``buffer``, (P, ...) for several planes) to ``source(state)`` with
    ``apply(x, resp, name)`` and writing the result to the state's
    ``target`` field: one call per plane in either batching mode, so a
    plane's bits do not depend on the planes beside it. Each plane's
    strategy name of ``op`` resolves once, here, from ``strategy`` for its
    own plane kind on ``device``."""
    if len({r.pad_shape for r in resps}) != 1:
        raise ValueError("the per-plane responses must share one padded "
                         f"shape, got {[r.pad_shape for r in resps]}")
    multi = cfg.num_planes > 1
    grid_shape = (cfg.num_wires, cfg.num_ticks)
    names = [resolve_spectrum_strategy(op, strategy, grid_shape, r, device)
             for r in resps]
    stage = Stage(name, None, op=op)
    stage.register_buffer(buffer, torch.stack(
        [r.freq for r in resps]) if multi else resps[0].freq)

    def fn(state: SimState) -> SimState:
        freq = getattr(stage, buffer)
        x = source(state)
        if not multi:
            out = apply(x, resps[0]._replace(freq=freq), names[0])
        else:
            out = torch.stack([apply(x[i], r._replace(freq=freq[i]), names[i])
                               for i, r in enumerate(resps)])
        return state._replace(**{target: out})

    stage.fn = fn
    return stage


def convolve_stage(cfg: LArTPCConfig, resp,
                   planes: Optional[Tuple[int, ...]] = None,
                   device="cuda") -> Stage:
    """S(t,x) -> M(t,x): frequency-domain convolution with the response,
    whose spectrum the stage holds as the buffer ``response_freq``
    (multi-plane: one response per plane, bipolar induction and unipolar
    collection, one convolution per plane)."""
    resps = _as_plane_responses(cfg, resp, planes, device)
    return _spectra_stage(
        "convolve", "fft_convolve", "response_freq", resps, fft_convolve,
        lambda state: state.grid, "signal", cfg, cfg.fft_strategy, device)


def noise_stage(cfg: LArTPCConfig,
                planes: Optional[Tuple[int, ...]] = None) -> Stage:
    """Add frequency-shaped electronics noise to the signal (multi-plane:
    an independent realisation per plane from the plane-folded subkeys)."""
    specs = _selected_specs(cfg, planes)
    multi = cfg.num_planes > 1

    def fn(state: SimState) -> SimState:
        dev = state.signal.device
        if not multi:
            noise = simulate_noise(state.kn, cfg, device=dev)
        else:
            noise = torch.stack([simulate_noise(k, cfg, device=dev)
                                 for k in _plane_keys(state.kn, specs)])
        denom = torch.clamp_min(scalar(cfg.adc_per_electron, noise), 1e-30)
        return state._replace(signal=state.signal + noise / denom)

    return Stage("noise", fn)


def digitize_stage(cfg: LArTPCConfig) -> Stage:
    """M(t,x) -> int16 ADC counts."""

    def fn(state: SimState) -> SimState:
        return state._replace(adc=digitize(state.signal, cfg))

    return Stage("digitize", fn)


def deconvolve_stage(cfg: LArTPCConfig, resp,
                     planes: Optional[Tuple[int, ...]] = None,
                     device="cuda") -> Stage:
    """ADC -> S^(t,x): invert the response with the config's regularised
    filter (``deconvolve`` registry). The per-plane filters are built once,
    from the same responses the convolve stage applies, and held as the
    buffer ``filter_freq``; one deconvolution per plane."""
    from repro_torch.core.deconvolve import (deconvolve, make_deconv_filter,
                                             measured_signal)

    filts = tuple(make_deconv_filter(r, cfg)
                  for r in _as_plane_responses(cfg, resp, planes, device))
    return _spectra_stage(
        "deconvolve", "deconvolve", "filter_freq", filts, deconvolve,
        lambda state: measured_signal(state.adc, cfg), "decon", cfg,
        cfg.deconv_strategy, device)


def hit_find_stage(cfg: LArTPCConfig,
                   planes: Optional[Tuple[int, ...]] = None,
                   device="cuda") -> Stage:
    """S^(t,x) -> HitSet: threshold-scan runs on every deconvolved wire
    (``hit_find`` registry; an ``"auto"`` strategy resolves once, here, for
    ``device``). Multi-plane: one scan per plane, the HitSet leaves stacked
    to (P, max_hits)."""
    from repro_torch.core.hitfind import find_hits, stack_hits

    n_planes = len(_selected_specs(cfg, planes))
    name = autotune.resolve("hit_find", cfg, device=device).strategy

    def fn(state: SimState) -> SimState:
        if cfg.num_planes == 1:
            return state._replace(hits=find_hits(state.decon, cfg, name))
        return state._replace(hits=stack_hits(
            find_hits(state.decon[i], cfg, name) for i in range(n_planes)))

    return Stage("hit_find", fn, op="hit_find")


#: which SimState field each stage's finite sentinel inspects (digitize
#: writes integers only; hit_find's float leaves are checked too)
_FINITE_CHECK_FIELDS = {
    "drift": "depos",
    "charge_grid": "grid",
    "convolve": "signal",
    "noise": "signal",
    "deconvolve": "decon",
    "hit_find": "hits",
}


def _finite_checked(stage: Stage) -> Stage:
    """Turn on the ``cfg.check_finite`` sentinel of ``stage``: after it
    runs, AND ``isfinite(...).all()`` over the float leaves it wrote into
    the state's ``finite_ok``. One reduction per leaf, on the device, and
    never a branch or a host read."""
    stage.finite_field = _FINITE_CHECK_FIELDS.get(stage.name)
    return stage


def check_supported(cfg: LArTPCConfig) -> None:
    """Raise for a patch dtype the port does not rasterise, and for a bad
    plane geometry or batching mode."""
    patch_dtype(cfg)
    plane_specs(cfg)
    resolve_plane_batching(cfg)


def build_sim_graph(cfg: LArTPCConfig, resp=None, add_noise: bool = True,
                    device="cuda",
                    planes: Optional[Tuple[int, ...]] = None,
                    recon: bool = False,
                    pool: Optional[torch.Tensor] = None) -> SimGraph:
    """Assemble the canonical ``drift -> charge_grid -> convolve -> noise ->
    digitize`` chain on ``device`` (the one place the order is written).

    ``resp``: a ``DetectorResponse`` (single plane), one per plane, or None
    for the per-plane defaults. ``add_noise=False`` drops the noise stage.
    ``planes`` restricts a multi-plane graph to those plane indices.
    ``recon=True`` appends ``deconvolve -> hit_find``, whose filters come
    from the same responses; the default graph has no recon stage and no
    ``decon``/``hits`` output. ``cfg.check_finite`` turns on the finite
    sentinel of every stage (``finite_ok``); the ADC is the same bits.
    ``pool``: the normals of ``rng_strategy="pool"``; when the config
    fluctuates from the pool and none is given, the standard pool,
    ``make_pool(key(1234))`` (2**20 normals on ``device``). The graph is
    fig4's whatever ``cfg.pipeline`` says."""
    check_supported(cfg)
    dev = resolve_device(device)
    if pool is None and cfg.fluctuate and cfg.rng_strategy == "pool":
        pool = make_pool(prng.key(1234), device=dev)
    resps = _as_plane_responses(cfg, resp, planes, dev)
    stages = [drift_stage(cfg, planes),
              charge_grid_stage(cfg, planes, dev, pool),
              convolve_stage(cfg, resps, planes, dev)]
    if add_noise:
        stages.append(noise_stage(cfg, planes))
    stages.append(digitize_stage(cfg))
    if recon:
        stages += [deconvolve_stage(cfg, resps, planes, dev),
                   hit_find_stage(cfg, planes, dev)]
    if cfg.check_finite:
        stages = [_finite_checked(s) for s in stages]
    return SimGraph(stages, dev)
