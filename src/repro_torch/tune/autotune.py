"""Empirical autotuner: time registered candidates, cache the winner to disk.

The reference's autotuner, on torch devices. Which implementation of a hot
op is fastest is decided by measurement on the device the run uses, at the
run's problem shape, and cached so later runs skip the timing:

  key   = (op, backend, device_kind, shape-bucket)
  value = {strategy, timings_us, shape, backend, device_kind, timer,
           torch_version, cuda_version, tuned_at, schema}

Shape dims are bucketed to the next power of two, so 100_000 and 120_000
depos share one decision but 1_000 does not. The cache is one JSON file,
the port's own (default ``~/.cache/repro-torch-tune/tune_cache.json``,
override with ``$REPRO_TORCH_TUNE_CACHE``): human-readable, safe to delete,
and never the reference's file.

Resolution order for a strategy-valued config field:

  explicit name  >  disk cache  >  (tune now, if asked)  >  backend default

``resolve_config`` runs before a graph is built, so a graph (and a stream
over it) fixes its strategy names once. Every ``"auto"`` dispatch site
resolves from the cache or the backend default of its tensor's device and
never times anything.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import time
import uuid
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.tune import registry
from repro_torch.tune.registry import TuneContext

CACHE_ENV = "REPRO_TORCH_TUNE_CACHE"

#: cache record schema version. Bump on incompatible record changes: entries
#: with a different (or missing) ``schema`` field are ignored per entry, so
#: a stale or foreign record degrades to a cache miss, never a crash.
SCHEMA_VERSION = 1

#: op -> the config field that names its strategy
OP_FIELDS: Dict[str, str] = {
    "drift": "drift_strategy",
    "scatter_add": "scatter_strategy",
    "charge_grid": "charge_grid_strategy",
    "fft_convolve": "fft_strategy",
    "deconvolve": "deconv_strategy",
    "hit_find": "hitfind_strategy",
}

#: ops whose decision is keyed by the plane KIND (their transforms differ
#: between bipolar induction and unipolar collection planes): on multi-plane
#: "auto" configs the field stays "auto" and every dispatch resolves with
#: its own plane key (see resolve_config_with_decisions)
PLANE_KEYED_OPS = ("fft_convolve", "deconvolve")


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------


def default_cache_path() -> str:
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    home = os.path.expanduser("~")
    return os.path.join(home, ".cache", "repro-torch-tune", "tune_cache.json")


class TuneCache:
    """A {cache_key: decision-record} JSON file, loaded lazily, written on put.

    Robust to what a shared cache file sees:

    * **Concurrent writers**: each ``put`` writes a per-process temp name
      (pid + random suffix) and atomically ``os.replace``s it in, so two
      processes never interleave bytes; and it merges on write (re-read
      the disk, overlay this handle's own entries), so the last writer
      keeps the other's decisions instead of clobbering them.
    * **Corrupt files**: torn writes, garbage bytes and non-dict JSON
      degrade to an empty cache (a re-tune), never a crash.
    * **Foreign entries**: records without ``schema == SCHEMA_VERSION`` (or
      not dicts at all) are dropped per entry on read.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path or default_cache_path()
        self._data: Optional[Dict[str, dict]] = None
        #: entries written through THIS handle, re-overlaid on every merge
        self._local: Dict[str, dict] = {}

    @staticmethod
    def _valid(entry: object) -> bool:
        return isinstance(entry, dict) and entry.get("schema") == SCHEMA_VERSION

    def _read_disk(self) -> Dict[str, dict]:
        try:
            with open(self.path) as f:
                raw = json.load(f)
        except (OSError, ValueError, UnicodeDecodeError):
            return {}
        if not isinstance(raw, dict):
            return {}
        return {k: v for k, v in raw.items() if self._valid(v)}

    def _load(self) -> Dict[str, dict]:
        if self._data is None:
            self._data = self._read_disk()
        return self._data

    def get(self, key: str) -> Optional[dict]:
        return self._load().get(key)

    def put(self, key: str, record: dict) -> None:
        record = dict(record, schema=SCHEMA_VERSION)
        self._local[key] = record
        # a concurrent tuner may have landed entries since we loaded: keep
        # theirs, overlay ours
        data = self._read_disk()
        data.update(self._local)
        self._data = data
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        tmp = f"{self.path}.{os.getpid()}.{uuid.uuid4().hex[:8]}.tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(data, f, indent=2, sort_keys=True)
                f.write("\n")
            os.replace(tmp, self.path)
        finally:
            with contextlib.suppress(OSError):
                os.unlink(tmp)


# ---------------------------------------------------------------------------
# Shape buckets and cache keys
# ---------------------------------------------------------------------------


def _bucket(n: int) -> int:
    """Next power of two >= n (0 stays 0): 100_000 -> 131_072."""
    return 0 if n <= 0 else 1 << (int(n) - 1).bit_length()


def shape_bucket(shape: Mapping[str, object]) -> str:
    """Numeric dims bucket to the next power of two; categorical dims (the
    ``plane`` kind) pass through verbatim."""
    return ";".join(
        f"{k}={v}" if isinstance(v, str) else f"{k}={_bucket(v)}"
        for k, v in sorted(shape.items()))


def cache_key(op: str, backend: str, device_kind: str,
              shape: Mapping[str, int]) -> str:
    return f"{op}|{backend}|{device_kind}|{shape_bucket(shape)}"


def op_shape(op: str, cfg) -> Dict[str, int]:
    """The problem dims op's tuning decision depends on."""
    if op == "drift":
        return {"num_depos": cfg.num_depos}
    if op in ("scatter_add", "charge_grid"):
        shape = {
            "num_depos": cfg.num_depos,
            "num_wires": cfg.num_wires,
            "num_ticks": cfg.num_ticks,
            "patch_wires": cfg.patch_wires,
            "patch_ticks": cfg.patch_ticks,
        }
        if op == "charge_grid":
            # the plane count changes the problem: a three-plane dispatch
            # compares single-plane candidates (paying the per-plane loop)
            # with the multi-plane kernels
            shape["num_planes"] = getattr(cfg, "num_planes", 1)
        return shape
    if op in ("fft_convolve", "deconvolve"):
        from repro_torch.config import plane_specs

        return {
            "num_wires": cfg.num_wires,
            "num_ticks": cfg.num_ticks,
            "response_wires": cfg.response_wires,
            "response_ticks": cfg.response_ticks,
            # the response type is part of the problem; this default is the
            # first plane's kind, and multi-plane "auto" configs resolve
            # each plane with its own kind (``_resolve_per_plane``)
            "plane": plane_specs(cfg)[0].kind,
        }
    if op == "hit_find":
        return {
            "num_wires": cfg.num_wires,
            "num_ticks": cfg.num_ticks,
            "max_hits_per_wire": cfg.max_hits_per_wire,
        }
    raise KeyError(f"no shape extractor for op {op!r}")


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------

#: a timer maps (candidate name, zero-arg thunk) -> median seconds; tests
#: inject fakes here to make the winner deterministic without a clock
Timer = Callable[[str, Callable[[], object]], float]

#: the method ``median_timer`` uses on each backend, named in every record
TIMER_METHODS = {
    "cuda": "median_timer: host-paced CUDA events (torch.cuda.synchronize() "
            "before and after each call), median of 3 after 1 warm-up",
    "cpu": "median_timer: time.perf_counter, median of 3 after 1 warm-up",
}


def median_timer(name: str, thunk: Callable[[], object], *,
                 warmup: int = 1, iters: int = 3, device="cuda") -> float:
    """Median seconds of ``iters`` calls of ``thunk`` after ``warmup``.

    On the card each call sits between two CUDA events, with the card
    synchronised before the first and after the second: the time is
    host-paced, so it includes the host's waits inside a call (the tile
    binning's reads), which a user pays. An error the card raises surfaces
    in the call that caused it. On the CPU: ``time.perf_counter``."""
    del name
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    for _ in range(warmup):
        thunk()
        if cuda:
            torch.cuda.synchronize(dev)
    times = []
    for _ in range(iters):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(dev)
            start.record()
            thunk()
            end.record()
            torch.cuda.synchronize(dev)
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            thunk()
            times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


# ---------------------------------------------------------------------------
# Per-op problem builders: representative inputs + one thunk per candidate
# ---------------------------------------------------------------------------


def _problem_depos(cfg, sample_depos: Optional[int], dev):
    from repro_torch.core import prng
    from repro_torch.core.depo import generate_depos

    return generate_depos(prng.key(0), cfg, sample_depos or cfg.num_depos,
                          device=dev)


def _drift_problem(cfg, ctx: TuneContext, sample_depos, dev):
    from repro_torch.core import prng
    from repro_torch.core.depo import generate_physical_depos

    pdepos = generate_physical_depos(prng.key(0), cfg,
                                     sample_depos or cfg.num_depos,
                                     device=dev)

    def make(strat):
        return lambda: strat.fn(pdepos, cfg)

    avail = registry.available_strategies("drift", ctx)
    return {name: make(s) for name, s in avail.items()}


def _scatter_problem(cfg, ctx: TuneContext, sample_depos, dev):
    from repro_torch.core.rasterize import rasterize

    patches, w0, t0 = rasterize(_problem_depos(cfg, sample_depos, dev), cfg)

    def make(strat):
        return lambda: strat.fn(patches, w0, t0, cfg)

    avail = registry.available_strategies("scatter_add", ctx)
    return {name: make(s) for name, s in avail.items()}


def _charge_grid_problem(cfg, ctx: TuneContext, sample_depos, dev):
    from repro_torch.core import prng

    key = prng.key(1)
    avail = registry.available_strategies("charge_grid", ctx)
    if getattr(cfg, "num_planes", 1) > 1:
        from repro_torch.config import plane_specs
        from repro_torch.core.depo import DepoSet, generate_plane_depos
        from repro_torch.core.stages import MULTIPLANE_CHARGE_GRID

        depos = generate_plane_depos(prng.key(0), cfg,
                                     sample_depos or cfg.num_depos,
                                     device=dev)
        specs = plane_specs(cfg)

        def make_mp(name, strat):
            if name in MULTIPLANE_CHARGE_GRID:
                # the multi-plane strategies take the (P, N) depos whole
                return lambda: strat.fn(key, depos, cfg)

            # single-plane candidates pay the FULL per-plane loop with the
            # fold_in seeds the executor uses, so the board compares like
            # with like: all P planes either way
            def loop():
                return torch.stack([
                    strat.fn(prng.fold_in(key, s.index),
                             DepoSet(*(x[i] for x in depos)), cfg)[0]
                    for i, s in enumerate(specs)])

            return loop

        return {name: make_mp(name, s) for name, s in avail.items()}

    depos = _problem_depos(cfg, sample_depos, dev)

    def make(strat):
        return lambda: strat.fn(key, depos, cfg)

    return {name: make(s) for name, s in avail.items()}


def _fft_problem(cfg, ctx: TuneContext, sample_depos, dev):
    from repro_torch.core import prng
    from repro_torch.core.response import make_response

    del sample_depos
    # time against the response the decision is keyed to: collection-plane
    # tunings measure the collection transform
    resp = make_response(cfg, plane=ctx.shape.get("plane", "induction"),
                         device=dev)
    grid = prng.uniform(prng.key(2), (cfg.num_wires, cfg.num_ticks), 0.0,
                        1.0, dev)

    def make(strat):
        return lambda: strat.fn(grid, resp)

    avail = registry.available_strategies("fft_convolve", ctx)
    return {name: make(s) for name, s in avail.items()}


def _deconv_problem(cfg, ctx: TuneContext, sample_depos, dev):
    from repro_torch.core import prng
    from repro_torch.core.deconvolve import make_deconv_filter
    from repro_torch.core.response import make_response

    del sample_depos
    # the inverse filter of the plane kind the decision is keyed to,
    # applied to a measured-signal-sized grid
    resp = make_response(cfg, plane=ctx.shape.get("plane", "induction"),
                         device=dev)
    filt = make_deconv_filter(resp, cfg)
    meas = prng.normal(prng.key(3), (cfg.num_wires, cfg.num_ticks), dev)

    def make(strat):
        return lambda: strat.fn(meas, filt)

    avail = registry.available_strategies("deconvolve", ctx)
    return {name: make(s) for name, s in avail.items()}


def _hitfind_problem(cfg, ctx: TuneContext, sample_depos, dev):
    from repro_torch.core import prng

    del sample_depos
    # noise-scale deconvolved grid: candidate runs appear at a realistic
    # (sparse) rate relative to the threshold
    decon = prng.normal(prng.key(4), (cfg.num_wires, cfg.num_ticks),
                        dev) * cfg.hit_threshold

    def make(strat):
        return lambda: strat.fn(decon, cfg)

    avail = registry.available_strategies("hit_find", ctx)
    return {name: make(s) for name, s in avail.items()}


_PROBLEMS = {
    "drift": _drift_problem,
    "scatter_add": _scatter_problem,
    "charge_grid": _charge_grid_problem,
    "fft_convolve": _fft_problem,
    "deconvolve": _deconv_problem,
    "hit_find": _hitfind_problem,
}

TUNABLE_OPS = tuple(_PROBLEMS)


def _usable_hit(op: str, hit: Optional[dict], ctx: TuneContext) -> bool:
    """A cached decision is usable only if its strategy still exists AND
    its availability predicate passes for the current context: the key
    carries (backend, device_kind, shape) but not config predicates like
    ``rng_strategy``, so a winner tuned under one config must not leak
    into a run whose config rules it out."""
    if not isinstance(hit, dict):  # None, or a foreign non-record entry
        return False
    return hit.get("strategy") in registry.available_strategies(op, ctx)


def candidate_thunks(op: str, cfg, *, sample_depos: Optional[int] = None,
                     shape: Optional[Mapping[str, int]] = None,
                     device="cuda") -> Dict[str, Callable[[], object]]:
    """Zero-arg thunks for every *available* candidate of ``op``, on
    representative inputs for ``cfg`` made on ``device``."""
    registry.ensure_registered()
    dev = resolve_device(device)
    shape = dict(shape) if shape is not None else op_shape(op, cfg)
    ctx = registry.make_context(cfg, shape, dev)
    return _PROBLEMS[op](cfg, ctx, sample_depos, dev)


# ---------------------------------------------------------------------------
# Resolution
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TuneDecision:
    """How a strategy name was arrived at for one op."""

    op: str
    strategy: str
    source: str  # explicit | cache | tuned | default
    cache_key: str = ""
    timings_us: Tuple[Tuple[str, float], ...] = ()

    @property
    def cache_hit(self) -> bool:
        return self.source == "cache"

    def describe(self) -> str:
        if self.source == "tuned":
            ordered = sorted(self.timings_us, key=lambda it: it[1])
            board = ", ".join(f"{n}={t:.0f}us" for n, t in ordered)
            return (f"tune[{self.op}]: selected {self.strategy!r} "
                    f"(tuned: {board}) -> cached as {self.cache_key}")
        if self.source == "cache":
            return (f"tune[{self.op}]: selected {self.strategy!r} "
                    f"(cache hit: {self.cache_key})")
        return f"tune[{self.op}]: selected {self.strategy!r} ({self.source})"


def _timer_method(timer: Optional[Timer], backend: str) -> str:
    if timer is None:
        return TIMER_METHODS[backend]
    return getattr(timer, "__name__", type(timer).__name__)


def tune_op(op: str, cfg, *, cache: Optional[TuneCache] = None,
            timer: Optional[Timer] = None, force: bool = False,
            sample_depos: Optional[int] = None,
            shape: Optional[Mapping[str, int]] = None,
            device="cuda") -> TuneDecision:
    """Pick the fastest available candidate of ``op`` for this config on
    ``device``.

    Consults the disk cache first (unless ``force``); on a miss, times
    every available candidate with ``timer`` (default ``median_timer`` on
    ``device``) and persists the winner. A candidate that raises fails the
    tune: none is skipped.
    """
    registry.ensure_registered()
    cache = cache or TuneCache()
    dev = resolve_device(device)
    shape = dict(shape) if shape is not None else op_shape(op, cfg)
    ctx = registry.make_context(cfg, shape, dev)
    key = cache_key(op, ctx.backend, ctx.device_kind, shape)

    if not force:
        hit = cache.get(key)
        if _usable_hit(op, hit, ctx):
            return TuneDecision(op=op, strategy=hit["strategy"],
                                source="cache", cache_key=key)

    candidates = candidate_thunks(op, cfg, sample_depos=sample_depos,
                                  shape=shape, device=dev)
    if not candidates:
        return TuneDecision(op=op,
                            strategy=registry.default_strategy(op, ctx.backend),
                            source="default", cache_key=key)
    time_one = timer or functools.partial(median_timer, device=dev)
    timings = {name: time_one(name, thunk)
               for name, thunk in candidates.items()}
    winner = min(timings, key=timings.get)
    timings_us = {n: t * 1e6 for n, t in timings.items()}
    cache.put(key, {
        "strategy": winner,
        "timings_us": timings_us,
        "shape": dict(shape),
        "backend": ctx.backend,
        "device_kind": ctx.device_kind,
        "timer": _timer_method(timer, ctx.backend),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "tuned_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
    })
    return TuneDecision(op=op, strategy=winner, source="tuned", cache_key=key,
                        timings_us=tuple(sorted(timings_us.items())))


def resolve(op: str, cfg, *, tune: bool = False,
            cache: Optional[TuneCache] = None, timer: Optional[Timer] = None,
            force: bool = False, sample_depos: Optional[int] = None,
            shape: Optional[Mapping[str, int]] = None,
            device="cuda") -> TuneDecision:
    """Resolve ``op``'s strategy for ``cfg`` on ``device``: explicit > cache
    > tune > default (the default of ``device``'s backend).

    Never times unless ``tune=True``. ``cfg`` may be None for a
    cache/default-only lookup when ``shape`` is given.
    """
    if cfg is not None:
        explicit = getattr(cfg, OP_FIELDS[op], "auto")
        if explicit != "auto":
            return TuneDecision(op=op, strategy=explicit, source="explicit")
    registry.ensure_registered()
    cache = cache or TuneCache()
    shape = dict(shape) if shape is not None else op_shape(op, cfg)
    ctx = registry.make_context(cfg, shape, device)
    key = cache_key(op, ctx.backend, ctx.device_kind, shape)
    if not force:
        hit = cache.get(key)
        if _usable_hit(op, hit, ctx):
            return TuneDecision(op=op, strategy=hit["strategy"],
                                source="cache", cache_key=key)
    if tune and cfg is not None:
        return tune_op(op, cfg, cache=cache, timer=timer, force=force,
                       sample_depos=sample_depos, shape=shape, device=device)
    name = registry.default_strategy(op, ctx.backend)
    return TuneDecision(op=op, strategy=name, source="default", cache_key=key)


def resolve_config(cfg, *, tune: bool = False,
                   cache: Optional[TuneCache] = None,
                   timer: Optional[Timer] = None, force: bool = False,
                   sample_depos: Optional[int] = None, device="cuda"):
    """Replace every ``"auto"`` strategy field of ``cfg`` with a concrete
    name for ``device``. Call it before building a graph, so the graph's
    strategies are fixed. Non-auto fields pass through untouched."""
    cfg, _ = resolve_config_with_decisions(
        cfg, tune=tune, cache=cache, timer=timer, force=force,
        sample_depos=sample_depos, device=device)
    return cfg


def resolve_config_with_decisions(cfg, *, tune: bool = False,
                                  cache: Optional[TuneCache] = None,
                                  timer: Optional[Timer] = None,
                                  force: bool = False,
                                  sample_depos: Optional[int] = None,
                                  tune_explicit: bool = False,
                                  device="cuda"):
    """Like ``resolve_config`` but also returns the per-op decisions.

    ``tune_explicit=True`` re-tunes ops even when their config field
    already names a concrete strategy (the ``--tune`` launcher flag:
    measure and override, don't trust the hand-picked value).
    """
    cache = cache or TuneCache()
    decisions = []
    for op, fld in OP_FIELDS.items():
        if tune and tune_explicit and getattr(cfg, fld) != "auto":
            cfg = dataclasses.replace(cfg, **{fld: "auto"})
        if (op in PLANE_KEYED_OPS and getattr(cfg, "num_planes", 1) > 1
                and getattr(cfg, fld) == "auto"):
            # one config field cannot name a per-plane winner: "auto" stays
            # and each dispatch resolves with its own plane key; tuning
            # here measures every distinct plane kind, so those per-plane
            # cache entries exist before the graph is built
            decisions.extend(_resolve_per_plane(
                op, cfg, tune=tune, cache=cache, timer=timer, force=force,
                sample_depos=sample_depos, device=device))
            continue
        d = resolve(op, cfg, tune=tune, cache=cache, timer=timer, force=force,
                    sample_depos=sample_depos, device=device)
        decisions.append(d)
        if getattr(cfg, fld) != d.strategy:
            cfg = dataclasses.replace(cfg, **{fld: d.strategy})
    return cfg, decisions


def _resolve_per_plane(op: str, cfg, *, tune: bool, cache: TuneCache,
                       timer: Optional[Timer], force: bool,
                       sample_depos: Optional[int], device):
    """One decision of a plane-keyed op per distinct plane kind of a
    multi-plane config (the field itself stays "auto"; see the caller)."""
    from repro_torch.config import plane_specs

    decisions = []
    for kind in sorted({s.kind for s in plane_specs(cfg)}):
        shape = dict(op_shape(op, cfg), plane=kind)
        if tune:
            d = tune_op(op, cfg, cache=cache, timer=timer, force=force,
                        sample_depos=sample_depos, shape=shape, device=device)
        else:
            # cache/default lookup only: cfg=None skips the explicit-name
            # branch (the field is "auto" here by construction)
            d = resolve(op, None, cache=cache, shape=shape, device=device)
        decisions.append(d)
    return decisions
