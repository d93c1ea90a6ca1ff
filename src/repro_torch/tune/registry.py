"""Kernel-strategy registry: one table of candidate implementations per hot op.

The reference's registry, for torch devices: each hot op (``charge_grid``,
``scatter_add``, ``fft_convolve``, ``drift``, ``deconvolve``,
``hit_find``) registers its candidates under a name, with an availability
predicate (some candidates only make sense on some backends or shapes)
and their ``differentiable`` and ``collectives`` metadata; per-backend
defaults live in one table. The autotuner (``repro_torch.tune.autotune``)
walks the same table to time the available candidates on a device and
cache the winner.

The backend of a context is the torch device type, ``"cuda"`` or
``"cpu"``: the compiled kernels run on ``"cuda"``, where the reference's
run on ``"tpu"``; on the CPU their wrappers run the plain versions. The
device is explicit everywhere: no function here picks one.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TuneContext:
    """Everything an availability predicate may inspect.

    cfg        : the workload config (``LArTPCConfig`` for the sim ops).
    backend    : the torch device type ("cuda" | "cpu").
    device_kind: e.g. "NVIDIA_H100_80GB_HBM3", "cpu"; part of the tuning
                 cache key.
    shape      : problem dims the op cares about (num_depos, grid dims, ...).
    """

    cfg: Any
    backend: str
    device_kind: str
    shape: Mapping[str, int]


@dataclasses.dataclass(frozen=True)
class Strategy:
    """One registered candidate implementation of a hot op.

    ``available``: the predicate a ``TuneContext`` must pass for the
    candidate to compete (None: always).
    ``differentiable``: whether autograd can flow through the candidate
    (hand-written kernels without a backward say False).
    ``collectives``: collective kinds the candidate may issue (none for
    every single-device strategy).
    """

    op: str
    name: str
    fn: Callable
    available: Optional[Callable[[TuneContext], bool]] = None
    note: str = ""
    differentiable: bool = True
    collectives: Tuple[str, ...] = ()

    def is_available(self, ctx: TuneContext) -> bool:
        return self.available is None or bool(self.available(ctx))


_OPS: Dict[str, Dict[str, Strategy]] = {}
_DEFAULTS: Dict[str, Dict[str, str]] = {}  # op -> {backend or "*": name}


def register_strategy(op: str, name: str, *,
                      available: Optional[Callable[[TuneContext], bool]] = None,
                      note: str = "", differentiable: bool = True,
                      collectives: Tuple[str, ...] = ()):
    """Decorator: register ``fn`` as candidate ``name`` of hot op ``op``."""

    def deco(fn):
        _OPS.setdefault(op, {})[name] = Strategy(
            op, name, fn, available, note, differentiable, tuple(collectives))
        return fn

    return deco


def set_default(op: str, name: str, backend: str = "*") -> None:
    """Declare the default strategy of ``op`` on ``backend`` ("*" = any
    backend without a more specific entry)."""
    _DEFAULTS.setdefault(op, {})[backend] = name


def ensure_registered() -> None:
    """Import every module that registers strategies (idempotent)."""
    import repro_torch.core.deconvolve  # noqa: F401  registers deconvolve/*
    import repro_torch.core.drift  # noqa: F401  registers drift/*
    import repro_torch.core.fft_conv  # noqa: F401  registers fft_convolve/*
    import repro_torch.core.hitfind  # noqa: F401  registers hit_find/*
    import repro_torch.core.pipeline  # noqa: F401  registers charge_grid/*
    import repro_torch.core.scatter  # noqa: F401  registers scatter_add/*


def list_ops() -> list:
    ensure_registered()
    return sorted(_OPS)


def strategies(op: str) -> Dict[str, Strategy]:
    """All registered candidates of ``op`` (name -> Strategy)."""
    ensure_registered()
    if op not in _OPS:
        raise KeyError(f"unknown hot op {op!r}; known: {sorted(_OPS)}")
    return dict(_OPS[op])


def get_strategy(op: str, name: str) -> Strategy:
    table = strategies(op)
    if name not in table:
        raise KeyError(f"unknown strategy {name!r} for op {op!r}; "
                       f"known: {sorted(table)}")
    return table[name]


def available_strategies(op: str, ctx: TuneContext) -> Dict[str, Strategy]:
    """Candidates of ``op`` whose availability predicate passes for ``ctx``."""
    return {n: s for n, s in strategies(op).items() if s.is_available(ctx)}


def differentiable_strategies(op: str) -> Dict[str, Strategy]:
    """Candidates of ``op`` that autograd can flow through."""
    return {n: s for n, s in strategies(op).items() if s.differentiable}


def is_differentiable(op: str, name: str) -> bool:
    """Whether candidate ``name`` of ``op`` supports autograd."""
    return get_strategy(op, name).differentiable


def declared_collectives(op: Optional[str] = None) -> Tuple[str, ...]:
    """Union of collective kinds declared by registered strategies: of one
    op, or of every op (``op=None``)."""
    ops = [op] if op is not None else list_ops()
    kinds: set = set()
    for o in ops:
        for strat in strategies(o).values():
            kinds.update(strat.collectives)
    return tuple(sorted(kinds))


def default_strategy(op: str, backend: str = "*") -> str:
    """The default (non-tuned) strategy of ``op`` on ``backend`` ("cuda" |
    "cpu"; "*" asks for the any-backend entry)."""
    ensure_registered()
    table = _DEFAULTS.get(op, {})
    if backend in table:
        return table[backend]
    if "*" in table:
        return table["*"]
    raise KeyError(f"no default strategy declared for op {op!r}")


def current_backend(device) -> str:
    """The backend of ``device``: its torch device type ("cuda" | "cpu")."""
    return torch.device(device).type


def current_device_kind(device) -> str:
    """The card's name with spaces as ``_`` (the tuning cache's key), or
    ``"cpu"``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    return torch.cuda.get_device_name(dev).replace(" ", "_")


def make_context(cfg, shape: Mapping[str, int], device=None,
                 backend: Optional[str] = None) -> TuneContext:
    """The context of ``cfg`` at ``shape`` on ``device`` (default the card,
    like every entry point; raises without one). ``backend`` overrides the
    device's backend for availability questions only."""
    dev = resolve_device("cuda" if device is None else device)
    return TuneContext(cfg=cfg, backend=backend or current_backend(dev),
                       device_kind=current_device_kind(dev),
                       shape=dict(shape))
