"""Kernel-strategy registry: one table of candidate implementations per hot op.

Same surface as the reference's registry: each hot op (``charge_grid``,
``scatter_add``, ``fft_convolve``, ``drift``) registers its candidates under
a name with their ``differentiable`` and ``collectives`` metadata, and
per-backend defaults live in one table. There is no autotuner in the port
yet: a config field set to ``"auto"`` resolves to the registry default.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple


@dataclasses.dataclass(frozen=True)
class Strategy:
    """One registered candidate implementation of a hot op.

    ``differentiable``: whether autograd can flow through the candidate
    (hand-written kernels without a backward say False).
    ``collectives``: collective kinds the candidate may issue (none for
    every single-device strategy).
    """

    op: str
    name: str
    fn: Callable
    note: str = ""
    differentiable: bool = True
    collectives: Tuple[str, ...] = ()


_OPS: Dict[str, Dict[str, Strategy]] = {}
_DEFAULTS: Dict[str, Dict[str, str]] = {}  # op -> {backend or "*": name}


def register_strategy(op: str, name: str, *, note: str = "",
                      differentiable: bool = True,
                      collectives: Tuple[str, ...] = ()):
    """Decorator: register ``fn`` as candidate ``name`` of hot op ``op``."""

    def deco(fn):
        _OPS.setdefault(op, {})[name] = Strategy(
            op, name, fn, note, differentiable, tuple(collectives))
        return fn

    return deco


def set_default(op: str, name: str, backend: str = "*") -> None:
    """Declare the default strategy of ``op`` on ``backend`` ("*" = any)."""
    _DEFAULTS.setdefault(op, {})[backend] = name


def ensure_registered() -> None:
    """Import every module that registers strategies (idempotent)."""
    import repro_torch.core.drift  # noqa: F401  registers drift/*
    import repro_torch.core.fft_conv  # noqa: F401  registers fft_convolve/*
    import repro_torch.core.pipeline  # noqa: F401  registers charge_grid/*
    import repro_torch.core.scatter  # noqa: F401  registers scatter_add/*


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


def default_strategy(op: str, backend: str = "*") -> str:
    """The default for ``op`` on ``backend`` ("cuda" | "cpu" | "*")."""
    ensure_registered()
    table = _DEFAULTS.get(op, {})
    if backend in table:
        return table[backend]
    if "*" in table:
        return table["*"]
    raise KeyError(f"no default strategy declared for op {op!r}")


def resolve(op: str, name: str, backend: str = "*") -> Strategy:
    """The strategy ``name`` of ``op``, with ``"auto"`` meaning the default."""
    if name == "auto":
        name = default_strategy(op, backend)
    return get_strategy(op, name)
