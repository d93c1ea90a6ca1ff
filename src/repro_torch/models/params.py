"""Parameter system: params are nested dicts of tensors; builders are
interpreted twice.

A model is defined by a ``build(make)`` function that calls
``make(path, shape, names, ...)`` for every parameter, as the reference's
is. Four interpreters:

  init_params   -> tensors (random init, per-path key folding)
  param_shapes  -> tensors on the ``meta`` device (shapes and dtypes only)
  param_names   -> the logical dim names of every parameter
  param_specs   -> their specs on a mesh (``parallel.sharding.build_spec``)

The per-path key is the md5 of the path folded into the model's key, and
the normals are the port's threefry draws, so ``init_params`` gives the
reference's parameters: zeros, ones and the RG-LRU's ``uniform_angle``
draws exactly (``prng.uniform`` reproduces ``jax.random.uniform``'s
bits), normals up to the ULPs of ``erfinv``. ``param_specs`` maps the
logical dim names to a mesh under ``PARAM_RULES`` (or the rules given), as
the reference's does.
"""
from __future__ import annotations

import hashlib
import math
from typing import Callable

import torch

from repro_torch.core import prng
from repro_torch.device import resolve_device

#: elements drawn at once: the threefry's int64 temporaries of a draw take
#: about 8 bytes x 6 per element, so a 590 M-element table (gemma2-2b's)
#: is drawn in ranges of this many elements (equal to one draw, see
#: ``prng.random_bits``)
DRAW_CHUNK = 1 << 26


def _path_key(key: torch.Tensor, path: str) -> torch.Tensor:
    h = int.from_bytes(hashlib.md5(path.encode()).digest()[:4], "little")
    return prng.fold_in(key, h)


def _draw(sampler, shape, device) -> torch.Tensor:
    """``sampler(shape_of_range, offset)`` over the flattened elements, in
    ranges of at most ``DRAW_CHUNK``."""
    n, chunk = math.prod(shape), DRAW_CHUNK
    if n <= chunk:
        return sampler((n,), 0).reshape(shape)
    out = torch.empty(n, dtype=torch.float32, device=device)
    for start in range(0, n, chunk):
        stop = min(n, start + chunk)
        out[start:stop] = sampler((stop - start,), start)
    return out.reshape(shape)


def init_params(build: Callable, key: torch.Tensor, dtype=torch.float32,
                device="cuda"):
    device = resolve_device(device)

    def make(path, shape, names, scale=1.0, init="normal", dtype_=None):
        dt = dtype_ or dtype
        if init == "zeros":
            return torch.zeros(shape, dtype=dt, device=device)
        if init == "ones":
            return torch.ones(shape, dtype=dt, device=device)
        k = _path_key(key, path)
        if init == "uniform_angle":
            # jax.random.uniform(k, shape, dt, -3.14159, 3.14159)
            return _draw(lambda s, o: prng.uniform(k, s, -3.14159, 3.14159,
                                                   device, dt, offset=o),
                         shape, device).to(dt)
        # scaled in place: a second full-size tensor would not fit beside
        # deepseek-moe-16b's 61 GiB of experts
        return _draw(lambda s, o: prng.normal(k, s, device, offset=o),
                     shape, device).mul_(scale).to(dt)

    return build(make)


def param_shapes(build: Callable, dtype=torch.float32):
    def make(path, shape, names, scale=1.0, init="normal", dtype_=None):
        return torch.empty(shape, dtype=dtype_ or dtype, device="meta")

    return build(make)


def param_names(build: Callable):
    def make(path, shape, names, scale=1.0, init="normal", dtype_=None):
        return tuple(names)

    return build(make)


def param_specs(build: Callable, mesh, rules=None):
    """The spec tree of the build's parameters."""
    from repro_torch.parallel.sharding import PARAM_RULES, build_spec

    rules = rules or PARAM_RULES

    def make(path, shape, names, scale=1.0, init="normal", dtype_=None):
        return build_spec(shape, names, mesh, rules)

    return build(make)


def count_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    return tree.numel()
