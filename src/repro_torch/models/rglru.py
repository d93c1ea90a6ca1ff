"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

Real-gated linear recurrent unit:
    r_t = sigmoid(W_a x_t)           (recurrence gate)
    i_t = sigmoid(W_i x_t)           (input gate)
    a_t = exp(-c * softplus(Λ) * r_t)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

A prompt runs ``_lru_scan``, the odd/even recursion of
``jax.lax.associative_scan`` (log depth, the same tree of combines, so the
same roundings); decode carries h. As in the reference's
``src/repro/models/rglru.py``.

XLA on the CPU contracts the recurrence's ``a * h + b`` into a fused
multiply-add where the reference runs jitted (inside its layer scan): in
the scan's combine, in the fold of ``h0`` into the first step and in the
decode step (probed: the eager reference rounds the product apart, the
jitted one does not). The port takes every one of them through
``_FusedMulAdd``, whose forward is ``fma_f32``, so ``_lru_scan`` equals the
jitted reference bit for bit; its backward is the derivative of
``a * b + c`` (``fma_f32`` works on bit views, which carry no gradient).

Under a step that splits its products over ``model`` (``parallel.fsdp``)
where the act rules split the LRU width (``rglru_splits``), a rank
computes its own channels: ``y_gate`` and ``xi`` from its columns of
``w_y`` and ``w_x``, their depthwise conv, ``lam``, the scan and the
output gate, and ``w_out``'s rows end the segment as its partial sum.
The gates contract over every channel: a rank holds a block of
``w_a``'s and ``w_i``'s rows, takes the partial product of its channels
with them, and reduce-scatters it over the channel dim
(``fsdp.channel_scatter``), so it keeps the sums of its own channels;
nothing of ``w_a`` or ``w_i`` is gathered over ``model``. The scan and
its FMAs act per channel, so the split leaves them as they are. A
cache's ``h`` and ``conv`` split their channels as the step does and are
read and written as the rank's part (``kvcache.read_part`` /
``write_part``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig, RGLRUConfig
from repro_torch.core.fluctuate import _FusedMulAdd
from repro_torch.models.layers import causal_conv1d
from repro_torch.models.ssm import softplus
from repro_torch.parallel import fsdp, kvcache

_C = 8.0


def make_rglru(make, path: str, cfg: ModelConfig):
    c: RGLRUConfig = cfg.rglru
    d = cfg.d_model
    w = c.lru_width or d
    s = d ** -0.5
    return {
        "w_y": make(f"{path}.w_y", (d, w), ("embed", "mlp"), s),
        "w_x": make(f"{path}.w_x", (d, w), ("embed", "mlp"), s),
        "conv_w": make(f"{path}.conv_w", (c.conv_width, w), ("conv", "mlp"),
                       0.2),
        "w_a": make(f"{path}.w_a", (w, w), ("mlp", None), w ** -0.5),
        "w_i": make(f"{path}.w_i", (w, w), ("mlp", None), w ** -0.5),
        "lam": make(f"{path}.lam", (w,), ("mlp",), init="uniform_angle"),
        "w_out": make(f"{path}.w_out", (w, d), ("mlp", "embed"), w ** -0.5),
    }


def rglru_splits(cfg: ModelConfig) -> bool:
    """Whether the current step splits the LRU width's channels over its
    split axis (``fsdp.splits``, the step's act rules)."""
    return fsdp.splits("mlp", cfg.rglru.lru_width or cfg.d_model)


class RGLRUCache(NamedTuple):
    h: torch.Tensor      # (B, W) float32 recurrent state
    conv: torch.Tensor   # (B, K-1, W)


def init_rglru_cache(cfg: ModelConfig, batch: int, layers: int, dtype,
                     device) -> RGLRUCache:
    c = cfg.rglru
    w = c.lru_width or cfg.d_model
    return RGLRUCache(
        h=torch.zeros((layers, batch, w), dtype=torch.float32,
                      device=device),
        conv=torch.zeros((layers, batch, c.conv_width - 1, w), dtype=dtype,
                         device=device))


def _combine(x, y):
    """The scan's operator on (a, b) pairs, ``x`` the earlier:
    (a1 a2, a2 b1 + b2), the second an FMA."""
    a1, b1 = x
    a2, b2 = y
    return a1 * a2, _FusedMulAdd.apply(a2, b1, b2)


def _interleave(evens, odds):
    """evens[0], odds[0], evens[1], ... along dim 1 (``len(evens)`` is
    ``len(odds)`` or one more)."""
    n = evens.shape[1] + odds.shape[1]
    out = torch.empty((evens.shape[0], n) + tuple(evens.shape[2:]),
                      dtype=evens.dtype, device=evens.device)
    out[:, 0::2] = evens
    out[:, 1::2] = odds
    return out


def _associative_scan(elems):
    """``jax.lax.associative_scan(_combine, elems, axis=1)``: combine the
    adjacent pairs, scan the half recursively (the odd outputs), then fold
    each even element into the odd output before it."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = _combine([e[:, 0:n - 1:2] for e in elems],
                       [e[:, 1::2] for e in elems])
    odds = _associative_scan(reduced)
    if n % 2 == 0:
        evens = _combine([e[:, :-1] for e in odds],
                         [e[:, 2::2] for e in elems])
    else:
        evens = _combine(odds, [e[:, 2::2] for e in elems])
    evens = [torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, evens)]
    return [_interleave(e, o) for e, o in zip(evens, odds)]


def _lru_scan(a, b, h0=None):
    """h_t = a_t h_{t-1} + b_t via associative scan. a,b: (B,S,W)."""
    if h0 is not None:
        first = _FusedMulAdd.apply(a[:, 0], h0, b[:, 0])
        b = torch.cat([first[:, None], b[:, 1:]], dim=1)
    return _associative_scan([a, b])[1]


def apply_rglru(params, x, cfg: ModelConfig,
                cache: Optional[RGLRUCache] = None
                ) -> Tuple[torch.Tensor, Optional[RGLRUCache]]:
    """Griffin recurrent block. x (B,S,D) -> (B,S,D). With a cache: a
    prompt scans from the cached state, one token takes one step; the cache
    is written in place. Where the step splits the channels
    (``rglru_splits``), ``params`` are the rank's ``model`` blocks and the
    output is its partial sum (module docstring)."""
    bsz, s, d = x.shape
    split = rglru_splits(cfg)
    # jax.nn.gelu defaults to the tanh approximation
    y_gate = F.gelu(torch.matmul(x, params["w_y"].to(x.dtype)),
                    approximate="tanh")
    xi = torch.matmul(x, params["w_x"].to(x.dtype))
    # under a mesh a cache leaf is this rank's block: its split states are
    # gathered here and each rank writes back its block (parallel.kvcache)
    window = None
    if cache is not None:
        window = (kvcache.read_part(cache.conv, 2) if split
                  else kvcache.read(cache.conv))
    xi, new_conv = causal_conv1d(xi, params["conv_w"], window)

    xf = xi.float()
    if split:
        # both gates' partial sums over this rank's rows, one
        # reduce-scatter to this rank's channels
        w = params["w_a"].shape[1]
        gates = torch.matmul(xf, torch.cat([params["w_a"].float(),
                                            params["w_i"].float()], dim=1))
        gates = fsdp.channel_scatter(gates.unflatten(-1, (2, w)))
        r, i = torch.sigmoid(gates[..., 0, :]), torch.sigmoid(gates[..., 1, :])
    else:
        r = torch.sigmoid(torch.matmul(xf, params["w_a"].float()))
        i = torch.sigmoid(torch.matmul(xf, params["w_i"].float()))
    log_a = -_C * softplus(params["lam"].float()) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * xf)

    if cache is None:
        h = _lru_scan(a, gated)
        new_cache = None
    else:
        h0 = (kvcache.read_part(cache.h, 1) if split
              else kvcache.read(cache.h))
        if s == 1:
            h = _FusedMulAdd.apply(a[:, 0], h0, gated[:, 0])[:, None]
        else:
            h = _lru_scan(a, gated, h0)
        if split:
            kvcache.write_part(cache.h, h[:, -1], 1)
            kvcache.write_part(cache.conv, new_conv, 2)
        else:
            kvcache.write_block(cache.h, h[:, -1])
            kvcache.write_block(cache.conv, new_conv)
        new_cache = cache

    out = h.to(x.dtype) * y_gate
    out = torch.matmul(out, params["w_out"].to(x.dtype))
    return out, new_cache
