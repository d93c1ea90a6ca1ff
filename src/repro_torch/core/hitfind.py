"""Threshold-scan hit finding over deconvolved wires -> fixed-capacity HitSet.

Each wire's deconvolved waveform is walked in time, and every run of
consecutive above-threshold ticks becomes one hit: summed charge,
charge-weighted mean tick, peak sample. Sequential in time, parallel over
wires. Two strategies of the ``hit_find`` op, as in the reference:

  scan   : the plain run scanner below, vectorised over wires, one step per
           tick (the reference's ``vmap`` of a ``fori_loop``).
  pallas : the per-wire CUDA kernel (``repro_torch.kernels.hitfind``) on
           the card, the same plain scanner for CPU tensors. Both follow
           the reference's operation order, so they give the same bits.

The default is ``pallas`` on the card and ``scan`` elsewhere, so
``hitfind_strategy="auto"`` (the config default) runs the kernel on the
card unless the tuning cache holds another decision. Output contract
(``HitSet``): capacity ``cfg.max_hits``, mask-padded, wire-major
(ascending wire, then time); ``n_hits`` counts every run found, so
``n_hits > mask.sum()`` shows truncation.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.config import LArTPCConfig
from repro_torch.tune import autotune, registry
from repro_torch.tune.registry import register_strategy, set_default


class HitSet(NamedTuple):
    """Fixed-capacity, mask-padded hits of one readout plane.

    Leaves are (max_hits,); multi-plane outputs stack a leading plane axis.
    Padding rows have mask False and zeroed values.
    """

    wire: torch.Tensor    # int32 global wire index of the hit's wire
    tick: torch.Tensor    # float32 charge-weighted mean tick of the run
    charge: torch.Tensor  # float32 summed deconvolved charge (electrons)
    peak: torch.Tensor    # float32 max deconvolved sample in the run
    mask: torch.Tensor    # bool: True for real hits, False for padding
    n_hits: torch.Tensor  # () int32 total candidate runs found


# ---------------------------------------------------------------------------
# The plain per-wire run scanner, vectorised over wires
# ---------------------------------------------------------------------------


def _emit(fire, n, csum, tsum, pk, hq, ht, hp, cap: int):
    """Close the runs of the wires in ``fire``: write (charge, mean tick,
    peak) at slot ``n`` where there is room. ``n`` counts every fired run,
    stored or not, so per-wire truncation stays visible."""
    ok = fire & (n < cap)
    slot = torch.arange(cap, device=n.device)[None, :] == torch.clamp_max(
        n, cap - 1)[:, None]
    write = slot & ok[:, None]
    tick = tsum / torch.clamp_min(csum, 1e-30)
    hq = torch.where(write, csum[:, None], hq)
    ht = torch.where(write, tick[:, None], ht)
    hp = torch.where(write, pk[:, None], hp)
    return n + fire.to(torch.int32), hq, ht, hp


def wire_scan(decon: torch.Tensor, threshold: float, cap: int):
    """Scan every wire of a (W, T) grid for runs of samples > threshold.

    Returns (counts (W,) int32, charge, tick, peak (W, cap) float32):
    counts is the TOTAL number of runs per wire (may exceed ``cap``); the
    (W, cap) arrays hold the first ``cap`` runs in time order, zero past
    them. Every sum is one float32 product or add at a time, in tick order,
    as the reference's loop body computes them (no fused multiply-add).
    """
    w, t_len = decon.shape
    dev = decon.device
    vals = decon.to(torch.float32)
    thr = torch.tensor(threshold, dtype=torch.float32, device=dev)
    zero = torch.zeros((w,), dtype=torch.float32, device=dev)
    n = torch.zeros((w,), dtype=torch.int32, device=dev)
    active = torch.zeros((w,), dtype=torch.bool, device=dev)
    csum, tsum, pk = zero, zero, zero
    hq = torch.zeros((w, cap), dtype=torch.float32, device=dev)
    ht, hp = hq.clone(), hq.clone()
    for t in range(t_len):
        v = vals[:, t]
        above = v > thr
        # a run ends when the previous tick was in-run and this one is not
        n, hq, ht, hp = _emit(active & ~above, n, csum, tsum, pk, hq, ht, hp,
                              cap)
        vt = v * float(t)
        csum = torch.where(above, torch.where(active, csum + v, v), zero)
        tsum = torch.where(above, torch.where(active, tsum + vt, vt), zero)
        pk = torch.where(above, torch.where(active, torch.maximum(pk, v), v),
                         zero)
        active = above
    # flush a run still open at the readout edge
    n, hq, ht, hp = _emit(active, n, csum, tsum, pk, hq, ht, hp, cap)
    return n, hq, ht, hp


# ---------------------------------------------------------------------------
# Strategies: the registry's ``hit_find`` op. Each maps (decon (W, T), cfg)
# to per-wire candidates (counts (W,) int32, charge/tick/peak (W, cap)).
# ---------------------------------------------------------------------------


@register_strategy("hit_find", "scan",
                   note="plain run scanner, vectorised over wires",
                   differentiable=False)
def hit_find_scan(decon: torch.Tensor, cfg: LArTPCConfig):
    return wire_scan(decon, float(cfg.hit_threshold),
                     int(cfg.max_hits_per_wire))


def _pallas_viable(ctx) -> bool:
    # compiled on the card; elsewhere the wrapper runs the plain per-tick
    # scan, so cap it to smoke-scale grids (the bound of fused_pallas)
    if ctx.backend == "cuda":
        return True
    cells = ctx.shape.get("num_wires", 0) * ctx.shape.get("num_ticks", 0)
    return cells <= (1 << 21)


@register_strategy("hit_find", "pallas", available=_pallas_viable,
                   note="per-wire CUDA scan kernel (plain scan on the CPU)",
                   differentiable=False)
def hit_find_pallas(decon: torch.Tensor, cfg: LArTPCConfig):
    from repro_torch.kernels.hitfind.ops import find_wire_hits_pallas

    return find_wire_hits_pallas(decon, threshold=float(cfg.hit_threshold),
                                 cap=int(cfg.max_hits_per_wire))


set_default("hit_find", "scan")
set_default("hit_find", "pallas", backend="cuda")


# ---------------------------------------------------------------------------
# Compaction + dispatch
# ---------------------------------------------------------------------------


def compact_hits(counts: torch.Tensor, charge: torch.Tensor,
                 tick: torch.Tensor, peak: torch.Tensor, cfg: LArTPCConfig,
                 *, wire_offset: int = 0,
                 max_hits: Optional[int] = None) -> HitSet:
    """Flatten per-wire candidates into one wire-major HitSet.

    Stored hits keep (wire, time) order; candidates past the global
    ``max_hits`` capacity go to a dump slot that is dropped. ``n_hits`` sums
    the found counts, so truncation (per wire or global) shows as ``n_hits >
    mask.sum()``. ``wire_offset`` shifts the reported wire index.
    """
    w, cap = charge.shape
    dev = charge.device
    m = int(max_hits if max_hits is not None else cfg.max_hits)
    stored = torch.clamp_max(counts.to(torch.int64), cap)        # (W,)
    starts = torch.cumsum(stored, 0) - stored                    # exclusive
    j = torch.arange(cap, device=dev)[None, :]
    valid = j < stored[:, None]                                  # (W, cap)
    # invalid and overflow candidates both target the dump slot m; the
    # stored targets are distinct, so only the dump slot sees collisions
    tgt = torch.where(valid, torch.clamp_max(starts[:, None] + j, m),
                      m).reshape(-1)
    wires = (torch.arange(w, dtype=torch.int32, device=dev)
             + wire_offset)[:, None].expand(w, cap)

    def place(vals: torch.Tensor, dtype) -> torch.Tensor:
        out = torch.zeros((m + 1,), dtype=dtype, device=dev)
        out[tgt] = vals.reshape(-1).to(dtype)
        return out[:m]

    nstored = torch.zeros((m + 1,), dtype=torch.int32, device=dev)
    nstored.index_add_(0, tgt, valid.reshape(-1).to(torch.int32))  # torch-lint: disable=atomic-index-add — int32 counts: exact in any order
    return HitSet(
        wire=place(wires, torch.int32),
        tick=place(tick, torch.float32),
        charge=place(charge, torch.float32),
        peak=place(peak, torch.float32),
        mask=nstored[:m] > 0,
        n_hits=counts.sum().to(torch.int32),
    )


def find_hits(decon: torch.Tensor, cfg: LArTPCConfig,
              strategy: Optional[str] = None, *, wire_offset: int = 0,
              max_hits: Optional[int] = None) -> HitSet:
    """Threshold-scan one plane's deconvolved (W, T) grid into a HitSet.

    ``strategy`` None takes the default of the grid's device (``pallas`` on
    the card, ``scan`` on the CPU); ``"auto"`` the tuning cache's decision
    for the grid's shape and per-wire capacity on that device, else that
    default; any other name must be registered, and unknown names raise
    ``ValueError`` with the valid list.
    """
    if strategy is None:
        strategy = registry.default_strategy("hit_find", decon.device.type)
    elif strategy == "auto":
        shape = {"num_wires": int(decon.shape[0]),
                 "num_ticks": int(decon.shape[1]),
                 "max_hits_per_wire": cfg.max_hits_per_wire}
        strategy = autotune.resolve("hit_find", None, shape=shape,
                                    device=decon.device).strategy
    try:
        strat = registry.get_strategy("hit_find", strategy)
    except KeyError:
        valid = sorted(registry.strategies("hit_find")) + ["auto"]
        raise ValueError(f"unknown hit_find strategy {strategy!r}; valid: "
                         f"{valid}") from None
    counts, charge, tick, peak = strat.fn(decon, cfg)
    return compact_hits(counts, charge, tick, peak, cfg,
                        wire_offset=wire_offset, max_hits=max_hits)


def stack_hits(per_plane) -> HitSet:
    """Per-plane HitSets stacked leaf by leaf to (P, max_hits) (and (P,)
    for ``n_hits``)."""
    return HitSet(*(torch.stack(leaves) for leaves in zip(*per_plane)))


def hits_to_tuples(hits: HitSet) -> Tuple[Tuple[int, float, float], ...]:
    """Host-side view of the real hits as sorted (wire, tick, charge)
    tuples."""
    mask = hits.mask.cpu()
    rows = zip(hits.wire.cpu()[mask].tolist(), hits.tick.cpu()[mask].tolist(),
               hits.charge.cpu()[mask].tolist())
    return tuple(sorted(rows))
