"""Multi-event batching: pack E ragged events into one padded batch and run
them through the stage graph together.

  pack_events      : E ragged DepoSets -> one padded EventBatch (structure
                     of arrays; padding depos carry charge 0 and sigma 1,
                     so they rasterise to zero and add nothing)
  simulate_events  : the canonical ``SimGraph`` over all E events through
                     its batched executor (``SimGraph.run_batch``), with
                     per-event keys so events stay independent
  screen_events    : the ingest gate of the streaming launcher

The reference batches with ``jax.vmap``, which turns each ``pallas_call``
into one launch with an event axis. The port's counterpart: the fused
charge-grid kernels take every (event, plane) row of a batch in
ceil(rows / 16) launches on the plane axis they already have, and every
other stage runs one event, and within it one plane, at a time (a batched
``torch.fft.irfft2`` is not bit-identical to the one-plane call). So every
event of a batch equals the per-event run (``SimGraph.run``) on the same
padded row, bit for bit, the reference's own contract.

Padding sits at wire 0, tick 0; the tile binning counts as dropped only the
entries of a row's first ``n_depos[e]`` depos, so an empty or ragged row
does not read as an overflow.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch import spans
from repro_torch.config import LArTPCConfig
from repro_torch.core import prng
from repro_torch.core.depo import DepoSet
from repro_torch.core.drift import PhysicalDepoSet
from repro_torch.core.stages import SimGraph, SimOutput, build_sim_graph
from repro_torch.device import resolve_device
from repro_torch.tune.autotune import resolve_config


class EventBatch(NamedTuple):
    """Padded structure-of-arrays container for E events of <= N_max depos.

    wire/tick/sigma_w/sigma_t/charge : (E, N_max) float32 on the device;
    entries past ``n_depos[e]`` are padding (charge 0, sigma 1) that
    contributes nothing. Multi-plane events (``generate_plane_depos``)
    carry a plane axis between the event and depo axes: (E, P, N_max).
    n_depos : (E,) int32 on the HOST, the valid depo count per event (per
    plane): the packer's own counts, so reading them never waits for the
    card.
    """

    wire: torch.Tensor
    tick: torch.Tensor
    sigma_w: torch.Tensor
    sigma_t: torch.Tensor
    charge: torch.Tensor
    n_depos: torch.Tensor

    @property
    def num_events(self) -> int:
        return self.wire.shape[0]

    @property
    def max_depos(self) -> int:
        return self.wire.shape[-1]

    @property
    def total_depos(self) -> int:
        """Total number of valid (non-padding) depos across events."""
        return int(self.n_depos.sum())

    def depo_set(self) -> DepoSet:
        """View as a DepoSet of (E, N_max) leaves."""
        return DepoSet(self.wire, self.tick, self.sigma_w, self.sigma_t,
                       self.charge)

    def event(self, e: int) -> DepoSet:
        """The padded per-event row (keeps the padded length, so the
        per-event run on it reproduces the batched row bit for bit)."""
        return DepoSet(*(x[e] for x in self.depo_set()))


class PhysicalEventBatch(NamedTuple):
    """Padded structure-of-arrays container for E physical events (leaves
    (E, N_max) float32; padding carries q = 0, which drifts to a zero-charge
    depo and rasterises to nothing). n_depos as in ``EventBatch``."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    t: torch.Tensor
    q: torch.Tensor
    n_depos: torch.Tensor

    @property
    def num_events(self) -> int:
        return self.x.shape[0]

    @property
    def max_depos(self) -> int:
        return self.x.shape[-1]

    def physical_set(self) -> PhysicalDepoSet:
        """View as a PhysicalDepoSet of (E, N_max) leaves."""
        return PhysicalDepoSet(self.x, self.y, self.z, self.t, self.q)

    def event(self, e: int) -> PhysicalDepoSet:
        """The padded per-event row."""
        return PhysicalDepoSet(*(x[e] for x in self.physical_set()))


def _pad_target(events, pad_to: Optional[int], pad_multiple: int) -> int:
    if not events:
        raise ValueError("packing needs at least one event")
    n_max = max(max(ev.n for ev in events), 1)
    if pad_to is not None:
        n_max = max(n_max, pad_to)
    return -(-n_max // pad_multiple) * pad_multiple


def _counts(events) -> torch.Tensor:
    return torch.tensor([ev.n for ev in events], dtype=torch.int32)


def _pad_last(x: torch.Tensor, n_max: int, fill: float = 0.0):
    return F.pad(x, (0, n_max - x.shape[-1]), value=fill)


def pack_physical_events(events: Sequence[PhysicalDepoSet],
                         pad_to: Optional[int] = None,
                         pad_multiple: int = 1) -> PhysicalEventBatch:
    """Pack E ragged PhysicalDepoSets into one padded (E, N_max) batch, every
    leaf padded with 0 (a q = 0 depo at the frame origin is inert). The
    sampling strategies' draws still depend on the padded length, so runs
    compare bit for bit only at equal N_max."""
    n_max = _pad_target(events, pad_to, pad_multiple)
    stacked = [torch.stack([_pad_last(x, n_max) for x in xs])
               for xs in zip(*events)]
    return PhysicalEventBatch(*stacked, n_depos=_counts(events))


def empty_event(planes: int = 1, device="cuda") -> DepoSet:
    """A zero-depo event on ``device`` (pads the EVENT axis of a short
    batch); ``planes > 1`` shapes its leaves (planes, 0) so it stacks with
    multi-plane events."""
    shape = (0,) if planes == 1 else (planes, 0)
    z = torch.zeros(shape, dtype=torch.float32,
                    device=resolve_device(device))
    return DepoSet(z, z, z, z, z)


def pad_depos(depos: DepoSet, n_max: int) -> DepoSet:
    """Pad one event's depo axis (the LAST axis; a plane axis may lead it)
    to ``n_max`` with inert depos: charge 0 (an all-zero patch, fluctuation
    variance 0) at wire 0, tick 0, and sigma 1 (any positive width avoids
    0/0 in the Gaussian edges)."""
    if depos.n > n_max:
        raise ValueError(f"event has {depos.n} depos > pad target {n_max}")
    return DepoSet(wire=_pad_last(depos.wire, n_max),
                   tick=_pad_last(depos.tick, n_max),
                   sigma_w=_pad_last(depos.sigma_w, n_max, 1.0),
                   sigma_t=_pad_last(depos.sigma_t, n_max, 1.0),
                   charge=_pad_last(depos.charge, n_max))


def pack_events(events: Sequence[DepoSet], pad_to: Optional[int] = None,
                pad_multiple: int = 1) -> EventBatch:
    """Pack E ragged DepoSets (on one device) into one padded EventBatch.

    N_max = the largest event, at least ``pad_to``, rounded up to
    ``pad_multiple`` (a fixed ``pad_to`` across batches keeps every batch
    one shape, and its rows the same bits)."""
    n_max = _pad_target(events, pad_to, pad_multiple)
    padded = [pad_depos(ev, n_max) for ev in events]
    stacked = [torch.stack(xs) for xs in zip(*padded)]
    return EventBatch(*stacked, n_depos=_counts(events))


def _host_events(events) -> List:
    """Every event's leaves as numpy float32 arrays, copied to the host in
    ONE read for the lot (one wait for the card per batch, not one per
    leaf)."""
    leaves = [x for ev in events for x in ev]
    if not leaves:
        return []
    flat = torch.cat([x.detach().reshape(-1).to(torch.float32)
                      for x in leaves])
    with spans.wait("sim.validate.copy", reads=1):
        flat = flat.cpu().numpy()
    out, off = [], 0
    for ev in events:
        arrays = []
        for x in ev:
            arrays.append(flat[off:off + x.numel()].reshape(tuple(x.shape)))
            off += x.numel()
        out.append(type(ev)(*arrays))
    return out


def screen_events(events, ids: Sequence[int], cfg: LArTPCConfig, *,
                  pad_to: Optional[int] = None, batch: int = 0,
                  health=None):
    """Ingest validation gate: keep clean events, quarantine the rest.

    Runs ``repro_torch.core.validate.check_depos`` on every (event, id)
    pair (the events copied to the host in one read) and returns
    ``(kept_events, kept_ids, dead_letters)``. Kept events keep their ids,
    and hence their ``fold_in`` keys, so their ADCs are bit-identical to a
    run that never saw the quarantined events. ``pad_to`` enforces the
    padded capacity; ``health`` (a ``RunHealth``) collects the counters.
    """
    from repro_torch.core.validate import check_depos, dead_letter

    kept_events, kept_ids, letters = [], [], []
    for ev, depos, host in zip(ids, events, _host_events(events)):
        reasons = check_depos(host, cfg, max_depos=pad_to)
        if reasons:
            letters.append(dead_letter(ev, batch, reasons, depos))
        else:
            kept_events.append(depos)
            kept_ids.append(ev)
    if health is not None and letters:
        health.quarantined += len(letters)
        health.dead_letters.extend(letters)
    return kept_events, kept_ids, letters


def event_keys(key: torch.Tensor, event_ids: Sequence[int]) -> torch.Tensor:
    """Stacked per-event keys (E, 2), ``fold_in(key, ev)`` for each id: the
    per-event launcher's keys, bit for bit the reference's (host tensors,
    as ``prng`` makes every key)."""
    return torch.stack([prng.fold_in(key, int(ev)) for ev in event_ids])


def simulate_events(keys: torch.Tensor, batch: EventBatch, resp=None,
                    cfg: Optional[LArTPCConfig] = None,
                    add_noise: bool = True, recon: bool = False,
                    graph: Optional[SimGraph] = None,
                    device="cuda",
                    pool: Optional[torch.Tensor] = None) -> SimOutput:
    """The canonical ``SimGraph`` for all E events of ``batch`` through its
    batched executor. ``keys``: (E, 2), one key per event. Returns a
    ``SimOutput`` whose leaves carry a leading event axis: adc (E[, P], W,
    T), dropped and finite_ok (E,), HitSet leaves (E[, P], max_hits).
    Under ``rng_strategy="pool"`` every event takes the one ``pool`` (default:
    the graph's standard pool) from offset 0: a padded row keeps its valid
    depos first, so its fluctuations are the per-event run's."""
    if graph is None:
        if cfg is None:
            raise TypeError("simulate_events() needs cfg or graph")
        graph = build_sim_graph(cfg, resp, add_noise=add_noise,
                                device=device, recon=recon, pool=pool)
    rows = [batch.event(e) for e in range(batch.num_events)]
    return graph.run_batch(keys, rows, n_valid=batch.n_depos.tolist())


def make_batched_sim_fn(cfg: LArTPCConfig, resp=None, add_noise: bool = True,
                        device="cuda", recon: bool = False,
                        pool: Optional[torch.Tensor] = None):
    """``sim(keys, batch) -> SimOutput``: the batched executor over one
    ``SimGraph`` built once (responses and, with ``recon``, the
    deconvolution filters included), as ``make_sim_fn`` is the single-event
    one.

    ``"auto"`` strategy fields resolve here, from the tuning cache or the
    device's defaults, so one set of strategies serves the whole stream.
    The reference's ``donate=`` has no counterpart: torch frees a batch's
    device memory when its last reference goes, and the streaming launcher
    builds a fresh batch for every launch. ``pool``: as in
    ``simulate_events``."""
    cfg = resolve_config(cfg, device=device)
    graph = build_sim_graph(cfg, resp, add_noise=add_noise, device=device,
                            recon=recon, pool=pool)

    def sim(keys: torch.Tensor, batch: EventBatch) -> SimOutput:
        return simulate_events(keys, batch, graph=graph)

    return sim


def shard_events(batch: EventBatch, device="cuda", mesh=None) -> EventBatch:
    """Stage an EventBatch on ``device``: the whole batch without a mesh (a
    no-op where it already lies there); with one (``repro_torch.core.
    distributed``), this rank's contiguous block of the event axis, the
    axis first padded with ``empty_event`` rows (n_depos 0) so the shard
    count divides it. ``n_depos`` stays on the host."""
    dev = resolve_device(device)
    if mesh is None:
        return EventBatch(*(x.to(dev) for x in batch[:-1]),
                          n_depos=batch.n_depos)
    from repro_torch.core.distributed import flat_index, num_shards

    nshards = num_shards(mesh)
    per = -(-batch.num_events // nshards)
    lo = flat_index(mesh) * per
    planes = batch.wire.shape[1] if batch.wire.ndim == 3 else 1
    empty = pad_depos(empty_event(planes, batch.wire.device),
                      batch.max_depos)
    rows = [batch.event(e) if e < batch.num_events else empty
            for e in range(lo, lo + per)]
    counts = [batch.n_depos[e] if e < batch.num_events
              else torch.zeros_like(batch.n_depos[0])
              for e in range(lo, lo + per)]
    return EventBatch(*(torch.stack(xs).to(dev) for xs in zip(*rows)),
                      n_depos=torch.stack(counts))
