"""The measured window: the simulator's streaming launcher, driven in
chunks, with the benchmark's own host clock around the calls it makes.

The window calls ``stream_simulate`` over chunks of ``chunk_batches``
batches, each chunk with a fresh seed drawn from the run's seed, until the
window's seconds are used; the chunk that crosses the end runs to its end
and counts, so the window holds whole chunks and all of their work. The
launcher gets the executor (``sim``) wrapped in a span and an ``on_batch``
callback, nothing else. A batch's latency runs from its entry into the
executor to the launcher's ``on_batch`` for it.

``on_batch`` also keeps a seeded reservoir sample of the window's events
(their ADC and hits, copied on the card) for the comparison after the
window.
"""
from __future__ import annotations

import hashlib
import random
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import torch

#: the benchmark's spans around the calls it makes (the traced run records
#: them): the executor, the launcher's callback, the launcher's whole call
DISPATCH = "simbench.dispatch"
ON_BATCH = "simbench.on_batch"
LAUNCHER = "simbench.launcher"


def chunk_seed(seed: int, chunk) -> int:
    """The 32-bit seed of window chunk ``chunk`` (an int, or a label such
    as ``"warmup"``) of the run seeded ``seed``."""
    digest = hashlib.sha256(f"simbench:{int(seed)}:{chunk}".encode())
    return int.from_bytes(digest.digest()[:4], "little")


@dataclass
class Sample:
    """One event of the window kept for the comparison."""

    chunk_seed: int
    event: int              # the event's id inside its chunk
    adc: torch.Tensor       # (P, W, T) int16, the program's
    hits: Optional[tuple]   # (wire, tick, charge, peak, mask, n_hits) or None


class Reservoir:
    """A uniform sample of ``size`` of the events offered, drawn from
    ``seed`` (algorithm R): the same seed and stream give the same
    sample."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = random.Random(f"simbench-sample:{seed}")
        self.items: List[Sample] = []
        self.seen = 0

    def wants(self) -> Optional[int]:
        """The slot the next event takes (None: it is not kept). Call once
        per event, in order."""
        i = self.seen
        self.seen += 1
        if i < self.size:
            return i
        j = self.rng.randint(0, i)
        return j if j < self.size else None

    def put(self, slot: int, item: Sample) -> None:
        if slot < len(self.items):
            self.items[slot] = item
        else:
            self.items.append(item)


@dataclass
class WindowStats:
    """The host clock's record of a window."""

    window_s: float = 0.0
    events: int = 0
    batches: int = 0
    chunks: int = 0
    retries: int = 0
    quarantined: int = 0
    dispatch_s: List[float] = field(default_factory=list)
    on_batch_s: List[float] = field(default_factory=list)
    latency_s: List[float] = field(default_factory=list)


class Streamer:
    """Runs chunks of the stream through the launcher with spans around
    the executor and the callback. ``span(name)`` returns a context
    manager entered around each call (the traced run records them)."""

    def __init__(self, cell, cfg, sim: Callable, device,
                 span: Optional[Callable] = None):
        from repro_torch.launch.sim import stream_simulate

        self.stream_simulate = stream_simulate
        self.cell = cell
        self.cfg = cfg
        self.sim = sim
        self.device = device
        self.span = span

    def _spanned(self, name):
        import contextlib

        return self.span(name) if self.span else contextlib.nullcontext()

    def chunk(self, seed: int, batches: int, stats: Optional[WindowStats],
              reservoir: Optional[Reservoir] = None) -> dict:
        """One ``stream_simulate`` call of ``batches`` batches seeded
        ``seed``; ``stats`` (when given) gains its spans."""
        e = self.cell.batch_events
        enters: List[float] = []

        def sim(keys, batch):
            with self._spanned(DISPATCH):
                t0 = time.perf_counter()
                out = self.sim(keys, batch)
                t1 = time.perf_counter()
            enters.append(t0)
            if stats is not None:
                stats.dispatch_s.append(t1 - t0)
            return out

        def on_batch(b, n_valid, n_depos, dt, out):
            with self._spanned(ON_BATCH):
                t0 = time.perf_counter()
                if reservoir is not None:
                    for r in range(n_valid):
                        slot = reservoir.wants()
                        if slot is not None:
                            hits = None if out.hits is None else tuple(
                                x[r].clone() for x in out.hits)
                            reservoir.put(slot, Sample(
                                seed, b * e + r, out.adc[r].clone(), hits))
                if stats is not None:
                    stats.latency_s.append(t0 - enters[b])
                    stats.events += n_valid
                    stats.batches += 1
                    stats.on_batch_s.append(time.perf_counter() - t0)

        with self._spanned(LAUNCHER):
            out = self.stream_simulate(
                self.cfg, batches * e, e, seed=seed, sim=sim,
                on_batch=on_batch, recon=self.cell.recon,
                device=self.device)
        if stats is not None:
            stats.chunks += 1
            stats.retries += out["health"]["retries"]
            stats.quarantined += out["health"]["quarantined"]
        return out

    def window(self, seed: int, seconds: float,
               reservoir: Optional[Reservoir] = None) -> WindowStats:
        """Whole chunks until ``seconds`` have passed; the clock stops once
        the card has finished the last one."""
        stats = WindowStats()
        batches = int(self.cell.traffic["chunk_batches"])
        sync()
        t0 = time.perf_counter()
        c = 0
        while True:
            self.chunk(chunk_seed(seed, c), batches, stats, reservoir)
            c += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync()
        stats.window_s = time.perf_counter() - t0
        return stats


def sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def build_program(cell, cfg, device):
    """The executor the launcher drives, built once: the batched executor
    that ``make_streaming_sim_fn`` wraps, taken from ``make_batched_sim_fn``
    so that the noise stage can be left out where the configuration leaves
    it out."""
    from repro_torch.core.batch import make_batched_sim_fn

    return make_batched_sim_fn(cfg, add_noise=cell.add_noise,
                               recon=cell.recon, device=device)
