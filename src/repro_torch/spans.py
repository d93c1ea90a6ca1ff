"""Spans and wait counters of the simulator's host layers, on the
profiler's clock.

    from repro_torch import spans

    with spans.span("sim.generate", batch=b):
        ...                                   # work the host does
    with spans.wait("sim.finish.flags", reads=1):
        flags = out.dropped.tolist()   # a host read that waits for the card

A span records only while a ``torch.profiler`` session records
(``torch.autograd._profiler_enabled()``) or inside ``with
spans.enabled():``. Otherwise ``span`` and ``wait`` return one shared null
context after a single check: no clock read, no allocation and no
``record_function``.

While on, each span:

* enters a ``torch.profiler.record_function`` of its name, the batch id in
  its args, when a profiler records, so it shows in any kineto trace;
* stamps its start and end with ``time.time_ns()``, the clock of kineto's
  events (the unix epoch, in ns), so that an idle gap in a device trace
  can be put down to the span the host was in;
* keeps, in ``RECORDER``: name, batch id, parent, start, end, self time
  (its time less its children's), the host reads a ``wait`` counts, and
  the outermost span open around it (``root``);
* given a CUDA ``device``, records a CUDA event at entry and at exit on
  the current stream. A pair is resolved to card milliseconds only once
  the card has passed both (``resolve``, which the launcher calls after
  each flags read, and ``summary``): it never waits for the card.

A span given no batch id takes its parent's, so the stages and waits
inside the executor carry the batch the launcher dispatched. The names
(``sim.*``) and the metrics that read them are listed in PERF.md §3.
The recorder belongs to one thread: the launcher's.
"""
from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
from torch.autograd import _profiler_enabled
from torch.autograd.profiler import record_function

#: the one context every call returns while nothing records
NULL = nullcontext()
#: the executor's span: a wait under it is the executor's, any other the
#: launcher's
DISPATCH = "sim.dispatch"
#: the span that finishes a batch: one a batch, whatever the retries
FINISH = "sim.finish"
#: the stage spans' prefix (``SimGraph.run_batch``)
STAGE = "sim.stage."
#: the key of the card time between batches in ``summary()["device_ms"]``
GAP = "launcher"

_clock = time.time_ns


def _always() -> bool:
    return True


#: the single check a span makes: the profiler's flag, or True inside
#: ``enabled()``
_check = _profiler_enabled


@dataclass
class Record:
    """One closed span."""

    name: str
    batch: Optional[int]
    parent: Optional[str]
    root: str
    start_ns: int
    end_ns: int
    self_ns: int
    reads: int = 0          # blocking host reads of card data (``wait``)
    wait: bool = False


class Recorder:
    """The closed spans of a process, and the card times of its device
    spans."""

    def __init__(self):
        self.records: List[Record] = []
        self.stack: List["_Span"] = []
        #: (batch, name, entry event, exit event) not yet resolved, in order
        self.pending: list = []
        #: card ms by span name, and between batches (``GAP``)
        self.device_ms: Dict[str, float] = {}
        self.device_calls: Dict[str, int] = {}
        self._last = None   # (batch, exit event) of the last resolved pair

    def reset(self) -> None:
        self.__init__()

    def resolve(self) -> None:
        """Turn the pending event pairs the card has passed into card ms,
        in order, stopping at the first it has not (``Event.query``, which
        does not wait). A pair that opens a new batch also gives the card
        time since the previous batch's last exit event (``GAP``)."""
        done = 0
        for batch, name, ev0, ev1 in self.pending:
            if not ev1.query():
                break
            if self._last is not None and self._last[0] != batch:
                self._add(GAP, self._last[1].elapsed_time(ev0))
            self._add(name, ev0.elapsed_time(ev1))
            self._last = (batch, ev1)
            done += 1
        del self.pending[:done]

    def _add(self, name: str, ms: float) -> None:
        self.device_ms[name] = self.device_ms.get(name, 0.0) + ms
        self.device_calls[name] = self.device_calls.get(name, 0) + 1

    def summary(self) -> dict:
        """Per-name totals: ``batches`` (``sim.finish`` spans), ``spans``
        {name: calls, total_ms, self_ms, reads, wait}, ``wait_ms``
        {"launcher", "executor"} (the executor's: waits under
        ``sim.dispatch``), ``reads`` (all waits' reads), and ``device_ms``
        / ``device_calls`` {name or ``GAP``: card ms, pairs}."""
        self.resolve()
        per: Dict[str, dict] = {}
        waits = {"launcher": 0.0, "executor": 0.0}
        reads = 0
        for r in self.records:
            s = per.setdefault(r.name, {"calls": 0, "total_ms": 0.0,
                                        "self_ms": 0.0, "reads": 0,
                                        "wait": r.wait})
            s["calls"] += 1
            s["total_ms"] += (r.end_ns - r.start_ns) / 1e6
            s["self_ms"] += r.self_ns / 1e6
            s["reads"] += r.reads
            if r.wait:
                side = "executor" if r.root == DISPATCH else "launcher"
                waits[side] += (r.end_ns - r.start_ns) / 1e6
                reads += r.reads
        return {"batches": per.get(FINISH, {}).get("calls", 0),
                "spans": per, "wait_ms": waits, "reads": reads,
                "device_ms": dict(self.device_ms),
                "device_calls": dict(self.device_calls)}


RECORDER = Recorder()


class _Span:
    __slots__ = ("name", "batch", "reads", "cuda", "rec", "parent", "rf",
                 "ev0", "start", "child")

    def __init__(self, name: str, batch, reads: int, cuda: bool):
        self.name = name
        self.batch = batch
        self.reads = reads
        self.cuda = cuda

    def __enter__(self):
        self.rec = rec = RECORDER
        self.parent = parent = rec.stack[-1] if rec.stack else None
        if self.batch is None and parent is not None:
            self.batch = parent.batch
        self.child = 0
        rec.stack.append(self)
        # the stamp before record_function's entry: kineto stamps early in
        # it, and its first entry in a session takes about a millisecond
        self.start = _clock()
        self.rf = None
        if _profiler_enabled():
            self.rf = record_function(
                self.name, None if self.batch is None
                else f"batch={self.batch}")
            self.rf.__enter__()
        self.ev0 = None
        if self.cuda:
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record()
        return self

    def __exit__(self, *exc):
        rec, parent = self.rec, self.parent
        if self.ev0 is not None:
            ev1 = torch.cuda.Event(enable_timing=True)
            ev1.record()
            rec.pending.append((self.batch, self.name, self.ev0, ev1))
        end = _clock()
        rec.stack.pop()
        took = end - self.start
        if parent is not None:
            parent.child += took
        root = rec.stack[0].name if rec.stack else self.name
        rec.records.append(Record(
            self.name, self.batch, None if parent is None else parent.name,
            root, self.start, end, took - self.child, self.reads,
            self.reads > 0))
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str, batch: Optional[int] = None, device=None):
    """A span of host work named ``name`` for batch ``batch`` (default:
    its parent's); ``device`` a CUDA ``torch.device`` adds the entry and
    exit events. The shared ``NULL`` while nothing records."""
    if not _check():
        return NULL
    return _Span(name, batch, 0,
                 device is not None and device.type == "cuda")


def wait(name: str, reads: int = 1):
    """A span around one statement whose ``reads`` host reads of card
    data block until the card has run all that is queued before them."""
    if not _check():
        return NULL
    return _Span(name, None, reads, False)


def resolve() -> None:
    """``RECORDER.resolve()`` while recording (nothing otherwise)."""
    if _check():
        RECORDER.resolve()


def summary() -> dict:
    return RECORDER.summary()


def reset() -> None:
    RECORDER.reset()


def open_span() -> Optional[_Span]:
    """The innermost open span (None: none open, or nothing records)."""
    return RECORDER.stack[-1] if RECORDER.stack else None


@contextmanager
def enabled():
    """Record inside the block without a profiler (spans emit no
    ``record_function`` then)."""
    global _check
    saved, _check = _check, _always
    try:
        yield RECORDER
    finally:
        _check = saved


def table(s: Optional[dict] = None) -> str:
    """The per-batch table of ``summary()``: a line a span name (calls,
    ms a batch in all and of its own, reads a batch), then the waits and
    the card's time a batch."""
    s = summary() if s is None else s
    n = max(s["batches"], 1)
    lines = [f"spans over {s['batches']} batches (ms a batch):",
             f"  {'span':<26} {'calls':>6} {'total':>9} {'self':>9} "
             f"{'reads':>6}"]
    for name in sorted(s["spans"]):
        v = s["spans"][name]
        lines.append(f"  {name:<26} {v['calls']:>6} {v['total_ms'] / n:9.3f}"
                     f" {v['self_ms'] / n:9.3f} {v['reads'] / n:6.2f}")
    lines.append(f"  waits: launcher {s['wait_ms']['launcher'] / n:.3f} ms,"
                 f" executor {s['wait_ms']['executor'] / n:.3f} ms, "
                 f"{s['reads'] / n:.2f} blocking reads a batch")
    if s["device_ms"]:
        lines.append("  card ms a batch: " + ", ".join(
            f"{k} {v / n:.3f}" for k, v in sorted(s["device_ms"].items())))
    return "\n".join(lines)
