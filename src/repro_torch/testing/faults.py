"""Deterministic fault injection for the streaming fault-tolerance layer
(the port's own copy of the reference's ``repro.testing.faults``).

Every recovery path in ``stream_simulate`` (quarantine, retry with
degradation, fail-fast, journal resume) must be exercised, not just
written. This harness injects faults at the exact boundaries the
production code defends, keyed by event or batch id, so every run (tests,
``chip_smoke.py``, a manual ``--inject-faults``) reproduces the same
failure schedule:

  nan@EV       : event EV's depos get NaN charge + Inf position
                 (ingest validation must quarantine it)
  neg@EV       : event EV gets a negative charge value
  oversize@EV  : event EV's depo count doubles past the padded capacity
  oom@B[xN]    : dispatch of batch B raises an OOM-class error N times
                 (default 1) before succeeding (retry/degradation path)
  error@B      : dispatch of batch B raises a NON-retryable error
                 (fail-fast path: stream dies with SimBatchError)

The plan is plain data + tiny numpy edits; it never touches the stage
graph, so a run with an empty plan is byte-identical to a run with no plan.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, FrozenSet

import numpy as np
import torch


class InjectedOOM(RuntimeError):
    """Stands in for the runtime's allocation failure. The message carries
    RESOURCE_EXHAUSTED so ``repro_torch.core.validate.is_oom_error``
    classifies it like a real out-of-memory error."""


class InjectedDispatchError(RuntimeError):
    """A non-retryable dispatch failure (no OOM marker): the retry policy
    must fail fast instead of degrading."""


_SPEC_RE = re.compile(r"^(nan|neg|oversize|oom|error)@(\d+)(?:x(\d+))?$")


@dataclasses.dataclass
class FaultPlan:
    """A deterministic failure schedule, keyed by event id / batch id."""

    nan_events: FrozenSet[int] = frozenset()
    negative_events: FrozenSet[int] = frozenset()
    oversized_events: FrozenSet[int] = frozenset()
    #: batch id -> remaining injected OOM failures (mutates as they fire)
    oom_batches: Dict[int, int] = dataclasses.field(default_factory=dict)
    error_batches: FrozenSet[int] = frozenset()

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Parse a comma-separated fault spec, e.g.
        ``"nan@0,neg@3,oversize@2,oom@1,oom@4x2,error@5"``."""
        nan, neg, over, err = set(), set(), set(), set()
        oom: Dict[int, int] = {}
        for part in filter(None, (p.strip() for p in spec.split(","))):
            m = _SPEC_RE.match(part)
            if not m:
                raise ValueError(
                    f"bad fault spec {part!r}; expected kind@id with kind in "
                    "nan|neg|oversize|oom|error (oom accepts @BxN for N "
                    "failures)")
            kind, ident, count = m.group(1), int(m.group(2)), m.group(3)
            if count is not None and kind != "oom":
                raise ValueError(f"xN count only applies to oom, got {part!r}")
            if kind == "nan":
                nan.add(ident)
            elif kind == "neg":
                neg.add(ident)
            elif kind == "oversize":
                over.add(ident)
            elif kind == "error":
                err.add(ident)
            else:
                oom[ident] = oom.get(ident, 0) + (int(count) if count else 1)
        return cls(nan_events=frozenset(nan), negative_events=frozenset(neg),
                   oversized_events=frozenset(over), oom_batches=oom,
                   error_batches=frozenset(err))

    # -- ingest-side injection ---------------------------------------------

    def corrupt_event(self, ev: int, depos):
        """Return ``depos`` with this event's scheduled corruption applied
        (the same object when event ``ev`` has none), as float32 tensors on
        the depos' device. Works on detector-frame ``DepoSet``s and
        physical ``PhysicalDepoSet``s, with or without a leading plane
        axis."""
        if ev not in (self.nan_events | self.negative_events
                      | self.oversized_events):
            return depos
        device = depos[0].device
        leaves = {f: np.array(getattr(depos, f).detach().cpu().numpy())
                  for f in depos._fields}
        charge_field = "charge" if "charge" in leaves else "q"
        pos_field = "wire" if "wire" in leaves else "x"
        if ev in self.nan_events:
            q = leaves[charge_field].reshape(-1)
            q[ev % max(q.size, 1)] = np.nan
            p = leaves[pos_field].reshape(-1)
            p[ev % max(p.size, 1)] = np.inf
        if ev in self.negative_events:
            q = leaves[charge_field].reshape(-1)
            q[ev % max(q.size, 1)] = -1234.5
        if ev in self.oversized_events:
            # double the depo axis: past any pad_to <= the original count
            leaves = {f: np.concatenate([a, a], axis=-1)
                      for f, a in leaves.items()}
        return type(depos)(**{
            f: torch.from_numpy(np.asarray(a, np.float32)).to(device)
            for f, a in leaves.items()})

    # -- dispatch-side injection -------------------------------------------

    def before_dispatch(self, batch: int) -> None:
        """Raise this batch's scheduled dispatch fault, if any. Injected
        OOMs are count-limited (``oom@BxN``): each firing decrements the
        budget, so the retry path eventually succeeds, the shape of a
        transient allocation failure the policy degrades for."""
        if batch in self.error_batches:
            raise InjectedDispatchError(
                f"injected non-retryable dispatch failure on batch {batch}")
        remaining = self.oom_batches.get(batch, 0)
        if remaining > 0:
            self.oom_batches[batch] = remaining - 1
            raise InjectedOOM(
                f"RESOURCE_EXHAUSTED: injected device OOM on batch {batch} "
                f"({remaining - 1} more scheduled)")


def corrupt_tune_cache(path: str, mode: str = "truncate") -> None:
    """Corrupt an autotune cache file in place, the ways disks do:

    truncate : cut the file mid-JSON (torn write)
    garbage  : replace it with non-JSON bytes
    foreign  : valid JSON, but entries from some other tool or schema,
               which must be ignored per entry (the schema check), not
               crash the run
    """
    if mode == "truncate":
        with open(path, "rb") as f:
            data = f.read()
        with open(path, "wb") as f:
            f.write(data[: max(len(data) // 2, 1)])
    elif mode == "garbage":
        with open(path, "wb") as f:
            f.write(b"\x00\xffnot json at all{{{")
    elif mode == "foreign":
        import json

        foreign = {
            "some|other|tool|key": "just a string, not a record",
            "scatter_add|cpu|cpu|num_depos=256": {
                "strategy": "xla", "schema": "bogus-9000"},
        }
        with open(path, "w") as f:
            json.dump(foreign, f)
    else:
        raise ValueError(f"unknown corruption mode {mode!r}; "
                         "expected truncate|garbage|foreign")
