"""The program's own spans and wait counters (``repro_torch.spans``), as
the traced chunk recorded them: it runs under ``torch.profiler``, and the
program records its spans while a profiler records.

``summary()`` is the recorder's summary, or None where the program has no
span layer (an older checkout) or recorded no finished batch. ``per_batch``
divides a total by the batches recorded.
"""
from __future__ import annotations

from typing import Optional


def summary() -> Optional[dict]:
    try:
        from repro_torch import spans
    except ImportError:
        return None
    s = spans.summary()
    return s if s["batches"] else None


def per_batch(total_of) -> Optional[float]:
    """``total_of(summary)`` over the batches recorded; None where nothing
    was recorded or ``total_of`` finds nothing (returns None)."""
    s = summary()
    if s is None:
        return None
    total = total_of(s)
    return None if total is None else total / s["batches"]


def self_ms(name: str) -> Optional[float]:
    """Self ms a batch of the spans named ``name``."""
    return per_batch(lambda s: s["spans"].get(name, {}).get("self_ms"))


def card_ms(*names: str) -> Optional[float]:
    """Card ms a batch between the entry and exit events of the stage
    spans ``names`` (summed); None off the card."""
    def total(s):
        got = [s["device_ms"][n] for n in names if n in s["device_ms"]]
        return sum(got) if len(got) == len(names) else None

    return per_batch(total)
