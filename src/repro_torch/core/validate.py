"""Ingest validation + run-health accounting for the streaming executors
(the port's own copy of the reference's ``repro.core.validate``).

A single poison event (NaN charge from a corrupt upstream file, a
million-depo "event" that blows the padded batch shape) must not kill a
million-event campaign. This module is the ingest gate of the
fault-tolerance layer:

  check_depos      : per-event sanity rules for detector-frame ``DepoSet``s
                     and physical-frame ``PhysicalDepoSet``s — finiteness,
                     charge sign, frame bounds, plane-axis consistency, and
                     (when asked) the padded-capacity ceiling. Returns the
                     list of violated rules, empty when the event is clean.
  dead_letter      : the quarantine record for one rejected event — enough
                     context (event id, batch, reasons, depo count) to
                     re-ingest or debug it offline instead of crashing.
  RunHealth        : the per-run counters (events_ok / quarantined / retries
                     / resumed / ...) every fault path increments; flows into
                     ``stream_simulate``'s stats dict and the launcher
                     summary line.
  SimBatchError    : the structured failure surfaced when a batch exhausts
                     its retry budget (or hits a non-retryable error) —
                     carries the batch id, attempt count, and the degraded
                     batch size at failure time.
  is_oom_error     : classifies an exception as OOM-class (retryable with
                     degradation) vs everything else (fail fast).

Validation runs on the HOST over event arrays copied there (torch tensors
through ``.cpu().numpy()``; ``repro_torch.core.batch.screen_events`` copies
a whole batch in one read) — it never enters the stage graph, so the
simulation is untouched (bit-identical ADCs; the device-side sibling is the
``cfg.check_finite`` sentinel in ``repro_torch.core.stages``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

#: out-of-frame margin, as a multiple of the readout extent: the rasterizer
#: clips patch origins to the grid, so mildly out-of-range coordinates (the
#: rotated-plane corner overhangs of a multi-plane projection) are harmless —
#: the bounds check only rejects values so far out they signal corruption
FRAME_MARGIN = 4.0


def _host(x) -> np.ndarray:
    """A leaf as a numpy array (a torch tensor copied to the host)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _finite_reasons(name: str, arr: np.ndarray) -> List[str]:
    bad = np.size(arr) - int(np.isfinite(arr).sum())
    if bad:
        return [f"nonfinite {name} ({bad} of {np.size(arr)} values)"]
    return []


def _bounds_reason(name: str, arr: np.ndarray, lo: float, hi: float
                   ) -> List[str]:
    finite = arr[np.isfinite(arr)]
    if finite.size and (float(finite.min()) < lo or float(finite.max()) > hi):
        return [f"{name} outside [{lo:g}, {hi:g}] "
                f"(range [{float(finite.min()):g}, {float(finite.max()):g}])"]
    return []


def check_physical_depos(pdepos, cfg, max_depos: Optional[int] = None
                         ) -> List[str]:
    """Validate one physical-frame event (``PhysicalDepoSet``).

    Rules: every leaf finite; charge ``q >= 0``; drift time ``x >= 0`` (a
    negative drift time is unphysical — the depo would sit behind the
    anode); arrival tick ``(t + x) / tick_us`` within ``FRAME_MARGIN``
    readout windows; optional depo-count ceiling ``max_depos``.
    """
    leaves = {f: _host(getattr(pdepos, f)) for f in pdepos._fields}
    reasons: List[str] = []
    reasons += _shape_reasons(leaves, num_planes=1)  # physical frame: no
    #                                                  plane axis yet
    for name, arr in leaves.items():
        reasons += _finite_reasons(name, arr)
    q, x = leaves["q"], leaves["x"]
    if np.any(np.isfinite(q) & (q < 0)):
        reasons.append(f"negative charge (min {float(np.nanmin(q)):g})")
    if np.any(np.isfinite(x) & (x < 0)):
        reasons.append(f"negative drift time (min {float(np.nanmin(x)):g})")
    window_us = cfg.num_ticks * cfg.tick_us
    arrival = leaves["t"] + x
    reasons += _bounds_reason("arrival time [us]", arrival,
                              -FRAME_MARGIN * window_us,
                              FRAME_MARGIN * window_us)
    if max_depos is not None and pdepos.n > max_depos:
        reasons.append(f"oversized: {pdepos.n} depos > capacity {max_depos}")
    return reasons


def check_detector_depos(depos, cfg, max_depos: Optional[int] = None
                         ) -> List[str]:
    """Validate one detector-frame event (``DepoSet``, drifted).

    Rules: every leaf finite; ``charge >= 0``; ``sigma_w``/``sigma_t`` > 0
    (a zero width divides the rasterizer's Gaussian edges); wire/tick within
    ``FRAME_MARGIN`` readout extents (generous on purpose — rotated-plane
    projections legitimately overhang the grid by a corner, and the
    rasterizer clips; only corruption-scale values reject); a leading plane
    axis exactly ``cfg.num_planes`` wide on multi-plane configs; optional
    depo-count ceiling ``max_depos`` (the padded batch capacity — an event
    bigger than the pad target would crash ``pack_events``).
    """
    leaves = {f: _host(getattr(depos, f)) for f in depos._fields}
    reasons = _shape_reasons(leaves, num_planes=cfg.num_planes)
    for name, arr in leaves.items():
        reasons += _finite_reasons(name, arr)
    q = leaves["charge"]
    if np.any(np.isfinite(q) & (q < 0)):
        reasons.append(f"negative charge (min {float(np.nanmin(q)):g})")
    for name in ("sigma_w", "sigma_t"):
        s = leaves[name]
        if np.any(np.isfinite(s) & (s <= 0)):
            reasons.append(f"non-positive {name} "
                           f"(min {float(np.nanmin(s)):g})")
    reasons += _bounds_reason("wire", leaves["wire"],
                              -FRAME_MARGIN * cfg.num_wires,
                              FRAME_MARGIN * cfg.num_wires)
    reasons += _bounds_reason("tick", leaves["tick"],
                              -FRAME_MARGIN * cfg.num_ticks,
                              FRAME_MARGIN * cfg.num_ticks)
    if max_depos is not None and depos.n > max_depos:
        reasons.append(f"oversized: {depos.n} depos > capacity {max_depos}")
    return reasons


def _shape_reasons(leaves: Dict[str, np.ndarray], num_planes: int
                   ) -> List[str]:
    shapes = {a.shape for a in leaves.values()}
    if len(shapes) != 1:
        return [f"inconsistent leaf shapes {sorted(map(str, shapes))}"]
    (shape,) = shapes
    if num_planes > 1:
        if len(shape) != 2:
            return [f"multi-plane event needs (P, N) leaves, got {shape}"]
        if shape[0] != num_planes:
            return [f"plane axis {shape[0]} != num_planes {num_planes}"]
    elif len(shape) != 1:
        return [f"single-plane event needs (N,) leaves, got {shape}"]
    return []


def check_depos(depos, cfg, max_depos: Optional[int] = None) -> List[str]:
    """Validate one event, dispatching on its frame (detector vs physical).

    Returns the (possibly empty) list of violated rules — the caller
    quarantines the event when it is non-empty.
    """
    from repro_torch.core.drift import PhysicalDepoSet

    if isinstance(depos, PhysicalDepoSet):
        return check_physical_depos(depos, cfg, max_depos=max_depos)
    return check_detector_depos(depos, cfg, max_depos=max_depos)


def dead_letter(event: int, batch: int, reasons: List[str], depos
                ) -> Dict[str, Any]:
    """The quarantine record for one rejected event (JSON-serializable)."""
    return {"event": int(event), "batch": int(batch),
            "reasons": list(reasons), "n_depos": int(depos.n)}


# ---------------------------------------------------------------------------
# Run health
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RunHealth:
    """Per-run fault-tolerance counters (``stream_simulate``'s scoreboard).

    events_ok        : events simulated successfully this run
    quarantined      : events dead-lettered by ingest validation
    retries          : batch dispatch retry attempts (OOM-class failures)
    halvings         : times the retry policy halved the batch event count
    resumed          : events skipped because the journal says their batch
                       already completed (``--resume``)
    nonfinite_events : events whose ``cfg.check_finite`` sentinel tripped
    callback_errors  : ``on_batch`` callback exceptions swallowed as warnings
    dead_letters     : the quarantine records behind ``quarantined``
    """

    events_ok: int = 0
    quarantined: int = 0
    retries: int = 0
    halvings: int = 0
    resumed: int = 0
    nonfinite_events: int = 0
    callback_errors: int = 0
    dead_letters: List[dict] = dataclasses.field(default_factory=list)

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def summary(self) -> str:
        parts = [f"ok={self.events_ok}", f"quarantined={self.quarantined}",
                 f"retries={self.retries}", f"resumed={self.resumed}"]
        for name in ("halvings", "nonfinite_events", "callback_errors"):
            if getattr(self, name):
                parts.append(f"{name}={getattr(self, name)}")
        return " ".join(parts)


# ---------------------------------------------------------------------------
# Failure classification
# ---------------------------------------------------------------------------


#: substrings that mark an exception as OOM-class (retryable by degrading
#: the batch size): torch's allocator raises ``torch.cuda.OutOfMemoryError``
#: ("CUDA out of memory"), the CUDA runtime's text for
#: cudaErrorMemoryAllocation is "out of memory" (the kernel wrappers carry
#: it, ``repro_torch.kernels.raise_on``), the injected faults say
#: RESOURCE_EXHAUSTED; the others cover phrasing variants
OOM_MARKERS = ("RESOURCE_EXHAUSTED", "RESOURCE EXHAUSTED", "OUT_OF_MEMORY",
               "out of memory", "Out of memory", "OutOfMemory")


def is_oom_error(exc: BaseException) -> bool:
    """True when ``exc`` looks like a device allocation failure — the only
    failure class the retry policy degrades the batch for (everything else
    fails fast: retrying a shape error or a poison NaN cannot succeed)."""
    msg = f"{type(exc).__name__}: {exc}"
    return any(marker in msg for marker in OOM_MARKERS)


class SimBatchError(RuntimeError):
    """A batch failed permanently: retries exhausted or non-retryable cause.

    Carries the structured context a campaign needs to recover — which batch,
    how many attempts, the degraded event count at failure time, and the
    underlying exception (also chained as ``__cause__``).
    """

    def __init__(self, batch: int, attempts: int, batch_events: int,
                 cause: BaseException):
        self.batch = batch
        self.attempts = attempts
        self.batch_events = batch_events
        self.cause = cause
        kind = "OOM-class" if is_oom_error(cause) else "non-retryable"
        super().__init__(
            f"batch {batch} failed permanently after {attempts} attempt(s) "
            f"at batch_events={batch_events} ({kind}): "
            f"{type(cause).__name__}: {cause}")
