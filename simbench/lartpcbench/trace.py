"""What a traced run reads besides the window: each stage's time on one
event, and the device's activity over one traced chunk.

``stage_times`` is the stage-by-stage timing method of the simulator's
stage graph, kept here so that it does not change with the program: each
stage run alone on the same input state, bracketed by CUDA events, one
warm-up and the median of three. ``profile_chunk`` runs one chunk of the
stream under ``torch.profiler`` with the benchmark's spans recorded, and
reduces the trace to the device's busy time over the traced window, the
kernels that took most of it and the longest idle gaps, each labelled by
the span the host was in when the gap began.
"""
from __future__ import annotations

import statistics
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

from lartpcbench.window import DISPATCH, LAUNCHER, ON_BATCH

#: the benchmark's spans, innermost first when they nest
SPANS = (DISPATCH, ON_BATCH, LAUNCHER)
WINDOW_SPAN = "simbench.traced_window"


def stage_times(graph, key, depos, iters: int = 3) -> Dict[str, float]:
    """{stage name: median seconds} of one event through ``graph``'s
    stages, each alone (CUDA events around each run)."""
    state = graph.init_state(key, depos)
    times: Dict[str, float] = {}
    for stage in graph.stages:
        out = stage(state)
        runs = []
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            stage(state)
            end.record()
            end.synchronize()
            runs.append(start.elapsed_time(end) / 1e3)
        times[stage.name] = statistics.median(runs)
        state = out
    return times


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
        else:
            merged.append((lo, hi))
    return merged


def reduce_events(events) -> dict:
    """Busy seconds, window seconds, top device ops and longest labelled
    idle gaps from kineto events (``name()``, ``device_type()``,
    ``start_ns()``, ``end_ns()``, ``is_user_annotation()``)."""
    from torch.autograd import DeviceType

    window = None
    spans: List[Tuple[int, int, str]] = []
    device: List[Tuple[int, int]] = []
    per_op: Dict[str, float] = defaultdict(float)
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if name == WINDOW_SPAN:
                window = (e.start_ns(), e.end_ns())
            elif name in SPANS:
                spans.append((e.start_ns(), e.end_ns(), name))
        elif e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            device.append((e.start_ns(), e.end_ns()))
            per_op[name] += (e.end_ns() - e.start_ns()) / 1e9
    if window is None or not device:
        return {}
    lo, hi = window
    busy = _union([(max(a, lo), min(b, hi)) for a, b in device
                   if b > lo and a < hi])
    busy_ns = sum(b - a for a, b in busy)
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    if busy:
        gaps = [(lo, busy[0][0])] + gaps + [(busy[-1][1], hi)]
    rank = {n: i for i, n in enumerate(SPANS)}

    def label(t: int) -> str:
        inside = [n for a, b, n in spans if a <= t < b]
        return min(inside, key=rank.get).split(".", 1)[1] if inside \
            else "outside the launcher"

    longest = sorted((g for g in gaps if g[1] > g[0]),
                     key=lambda g: g[0] - g[1])[:10]
    return {
        "busy_s": busy_ns / 1e9,
        "window_s": (hi - lo) / 1e9,
        "device_ops": sorted(([n, s] for n, s in per_op.items()),
                             key=lambda x: -x[1])[:10],
        "idle_gaps": [[label(a), (b - a) / 1e9] for a, b in longest],
    }


def profile_chunk(run_chunk: Callable[[], None]) -> dict:
    """Run ``run_chunk`` under the profiler (host and device activity)
    and reduce its trace (``reduce_events``); {} when the trace holds no
    device activity."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_SPAN):
            run_chunk()
            torch.cuda.synchronize()
    return reduce_events(prof.profiler.kineto_results.events())
