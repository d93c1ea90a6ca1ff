"""The program's spans and wait counters (``repro_torch.spans``) over one
cell, in one process:

    python3 simbench/split.py --workload <cell> --seeds 11,12 \
        --seconds 20 [--device cpu --smoke]

1. Windows of the cell with ``spans.enabled()`` off and on, in turns on
   the same seeds (off, on for the first seed, on, off for the next, ...):
   ``events_per_s`` of each, the cost of recording being the on windows'
   rate against the off ones'.
2. For each on window, the split: the launcher's spans (``sim.generate``,
   ``sim.validate`` with its copy, ``sim.pack``, ``sim.finish`` less
   ``sim.on_batch``) against ``launcher_host_ms``, and ``sim.dispatch``
   and its stage spans against ``dispatch_ms``, with the waits and the
   blocking reads a batch.
3. A chunk of 2 batches under ``analysis.census.Census``: the census's
   host reads of card tensors (``device_reads``) against the reads the
   waits count, and any read outside a wait span.
4. One chunk under ``torch.profiler``, as the traced run runs it: the
   span metrics' readings, and the device's idle gaps, each labelled by
   the innermost program span open when it began.

Between 2 and 3, the microseconds a span costs off and on.

One JSON line a step. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
import time

from run import set_environment


def window_line(stats, s, seed, on) -> dict:
    """One window's rate, and with spans on its split, ms a batch."""
    n = stats.batches
    out = {"step": "window", "seed": seed, "spans": on,
           "events": stats.events, "window_s": stats.window_s,
           "events_per_s": stats.events / stats.window_s,
           "launcher_host_ms": 1e3 * (stats.window_s - sum(stats.dispatch_s)
                                      - sum(stats.on_batch_s)) / n,
           "dispatch_ms": 1e3 * sum(stats.dispatch_s) / n}
    if s is None:
        return out
    sp = s["spans"]
    b = s["batches"]

    def tot(name, key="total_ms"):
        return sp.get(name, {}).get(key, 0.0) / b

    launcher = (tot("sim.generate") + tot("sim.validate") + tot("sim.pack")
                + tot("sim.finish") - tot("sim.on_batch"))
    stages = sum(v["total_ms"] for k, v in sp.items()
                 if k.startswith("sim.stage.")) / b
    out.update({
        "batches_recorded": b,
        "spans_a_batch": sum(v["calls"] for v in sp.values()) / b,
        "launcher_spans_ms": launcher,
        "launcher_spans_over_host": launcher / out["launcher_host_ms"],
        "dispatch_span_ms": tot("sim.dispatch"),
        "dispatch_span_over_dispatch": tot("sim.dispatch")
        / out["dispatch_ms"],
        "stages_over_dispatch_span": stages / tot("sim.dispatch"),
        "wait_ms": {k: v / b for k, v in s["wait_ms"].items()},
        "host_syncs": s["reads"] / b,
        "self_ms": {k: v["self_ms"] / b for k, v in sorted(sp.items())},
        "total_ms": {k: v["total_ms"] / b for k, v in sorted(sp.items())},
        "card_ms": {k: v / b for k, v in sorted(s["device_ms"].items())}})
    return out


def overhead_line(spans, device, n: int = 20000) -> dict:
    """Microseconds a ``with`` of a span: off, on (``spans.enabled()``,
    no profiler), a wait on, and a span with card events on; a bare
    ``with`` of the null context is subtracted."""
    import contextlib

    def per(make, calls=n):
        t0 = time.perf_counter()
        for _ in range(calls):
            with make():
                pass
        return 1e6 * (time.perf_counter() - t0) / calls

    base = per(contextlib.nullcontext)
    out = {"step": "overhead", "calls": n,
           "off_us": per(lambda: spans.span("sim.x", batch=1)) - base}
    spans.reset()
    with spans.enabled():
        out["on_us"] = per(lambda: spans.span("sim.x", batch=1)) - base
        out["wait_on_us"] = per(lambda: spans.wait("sim.x", reads=1)) - base
        if device.type == "cuda":
            out["card_on_us"] = per(lambda: spans.span(
                "sim.x", batch=1, device=device), n // 4) - base
    spans.reset()
    return out


def census_line(sess, seed, spans) -> dict:
    """Host reads of one chunk under the census, against the waits."""
    from repro_torch.analysis import census

    seen = []
    host = census.Census._host

    def watched(self, op, device_type):
        sp = spans.open_span()
        seen.append((census.site(), op, device_type,
                     None if sp is None else sp.name,
                     bool(sp is not None and sp.reads)))
        host(self, op, device_type)

    batches = 2
    census.Census._host = watched
    spans.reset()
    try:
        with spans.enabled(), census.Census() as c:
            sess.streamer.chunk(seed, batches, None)
    finally:
        census.Census._host = host
    dev = sess.device.type
    reads = c.device_reads(dev)
    outside = collections.Counter(
        f"{where} {op}" for where, op, d, _, in_wait in seen
        if d == dev and not in_wait)
    return {"step": "census", "device": dev, "batches": batches,
            "census_reads": sum(reads.values()) / batches,
            "census_reads_no_h2d": sum(
                1 for _, op, d, _, _ in seen
                if d == dev and op != "h2d") / batches,
            "wait_reads": spans.summary()["reads"] / batches,
            "by_site": {k: v / batches for k, v in sorted(reads.items())},
            "outside_waits": dict(outside)}


def traced_line(sess, seed, spans) -> dict:
    """One chunk under the profiler: the span metrics and the labelled
    idle gaps."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from lartpcbench import cells, metrics, trace

    batches = int(sess.cell.traffic["chunk_batches"])
    acts = [ProfilerActivity.CPU]
    cuda = sess.device.type == "cuda"
    if cuda:
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    spans.reset()
    with profile(activities=acts) as prof:
        with record_function(trace.WINDOW_SPAN):
            sess.streamer.chunk(seed, batches, None)
            if cuda:
                torch.cuda.synchronize()
    entries = [m for m in cells.load_benchmark()["per_layer"]
               if m["name"].split(".")[0] in ("wait_ms", "host_syncs",
                                              "launcher_ms", "span_ms")]
    values = {k: v["value"] for k, v in metrics.read_all(
        metrics.for_cell(entries, sess.cell.name), {}).items()}
    win, host, device = None, [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            if e.name() == trace.WINDOW_SPAN:
                win = (e.start_ns(), e.end_ns())
            elif e.name().startswith("sim."):
                host.append((e.start_ns(), e.end_ns(), e.name()))
        elif e.device_type() == DeviceType.CUDA \
                and not e.is_user_annotation():
            device.append((e.start_ns(), e.end_ns()))
    out = {"step": "traced", "metrics": values}
    if win is None or not device:
        return out
    lo, hi = win
    busy = trace._union([(max(a, lo), min(b, hi)) for a, b in device
                         if b > lo and a < hi])
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]

    def label(t):
        inside = [(a, n) for a, b, n in host if a <= t < b]
        return max(inside)[1] if inside else "outside the program's spans"

    by = collections.defaultdict(float)
    for a, b in gaps:
        by[label(a)] += (b - a) / 1e6
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    busy_s = sum(b - a for a, b in busy) / 1e9
    out.update({
        "window_s": (hi - lo) / 1e9, "busy_s": busy_s,
        "idle_share": 1 - busy_s / ((hi - lo) / 1e9),
        "idle_ms_by_span": dict(sorted(by.items(), key=lambda x: -x[1])),
        "longest_gaps": [[label(a), (b - a) / 1e6] for a, b in longest]})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds, one off and one on "
                         "window each")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)

    set_environment()
    import torch

    from lartpcbench import cells, session, window
    from repro_torch import spans

    torch.backends.cuda.matmul.allow_tf32 = False
    cell = cells.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    t0 = time.perf_counter()
    sess = session.Session(cell, args.device, smoke=args.smoke)
    sess.warm(seeds[0])
    head = {"step": "setup", "workload": cell.name,
            "seconds": time.perf_counter() - t0}
    if sess.device.type == "cuda":
        head["card"] = session.card()
    print(json.dumps(head), flush=True)
    for i, seed in enumerate(seeds):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            spans.reset()
            if on:
                with spans.enabled():
                    stats = sess.streamer.window(seed, args.seconds)
                s = spans.summary()
            else:
                stats, s = sess.streamer.window(seed, args.seconds), None
            print(json.dumps(window_line(stats, s, seed, on)), flush=True)
    print(json.dumps(overhead_line(spans, sess.device)), flush=True)
    print(json.dumps(census_line(
        sess, window.chunk_seed(seeds[0], "census"), spans)), flush=True)
    print(json.dumps(traced_line(
        sess, window.chunk_seed(seeds[0], "traced"), spans)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
