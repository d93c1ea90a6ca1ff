"""One cell in one process: set-up, the measured window, the traced
readings and the comparison, as ``run.py`` and ``readings.py`` drive
them."""
from __future__ import annotations

import gc
import subprocess
import time
from typing import Callable, Dict, Optional

import torch

from lartpcbench import cells, check, counts, metrics, trace, window

#: top-level module names a run may not hold once the window has closed:
#: the JAX stack and the JAX package the simulator was ported from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules) -> list:
    """The loaded modules whose top-level name (before the first dot) is
    one of ``FORBIDDEN``, compared whole."""
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN)


class Session:
    """The cell's executor built once on ``device``, driven by the
    simulator's streaming launcher.

    ``executor(cell, ref_cfg, device)`` puts another executor in the
    program's place (the control); ``wrap(sim)`` breaks the program's
    (the faults); ``smoke`` runs the simulator's smoke sizes (CPU tests).
    """

    def __init__(self, cell: cells.Cell, device="cuda", smoke: bool = False,
                 executor: Optional[Callable] = None,
                 wrap: Optional[Callable] = None):
        self.cell = cell
        self.device = torch.device(device)
        self.cfg = cells.program_config(cell, smoke)
        self.ref_cfg = cells.reference_config(cell, smoke)
        if executor is not None:
            sim = executor(cell, self.ref_cfg, self.device)
        else:
            sim = window.build_program(cell, self.cfg, self.device)
        self.sim = wrap(sim) if wrap is not None else sim
        self.streamer = window.Streamer(cell, self.cfg, self.sim,
                                        self.device)

    def warm(self, seed: int) -> None:
        """One chunk of ``warmup_batches`` batches: every shape, kernel and
        transform plan the window uses, built before it."""
        self.streamer.chunk(window.chunk_seed(seed, "warmup"),
                            int(self.cell.traffic["warmup_batches"]), None)
        window.sync()

    def measure(self, seed: int, seconds: float,
                sample: Optional[int] = None):
        """The window and its seeded sample of events."""
        size = sample or int(self.cell.params["check_events"])
        res = window.Reservoir(size, seed)
        return self.streamer.window(seed, seconds, res), res

    def stage_times(self, seed: int) -> Dict[str, float]:
        """Each stage of one event of the cell alone, on the simulator's
        stage graph built as the executor builds it."""
        from repro_torch.core import prng
        from repro_torch.core.depo import generate_plane_depos
        from repro_torch.core.stages import build_sim_graph
        from repro_torch.tune.autotune import resolve_config

        cfg = resolve_config(self.cfg, device=self.device)
        graph = build_sim_graph(cfg, add_noise=self.cell.add_noise,
                                recon=self.cell.recon, device=self.device)
        key = prng.fold_in(prng.key(window.chunk_seed(seed, "stages")), 0)
        depos = generate_plane_depos(key, cfg, device=self.device)
        return trace.stage_times(graph, key, depos)

    def profile(self, seed: int) -> dict:
        """One chunk of the stream under the profiler, spans recorded."""
        from torch.profiler import record_function

        traced = window.Streamer(self.cell, self.cfg, self.sim,
                                 self.device, span=record_function)
        batches = int(self.cell.traffic["chunk_batches"])
        return trace.profile_chunk(lambda: traced.chunk(
            window.chunk_seed(seed, "traced"), batches, None))

    def release(self) -> None:
        """Drop the executor and the card's cached blocks (before the
        reference runs, so its memory does not read as the program's)."""
        self.sim = self.streamer = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def compare(self, samples) -> Dict[str, float]:
        return check.compare(self.cell, samples, self.ref_cfg, self.device)


def card() -> dict:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return {}
    return {"nvidia_smi": out}


def run(cell: cells.Cell, seed: int, seconds: float, traced: bool,
        t_start: float, device="cuda", smoke: bool = False,
        executor: Optional[Callable] = None,
        wrap: Optional[Callable] = None,
        sample: Optional[int] = None) -> dict:
    """One benchmark run of ``cell``: the result line's fields."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    session = Session(cell, dev, smoke, executor, wrap)
    session.warm(seed)
    setup_s = time.perf_counter() - t_start
    stats, res = session.measure(seed, seconds, sample)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    bench = cells.load_benchmark()
    ctx = {"window": stats, "setup_s": setup_s, "cell": cell,
           "cfg": session.ref_cfg,
           "counts": counts.stages(session.ref_cfg, cell.add_noise)}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    breakdown = None
    if traced:
        if cuda:
            ctx["trace"] = session.profile(seed)
            ctx["stages"] = session.stage_times(seed)
        tr = ctx.get("trace") or {}
        if tr:
            device_info["busy_s"] = tr["busy_s"]
            device_info["window_s"] = tr["window_s"]
            breakdown = {"device_ops": tr["device_ops"],
                         "idle_gaps": tr["idle_gaps"]}
        entries = bench["per_layer"]
    else:
        entries = bench["end_to_end"]
    values = metrics.read_all(metrics.for_cell(entries, cell.name), ctx)

    session.release()
    numbers = session.compare(res.items)
    limits = cell.limits
    correct = (check.verdict(numbers, limits) and stats.events > 0
               and len(res.items) > 0)
    result = {"correct": correct,
              "attempted": stats.events + stats.quarantined,
              "failed": stats.quarantined,
              "metrics": values, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    if cuda:
        result["card"] = card()
    result["window"] = {"seconds": stats.window_s, "events": stats.events,
                        "batches": stats.batches, "chunks": stats.chunks,
                        "retries": stats.retries,
                        "sampled": [[s.chunk_seed, s.event]
                                    for s in res.items]}
    result["checks"] = {k: {"value": numbers.get(k), "limit": limits.get(k)}
                        for k in sorted(set(numbers) | set(limits))}
    return result
