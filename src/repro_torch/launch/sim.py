"""LArTPC simulation launcher of the PyTorch/CUDA port:

    python -m repro_torch.launch.sim [--smoke] [--events N] [--batch-events E]
                                     [--depos N] [--planes P] [--seed S]
                                     [--recon] [--stage-board]
                                     [--journal PATH [--resume]]
                                     [--check-finite] [--no-validate]
                                     [--max-retries R] [--inject-faults SPEC]
                                     [--device cuda|cpu] [--tune] [--retune]
                                     [--strategy <scatter>]
                                     [--pipeline fig3|fig4]
                                     [--profile PATH]
                                     [--set key=value ...]

The launcher streams batches of E events (``--batch-events``, default 1)
through the batched executor of the stage graph (``repro_torch.core.batch``),
as the reference launcher does: while batch b runs, batch b-1 is finished
and reported. Event ``ev`` uses the key ``fold_in(key(seed), ev)`` and the
depos ``generate_depos`` draws from it (``generate_plane_depos`` for
multi-plane configs: ``--planes 3`` gives the MicroBooNE U, V and Y
planes); every batch is padded to ``cfg.num_depos`` depos and, when short,
with zero-depo events. ``--recon`` appends the deconvolve and hit_find
stages and reports hits stored and found. Prints one ``batch N: ...`` line
per batch, naming the dtype of the patches the charge grid rasterises
(``--set charge_grid_strategy=unfused_bf16``: bfloat16), one line per plane
of it, and a ``total:`` line. ``--stage-board`` first prints each stage's
time (``SimGraph.timed``), and per plane for multi-plane configs.

``--pipeline fig3`` runs the paper's per-depo host-loop baseline instead
(``repro_torch.core.pipeline.simulate_fig3``), one event at a time, and
prints one ``event N: D depos -> (W, T) ADC in ...`` line per event; it
takes none of ``--recon``, ``--journal``, ``--resume`` and
``--inject-faults``. ``--set rng_strategy=pool`` streams the pre-computed
normal pool through the unfused charge grid.

``--tune`` autotunes every registered hot op (drift, scatter-add, charge
grid, convolve, deconvolve, hit finding) on ``--device`` at the config's
shape, explicit fields included, and prints one ``tune[op]: ...`` line per
decision; decisions persist in the port's tuning cache
(``$REPRO_TORCH_TUNE_CACHE``, default
``~/.cache/repro-torch-tune/tune_cache.json``), so a repeated run reports
a cache hit; ``--retune`` re-measures. ``--strategy`` forces the
scatter-add strategy over both the config and the tuner. Without
``--tune``, ``"auto"`` fields resolve from the cache or the device's
defaults.

Fault tolerance, as in the reference: ingest validation quarantines bad
events (``--no-validate`` skips it), OOM-class failures retry with halved
batches (``--max-retries``), others fail fast, ``--journal`` records every
finished batch and ``--resume`` skips them, ``--check-finite`` turns on the
device-side finite sentinel, and ``--inject-faults`` schedules faults
(``repro_torch.testing.faults``). Runs on the card unless ``--device cpu``.

``--profile PATH`` streams under ``torch.profiler`` (host and, on the card,
device activity) and writes its Chrome trace to PATH: the program's spans
(``repro_torch.spans``: ``sim.generate``, ``sim.validate``, ``sim.pack``,
``sim.dispatch``, a ``sim.stage.<name>`` a stage, ``sim.finish``, and the
waits ``sim.validate.copy``, ``sim.bin.mask``, ``sim.finish.*``) beside the
card's kernels. The run ends with the spans' table: each span's calls, ms
a batch in all and of its own, and the blocking host reads a batch, then
the waits and the card's ms a batch by stage and between batches.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import time
import warnings
from typing import Callable, Optional

import torch

from repro_torch import spans
from repro_torch.config import (LArTPCConfig, apply_overrides, get_config,
                                plane_specs)
from repro_torch.core import prng
from repro_torch.core.batch import (empty_event, event_keys,
                                    make_batched_sim_fn, pack_events,
                                    screen_events)
from repro_torch.core.depo import (generate_depos, generate_physical_depos,
                                   generate_plane_depos)
from repro_torch.core.pipeline import make_sim_fn, simulate
from repro_torch.core.response import make_response
from repro_torch.core.stages import SimOutput, join_outputs
from repro_torch.core.validate import RunHealth, SimBatchError, is_oom_error
from repro_torch.device import resolve_device
from repro_torch.launch.journal import RunJournal, run_fingerprint
from repro_torch.tune import resolve_config, \
    resolve_config_with_decisions, strategies


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_events(cfg: LArTPCConfig, num_events: int, seed: int = 0,
               device="cuda", sim=None,
               on_event: Optional[Callable] = None) -> dict:
    """Simulate ``num_events`` events, one launch each (the per-event loop
    the streamed batches are held against).

    ``on_event(ev, out, seconds)`` sees every event's ``SimOutput``. Raises
    if the charge-grid binning dropped any (depo, tile) entry. Returns
    {"events", "depos", "wall_s", "event_s": [...]}; ``depos`` counts each
    event's depos once, whatever the number of planes; ``wall_s`` includes
    depo generation, ``event_s`` is the simulation alone (for multi-plane
    configs it includes the drift onto the planes).
    """
    dev = resolve_device(device)
    sim = sim if sim is not None else make_sim_fn(cfg, device=dev)
    generate = (generate_physical_depos if cfg.num_planes > 1
                else generate_depos)
    base = prng.key(seed)
    stats = {"events": 0, "depos": 0, "wall_s": 0.0, "event_s": []}
    t_start = time.perf_counter()
    for ev in range(num_events):
        k = prng.fold_in(base, ev)
        depos = generate(k, cfg, device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        out = sim(k, depos)
        _sync(dev)
        dt = time.perf_counter() - t0
        dropped = int(out.dropped) if out.dropped is not None else 0
        if dropped:
            raise RuntimeError(f"event {ev}: the tile binning dropped "
                               f"{dropped} (depo, tile) entries; raise k_max")
        stats["events"] += 1
        stats["depos"] += depos.n
        stats["event_s"].append(dt)
        if on_event is not None:
            on_event(ev, out, dt)
    stats["wall_s"] = time.perf_counter() - t_start
    return stats


def run_fig3(cfg: LArTPCConfig, num_events: int, seed: int = 0,
             device="cuda") -> None:
    """The per-depo host-loop baseline (paper Fig. 3): event ``ev`` with the
    launcher's key and depos through ``simulate`` (``cfg.pipeline`` is
    fig3), one line per event, as the reference prints it."""
    dev = resolve_device(device)
    resp = make_response(cfg, device=dev)
    base = prng.key(seed)
    for ev in range(num_events):
        k = prng.fold_in(base, ev)
        depos = generate_depos(k, cfg, device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        out = simulate(k, depos, cfg, resp=resp, device=dev)
        _sync(dev)
        dt = time.perf_counter() - t0
        print(f"event {ev}: {depos.n} depos -> {tuple(out.adc.shape)} ADC in "
              f"{dt*1e3:.0f} ms ({depos.n/dt:.3g} depos/s), "
              f"max dev {max_dev(out.adc, cfg)}")


def make_streaming_sim_fn(cfg: LArTPCConfig, recon: bool = False,
                          device="cuda"):
    """The program ``stream_simulate`` drives: ``make_batched_sim_fn``'s
    batched executor (the reference's donation policy has no counterpart:
    every launch gets a fresh batch, whose memory torch frees when the
    batch goes)."""
    return make_batched_sim_fn(cfg, device=device, recon=recon)


def stream_simulate(cfg: LArTPCConfig, num_events: int, batch_events: int = 1,
                    seed: int = 0, sim: Optional[Callable] = None,
                    pad_to: Optional[int] = None,
                    on_batch: Optional[Callable] = None,
                    recon: bool = False,
                    journal: Optional[str] = None, resume: bool = False,
                    validate: bool = True, max_retries: int = 3,
                    retry_backoff_s: float = 0.0,
                    faults=None, device="cuda") -> dict:
    """Pipelined streaming loop of the batched executor (the reference's
    ``stream_simulate``).

    Schedule per step b:
      1. generate, screen and pad batch b
      2. dispatch ``sim(keys, batch_b)`` (torch enqueues it on the card)
      3. finish batch b-1: wait for its CUDA event, check it, report it

    Every batch is padded to ``pad_to`` (default ``cfg.num_depos``) depos
    and, when short, with zero-depo events whose ids continue past
    ``num_events`` (the reference's padding ids), so every batch has the
    same (E, N_max) shape and each row the bits the per-event run gives it.
    Returns {"events", "depos", "wall_s", "batches": [...], "health"}.

    Fault tolerance:

    * ``validate`` screens every generated event (``check_depos``, one
      host copy per batch); invalid events are quarantined as dead
      letters, and survivors keep their ids and keys, so their ADCs are
      bit-identical to a clean run's. Clean input gives the same bits with
      validation on or off.
    * ``journal`` names an append-only JSONL journal of finished batches;
      ``resume`` skips the batches it records.
    * OOM-class failures (``is_oom_error``) retry up to ``max_retries``
      times, halving the batch's event count each attempt (bit-identical:
      rows are independent and ``pad_to`` is fixed); other failures, an
      exhausted budget, and a binning that dropped entries of a valid
      event raise ``SimBatchError`` naming the batch.
    * an ``on_batch(b, n_valid, n_depos, seconds, out)`` exception becomes
      a warning after the batch's stats are recorded.
    * ``faults`` (a ``repro_torch.testing.faults.FaultPlan``) injects
      corrupt events and dispatch failures; None injects nothing.

    Host reads per batch: the validation copy; the occupancy count of the
    compact layouts (one for all rows of a fused batch); the tile binning's
    masked writes, which wait for the card twice per (event, plane) row
    for the dense lists and four times for the compact ones; the finished
    batch's flags; with ``recon``, its count of stored hits; plus what
    ``on_batch`` and the journal read.

    Spans (``repro_torch.spans``; they record under ``torch.profiler`` or
    ``spans.enabled()``): ``sim.generate``, ``sim.validate`` (its copy a
    ``sim.validate.copy`` wait), ``sim.pack`` and ``sim.dispatch`` for
    batch b, then ``sim.finish`` for batch b-1, which holds the waits
    ``sim.finish.flags``, ``sim.finish.hits`` and ``sim.finish.journal``
    and the ``sim.on_batch`` callback; inside the executor, a
    ``sim.stage.<name>`` span a stage and ``sim.bin.mask`` waits.
    """
    if batch_events < 1:
        raise ValueError(f"batch_events must be >= 1, got {batch_events}")
    if num_events < 0:
        raise ValueError(f"num_events must be >= 0, got {num_events}")
    if resume and journal is None:
        raise ValueError("resume=True needs a journal path")
    dev = resolve_device(device)
    if sim is None:
        sim = make_streaming_sim_fn(cfg, recon=recon, device=dev)
    key = prng.key(seed)
    num_batches = -(-num_events // batch_events)
    pad_to = pad_to if pad_to is not None else cfg.num_depos
    health = RunHealth()

    jrn = None
    if journal is not None:
        fp = run_fingerprint(cfg, seed=seed, batch_events=batch_events,
                             pad_to=pad_to, num_events=num_events,
                             recon=recon)
        jrn = RunJournal(journal, fingerprint=fp, resume=resume)

    # multi-plane configs stream per-plane pre-drifted events (a leading
    # plane axis on every leaf), as the reference's stream does
    gen = generate_plane_depos if cfg.num_planes > 1 else generate_depos

    def make_batch(b: int):
        """Generate, fault-corrupt, screen and pad batch b: (rows, row ids,
        kept count). Kept events keep their ids (and keys); padding ids
        continue past ``num_events``."""
        ids = list(range(b * batch_events,
                         min((b + 1) * batch_events, num_events)))
        with spans.span("sim.generate", batch=b):
            events = [gen(prng.fold_in(key, ev), cfg, device=dev)
                      for ev in ids]
        if faults is not None:
            events = [faults.corrupt_event(ev, d)
                      for ev, d in zip(ids, events)]
        if validate:
            with spans.span("sim.validate", batch=b):
                events, ids, _ = screen_events(events, ids, cfg,
                                               pad_to=pad_to, batch=b,
                                               health=health)
        with spans.span("sim.pack", batch=b):
            n_valid = len(ids)
            pad = [empty_event(planes=cfg.num_planes, device=dev)]
            rows = events + pad * (batch_events - n_valid)
            row_ids = ids + list(range(
                num_events + b * batch_events,
                num_events + b * batch_events + batch_events - n_valid))
        return rows, row_ids, n_valid

    def launch_rows(b: int, rows, row_ids) -> SimOutput:
        """One dispatch over the given event rows (fresh keys and a fresh
        packed batch every time)."""
        if faults is not None:
            faults.before_dispatch(b)
        with spans.span("sim.pack", batch=b):
            keys = event_keys(key, row_ids)
            batch = pack_events(rows, pad_to=pad_to)
        with spans.span(spans.DISPATCH, batch=b):
            return sim(keys, batch)

    def run_degraded(b: int, rows, row_ids, first_exc: BaseException):
        """Bounded retry with degradation: halve the event count per
        OOM-class attempt and run the sub-batches one after another; rows
        are independent and ``pad_to`` is fixed, so the results are the
        unhalved launch's bits. Non-retryable causes and an exhausted
        budget raise ``SimBatchError``."""
        exc, sub, attempts = first_exc, len(rows), 0
        while True:
            if not is_oom_error(exc):
                raise SimBatchError(b, attempts + 1, sub, exc) from exc
            attempts += 1
            if attempts > max_retries:
                raise SimBatchError(b, attempts, sub, exc) from exc
            health.retries += 1
            if sub > 1:
                sub = -(-sub // 2)
                health.halvings += 1
            if retry_backoff_s:
                time.sleep(retry_backoff_s * attempts)
            try:
                outs = []
                for s in range(0, len(rows), sub):
                    outs.append(launch_rows(b, rows[s:s + sub],
                                            row_ids[s:s + sub]))
                    _sync(dev)
                return join_outputs(outs, torch.cat)
            except Exception as e:  # noqa: BLE001 — classified above
                exc = e

    stats = {"events": 0, "depos": 0, "wall_s": 0.0, "batches": []}
    t_start = time.perf_counter()
    inflight = None

    def read_flags(out: SimOutput):
        """The batch's per-event ``dropped`` and ``finite_ok`` on the host
        (None where the output has none): the batch's wait for the card.
        The card has then passed the batch's stage events: they resolve."""
        flags = (out.dropped, out.finite_ok)
        with spans.wait("sim.finish.flags", reads=(out.dropped is not None)
                        + (out.finite_ok is not None)):
            flags = tuple(None if x is None else x.tolist() for x in flags)
        spans.resolve()
        return flags

    def finish(entry):
        with spans.span(spans.FINISH, batch=entry[0]):
            _finish(*entry)

    def _finish(b, rows, row_ids, n_valid, n_depos, t0, out):
        try:
            dropped, finite = read_flags(out)
        except Exception as e:  # noqa: BLE001 — run_degraded classifies
            out = run_degraded(b, rows, row_ids, e)
            dropped, finite = read_flags(out)
        dt = time.perf_counter() - t0
        if dropped is not None:
            for ev, lost in zip(row_ids[:n_valid], dropped[:n_valid]):
                if lost:
                    raise SimBatchError(b, 1, len(rows), RuntimeError(
                        f"event {ev}: the tile binning dropped {lost} "
                        "(depo, tile) entries; raise k_max"))
        # record the batch BEFORE the user callback runs: a callback
        # exception must not lose the batch's stats or journal entry
        health.events_ok += n_valid
        stats["events"] += n_valid
        stats["depos"] += n_depos
        rec = {"batch": b, "events": n_valid, "depos": n_depos, "wall_s": dt}
        if finite is not None:
            bad = sum(not ok for ok in finite[:n_valid])
            rec["nonfinite"] = bad
            health.nonfinite_events += bad
        if recon and out.hits is not None:
            stored = out.hits.mask[:n_valid].sum()
            with spans.wait("sim.finish.hits", reads=1):
                rec["hits"] = int(stored)
        if jrn is not None:
            adc = out.adc[:n_valid].contiguous()
            with spans.wait("sim.finish.journal", reads=1):
                adc = adc.cpu().numpy()
            jrec = dict(rec, ids=[int(i) for i in row_ids[:n_valid]],
                        adc_sha=hashlib.sha256(adc.tobytes()).hexdigest(),
                        quarantined=sum(
                            1 for d in health.dead_letters
                            if d["batch"] == b))
            jrec.pop("wall_s")
            jrn.append_batch(jrec)
        stats["batches"].append(rec)
        if on_batch is not None:
            try:
                with spans.span("sim.on_batch", batch=b):
                    on_batch(b, n_valid, n_depos, dt, out)
            except Exception as e:  # noqa: BLE001 — user code, not ours
                health.callback_errors += 1
                warnings.warn(
                    f"on_batch callback failed for batch {b} "
                    f"(stats already recorded): {type(e).__name__}: {e}",
                    RuntimeWarning, stacklevel=2)

    try:
        for b in range(num_batches):
            if jrn is not None and b in jrn.completed:
                done = jrn.completed[b]
                health.resumed += int(done.get("events", 0))
                stats["events"] += int(done.get("events", 0))
                stats["depos"] += int(done.get("depos", 0))
                stats["batches"].append({
                    "batch": b, "events": int(done.get("events", 0)),
                    "depos": int(done.get("depos", 0)), "wall_s": 0.0,
                    "resumed": True})
                continue
            rows, row_ids, n_valid = make_batch(b)
            n_depos = sum(int(d.n) for d in rows[:n_valid])
            t0 = time.perf_counter()
            try:
                try:
                    out = launch_rows(b, rows, row_ids)
                except Exception as e:  # noqa: BLE001 — classified below
                    out = run_degraded(b, rows, row_ids, e)
            except SimBatchError:
                # batch b is lost, but b-1 already ran: record (and
                # journal) it first, so a resumed run redoes only batch b
                if inflight is not None:
                    finish(inflight)
                    inflight = None
                raise
            if inflight is not None:
                finish(inflight)
            inflight = (b, rows, row_ids, n_valid, n_depos, t0, out)
        if inflight is not None:
            finish(inflight)
    finally:
        if jrn is not None:
            jrn.close()
    stats["wall_s"] = time.perf_counter() - t_start
    stats["health"] = health.as_dict()
    return stats


def patch_dtype_name(cfg: LArTPCConfig) -> str:
    """The dtype of the patches the config's charge-grid strategy
    rasterises: bfloat16 for ``unfused_bf16``, float32 for the fused
    kernels (which ignore ``patch_dtype``), else ``cfg.patch_dtype``."""
    name = cfg.charge_grid_strategy
    if name == "unfused_bf16":
        return "bfloat16"
    return "float32" if name.startswith("fused") else cfg.patch_dtype


def max_dev(adc: torch.Tensor, cfg: LArTPCConfig) -> int:
    """Largest |ADC - baseline| of an event (or of a batch's events)."""
    return int((adc.to(torch.int32) - int(cfg.adc_baseline)).abs().max())


def hit_counts(hits, plane: Optional[int] = None):
    """(stored, found) hits of a HitSet: of one plane of a multi-plane
    HitSet, or summed over its planes."""
    mask, found = hits.mask, hits.n_hits
    if plane is not None:
        mask, found = mask[plane], found[plane]
    return int(mask.sum()), int(found.sum())


def hit_text(hits, plane: Optional[int] = None) -> str:
    """``", S hits stored, F found"`` for a recon output, else ``""``."""
    if hits is None:
        return ""
    stored, found = hit_counts(hits, plane)
    return f", {stored} hits stored, {found} found"


def stage_board(cfg: LArTPCConfig, recon: bool, seed: int, device) -> None:
    """Print each stage's time (``SimGraph.timed``) on one event, and for a
    multi-plane config each plane's (the graph restricted to that plane;
    a multi-plane charge-grid strategy takes all planes in one launch, so
    its per-plane rows are not printed). ``"auto"`` fields resolve through
    the tuning cache first."""
    from repro_torch.core.stages import MULTIPLANE_CHARGE_GRID, \
        build_sim_graph

    cfg = resolve_config(cfg, device=device)
    key = prng.key(seed)
    pdepos = generate_physical_depos(key, cfg, device=device)
    _, timings = build_sim_graph(cfg, recon=recon, device=device).timed(
        key, pdepos)
    total = sum(timings.values())
    for name, sec in timings.items():
        print(f"stage {name:<12} {sec * 1e3:8.2f} ms "
              f"({100 * sec / total:5.1f}%)")
    if cfg.num_planes == 1:
        return
    if cfg.charge_grid_strategy in MULTIPLANE_CHARGE_GRID:
        print(f"stage planes: {cfg.charge_grid_strategy} runs every plane "
              "in one launch; no per-plane rows")
        return
    for p in range(cfg.num_planes):
        _, pt = build_sim_graph(cfg, planes=(p,), recon=recon,
                                device=device).timed(key, pdepos)
        for name, sec in pt.items():
            print(f"stage plane{p}/{name:<10} {sec * 1e3:8.2f} ms "
                  f"({100 * sec / total:5.1f}%)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--events", type=int, default=2)
    ap.add_argument("--batch-events", type=int, default=1,
                    help="events per batch (the batched executor's E)")
    ap.add_argument("--depos", type=int, default=0)
    ap.add_argument("--planes", type=int, default=0,
                    help="readout planes per event (3: U, V, Y)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--recon", action="store_true",
                    help="append the deconvolve + hit_find recon stages")
    ap.add_argument("--stage-board", action="store_true",
                    help="print per-stage times (and per plane) before "
                         "streaming")
    ap.add_argument("--journal", default=None, metavar="PATH",
                    help="append-only JSONL batch journal for this run; "
                         "enables --resume")
    ap.add_argument("--resume", action="store_true",
                    help="skip batches the --journal records as complete")
    ap.add_argument("--check-finite", action="store_true",
                    help="turn on the per-event finite sentinel of every "
                         "float stage (device-side; off by default)")
    ap.add_argument("--no-validate", action="store_true",
                    help="skip ingest validation / quarantine")
    ap.add_argument("--max-retries", type=int, default=3,
                    help="OOM-class retries per batch, halving its event "
                         "count each attempt")
    ap.add_argument("--inject-faults", default=None, metavar="SPEC",
                    help="deterministic fault schedule, e.g. "
                         "'nan@0,oversize@2,oom@1x2,error@3'")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no silent fallback")
    ap.add_argument("--tune", action="store_true",
                    help="autotune kernel strategies for this config on "
                         "--device (cached; repeated runs report a cache "
                         "hit)")
    ap.add_argument("--retune", action="store_true",
                    help="with --tune: ignore the cache and re-measure")
    ap.add_argument("--strategy", default=None,
                    help="force the scatter-add strategy (see "
                         "repro_torch.tune; 'auto' resolves via the tuning "
                         "cache)")
    ap.add_argument("--pipeline", choices=["fig3", "fig4"], default=None)
    ap.add_argument("--profile", default=None, metavar="PATH",
                    help="stream under torch.profiler, write its Chrome "
                         "trace to PATH and print the spans' table")
    ap.add_argument("--set", nargs="*", default=[])
    args = ap.parse_args(argv)

    if args.resume and not args.journal:
        raise SystemExit("--resume needs --journal PATH")

    cfg = get_config("lartpc-uboone", smoke=args.smoke)
    if args.depos:
        cfg = apply_overrides(cfg, {"num_depos": args.depos})
    if args.planes:
        cfg = apply_overrides(cfg, {"num_planes": args.planes})
    if args.pipeline:
        cfg = apply_overrides(cfg, {"pipeline": args.pipeline})
    if args.check_finite:
        cfg = apply_overrides(cfg, {"check_finite": True})
    if args.set:
        cfg = apply_overrides(cfg, dict(kv.split("=", 1) for kv in args.set))

    device = resolve_device(args.device)
    if args.tune:
        cfg, decisions = resolve_config_with_decisions(
            cfg, tune=True, force=args.retune, tune_explicit=True,
            device=device)
        for d in decisions:
            print(d.describe())
    if args.strategy:
        known = sorted(strategies("scatter_add")) + ["auto"]
        if args.strategy not in known:
            raise SystemExit(f"unknown --strategy {args.strategy!r}; "
                             f"known: {known}")
        cfg = apply_overrides(cfg, {"scatter_strategy": args.strategy})

    if args.stage_board:
        stage_board(cfg, args.recon, args.seed, device)

    faults = None
    if args.inject_faults:
        from repro_torch.testing.faults import FaultPlan

        faults = FaultPlan.parse(args.inject_faults)

    if cfg.pipeline == "fig3":
        if args.recon:
            raise SystemExit("--recon needs the batched fig4 pipeline "
                             "(drop --pipeline fig3)")
        for flag in ("journal", "resume", "inject_faults", "profile"):
            if getattr(args, flag):
                raise SystemExit(f"--{flag.replace('_', '-')} needs the "
                                 "batched fig4 pipeline (drop "
                                 "--pipeline fig3)")
        run_fig3(cfg, args.events, args.seed, device)
        return

    patches = patch_dtype_name(resolve_config(cfg, device=device))

    def report(b, n_valid, n_depos, dt, out):
        if n_valid == 0:
            print(f"batch {b}: 0 events (all quarantined or padding) in "
                  f"{dt*1e3:.0f} ms")
            return
        adc = out.adc[:n_valid]
        hits = (None if out.hits is None
                else type(out.hits)(*(x[:n_valid] for x in out.hits)))
        extra = ""
        if out.finite_ok is not None:
            bad = int((~out.finite_ok[:n_valid]).sum())
            if bad:
                extra = f", {bad} NON-FINITE"
        head = f"batch {b}: {n_valid} events / {n_depos} depos"
        rate = f"{n_depos/dt:.3g} depos/s"
        if cfg.num_planes > 1:
            head += f" x {cfg.num_planes} planes"
            rate = f"{n_depos * cfg.num_planes / dt:.3g} plane-depos/s"
        print(f"{head} -> {tuple(out.adc.shape)} ADC in {dt*1e3:.0f} ms "
              f"({rate}), max dev {max_dev(adc, cfg)}, patches {patches}"
              f"{extra}{hit_text(hits)}")
        if cfg.num_planes == 1:
            return
        for spec in plane_specs(cfg):
            p = spec.index
            plane_hits = (None if hits is None
                          else type(hits)(*(x[:, p] for x in hits)))
            print(f"batch {b} plane {p} ({spec.kind}, {spec.angle_deg:g} "
                  f"deg): max dev {max_dev(adc[:, p], cfg)}"
                  f"{hit_text(plane_hits)}")

    profiler = contextlib.nullcontext()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        profiler = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else []))
        spans.reset()
    try:
        with profiler:
            stats = stream_simulate(cfg, args.events, args.batch_events,
                                    seed=args.seed, on_batch=report,
                                    recon=args.recon, journal=args.journal,
                                    resume=args.resume,
                                    validate=not args.no_validate,
                                    max_retries=args.max_retries,
                                    faults=faults, device=device)
    except SimBatchError as e:
        raise SystemExit(
            f"stream failed: {e}" + ("" if not args.journal else
                                     f" — rerun with --resume to continue "
                                     f"from the journal at {args.journal}"))
    ev_s = stats["events"] / stats["wall_s"]
    dp_s = stats["depos"] / stats["wall_s"]
    print(f"total: {stats['events']} events / {stats['depos']} depos in "
          f"{stats['wall_s']:.2f} s ({ev_s:.3g} events/s, {dp_s:.3g} depos/s)")
    health = stats["health"]
    if any(health[k] for k in ("quarantined", "retries", "halvings",
                               "resumed", "nonfinite_events",
                               "callback_errors")):
        print("health: " + ", ".join(
            f"{k}={v}" for k, v in health.items() if k != "dead_letters"))
        for d in health.get("dead_letters", []):
            print(f"  dead-letter event {d['event']} (batch {d['batch']}): "
                  + "; ".join(d["reasons"]))
    if args.profile:
        profiler.export_chrome_trace(args.profile)
        print(spans.table())
        print(f"profile: Chrome trace written to {args.profile}")


if __name__ == "__main__":
    main()
