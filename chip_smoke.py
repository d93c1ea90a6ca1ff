#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases (any failure exits non-zero before the result line):

  1. device   : the card's name and power limit (nvidia-smi), device count
  2. build    : nvcc every CUDA source for sm_90a (timed as set-up)
  3. kernels  : each fused charge-grid kernel against its plain PyTorch
                version at full MicroBooNE width (2560 x 9592, 100k depos):
                dense within the grid tolerance of the plain version,
                compact == dense bit for bit, two runs bit-identical, no
                dropped (depo, tile) entries; again at a tile-edge config,
                with 32 x 128 tiles, and for single depos straddling tile
                edges
  4. main     : the launcher's event loop, 4 full-width events with
                charge_grid_strategy=fused_pallas, then fused_pallas_compact
                (launch counters reset just before and read just after
                each); the ADC of every event must agree between the two;
                int16 ADC at the 900 baseline, finite signal, non-zero max
                dev; per-event time, depos/s, per-stage times, peak memory;
                then one event of the default unfused strategy
  5. timing   : each kernel's wrapper (median of 5 rounds of 20 calls) and
                its plain version timed with CUDA events at the main path's
                shapes, beside the least time the card could take (bytes or
                operations bound, from this run's inputs)
  6. summary  : one JSON line {"kernels": [...]}
  7. result   : last line {"ok": true, "device": {...}}

The on-card checks live here rather than in pytest because the machine with
the card has no JAX, which the repository's test configuration imports.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM peaks (NVIDIA data sheet): device memory bytes/s and float32
#: operations/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
#: operations per in-support pixel of the fused kernel: 2 mul (q*ww*wt);
#: 4 fmix32 hashes x 8 integer ops; 4 counter ops; 7 for the two uniforms;
#: 7 for Box-Muller (max, log, mul, sqrt, mul, cos, mul); 10 for the
#: binomial step; 1 accumulate. Transcendentals count as one operation,
#: so the bound stays a lower bound.
OPS_PER_PIXEL = 2 + 32 + 4 + 7 + 7 + 10 + 1
#: operations per row/column weight (two erf and their arguments)
OPS_PER_AXIS = 10
#: operations per (depo, tile) entry for its stream seed (2 mul, xor,
#: fmix32, add)
OPS_PER_ENTRY = 12
EVENTS = 4
STRATEGIES = ("fused_pallas", "fused_pallas_compact")


class PhaseError(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_time(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call of ``fn`` over ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


class KernelCase:
    """One fused-kernel problem: depos (generated from ``key`` unless
    given), binned lists and seed on the card."""

    def __init__(self, cfg, key, tw: int, tt: int, device, depos=None):
        import torch

        from repro_torch.core import prng
        from repro_torch.core.depo import depo_patch_origin, generate_depos
        from repro_torch.kernels.scatter_add import ops as binning

        self.cfg, self.tw, self.tt = cfg, tw, tt
        if depos is None:
            depos = generate_depos(key, cfg, device=device)
        w0, t0 = depo_patch_origin(depos, cfg)
        self.params = (*depos, w0, t0)
        self.seed = tuple(int(v) for v in prng.key_data(prng.split(key)[0]))
        self.k_max = binning.default_k_max(depos.n, cfg.num_wires,
                                           cfg.num_ticks, tw, tt)
        bin_args = (w0, t0, cfg.patch_wires, cfg.patch_ticks, cfg.num_wires,
                    cfg.num_ticks, tw, tt)
        self.ids, self.n_tiles, dropped = binning.bin_depos_to_tiles(
            *bin_args, self.k_max)
        self.n_cap = binning.active_tile_cap(*bin_args[:1], *bin_args[2:],
                                             t0=t0)
        self.active, self.cids, cdropped = binning.bin_depos_to_tiles_compact(
            *bin_args, self.k_max, self.n_cap)
        check(int(dropped) == 0 and int(cdropped) == 0,
              f"binning dropped {int(dropped)}/{int(cdropped)} entries")
        self.tiles_w, self.tiles_t, _ = binning.tile_counts(
            cfg.num_wires, cfg.num_ticks, tw, tt)
        self.kw = dict(num_wires=cfg.num_wires, num_ticks=cfg.num_ticks,
                       tw=tw, tt=tt, k_max=self.k_max, pw=cfg.patch_wires,
                       pt=cfg.patch_ticks, seed=self.seed, fluctuate=True)
        self._work = None
        torch.cuda.synchronize()

    def dense(self):
        from repro_torch.kernels.fused_sim import kernel

        return kernel.fused_rasterize_scatter(*self.params, self.ids,
                                              **self.kw)

    def compact(self):
        from repro_torch.kernels.fused_sim import kernel

        return kernel.fused_rasterize_scatter_compact(
            *self.params, self.active, self.cids, **self.kw)

    def plain_dense(self):
        from repro_torch.kernels.fused_sim import ref

        out = ref.fused_rasterize_scatter_ref(
            self.params, self.ids, tiles_w=self.tiles_w, tiles_t=self.tiles_t,
            tw=self.tw, tt=self.tt, k_max=self.k_max,
            pw=self.cfg.patch_wires, pt=self.cfg.patch_ticks, seed=self.seed,
            fluctuate=True)
        return out[:self.cfg.num_wires, :self.cfg.num_ticks]

    def plain_compact(self):
        from repro_torch.kernels.fused_sim import kernel, ref

        blocks = ref.fused_rasterize_scatter_compact_ref(
            self.params, self.active, self.cids, tiles_t=self.tiles_t,
            tw=self.tw, tt=self.tt, k_max=self.k_max,
            pw=self.cfg.patch_wires, pt=self.cfg.patch_ticks, seed=self.seed,
            fluctuate=True)
        return kernel.scatter_tiles_to_grid(
            blocks, self.active, self.tiles_w, self.tiles_t, self.tw,
            self.tt)[:self.cfg.num_wires, :self.cfg.num_ticks]

    def work(self):
        """(entries, in-support pixels, row+column weights) these lists
        need: the data-dependent work of the kernel."""
        if self._work is None:
            import torch

            pos = torch.nonzero(self.ids >= 0, as_tuple=True)[0]
            tile = pos // self.k_max
            d = self.ids[pos].long()
            w0, t0 = self.params[5].long()[d], self.params[6].long()[d]
            tw0 = (tile // self.tiles_t) * self.tw
            tt0 = (tile % self.tiles_t) * self.tt
            nr = (torch.minimum(w0 + self.cfg.patch_wires, tw0 + self.tw)
                  - torch.maximum(w0, tw0)).clamp_min(0)
            nc = (torch.minimum(t0 + self.cfg.patch_ticks, tt0 + self.tt)
                  - torch.maximum(t0, tt0)).clamp_min(0)
            self._work = (int(pos.numel()), int((nr * nc).sum()),
                          int((nr + nc).sum()))
        return self._work

    def bound(self, compact: bool):
        """(bound_ms, bound_by): the larger of bytes over the memory rate
        and operations over the float32 rate."""
        entries, pixels, axes = self.work()
        n = self.params[0].numel()
        out_bytes = 4 * self.cfg.num_wires * self.cfg.num_ticks
        list_bytes = 4 * entries + (4 * self.n_cap if compact else 0)
        nbytes = 7 * 4 * n + list_bytes + out_bytes
        ops = (OPS_PER_PIXEL * pixels + OPS_PER_AXIS * axes
               + OPS_PER_ENTRY * entries)
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        t_ops = ops / PEAK_F32_OPS_S * 1e3
        return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes,
                                                                 "bytes")


def check_kernels(case, label: str):
    """Phase 3 checks for one case; returns max |kernel - plain| of the
    dense and of the compact kernel."""
    import torch

    from repro_torch.testing.parity import GRID_ATOL_FRAC, RTOL

    dense1, dense2 = case.dense(), case.dense()
    comp1, comp2 = case.compact(), case.compact()
    plain = case.plain_dense()
    plain_c = case.plain_compact()
    torch.cuda.synchronize()
    check(torch.equal(dense1, dense2), f"{label}: dense kernel not "
          "bit-identical run to run")
    check(torch.equal(comp1, comp2), f"{label}: compact kernel not "
          "bit-identical run to run")
    check(torch.equal(comp1, dense1), f"{label}: compact kernel != dense "
          "kernel")
    check(torch.equal(plain_c, plain), f"{label}: plain compact != plain "
          "dense")
    check(bool(torch.isfinite(dense1).all()), f"{label}: non-finite grid")
    atol = GRID_ATOL_FRAC * float(plain.abs().max())
    err = float((dense1 - plain).abs().max())
    err_c = float((comp1 - plain_c).abs().max())
    close = torch.allclose(dense1, plain, rtol=RTOL, atol=atol)
    n_bad = int((~torch.isclose(dense1, plain, rtol=RTOL, atol=atol)).sum())
    print(f"{label}: grid {tuple(dense1.shape)}, max |kernel - plain| = "
          f"{err:.6g} (atol {atol:.6g}, rtol {RTOL}), {n_bad} outside; "
          f"max |plain| = {float(plain.abs().max()):.6g}; compact == dense "
          f"bitwise; run-to-run bitwise; n_cap {case.n_cap}, k_max "
          f"{case.k_max}, entries {case.work()[0]}", flush=True)
    check(close, f"{label}: dense kernel outside tolerance of the plain "
          "version")
    return err, err_c


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from repro_torch import kernels
    from repro_torch.config import get_config
    from repro_torch.core import prng
    from repro_torch.core.depo import DepoSet, generate_depos
    from repro_torch.core.pipeline import make_sim_fn
    from repro_torch.kernels.fused_sim import kernel
    from repro_torch.launch.sim import max_dev, run_events

    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()

    phase("device")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}; device 0: {kind}; devices: {count}")
    print(card, flush=True)

    phase("build")
    t0 = time.perf_counter()
    logs = kernels.build_all()
    for name, log in logs.items():
        print(f"[nvcc {name}]\n{log.strip()}")
    print(f"build: {time.perf_counter() - t0:.2f} s set-up "
          f"({', '.join(logs) or 'cached'})", flush=True)

    phase("kernels vs plain")
    full = get_config("lartpc-uboone")
    key0 = prng.fold_in(prng.key(0), 0)
    main_case = KernelCase(full, key0, 64, 256, dev)
    errors = check_kernels(main_case, "full width 64x256 tiles")
    edge_cfg = dataclasses.replace(full, num_wires=96, num_ticks=768,
                                   num_depos=128)
    check_kernels(KernelCase(edge_cfg, prng.key(1), 32, 128, dev),
                  "tile-edge 96x768, 32x128 tiles")
    check_kernels(KernelCase(full, prng.fold_in(prng.key(0), 1), 32, 128,
                             dev), "full width 32x128 tiles")
    # one depo per case, straddling an interior edge of the 64x256 tiles of
    # a 96x768 grid or clipped at the detector edge
    one = dataclasses.replace(edge_cfg, num_depos=1)
    for label, values in (("straddle wire edge", (63.7, 100.2, 1.1, 1.4,
                                                  4321.0)),
                          ("straddle tick edge", (30.0, 255.4, 1.1, 1.4,
                                                  4321.0)),
                          ("straddle corner", (63.7, 255.4, 1.1, 1.4,
                                               4321.0)),
                          ("detector edge", (0.4, 2.0, 0.8, 1.0, 999.0))):
        depos = DepoSet(*(torch.tensor([v], dtype=torch.float32, device=dev)
                          for v in values))
        check_kernels(KernelCase(one, prng.key(2), 64, 256, dev, depos),
                      f"one depo, {label}")

    phase("main path")
    adcs = {}
    launches = {}
    for strategy in STRATEGIES:
        cfg = dataclasses.replace(full, charge_grid_strategy=strategy)
        sim = make_sim_fn(cfg, device=dev)
        digests = []
        lines = []

        def on_event(ev, out, dt, cfg=cfg, digests=digests, lines=lines):
            check(out.adc.dtype == torch.int16, "ADC is not int16")
            check(tuple(out.adc.shape) == (cfg.num_wires, cfg.num_ticks),
                  f"ADC shape {tuple(out.adc.shape)}")
            check(bool(torch.isfinite(out.signal).all()), "non-finite signal")
            median = int(out.adc.flatten()[::97].median())
            dev_max = max_dev(out.adc, cfg)
            check(median == int(cfg.adc_baseline),
                  f"ADC median {median} != baseline {cfg.adc_baseline}")
            check(dev_max > 0, "max dev is 0")
            digests.append(out.adc.clone())
            lines.append(f"{strategy} event {ev}: {cfg.num_depos} depos -> "
                         f"{tuple(out.adc.shape)} ADC in {dt*1e3:.3f} ms "
                         f"({cfg.num_depos/dt:.4g} depos/s), max dev "
                         f"{dev_max}, median {median}")

        torch.cuda.reset_peak_memory_stats(dev)
        kernel.reset_launches()
        stats = run_events(cfg, EVENTS, seed=0, device=dev, sim=sim,
                           on_event=on_event)
        launches[strategy] = dict(kernel.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev)
        print("\n".join(lines))
        print(f"{strategy} total: {stats['events']} events / "
              f"{stats['depos']} depos in {stats['wall_s']:.4f} s "
              f"(sim alone: median {statistics.median(stats['event_s'])*1e3:.3f}"
              f" ms/event); launches {launches[strategy]}; peak memory "
              f"{peak / 2**20:.1f} MiB", flush=True)
        adcs[strategy] = digests
        _, timings = sim.timed(key0, generate_depos(key0, full, device=dev),
                               warmup=1, iters=5)
        total = sum(timings.values())
        print(f"{strategy} stages (CUDA events, median of 5): " + ", ".join(
            f"{n} {s*1e3:.3f} ms ({100*s/total:.1f}%)"
            for n, s in timings.items()), flush=True)
    check(launches["fused_pallas"]["fused_rasterize_scatter"] == EVENTS,
          f"dense kernel launches {launches['fused_pallas']}")
    check(launches["fused_pallas_compact"]["fused_rasterize_scatter_compact"]
          == EVENTS, f"compact kernel launches "
          f"{launches['fused_pallas_compact']}")
    for ev in range(EVENTS):
        check(torch.equal(adcs[STRATEGIES[0]][ev], adcs[STRATEGIES[1]][ev]),
              f"event {ev}: fused_pallas and fused_pallas_compact ADC differ")
    print(f"ADC of all {EVENTS} events identical between {STRATEGIES}")

    unfused = run_events(full, 1, seed=0, device=dev, on_event=lambda ev,
                         out, dt: print(f"unfused event {ev}: {dt*1e3:.3f} "
                                        f"ms, max dev {max_dev(out.adc, full)}"))
    check(unfused["events"] == 1, "unfused run")

    phase("kernel timing")
    rows = []
    for name, compact, fn, plain, replaces in (
            ("fused_rasterize_scatter", False, main_case.dense,
             main_case.plain_dense, "src/repro/kernels/fused_sim/kernel.py:262"),
            ("fused_rasterize_scatter_compact", True, main_case.compact,
             main_case.plain_compact,
             "src/repro/kernels/fused_sim/kernel.py:300")):
        rounds = sorted(cuda_time(fn, iters=20, warmup=2) for _ in range(5))
        ms = statistics.median(rounds)
        plain_ms = cuda_time(plain, iters=3, warmup=1)
        bound_ms, bound_by = main_case.bound(compact)
        strategy = STRATEGIES[compact]
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/fused_sim.cu",
            "replaces": replaces,
            "launches": launches[strategy][name],
            "max_abs_err": errors[compact], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None})
        print(f"{name}: {ms:.4f} ms/call of the wrapper (median of 5 rounds "
              f"of 20 calls, CUDA events; rounds {rounds[0]:.4f}.."
              f"{rounds[-1]:.4f} ms); plain {plain_ms:.3f} ms; bound "
              f"{bound_ms:.4f} ms "
              f"({bound_by}); library call: none (no single PyTorch call "
              f"computes this function); work {main_case.work()}",
              flush=True)

    print(f"chip_smoke wall: {time.perf_counter() - t_all:.1f} s")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
