#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases (any failure exits non-zero before the result line):

  1. device   : the card's name and power limit (nvidia-smi), device count
  2. build    : nvcc every CUDA source for sm_90a, in parallel (timed as
                set-up)
  3. kernels  : each kernel against its plain PyTorch version.
                Fused (rows 1-2) at full MicroBooNE width (2560 x 9592, 100k
                depos): dense within the grid tolerance of the plain
                version, compact == dense bit for bit, two runs
                bit-identical, no dropped (depo, tile) entries; again at a
                tile-edge config, with 32 x 128 tiles, and for single depos
                straddling tile edges.
                Scatter-add (rows 5-6) on the unfused chain's fluctuated
                patches at the same configs: kernel == plain bit for bit,
                compact == dense bit for bit, two runs bit-identical, and
                within the parity tolerance of index_put_(accumulate=True).
                Multi-plane fused (rows 3-4) at full width with 3 planes:
                within the grid tolerance of the plain version, compact ==
                dense bit for bit, and plane p == the one-plane kernel (row
                1) on plane p's depos with fold_in(kf, p), bit for bit.
                Rasterize (row 8) at 100k depos (padded to 100 096), with
                fluctuation on and off: kernel == plain bit for bit, two
                runs bit-identical, zero padding
  4. main     : the launcher's event loop (launch counters reset just
                before and read just after each run): 4 full-width events
                with charge_grid_strategy=fused_pallas, then
                fused_pallas_compact (ADC equal between the two); one event
                of the default unfused strategy; 4 full-width three-plane
                events with fused_pallas_multiplane, then
                fused_pallas_multiplane_compact (ADC equal between the two,
                and equal to the per-plane loop of the one-plane kernel);
                2 full-width events of unfused with scatter_strategy=pallas,
                then pallas_compact (ADC equal between the two, launch
                counters equal to the events served); 4 full-width
                three-plane events with fused_pallas_multiplane and
                recon=True (deconvolve + hit_find; ADC equal to the
                sim-only run, one hit-scan launch per plane and event,
                stored and found hits per plane); rasterize_depos at 100k
                depos with fluctuation on and off. Per plane:
                int16 ADC at the 900 baseline, finite signal, non-zero max
                dev; per-event time, depos/s, per-stage times, peak memory.
                Then the hit-scan kernel (row 7) against its plain version,
                bit for bit, on every plane's full-width deconvolved grid of
                recon event 0 and on synthetic edge-case grids
  5. timing   : each kernel's wrapper (median of 5 rounds of 20 calls) and
                its plain version (3 calls; the three-plane plain versions
                2 calls, hit scan and rasterize 1 call) timed with CUDA
                events at the main path's shapes (hit scan: one plane),
                beside the least time the card could take (bytes or
                operations bound, from this run's inputs) and, for the
                scatter-add kernels, the one PyTorch call that computes the
                same function (index_put_ with accumulate=True)
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
#: operations per in-support pixel of the rasterize kernel with
#: fluctuation: 2 mul (q*ww*wt); max, log, mul, sqrt, mul, cos, mul (the
#: normal); max, div, max, min (p); sub, mul, max (var); sqrt, fma, max
OPS_PER_RASTER_PIXEL = 2 + 7 + 4 + 3 + 3
#: operations per hit-scan sample (compare, two selects, mul, two adds,
#: max, the run bookkeeping)
OPS_PER_HIT_SAMPLE = 10
EVENTS = 4
#: full-width single-plane events per scatter-add strategy
SCATTER_EVENTS = 2
PLANES = 3
STRATEGIES = ("fused_pallas", "fused_pallas_compact")
MULTI_STRATEGIES = ("fused_pallas_multiplane",
                    "fused_pallas_multiplane_compact")
SCATTER_STRATEGIES = ("pallas", "pallas_compact")
#: one depo per case, straddling an interior edge of the 64x256 tiles of a
#: 96x768 grid or clipped at the detector edge
ONE_DEPO_CASES = (("straddle wire edge", (63.7, 100.2, 1.1, 1.4, 4321.0)),
                  ("straddle tick edge", (30.0, 255.4, 1.1, 1.4, 4321.0)),
                  ("straddle corner", (63.7, 255.4, 1.1, 1.4, 4321.0)),
                  ("detector edge", (0.4, 2.0, 0.8, 1.0, 999.0)))


#: synthetic hit-scan grids: 70 wires (a ragged last warp) x 1000 ticks
#: (a ragged last tile), threshold 500, and the scanner's edge cases
HIT_CASE_SHAPE = (70, 1000)
HIT_THRESHOLD = 500.0


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


def wrapper_ms(fn):
    """(median, sorted rounds) of 5 rounds of 20 calls, ms per call."""
    rounds = sorted(cuda_time(fn, iters=20, warmup=2) for _ in range(5))
    return statistics.median(rounds), rounds


def bound_of(nbytes: float, ops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the float32 rate."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_OPS_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def list_work(ids, k_max: int, w0, t0, pw: int, pt: int, tiles_t: int,
              tw: int, tt: int):
    """(entries, in-tile patch pixels, in-tile patch rows + columns) of the
    filled entries of dense per-tile lists: the work their data needs."""
    import torch

    pos = torch.nonzero(ids >= 0, as_tuple=True)[0]
    tile = pos // k_max
    d = ids[pos].long()
    w0, t0 = w0.long()[d], t0.long()[d]
    tw0 = (tile // tiles_t) * tw
    tt0 = (tile % tiles_t) * tt
    nr = (torch.minimum(w0 + pw, tw0 + tw)
          - torch.maximum(w0, tw0)).clamp_min(0)
    nc = (torch.minimum(t0 + pt, tt0 + tt)
          - torch.maximum(t0, tt0)).clamp_min(0)
    return int(pos.numel()), int((nr * nc).sum()), int((nr + nc).sum())


class KernelCase:
    """One fused-kernel problem: depos (generated from ``key`` unless
    given), binned lists and seed (the charge-grid key's words unless
    given) on the card."""

    def __init__(self, cfg, key, tw: int, tt: int, device, depos=None,
                 seed=None):
        import torch

        from repro_torch.core import prng
        from repro_torch.core.depo import depo_patch_origin, generate_depos
        from repro_torch.kernels.scatter_add import ops as binning

        self.cfg, self.tw, self.tt = cfg, tw, tt
        if depos is None:
            depos = generate_depos(key, cfg, device=device)
        w0, t0 = depo_patch_origin(depos, cfg)
        self.params = (*depos, w0, t0)
        self.seed = seed if seed is not None else tuple(
            int(v) for v in prng.key_data(prng.split(key)[0]))
        self.k_max = binning.default_k_max(depos.n, cfg.num_wires,
                                           cfg.num_ticks, tw, tt)
        self.bin_args = (w0, t0, cfg.patch_wires, cfg.patch_ticks,
                         cfg.num_wires, cfg.num_ticks, tw, tt)
        self.ids, self.n_tiles, dropped = binning.bin_depos_to_tiles(
            *self.bin_args, self.k_max)
        self.n_cap = binning.active_tile_cap(
            *self.bin_args[:1], *self.bin_args[2:], t0=t0)
        self.active, self.cids, cdropped = self.compact_lists(self.n_cap)
        check(int(dropped) == 0 and int(cdropped) == 0,
              f"binning dropped {int(dropped)}/{int(cdropped)} entries")
        self.tiles_w, self.tiles_t, _ = binning.tile_counts(
            cfg.num_wires, cfg.num_ticks, tw, tt)
        self.kw = dict(num_wires=cfg.num_wires, num_ticks=cfg.num_ticks,
                       tw=tw, tt=tt, k_max=self.k_max, pw=cfg.patch_wires,
                       pt=cfg.patch_ticks, seed=self.seed, fluctuate=True)
        self._work = None
        torch.cuda.synchronize()

    def compact_lists(self, n_cap: int):
        from repro_torch.kernels.scatter_add import ops as binning

        return binning.bin_depos_to_tiles_compact(*self.bin_args, self.k_max,
                                                  n_cap)

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
            self._work = list_work(self.ids, self.k_max, self.params[5],
                                   self.params[6], self.cfg.patch_wires,
                                   self.cfg.patch_ticks, self.tiles_t,
                                   self.tw, self.tt)
        return self._work

    def bytes_ops(self, n_cap: int = 0):
        """(bytes, operations) of the fused kernel on these lists: inputs
        read once, the grid written once; ``n_cap`` adds the compact
        layout's active list."""
        entries, pixels, axes = self.work()
        n = self.params[0].numel()
        out_bytes = 4 * self.cfg.num_wires * self.cfg.num_ticks
        nbytes = 7 * 4 * n + 4 * entries + 4 * n_cap + out_bytes
        ops = (OPS_PER_PIXEL * pixels + OPS_PER_AXIS * axes
               + OPS_PER_ENTRY * entries)
        return nbytes, ops

    def bound(self, compact: bool):
        return bound_of(*self.bytes_ops(self.n_cap if compact else 0))


class MultiPlaneCase:
    """One three-plane fused-kernel problem: the event's physical depos
    drifted onto every plane, one ``KernelCase`` per plane seeded with
    ``fold_in(kf, p)``, and the plane-major lists of the multi-plane
    launch (compact: one shared ``n_cap``)."""

    def __init__(self, cfg, key, tw: int, tt: int, device):
        import torch

        from repro_torch.core import prng
        from repro_torch.core.depo import generate_plane_depos
        from repro_torch.core.stages import plane_fold_keys
        from repro_torch.config import plane_specs

        self.cfg = cfg
        depos = generate_plane_depos(key, cfg, device=device)
        keys = plane_fold_keys(prng.split(key)[0], plane_specs(cfg))
        self.seeds = [tuple(row) for row in keys.tolist()]
        self.planes = [KernelCase(cfg, None, tw, tt, device,
                                  depos=type(depos)(*(x[p] for x in depos)),
                                  seed=self.seeds[p])
                       for p in range(cfg.num_planes)]
        first = self.planes[0]
        self.k_max, self.tiles_w, self.tiles_t = (first.k_max, first.tiles_w,
                                                  first.tiles_t)
        self.n_cap = max(c.n_cap for c in self.planes)
        compact = [c.compact_lists(self.n_cap) for c in self.planes]
        check(all(int(d) == 0 for _, _, d in compact),
              "multi-plane compact binning dropped entries")
        self.params = tuple(torch.stack([c.params[i] for c in self.planes])
                            for i in range(7))
        self.ids = torch.cat([c.ids for c in self.planes])
        self.active = torch.cat([a for a, _, _ in compact])
        self.cids = torch.cat([i for _, i, _ in compact])
        self.kw = dict(num_planes=cfg.num_planes, num_wires=cfg.num_wires,
                       num_ticks=cfg.num_ticks, tw=tw, tt=tt,
                       k_max=self.k_max, pw=cfg.patch_wires,
                       pt=cfg.patch_ticks, seeds=self.seeds, fluctuate=True)
        self.geom = dict(tiles_t=self.tiles_t, tw=tw, tt=tt, k_max=self.k_max,
                         pw=cfg.patch_wires, pt=cfg.patch_ticks)
        torch.cuda.synchronize()

    def dense(self):
        from repro_torch.kernels.fused_sim import kernel

        return kernel.fused_rasterize_scatter_multiplane(
            *self.params, self.ids, **self.kw)

    def compact(self):
        from repro_torch.kernels.fused_sim import kernel

        return kernel.fused_rasterize_scatter_multiplane_compact(
            *self.params, self.active, self.cids, **self.kw)

    def plain_dense(self):
        from repro_torch.kernels.fused_sim import ref

        out = ref.fused_rasterize_scatter_multiplane_ref(
            self.params, self.ids, tiles_w=self.tiles_w, seeds=self.seeds,
            fluctuate=True, **self.geom)
        return out[:, :self.cfg.num_wires, :self.cfg.num_ticks]

    def plain_compact(self):
        from repro_torch.kernels.fused_sim import kernel, ref

        blocks = ref.fused_rasterize_scatter_multiplane_compact_ref(
            self.params, self.active, self.cids, seeds=self.seeds,
            fluctuate=True, **self.geom)
        return kernel.scatter_tiles_to_grid_planes(
            blocks, self.active, self.cfg.num_planes, self.tiles_w,
            self.tiles_t, self.geom["tw"], self.geom["tt"]
        )[:, :self.cfg.num_wires, :self.cfg.num_ticks]

    def bound(self, compact: bool):
        """The one-plane bound's bytes and operations summed over the
        planes' lists."""
        parts = [c.bytes_ops(self.n_cap if compact else 0)
                 for c in self.planes]
        return bound_of(sum(b for b, _ in parts), sum(o for _, o in parts))

    def work(self):
        return tuple(sum(w) for w in zip(*(c.work() for c in self.planes)))


class ScatterCase:
    """One scatter-add problem: the unfused chain's fluctuated patches of
    depos generated from ``key`` (or given), with the dense and compact
    lists the ``pallas`` strategies bin them into."""

    def __init__(self, cfg, key, tw: int, tt: int, device, depos=None):
        import torch

        from repro_torch.core import fluctuate as fl
        from repro_torch.core import prng
        from repro_torch.core.depo import generate_depos
        from repro_torch.core.rasterize import rasterize
        from repro_torch.kernels.scatter_add import ops as binning

        self.cfg = cfg
        if depos is None:
            depos = generate_depos(key, cfg, device=device)
        patches, self.w0, self.t0 = rasterize(depos, cfg)
        self.patches = fl.fluctuate_counter(prng.split(key)[0], patches,
                                            depos.charge)
        _, pw, pt = self.patches.shape
        self.tw, self.tt = max(tw, pw), max(tt, pt)
        self.k_max = binning.default_k_max(depos.n, cfg.num_wires,
                                           cfg.num_ticks, self.tw, self.tt)
        args = (self.w0, self.t0, pw, pt, cfg.num_wires, cfg.num_ticks,
                self.tw, self.tt)
        self.ids, _, dropped = binning.bin_depos_to_tiles(*args, self.k_max)
        self.n_cap = binning.active_tile_cap(*args[:1], *args[2:], t0=self.t0)
        self.active, self.cids, cdropped = binning.bin_depos_to_tiles_compact(
            *args, self.k_max, self.n_cap)
        check(int(dropped) == 0 and int(cdropped) == 0,
              f"scatter binning dropped {int(dropped)}/{int(cdropped)}")
        self.tiles_w, self.tiles_t, _ = binning.tile_counts(
            cfg.num_wires, cfg.num_ticks, self.tw, self.tt)
        self.kw = dict(num_wires=cfg.num_wires, num_ticks=cfg.num_ticks,
                       tw=self.tw, tt=self.tt, k_max=self.k_max)
        from repro_torch.core.scatter import flat_pixel_indices

        self.flat_idx = flat_pixel_indices(self.w0, self.t0, pw, pt,
                                           cfg.num_ticks).reshape(-1)
        torch.cuda.synchronize()

    def _crop(self, grid):
        return grid[:self.cfg.num_wires, :self.cfg.num_ticks]

    def _place(self, blocks):
        from repro_torch.kernels.fused_sim.kernel import scatter_tiles_to_grid

        return self._crop(scatter_tiles_to_grid(
            blocks, self.active, self.tiles_w, self.tiles_t, self.tw,
            self.tt))

    def dense(self):
        from repro_torch.kernels.scatter_add import kernel

        return self._crop(kernel.scatter_add_pallas(
            self.patches, self.w0, self.t0, self.ids, **self.kw))

    def compact(self):
        from repro_torch.kernels.scatter_add import kernel

        return self._place(kernel.scatter_add_pallas_compact(
            self.patches, self.w0, self.t0, self.active, self.cids,
            **self.kw))

    def plain_dense(self):
        from repro_torch.kernels.scatter_add import ref

        return self._crop(ref.scatter_add_ref(
            self.patches, self.w0, self.t0, self.ids, tiles_w=self.tiles_w,
            tiles_t=self.tiles_t, tw=self.tw, tt=self.tt, k_max=self.k_max))

    def plain_compact(self):
        from repro_torch.kernels.scatter_add import ref

        return self._place(ref.scatter_add_compact_ref(
            self.patches, self.w0, self.t0, self.active, self.cids,
            tiles_t=self.tiles_t, tw=self.tw, tt=self.tt, k_max=self.k_max))

    def library(self):
        """The one PyTorch call computing the same function:
        index_put_(accumulate=True) of every patch pixel into a zeroed
        grid."""
        import torch

        grid = torch.zeros(self.cfg.num_wires * self.cfg.num_ticks,
                           dtype=torch.float32, device=self.patches.device)
        grid.index_put_((self.flat_idx,), self.patches.reshape(-1),
                        accumulate=True)
        return grid.reshape(self.cfg.num_wires, self.cfg.num_ticks)

    def work(self):
        """(entries, in-tile patch pixels) these lists add."""
        _, pw, pt = self.patches.shape
        return list_work(self.ids, self.k_max, self.w0, self.t0, pw, pt,
                         self.tiles_t, self.tw, self.tt)[:2]

    def bound(self, compact: bool):
        """Bytes: patches, origins and the filled list entries read once
        (plus the compact active list), the grid written once;
        operations: one add per in-tile patch pixel."""
        entries, pixels = self.work()
        nbytes = (self.patches.numel() * 4 + 8 * self.patches.shape[0]
                  + 4 * entries + (4 * self.n_cap if compact else 0)
                  + 4 * self.cfg.num_wires * self.cfg.num_ticks)
        return bound_of(nbytes, pixels)


class RasterCase:
    """The rasterize kernel's problem on its own path: ``rasterize_depos``
    of ``cfg.num_depos`` generated depos, padded to the 256-depo block,
    with the uniform pools of ``split(key)`` over the padded shape."""

    def __init__(self, cfg, key, device, block: int = 256):
        import torch

        from repro_torch.core.depo import depo_patch_origin, generate_depos
        from repro_torch.kernels.rasterize import ops

        self.cfg = cfg
        padded, _ = ops.pad_depos(generate_depos(key, cfg, device=device),
                                  block)
        self.params = (*padded, *depo_patch_origin(padded, cfg))
        self.pw_pad = (cfg.patch_wires + 7) // 8 * 8
        self.pt_pad = cfg.pad_ticks
        self.pools = ops.uniform_pools(key, (padded.n, self.pw_pad,
                                             self.pt_pad), device)
        self.kw = dict(pw=cfg.patch_wires, pt=cfg.patch_ticks,
                       pw_pad=self.pw_pad, pt_pad=self.pt_pad)
        torch.cuda.synchronize()

    def kernel(self, fluctuate: bool = True):
        from repro_torch.kernels.rasterize import kernel

        return kernel.rasterize_pallas(*self.params, *self.pools,
                                       fluctuate=fluctuate, **self.kw)

    def plain(self, fluctuate: bool = True):
        from repro_torch.kernels.rasterize import ref

        return ref.rasterize_ref(*self.params, *self.pools,
                                 fluctuate=fluctuate, **self.kw)

    def bound(self, fluctuate: bool = True):
        """Bytes: the output written once, the depo parameters and, with
        fluctuation, the in-support part of both pools read once;
        operations: the per-pixel arithmetic of the in-support pixels and
        the axis weights."""
        n = self.params[0].numel()
        pixels = n * self.cfg.patch_wires * self.cfg.patch_ticks
        nbytes = 4 * n * (self.pw_pad * self.pt_pad + 7)
        ops = (2 * pixels + OPS_PER_AXIS * n * (self.cfg.patch_wires
                                                + self.cfg.patch_ticks))
        if fluctuate:
            nbytes += 2 * 4 * pixels
            ops += (OPS_PER_RASTER_PIXEL - 2) * pixels
        return bound_of(nbytes, ops)


def hit_edge_grids(device):
    """(label, (W, T) grid) synthetic hit-scan cases: runs at tick 0, open
    at the last tick, more runs than the per-wire capacity, samples equal
    to the threshold, all below, all above, and noise of every run
    length."""
    import torch

    w, t = HIT_CASE_SHAPE
    gen = torch.Generator(device="cpu").manual_seed(0)
    noise = torch.randn((w, t), generator=gen) * 600.0
    g = torch.zeros((w, t))
    g[0, 0] = 700.0
    g[1, :5] = torch.tensor([600.0, 900.0, 1200.0, 800.0, 510.0])
    g[2, -3:] = torch.tensor([550.0, 2000.0, 900.0])
    g[3, :] = 1000.0 + torch.arange(t, dtype=torch.float32)
    g[4, ::2] = 800.0
    g[5, 10:20] = HIT_THRESHOLD
    g[6, 10:20] = torch.nextafter(torch.tensor(HIT_THRESHOLD),
                                  torch.tensor(1e9))
    g[7, ::3] = 2e6
    g[8:40] = noise[8:40]
    g[40:] = noise[40:].abs() * 0.5 + 450.0
    return [("edge cases", g.to(device)), ("noise", noise.to(device))]


def check_hitfind(grids, cap: int):
    """Hit-scan kernel == its plain version bit for bit on every (label,
    grid), two runs bit-identical; returns the largest |kernel - plain|
    over the float outputs (0 when they pass)."""
    import torch

    from repro_torch.kernels.hitfind import kernel, ref

    worst = 0.0
    for label, grid in grids:
        got = kernel.hitfind_pallas(grid, threshold=HIT_THRESHOLD, cap=cap)
        again = kernel.hitfind_pallas(grid, threshold=HIT_THRESHOLD, cap=cap)
        want = ref.hitfind_ref(grid, threshold=HIT_THRESHOLD, cap=cap)
        torch.cuda.synchronize()
        errs = [float((a - b).abs().max()) for a, b in zip(got[1:], want[1:])]
        worst = max([worst] + errs)
        counts = got[0][:, 0]
        print(f"hit scan {label}: grid {tuple(grid.shape)}, runs found "
              f"{int(counts.sum())}, stored {int(counts.clamp_max(cap).sum())}"
              f", max |kernel - plain| (charge, tick, peak) = {errs}",
              flush=True)
        for name, a, b, c in zip(("counts", "charge", "tick", "peak"), got,
                                 want, again):
            check(torch.equal(a, b), f"hit scan {label}: kernel {name} != "
                  "plain version")
            check(torch.equal(a, c), f"hit scan {label}: kernel {name} not "
                  "bit-identical run to run")
    return worst


def hit_bound(grid, cap: int):
    """The hit scan's bound on ``grid``. Bytes: the grid read once, counts
    and candidates written once; operations: ~10 per sample."""
    w, t = grid.shape
    return bound_of(4 * (w * t + w + 3 * w * cap), OPS_PER_HIT_SAMPLE * w * t)


def check_kernels(case, label: str):
    """Phase 3 checks for one fused case; returns max |kernel - plain| of
    the dense and of the compact kernel."""
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


def check_scatter(case, label: str):
    """Phase 3 checks for one scatter-add case; returns max |kernel -
    plain| of the dense and of the compact kernel (0 when they pass)."""
    import torch

    from repro_torch.testing.parity import ATOL_FRAC, RTOL

    dense1, dense2 = case.dense(), case.dense()
    comp1, comp2 = case.compact(), case.compact()
    plain, plain_c = case.plain_dense(), case.plain_compact()
    lib = case.library()
    torch.cuda.synchronize()
    err = float((dense1 - plain).abs().max())
    err_c = float((comp1 - plain_c).abs().max())
    atol = ATOL_FRAC * float(lib.abs().max())
    lib_err = float((dense1 - lib).abs().max())
    print(f"{label}: grid {tuple(dense1.shape)}, max |kernel - plain| = "
          f"{err:.6g} (compact {err_c:.6g}), max |kernel - index_put_| = "
          f"{lib_err:.6g} (atol {atol:.6g}, rtol {RTOL}); max |grid| = "
          f"{float(plain.abs().max()):.6g}; tiles {case.tw}x{case.tt}, "
          f"n_cap {case.n_cap}, k_max {case.k_max}", flush=True)
    check(float(dense1.sum()) > 0.0, f"{label}: empty grid")
    check(torch.equal(dense1, plain), f"{label}: dense kernel != plain "
          "version")
    check(torch.equal(comp1, plain_c), f"{label}: compact kernel != plain "
          "version")
    check(torch.equal(dense1, dense2) and torch.equal(comp1, comp2),
          f"{label}: kernel not bit-identical run to run")
    check(torch.equal(comp1, dense1), f"{label}: compact kernel != dense "
          "kernel")
    check(torch.allclose(dense1, lib, rtol=RTOL, atol=atol),
          f"{label}: kernel outside tolerance of index_put_")
    return err, err_c


def check_multiplane(case, label: str):
    """Phase 3 checks for the three-plane fused case; returns max |kernel -
    plain| of the dense and of the compact kernel."""
    import torch

    from repro_torch.testing.parity import GRID_ATOL_FRAC, RTOL

    dense1, dense2 = case.dense(), case.dense()
    comp = case.compact()
    plain, plain_c = case.plain_dense(), case.plain_compact()
    singles = [c.dense() for c in case.planes]
    torch.cuda.synchronize()
    atol = GRID_ATOL_FRAC * float(plain.abs().max())
    err = float((dense1 - plain).abs().max())
    err_c = float((comp - plain_c).abs().max())
    print(f"{label}: grids {tuple(dense1.shape)}, max |kernel - plain| = "
          f"{err:.6g} (compact {err_c:.6g}; atol {atol:.6g}, rtol {RTOL}); "
          f"n_cap {case.n_cap} per plane, k_max {case.k_max}, entries per "
          f"plane {[c.work()[0] for c in case.planes]}", flush=True)
    check(torch.equal(dense1, dense2), f"{label}: not bit-identical run to "
          "run")
    check(torch.equal(comp, dense1), f"{label}: compact kernel != dense "
          "kernel")
    check(torch.equal(plain_c, plain), f"{label}: plain compact != plain "
          "dense")
    check(torch.allclose(dense1, plain, rtol=RTOL, atol=atol),
          f"{label}: kernel outside tolerance of the plain version")
    for p, single in enumerate(singles):
        check(torch.equal(dense1[p], single),
              f"{label}: plane {p} != the one-plane kernel with "
              f"fold_in(kf, {p})")
    print(f"{label}: plane p == one-plane kernel with fold_in(kf, p), bit "
          f"for bit, p = 0..{len(singles) - 1}", flush=True)
    return err, err_c


def run_main(cfg, label: str, events: int, dev, counters,
             recon: bool = False):
    """One launcher run of ``events`` events, every launch counter reset
    just before and read just after; per-plane checks on every event.
    Returns (the events' ADC, the counters read, the graph, event 0's
    output)."""
    import torch

    from repro_torch.core.pipeline import make_sim_fn
    from repro_torch.launch.sim import hit_counts, max_dev, run_events

    sim = make_sim_fn(cfg, device=dev, recon=recon)
    adcs, lines, first = [], [], []
    n_planes = cfg.num_planes
    shape = ((n_planes,) if n_planes > 1 else ()) + (cfg.num_wires,
                                                     cfg.num_ticks)

    def on_event(ev, out, dt):
        check(out.adc.dtype == torch.int16, "ADC is not int16")
        check(tuple(out.adc.shape) == shape,
              f"ADC shape {tuple(out.adc.shape)} != {shape}")
        check(bool(torch.isfinite(out.signal).all()), "non-finite signal")
        planes = out.adc.reshape(-1, cfg.num_wires, cfg.num_ticks)
        devs, medians = [], []
        for p in range(planes.shape[0]):
            medians.append(int(planes[p].flatten()[::97].median()))
            devs.append(max_dev(planes[p], cfg))
            check(medians[-1] == int(cfg.adc_baseline),
                  f"plane {p}: ADC median {medians[-1]} != baseline "
                  f"{cfg.adc_baseline}")
            check(devs[-1] > 0, f"plane {p}: max dev is 0")
        adcs.append(out.adc.clone())
        if ev == 0:
            first.append(out)
        n = cfg.num_depos * n_planes
        hits = ""
        if recon:
            check(bool(torch.isfinite(out.decon).all()), "non-finite decon")
            per_plane = [hit_counts(out.hits, p if n_planes > 1 else None)
                         for p in range(n_planes)]
            check(all(s > 0 for s, _ in per_plane), f"a plane without hits: "
                  f"{per_plane}")
            hits = f", hits (stored, found) per plane {per_plane}"
        lines.append(f"{label} event {ev}: {cfg.num_depos} depos x "
                     f"{n_planes} plane(s) -> {tuple(out.adc.shape)} ADC in "
                     f"{dt*1e3:.3f} ms ({n/dt:.4g} plane-depos/s), max dev "
                     f"per plane {devs}, median per plane {medians}, "
                     f"dropped {int(out.dropped)}{hits}")

    torch.cuda.reset_peak_memory_stats(dev)
    for module in counters:
        module.reset_launches()
    stats = run_events(cfg, events, seed=0, device=dev, sim=sim,
                       on_event=on_event)
    launches = {name: n for module in counters
                for name, n in module.LAUNCHES.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    print("\n".join(lines))
    print(f"{label} total: {stats['events']} events / {stats['depos']} "
          f"depos x {n_planes} plane(s) in {stats['wall_s']:.4f} s (sim "
          f"alone: median {statistics.median(stats['event_s'])*1e3:.3f} "
          f"ms/event); launches {launches}; peak memory "
          f"{peak / 2**20:.1f} MiB", flush=True)
    return adcs, launches, sim, first[0]


def print_stages(label: str, sim, key, depos) -> None:
    _, timings = sim.timed(key, depos, warmup=1, iters=5)
    total = sum(timings.values())
    print(f"{label} stages (CUDA events, median of 5): " + ", ".join(
        f"{n} {s*1e3:.3f} ms ({100*s/total:.1f}%)"
        for n, s in timings.items()) + f"; sum {total*1e3:.3f} ms",
        flush=True)


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
    from repro_torch.core.depo import (DepoSet, generate_depos,
                                       generate_physical_depos)
    from repro_torch.kernels.fused_sim import kernel
    from repro_torch.kernels.hitfind import kernel as hit_kernel
    from repro_torch.kernels.hitfind import ref as hit_ref
    from repro_torch.kernels.rasterize import kernel as raster_kernel
    from repro_torch.kernels.rasterize.ops import rasterize_depos
    from repro_torch.kernels.scatter_add import kernel as scatter_kernel
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
    full3 = dataclasses.replace(full, num_planes=PLANES)
    key0 = prng.fold_in(prng.key(0), 0)
    main_case = KernelCase(full, key0, 64, 256, dev)
    errors = check_kernels(main_case, "full width 64x256 tiles")
    edge_cfg = dataclasses.replace(full, num_wires=96, num_ticks=768,
                                   num_depos=128)
    check_kernels(KernelCase(edge_cfg, prng.key(1), 32, 128, dev),
                  "tile-edge 96x768, 32x128 tiles")
    check_kernels(KernelCase(full, prng.fold_in(prng.key(0), 1), 32, 128,
                             dev), "full width 32x128 tiles")
    one = dataclasses.replace(edge_cfg, num_depos=1)
    for label, values in ONE_DEPO_CASES:
        depos = DepoSet(*(torch.tensor([v], dtype=torch.float32, device=dev)
                          for v in values))
        check_kernels(KernelCase(one, prng.key(2), 64, 256, dev, depos),
                      f"one depo, {label}")

    scatter_case = ScatterCase(full, key0, 64, 256, dev)
    scatter_errors = check_scatter(scatter_case,
                                   "scatter-add full width 64x256 tiles")
    check_scatter(ScatterCase(edge_cfg, prng.key(1), 32, 128, dev),
                  "scatter-add tile-edge 96x768, 32x128 tiles")
    for label, values in ONE_DEPO_CASES:
        depos = DepoSet(*(torch.tensor([v], dtype=torch.float32, device=dev)
                          for v in values))
        check_scatter(ScatterCase(one, prng.key(2), 64, 256, dev, depos),
                      f"scatter-add one depo, {label}")

    multi_case = MultiPlaneCase(full3, key0, 64, 256, dev)
    multi_errors = check_multiplane(multi_case,
                                    "three planes, full width 64x256 tiles")

    raster_case = RasterCase(full, key0, dev)
    raster_err = 0.0
    for fluct in (True, False):
        got, again = raster_case.kernel(fluct), raster_case.kernel(fluct)
        want = raster_case.plain(fluct)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        same = float((got == want).float().mean())
        print(f"rasterize fluctuate={fluct}: patches {tuple(got.shape)}, max "
              f"|kernel - plain| = {err:.6g}, bitwise-equal share {same}; "
              f"max |patch| {float(want.abs().max()):.6g}", flush=True)
        check(torch.equal(got, want), f"rasterize fluctuate={fluct}: kernel "
              "!= plain version")
        check(torch.equal(got, again), f"rasterize fluctuate={fluct}: not "
              "bit-identical run to run")
        check(bool((got[:, full.patch_wires:] == 0).all()
                   and (got[:, :, full.patch_ticks:] == 0).all()),
              "rasterize: non-zero padding")
        check(bool((got >= 0).all()) and float(got.sum()) > 0,
              f"rasterize fluctuate={fluct}: negative or empty patches")
        raster_err = max(raster_err, err)
        del got, again, want

    phase("main path")
    adcs = {}
    launches = {}
    for strategy in STRATEGIES:
        cfg = dataclasses.replace(full, charge_grid_strategy=strategy)
        adcs[strategy], launches[strategy], sim, _ = run_main(
            cfg, strategy, EVENTS, dev, [kernel])
        print_stages(strategy, sim, key0, generate_depos(key0, full,
                                                         device=dev))
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

    for strategy in MULTI_STRATEGIES:
        cfg = dataclasses.replace(full3, charge_grid_strategy=strategy)
        adcs[strategy], launches[strategy], sim, _ = run_main(
            cfg, strategy, EVENTS, dev, [kernel])
        print_stages(strategy, sim, key0, generate_physical_depos(
            key0, full3, device=dev))
        name = strategy.replace("fused_pallas", "fused_rasterize_scatter")
        check(launches[strategy][name] == EVENTS,
              f"{strategy}: kernel launches {launches[strategy]}")
    for ev in range(EVENTS):
        check(torch.equal(adcs[MULTI_STRATEGIES[0]][ev],
                          adcs[MULTI_STRATEGIES[1]][ev]),
              f"event {ev}: {MULTI_STRATEGIES} ADC differ")
    print(f"ADC of all {EVENTS} three-plane events identical between "
          f"{MULTI_STRATEGIES}")
    loop_cfg = dataclasses.replace(full3, charge_grid_strategy="fused_pallas",
                                   plane_batching="loop")
    loop_adcs, loop_launches, _, _ = run_main(loop_cfg, "fused_pallas loop",
                                              1, dev, [kernel])
    check(loop_launches["fused_rasterize_scatter"] == PLANES,
          f"per-plane loop launches {loop_launches}")
    check(torch.equal(loop_adcs[0], adcs[MULTI_STRATEGIES[0]][0]),
          "event 0: the multi-plane launch differs from the per-plane loop "
          "of the one-plane kernel")
    print("event 0: multi-plane stacked ADC == per-plane loop of the "
          "one-plane kernel, bit for bit")

    for scatter in SCATTER_STRATEGIES:
        cfg = dataclasses.replace(full, scatter_strategy=scatter)
        adcs[scatter], launches[scatter], sim, _ = run_main(
            cfg, f"unfused+{scatter}", SCATTER_EVENTS, dev, [scatter_kernel])
        print_stages(f"unfused+{scatter}", sim, key0,
                     generate_depos(key0, full, device=dev))
        name = f"scatter_add_{scatter}"
        check(launches[scatter][name] == SCATTER_EVENTS,
              f"{scatter}: kernel launches {launches[scatter]}")
    for ev in range(SCATTER_EVENTS):
        check(torch.equal(adcs["pallas"][ev], adcs["pallas_compact"][ev]),
              f"event {ev}: unfused pallas and pallas_compact ADC differ")
    print(f"ADC of all {SCATTER_EVENTS} unfused events identical between "
          f"{SCATTER_STRATEGIES}")

    recon_cfg = dataclasses.replace(full3,
                                    charge_grid_strategy=MULTI_STRATEGIES[0])
    recon_adcs, launches["recon"], sim, recon0 = run_main(
        recon_cfg, "recon", EVENTS, dev, [kernel, hit_kernel], recon=True)
    print_stages("recon", sim, key0, generate_physical_depos(
        key0, full3, device=dev))
    check(launches["recon"]["hitfind_pallas"] == PLANES * EVENTS,
          f"recon: hit-scan launches {launches['recon']} != planes x events")
    check(launches["recon"]["fused_rasterize_scatter_multiplane"] == EVENTS,
          f"recon: charge-grid launches {launches['recon']}")
    for ev in range(EVENTS):
        check(torch.equal(recon_adcs[ev], adcs[MULTI_STRATEGIES[0]][ev]),
              f"event {ev}: the recon graph's ADC differs from the sim-only "
              "graph's")
    print(f"ADC of all {EVENTS} recon events identical to the sim-only run")

    depos0 = generate_depos(key0, full, device=dev)
    raster_kernel.reset_launches()
    for fluct in (True, False):
        patches, _, _ = rasterize_depos(key0, depos0, full, fluctuate=fluct,
                                        device=dev)
        torch.cuda.synchronize()
        check(tuple(patches.shape) == (full.num_depos, raster_case.pw_pad,
                                       raster_case.pt_pad)
              and bool(torch.isfinite(patches).all()),
              f"rasterize_depos fluctuate={fluct}: {tuple(patches.shape)}")
        print(f"rasterize_depos fluctuate={fluct}: {tuple(patches.shape)} "
              f"patches, total charge {float(patches.sum()):.6g}", flush=True)
    launches["rasterize"] = dict(raster_kernel.LAUNCHES)
    check(launches["rasterize"]["rasterize_pallas"] == 2,
          f"rasterize_depos launches {launches['rasterize']}")
    del patches

    planes0 = [(f"recon event 0 plane {p}", recon0.decon[p].contiguous())
               for p in range(PLANES)]
    hit_err = check_hitfind(planes0 + hit_edge_grids(dev),
                            full.max_hits_per_wire)
    print("hit scan: kernel == plain version bit for bit on every plane and "
          "edge case", flush=True)

    phase("kernel timing")
    rows = []
    fused_src = "src/repro_torch/csrc/fused_sim.cu"
    scatter_src = "src/repro_torch/csrc/scatter_add.cu"
    grid0, cap = planes0[0][1], full.max_hits_per_wire
    # (name, wrapper call, plain call, plain calls timed, bound, library
    # call or None, source, replaced TPU kernel, main-path run, max error)
    timed = (
        ("fused_rasterize_scatter", main_case.dense, main_case.plain_dense, 3,
         main_case.bound(False), None, fused_src,
         "src/repro/kernels/fused_sim/kernel.py:262", "fused_pallas",
         errors[0]),
        ("fused_rasterize_scatter_compact", main_case.compact,
         main_case.plain_compact, 3, main_case.bound(True), None, fused_src,
         "src/repro/kernels/fused_sim/kernel.py:300", "fused_pallas_compact",
         errors[1]),
        ("fused_rasterize_scatter_multiplane", multi_case.dense,
         multi_case.plain_dense, 2, multi_case.bound(False), None, fused_src,
         "src/repro/kernels/fused_sim/kernel.py:340",
         "fused_pallas_multiplane", multi_errors[0]),
        ("fused_rasterize_scatter_multiplane_compact", multi_case.compact,
         multi_case.plain_compact, 2, multi_case.bound(True), None,
         fused_src, "src/repro/kernels/fused_sim/kernel.py:392",
         "fused_pallas_multiplane_compact", multi_errors[1]),
        ("scatter_add_pallas", scatter_case.dense, scatter_case.plain_dense,
         3, scatter_case.bound(False), scatter_case.library, scatter_src,
         "src/repro/kernels/scatter_add/kernel.py:97", "pallas",
         scatter_errors[0]),
        ("scatter_add_pallas_compact", scatter_case.compact,
         scatter_case.plain_compact, 3, scatter_case.bound(True),
         scatter_case.library, scatter_src,
         "src/repro/kernels/scatter_add/kernel.py:140", "pallas_compact",
         scatter_errors[1]),
        ("hitfind_pallas",
         lambda: hit_kernel.hitfind_pallas(grid0, threshold=HIT_THRESHOLD,
                                           cap=cap),
         lambda: hit_ref.hitfind_ref(grid0, threshold=HIT_THRESHOLD,
                                     cap=cap),
         1, hit_bound(grid0, cap), None, "src/repro_torch/csrc/hitfind.cu",
         "src/repro/kernels/hitfind/kernel.py:40", "recon", hit_err),
        ("rasterize_pallas", raster_case.kernel, raster_case.plain, 1,
         raster_case.bound(), None, "src/repro_torch/csrc/rasterize.cu",
         "src/repro/kernels/rasterize/kernel.py:78", "rasterize",
         raster_err))
    for (name, fn, plain, plain_iters, (bound_ms, bound_by), library,
         source, replaces, run, err) in timed:
        ms, rounds = wrapper_ms(fn)
        plain_ms = cuda_time(plain, iters=plain_iters, warmup=1)
        library_ms = wrapper_ms(library)[0] if library else None
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[run][name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms})
        lib_text = (f"library call index_put_(accumulate=True) "
                    f"{library_ms:.4f} ms" if library else
                    "library call: none (no single PyTorch call computes "
                    "this function)")
        print(f"{name}: {ms:.4f} ms/call of the wrapper (median of 5 rounds "
              f"of 20 calls, CUDA events; rounds {rounds[0]:.4f}.."
              f"{rounds[-1]:.4f} ms); plain {plain_ms:.3f} ms (mean of "
              f"{plain_iters}); bound {bound_ms:.4f} ms ({bound_by}); "
              f"{lib_text}; launches on the main path "
              f"{launches[run][name]}", flush=True)
    unfluct_ms = wrapper_ms(lambda: raster_case.kernel(False))[0]
    print(f"rasterize_pallas without fluctuation: {unfluct_ms:.4f} ms/call, "
          f"bound {raster_case.bound(False)[0]:.4f} ms "
          f"({raster_case.bound(False)[1]})", flush=True)
    print(f"fused work (entries, in-support pixels, row+column weights): "
          f"one plane {main_case.work()}, three planes {multi_case.work()}; "
          f"scatter-add (entries, in-tile pixels) {scatter_case.work()}")

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
