"""Executors to put in the program's place, for the control and the
faults the comparison has to catch. None of them runs in a benchmark run.

``reference_executor`` is the control: the plain reference, computing in
bfloat16 (the precision below the configuration's float32), driven by the
launcher as the program's executor is. ``half_batch`` and ``altered`` break
the program's own executor underneath the launcher.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class Output(NamedTuple):
    """The fields of an executor's output that the launcher and the
    benchmark read."""

    adc: torch.Tensor
    signal: Optional[torch.Tensor] = None
    charge_grid: Optional[torch.Tensor] = None
    dropped: Optional[torch.Tensor] = None
    decon: Optional[torch.Tensor] = None
    hits: Optional[tuple] = None
    finite_ok: Optional[torch.Tensor] = None


class HitRows(NamedTuple):
    wire: torch.Tensor
    tick: torch.Tensor
    charge: torch.Tensor
    peak: torch.Tensor
    mask: torch.Tensor
    n_hits: torch.Tensor


def _hit_rows(hits, cap: int, device) -> HitRows:
    """Per-plane reference hits in the program's fixed-capacity layout
    (P, cap), the first ``cap`` of each plane stored."""
    cols = {k: [] for k in HitRows._fields}
    for h in hits:
        n = min(len(h.wire), cap)
        pad = cap - n
        for name, x, dtype in (("wire", h.wire, torch.int32),
                               ("tick", h.tick, torch.float32),
                               ("charge", h.charge, torch.float32),
                               ("peak", h.peak, torch.float32)):
            cols[name].append(torch.cat([x[:n].to(dtype), torch.zeros(
                pad, dtype=dtype, device=device)]))
        cols["mask"].append(torch.arange(cap, device=device) < n)
        cols["n_hits"].append(torch.tensor(len(h.wire), dtype=torch.int32,
                                           device=device))
    return HitRows(**{k: torch.stack(v) for k, v in cols.items()})


def reference_executor(cell, ref_cfg: dict, device,
                       dtype=torch.bfloat16):
    """``sim(keys, batch)``: each event of the batch by the plain
    reference from the launcher's key and depos, held in ``dtype``."""
    from plainref import lartpc

    det = lartpc.Detector(ref_cfg, device, recon=cell.recon)
    cap = int(ref_cfg["max_hits"])

    def sim(keys, batch):
        adcs, hits = [], []
        for e in range(batch.wire.shape[0]):
            n = int(batch.n_depos[e])
            key = tuple(int(v) for v in keys[e].tolist())
            depos = [lartpc.Depos(*(getattr(batch, f)[e, p, :n].to(device)
                                    for f in lartpc.Depos._fields))
                     for p in range(batch.wire.shape[1])]
            adc = lartpc.simulate(det, key, depos,
                                  add_noise=cell.add_noise, dtype=dtype)
            adcs.append(adc)
            if cell.recon:
                hits.append(_hit_rows(lartpc.recon(det, adc, dtype), cap,
                                      device))
        n_ev = len(adcs)
        return Output(
            adc=torch.stack(adcs),
            dropped=torch.zeros(n_ev, dtype=torch.int64, device=device),
            hits=(HitRows(*(torch.stack(x) for x in zip(*hits)))
                  if hits else None))

    return sim


def half_batch(sim):
    """The program's executor with the second half of every batch left
    out: those rows repeat the first half's outputs."""

    def broken(keys, batch):
        out = sim(keys, batch)
        n = out.adc.shape[0]
        keep = max(n - n // 2, 1)
        rows = torch.arange(n, device=out.adc.device) % keep

        def take(x):
            if x is None:
                return None
            if isinstance(x, torch.Tensor):
                return x[rows.to(x.device)] if x.dim() else x
            return type(x)(*(take(v) for v in x))

        return type(out)(*(take(v) for v in out))

    return broken


def altered(sim, what: str = "adc"):
    """The program's executor with every event's answer altered where it
    is produced: the waveform of one wire of each plane moved by 7 counts
    (``adc``), or every stored hit's charge raised by 1 % (``hit``)."""

    def broken(keys, batch):
        out = sim(keys, batch)
        if what == "adc":
            adc = out.adc.clone()
            adc[..., adc.shape[-2] // 2, :] += 7
            return out._replace(adc=adc)
        hits = out.hits
        return out._replace(hits=hits._replace(charge=hits.charge * 1.01))

    return broken
