"""The comparison that decides ``correct``, on the CPU at the simulator's
smoke sizes: the plain reference agrees with the streaming launcher's
output for both configurations; the control (the reference computing in
bfloat16 in the program's place) and each fault planted under the launcher
come out as not correct."""
from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for path in (str(BENCH), str(ROOT / "src")):
    if path not in sys.path:
        sys.path.insert(0, path)

from lartpcbench import cells, check, control, session  # noqa: E402

FULL = "uboone-full.cosmics"
SIGNAL = "uboone-signal.cosmics"
SEED = 2**31 + 9


def _run(name, **kw):
    return session.run(cells.load_cell(name), SEED, 0.3, False,
                       time.perf_counter(), device="cpu", smoke=True,
                       sample=64, **kw)


@pytest.mark.parametrize("name", [FULL, SIGNAL])
def test_reference_agrees_with_the_stream(name):
    result = _run(name)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= cells.load_cell(name).batch_events
    assert result["failed"] == 0
    numbers = {k: v["value"] for k, v in result["checks"].items()}
    assert numbers["adc_off2_ppm"] == 0.0
    if name == FULL:
        assert numbers["hit_unmatched_frac"] == 0.0


@pytest.mark.parametrize("name", [FULL, SIGNAL])
def test_control_is_not_correct(name):
    result = _run(name, executor=control.reference_executor)
    assert not result["correct"]
    numbers = {k: v["value"] for k, v in result["checks"].items()}
    assert numbers["adc_diff_ppm"] > result["checks"]["adc_diff_ppm"][
        "limit"]


@pytest.mark.parametrize("name,fault", [
    (SIGNAL, "half_batch"), (SIGNAL, "adc"), (FULL, "adc"), (FULL, "hit")])
def test_fault_is_not_correct(name, fault):
    if fault == "half_batch":
        wrap = control.half_batch
    else:
        def wrap(sim):
            return control.altered(sim, fault)
    result = _run(name, wrap=wrap)
    assert not result["correct"], result["checks"]


def test_hit_mismatch_counts_both_sides():
    ref = {"wire": np.array([1, 1, 2]), "tick": np.array([10.0, 50.0, 7.0]),
           "charge": np.array([900.0, 800.0, 700.0]),
           "peak": np.array([300.0, 200.0, 100.0])}
    same = {k: v.copy() for k, v in ref.items()}
    assert check.hit_mismatch(same, ref, 100) == (0, 3)
    moved = {k: v.copy() for k, v in ref.items()}
    moved["charge"][1] *= 1.01
    assert check.hit_mismatch(moved, ref, 100) == (2, 3)
    fewer = {k: v[:2] for k, v in ref.items()}
    assert check.hit_mismatch(fewer, ref, 100) == (1, 3)
    empty = {k: v[:0] for k, v in ref.items()}
    assert check.hit_mismatch(empty, ref, 100) == (3, 3)


def test_verdict_needs_every_number_under_its_limit():
    limits = {"a": 1.0, "b": 2.0}
    assert check.verdict({"a": 1.0, "b": 0.0}, limits)
    assert not check.verdict({"a": 1.5, "b": 0.0}, limits)
    assert not check.verdict({"a": 0.0}, limits)


def _nudged_executor(cell, ref_cfg, device):
    """The plain reference in float32 in the program's place, each ADC
    raised by one count at the first hits of every plane before its own
    hits are found: an ADC under both ADC limits that moves the hits."""
    from plainref import lartpc

    det = lartpc.Detector(ref_cfg, device, recon=cell.recon)
    cap = int(ref_cfg["max_hits"])

    def sim(keys, batch):
        adcs, hits = [], []
        for e in range(batch.wire.shape[0]):
            n = int(batch.n_depos[e])
            key = tuple(int(v) for v in keys[e].tolist())
            depos = [lartpc.Depos(*(getattr(batch, f)[e, p, :n]
                                    for f in lartpc.Depos._fields))
                     for p in range(batch.wire.shape[1])]
            adc = lartpc.simulate(det, key, depos, add_noise=cell.add_noise)
            for p, h in enumerate(lartpc.recon(det, adc)):
                w, t = h.wire[:20].long(), h.tick[:20].round().long()
                adc[p, w, t] += 1
            adcs.append(adc)
            hits.append(control._hit_rows(lartpc.recon(det, adc), cap,
                                          device))
        return control.Output(
            adc=torch.stack(adcs),
            dropped=torch.zeros(len(adcs), dtype=torch.int64, device=device),
            hits=control.HitRows(*(torch.stack(x) for x in zip(*hits))))

    return sim


def test_adc_moved_under_its_limits_shows_in_the_hits():
    result = _run(FULL, executor=_nudged_executor)
    checks = {k: v["value"] for k, v in result["checks"].items()}
    limits = cells.load_cell(FULL).limits
    assert 0 < checks["adc_diff_ppm"] <= limits["adc_diff_ppm"]
    assert checks["adc_off2_ppm"] == 0.0
    assert checks["hit_unmatched_frac"] > limits["hit_unmatched_frac"]
    assert not result["correct"]
