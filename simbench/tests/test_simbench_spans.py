"""The readers of the program's spans (``lartpcbench.program_spans`` and
the metrics that use it), on the CPU: each gives the per-batch mean of a
recorder filled by hand, None when nothing was recorded or the program has
no span layer, and, over a smoke-size chunk of each cell run under a CPU
``torch.profiler`` as the traced run runs it, host values and no card
value."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for path in (str(BENCH), str(ROOT / "src")):
    if path not in sys.path:
        sys.path.insert(0, path)

from lartpcbench import cells, metrics, window  # noqa: E402
from repro_torch import spans  # noqa: E402

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
#: the metrics that read the program's recorder
SPAN_METRICS = ["wait_ms.launcher", "wait_ms.executor", "host_syncs",
                "launcher_ms.generate", "launcher_ms.validate",
                "launcher_ms.pack", "span_ms.launcher",
                "span_ms.charge_grid", "span_ms.convolve", "span_ms.noise",
                "span_ms.recon"]
HOST = SPAN_METRICS[:6]
CARD = SPAN_METRICS[6:]

#: what the hand-filled recorder below gives each metric, a batch
EXPECTED = {"wait_ms.launcher": (5 + 3 + 7 + 9) / 2,
            "wait_ms.executor": (1 + 2) / 2,
            "host_syncs": 2 * (1 + 2 + 1) / 2,
            "launcher_ms.generate": (10 + 12) / 2,
            "launcher_ms.validate": (4 + 2) / 2,
            "launcher_ms.pack": (1 + 1 + 1 + 2) / 2,
            "span_ms.launcher": 9.0,
            "span_ms.charge_grid": 20.0 / 2, "span_ms.convolve": 6.0 / 2,
            "span_ms.noise": 80.0 / 2, "span_ms.recon": (14.0 + 2.0) / 2}


def _rec(name, batch, ms, parent=None, root=None, self_ms=None, reads=0):
    ns = int(ms * 1e6)
    own = ns if self_ms is None else int(self_ms * 1e6)
    return spans.Record(name, batch, parent, root or name, 0, ns, own,
                        reads, reads > 0)


def hand_filled() -> spans.Recorder:
    rec = spans.Recorder()
    for b, (gen, val, copy, flags) in enumerate([(10, 4, 5, 7),
                                                 (12, 2, 3, 9)]):
        rec.records += [
            _rec("sim.generate", b, gen),
            _rec("sim.validate.copy", b, copy, "sim.validate",
                 "sim.validate", reads=1),
            _rec("sim.validate", b, val + copy, self_ms=val),
            _rec("sim.pack", b, 1), _rec("sim.pack", b, b + 1),
            _rec("sim.bin.mask", b, b + 1, "sim.stage.charge_grid",
                 "sim.dispatch", reads=2),
            _rec("sim.dispatch", b, 40, self_ms=1),
            _rec("sim.finish.flags", b, flags, "sim.finish", "sim.finish",
                 reads=1),
            _rec("sim.finish", b, flags + 1, self_ms=1)]
    rec.device_ms = {"sim.stage.charge_grid": 20.0, "sim.stage.convolve": 6.0,
                     "sim.stage.noise": 80.0, "sim.stage.deconvolve": 14.0,
                     "sim.stage.hit_find": 2.0, spans.GAP: 9.0}
    rec.device_calls = {k: 2 for k in rec.device_ms}
    rec.device_calls[spans.GAP] = 1
    return rec


@pytest.fixture
def recorder(monkeypatch):
    rec = spans.Recorder()
    monkeypatch.setattr(spans, "RECORDER", rec)
    return rec


def test_span_metrics_are_listed_with_their_cells():
    entries = {m["name"]: m for m in BENCHMARK["per_layer"]}
    both = ["uboone-full.cosmics", "uboone-signal.cosmics"]
    for name in SPAN_METRICS:
        m = entries[name]
        assert m["moves"] == "events_per_s"
        assert m["source"] == ("device_trace" if name in CARD
                               else "host_clock")
        assert m["workloads"] == (["uboone-full.cosmics"] if name in (
            "span_ms.noise", "span_ms.recon") else both)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_reader_gives_the_per_batch_mean(name, recorder, monkeypatch):
    monkeypatch.setattr(spans, "RECORDER", hand_filled())
    assert metrics.reader(name)({}) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_reader_gives_none_when_nothing_was_recorded(name, recorder):
    assert metrics.reader(name)({}) is None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_reader_gives_none_without_the_span_layer(name, monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    assert metrics.reader(name)({}) is None


@pytest.mark.parametrize("cell_name", [w["name"]
                                       for w in BENCHMARK["workloads"]])
def test_traced_chunk_records_host_values_and_no_card_value(cell_name,
                                                            recorder):
    import torch
    from torch.profiler import ProfilerActivity, profile

    cell = cells.load_cell(cell_name)
    cfg = cells.program_config(cell, smoke=True)
    sim = window.build_program(cell, cfg, torch.device("cpu"))
    streamer = window.Streamer(cell, cfg, sim, torch.device("cpu"))
    streamer.chunk(window.chunk_seed(2**33 + 5, "warmup"), 1, None)
    assert recorder.records == []
    with profile(activities=[ProfilerActivity.CPU]):
        streamer.chunk(window.chunk_seed(2**33 + 5, "traced"), 2, None)
    entries = metrics.for_cell(
        [m for m in BENCHMARK["per_layer"] if m["name"] in SPAN_METRICS],
        cell_name)
    got = metrics.read_all(entries, {})
    assert sorted(got) == sorted(m["name"] for m in entries
                                 if m["name"] in HOST)
    assert got["host_syncs"]["value"] == (1 + 2 * 3 * cell.batch_events + 1
                                          + cell.recon)
    assert all(v["value"] >= 0 for v in got.values())
