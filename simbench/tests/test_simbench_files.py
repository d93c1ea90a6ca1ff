"""The benchmark's files: cells, configurations, traffic and metric readers
are found by name, and a traffic mix or a metric added as a file is found
with no edit."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for path in (str(BENCH), str(ROOT / "src")):
    if path not in sys.path:
        sys.path.insert(0, path)

from lartpcbench import cells, metrics  # noqa: E402

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCHMARK["workloads"]]
METRICS = BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_by_name(name):
    cell = cells.load_cell(name)
    assert cell.batch_events >= 1
    assert cell.limits
    fields = cells.fields(cell)
    assert fields["num_depos"] == cell.traffic["num_depos"]
    assert "auto" not in {v for v in fields.values() if isinstance(v, str)}


@pytest.mark.parametrize("name", CELLS)
def test_program_config_takes_every_field(name):
    cell = cells.load_cell(name)
    cfg = cells.program_config(cell)
    for key, value in cells.fields(cell).items():
        got = getattr(cfg, key)
        assert (list(got) if isinstance(got, tuple) else got) == value, key


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        cells.load_cell("no-such-cell")


@pytest.mark.parametrize("metric", METRICS, ids=[m["name"] for m in METRICS])
def test_every_metric_has_a_reader(metric):
    assert callable(metrics.reader(metric["name"]))


def test_added_files_are_found_without_an_edit(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(BENCH, root / "simbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    first = bench["workloads"][0]
    traffic = json.loads((BENCH / "traffic" / f"{first['traffic']}.json")
                         .read_text())
    traffic["num_depos"] = 12345
    (root / "simbench" / "traffic" / "sparse.json").write_text(
        json.dumps(traffic))
    bench["workloads"].append(dict(first, name="added.sparse",
                                   traffic="sparse"))
    (root / "simbench" / "cells" / "added.sparse.json").write_text(
        (BENCH / "cells" / f"{first['name']}.json").read_text())
    (root / "simbench" / "metrics" / "added_metric.py").write_text(
        "def read(ctx):\n    return ctx['window'].events * 2.0\n")
    bench["per_layer"].append({
        "name": "added_metric", "unit": "events", "better": "higher",
        "source": "host_clock", "layer": "streaming launcher",
        "moves": "events_per_s", "workloads": ["added.sparse"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = cells.load_cell("added.sparse", root=root)
    assert cells.fields(cell)["num_depos"] == 12345

    class Window:
        events = 7

    entries = metrics.for_cell(bench["per_layer"], "added.sparse")
    assert [m["name"] for m in entries][-1] == "added_metric"
    got = metrics.read_all([entries[-1]], {"window": Window()},
                           root=root / "simbench")
    assert got == {"added_metric": {"value": 14.0, "unit": "events"}}


def test_metrics_without_workloads_go_to_every_cell():
    entries = [{"name": "a"}, {"name": "b", "workloads": ["x"]}]
    assert [m["name"] for m in metrics.for_cell(entries, "y")] == ["a"]
    assert [m["name"] for m in metrics.for_cell(entries, "x")] == ["a", "b"]
