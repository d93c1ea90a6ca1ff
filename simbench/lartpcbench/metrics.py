"""Metric readers, one file each under ``simbench/metrics/``, found by the
metric's name in ``BENCHMARK.json``.

A reader is a module with ``read(ctx) -> float | None``. ``ctx`` holds
what the run measured:

``window``    the ``window.WindowStats`` of the measured window
``setup_s``   seconds from the process's start to the window's
``cfg``       the cell's fields (the plain reference's configuration dict)
``cell``      the ``cells.Cell``
``counts``    {stage: (operations, bytes)} of one event (``counts.py``)
``stages``    {stage: seconds} of one event, stage by stage (traced runs)
``trace``     the reduced profile of one traced chunk (traced runs)

A reader that finds nothing to read returns None, and the metric is left
out of the result.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Dict, Iterable, Optional

from lartpcbench.cells import BENCH


def reader(name: str, root: Optional[Path] = None):
    path = (root or BENCH) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"simbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def for_cell(entries: Iterable[dict], cell_name: str) -> list:
    """The metric entries of ``BENCHMARK.json`` that this cell reports."""
    return [m for m in entries
            if cell_name in m.get("workloads", [cell_name])]


def read_all(entries: Iterable[dict], ctx: dict,
             root: Optional[Path] = None) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of every entry whose reader finds a
    value."""
    out = {}
    for m in entries:
        value = reader(m["name"], root)(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
