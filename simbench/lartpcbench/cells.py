"""Cells, configurations and traffic mixes, found by name.

``BENCHMARK.json`` (at the checkout's root) lists the cells. A cell names a
configuration and a traffic mix; its own parameters sit in
``simbench/cells/<cell>.json``. A configuration is the file its
``BENCHMARK.json`` entry names; a traffic mix is
``simbench/traffic/<traffic>.json``. Nothing here knows a cell by name, so
a cell, a configuration or a mix is added with files and entries alone.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

#: the benchmark's folder and the checkout it lies in
BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent

#: the simulator's smoke sizes (CPU tests): every width cut, as the
#: configuration's own smoke preset cuts it
SMOKE = {"num_wires": 128, "num_ticks": 512, "response_wires": 11,
         "response_ticks": 64, "num_depos": 256}


@dataclass(frozen=True)
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""

    name: str
    chips: int
    config: dict        # the configuration file
    traffic: dict       # the traffic file
    params: dict        # simbench/cells/<name>.json

    @property
    def batch_events(self) -> int:
        return int(self.params["batch_events"])

    @property
    def add_noise(self) -> bool:
        return bool(self.config["graph"]["add_noise"])

    @property
    def recon(self) -> bool:
        return bool(self.config["graph"]["recon"])

    @property
    def limits(self) -> Dict[str, float]:
        return dict(self.config["limits"])


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Optional[Path] = None) -> dict:
    return _read((root or ROOT) / "BENCHMARK.json")


def load_cell(name: str, root: Optional[Path] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` under ``root`` (default: this
    checkout); raises ``KeyError`` for a name it does not list."""
    root = root or ROOT
    bench = load_benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r}; known: {sorted(entries)}")
    w = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    return Cell(name=name, chips=int(w["chips"]),
                config=_read(root / configs[w["config"]]["file"]),
                traffic=_read(root / "simbench" / "traffic"
                              / f"{w['traffic']}.json"),
                params=_read(root / "simbench" / "cells" / f"{name}.json"))


def fields(cell: Cell, smoke: bool = False) -> dict:
    """The simulator's fields as the cell runs them: the configuration's,
    then the traffic's depos an event, then (``smoke``) the smoke sizes."""
    out = dict(cell.config["config"])
    out["num_depos"] = int(cell.traffic["num_depos"])
    if smoke:
        out.update(SMOKE)
    return out


def reference_config(cell: Cell, smoke: bool = False) -> dict:
    """What the plain reference reads: the fields and the fluctuation
    streams' tile size."""
    out = fields(cell, smoke)
    out.update(cell.config["streams"])
    return out


def program_config(cell: Cell, smoke: bool = False):
    """The simulator's ``LArTPCConfig`` of the cell: its registered
    ``lartpc-uboone`` configuration with every field of the file set."""
    from repro_torch.config import apply_overrides, get_config

    values = {k: tuple(v) if isinstance(v, list) else v
              for k, v in fields(cell, smoke).items()}
    return apply_overrides(get_config("lartpc-uboone"), values)
