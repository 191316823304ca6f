"""Find a cell and everything it names, by name.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix.  Each
lives in a file of its own under this directory, and so do the limits of
the cell's correctness check and each metric's reader:

    configs/<config>.json    the transform, its entry point and its source
    traffic/<mix>.json       how the window calls it (traffic.py reads it)
    limits/<cell>.json       the limit of each number compared (check.py)
    metrics/<metric>.py      ``read(readings) -> float | None``
    entries/<entry>.py       ``build(config, traffic, devices) -> target``
    references/<ref>.py      the plain reference the check compares with

Adding one of them is adding a file; no file here lists them.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path

from perfbench.traffic import Traffic

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: Traffic
    limits: dict            # number compared -> its limit


def _load(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    with open(REPO / "BENCHMARK.json") as f:
        return json.load(f)


def load_cell(workload: str, bench: dict | None = None) -> Cell:
    bench = bench or benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    return make_cell(workload, entry["config"], entry["traffic"],
                     int(entry["chips"]))


def make_cell(name: str, config: str, traffic: str, chips: int) -> Cell:
    """The cell ``name`` of configuration ``config`` under mix
    ``traffic``, from their files."""
    limits = {k: float(v["limit"]) for k, v in _load("limits", name).items()
              if isinstance(v, dict)}
    return Cell(name=name, chips=chips, config=_load("configs", config),
                traffic=Traffic.from_dict(_load("traffic", traffic)),
                limits=limits)


def cell_metrics(bench: dict, workload: str, traced: bool) -> list[dict]:
    """The metrics a run of ``workload`` reports: its end-to-end metrics
    untraced, its per-layer metrics traced.  A metric with a
    ``workloads`` key belongs only to the cells it lists."""
    group = bench["per_layer" if traced else "end_to_end"]
    return [m for m in group
            if workload in m.get("workloads", (workload,))]


def module(kind: str, name: str):
    """``perfbench.<kind>.<name>``: an entry, a reference or a metric."""
    return importlib.import_module(f"perfbench.{kind}.{name}")
