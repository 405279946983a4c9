"""Finds what `BENCHMARK.json` names: a cell's configuration
(`configs/<config>.json`), its traffic (`workloads/<cell>.json`) and a
metric's reader (`metrics/<metric>.py`). Adding one is adding a file."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str) -> tuple[dict, dict]:
    """(the cell's entry in BENCHMARK.json, its parameters): the
    configuration's file with the cell's traffic file laid over it."""
    bench = benchmark()
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json (cells: {sorted(entries)})")
    entry = entries[name]
    config = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    params = _load(ROOT / config["file"])
    params.update(_load(HERE / "workloads" / f"{name}.json"))
    return entry, params


def metrics_of(cell_name: str, kind: str) -> list[dict]:
    """The metrics of `kind` ("end_to_end" or "per_layer") that the cell
    reports: those without a "workloads" key, and those that list it."""
    return [m for m in benchmark()[kind] if cell_name in m.get("workloads", [cell_name])]


def reader(metric: str):
    """`read(run) -> float | None` of `metrics/<metric>.py`."""
    path = HERE / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read
