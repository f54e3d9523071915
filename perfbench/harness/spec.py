"""Where a cell's pieces live, found by the names in ``BENCHMARK.json``.

- a configuration: the ``file`` its entry names (``perfbench/configs``);
- a traffic mix: ``perfbench/traffic/<traffic>.json``, whose ``kind``
  names the general generator that reads it, ``perfbench/drivers/<kind>.py``;
- the limits of a cell's correctness checks: ``perfbench/limits/<cell>.json``;
- a per-layer metric's reader: ``perfbench/metrics/<metric>.py``;
- a configuration's plain reference: ``perfbench/reference/<reference>.py``.

A later change adds a configuration, a mix, a cell or a metric by adding
such files and entries; no file here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str | None = None) -> ModuleType:
    """Import the Python file ``path`` (its name may hold dots)."""
    name = name or "perfbench_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot import {path}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with everything it names loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    root: Path

    @property
    def driver_path(self) -> Path:
        return self.root / "perfbench" / "drivers" / f"{self.traffic['kind']}.py"

    @property
    def reference_path(self) -> Path:
        return self.root / "perfbench" / "reference" / f"{self.config['reference']}.py"

    def reader_path(self, metric: str) -> Path:
        return self.root / "perfbench" / "metrics" / f"{metric}.py"


def _reported_by(metric: dict, cell: str, e2e_names: set[str] | None) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    list, else every cell (an end-to-end metric, ``e2e_names`` None) or
    every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def find_cell(bench: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``bench`` (BENCHMARK.json's content)."""
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r}; have {sorted(by_name)}")
    entry = by_name[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[entry["config"]]["file"])
    traffic = load_json(root / "perfbench" / "traffic" / f"{entry['traffic']}.json")
    limits = load_json(root / "perfbench" / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if _reported_by(m, name, None)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reported_by(m, name, e2e_names)]
    return Cell(name=name, chips=int(entry["chips"]), config=config, traffic=traffic,
                limits=limits, end_to_end=e2e, per_layer=per_layer, root=root)
