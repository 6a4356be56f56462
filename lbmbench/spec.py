"""A cell as ``BENCHMARK.json`` names it, resolved to the benchmark's data
files by name alone:

- ``lbmbench/configs/<config>.json``: the deployment (params, mask
  recipe, source, ``assumed``, ``reduced``);
- ``lbmbench/traffic/<traffic>.json``: the mix, as ``scenes.py`` makes
  it;
- ``lbmbench/cells/<workload>.json``: how many scenes a run checks
  against the reference, and each compared number's limit with the
  readings it was set from;
- ``lbmbench/metrics/<metric>.py``: one reader a per-layer metric, a
  function ``read(record)`` that returns a number or None.

A later cell, configuration or metric is new files and new entries in
``BENCHMARK.json``; nothing here names one. A mix of another kind than
whole published scenes needs the generator to read its parameters.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
BENCHMARK = HERE.parent / "BENCHMARK.json"


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    check: dict
    end_to_end: list
    per_layer: list

    @property
    def name(self) -> str:
        return self.workload["name"]


def _read(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_benchmark(path: Path = BENCHMARK) -> dict:
    return _read(path)


def _applies(metric: dict, name: str) -> bool:
    return name in metric.get("workloads", [name])


def resolve(name: str, bench: dict | None = None, root: Path = HERE) -> Cell:
    """The cell ``name`` of ``bench`` (default: ``BENCHMARK.json``) with
    its files read from ``root``; a name that resolves to nothing
    raises."""
    bench = load_benchmark() if bench is None else bench
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r}; known: {sorted(by_name)}")
    w = by_name[name]
    return Cell(
        workload=w,
        config=_read(root / "configs" / f"{w['config']}.json"),
        traffic=_read(root / "traffic" / f"{w['traffic']}.json"),
        check=_read(root / "cells" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def reader(metric: str, root: Path = HERE):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = root / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"lbmbench_metric_{metric.replace('.', '_').replace('-', '_')}", path)
    if spec is None:
        raise FileNotFoundError(f"no reader for metric {metric!r} at {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
