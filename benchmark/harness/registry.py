"""Find a cell's files by name: ``workloads/<cell>.json`` names its
configuration (``configs/<config>.json``), its driver and its task
(``tasks/<task>.py``); the configuration names its generator
(``gen/<generator>.py``); each per-layer metric of ``BENCHMARK.json`` has
its reader in ``metrics/<metric>.py``.  A new cell, configuration or
metric is new files and new entries, never an edit of these."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import types

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
SPEC = os.path.join(ROOT, "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    end_to_end: list  # BENCHMARK.json entries this cell reports
    per_layer: list


def _json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def spec() -> dict:
    with open(SPEC) as f:
        return json.load(f)


def _applies(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load_cell(name: str, overrides: dict | None = None) -> Cell:
    """The cell ``name`` with its configuration and the metrics it
    reports; ``overrides`` (``{"workload": {...}, "config": {...}}``)
    replaces keys, for tests at small sizes."""
    overrides = overrides or {}
    workload = {**_json("workloads", f"{name}.json"),
                **overrides.get("workload", {})}
    config = {**_json("configs", f"{workload['config']}.json"),
              **overrides.get("config", {})}
    bench = spec()
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, names)]
    return Cell(name, workload, config, e2e, per_layer)


def task(cell: Cell) -> types.ModuleType:
    return importlib.import_module(f"benchmark.tasks.{cell.workload['task']}")


def generator(cell: Cell) -> types.ModuleType:
    return importlib.import_module(f"benchmark.gen.{cell.config['generator']}")


def metric_reader(name: str) -> types.ModuleType:
    """``metrics/<name>.py``, loaded by path (metric names hold dots)."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    mod_name = "benchmark.metrics." + name.replace(".", "__")
    spec_ = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod
