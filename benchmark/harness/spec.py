"""What a run measures, found by name from `BENCHMARK.json`.

Everything that belongs to one configuration, one traffic mix, one cell
or one metric is a file of its own under the benchmark's folder, found by
the name that `BENCHMARK.json` gives it:

- a configuration: the `file` of its `configs` entry (JSON: the scene, the
  image size, the depth, its source);
- a traffic mix: `traffic/<traffic>.json` (the call each step makes:
  `render`, the default, or `grad_step`; the samples per pixel, the
  options, how many calls the check and the traced slice take);
- a cell: `cells/<workload>.json` (why it exists, the limits of its
  correctness check with the readings they were set from, its seeds);
- a metric: `metrics/<name>.py`, a module with `read(run)` that returns
  the metric's value, or None where it finds nothing to read.

A later cell, mix or metric is new files and new entries, never an edit.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    better: str
    source: str
    end_to_end: bool
    moves: str | None = None
    workloads: tuple | None = None

    def applies(self, cell: str, reported: set) -> bool:
        """Whether a run of `cell` reports this metric: the cells it lists,
        or, without a list, every cell that reports what it moves (an
        end-to-end metric without a list: every cell)."""
        if self.workloads is not None:
            return cell in self.workloads
        return self.end_to_end or self.moves in reported


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    notes: dict
    end_to_end: list
    per_layer: list
    root: str = ROOT


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def _metrics(entries, end_to_end: bool) -> list:
    return [Metric(name=e["name"], unit=e["unit"], better=e["better"],
                   source=e["source"], end_to_end=end_to_end,
                   moves=e.get("moves"),
                   workloads=(tuple(e["workloads"]) if "workloads" in e
                              else None))
            for e in entries]


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell `name` of `root/BENCHMARK.json` with its files; KeyError
    if the benchmark has no such cell."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(os.path.join(root, configs[w["config"]]["file"]))
    bench_dir = os.path.join(root, bench["paths"][0])
    traffic = _load_json(os.path.join(bench_dir, "traffic",
                                      f"{w['traffic']}.json"))
    notes = _load_json(os.path.join(bench_dir, "cells", f"{name}.json"))
    e2e = [m for m in _metrics(bench["end_to_end"], True)
           if m.applies(name, set())]
    reported = {m.name for m in e2e}
    layer = [m for m in _metrics(bench["per_layer"], False)
             if m.applies(name, reported)]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, notes=notes, end_to_end=e2e,
                per_layer=layer, root=root)


def metric_reader(name: str, root: str = ROOT):
    """The `read(run)` of `metrics/<name>.py` under the benchmark's
    folder (the module is loaded from its file: metric names hold dots)."""
    bench = load_benchmark(root)
    path = os.path.join(root, bench["paths"][0], "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
