"""Resolving a cell by name: ``BENCHMARK.json`` at the checkout's root
names each cell's configuration and traffic, and each file is found by
that name alone:

    configs/<config>.json          the CLI flags (and source, assumed, reduced)
    traffic/<traffic>.json         the generator's parameters
    layer_metrics/<metric>.py      one reader a per-layer metric

A later cell, mix or metric is added by files and entries, not code."""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


@dataclass
class Cell:
    """A workload of BENCHMARK.json with its configuration's and traffic's
    files read, its metrics and its per-layer readers."""

    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list[dict]
    per_layer: list[dict]
    readers: dict = field(default_factory=dict)  # per-layer metric name -> read(window)

    def argv(self, changed: dict | None = None) -> list[str]:
        """The configuration's CLI flags, with ``changed`` ones, as
        ``key=value`` arguments."""
        out = []
        for key, value in {**self.config["flags"], **(changed or {})}.items():
            if isinstance(value, bool):
                value = "true" if value else "false"
            out.append(f"{key}={value}")
        return out

    @property
    def flags(self) -> dict:
        return self.config["flags"]


def _load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_reader(bench_dir: str, metric: str):
    """``read`` of ``layer_metrics/<metric>.py``, loaded by its path."""
    path = os.path.join(bench_dir, "layer_metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"gpubench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def resolve(workload: str, root: str = ROOT) -> Cell:
    """The cell ``workload`` of ``<root>/BENCHMARK.json`` with its files."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (have {', '.join(sorted(cells))})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(os.path.join(root, configs[w["config"]]["file"]))
    bench_dir = os.path.join(root, os.path.basename(BENCH_DIR))
    traffic = _load_json(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json"))
    per_layer = [m for m in bench["per_layer"] if _applies(m, workload)]
    return Cell(
        name=workload,
        config=config,
        traffic=traffic,
        chips=int(w["chips"]),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=per_layer,
        readers={m["name"]: load_reader(bench_dir, m["name"]) for m in per_layer},
    )
