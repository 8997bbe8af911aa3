"""Checkouts for the CPU tests: a copy of the benchmark's folder and
BENCHMARK.json in a temporary directory, with configurations, traffic
mixes and workload entries added as files and entries alone; and the tiny
cells that most tests run."""

from __future__ import annotations

import json
import os
import shutil

from gpubench import cells

TINY_CONFIG = {
    "name": "tiny",
    "source": "a CPU test's own",
    "flags": {"kmerLength": 31, "canonical": True, "gpuMemoryLimit": 8_000_000, "readsPerChunk": 300,
              "tableImpl": "two"},
    "reduced": [],
}
# Each tiny configuration's flags beside TINY_CONFIG's.  tiny55f: k=55 on
# the forward strand keeps 4 key lanes, so the two-level raw sort takes two
# digits; at this budget the table has 66,666 slots and a chunk 13,800
# windows, so the mini mix's 9 chunks take 3 consolidations (after 4, 8
# and 9 chunks) and the prefix grows twice.
TINY_FLAGS = {
    "tiny": {},
    "tiny1": {"tableImpl": "one"},
    "tiny55f": {"kmerLength": 55, "canonical": False},
}
TINY_TRAFFIC = {"genome_length": 3000, "reads": 2000, "read_length": 100, "substitution_share": 0.01,
                "n_share": 0.001, "files": 3}


def checkout_with(root, configs: dict, workloads: list, traffic: dict | None = None, like: str | None = None) -> str:
    """A checkout at ``root``: the benchmark's folder and BENCHMARK.json,
    with each of ``configs`` (name -> the file's contents) written as
    ``configs/<name>.json`` and given an entry, each of ``traffic`` (name ->
    parameters) as ``traffic/<name>.json``, and each of ``workloads`` (the
    entries, whole) added; the new cells join every per-layer metric that
    lists ``like``, or every one when ``like`` is None.  Returns root."""
    root = str(root)
    shutil.copytree(cells.BENCH_DIR, os.path.join(root, "gpubench"),
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    with open(os.path.join(cells.ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    for name, config in configs.items():
        with open(os.path.join(root, "gpubench", "configs", f"{name}.json"), "w") as fh:
            json.dump(config, fh)
        bench["configs"].append({"name": name, "source": config["source"], "file": f"gpubench/configs/{name}.json",
                                 "reduced": config["reduced"], "why": "tests"})
    for name, params in (traffic or {}).items():
        with open(os.path.join(root, "gpubench", "traffic", f"{name}.json"), "w") as fh:
            json.dump(params, fh)
    bench["workloads"] += workloads
    for m in bench["per_layer"]:
        if like is None or like in m["workloads"]:
            m["workloads"] = m["workloads"] + [w["name"] for w in workloads]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    return root


def tiny_checkout(root) -> str:
    """A checkout at ``root`` whose BENCHMARK.json has the cells
    ``<name>.mini`` of TINY_FLAGS, on the mix ``mini``, added by files and
    entries alone, each in every per-layer metric's workloads; returns
    root."""
    configs = {name: dict(TINY_CONFIG, name=name, flags=dict(TINY_CONFIG["flags"], **flags))
               for name, flags in TINY_FLAGS.items()}
    workloads = [{"name": f"{name}.mini", "config": name, "traffic": "mini", "chips": 1, "why": "tests"}
                 for name in TINY_FLAGS]
    return checkout_with(root, configs, workloads, {"mini": TINY_TRAFFIC})
