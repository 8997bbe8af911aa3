"""A tiny cell for the CPU tests: a copy of the benchmark's folder and
BENCHMARK.json in a temporary checkout, with a configuration, a traffic
mix and a workload entry added as files and entries alone."""

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
TINY_TRAFFIC = {"genome_length": 3000, "reads": 2000, "read_length": 100, "substitution_share": 0.01,
                "n_share": 0.001, "files": 3}


def tiny_checkout(root, table: str = "two") -> str:
    """A checkout at ``root`` whose BENCHMARK.json has the cell ``tiny.mini``
    (and ``tiny1.mini`` on the one-level table) added by files and entries
    alone; returns root."""
    root = str(root)
    shutil.copytree(cells.BENCH_DIR, os.path.join(root, "gpubench"),
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    with open(os.path.join(cells.ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    for name, impl in (("tiny", "two"), ("tiny1", "one")):
        config = dict(TINY_CONFIG, name=name, flags=dict(TINY_CONFIG["flags"], tableImpl=impl))
        with open(os.path.join(root, "gpubench", "configs", f"{name}.json"), "w") as fh:
            json.dump(config, fh)
        bench["configs"].append({"name": name, "source": "a CPU test's own",
                                 "file": f"gpubench/configs/{name}.json", "reduced": [], "why": "tests"})
        bench["workloads"].append({"name": f"{name}.mini", "config": name, "traffic": "mini", "chips": 1,
                                   "why": "tests"})
    with open(os.path.join(root, "gpubench", "traffic", "mini.json"), "w") as fh:
        json.dump(TINY_TRAFFIC, fh)
    for m in bench["per_layer"]:
        m["workloads"] = m["workloads"] + ["tiny.mini", "tiny1.mini"]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    return root
