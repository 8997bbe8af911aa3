"""Every cell of BENCHMARK.json resolves to its files by name, the file
keeps to the benchmark's contract, and a cell added by files and entries
alone runs."""

import json
import os
import re

import pytest
import torch

from gpubench import cells, harness
from gpubench.tests._tiny import tiny_checkout

with open(os.path.join(cells.ROOT, "BENCHMARK.json")) as fh:
    BENCH = json.load(fh)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_to_its_files(workload):
    cell = cells.resolve(workload)
    w = next(x for x in BENCH["workloads"] if x["name"] == workload)
    assert workload == f"{w['config']}.{w['traffic']}"
    assert cell.config["name"] == w["config"]
    assert cell.chips == 1
    assert {m["name"] for m in cell.end_to_end} == {"kmers_per_s", "setup_s"}
    assert cell.per_layer and set(cell.readers) == {m["name"] for m in cell.per_layer}
    assert all(callable(r) for r in cell.readers.values())
    argv = cell.argv()
    assert "kmerLength=31" in argv and "canonical=true" in argv
    assert any(a.startswith("tableImpl=") for a in argv)


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpubench"] and BENCH["command"] == ["python3", "gpubench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[key]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("gpubench/") and os.path.exists(os.path.join(cells.ROOT, c["file"]))
        with open(os.path.join(cells.ROOT, c["file"])) as fh:
            assert json.load(fh)["reduced"] == c["reduced"] == []
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock" and UNIT.match(m["unit"])
    cell_names = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] == "kmers_per_s" and set(m["workloads"]) <= cell_names and UNIT.match(m["unit"])
        assert os.path.exists(os.path.join(cells.BENCH_DIR, "layer_metrics", f"{m['name']}.py"))
    for w in cell_names:  # every cell reports setup_s, another end-to-end metric and a per-layer one
        assert any(w in m["workloads"] for m in BENCH["per_layer"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_a_cell_added_by_files_and_entries_alone_runs(tmp_path):
    root = tiny_checkout(tmp_path / "checkout")
    cell = cells.resolve("tiny.mini", root)
    result = harness.run(cell, 7, 0.5, False, torch.device("cpu"), cache_dir=str(tmp_path / "cache"))
    assert result["correct"] is True and result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"kmers_per_s", "setup_s"}
