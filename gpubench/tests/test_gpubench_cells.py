"""Every cell of BENCHMARK.json resolves to its files by name, the file
keeps to the benchmark's contract, and a cell added by files and entries
alone, at any k, on either strand, on either chip count, passes both
checks and runs."""

import json
import os
import re

import pytest
import torch

from gpubench import cells, harness
from gpubench.tests._tiny import checkout_with, tiny_checkout

with open(os.path.join(cells.ROOT, "BENCHMARK.json")) as fh:
    BENCH = json.load(fh)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

# The first cell that the benchmark's open questions list: k=55 on the
# forward strand, 4 key lanes, on the two-level table and the ecoli mix.
K55F_CONFIG = {
    "name": "k55f_two",
    "source": "https://github.com/jsdjayanga/kmer-counter (the reference CLI's key=value flags); k=55, "
              "the largest k of SPAdes' default set for 100-150 bp reads",
    "flags": {"kmerLength": 55, "canonical": False, "gpuMemoryLimit": 8_000_000_000, "readsPerChunk": 262_144,
              "tableImpl": "two"},
    "reduced": [],
}
K55F_CELL = {"name": "k55f_two.ecoli", "config": "k55f_two", "traffic": "ecoli", "chips": 1,
             "why": "k=55 forward: 4 key lanes, a two-digit raw sort, the NL=4 kernels on the two-level path"}


def _flag(value) -> str:
    return ("true" if value else "false") if isinstance(value, bool) else str(value)


def check_cell(bench: dict, root: str, workload: str) -> None:
    """The cell resolves to its files, and its CLI flags are its
    configuration file's, in order, at a k and strand the program takes."""
    cell = cells.resolve(workload, root)
    w = next(x for x in bench["workloads"] if x["name"] == workload)
    assert workload == f"{w['config']}.{w['traffic']}"
    assert cell.config["name"] == w["config"]
    assert cell.chips == w["chips"] and cell.chips in (1, 4)
    assert {m["name"] for m in cell.end_to_end} == {"kmers_per_s", "setup_s"}
    assert cell.per_layer and set(cell.readers) == {m["name"] for m in cell.per_layer}
    assert all(callable(r) for r in cell.readers.values())
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    with open(os.path.join(root, entry["file"])) as fh:
        flags = json.load(fh)["flags"]
    assert cell.argv() == [f"{key}={_flag(value)}" for key, value in flags.items()]
    k = flags["kmerLength"]
    assert type(k) is int and 1 <= k <= 128
    assert isinstance(flags["canonical"], bool) and "tableImpl" in flags


def check_contract(bench: dict, root: str) -> None:
    """BENCHMARK.json at ``root`` keeps to the benchmark's contract."""
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["gpubench"] and bench["command"] == ["python3", "gpubench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for x in bench[key]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("gpubench/") and os.path.exists(os.path.join(root, c["file"]))
        with open(os.path.join(root, c["file"])) as fh:
            reduced = json.load(fh)["reduced"]
        assert isinstance(c["reduced"], list) and reduced == c["reduced"]
        assert len(reduced) <= 16 and all(NAME.match(key) for key in reduced)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
        assert w["chips"] in (1, 4)
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)
    for m in bench["end_to_end"]:
        assert set(m) == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock" and UNIT.match(m["unit"])
    cell_names = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] == "kmers_per_s" and set(m["workloads"]) <= cell_names and UNIT.match(m["unit"])
        assert os.path.exists(os.path.join(root, "gpubench", "layer_metrics", f"{m['name']}.py"))
    for w in cell_names:  # every cell reports setup_s, another end-to-end metric and a per-layer one
        assert any(w in m["workloads"] for m in bench["per_layer"])
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_to_its_files(workload):
    check_cell(BENCH, cells.ROOT, workload)


def test_benchmark_json_keeps_to_the_contract():
    check_contract(BENCH, cells.ROOT)


@pytest.mark.parametrize("chips,reduced", [(1, []), (4, ["readsPerChunk"])], ids=["one_chip", "four_chips_cut"])
def test_a_k55_forward_cell_added_by_files_and_entries_alone_keeps_to_the_contract(tmp_path, chips, reduced):
    config = dict(K55F_CONFIG, reduced=reduced)
    if reduced:
        config["flags"] = dict(config["flags"], readsPerChunk=65_536)
    root = checkout_with(tmp_path / "checkout", {"k55f_two": config}, [dict(K55F_CELL, chips=chips)],
                         like="k31c_two.ecoli_err")
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    check_contract(bench, root)
    for w in bench["workloads"]:
        check_cell(bench, root, w["name"])
    cell = cells.resolve("k55f_two.ecoli", root)
    assert "kmerLength=55" in cell.argv() and "canonical=false" in cell.argv()
    like = cells.resolve("k31c_two.ecoli_err", root)
    assert {m["name"] for m in cell.per_layer} == {m["name"] for m in like.per_layer}


@pytest.mark.parametrize("workload", ["tiny.mini", "tiny55f.mini"])
def test_a_cell_added_by_files_and_entries_alone_runs(tmp_path, workload):
    root = tiny_checkout(tmp_path / "checkout")
    cell = cells.resolve(workload, root)
    result = harness.run(cell, 7, 0.5, False, torch.device("cpu"), cache_dir=str(tmp_path / "cache"))
    assert result["correct"] is True and result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"kmers_per_s", "setup_s"}
