"""The harness's count loop on the CPU at a tiny size: dumps equal to the
reference's, the result's shape, the control and each planted fault
caught, and the import rule."""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

from gpubench import cells, harness
from gpubench.controls import faults
from gpubench.tests._tiny import tiny_checkout

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_checkout(tmp_path_factory.mktemp("checkout"))


def run(root, tmp_path, workload="tiny.mini", seed=3, traced=False, seconds=0.3, **kw):
    cell = cells.resolve(workload, root)
    return harness.run(cell, seed, seconds, traced, CPU, cache_dir=str(tmp_path / "cache"), log=lambda _: None,
                       **kw)


@pytest.mark.parametrize("workload", ["tiny.mini", "tiny1.mini", "tiny55f.mini"])
def test_the_count_loop_gives_the_references_dump(root, tmp_path, workload):
    # A window long enough for two counts on a loaded host (a tiny count
    # takes 0.05-0.3 s on the CPU).
    r = run(root, tmp_path, workload, seconds=1.0)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 2
    assert all(c["value"] == 0 for k, c in r["checks"].items() if k != "peak_bytes")
    # A second run of the seed takes the reference's digest from the cache.
    assert len(os.listdir(tmp_path / "cache")) == 1
    again = run(root, tmp_path, workload)
    assert again["correct"] is True and len(os.listdir(tmp_path / "cache")) == 1


@pytest.mark.parametrize("traced", [False, True])
def test_the_result_has_the_contracts_shape(root, tmp_path, traced):
    r = run(root, tmp_path, traced=traced)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"] and list(r)[-1] == "checks"
    dev = r["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev) and dev["count"] == 1
    assert ({"busy_s", "window_s"} <= set(dev)) is traced
    names = {m["name"] for m in (cells.resolve("tiny.mini", root).per_layer if traced else
                                 cells.resolve("tiny.mini", root).end_to_end)}
    assert set(r["metrics"]) <= names and all(set(v) == {"value", "unit"} for v in r["metrics"].values())
    if not traced:
        assert set(r["metrics"]) == names
    else:  # the host timers are read on the CPU; the trace's metrics need the card
        assert {"engine.dispatch_ms", "ingest.parse_ms", "ingest.wait_ms", "finalize.wall_ms"} <= set(r["metrics"])
    assert all(set(c) == {"value", "limit"} for c in r["checks"].values())
    json.dumps(r)


@pytest.mark.parametrize("workload", ["tiny.mini", "tiny55f.mini"])
def test_the_control_is_not_correct(root, tmp_path, workload):
    cell = cells.resolve(workload, root)
    r = run(root, tmp_path, workload, program_flags=faults.control_flags(cell))
    assert r["correct"] is False and r["checks"]["records_wrong"]["value"] > 0
    assert r["failed"] == r["attempted"]


@pytest.mark.parametrize("workload", ["tiny.mini", "tiny1.mini", "tiny55f.mini"])
@pytest.mark.parametrize("fault", faults.FAULTS)
def test_each_planted_fault_is_not_correct(root, tmp_path, workload, fault):
    with faults.planted(fault):
        r = run(root, tmp_path, workload)
    assert r["correct"] is False and r["checks"]["records_wrong"]["value"] > 0


def test_a_window_dump_unlike_the_first_fails(root, tmp_path, monkeypatch):
    from kmer_counter_tpu_torch import engine

    original, calls = engine.dump_table, [0]

    def second_differs(path, lanes, counts, *a, **kw):
        calls[0] += 1
        if calls[0] == 2:
            counts = counts.copy()
            counts[-1] += 1
        return original(path, lanes, counts, *a, **kw)

    monkeypatch.setattr(engine, "dump_table", second_differs)
    r = run(root, tmp_path)
    assert r["correct"] is False and r["checks"]["dumps_unlike_first"]["value"] == 1
    assert r["checks"]["records_wrong"]["value"] == 0 and r["failed"] == 1


def test_a_count_that_raises_fails(root, tmp_path, monkeypatch):
    from kmer_counter_tpu_torch import engine

    original, calls = engine.run_count, [0]

    def third_raises(*a, **kw):
        calls[0] += 1
        if calls[0] == 3:
            raise RuntimeError("planted")
        return original(*a, **kw)

    monkeypatch.setattr(engine, "run_count", third_raises)
    # The third call is the window's second count: a window long enough
    # for two counts on a loaded host.
    r = run(root, tmp_path, seconds=1.0)
    assert r["correct"] is False and r["checks"]["counts_raised"]["value"] == 1 and r["failed"] >= 1


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    fake = type(sys)("fake")
    for name in ("kmer_counter_tpu_torch", "kmer_counter_tpu_torch.engine", "jax_like", "jaxlibx"):
        monkeypatch.setitem(sys.modules, name, fake)
    assert harness.forbidden_modules() == []
    for name in ("kmer_counter_tpu.ops", "jax", "jaxlib.xla", "flax"):
        monkeypatch.setitem(sys.modules, name, fake)
    assert harness.forbidden_modules() == ["flax", "jax", "jaxlib", "kmer_counter_tpu"]


def test_main_refuses_a_process_that_loaded_jax(monkeypatch, capsys):
    fake = {"correct": True, "checks": {}}
    monkeypatch.setattr(harness, "run", lambda *a, **kw: fake)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setitem(sys.modules, "jax", type(sys)("jax"))
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    assert harness.main(["--workload", "k31c_two.ecoli_err", "--seed", "1", "--seconds", "1"]) == 3
    out, err = capsys.readouterr()
    assert out == "" and "jax" in err


def test_run_py_exits_without_a_result_where_there_is_no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for a machine without one")
    p = subprocess.run([sys.executable, os.path.join(cells.BENCH_DIR, "run.py"), "--workload", "k31c_two.ecoli_err",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                       cwd=cells.ROOT, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_run_py_exits_without_a_result_beside_the_benchmark_alone(tmp_path):
    """A directory holding only BENCHMARK.json and gpubench/: no program."""
    tiny_checkout(tmp_path)
    env = dict(os.environ, PYTHONPATH="")
    p = subprocess.run([sys.executable, "gpubench/run.py", "--workload", "tiny.mini", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
                       env=env, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_nothing_the_benchmark_runs_imports_jax_or_the_jax_package(root, tmp_path):
    code = ("import sys, torch; sys.path.insert(0, %r); "
            "from gpubench import cells, harness; from gpubench.controls import faults, readings; "
            "cell = cells.resolve('tiny.mini', %r); "
            "r = harness.run(cell, 1, 0.2, True, torch.device('cpu'), cache_dir=%r, log=lambda _: None); "
            "assert r['correct']; print(harness.forbidden_modules())") % (cells.ROOT, root, str(tmp_path / "c"))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
    for dirpath, _, files in os.walk(cells.BENCH_DIR):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    tree = ast.parse(fh.read())
                for node in ast.walk(tree):
                    names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                             [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
                    assert not {n.split(".")[0] for n in names} & set(harness.FORBIDDEN), (f, names)
