"""The port's mesh engine in two processes: two gloo ranks, each owning two
CPU positions of one 4-position mesh (tests/torch_multiproc_worker.py).

The ranks read their own files, agree on every bound in lockstep, route
the records across processes with ``all_to_all_single`` and write the part
files of their positions; the parts in name order must be the golden
table, with each table, a spill, and a crash resumed from the mesh
snapshot.  One case holds each part to the JAX package's own two-process
run (tests/test_multiprocess.py) byte for byte.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from tests.test_ingest import random_seqs, write_fastq
from tests.test_torch_engine import golden_bytes

_WORKER = os.path.join(os.path.dirname(__file__), "torch_multiproc_worker.py")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240


def _input(tmp_path, seed, n_reads):
    rng = np.random.default_rng(seed)
    (tmp_path / "in").mkdir()
    for i in range(4):  # 4 files, so that the round-robin split gives both ranks data
        write_fastq(tmp_path / "in" / f"f{i}.fastq", random_seqs(rng, n_reads, 60))


def run_port_jobs(tmp_path, jobs, crash_after=0, positions=2):
    """Runs both ranks, each owning ``positions`` positions, through
    ``jobs`` in one process group: dicts of out_dir, impl, k and optionally
    table_slots, temp_dir, ckpt_dir, checkpoint_every.  Returns the ranks'
    output."""
    store = tmp_path / f"store_{crash_after}_{len(list(tmp_path.glob('store_*')))}"
    env = {k_: v for k_, v in os.environ.items() if not k_.startswith(("JAX", "XLA"))}
    env["PYTHONPATH"] = _REPO
    env["KMER_TEST_POSITIONS"] = str(positions)
    if crash_after:
        env["KMER_TEST_CRASH_AFTER_CHUNKS"] = str(crash_after)
    argv = []
    for job in jobs:
        (tmp_path / job["out_dir"]).mkdir(exist_ok=True)
        argv += ["--"] * bool(argv) + [str(tmp_path / "in"), str(tmp_path / job["out_dir"] / "out.bin"), job["impl"],
                                       str(job["k"]), str(job.get("table_slots", 0))]
        if job.get("temp_dir") or job.get("ckpt_dir"):
            argv.append(job.get("temp_dir", ""))
        if job.get("ckpt_dir"):
            argv += [job["ckpt_dir"], str(job["checkpoint_every"])]
    procs = [subprocess.Popen([sys.executable, _WORKER, str(rank), "2", str(store), *argv], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(2)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            pytest.fail(f"a rank timed out after {TIMEOUT_S} s; output so far: {logs}")
    for p, log in zip(procs, logs):
        assert p.returncode == (17 if crash_after else 0), log
    return logs


def read_parts(out_root, k, positions=2):
    """(the parts concatenated in name order, the part file names) of a
    two-rank run whose output file is ``out_root / "out.bin"``."""
    parts = sorted(f for f in os.listdir(out_root) if f.startswith("out.bin.part"))
    assert len(parts) == 2 * positions, parts
    manifests = sorted(f for f in os.listdir(out_root) if ".manifest." in f)
    assert len(manifests) == 2, manifests
    records = sum(json.load(open(out_root / m))["records"] for m in manifests)
    data = b"".join((out_root / f).read_bytes() for f in parts)
    assert len(data) == records * (8 * -(-k // 32) + 4)
    return data, parts


def job_line(logs, rank, out_dir):
    """The line rank ``rank`` printed at the end of the job writing into
    ``out_dir``."""
    return next(line for line in logs[rank].splitlines() if line.startswith(f"rank {rank} ok out=")
                and f"{os.sep}{out_dir}{os.sep}out.bin " in line)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One launch of both ranks through four jobs on one input (each table,
    without and with a spill).  The input's first half is uniform reads,
    its second half reads with a poly-A head: a spill run's splitters
    freeze at its first spill, over the uniform reads, and the poly-A
    reads after it crowd the lowest range, which then takes more rows than
    a position may hold and arrives in rounds."""
    tmp = tmp_path_factory.mktemp("two_ranks")
    rng = np.random.default_rng(11)
    (tmp / "in").mkdir()
    for i in range(2):  # rank i reads f{i}, then f{i+2}
        write_fastq(tmp / "in" / f"f{i}.fastq", random_seqs(rng, 128, 60))
        write_fastq(tmp / "in" / f"f{i + 2}.fastq", ["A" * 30 + s for s in random_seqs(rng, 128, 30)])
    jobs = [dict(out_dir=f"{impl}_{mode}", impl=impl, k=31, table_slots=4000,
                 temp_dir=str(tmp / f"spill_{impl}") if mode == "spill" else "")
            for impl in ("two", "one") for mode in ("plain", "spill")]
    logs = run_port_jobs(tmp, jobs)
    return tmp, logs, golden_bytes(tmp, 31, True)


@pytest.mark.parametrize("impl", ["two", "one"])
def test_two_ranks_match_golden(runs, impl):
    tmp, logs, want = runs
    data, parts = read_parts(tmp / f"{impl}_plain", 31)
    assert parts == [f"out.bin.part{p:05d}" for p in range(4)]
    assert data == want
    assert all("spilled=0 " in job_line(logs, r, f"{impl}_plain") for r in range(2))


@pytest.mark.parametrize("impl", ["two", "one"])
def test_two_ranks_spill_match_golden(runs, impl):
    """Every rank routes its positions' tables to their owners and writes
    a run per position, mid-run; each part merges its runs.  The crowded
    range arrives in rounds (a run per round)."""
    tmp, logs, want = runs
    data, _ = read_parts(tmp / f"{impl}_spill", 31)
    lines = [job_line(logs, r, f"{impl}_spill") for r in range(2)]
    assert all("spilled=0 " not in line for line in lines), lines
    assert all(int(re.search(r"rounds=(\d+)", line).group(1)) > 1 for line in lines), lines
    assert data == want
    assert not [f for f in os.listdir(tmp / f"spill_{impl}") if f.endswith(".run")]


@pytest.mark.parametrize("impl,spill", [("one", False), ("two", True)])
def test_two_ranks_kill_resume_match_golden(tmp_path, impl, spill):
    """Both ranks die after the same step; a second run resumes the newest
    complete mesh snapshot (with the spill runs it lists) to golden."""
    _input(tmp_path, 21, 64)
    ckpt = str(tmp_path / "ckpt")
    job = dict(out_dir="port", impl=impl, k=31, table_slots=1200 if spill else 4000,
               temp_dir=str(tmp_path / "spill") if spill else "", ckpt_dir=ckpt, checkpoint_every=1)
    logs = run_port_jobs(tmp_path, [job], crash_after=6)
    assert all("simulated crash" in log for log in logs), logs
    manifests = [json.load(open(os.path.join(ckpt, f))) for f in os.listdir(ckpt) if f.endswith(".json")]
    assert manifests, "no snapshot before the crash"
    if spill:
        assert any(m.get("pos_runs") for m in manifests), "no snapshot lists a spill run"
    logs2 = run_port_jobs(tmp_path, [job])
    assert all("resumed mesh checkpoint" in log for log in logs2), logs2
    assert read_parts(tmp_path / "port", 31)[0] == golden_bytes(tmp_path, 31, True)


@pytest.mark.parametrize("impl", ["two"])
def test_parts_byte_identical_to_jax_two_processes(tmp_path, impl):
    """The JAX package's two processes (4 virtual CPU devices each, an
    8-device mesh) and the port's (2 ranks x 4 CPU positions here) write
    the same part files: the same rows per position, the same splitters,
    the same ranges."""
    from tests.test_multiprocess import _run_workers

    _input(tmp_path, 3, 40)
    _run_workers(tmp_path, impl, 31)
    jax_parts = sorted(f for f in os.listdir(tmp_path) if f.startswith(f"out_{impl}.bin.part"))
    run_port_jobs(tmp_path, [dict(out_dir="port8", impl=impl, k=31)], positions=4)
    _, port_parts = read_parts(tmp_path / "port8", 31, positions=4)
    assert [f.split(".part")[1] for f in port_parts] == [f.split(".part")[1] for f in jax_parts]
    assert len(port_parts) == 8
    for jp, pp in zip(jax_parts, port_parts):
        assert (tmp_path / "port8" / pp).read_bytes() == (tmp_path / jp).read_bytes(), pp
