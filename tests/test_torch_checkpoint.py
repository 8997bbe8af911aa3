"""Checkpoint and resume in the port's engine, across packages: the port
resumes snapshots the JAX package wrote (also across a spill to disk), the
JAX engine resumes snapshots the port wrote, and a run stopped right after
a checkpointed consolidation resumes to the golden dump.  Also
``profile=true``, which wraps the run in a torch.profiler trace."""

import json

import numpy as np
import pytest
import torch

from kmer_counter_tpu import checkpoint as jax_ckpt
from kmer_counter_tpu import golden
from kmer_counter_tpu import records as jax_records
from kmer_counter_tpu.config import Options
from kmer_counter_tpu.engine import CountEngine as JaxCountEngine
from kmer_counter_tpu.io import spill as jax_spill
from kmer_counter_tpu.ops import table2 as jax_t2
from kmer_counter_tpu_torch import checkpoint
from kmer_counter_tpu_torch.engine import CountEngine, run_count
from kmer_counter_tpu_torch.ops import table2 as t2

from tests.test_ingest import random_seqs, write_fastq
from tests.test_torch_engine import golden_bytes

CPU = torch.device("cpu")
K = 15
M = 0xFFFFFFFF


class Crash(Exception):
    """Stands for the process dying right after a snapshot."""


def _opts(tmp_path, impl, **kw):
    return Options(kmer_length=K, input_dir=str(tmp_path / "in"), output_file=str(tmp_path / "out.bin"),
                   checkpoint_dir=str(tmp_path / "ck"), table_impl=impl, verbose=0, **kw)


def _port(opts):
    return CountEngine(opts, device=CPU)


ENGINES = {"port": _port, "jax": JaxCountEngine}


def _golden_table(seqs):
    words, counts = golden.table_from_counter(golden.count_reads(seqs, K))
    return jax_records.words_to_lanes(words), counts


def _crash_port_after(monkeypatch, when):
    """The port's engine raises Crash right after the first snapshot whose
    stats satisfy ``when``."""
    real = CountEngine._save_checkpoint

    def save(self, stats, *args, **kw):
        real(self, stats, *args, **kw)
        if when(stats):
            raise Crash

    monkeypatch.setattr(CountEngine, "_save_checkpoint", save)


@pytest.mark.parametrize("impl", ["two", "one"])
def test_port_resumes_a_jax_snapshot(tmp_path, rng, impl):
    """tests/test_checkpoint.py's crash-resume scenario: the JAX package's
    snapshot holds golden(a); the port counts only b and writes
    golden(a) + golden(b)."""
    (tmp_path / "in").mkdir()
    seqs_a, seqs_b = random_seqs(rng, 10, 40), random_seqs(rng, 12, 40)
    write_fastq(tmp_path / "in" / "a.fastq", seqs_a)
    write_fastq(tmp_path / "in" / "b.fastq", seqs_b)
    opts = _opts(tmp_path, impl)
    jax_ckpt.save(str(tmp_path / "ck"), opts, *_golden_table(seqs_a), reads_absorbed=10,
                  files={"a.fastq": 10})
    stats = _port(opts).run()
    assert stats.reads == 22 and stats.per_file == {"a.fastq": 10, "b.fastq": 12}
    assert (tmp_path / "out.bin").read_bytes() == golden_bytes(tmp_path, K, False)


@pytest.mark.parametrize("impl", ["two", "one"])
def test_port_resumes_a_jax_snapshot_across_a_spill(tmp_path, rng, impl):
    """tests/test_checkpoint.py::test_engine_resume_across_spill on the
    port: the JAX package wrote the spill run and the snapshot that lists
    it; the port re-registers the run and writes the golden dump.  At the
    default gpuMemoryLimit (100 MB) a full raw region's sort passes the
    budget by the port's model, so the prefix may not grow
    (budget.max_prefix_slots is 0) and the two-level table spills its live
    rows at the consolidation that would grow it."""
    (tmp_path / "in").mkdir()
    seqs_a, seqs_b, seqs_c = random_seqs(rng, 8, 40), random_seqs(rng, 6, 40), random_seqs(rng, 10, 40)
    write_fastq(tmp_path / "in" / "a.fastq", seqs_a + seqs_b + seqs_c)
    (tmp_path / "tmp").mkdir()
    opts = _opts(tmp_path, impl, temp_dir=str(tmp_path / "tmp"))
    run = jax_spill.write_run(str(tmp_path / "tmp" / "spill_000001.run"), *_golden_table(seqs_a))
    jax_ckpt.save(str(tmp_path / "ck"), opts, *_golden_table(seqs_b), reads_absorbed=14,
                  files={"a.fastq": 14}, spill_runs=[run])
    stats = _port(opts).run()
    assert stats.reads == 24
    # the re-registered run, (two-level) the prefix's rows, the final table
    assert stats.spilled_runs == (3 if impl == "two" else 2)
    assert (tmp_path / "out.bin").read_bytes() == golden_bytes(tmp_path, K, False)


@pytest.mark.parametrize("resumer", ["port", "jax"])
@pytest.mark.parametrize("impl", ["two", "one"])
def test_crash_after_a_consolidation_resumes_to_golden(tmp_path, rng, monkeypatch, impl, resumer):
    """A run with checkpointEvery=1 stops right after its first mid-stream
    consolidation.  The snapshot counts exactly the reads the consolidated
    table holds: a chunk that waits for the consolidation is not yet
    absorbed, so the resume (by either package) counts it."""
    (tmp_path / "in").mkdir()
    write_fastq(tmp_path / "in" / "a.fastq", random_seqs(rng, 30, 40))
    write_fastq(tmp_path / "in" / "b.fastq", random_seqs(rng, 18, 40))
    opts = _opts(tmp_path, impl, checkpoint_every=1, reads_per_chunk=4, table_slots=240)
    with monkeypatch.context() as m:
        _crash_port_after(m, lambda stats: True)
        with pytest.raises(Crash):
            _port(opts).run()
    manifest = json.loads((tmp_path / "ck" / "checkpoint.json").read_text())
    assert 0 < manifest["reads_absorbed"] < 48 and manifest["reads_absorbed"] % 4 == 0
    assert manifest["files"] == {"a.fastq": manifest["reads_absorbed"]}
    stats = ENGINES[resumer](opts).run()
    assert stats.reads == 48
    assert (tmp_path / "out.bin").read_bytes() == golden_bytes(tmp_path, K, False)


@pytest.mark.parametrize("resumer", ["port", "jax"])
@pytest.mark.parametrize("impl", ["two", "one"])
def test_crash_after_a_spill_resumes_to_golden(tmp_path, rng, monkeypatch, impl, resumer):
    """The port spills and snapshots (checkpointEvery=1), then stops right
    after the first snapshot that lists a spill run; either package resumes
    it: re-registers the runs, skips the absorbed reads and writes the
    golden dump."""
    (tmp_path / "in").mkdir()
    write_fastq(tmp_path / "in" / "a.fastq", random_seqs(rng, 96, 40))
    opts = _opts(tmp_path, impl, checkpoint_every=1, temp_dir=str(tmp_path / "tmp"), reads_per_chunk=8,
                 table_slots=600)
    with monkeypatch.context() as m:
        _crash_port_after(m, lambda stats: stats.spilled_runs > 0)
        with pytest.raises(Crash):
            _port(opts).run()
    manifest = json.loads((tmp_path / "ck" / "checkpoint.json").read_text())
    assert manifest["spill_runs"] and 0 < manifest["reads_absorbed"] < 96
    stats = ENGINES[resumer](opts).run()
    assert stats.reads == 96 and stats.spilled_runs >= 2
    assert (tmp_path / "out.bin").read_bytes() == golden_bytes(tmp_path, K, False)
    assert checkpoint.load(str(tmp_path / "ck"), opts) is None  # its runs were merged away


@pytest.mark.parametrize("impl", ["two", "one"])
def test_port_resumes_a_jax_crash_after_a_spill(tmp_path, rng, monkeypatch, impl):
    """The JAX engine spills and snapshots, then stops right after its
    first snapshot that lists a spill run; the port resumes it."""
    (tmp_path / "in").mkdir()
    write_fastq(tmp_path / "in" / "a.fastq", random_seqs(rng, 96, 40))
    opts = _opts(tmp_path, impl, checkpoint_every=1, temp_dir=str(tmp_path / "tmp"), reads_per_chunk=8,
                 table_slots=600)
    real = jax_ckpt.save

    def save(*args, **kw):
        real(*args, **kw)
        if kw.get("spill_runs"):
            raise Crash

    with monkeypatch.context() as m:
        m.setattr(jax_ckpt, "save", save)
        with pytest.raises(Crash):
            JaxCountEngine(opts).run()
    stats = _port(opts).run()
    assert stats.reads == 96 and stats.spilled_runs >= 2
    assert (tmp_path / "out.bin").read_bytes() == golden_bytes(tmp_path, K, False)


@pytest.mark.parametrize("impl", ["two", "one"])
def test_resume_of_a_snapshot_past_the_cap_spills_it(tmp_path, rng, monkeypatch, impl):
    """A snapshot with more rows than the table may hold under its cap
    (one the JAX engine wrote, whose tables grow further; or a one-level
    snapshot, taken before its consolidation's spill decision) becomes a
    spill run at resume: no table of the resumed run passes the cap
    (budget.max_prefix_slots / max_table_slots, here from tableSlots), and
    the dump is golden's."""
    from kmer_counter_tpu_torch.ops import pipeline
    from kmer_counter_tpu_torch.ops import table as t1

    (tmp_path / "in").mkdir()
    seqs_a, seqs_b = random_seqs(rng, 40, 40), random_seqs(rng, 12, 40)
    write_fastq(tmp_path / "in" / "a.fastq", seqs_a)
    write_fastq(tmp_path / "in" / "b.fastq", seqs_b)
    opts = _opts(tmp_path, impl, temp_dir=str(tmp_path / "tmp"), reads_per_chunk=4, table_slots=240)
    lanes, counts = _golden_table(seqs_a)
    cap = 2 * 240 - (240 - 240 // 8) if impl == "two" else 2 * 240
    assert len(counts) > cap
    jax_ckpt.save(str(tmp_path / "ck"), opts, lanes, counts, reads_absorbed=40, files={"a.fastq": 40})
    sizes = []

    def record(module, name, size):
        real = getattr(module, name)

        def call(table, *args, **kw):
            sizes.append(size(table))
            return real(table, *args, **kw)

        monkeypatch.setattr(module, name, call)

    if impl == "two":
        record(pipeline, "count_step_two_level", lambda table: table.prefix_lanes.shape[1])
        record(t2, "consolidate3", lambda table: table.prefix_lanes.shape[1])
    else:
        record(t1, "append", lambda table: table.lanes.shape[1])
    stats = _port(opts).run()
    assert sizes and max(sizes) <= cap
    assert stats.reads == 52 and stats.spilled_runs >= 2  # the snapshot's run, then the final table
    assert (tmp_path / "out.bin").read_bytes() == golden_bytes(tmp_path, K, False)


@pytest.mark.parametrize("impl", ["two", "one"])
def test_resume_detects_ingest_drift(tmp_path, rng, impl):
    """tests/test_checkpoint.py::test_engine_resume_detects_ingest_drift on
    the port: the snapshot absorbed 10 reads of a.fastq, which now holds 4."""
    (tmp_path / "in").mkdir()
    seqs_a = random_seqs(rng, 10, 40)
    write_fastq(tmp_path / "in" / "a.fastq", seqs_a[:4])
    write_fastq(tmp_path / "in" / "b.fastq", random_seqs(rng, 12, 40))
    opts = _opts(tmp_path, impl)
    checkpoint.save(str(tmp_path / "ck"), opts, *_golden_table(seqs_a), reads_absorbed=10,
                    files={"a.fastq": 10})
    with pytest.raises(RuntimeError, match="resume drift"):
        _port(opts).run()


@pytest.mark.parametrize("impl", ["two", "one"])
def test_missing_spill_run_refuses_the_snapshot(tmp_path, rng, impl):
    """A snapshot whose listed spill run vanished would lose that run's
    counts: load refuses it, and the engine counts from scratch."""
    (tmp_path / "in").mkdir()
    seqs = random_seqs(rng, 20, 40)
    write_fastq(tmp_path / "in" / "a.fastq", seqs)
    (tmp_path / "tmp").mkdir()
    opts = _opts(tmp_path, impl, temp_dir=str(tmp_path / "tmp"))
    run = tmp_path / "tmp" / "spill_000001.run"
    lanes, counts = _golden_table(seqs[:8])
    jax_spill.write_run(str(run), lanes, counts)
    checkpoint.save(str(tmp_path / "ck"), opts, *_golden_table(seqs[8:12]), reads_absorbed=12,
                    files={"a.fastq": 12}, spill_runs=[str(run)])
    assert checkpoint.load(str(tmp_path / "ck"), opts) is not None
    run.unlink()
    assert checkpoint.load(str(tmp_path / "ck"), opts) is None
    stats = _port(opts).run()
    assert stats.reads == 20
    assert (tmp_path / "out.bin").read_bytes() == golden_bytes(tmp_path, K, False)


def test_two_level_resume_pads_the_prefix_with_the_sentinel(tmp_path, rng, monkeypatch):
    """A snapshot of U records resumed into a prefix of CP > U slots: the
    port puts the sentinel key with count 0 after the U rows, so the prefix
    handed to K1 stays ascending, as the kernel requires.  The JAX engine
    pads with zero keys there (ROADMAP Queue 3), the fault that makes K1
    count rows twice after its grow2
    (tests/test_torch_merge_fold_compact.py::test_jax_k1_over_counts_after_grow2_zero_padding)."""
    (tmp_path / "in").mkdir()
    seqs_a, seqs_b = random_seqs(rng, 4, 40), random_seqs(rng, 12, 40)
    write_fastq(tmp_path / "in" / "a.fastq", seqs_a)
    write_fastq(tmp_path / "in" / "b.fastq", seqs_b)
    opts = _opts(tmp_path, "two", reads_per_chunk=4, table_slots=2400)
    lanes, counts = _golden_table(seqs_a)
    U = len(counts)
    seen = {}

    def capture(module, key):
        real = module.consolidate3

        def call(table, *args, **kw):
            seen.setdefault(key, (np.asarray(table.prefix_lanes), np.asarray(table.prefix_counts)))
            return real(table, *args, **kw)

        monkeypatch.setattr(module, "consolidate3", call)

    capture(t2, "port")
    capture(jax_t2, "jax")
    for name, engine in ENGINES.items():
        jax_ckpt.save(str(tmp_path / "ck"), opts, lanes, counts, reads_absorbed=4, files={"a.fastq": 4})
        engine(opts).run()
        assert (tmp_path / "out.bin").read_bytes() == golden_bytes(tmp_path, K, False), name

    port_lanes, port_counts = seen["port"]
    port_lanes = port_lanes.view(np.uint32)
    CP = port_lanes.shape[1]
    assert CP > U
    np.testing.assert_array_equal(port_lanes[:, :U], lanes[:, :1].T)
    assert (port_lanes[:, U:] == M).all() and (port_counts[U:] == 0).all()
    keys = port_lanes[0].astype(np.int64)
    assert (np.diff(keys) >= 0).all()  # ascending, as K1 requires

    jax_lanes, jax_counts = seen["jax"]
    assert jax_lanes.shape[1] > U
    assert (jax_lanes[:, U:] == 0).all() and (jax_counts[U:] == 0).all()
    assert (np.diff(jax_lanes[0].astype(np.int64)) < 0).any()  # not ascending


@pytest.mark.parametrize("impl", ["two", "one"])
def test_profile_writes_a_trace(tmp_path, rng, impl):
    """profile=true: the run is traced and the trace written next to the
    output file (on the CPU here, so it holds host events only)."""
    (tmp_path / "in").mkdir()
    write_fastq(tmp_path / "in" / "a.fastq", random_seqs(rng, 12, 40))
    opts = Options(kmer_length=K, input_dir=str(tmp_path / "in"), output_file=str(tmp_path / "out.bin"),
                   table_impl=impl, profile=True, verbose=0, reads_per_chunk=4)
    run_count(opts, CPU)
    trace = tmp_path / "out.bin.trace" / "trace.json"
    events = json.loads(trace.read_text())["traceEvents"]
    assert len(events) > 10
    assert (tmp_path / "out.bin").read_bytes() == golden_bytes(tmp_path, K, False)


def test_snapshot_lanes_are_the_consolidated_prefix(tmp_path, rng):
    """The two-level snapshot is the prefix's live rows after a
    consolidation, unique and ascending (no host fold is needed)."""
    (tmp_path / "in").mkdir()
    write_fastq(tmp_path / "in" / "a.fastq", random_seqs(rng, 24, 40))
    opts = _opts(tmp_path, "two", checkpoint_every=1, reads_per_chunk=4, table_slots=240)
    _port(opts).run()
    snap = checkpoint.load(str(tmp_path / "ck"), opts)
    words = jax_records.lanes_to_words(snap.lanes)
    assert len(snap.counts) and (snap.counts > 0).all()
    assert all(tuple(a) < tuple(b) for a, b in zip(words[:-1].tolist(), words[1:].tolist()))
