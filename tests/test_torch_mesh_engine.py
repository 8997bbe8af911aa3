"""The port's MeshCountEngine on an 8-position CPU mesh against golden and
the JAX MeshCountEngine on conftest's 8 virtual CPU devices, byte for
byte: each table, mixed line lengths, the all-T k-mer, a spill, the spill
decision at the 2e9 plan against the JAX threshold, a resume across a
spill, a snapshot of another configuration, and run_count's dispatch."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from kmer_counter_tpu.config import Options as JaxOptions
from kmer_counter_tpu.engine import MeshCountEngine as JaxMeshEngine
from kmer_counter_tpu_torch import budget as bg
from kmer_counter_tpu_torch import checkpoint
from kmer_counter_tpu_torch.config import Options
from kmer_counter_tpu_torch.engine import MeshCountEngine, plan_chunks, run_count
from kmer_counter_tpu_torch.parallel import pipeline
from kmer_counter_tpu_torch.parallel.mesh import make_mesh

from tests.test_ingest import random_seqs, write_fastq
from tests.test_torch_engine import golden_bytes

CPU = torch.device("cpu")
D = 8
BUDGET_2E9 = 2_000_000_000


@pytest.fixture(scope="module")
def mesh8():
    return make_mesh(devices=[CPU] * D)


def _port(tmp_path, mesh, name="port", **kw):
    opts = Options(input_dir=str(tmp_path / "in"), output_file=str(tmp_path / f"{name}.bin"), verbose=0, **kw)
    stats = MeshCountEngine(opts, mesh=mesh).run()
    return (tmp_path / f"{name}.bin").read_bytes(), stats


def _jax(tmp_path, **kw):
    opts = JaxOptions(input_dir=str(tmp_path / "in"), output_file=str(tmp_path / "jax.bin"), mesh_shape=(D,),
                      verbose=0, **kw)
    stats = JaxMeshEngine(opts).run()
    return (tmp_path / "jax.bin").read_bytes(), stats


@pytest.mark.parametrize("impl", ["two", "one"])
def test_mesh_engine_matches_jax_and_golden(tmp_path, rng, mesh8, impl):
    """k=31 canonical with consolidations on every position, and reads in
    two files (N bases in some)."""
    (tmp_path / "in").mkdir()
    seqs = random_seqs(rng, 160, 60)
    for i in range(0, 160, 5):
        seqs[i] = seqs[i][:20] + "N" + seqs[i][21:]
    write_fastq(tmp_path / "in" / "a.fastq", seqs[:100])
    write_fastq(tmp_path / "in" / "b.fastq", seqs[100:])
    kw = dict(kmer_length=31, canonical=True, reads_per_chunk=32, table_impl=impl, table_slots=3000)
    port, ps = _port(tmp_path, mesh8, **kw)
    jax_out, js = _jax(tmp_path, **kw)
    assert port == jax_out == golden_bytes(tmp_path, 31, True)
    for field in ("reads", "bases", "chunks", "consolidations", "distinct_kmers"):
        assert getattr(ps, field) == getattr(js, field), field
    assert ps.consolidations >= 1


@pytest.mark.parametrize("impl", ["two", "one"])
def test_mesh_engine_mixed_lengths_and_all_t(tmp_path, rng, mesh8, impl):
    """k=16 forward: files of 40 bp, 70 bp and 10 bp reads (shorter than
    k: absorbed without a step; short chunks padded with zero bytes), and
    all-T reads, whose k-mers the two-level table counts on the side and
    writes as the last record.  The JAX engine runs for the two-level
    table, whose side count it shares; each dump is golden's."""
    (tmp_path / "in").mkdir()
    a = random_seqs(rng, 30, 40)
    a[4] = "T" * 40
    write_fastq(tmp_path / "in" / "a.fastq", a)
    b = random_seqs(rng, 20, 70)
    b[7] = "T" * 70
    write_fastq(tmp_path / "in" / "b.fastq", b)
    write_fastq(tmp_path / "in" / "c.fastq", random_seqs(rng, 5, 10))
    kw = dict(kmer_length=16, reads_per_chunk=16, table_impl=impl)
    port, ps = _port(tmp_path, mesh8, **kw)
    assert port == golden_bytes(tmp_path, 16, False)
    if impl == "two":
        assert port == _jax(tmp_path, **kw)[0]
    assert ps.reads == 55
    assert port[-12:] == np.array([0xFFFFFFFF00000000], "<u8").tobytes() + np.array([25 + 55], "<u4").tobytes()


@pytest.mark.parametrize("impl", ["two", "one"])
def test_mesh_engine_spill_matches_jax_and_golden(tmp_path, rng, mesh8, impl):
    """A tiny tableSlots with a temp dir: the positions' tables spill as
    runs over the whole key space, and the host merge writes the output."""
    (tmp_path / "in").mkdir()
    write_fastq(tmp_path / "in" / "a.fastq", random_seqs(rng, 512, 40))
    kw = dict(kmer_length=15, reads_per_chunk=64, table_impl=impl, table_slots=3000)
    port, ps = _port(tmp_path, mesh8, temp_dir=str(tmp_path / "tmp_port"), **kw)
    jax_out, js = _jax(tmp_path, temp_dir=str(tmp_path / "tmp_jax"), **kw)
    assert ps.spilled_runs > D and js.spilled_runs > 0
    assert port == jax_out == golden_bytes(tmp_path, 15, False)
    assert not list((tmp_path / "tmp_port").glob("*.run"))


@pytest.mark.parametrize("impl", ["two", "one"])
def test_mesh_engine_crowded_range_merges_on_the_host(tmp_path, rng, mesh8, impl):
    """Skewed keys (two thirds of the reads a poly-A head): the splitters
    sampled at the finalize give the range of the low keys more rows than a
    position may hold (its spill cap), so the positions' tables go to the
    host merge as runs instead of the route; the dump is golden's."""
    (tmp_path / "in").mkdir()
    write_fastq(tmp_path / "in" / "a.fastq", random_seqs(rng, 200, 60))
    write_fastq(tmp_path / "in" / "b.fastq", ["A" * 30 + s for s in random_seqs(rng, 400, 30)])
    opts = Options(input_dir=str(tmp_path / "in"), output_file=str(tmp_path / "port.bin"), kmer_length=31,
                   canonical=True, reads_per_chunk=64, table_impl=impl, table_slots=20_000,
                   temp_dir=str(tmp_path / "tmp"), verbose=0)
    engine = MeshCountEngine(opts, mesh=mesh8)
    stats = engine.run()
    assert engine.route_rounds > 1 and stats.spilled_runs == D
    assert (tmp_path / "port.bin").read_bytes() == golden_bytes(tmp_path, 31, True)


def test_mesh_engine_spills_under_a_byte_budget(tmp_path, rng, mesh8, monkeypatch):
    """Without tableSlots each position's cap is the single-device model's
    at gpuMemoryLimit / D: a 4e6-byte budget over 8 positions (the model
    without its allocator slack; prefix 1,736, raw region 5,208 and a cap
    of 7,228 slots a position, with the route's step) makes the two-level positions spill their
    prefixes rather than grow them."""
    monkeypatch.setattr(bg, "_ALLOCATOR_SLACK", 0)
    (tmp_path / "in").mkdir()
    write_fastq(tmp_path / "in" / "a.fastq", random_seqs(rng, 3000, 60))
    seen = []
    real = pipeline.ShardedCounter2.consolidate

    def consolidate(self, cap=None, spill=None):
        seen.append(cap)
        return real(self, cap, spill)

    monkeypatch.setattr(pipeline.ShardedCounter2, "consolidate", consolidate)
    _, stats = _port(tmp_path, mesh8, kmer_length=21, table_impl="two", memory_limit_bytes=4_000_000,
                     reads_per_chunk=160, temp_dir=str(tmp_path / "tmp"))
    assert stats.spilled_runs >= 2 * D
    assert seen and set(seen) == {7_228}
    assert (tmp_path / "port.bin").read_bytes() == golden_bytes(tmp_path, 21, False)


def _mesh_plan(k=31, L=100, limit=BUDGET_2E9, positions=4):
    """The mesh engine's plan (chip_smoke.py's mesh_spill phase: 4
    positions, 100 bp reads, k=31, 2e9)."""
    opts = Options(kmer_length=k, memory_limit_bytes=limit, temp_dir="t", input_dir="in", output_file="o")
    reads_per_chunk, table_slots = plan_chunks(opts, L)
    rpd = reads_per_chunk // positions
    slots = rpd * (L - k + 1)
    per = max(table_slots // positions, 4 * slots)
    cp = per // 4
    return opts, rpd, slots, cp, per - cp, bg.Chunk(rpd * L, slots)


def test_mesh_spill_decision_at_the_2e9_plan_against_the_jax_threshold():
    """Pins a standing fault of the JAX package (ROADMAP Queue 3): the JAX
    mesh spills only once a position's live + raw bound passes its share of
    the single-device threshold (engine._max_slots_per_device: four times
    the planned table over D), after growing.  With k-mers that are all
    distinct it lets each of 4 positions grow its prefix to 41,665,680
    slots, where the port's model puts the 4 positions' raw sorts at
    3.43e9 together.
    The port caps each position at the model's bound for gpuMemoryLimit/D."""
    opts, rpd, slots, cp, cr, chunk = _mesh_plan()
    assert (rpd, slots, cp, cr) == (24_801, 1_736_070, 1_736_111, 5_208_333)
    per = dataclasses.replace(opts, memory_limit_bytes=BUDGET_2E9 // 4)
    cap = bg.max_prefix_slots(per, 2, cr, chunk, routed=True)
    assert cr < cap < 2 * cr
    peaks = bg.two_level_peaks(2, cap, cr, cr, chunk, finalize_rows=cap, route_rows=cap)
    assert 4 * max(peaks.values()) <= BUDGET_2E9 and "route_merge_local" in peaks
    jax_opts = JaxOptions(kmer_length=31, memory_limit_bytes=BUDGET_2E9, temp_dir="t", input_dir="in",
                          output_file="o", mesh_shape=(4,))
    jax_cap = JaxMeshEngine.__new__(JaxMeshEngine)
    jax_cap.opts = jax_opts
    jax_cap = jax_cap._max_slots_per_device(2, 4)
    live, raw, jcp = 0, 3 * slots, cp
    while live + raw <= jax_cap:  # the JAX rule: grow geometrically, spill only past jax_cap
        if live + raw > jcp:
            jcp = max(live + raw, 2 * jcp)
        live += raw
    assert jcp == 41_665_680 and jcp > 2 * cap
    assert 4 * bg.two_level_peaks(2, jcp, cr, raw, chunk)["_sort_raw_desc"] > BUDGET_2E9


def _crash_after(monkeypatch, n_steps):
    for cls in (pipeline.ShardedCounter, pipeline.ShardedCounter2):
        real, done = cls.step, [0]

        def step(self, reads, _real=real, _done=done):
            if _done[0] >= n_steps:
                raise RuntimeError("simulated crash")
            _done[0] += 1
            return _real(self, reads)

        monkeypatch.setattr(cls, "step", step)


@pytest.mark.parametrize("impl", ["two", "one"])
def test_mesh_resume_across_a_spill_matches_golden(tmp_path, rng, mesh8, monkeypatch, impl):
    """A snapshot at every consolidation with spilling on; the run dies
    after 6 steps; a second run resumes the newest snapshot, with the spill
    runs it lists, to golden."""
    (tmp_path / "in").mkdir()
    write_fastq(tmp_path / "in" / "a.fastq", random_seqs(rng, 200, 60))
    ckpt = str(tmp_path / "ckpt")
    kw = dict(kmer_length=31, canonical=True, reads_per_chunk=32, table_slots=1200, table_impl=impl,
              temp_dir=str(tmp_path / "spill"), checkpoint_dir=ckpt, checkpoint_every=1)
    with monkeypatch.context() as mp:
        _crash_after(mp, 6)
        with pytest.raises(RuntimeError, match="simulated crash"):
            _port(tmp_path, mesh8, **kw)
    assert list((tmp_path / "spill").glob("*.run")), "the crashed run never spilled"
    seen = []
    real = checkpoint.mesh_load

    def spy(*a, **k):
        seen.append(real(*a, **k))
        return seen[-1]

    monkeypatch.setattr(checkpoint, "mesh_load", spy)
    out, stats = _port(tmp_path, mesh8, **kw)
    assert seen[0] is not None and seen[0].epoch >= 1 and seen[0].scheduler_runs
    assert out == golden_bytes(tmp_path, 31, True)
    assert stats.reads == 200


def test_mesh_snapshot_of_another_configuration_is_ignored(tmp_path, rng, mesh8):
    """A mesh snapshot taken at another k is not resumed: a fresh count."""
    (tmp_path / "in").mkdir()
    write_fastq(tmp_path / "in" / "a.fastq", random_seqs(rng, 60, 60))
    kw = dict(reads_per_chunk=16, checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_every=1, table_slots=1500)
    _port(tmp_path, mesh8, kmer_length=31, canonical=True, **kw)
    assert any(f.startswith("mesh.e") for f in os.listdir(tmp_path / "ckpt"))
    out, stats = _port(tmp_path, mesh8, kmer_length=15, **kw)
    assert out == golden_bytes(tmp_path, 15, False)
    assert stats.reads == 60


def test_run_count_takes_the_mesh_for_mesh_shape(tmp_path, rng):
    """run_count's dispatch, as in the JAX package: meshShape selects the
    mesh engine, whose default mesh is the first meshShape[0] visible
    devices (the CPU is one), and profile=true traces it."""
    (tmp_path / "in").mkdir()
    write_fastq(tmp_path / "in" / "a.fastq", random_seqs(rng, 40, 50))
    opts = Options(kmer_length=15, input_dir=str(tmp_path / "in"), output_file=str(tmp_path / "o.bin"),
                   mesh_shape=(4,), profile=True, verbose=0, reads_per_chunk=8)
    engines = []
    real = MeshCountEngine.run

    def run(self):
        engines.append(self)
        return real(self)

    MeshCountEngine.run = run
    try:
        run_count(opts, CPU)
    finally:
        MeshCountEngine.run = real
    assert len(engines) == 1 and engines[0].mesh.size == 1
    assert (tmp_path / "o.bin").read_bytes() == golden_bytes(tmp_path, 15, False)
    assert (tmp_path / "o.bin.trace" / "trace.json").exists()
