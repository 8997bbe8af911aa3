"""The port's sharded counters (kmer_counter_tpu_torch.parallel.pipeline) on
an 8-position CPU mesh against the JAX counters on conftest's 8 virtual
CPU devices: the same chunks give the same finalize and the same
finalize_local part for every position; and the sentinel that the port
puts into every empty prefix slot where the JAX mesh puts key 0 (growth,
restore, reset)."""

import numpy as np
import pytest
import torch

from kmer_counter_tpu import golden
from kmer_counter_tpu.parallel.mesh import make_mesh as jax_make_mesh
from kmer_counter_tpu.parallel import pipeline as jax_pipeline
from kmer_counter_tpu_torch.ops.u32 import to_numpy
from kmer_counter_tpu_torch.parallel import pipeline
from kmer_counter_tpu_torch.parallel.mesh import make_mesh

CPU = torch.device("cpu")
D = 8
M = np.uint32(0xFFFFFFFF)


@pytest.fixture(scope="module")
def meshes():
    return jax_make_mesh(D), make_mesh(devices=[CPU] * D)


def _counters(meshes, two_level, k, canonical, rpd, L, slots):
    jmesh, pmesh = meshes
    if two_level:
        cp = max(slots // 4, 1)
        args = (k, canonical, cp, slots - cp, rpd, L)
        return jax_pipeline.ShardedCounter2(jmesh, *args), pipeline.ShardedCounter2(pmesh, *args)
    args = (k, canonical, slots, rpd, L)
    return jax_pipeline.ShardedCounter(jmesh, *args), pipeline.ShardedCounter(pmesh, *args)


def _as_counter(lanes, counts):
    from kmer_counter_tpu import records

    words = records.lanes_to_words(np.asarray(lanes))
    return {tuple(w): int(c) for w, c in zip(words.tolist(), np.asarray(counts).tolist())}


def _check_equal(jc, pc, want=None):
    parts_j, parts_p = jc.finalize_local(), pc.finalize_local()
    assert [p[0] for p in parts_p] == [p[0] for p in parts_j] == list(range(D))
    for (_, jl, jcnt), (_, pl, pcnt) in zip(parts_j, parts_p):
        np.testing.assert_array_equal(pl, np.asarray(jl))
        np.testing.assert_array_equal(pcnt, np.asarray(jcnt))
    lanes, counts = pc.finalize()
    np.testing.assert_array_equal(lanes, np.concatenate([p[1] for p in parts_j]))
    np.testing.assert_array_equal(counts, np.concatenate([p[2] for p in parts_j]))
    np.testing.assert_array_equal(pc.splitters, np.asarray(jc._splitters))
    if want is not None:
        assert _as_counter(lanes, counts) == want
    return lanes


@pytest.mark.parametrize("two_level", [True, False], ids=["two", "one"])
@pytest.mark.parametrize("k,canonical", [(15, False), (31, True), (55, False)])
def test_counters_match_jax_finalize_and_parts(meshes, make_reads, two_level, k, canonical):
    L = max(k + 15, 60)
    jc, pc = _counters(meshes, two_level, k, canonical, 4, L, 4096)
    want = {}
    for _ in range(3):
        reads = make_reads(D * 4, L, invalid_frac=0.03)
        for key, c in golden.count_reads(reads, k, canonical).items():
            want[key] = want.get(key, 0) + c
        jc.step(reads)
        pc.step(reads)
    lanes = _check_equal(jc, pc, want)
    keys = list(map(tuple, lanes.tolist()))
    assert keys == sorted(keys)
    assert pc.position_consolidations >= D


@pytest.mark.parametrize("two_level", [True, False], ids=["two", "one"])
def test_consolidation_pressure_matches_jax(meshes, make_reads, two_level):
    """Tables a few chunks wide: every position consolidates (and the
    two-level prefix grows) several times before the finalize."""
    k, L = 15, 40
    jc, pc = _counters(meshes, two_level, k, False, 2, L, 256)
    want = {}
    for _ in range(6):
        reads = make_reads(D * 2, L)
        for key, c in golden.count_reads(reads, k).items():
            want[key] = want.get(key, 0) + c
        jc.step(reads)
        pc.step(reads)
    _check_equal(jc, pc, want)
    assert pc.position_consolidations >= 2 * D


def _prefixes(pc):
    return [(to_numpy(t.prefix_lanes), to_numpy(t.prefix_counts)) for t in pc.tables]


def _jax_prefixes(jc):
    lanes = np.asarray(jc.prefix_lanes).reshape(jc.NL, D, -1)
    counts = np.asarray(jc.prefix_counts).reshape(D, -1)
    return [(lanes[:, d], counts[d]) for d in range(D)]


def _assert_sentinel_tail(prefixes, lives):
    for (lanes, counts), u in zip(prefixes, lives):
        assert (lanes[:, u:] == M).all() and (counts[u:] == 0).all()
        assert (counts[:u] > 0).all()
        keys = [tuple(r) for r in lanes.T.tolist()]
        assert keys == sorted(keys)  # ascending, as K1 requires


def test_grown_prefix_holds_the_sentinel(meshes, make_reads, monkeypatch):
    """A consolidation that grows the prefix (live + raw > CP): as K1 gets
    it, each position's grown prefix holds its live rows, then the
    sentinel key with count 0.  The JAX ``_grow_prefix`` fills the new
    slots with key 0, so its prefix is not ascending (the fault of its
    grow2, ROADMAP Queue 3)."""
    from kmer_counter_tpu_torch.ops import table2 as t2

    k, L = 15, 40
    jc, pc = _counters(meshes, True, k, False, 2, L, 256)
    for _ in range(4):
        reads = make_reads(D * 2, L)
        jc.step(reads)
        pc.step(reads)
    lives, cp = list(pc.live), pc.CP
    seen, real = [], t2.consolidate3

    def capture(table, **kw):
        seen.append((to_numpy(table.prefix_lanes), to_numpy(table.prefix_counts)))
        return real(table, **kw)

    monkeypatch.setattr(t2, "consolidate3", capture)
    pc.consolidate()
    assert pc.CP > cp and len(seen) == D and min(lives) > 0
    _assert_sentinel_tail(seen, lives)
    jc._grow_prefix(pc.CP)
    for lanes, counts in _jax_prefixes(jc):
        assert (lanes[:, cp:] == 0).all() and (counts[cp:] == 0).all()
        assert (np.diff(lanes[0].astype(np.int64)) < 0).any()  # not ascending


def _items(rng, NL, sizes):
    out = []
    for pos, u in enumerate(sizes):
        keys = np.unique(rng.integers(0, 2**32, size=(2 * u, NL), dtype=np.uint64).astype(np.uint32), axis=0)[:u]
        out.append((pos, keys, rng.integers(1, 5, size=len(keys)).astype(np.uint32), pos))
    return out


def test_restored_prefix_holds_the_sentinel(meshes):
    """import_positions (a mesh snapshot's resume) into a prefix larger
    than the snapshot: the port pads each position with the sentinel, the
    JAX restore with key 0; both export the same rows back."""
    jc, pc = _counters(meshes, True, 31, True, 2, 60, 1024)
    items = _items(np.random.default_rng(5), 2, [40, 0, 17, 90, 3, 60, 8, 25])
    jc.import_positions(items)
    pc.import_positions(items)
    assert pc.CP == jc.CP > 90
    _assert_sentinel_tail(_prefixes(pc), [len(c) for _, _, c, _ in items])
    for (jl, jcnt), (_, _, c, _) in zip(_jax_prefixes(jc), items):
        assert (jl[:, len(c):] == 0).all() and (jcnt[len(c):] == 0).all()
    for (pp, pl, pcnt, pa), (jp, jl, jcnt, ja) in zip(pc.export_positions(), jc.export_positions()):
        assert (pp, pa) == (jp, ja)
        np.testing.assert_array_equal(pl, np.asarray(jl))
        np.testing.assert_array_equal(pcnt, np.asarray(jcnt))


def test_reset_prefix_holds_the_sentinel(meshes, make_reads):
    """reset (after a spill): every prefix slot of the port holds the
    sentinel with count 0, as at creation; the JAX reset zeroes only the
    counts, leaving the old keys.  The counts after a reset are those of
    the chunks that follow it."""
    k, L = 15, 40
    jc, pc = _counters(meshes, True, k, False, 2, L, 256)
    for _ in range(3):
        reads = make_reads(D * 2, L)
        jc.step(reads)
        pc.step(reads)
    jc.consolidate()
    pc.consolidate()
    jc.reset()
    pc.reset()
    _assert_sentinel_tail(_prefixes(pc), [0] * D)
    assert any((lanes != M).any() for lanes, _ in _jax_prefixes(jc))
    want = {}
    for _ in range(2):
        reads = make_reads(D * 2, L)
        for key, c in golden.count_reads(reads, k).items():
            want[key] = want.get(key, 0) + c
        jc.step(reads)
        pc.step(reads)
    _check_equal(jc, pc, want)
    assert pc.allt_total() == jc.allt_total() == 0


@pytest.mark.parametrize("processes", [1, 2, 3])
def test_file_shard_is_the_jax_round_robin(tmp_path, monkeypatch, processes):
    """The mesh engine's file split (io.fastq ``shard=(rank, processes)``,
    whole files round-robin when there are as many files as processes):
    each rank's files are those the JAX ``process_shard`` gives each jax
    process."""
    import jax

    from kmer_counter_tpu.parallel import mesh as jax_mesh
    from kmer_counter_tpu_torch.io.fastq import scan_fastq_dir

    for i in range(7):
        (tmp_path / f"f{i}.fastq").write_text("@r\nACGT\n+\nIIII\n")
    every, _ = scan_fastq_dir(str(tmp_path))
    monkeypatch.setattr(jax, "process_count", lambda: processes)
    for rank in range(processes):
        monkeypatch.setattr(jax, "process_index", lambda: rank)
        paths, byte_shard = scan_fastq_dir(str(tmp_path), shard=(rank, processes))
        assert byte_shard is None
        assert paths == jax_mesh.process_shard(every)
