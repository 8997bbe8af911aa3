"""Port two-level table (ops.table2) vs the JAX two-level table and golden.

Chunk rounds go through the port's table (append, consolidate3 with the
merge-fold-compact plain version on CPU, grow2, finalize_host) and
through the JAX table (append_raw, consolidate2 on CPU, finalize_host);
the finalized outputs must be equal, and equal to golden.
table_from_numpy / table_to_numpy carry one identical state across.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_counter_tpu import golden, records
from kmer_counter_tpu.ops import table2 as jt2
from kmer_counter_tpu.ops.pipeline import extract_chunk_keys as jax_extract
from kmer_counter_tpu_torch.ops import table2 as t2
from kmer_counter_tpu_torch.ops.pipeline import count_step_two_level
from kmer_counter_tpu_torch.ops.u32 import from_numpy, to_numpy

from conftest import random_reads
from tests.test_torch_cuda import CONSOLIDATE_VARIANTS

CPU = torch.device("cpu")


def port_rounds(chunks, k, canonical, cp, cr, consolidate_every=None, merged=None, **variant):
    """The engine's loop in small: consolidate when the raw region is full
    (or every few chunks), pre-growing the prefix to live + raw first.
    ``variant``: consolidate3's keywords; ``merged``: a list that gets each
    consolidation's (prefix lanes, prefix counts, live, lost)."""
    table = t2.make_table2(cp, cr, records.active_lanes(k), CPU)
    live = 0
    for i, reads in enumerate(chunks):
        width = reads.shape[0] * (reads.shape[1] - k + 1)
        if table.raw_off + width > table.raw_lanes.shape[1] or (
            consolidate_every and i and i % consolidate_every == 0
        ):
            if live + table.raw_off > table.prefix_lanes.shape[1]:
                table = t2.grow2(table, live + table.raw_off, cr)
            table, live, lost = t2.consolidate3(table, **variant)
            assert lost == 0
            if merged is not None:
                merged.append((*t2.table_to_numpy(table)[:2], live, lost))
        count_step_two_level(table, torch.from_numpy(reads), k, canonical)
    if live + table.raw_off > table.prefix_lanes.shape[1]:
        table = t2.grow2(table, live + table.raw_off, cr)
    return table


def jax_rounds(chunks, k, canonical, cp, cr, consolidate_every=None):
    table = jt2.make_table2(cp, cr, records.active_lanes(k))
    for i, reads in enumerate(chunks):
        lanes, allt = jax_extract(jnp.asarray(reads), k, canonical)
        if int(table.raw_off) + lanes.shape[1] > cr or (
            consolidate_every and i and i % consolidate_every == 0
        ):
            table, _, lost = jt2.consolidate2(table)
            assert int(lost) == 0
        table = jt2.append_raw(table, lanes, allt)
    return table


def golden_table(chunks, k, canonical):
    words, counts = golden.table_from_counter(golden.count_reads(np.vstack(chunks), k, canonical))
    return records.words_to_lanes(words)[:, : records.active_lanes(k)], counts


def on_host(out):
    """A finalize's table as host rows: the port's (lanes [NL, U] tensor,
    counts, all-T count) with the all-T record appended as the last row,
    as the JAX package's finalize_host returns it."""
    if len(out) == 2:
        return out
    lanes, counts, allt = out
    lanes = to_numpy(lanes).T
    if allt:
        lanes = np.concatenate([lanes, np.full((1, lanes.shape[1]), 0xFFFFFFFF, np.uint32)])
        counts = np.concatenate([counts, np.asarray([allt], np.uint32)])
    return lanes, counts


def assert_same(port_out, jax_out, want):
    for got in (on_host(port_out), on_host(jax_out)):
        np.testing.assert_array_equal(got[0], want[0].reshape(got[0].shape))
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("k", [4, 15, 31, 55])
@pytest.mark.parametrize("canonical", [False, True])
def test_rounds_match_jax_and_golden(rng, k, canonical):
    L = max(k + 9, 40)
    chunks = [random_reads(rng, 12, L, invalid_frac=0.05) for _ in range(5)]
    P = L - k + 1
    # the port starts from a tiny prefix, so it must grow; JAX's is sized
    port = port_rounds(chunks, k, canonical, cp=16, cr=2 * 12 * P, consolidate_every=2)
    jax_t = jax_rounds(chunks, k, canonical, cp=4 * 12 * P, cr=2 * 12 * P, consolidate_every=2)
    assert port.prefix_lanes.shape[1] > 16
    assert_same(t2.finalize_host(port, k), jt2.finalize_host(jax_t, k), golden_table(chunks, k, canonical))


@pytest.mark.parametrize("canonical", [False, True])
def test_all_t_side_count_k16(rng, canonical):
    k = 16
    base = random_reads(rng, 6, 40, invalid_frac=0.02)
    allt_reads = np.full((3, 40), ord("T"), np.uint8)
    allt_reads[1, 5] = ord("N")
    chunks = [base, allt_reads, base]
    port = port_rounds(chunks, k, canonical, cp=64, cr=256, consolidate_every=1)
    jax_t = jax_rounds(chunks, k, canonical, cp=4096, cr=256, consolidate_every=1)
    assert (int(port.allt) > 0) == (not canonical)
    port_out = t2.finalize_host(port, k)
    assert_same(port_out, jt2.finalize_host(jax_t, k), golden_table(chunks, k, canonical))
    # T^k's count comes back beside the table, for the last, maximum record
    assert (port_out[2] > 0) == (not canonical)
    if not canonical:
        assert (on_host(port_out)[0][-1] == 0xFFFFFFFF).all()


@pytest.mark.parametrize("k,canonical", [(15, False), (31, True), (55, False)])
def test_identical_state_carried_from_jax(rng, k, canonical):
    """A JAX table mid-run (consolidated prefix + pending raw rows) becomes a
    port table through table_from_numpy; both finalize to the same table."""
    L = k + 15
    chunks = [random_reads(rng, 10, L, invalid_frac=0.03) for _ in range(3)]
    P = L - k + 1
    jax_t = jax_rounds(chunks, k, canonical, cp=8 * 10 * P, cr=2 * 10 * P, consolidate_every=2)
    assert int(jax_t.raw_off) > 0
    pl, pc = np.asarray(jax_t.prefix_lanes), np.asarray(jax_t.prefix_counts)
    # consolidate2's prefix is ascending with (sentinel, 0) empty slots and
    # at most two rows per key: a valid K1 input as it stands
    assert (np.lexsort(pl[::-1]) == np.arange(pl.shape[1])).all()  # stable: sorted ⇔ identity
    assert (pl[:, pc == 0] == 0xFFFFFFFF).all()
    port = t2.table_from_numpy(pl, pc, np.asarray(jax_t.raw_lanes), int(jax_t.raw_off),
                               int(jax_t.allt), CPU)
    port = t2.grow2(port, pl.shape[1] + port.raw_off, port.raw_lanes.shape[1])
    assert_same(t2.finalize_host(port, k), jt2.finalize_host(jax_t, k), golden_table(chunks, k, canonical))


def test_table_numpy_round_trip(rng):
    state = (
        rng.integers(0, 2**32, (3, 40), dtype=np.uint64).astype(np.uint32),
        rng.integers(0, 2**32, 40, dtype=np.uint64).astype(np.uint32),
        rng.integers(0, 2**32, (3, 30), dtype=np.uint64).astype(np.uint32),
        7,
        0xFFFFFFF0,
    )
    back = t2.table_to_numpy(t2.table_from_numpy(*state, CPU))
    for got, want in zip(back, state):
        np.testing.assert_array_equal(got, want)


def test_grow2_pads_with_sentinel_and_keeps_state():
    table = t2.make_table2(4, 6, 2, CPU)
    table.prefix_lanes[:, :2] = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    table.prefix_counts[:2] = torch.tensor([5, 6], dtype=torch.int32)
    table.raw_lanes[:, :3] = 9
    table.raw_off = 3
    grown = t2.grow2(table, 10, 8)
    pl, pc, rl, off, allt = t2.table_to_numpy(grown)
    assert pl.shape == (2, 10) and rl.shape == (2, 8) and off == 3
    assert (pl[:, 2:] == 0xFFFFFFFF).all() and (pc[2:] == 0).all()
    np.testing.assert_array_equal(pl[:, :2], [[1, 2], [3, 4]])
    np.testing.assert_array_equal(rl[:, :3], 9)
    assert t2.grow2(grown, 12, 8).raw_lanes is grown.raw_lanes  # same raw size: shared
    with pytest.raises(ValueError):
        t2.grow2(grown, 5, 8)


def test_grow2_shrinks_the_raw_region_to_its_rows_in_use():
    """An unchanged prefix is shared; a shrunk raw region keeps its rows in
    use and is zero past them; no region shrinks below those rows."""
    table = t2.make_table2(4, 8, 2, CPU)
    table.raw_lanes[:, :3] = 9
    table.raw_lanes[:, 3:] = 7  # stale rows past raw_off
    table.raw_off = 3
    shrunk = t2.grow2(table, 4, 5)
    assert shrunk.prefix_lanes is table.prefix_lanes and shrunk.prefix_counts is table.prefix_counts
    _, _, rl, off, _ = t2.table_to_numpy(shrunk)
    assert rl.shape == (2, 5) and off == 3
    np.testing.assert_array_equal(rl[:, :3], 9)
    assert (rl[:, 3:] == 0).all()
    assert t2.grow2(table, 4, 3).raw_lanes.shape == (2, 3)
    with pytest.raises(ValueError):
        t2.grow2(table, 4, 2)


def test_consolidate3_reports_lost_and_finalize_raises(rng):
    k = 15
    reads = random_reads(rng, 8, 40)
    table = t2.make_table2(4, 8 * 26, 1, CPU)  # far too small a prefix
    count_step_two_level(table, torch.from_numpy(reads), k, False)
    _, live, lost = t2.consolidate3(t2.make_table2(4, 8 * 26, 1, CPU))
    assert (live, lost) == (0, 0)
    with pytest.raises(RuntimeError, match="truncated"):
        t2.finalize_host(table, k)
    _, live, lost = t2.consolidate3(table)
    assert live == 4 and lost > 0


def test_finalize_raises_when_all_t_key_leaked():
    table = t2.make_table2(4, 4, 1, CPU)
    table.prefix_lanes[0, 0] = -1  # the all-T key inside the stream
    table.prefix_counts[0] = 2
    table.allt += 1
    with pytest.raises(RuntimeError, match="all-T key present"):
        t2.finalize_host(table, 16)


def _sorted_sizes(monkeypatch):
    """Records the row count of every sort that sort_reduce makes."""
    from kmer_counter_tpu_torch.ops import lane_sort

    sizes, real = [], lane_sort.sort_ops

    def recording(keys, payload):
        sizes.append(keys.shape[1])
        return real(keys, payload)

    monkeypatch.setattr(lane_sort, "sort_ops", recording)
    return sizes


@pytest.mark.parametrize("k,canonical", [(16, False), (31, True), (55, False)])
def test_finalize_with_live_bound_matches_whole_prefix(rng, monkeypatch, k, canonical):
    L = k + 15
    chunks = [random_reads(rng, 10, L, invalid_frac=0.03) for _ in range(3)]
    chunks[1][2] = ord("T")
    P = L - k + 1
    port = port_rounds(chunks, k, canonical, cp=8 * 10 * P, cr=2 * 10 * P, consolidate_every=2)
    port, live, lost = t2.consolidate3(port)
    assert lost == 0 and 0 < live < port.prefix_lanes.shape[1]
    sizes = _sorted_sizes(monkeypatch)
    bounded = t2.finalize_host(port, k, live)
    assert sizes == [live]  # only the live rows were sorted
    whole = t2.finalize_host(port, k)
    assert sizes[1:] == [port.prefix_lanes.shape[1]]
    assert_same(bounded, whole, golden_table(chunks, k, canonical))


@pytest.mark.parametrize("k,canonical", [(15, False), (31, True)])
def test_finalize_with_live_bound_on_a_jax_carried_table(rng, k, canonical):
    """consolidate2's prefix may hold two rows of one key among its live
    rows: the bound still covers them, and sort_reduce folds them."""
    L = k + 15
    chunks = [random_reads(rng, 10, L, invalid_frac=0.03) for _ in range(3)]
    P = L - k + 1
    jax_t = jax_rounds(chunks, k, canonical, cp=8 * 10 * P, cr=2 * 10 * P, consolidate_every=2)
    jax_t, live, lost = jt2.consolidate2(jax_t)
    assert int(lost) == 0 and int(jax_t.raw_off) == 0
    port = t2.table_from_numpy(np.asarray(jax_t.prefix_lanes), np.asarray(jax_t.prefix_counts),
                               np.asarray(jax_t.raw_lanes), 0, int(jax_t.allt), CPU)
    assert_same(t2.finalize_host(port, k, int(live)), t2.finalize_host(port, k),
                golden_table(chunks, k, canonical))


def test_engine_finalize_sorts_only_the_live_rows(tmp_path, rng, monkeypatch):
    from kmer_counter_tpu.config import Options
    from kmer_counter_tpu_torch.engine import CountEngine

    from tests.test_ingest import random_seqs, write_fastq

    (tmp_path / "in").mkdir()
    write_fastq(tmp_path / "in" / "a.fastq", random_seqs(rng, 40, 60))
    sizes = _sorted_sizes(monkeypatch)
    opts = Options(kmer_length=21, input_dir=str(tmp_path / "in"), output_file=str(tmp_path / "o.bin"),
                   verbose=0, reads_per_chunk=4, table_slots=64, table_impl="two")
    stats = CountEngine(opts, device=CPU).run()
    assert sizes == [stats.distinct_kmers]  # the one sort of the run: finalize's


def _jax_table(port_table):
    """A JAX TwoLevelTable holding the port table's state (its prefix is
    padded with the sentinel, which the ascending merges need)."""
    pl, pc, rl, off, allt = t2.table_to_numpy(port_table)
    return jt2.TwoLevelTable(jnp.asarray(pl), jnp.asarray(pc), jnp.asarray(rl), jnp.int32(off),
                             jnp.uint32(allt))


@pytest.mark.parametrize("variant", sorted(CONSOLIDATE_VARIANTS))
def test_consolidate3_variants_match_jax(rng, variant):
    """Each keyword combination against the JAX consolidate3 of the same
    keywords (Pallas in interpret mode, one 64K tile): a consolidation in
    the middle of the run and one at its end, on one identical state."""
    kw = CONSOLIDATE_VARIANTS[variant]
    k, canonical = 15, True
    table = t2.make_table2(16384, 49152, 1, CPU)  # CP + CR == pallas_sort.TILE
    chunks = [random_reads(rng, 16, 40, invalid_frac=0.05) for _ in range(4)]
    for i, reads in enumerate([*chunks, None]):
        if i in (2, len(chunks)):
            want, want_live, want_lost = jt2.consolidate3(_jax_table(table), _interpret=True, **kw)
            table, live, lost = t2.consolidate3(table, **kw)
            assert (live, lost) == (int(want_live), int(want_lost)) and live > 0
            np.testing.assert_array_equal(t2.table_to_numpy(table)[0], np.asarray(want.prefix_lanes))
            np.testing.assert_array_equal(t2.table_to_numpy(table)[1], np.asarray(want.prefix_counts))
        if reads is not None:
            count_step_two_level(table, torch.from_numpy(reads), k, canonical)
    assert_same(t2.finalize_host(table, k, live), golden_table(chunks, k, canonical),
                golden_table(chunks, k, canonical))


@pytest.mark.parametrize("k,canonical", [(16, False), (31, True), (55, False)])
def test_consolidate3_variants_agree(rng, k, canonical):
    """All four keyword combinations give the same (table', live, lost) at
    every consolidation of a run that grows its prefix."""
    L = k + 15
    chunks = [random_reads(rng, 10, L, invalid_frac=0.03) for _ in range(6)]
    chunks[2][1] = ord("T")  # all-T windows: the side count at k=16 forward
    P = L - k + 1
    runs = {}
    for name, kw in CONSOLIDATE_VARIANTS.items():
        runs[name] = []
        table = port_rounds(chunks, k, canonical, cp=16, cr=2 * 10 * P, consolidate_every=2,
                            merged=runs[name], **kw)
        assert_same(t2.finalize_host(table, k), golden_table(chunks, k, canonical),
                    golden_table(chunks, k, canonical))
    want = runs["merge_fold_compact"]
    assert len(want) >= 2
    for name, got in runs.items():
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[0], w[0])
            np.testing.assert_array_equal(g[1], w[1])
            assert g[2:] == w[2:], name


def test_split_variant_helpers_match_jax(rng):
    """The torch helpers between the kernels against their XLA originals:
    the ascending raw sorts with liveness or multiplicities, and the fold
    onto run heads."""
    raw = rng.integers(0, 6, (2, 300)).astype(np.uint32)
    raw[:, 40:50] = 0xFFFFFFFF  # masked windows
    raw_off = 250
    port = t2.table_from_numpy(np.zeros((2, 1), np.uint32), np.zeros(1, np.uint32), raw, raw_off, 0, CPU)
    for port_fn, jax_fn in ((t2._sort_raw_ones, jt2._c3_sort_raw_ones), (t2._sort_raw, jt2._c3_sort_raw)):
        s, c = port_fn(port.raw_lanes, raw_off)
        ws, wc = jax_fn(jnp.asarray(raw), jnp.int32(raw_off))
        np.testing.assert_array_equal(to_numpy(s), np.asarray(ws))
        np.testing.assert_array_equal(to_numpy(c), np.asarray(wc))
    counts = rng.integers(0, 2**32, 300, dtype=np.uint64).astype(np.uint32)
    folded = t2._fold_counts_in_place(s, from_numpy(counts, CPU))
    want = jt2._fold_counts_in_place(jnp.asarray(to_numpy(s)), jnp.asarray(counts))
    np.testing.assert_array_equal(to_numpy(folded), np.asarray(want))


@pytest.mark.parametrize("variant", sorted(CONSOLIDATE_VARIANTS))
def test_consolidate3_that_loses_records_matches_jax(rng, variant):
    """More live records than prefix slots: each variant's compacting
    kernel writes only the CP prefix columns, and live, lost and the prefix
    equal the JAX consolidate3's (Pallas in interpret mode, one 64K tile)."""
    CP, CR = 1024, 64512  # CP + CR == pallas_sort.TILE
    keys = np.unique(rng.integers(0, 2**32 - 1, 4000, dtype=np.uint64).astype(np.uint32))
    prefix = np.sort(rng.choice(keys, 600, replace=False))
    pl = np.full((1, CP), 0xFFFFFFFF, np.uint32)
    pc = np.zeros(CP, np.uint32)
    pl[0, :600], pc[:600] = prefix, rng.integers(1, 6, 600)
    raw = np.zeros((1, CR), np.uint32)
    raw_off = 5000
    raw[0, :raw_off] = rng.choice(keys, raw_off)
    raw[0, rng.integers(0, raw_off, 50)] = 0xFFFFFFFF  # masked windows
    table = t2.table_from_numpy(pl, pc, raw, raw_off, 0, CPU)
    kw = CONSOLIDATE_VARIANTS[variant]
    want, want_live, want_lost = jt2.consolidate3(_jax_table(table), _interpret=True, **kw)
    got, live, lost = t2.consolidate3(table, **kw)
    assert (live, lost) == (int(want_live), int(want_lost)) and live == CP and lost > 0
    np.testing.assert_array_equal(t2.table_to_numpy(got)[0], np.asarray(want.prefix_lanes))
    np.testing.assert_array_equal(t2.table_to_numpy(got)[1], np.asarray(want.prefix_counts))


def _sorted_with_counts(rng, NL, n, n_sent, run_len):
    """Sorted keys [NL, n] in runs of up to run_len rows, the last n_sent
    rows the sentinel, and uint32 counts (a tenth near 2^32, so totals
    wrap)."""
    keys = np.sort(rng.integers(0, max(n // run_len, 1), n)).astype(np.uint32)
    lanes = np.zeros((NL, n), np.uint32)
    lanes[-1] = keys
    lanes[:, n - n_sent :] = 0xFFFFFFFF
    counts = rng.integers(0, 6, n).astype(np.uint32)
    counts[rng.random(n) < 0.1] = rng.integers(2**31, 2**32, dtype=np.uint64)
    return lanes, counts


@pytest.mark.parametrize("piece", [1, 3, 64, 1 << 24])
@pytest.mark.parametrize("shape", [(1, 500, 40, 3), (2, 777, 0, 50), (1, 300, 300, 5), (2, 1000, 1, 400)])
def test_fold_in_pieces_matches_jax(rng, monkeypatch, piece, shape):
    """K5's fold (the split variant without a folding merge), in place and
    piece by piece over the rows before the sentinel tail, against the JAX
    _fold_counts_in_place: runs longer than a piece, totals that wrap, no
    sentinel tail, only sentinel rows."""
    monkeypatch.setattr(t2, "FOLD_PIECE", piece)
    lanes, counts = _sorted_with_counts(rng, *shape)
    port_counts = from_numpy(counts, CPU)
    folded = t2._fold_counts_in_place(from_numpy(lanes, CPU), port_counts)
    assert folded is port_counts  # written in place
    want = jt2._fold_counts_in_place(jnp.asarray(lanes), jnp.asarray(counts))
    np.testing.assert_array_equal(to_numpy(folded), np.asarray(want))
