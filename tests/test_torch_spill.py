"""Spilling to disk in the port's engine (``tempFileLocation``): both
tables against the JAX engine and golden, and the spill decision that
keeps a run under its budget (kmer_counter_tpu_torch.budget)."""

import pytest
import torch

from kmer_counter_tpu.config import Options
from kmer_counter_tpu.engine import CountEngine as JaxCountEngine
from kmer_counter_tpu_torch import budget as bg
from kmer_counter_tpu_torch import records
from kmer_counter_tpu_torch.engine import CountEngine, plan_chunks
from kmer_counter_tpu_torch.ops.pipeline import chunk_slots

from tests.test_ingest import random_seqs, write_fastq
from tests.test_torch_engine import golden_bytes

CPU = torch.device("cpu")
BUDGET_2E9 = 2_000_000_000


def _input(tmp_path, rng, n_reads, length, all_t=False):
    (tmp_path / "in").mkdir()
    seqs = random_seqs(rng, n_reads, length)
    for i in range(0, n_reads, 3):  # N bases in every third read
        p = int(rng.integers(0, length))
        seqs[i] = seqs[i][:p] + "N" + seqs[i][p + 1 :]
    if all_t:
        seqs[3] = "T" * length
    write_fastq(tmp_path / "in" / "a.fastq", seqs[: n_reads // 2])
    write_fastq(tmp_path / "in" / "b.fastq", seqs[n_reads // 2 :])


def _run_both(tmp_path, k, canonical, impl, **kw):
    """The port's and the JAX engine's dumps and stats, each spilling to a
    temp dir of its own."""
    outs, stats = [], []
    for name, engine in (("port", lambda o: CountEngine(o, device=CPU)), ("jax", JaxCountEngine)):
        opts = Options(kmer_length=k, canonical=canonical, input_dir=str(tmp_path / "in"),
                       output_file=str(tmp_path / f"{name}.bin"), temp_dir=str(tmp_path / f"tmp_{name}"),
                       table_impl=impl, verbose=0, **kw)
        stats.append(engine(opts).run())
        outs.append((tmp_path / f"{name}.bin").read_bytes())
    return outs, stats


@pytest.mark.parametrize("impl", ["two", "one"])
def test_engine_spill_path_matches_jax_and_golden(tmp_path, rng, impl):
    """tests/test_spill.py::test_engine_spill_path on the port, with each
    table: at least one mid-run spill and the final run."""
    (tmp_path / "in").mkdir()
    write_fastq(tmp_path / "in" / "a.fastq", random_seqs(rng, 80, 40))
    (port, jax_out), (ps, js) = _run_both(tmp_path, 15, False, impl, reads_per_chunk=4, table_slots=400)
    assert ps.spilled_runs >= 2
    assert port == jax_out == golden_bytes(tmp_path, 15, False)
    for field in ("reads", "bases", "chunks", "distinct_kmers", "total_kmers"):
        assert getattr(ps, field) == getattr(js, field), field
    assert not list((tmp_path / "tmp_port").glob("*.run"))  # the merge consumed every run


@pytest.mark.parametrize("impl", ["two", "one"])
@pytest.mark.parametrize("k,canonical,all_t", [(16, False, True), (31, True, False), (55, False, False)])
def test_spill_at_other_widths_matches_jax_and_golden(tmp_path, rng, impl, k, canonical, all_t):
    """Several key lanes, canonical keys, and (k=16 forward) the all-T
    k-mer, which the two-level table counts on the side: the port keeps it
    out of the spill runs and writes it once, with the final table."""
    _input(tmp_path, rng, 96, 70, all_t)
    (port, jax_out), (ps, _) = _run_both(tmp_path, k, canonical, impl, reads_per_chunk=4, table_slots=300)
    assert ps.spilled_runs >= 2
    assert port == jax_out == golden_bytes(tmp_path, k, canonical)


def test_spill_under_a_byte_budget_matches_golden(tmp_path, rng, monkeypatch):
    """Without tableSlots the cap is gpuMemoryLimit, through the peak
    model: the 2e9 plan of the chip's spill phase scaled down 1000x (a
    2e6-byte budget, the model without its allocator slack), on reads whose
    k-mers are nearly all distinct.  The two-level table spills rather
    than grow its prefix past the budget."""
    monkeypatch.setattr(bg, "_ALLOCATOR_SLACK", 0)
    (tmp_path / "in").mkdir()
    write_fastq(tmp_path / "in" / "a.fastq", random_seqs(rng, 3500, 60))
    opts = Options(kmer_length=21, input_dir=str(tmp_path / "in"), output_file=str(tmp_path / "o.bin"),
                   temp_dir=str(tmp_path / "tmp"), memory_limit_bytes=2_000_000, table_impl="two",
                   verbose=0)
    assert plan_chunks(opts, 60) == (173, 27_777)
    stats = CountEngine(opts, device=CPU).run()
    assert stats.spilled_runs >= 3
    assert (tmp_path / "o.bin").read_bytes() == golden_bytes(tmp_path, 21, False)


def _plan(k=31, L=100, limit=BUDGET_2E9):
    opts = Options(kmer_length=k, memory_limit_bytes=limit, temp_dir="t", input_dir="in", output_file="o")
    reads_per_chunk, table_slots = plan_chunks(opts, L)
    NL = records.active_lanes(k)
    slots = chunk_slots(reads_per_chunk, L, k)
    cp = max(table_slots // 8, 1)
    cr = max(table_slots - cp, slots)
    return opts, NL, cp, cr, slots, bg.Chunk(reads_per_chunk * L, slots), table_slots


def test_two_level_spill_decision_keeps_the_2e9_plan_under_budget():
    """The spill phase's plan (k=31, 100 bp reads, gpuMemoryLimit=2e9) on
    input whose k-mers are all distinct: no consolidation, growth or
    finalize that the cap allows passes the budget by the peak model, and
    the live rows spill several times."""
    opts, NL, cp, cr, slots, chunk, _ = _plan()
    assert (cp, cr, slots) == (3_472_222, 24_305_555, 6_944_420)
    cap = bg.max_prefix_slots(opts, NL, cr, chunk)
    assert cr < cap < 2 * cr
    live = raw = spills = 0
    worst = 0
    for i in range(21):  # about 2M reads
        if raw + slots > cr or i == 20:
            final = i == 20
            if final:
                raw += slots
            new_cp, spill = bg.next_prefix(cap, cp, live, raw)
            if spill:
                spills, live = spills + 1, 0
            assert new_cp <= cap
            peaks = bg.two_level_peaks(NL, new_cp, cr, raw, chunk, grow_from=cp,
                                       finalize_rows=live + raw if final else None)
            worst = max(worst, *peaks.values())
            cp, live, raw = new_cp, min(live + raw, new_cp), 0
        raw += slots
    assert worst <= BUDGET_2E9
    assert spills >= 2


def test_prefix_cap_is_the_largest_prefix_under_budget():
    """max_prefix_slots is the model's own bound, not a margin: at the cap
    every step (a full raw region, a finalize of the whole prefix) fits
    the budget, and one slot more does not; likewise max_table_slots."""
    opts, NL, _, cr, _, chunk, _ = _plan()
    cap = bg.max_prefix_slots(opts, NL, cr, chunk)
    assert max(bg.two_level_peaks(NL, cap, cr, cr, chunk, finalize_rows=cap).values()) <= BUDGET_2E9
    assert max(bg.two_level_peaks(NL, cap + 1, cr, cr, chunk, finalize_rows=cap + 1).values()) > BUDGET_2E9
    table_cap = bg.max_table_slots(opts, NL, chunk)
    assert max(bg.one_level_peaks(NL, table_cap, chunk, grow_from=table_cap // 2).values()) <= BUDGET_2E9
    assert max(bg.one_level_peaks(NL, table_cap + 1, chunk).values()) > BUDGET_2E9


@pytest.mark.parametrize("k", [31, 55])
def test_resume_of_a_full_snapshot_spills_at_the_2e9_plan(k):
    """A one-level snapshot is taken after a consolidation, before the
    spill decision, so at the 2e9 plan it can hold about as many rows as
    the table has slots (25.3M of 27.8M at k=31).  Resumed with room for a
    chunk, the doubled table passes the cap: the engine's resume sizing
    (next_capacity) spills the snapshot's rows and keeps the planned size.
    The two-level resume does the same with a snapshot that passes the
    prefix cap."""
    opts, NL, cp, cr, slots, chunk, table_slots = _plan(k)
    U = table_slots * 911 // 1000
    assert bg.next_capacity(bg.max_table_slots(opts, NL, chunk), table_slots, U + slots) == (table_slots, True)
    assert bg.next_capacity(None, table_slots, U + slots) == (2 * table_slots, False)
    cap = bg.max_prefix_slots(opts, NL, cr, chunk)
    assert bg.next_prefix(cap, cp, cap, 0) == (cap, False)
    assert bg.next_prefix(cap, cp, cap + 1, 0) == (cp, True)


def test_two_level_growth_without_a_budget_passes_it():
    """Why the decision comes before the growth: the geometric pre-grow
    alone (no temp dir, or the JAX rule) reaches a prefix whose raw sort
    passes the 2e9 budget by the model."""
    _, NL, cp, cr, slots, chunk, _ = _plan()
    live = 0
    for _ in range(4):
        raw = 3 * slots
        cp, spill = bg.next_prefix(None, cp, live, raw)
        assert not spill
        live += raw
    assert max(bg.two_level_peaks(NL, cp, cr, 3 * slots, chunk).values()) > BUDGET_2E9


def test_jax_spill_threshold_passes_the_budget():
    """Pins a standing fault of the JAX package (ROADMAP Queue 3): its
    two-level engine spills only once cp + cr passes four times the planned
    table (engine._max_table_slots_two), after growing.  At the 2e9 plan it
    lets the prefix reach 83.3M slots, where the port's model (from the
    peaks measured on the card) puts the raw sort well past 2e9."""
    opts, NL, cp, cr, slots, chunk, _ = _plan()
    jax_cap = JaxCountEngine(opts)._max_table_slots_two(NL)
    live, raw = 0, 3 * slots
    while True:  # the JAX pre-grow: geometric, spilling only past jax_cap
        grown = max(live + raw, 2 * cp) if live + raw > cp else cp
        if grown + cr > jax_cap:
            break
        cp, live = grown, live + raw
    assert cp == 83_333_040 and cp + cr <= jax_cap
    assert bg.two_level_peaks(NL, cp, cr, raw, chunk)["_sort_raw_desc"] > BUDGET_2E9


def test_one_level_spill_decision_keeps_the_2e9_plan_under_budget():
    """The one-level table at the 2e9 plan fits its budget, and doubling it
    would not: a full table spills instead of growing."""
    opts, NL, _, _, slots, chunk, table_slots = _plan()
    cap = bg.max_table_slots(opts, NL, chunk)
    assert table_slots <= cap < 2 * table_slots
    assert max(bg.one_level_peaks(NL, table_slots, chunk).values()) <= BUDGET_2E9
    assert bg.next_capacity(cap, table_slots, table_slots - 10 + slots) == (table_slots, True)
    assert bg.next_capacity(None, table_slots, table_slots - 10 + slots) == (2 * table_slots, False)
    assert bg.next_capacity(cap, table_slots, slots) == (table_slots, False)


# Step peaks that scripts/consolidate_peaks.py measured on an NVIDIA H100
# 80GB HBM3 (700 W): the 2M-read k=31 count at gpuMemoryLimit=8e9 (the
# two-level main path: prefix 166,666,500, raw 97,222,223, 83,333,250 live
# raw rows, 396,825 reads x 100 bp a chunk), and with --spill the 2M-read
# count from a 200-Mbase genome at 2e9 (the largest two-level
# consolidation: prefix 41,666,520 grown from 20,833,260 when the prefix
# could grow that far, 20,833,260 grown from 3,472,222 since it is held to
# max_prefix_slots; raw 24,305,555, 20,833,260 live raw rows; the
# one-level table of 27,777,777 slots; 99,206 reads a chunk), and
# (--spill --k 55, NL=4) the same reads at k=55: prefix 12,499,902 grown
# from 2,083,333, raw 14,583,333, 12,499,902 live raw rows; the one-level
# table of 16,666,666 slots; 90,579 reads a chunk (measured again with
# torch 2.11, the chunk step K8's); and (--workload k55f_two.ecoli) the
# count of gpubench's k55f_two configuration on the ecoli mix, k=55
# forward at 8e9: its second consolidation
# merges 48,234,496 raw rows (four chunks of 262,144 reads x 46 windows;
# each of the 4 files' second chunk, 237,856 reads, staged in a whole
# chunk's rows, the rest masked) into a prefix grown from 48,234,496 to 96,468,992 slots beside
# a raw region of 58,333,333, and the finalize sorts 4,641,581 rows.
MEASURED = [
    ("main", lambda: bg.two_level_peaks(2, 166_666_500, 97_222_223, 83_333_250, bg.Chunk(396_825 * 100, 396_825 * 70)),
     {"_sort_raw_desc": 7_616_856_576, "merge_fold_compact": 5_989_281_280, "count_step_two_level": 4_826_825_216},
     "_sort_raw_desc"),
    ("spill", lambda: bg.two_level_peaks(2, 41_666_520, 24_305_555, 20_833_260, bg.Chunk(99_206 * 100, 99_206 * 70),
                                         grow_from=20_833_260),
     {"_sort_raw_desc": 1_904_750_080, "merge_fold_compact": 1_498_100_224, "count_step_two_level": 1_207_593_472,
      "grow2": 955_069_440},
     "_sort_raw_desc"),
    ("spill_capped", lambda: bg.two_level_peaks(2, 20_833_260, 24_305_555, 20_833_260,
                                                bg.Chunk(99_206 * 100, 99_206 * 70), grow_from=3_472_222),
     {"_sort_raw_desc": 1_654_636_032, "merge_fold_compact": 997_742_592, "count_step_two_level": 957_594_112,
      "grow2": 497_414_144},
     "_sort_raw_desc"),
    ("spill_one", lambda: bg.one_level_peaks(2, 27_777_777, bg.Chunk(99_206 * 100, 99_206 * 70)),
     {"consolidate": 1_509_918_208, "extract_chunk": 846_006_272},
     "consolidate"),
    ("spill_k55", lambda: bg.two_level_peaks(4, 12_499_902, 14_583_333, 12_499_902,
                                             bg.Chunk(90_579 * 100, 90_579 * 46), grow_from=2_083_333),
     {"_sort_raw_desc": 1_632_795_136, "merge_fold_compact": 1_035_023_360, "count_step_two_level": 492_390_912,
      "grow2": 534_610_944},
     "_sort_raw_desc"),
    ("k55f_two", lambda: bg.two_level_peaks(4, 96_468_992, 58_333_333, 48_234_496,
                                            bg.Chunk(262_144 * 100, 262_144 * 46), grow_from=48_234_496,
                                            finalize_rows=4_641_581),
     {"_sort_raw_desc": 7_306_930_176, "merge_fold_compact": 5_989_652_480, "count_step_two_level": 1_925_286_912,
      "grow2": 3_854_666_752, "finalize2": 2_216_572_416},
     "_sort_raw_desc"),
    ("spill_one_k55", lambda: bg.one_level_peaks(4, 16_666_666, bg.Chunk(90_579 * 100, 90_579 * 46)),
     {"consolidate": 1_276_395_520, "extract_chunk": 884_596_736},
     "consolidate"),
]


@pytest.mark.parametrize("path,peaks,measured,largest", MEASURED, ids=[m[0] for m in MEASURED])
def test_budget_model_covers_the_measured_peaks(path, peaks, measured, largest):
    """The model at the shapes where the steps were measured: at or above
    each measured peak, and within 10% of the step that sets the run's
    peak (the spill decision's margin)."""
    reckoned = peaks()
    for step, m in measured.items():
        assert m <= reckoned[step], (step, reckoned[step], m)
    assert reckoned[largest] <= 1.10 * measured[largest]


@pytest.mark.parametrize("path", ["spill_k55", "k55f_two"])
def test_the_four_lane_reckoning_is_within_3pct_above_the_measured_peak(path):
    """At NL=4 (two raw-sort digits) the run's peak, set by the raw sort,
    is reckoned at or above the card's measurement and at most 3% above it,
    at the 2e9 spill count and at the k55f_two configuration's 8e9 count, given
    the raw rows each consolidation sorts: every chunk's whole rows, its
    padding included."""
    _, peaks, measured, largest = next(m for m in MEASURED if m[0] == path)
    reckoned = peaks()
    assert max(reckoned.values()) == reckoned[largest]
    assert measured[largest] <= reckoned[largest] <= 1.03 * measured[largest]


def test_slot_cap_follows_table_slots():
    """With tableSlots set the table may grow to twice it, as in the JAX
    engine, whatever the byte budget."""
    opts = Options(kmer_length=15, table_slots=400, temp_dir="t")
    chunk = bg.Chunk(4 * 40, 4 * 26)
    cap = bg.max_prefix_slots(opts, 1, 350, chunk)
    assert cap == 450 and bg.max_table_slots(opts, 1, chunk) == 800
    assert bg.next_prefix(cap, 312, 300, 312) == (312, True)
    assert bg.next_prefix(cap, 200, 100, 312) == (412, False)
    assert bg.next_prefix(cap, 200, 100, 200) == (400, False)
    assert bg.next_prefix(cap, 300, 100, 312) == (450, False)
    assert bg.next_capacity(800, 400, 700) == (800, False)
    assert bg.next_capacity(800, 400, 900) == (400, True)
