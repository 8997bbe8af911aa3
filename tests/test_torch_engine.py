"""The whole slice on CPU: the port's CountEngine and CLI against the JAX
CountEngine (tableImpl=two) and CLI, and against golden.

Output files must be byte-identical; print mode must render the same text.
"""

import functools

import pytest
import torch

from kmer_counter_tpu import golden
from kmer_counter_tpu.__main__ import main as jax_main
from kmer_counter_tpu.config import Options
from kmer_counter_tpu.engine import CountEngine as JaxCountEngine
from kmer_counter_tpu_torch.__main__ import main
from kmer_counter_tpu_torch.engine import CountEngine, plan_chunks

from tests.test_ingest import random_seqs, write_fastq
from tests.test_torch_cuda import CONSOLIDATE_VARIANTS, SPLIT_VARIANTS, VARIANT_MERGE

CPU = torch.device("cpu")


def golden_bytes(tmp_path, k, canonical):
    seqs = []
    for f in sorted((tmp_path / "in").iterdir()):
        lines = f.read_text().splitlines()
        seqs += [lines[i] for i in range(1, len(lines), 4)]
    return golden.serialize_counter(golden.count_reads(seqs, k, canonical))


def run_both(tmp_path, k, canonical, **kw):
    outs, stats = [], []
    for name, engine in (("port", lambda o: CountEngine(o, device=CPU)),
                         ("jax", lambda o: JaxCountEngine(o))):
        out = tmp_path / f"{name}.bin"
        opts = Options(kmer_length=k, canonical=canonical, input_dir=str(tmp_path / "in"),
                       output_file=str(out), verbose=0, table_impl="two", **kw)
        stats.append(engine(opts).run())
        outs.append(out.read_bytes())
    return outs, stats


@pytest.mark.parametrize(
    "k,canonical,all_t",
    [(15, False, False), (16, False, True), (31, True, False), (55, False, False)],
)
def test_engine_matches_jax_and_golden(tmp_path, rng, k, canonical, all_t):
    (tmp_path / "in").mkdir()
    seqs = random_seqs(rng, 30, 80)
    for i in range(0, 30, 3):  # N bases in every third read
        p = int(rng.integers(0, 80))
        seqs[i] = seqs[i][:p] + "N" + seqs[i][p + 1 :]
    if all_t:
        seqs[3] = "T" * 80
        seqs[4] = "T" * 40 + "N" + "T" * 39
    write_fastq(tmp_path / "in" / "a.fastq", seqs[:20])
    write_fastq(tmp_path / "in" / "b.fastq", seqs[20:])
    # a tiny table: several consolidations and at least one prefix grow
    (port, jax_out), (ps, js) = run_both(tmp_path, k, canonical, reads_per_chunk=4, table_slots=64)
    assert port == jax_out == golden_bytes(tmp_path, k, canonical)
    assert len(port) > 0
    assert ps.consolidations > 2
    for field in ("reads", "bases", "chunks", "distinct_kmers", "total_kmers"):
        assert getattr(ps, field) == getattr(js, field), field


def test_engine_grows_the_prefix(tmp_path, rng, capsys):
    (tmp_path / "in").mkdir()
    write_fastq(tmp_path / "in" / "a.fastq", random_seqs(rng, 40, 60))
    out = tmp_path / "o.bin"
    opts = Options(kmer_length=21, input_dir=str(tmp_path / "in"), output_file=str(out),
                   verbose=1, reads_per_chunk=4, table_slots=64)
    stats = CountEngine(opts, device=CPU).run()
    assert "growing prefix" in capsys.readouterr().out
    assert out.read_bytes() == golden_bytes(tmp_path, 21, False)
    assert stats.reads == 40 and stats.metrics["counters"]["chunks"] == stats.chunks


def test_engine_mixed_line_lengths_and_short_reads(tmp_path, rng):
    (tmp_path / "in").mkdir()
    write_fastq(tmp_path / "in" / "a.fastq", random_seqs(rng, 9, 50))
    write_fastq(tmp_path / "in" / "b.fastq", random_seqs(rng, 7, 12))  # shorter than k
    write_fastq(tmp_path / "in" / "c.fastq", random_seqs(rng, 11, 33))
    (port, jax_out), (ps, js) = run_both(tmp_path, 15, False, reads_per_chunk=4)
    assert port == jax_out == golden_bytes(tmp_path, 15, False)
    assert ps.reads == js.reads == 27


def test_engine_no_usable_reads_writes_empty_dump(tmp_path, rng):
    (tmp_path / "in").mkdir()
    write_fastq(tmp_path / "in" / "a.fastq", random_seqs(rng, 5, 10))
    (port, jax_out), _ = run_both(tmp_path, 31, True)
    assert port == jax_out == b""


def test_plan_chunks_matches_jax_cpu_plan():
    from kmer_counter_tpu.engine import plan_chunks as jax_plan

    for k, L, kw in ((31, 100, {}), (15, 150, {"memory_limit_bytes": 8_000_000_000}),
                     (101, 150, {"reads_per_chunk": 1000}), (55, 80, {"table_slots": 5000})):
        opts = Options(kmer_length=k, **kw)
        assert plan_chunks(opts, L) == jax_plan(opts, L)


def test_cli_and_print_mode_match_jax_cli(tmp_path, rng, capsys):
    (tmp_path / "in").mkdir()
    write_fastq(tmp_path / "in" / "a.fastq", random_seqs(rng, 15, 45, alphabet="ACGTN"))
    argv = ["kmerLength=13", "canonical=true", f"inputFileLocation={tmp_path / 'in'}",
            "readsPerChunk=4", "tableImpl=two", "verbose=0"]
    assert main(argv + [f"outputFile={tmp_path / 'port.bin'}"], device=CPU) == 0
    port_log = capsys.readouterr().out
    assert jax_main(argv + [f"outputFile={tmp_path / 'jax.bin'}"]) == 0
    jax_log = capsys.readouterr().out
    assert port_log.replace("port.bin", "X") == jax_log.replace("jax.bin", "X")
    port = (tmp_path / "port.bin").read_bytes()
    assert port == (tmp_path / "jax.bin").read_bytes() == golden_bytes(tmp_path, 13, True)

    assert main(["print", str(tmp_path / "port.bin"), "-", "13"]) == 0
    port_text = capsys.readouterr().out
    assert jax_main(["print", str(tmp_path / "jax.bin"), "-", "13"]) == 0
    assert port_text == capsys.readouterr().out
    assert port_text.count("\n") == len(port) // 12 + 1  # banner + one line per record


def test_cli_missing_flags(capsys):
    assert main(["kmerLength=13"], device=CPU) == 2
    assert "required flag" in capsys.readouterr().err


@pytest.mark.parametrize("k,canonical,all_t", [(16, False, True), (31, True, False)])
@pytest.mark.parametrize("variant", SPLIT_VARIANTS)
def test_cli_with_each_split_consolidation_matches_golden(tmp_path, rng, monkeypatch, variant, k,
                                                          canonical, all_t):
    """The CLI with table2.consolidate3 bound to a split variant, as
    chip_smoke.py binds it: the variant's merge and K2 run at every
    consolidation, K1 never, and the dump equals golden."""
    from kmer_counter_tpu_torch.ops import table2 as t2

    calls = {"merge": 0, "compact_live": 0, "merge_fold_compact": 0}

    def counting(key, fn):
        def call(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)

        return call

    merge = VARIANT_MERGE[variant]
    monkeypatch.setattr(t2, merge, counting("merge", getattr(t2, merge)))
    for name in ("compact_live", "merge_fold_compact"):
        monkeypatch.setattr(t2, name, counting(name, getattr(t2, name)))
    monkeypatch.setattr(t2, "consolidate3",
                        functools.partial(t2.consolidate3, **CONSOLIDATE_VARIANTS[variant]))
    (tmp_path / "in").mkdir()
    seqs = random_seqs(rng, 30, 70, alphabet="ACGTN")
    if all_t:
        seqs[5] = "T" * 70
    write_fastq(tmp_path / "in" / "a.fastq", seqs)
    out = tmp_path / "o.bin"
    argv = [f"kmerLength={k}", f"canonical={str(canonical).lower()}", f"inputFileLocation={tmp_path / 'in'}",
            f"outputFile={out}", "readsPerChunk=4", "tableSlots=64", "tableImpl=two", "verbose=0"]
    assert main(argv, device=CPU) == 0
    assert out.read_bytes() == golden_bytes(tmp_path, k, canonical)
    assert calls["merge"] >= 2 and calls["compact_live"] == calls["merge"]
    assert calls["merge_fold_compact"] == 0


def _genome_reads(rng, genome_length, n, L):
    """``n`` reads of ``L`` bases sampled from a random genome, so that
    their windows repeat."""
    genome = "".join(rng.choice(list("ACGT"), size=genome_length))
    return [genome[s : s + L] for s in rng.integers(0, genome_length - L + 1, size=n)]


def _reckoned_tables(monkeypatch, opts, line_length):
    """Spies on the two-level table's allocation, growth, consolidation and
    finalize: each call's tables as (step, prefix slots, raw slots), and
    the largest peak the budget model reckons for the steps at those
    sizes."""
    from kmer_counter_tpu_torch import budget as bg
    from kmer_counter_tpu_torch import records
    from kmer_counter_tpu_torch.ops import table2 as t2
    from kmer_counter_tpu_torch.ops.pipeline import chunk_slots

    NL, limit = records.active_lanes(opts.kmer_length), opts.memory_limit_bytes
    reads_per_chunk, _ = plan_chunks(opts, line_length)
    chunk = bg.Chunk(reads_per_chunk * line_length, chunk_slots(reads_per_chunk, line_length, opts.kmer_length))
    seen = {"tables": [], "reckoned": 0}

    def spy(name, real, sizes, peaks):
        def call(*args, **kw):
            seen["tables"].append((name, *sizes(*args)))
            if peaks is not None:
                seen["reckoned"] = max(seen["reckoned"], *peaks(*args).values())
            return real(*args, **kw)

        return call

    def shape(t, *_):
        return t.prefix_lanes.shape[1], t.raw_lanes.shape[1]

    monkeypatch.setattr(t2, "make_table2", spy("make", t2.make_table2, lambda cp, cr, *a: (cp, cr), None))
    monkeypatch.setattr(t2, "grow2", spy("grow2", t2.grow2, lambda t, cp, cr: (cp, cr), lambda t, cp, cr: (
        bg.two_level_peaks(NL, cp, cr, 0, chunk, grow_from=t.prefix_lanes.shape[1], limit=limit))))
    monkeypatch.setattr(t2, "consolidate3", spy("consolidate3", t2.consolidate3, shape, lambda t, **kw: (
        bg.two_level_peaks(NL, *shape(t), t.raw_off, chunk, limit=limit))))
    monkeypatch.setattr(t2, "finalize2", spy("finalize2", t2.finalize2, shape, lambda t, live=None: (
        bg.two_level_peaks(NL, t.prefix_lanes.shape[1], 0, 0, chunk, finalize_rows=live, limit=limit))))
    return seen


def test_a_prefix_past_the_limit_takes_raw_slots_and_counts_exactly(tmp_path, rng, monkeypatch):
    """Without a tempFileLocation the plan alone keeps gpuMemoryLimit: k=55
    forward (four key lanes) on reads whose distinct windows outgrow what
    a geometric prefix may take beside the planned raw region.  The prefix
    grows only as far as the model allows, the raw region gives up slots
    (at the start and between consolidations), every step the model
    reckons at the sizes the engine chose stays within the limit, and the
    dump is the reference's."""
    (tmp_path / "in").mkdir()
    write_fastq(tmp_path / "in" / "a.fastq", _genome_reads(rng, 12_000, 600, 100))
    limit = 1_200_000
    opts = Options(kmer_length=55, canonical=False, input_dir=str(tmp_path / "in"),
                   output_file=str(tmp_path / "o.bin"), memory_limit_bytes=limit, reads_per_chunk=20,
                   table_impl="two", verbose=0)
    seen = _reckoned_tables(monkeypatch, opts, 100)
    stats = CountEngine(opts, device=CPU).run()
    assert (tmp_path / "o.bin").read_bytes() == golden_bytes(tmp_path, 55, False)
    assert 0 < seen["reckoned"] <= limit
    (_, cp0, cr0), *rest = seen["tables"]
    _, planned = plan_chunks(opts, 100)
    assert seen["tables"][0][0] == "make" and cp0 + cr0 < planned  # the raw region shrank before the start
    raw_sizes = [cr for step, _, cr in rest]
    assert any(b < a for a, b in zip([cr0, *raw_sizes], raw_sizes))  # and again between consolidations
    assert stats.consolidations > 600 * 46 // cr0


@pytest.mark.parametrize("limit,genome", [(100_000, 12_000), (600_000, 12_000)], ids=["at_the_start", "mid_run"])
def test_a_limit_no_plan_keeps_stops_before_it_allocates(tmp_path, rng, monkeypatch, limit, genome):
    """Where the live rows (none, at the start) leave no room for a raw
    region of one chunk, the count stops with an error that names both
    ways out, before it allocates the table (at the start) or its next raw
    region (mid-run)."""
    (tmp_path / "in").mkdir()
    write_fastq(tmp_path / "in" / "a.fastq", _genome_reads(rng, genome, 600, 100))
    opts = Options(kmer_length=55, canonical=False, input_dir=str(tmp_path / "in"),
                   output_file=str(tmp_path / "o.bin"), memory_limit_bytes=limit, reads_per_chunk=20,
                   table_impl="two", verbose=0)
    seen = _reckoned_tables(monkeypatch, opts, 100)
    with pytest.raises(RuntimeError, match=r"gpuMemoryLimit=\d+ .* tempFileLocation"):
        CountEngine(opts, device=CPU).run()
    steps = [step for step, *_ in seen["tables"]]
    if limit == 100_000:
        assert steps == []
    else:  # the last step before the error is a consolidation, not a new raw region
        assert steps[-1] == "consolidate3" and "finalize2" not in steps
    assert seen["reckoned"] <= limit
    assert not (tmp_path / "o.bin").exists()
