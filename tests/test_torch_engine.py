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
