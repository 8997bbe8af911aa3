"""The port's copies of the JAX package's NumPy-only modules (config,
records, metrics, checkpoint, io.fastq, io.native, io.dump, io.printer,
io.spill) against the originals: the same inputs give the same results,
and the same files, byte for byte."""

import dataclasses
import os

import numpy as np
import pytest

from kmer_counter_tpu import checkpoint as jax_checkpoint
from kmer_counter_tpu import config as jax_config
from kmer_counter_tpu import metrics as jax_metrics
from kmer_counter_tpu import records as jax_records
from kmer_counter_tpu.io import dump as jax_dump
from kmer_counter_tpu.io import fastq as jax_fastq
from kmer_counter_tpu.io import native as jax_native
from kmer_counter_tpu.io import printer as jax_printer
from kmer_counter_tpu.io import spill as jax_spill
from kmer_counter_tpu_torch import checkpoint, config, metrics, records
from kmer_counter_tpu_torch.io import dump, fastq, native, printer, spill

from tests.test_ingest import random_seqs, write_fastq


@pytest.mark.parametrize(
    "argv",
    [
        [],
        ["kmerLength=31", "canonical=true", "gpuMemoryLimit=8000000000", "inputFileLocation=in",
         "outputFile=o.bin", "tableImpl=one"],
        ["kmerLength=101", "meshShape=2x4", "mergeSlack=2.5", "readsPerChunk=1000", "tableSlots=5000",
         "prefetchChunks=3", "ingestThreads=1", "checkpointEvery=2", "checkpointDir=ck", "profile=yes",
         "verbose=2", "tempFileLocation=t", "noOfMergersAtOnce=3", "noOfMergeThreads=5", "bogus=1"],
    ],
)
def test_options_parse_the_same_argv_field_for_field(argv):
    port, jax_opts = config.Options.from_argv(argv), jax_config.Options.from_argv(argv)
    assert dataclasses.asdict(port) == dataclasses.asdict(jax_opts)
    assert port._FLAGS.keys() == jax_opts._FLAGS.keys()
    assert (port.words_per_kmer, port.lanes_per_kmer) == (jax_opts.words_per_kmer, jax_opts.lanes_per_kmer)


def test_options_refuse_the_same_values():
    for kw in ({"kmer_length": 0}, {"kmer_length": 129}, {"memory_limit_bytes": 0}):
        with pytest.raises(ValueError):
            config.Options(**kw)
        with pytest.raises(ValueError):
            jax_config.Options(**kw)


@pytest.mark.parametrize("k", [1, 15, 16, 31, 32, 33, 64, 101, 128])
def test_records_functions_agree(rng, k):
    codes = rng.integers(0, 4, (50, k)).astype(np.uint8)
    words = records.pack_codes(codes, k)
    np.testing.assert_array_equal(words, jax_records.pack_codes(codes, k))
    for fn in ("canonical_words", "revcomp_words", "unpack_words"):
        np.testing.assert_array_equal(getattr(records, fn)(words, k), getattr(jax_records, fn)(words, k))
    lanes = records.words_to_lanes(words)
    np.testing.assert_array_equal(lanes, jax_records.words_to_lanes(words))
    np.testing.assert_array_equal(records.lanes_to_words(lanes), jax_records.lanes_to_words(lanes))
    assert records.active_lanes(k) == jax_records.active_lanes(k)
    assert records.record_size_bytes(k) == jax_records.record_size_bytes(k)
    counts = rng.integers(1, 2**32, 50, dtype=np.uint64).astype(np.uint32)
    assert records.serialize_table(words, counts) == jax_records.serialize_table(words, counts)


def _table(rng, k, n=40):
    words = np.unique(records.pack_codes(rng.integers(0, 4, (n, k)).astype(np.uint8), k), axis=0)
    lanes = records.words_to_lanes(words)[:, : records.active_lanes(k)]
    return np.ascontiguousarray(lanes), rng.integers(1, 2**32, len(words), dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("k", [13, 31, 33, 101])
def test_dump_table_bytes_and_print_records_text(tmp_path, rng, k, capsys):
    lanes, counts = _table(rng, k)
    port, jax_out = tmp_path / "port.bin", tmp_path / "jax.bin"
    dump.dump_table(str(port), lanes, counts)
    jax_dump.dump_table(str(jax_out), lanes, counts)
    assert port.read_bytes() == jax_out.read_bytes() and port.stat().st_size > 0
    for got, want in zip(dump.load_table(str(port), k), jax_dump.load_table(str(jax_out), k)):
        np.testing.assert_array_equal(got, want)
    printer.print_records(str(port), k)
    port_text = capsys.readouterr().out
    jax_printer.print_records(str(jax_out), k)
    assert port_text == capsys.readouterr().out
    assert port_text.count("\n") >= len(counts)


def _chunks(source, reads_per_chunk):
    out = []
    while (chunk := source.read_chunk(reads_per_chunk)) is not None:
        out.append((chunk.reads.tobytes(), chunk.reads.shape, chunk.n_reads, chunk.line_length,
                    os.path.basename(chunk.path)))
    source.close()
    return out


def _fixture(tmp_path, rng):
    d = tmp_path / "in"
    d.mkdir()
    write_fastq(d / "a.fastq", random_seqs(rng, 37, 60))
    write_fastq(d / "b.fq", random_seqs(rng, 5, 33, alphabet="ACGTN"))
    write_fastq(d / "c.fastq", random_seqs(rng, 90, 150))
    return str(d)


@pytest.mark.parametrize("threads", [1, 3])
def test_parallel_ingest_gives_the_same_chunks(tmp_path, rng, threads):
    d = _fixture(tmp_path, rng)
    port = fastq.ParallelIngest(d, threads=threads, segment_bytes=4096)
    jax_src = jax_fastq.ParallelIngest(d, threads=threads, segment_bytes=4096)
    assert port.probe_line_lengths() == jax_src.probe_line_lengths() == [60, 33, 150]
    got, want = _chunks(port, 16), _chunks(jax_src, 16)
    assert got == want and len(got) > 5


@pytest.mark.parametrize("use_native", [False, None])
def test_directory_input_gives_the_same_chunks(tmp_path, rng, use_native):
    d = _fixture(tmp_path, rng)
    got = _chunks(fastq.DirectoryInput(d, use_native=use_native), 16)
    assert got == _chunks(jax_fastq.DirectoryInput(d, use_native=use_native), 16)


def test_native_reader_loads_the_repository_library():
    """The copy's library paths reach the repository's native/ directory,
    as the original's do."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(here, "native", "libkmer_io.so")
    assert os.path.abspath(native._LIB_PATHS[0]) == want


def test_metrics_copy_counts_and_times_the_same():
    port, jax_m = metrics.Metrics(), jax_metrics.Metrics()
    for m in (port, jax_m):
        m.count("chunks", 3)
        with m.timer("consolidate"):
            pass
    snap, jax_snap = port.snapshot(), jax_m.snapshot()
    assert snap["counters"] == jax_snap["counters"] == {"chunks": 3}
    assert snap["timer_calls"] == jax_snap["timer_calls"] == {"consolidate": 1}
    assert snap["timers_s"].keys() == jax_snap["timers_s"].keys()


def _runs(tmp_path, rng, k, n_runs=5):
    """Sorted run files of overlapping random tables (keys shared across
    runs, and counts near 2^32 so that some sums saturate in the merge)."""
    pool_lanes, _ = _table(rng, k, n=60)
    paths = []
    for i in range(n_runs):
        pick = np.sort(rng.choice(len(pool_lanes), 25, replace=False))
        counts = rng.integers(1, 2**32, 25, dtype=np.uint64).astype(np.uint32)
        paths.append(jax_spill.write_run(str(tmp_path / f"run{i}.run"), pool_lanes[pick], counts))
    return paths


@pytest.mark.parametrize("k", [15, 33, 101])
def test_write_run_bytes(tmp_path, rng, k):
    lanes, counts = _table(rng, k)
    counts[::5] = 0  # empty slots are not written
    port = spill.write_run(str(tmp_path / "p" / "a.run"), lanes, counts)
    jax_path = jax_spill.write_run(str(tmp_path / "j" / "a.run"), lanes, counts)
    assert open(port, "rb").read() == open(jax_path, "rb").read()


@pytest.mark.parametrize("use_native", [False, None])
@pytest.mark.parametrize("k", [15, 33])
def test_merge_runs_output(tmp_path, rng, k, use_native):
    """The heap merge (use_native=False) and the dispatch (the native merge
    when the library is built) write the same bytes as the original's."""
    paths = _runs(tmp_path, rng, k)
    n = spill.merge_runs(paths, str(tmp_path / "port.bin"), k, use_native=use_native)
    want = jax_spill.merge_runs(paths, str(tmp_path / "jax.bin"), k, use_native=use_native)
    assert n == want > 25
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes()
    _, counts = dump.load_table(str(tmp_path / "port.bin"), k)
    assert (counts == 0xFFFFFFFF).any()  # saturated sums


def test_native_merge_runs_output(tmp_path, rng):
    if not jax_native.available():
        pytest.skip("native/libkmer_io.so is not built")
    k = 31
    paths = _runs(tmp_path, rng, k)
    n = native.native_merge_runs(paths, str(tmp_path / "port.bin"), k)
    assert n == jax_native.native_merge_runs(paths, str(tmp_path / "jax.bin"), k)
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes()


def test_merge_scheduler_finish_output(tmp_path, rng):
    k = 21
    outs = []
    for name, module in (("port", spill), ("jax", jax_spill)):
        (tmp_path / name).mkdir()
        sched = module.MergeScheduler(str(tmp_path / name / "tmp"), k, fan_in=2, threads=2, seq_start=7)
        for path in _runs(tmp_path / name, np.random.default_rng(5), k, n_runs=7):
            sched.add_run(path)
        assert sched.snapshot_runs()
        n = sched.finish(str(tmp_path / name / "out.bin"))
        outs.append((n, (tmp_path / name / "out.bin").read_bytes()))
        assert not list((tmp_path / name / "tmp").glob("*.run"))
    assert outs[0] == outs[1] and outs[0][0] > 25


@pytest.mark.parametrize("spilled", [False, True])
def test_checkpoint_files_byte_identical(tmp_path, rng, spilled):
    k = 31
    lanes, counts = _table(rng, k)
    abi = records.pad_lanes_to_abi(lanes, k)
    run = spill.write_run(str(tmp_path / "spill_000001.run"), lanes, counts) if spilled else None
    opts = config.Options(kmer_length=k, canonical=True, input_dir=str(tmp_path / "in"))
    for name, module in (("port", checkpoint), ("jax", jax_checkpoint)):
        module.save(str(tmp_path / name), opts, abi, counts, 1234, files={"a.fastq": 1000, "b.fastq": 234},
                    allt=7, spill_runs=[run] if run else None)
    for f in (checkpoint.MANIFEST, checkpoint.TABLE):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()
    assert checkpoint.config_fingerprint(opts) == jax_checkpoint.config_fingerprint(opts)
    got = checkpoint.load(str(tmp_path / "jax"), opts)
    want = jax_checkpoint.load(str(tmp_path / "port"), opts)
    for a, b in zip(got, want):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b
    assert (got.reads_absorbed, got.allt, bool(got.spill_runs)) == (1234, 7, spilled)
