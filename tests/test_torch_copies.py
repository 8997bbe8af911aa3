"""The port's copies of the JAX package's NumPy-only modules (config,
records, metrics, io.fastq, io.native, io.dump, io.printer) against the
originals: the same inputs give the same results."""

import dataclasses
import os

import numpy as np
import pytest

from kmer_counter_tpu import config as jax_config
from kmer_counter_tpu import metrics as jax_metrics
from kmer_counter_tpu import records as jax_records
from kmer_counter_tpu.io import dump as jax_dump
from kmer_counter_tpu.io import fastq as jax_fastq
from kmer_counter_tpu.io import printer as jax_printer
from kmer_counter_tpu_torch import config, metrics, records
from kmer_counter_tpu_torch.io import dump, fastq, native, printer

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
