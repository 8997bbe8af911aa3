"""The port's ParallelIngest cuts files into byte-range units, a thread
each, and parses each unit whole ahead of the consumer: the chunk stream
stays DirectoryInput's (and the JAX package's ParallelIngest's), the plan
follows the file sizes, the parsed rows held stay within the stated bound,
and the counters add up."""

import functools
import os
import re
import time

import numpy as np
import pytest

from kmer_counter_tpu.io import fastq as jax_fastq
from kmer_counter_tpu_torch import engine
from kmer_counter_tpu_torch.io import fastq
from kmer_counter_tpu_torch.io import native

from tests.test_ingest import random_seqs, write_fastq
from tests.test_torch_engine import run_both

THREADS = [1, 2, 3, 4, 8]
# Small enough that the fixtures' larger files are cut into many units.
SPLIT, UNIT = 8192, 16384
MIB = 1 << 20


def _records(seqs, quals, crlf=False):
    nl = "\r\n" if crlf else "\n"
    return "".join(f"@read{i} x{nl}{s}{nl}+{nl}{q}{nl}" for i, (s, q) in enumerate(zip(seqs, quals)))


def _awkward_reads(rng, n, L):
    """Reads of L bases, some short, some all 'N', whose quality lines start
    with '@' or '+' (a header or a separator to a careless resync)."""
    seqs = random_seqs(rng, n, L, alphabet="ACGTN")
    for i in range(5, n, 7):  # the first read sets the file's line length
        seqs[i] = seqs[i][: int(rng.integers(0, L))]
    for i in range(3, n, 11):
        seqs[i] = "N" * L
    quals = [rng.choice(["@", "+", "I"]) + "I" * (len(s) - 1) if s else "" for s in seqs]
    return seqs, quals


def _fixture(tmp_path, rng):
    """Files below and above the split size, CRLF lines, an empty file, a
    malformed and a truncated file (each fewer reads than a block)."""
    d = tmp_path / "in"
    d.mkdir()
    write_fastq(d / "a_small.fastq", random_seqs(rng, 30, 60))
    (d / "b_big.fastq").write_text(_records(*_awkward_reads(rng, 400, 100)))
    (d / "c_crlf.fastq").write_bytes(_records(*_awkward_reads(rng, 200, 80), crlf=True).encode())
    (d / "d_empty.fastq").write_text("")
    bad = _records(*_awkward_reads(rng, 8, 50)).split("\n")
    del bad[10]  # the separator of record 2
    (d / "e_bad.fastq").write_text("\n".join(bad))
    trunc = _records(*_awkward_reads(rng, 9, 50)).split("\n")
    (d / "f_trunc.fastq").write_text("\n".join(trunc[:-4]))  # ends after a sequence line
    write_fastq(d / "g_big.fq", random_seqs(rng, 300, 120))
    assert os.path.getsize(d / "b_big.fastq") > 4 * UNIT and os.path.getsize(d / "a_small.fastq") < SPLIT
    return str(d)


def _events(src, reads_per_chunk, capsys):
    """The stream as events: each chunk, and each skip warning (named by its
    file) placed after the rows of its file and before the next file's."""
    capsys.readouterr()
    out = []
    while True:
        chunk = src.read_chunk(reads_per_chunk)
        warned = re.findall(r"\[ingest\] skipping (?:rest of )?(\S+?):", capsys.readouterr().err)
        warns = [("warn", os.path.basename(p)) for p in warned]
        if chunk is None:
            out += warns
            break
        name = os.path.basename(chunk.path)
        item = ("rows", name, chunk.reads.tobytes(), chunk.reads.shape, chunk.n_reads, chunk.line_length)
        before = [w for w in warns if w[1] < name]
        out += before + [item] + [w for w in warns if w not in before]
    src.close()
    return out


def _port(d, threads, **kw):
    kw = {"segment_bytes": SPLIT, "unit_bytes": UNIT, "unit_chunk_reads": 16, **kw}
    return fastq.ParallelIngest(d, threads=threads, **kw)


@pytest.mark.parametrize("use_native", [None, False], ids=["native", "python"])
@pytest.mark.parametrize("threads", THREADS)
def test_the_chunk_stream_is_directory_inputs_and_the_jax_packages(tmp_path, rng, capsys, threads, use_native):
    d = _fixture(tmp_path, rng)
    port = _port(d, threads, use_native=use_native)
    assert len(port._units) > len(port.paths) + 2 * threads  # the larger files are cut
    got = _events(port, 37, capsys)
    want = _events(fastq.DirectoryInput(d, use_native=use_native), 37, capsys)
    jax_got = _events(jax_fastq.ParallelIngest(d, threads=threads, use_native=use_native), 37, capsys)
    assert got == want == jax_got
    assert [e[1] for e in got if e[0] == "warn"] == ["d_empty.fastq", "e_bad.fastq", "f_trunc.fastq"]
    assert len(got) > 20


def _quality_starts(data: bytes):
    """Byte offsets of the quality lines' starts."""
    starts = [0] + [i + 1 for i, b in enumerate(data) if b == ord("\n")][:-1]
    return {s for j, s in enumerate(starts) if j % 4 == 3}


@pytest.mark.parametrize("threads", THREADS)
def test_a_unit_boundary_on_any_line_keeps_the_stream(tmp_path, rng, threads):
    """Boundaries of many plans fall on every kind of line, among them a
    quality line that starts with '@'; each plan gives the sequential rows."""
    d = tmp_path / "in"
    d.mkdir()
    seqs, quals = _awkward_reads(rng, 120, 40)
    quals = ["@" + q[1:] if q else q for q in quals]
    data = _records(seqs, quals).encode()
    (d / "a.fastq").write_bytes(data)
    want = _rows(fastq.DirectoryInput(str(d)), 50)
    at_quality = set()
    for unit in range(200, 1400, 37):
        port = _port(str(d), threads, segment_bytes=1, unit_bytes=unit, unit_chunk_reads=7)
        at_quality |= {u.byte_range[0] for u in port._units} & _quality_starts(data)
        assert _rows(port, 50) == want, unit
    assert any(data[s] == ord("@") for s in at_quality)


def _rows(src, reads_per_chunk):
    out = []
    while (chunk := src.read_chunk(reads_per_chunk)) is not None:
        out += [bytes(r).rstrip(b"\x00") for r in chunk.reads[: chunk.n_reads]]
    src.close()
    return out


def _split_fault(tmp_path, rng, fault, threads):
    """Three large files, the middle one faulty; returns (directory, the
    middle file's reads before its fault)."""
    d = tmp_path / "in"
    d.mkdir()
    write_fastq(d / "a.fastq", random_seqs(rng, 200, 100))
    seqs = random_seqs(rng, 600, 100)
    text = _records(seqs, ["I" * 100] * 600)
    lines = text.split("\n")
    bad = 350  # a record in a middle unit
    if fault == "corrupt_at_cut":
        # the first record whose header lies at or past a cut of the
        # corrupted file (two bytes shorter): a parse from the cut
        # resynchronizes past it, so only the join check sees the fault
        cut = fastq.plan_units(0, len(text) - 2, threads, SPLIT, UNIT)[3][0]
        headers = np.cumsum([0] + [len(line) + 1 for line in lines[:-1]])[::4]
        bad = int(np.argmax(headers >= cut))
    if fault == "truncated":
        lines, good = lines[:-3], seqs[:-1]  # ends after the last sequence line
    else:
        del lines[4 * bad + 2]  # the record's separator
        good = seqs[:bad]
    (d / "b.fastq").write_text("\n".join(lines))
    write_fastq(d / "c.fastq", random_seqs(rng, 200, 100))
    return str(d), [s.encode() for s in good]


@pytest.mark.parametrize("use_native", [None, False], ids=["native", "python"])
@pytest.mark.parametrize("fault", ["truncated", "corrupt_middle", "corrupt_at_cut"])
@pytest.mark.parametrize("threads", [2, 4])
def test_a_fault_in_a_cut_file_skips_its_rest_with_one_warning(tmp_path, rng, capsys, threads, fault, use_native):
    d, good = _split_fault(tmp_path, rng, fault, threads)
    port = _port(d, threads, use_native=use_native)
    assert sum(u.path.endswith("b.fastq") for u in port._units) >= 4
    got = _events(port, 64, capsys)
    want = _events(fastq.DirectoryInput(d, use_native=use_native), 64, capsys)

    def per_file(events):
        rows = {}
        for e in events:
            if e[0] == "rows":
                arr = np.frombuffer(e[2], np.uint8).reshape(e[3])
                rows.setdefault(e[1], []).extend(bytes(r).rstrip(b"\x00") for r in arr)
        return rows

    got_rows, want_rows = per_file(got), per_file(want)
    assert got_rows["a.fastq"] == want_rows["a.fastq"] and got_rows["c.fastq"] == want_rows["c.fastq"]
    served = got_rows.get("b.fastq", [])
    assert served == good[: len(served)]  # reads of the file before its fault, none after
    assert [e for e in got if e[0] == "warn"] == [e for e in want if e[0] == "warn"] == [("warn", "b.fastq")]
    # the warning lies between the faulty file's rows and the next file's
    names = [e[1] for e in got]
    assert names.index("b.fastq") == max(i for i, e in enumerate(got) if e[0] == "warn") or \
        names.index("c.fastq") > names.index("b.fastq")
    assert got.index(("warn", "b.fastq")) < names.index("c.fastq")
    assert all(i < got.index(("warn", "b.fastq")) for i, n in enumerate(names) if n == "a.fastq")


def test_tail_phase_and_joins_at_read_the_record_boundaries(tmp_path, rng):
    seqs = random_seqs(rng, 50, 30)
    text = _records(seqs, ["@" + "I" * 29] * 50)
    lines = text.split("\n")
    for keep, phase in ((len(lines), 0), (len(lines) - 1, 0), (len(lines) - 2, 3), (len(lines) - 3, 2),
                        (len(lines) - 4, 1), (len(lines) - 5, 0), (1, 1), (2, 2), (3, 3)):
        p = tmp_path / f"t{keep}.fastq"
        p.write_text("\n".join(lines[:keep]))
        assert fastq.tail_phase(str(p)) == phase, keep
    whole = tmp_path / f"t{len(lines)}.fastq"
    assert all(fastq.joins_at(str(whole), b) for b in range(1, len(text) + 1))
    long = tmp_path / "long.fastq"  # a tail longer than the first window
    long.write_text(_records(["A" * 40000] * 3, ["I" * 40000] * 3) + "@r\nACGT\n")
    assert fastq.tail_phase(str(long)) == 2


@pytest.mark.parametrize("threads", THREADS)
def test_the_plan_cuts_a_file_into_a_unit_a_thread_within_the_cap(threads):
    cap = 32 * MIB
    units = fastq.plan_units(0, 103_500_000, threads)  # a benchmark file
    assert len(units) == max(threads, 4) and all(b - a <= cap for a, b in units)
    if threads == 4:
        assert [b - a for a, b in units] == [25_875_000] * 4
    huge = fastq.plan_units(0, 10**12, threads)
    assert len(huge) == -(-10**12 // cap) and all(b - a <= cap for a, b in huge)
    assert fastq.plan_units(0, 4 * MIB - 1, threads) == [(0, 4 * MIB - 1)]  # small files stay whole
    shard = fastq.plan_units(10**9, 2 * 10**9, threads)  # a byte shard's range
    for units in (fastq.plan_units(0, 103_500_000, threads), huge, shard):
        assert all(b1 == a2 for (_, b1), (a2, _) in zip(units, units[1:]))
    assert shard[0][0] == 10**9 and shard[-1][1] == 2 * 10**9


@pytest.mark.parametrize("threads", THREADS)
def test_units_partition_the_file_and_a_shards_range(tmp_path, rng, threads):
    d = tmp_path / "in"
    d.mkdir()
    seqs, quals = _awkward_reads(rng, 500, 90)
    (d / "a.fastq").write_text(_records(seqs, quals))
    want = _rows(fastq.DirectoryInput(str(d)), 64)
    port = _port(str(d), threads)
    readers = [fastq.FASTQReader] + ([native.NativeFASTQReader] if native.available() else [])
    for reader in readers:
        per_unit = [_rows(reader(u.path, byte_range=u.byte_range), 64) for u in port._units]
        assert sum(map(len, per_unit)) == len(want) and sum(per_unit, []) == want
    port.close()
    size = os.path.getsize(d / "a.fastq")
    shard_rows = []
    for idx in range(3):
        src = _port(str(d), threads, shard=(idx, 3), shard_mode="bytes")
        lo, hi = size * idx // 3, size * (idx + 1) // 3
        ranges = [u.byte_range for u in src._units]
        assert ranges[0][0] == lo and ranges[-1][1] == hi and len(ranges) >= threads
        assert all(b1 == a2 for (_, b1), (a2, _) in zip(ranges, ranges[1:]))
        rows = _rows(src, 64)
        assert rows == _rows(fastq.DirectoryInput(str(d), shard=(idx, 3), shard_mode="bytes"), 64)
        shard_rows += rows
    assert shard_rows == want


def _wait_for(cond, seconds=20.0):
    end = time.monotonic() + seconds
    while not cond():
        assert time.monotonic() < end, "timed out"
        time.sleep(0.005)


def _one_big_file(tmp_path, rng, n=2000, L=100):
    d = tmp_path / "in"
    d.mkdir()
    write_fastq(d / "a.fastq", random_seqs(rng, n, L))
    return str(d)


@pytest.mark.parametrize("threads", THREADS)
def test_an_idle_consumer_gets_the_window_parsed_whole_within_the_bound(tmp_path, rng, threads):
    L = 100
    d = _one_big_file(tmp_path, rng, L=L)
    port = _port(d, threads)
    window = threads + 2
    assert len(port._units) > window
    # every unit in the window parsed to its end, none past it started
    _wait_for(lambda: all(buf and buf[-1] is None for buf in port._buffers[:window]))
    time.sleep(0.05)
    assert port._next_unit == window and not any(port._buffers[window:])
    record = len("@read0000 \n") + 2 * (L + 1) + 2  # write_fastq's longest record
    bound = window * (UNIT + record) * L // (2 * L + 6)
    held = port.buffered_bytes
    assert held == port.buffered_peak > 0
    assert held == sum(c.reads.nbytes for buf in port._buffers for c in buf if c is not None)
    assert held <= bound
    # reading it all keeps the bound, and leaves nothing held
    n = len(_rows(port, 300))
    assert n == 2000 and port.buffered_peak <= bound and port.buffered_bytes == 0


@pytest.mark.parametrize("threads", [1, 4, 8])
def test_close_joins_every_worker_while_units_are_full(tmp_path, rng, threads):
    port = _port(_one_big_file(tmp_path, rng), threads)
    window = threads + 2
    _wait_for(lambda: all(buf and buf[-1] is None for buf in port._buffers[:window]))
    port.read_chunk(100)
    t0 = time.monotonic()
    port.close()
    assert time.monotonic() - t0 < 2.0
    assert not any(t.is_alive() for t in port._threads)
    assert port.buffered_bytes == 0


@pytest.mark.parametrize("threads", THREADS)
def test_ready_and_waited_blocks_add_up_to_the_blocks_served(tmp_path, rng, threads):
    d = _fixture(tmp_path, rng)
    port = _port(d, threads)
    blocks = 0
    for u in port._units:
        try:
            n = len(_rows(port._open_unit(u), 1 << 20))
        except (OSError, ValueError):
            continue  # a bad file: its blocks up to the fault, none here
        blocks += -(-n // 16)
    _rows(port, 37)
    c = port.counters
    assert set(c) == {"ingest_blocks_ready", "ingest_blocks_waited", "ingest_units"}
    assert c["ingest_units"] == len(port._units) and c["ingest_blocks_waited"] >= 0
    assert c["ingest_blocks_ready"] + c["ingest_blocks_waited"] == blocks


@pytest.mark.parametrize("threads", [1, 4])
def test_an_engine_count_records_the_counters_and_its_dump_is_the_jax_packages(tmp_path, rng, monkeypatch, threads):
    (tmp_path / "in").mkdir()
    for name, n in (("a.fastq", 300), ("b.fastq", 40), ("c.fastq", 250)):
        seqs, _ = _awkward_reads(rng, n, 80)
        write_fastq(tmp_path / "in" / name, seqs)
    monkeypatch.setattr(engine, "ParallelIngest",
                        functools.partial(fastq.ParallelIngest, segment_bytes=SPLIT, unit_bytes=UNIT))
    (port, jax_out), (stats, _) = run_both(tmp_path, 31, True, ingest_threads=threads, reads_per_chunk=64)
    assert port == jax_out and len(port) > 0
    counters = stats.metrics["counters"]
    if threads == 1:
        assert not {"ingest_blocks_ready", "ingest_blocks_waited", "ingest_units"} & set(counters)
    else:
        assert counters["ingest_units"] > 3
        assert counters["ingest_blocks_ready"] + counters["ingest_blocks_waited"] >= counters["ingest_units"] - 1


def test_many_threads_on_tiny_units_under_fast_switching(tmp_path, rng):
    """More workers than cores and a short switch interval: the stream is
    still the sequential one, and the bytes held come back to 0 (a lost
    update of the shared count would leave a remainder)."""
    import sys

    d = _fixture(tmp_path, rng)
    for name in ("e_bad.fastq", "f_trunc.fastq"):  # cut, they serve reads up to their fault
        os.remove(os.path.join(d, name))
    want = _rows(fastq.DirectoryInput(d), 29)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(3):
            port = _port(d, 2 * os.cpu_count() + 3, segment_bytes=1, unit_bytes=2048, unit_chunk_reads=5)
            assert _rows(port, 29) == want
            assert port.buffered_bytes == 0 and not any(t.is_alive() for t in port._threads)
    finally:
        sys.setswitchinterval(interval)
