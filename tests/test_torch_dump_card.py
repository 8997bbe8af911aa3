"""The dump's tensor route on the CPU: ``ops.record_pack``'s plain version
against ``records.serialize_table(records.lanes_to_words(...))`` and the
JAX package's dump file; ``dump_table`` given lane-major tensor lanes
against the host route, with ``append`` and with counts altered after a
copy; and whole counts on both tables, the all-T record included, whose
dumps equal the host route's bytes."""

import numpy as np
import pytest
import torch

from kmer_counter_tpu import golden
from kmer_counter_tpu.io import dump as jax_dump
from kmer_counter_tpu_torch import engine, metrics, records
from kmer_counter_tpu_torch.config import Options
from kmer_counter_tpu_torch.io.dump import dump_table
from kmer_counter_tpu_torch.ops.record_pack import pack_records, pack_records_reference, record_words
from kmer_counter_tpu_torch.ops.u32 import from_numpy

from tests.test_ingest import random_seqs, write_fastq

CPU = torch.device("cpu")
M = 0xFFFFFFFF


def _host_bytes(lanes_rows: np.ndarray, counts: np.ndarray) -> bytes:
    """The host formatter's bytes: row-major lanes, rows with count 0 out."""
    keep = counts > 0
    return records.serialize_table(records.lanes_to_words(lanes_rows[keep]), counts[keep])


def _table(rng, NL, n, zeros=True, all_t=False):
    """Row-major uint32 lanes [n, NL] and counts [n]: random keys, a few
    zero counts among them, and the all-ones (all-T) key as the last row."""
    lanes = rng.integers(0, 2**32, (n, NL), dtype=np.uint64).astype(np.uint32)
    counts = rng.integers(1, 2**32, n, dtype=np.uint64).astype(np.uint32)
    if zeros and n:
        counts[rng.random(n) < 0.2] = 0
    if all_t and n:
        lanes[-1] = M
        counts[-1] = 7
    return lanes, counts


def _lane_major(lanes_rows: np.ndarray, pad: int = 0, offset: int = 0) -> torch.Tensor:
    """The lanes as an int32 ``[NL, n]`` tensor, a column slice of a wider
    buffer when ``pad`` or ``offset`` (lanes ``n + pad + offset`` apart)."""
    n, NL = lanes_rows.shape
    buf = np.zeros((NL, offset + n + pad), np.uint32)
    buf[:, offset:offset + n] = lanes_rows.T
    return from_numpy(buf, CPU)[:, offset:offset + n]


CASES = [(NL, n, view) for NL in range(1, 9) for n, view in ((0, "plain"), (1, "plain"), (37, "plain"),
                                                             (300, "strided"), (257, "offset"))]


@pytest.mark.parametrize("NL,n,view", CASES)
def test_plain_pack_is_serialize_table_and_the_jax_dump(tmp_path, rng, NL, n, view):
    lanes, counts = _table(rng, NL, n, all_t=True)
    t = _lane_major(lanes, pad=11 if view == "strided" else 0, offset=5 if view == "offset" else 0)
    if view != "plain" and NL > 1:
        assert not t.is_contiguous()
    image = pack_records_reference(t, from_numpy(counts, CPU))
    got = image.numpy().tobytes()
    assert image.dtype is torch.uint8
    assert got == _host_bytes(lanes, counts)
    assert len(got) == int((counts > 0).sum()) * 4 * record_words(NL)
    jax_dump.dump_table(str(tmp_path / "jax.bin"), lanes, counts)
    assert got == (tmp_path / "jax.bin").read_bytes()
    # The wrapper takes the plain version for a CPU tensor.
    assert pack_records(t, from_numpy(counts, CPU)).numpy().tobytes() == got


def test_pack_refuses_what_the_kernel_does_not_take():
    lanes = torch.zeros((2, 8), dtype=torch.int32)
    counts = torch.ones(8, dtype=torch.int32)
    with pytest.raises(TypeError):
        pack_records(lanes.to(torch.int64), counts)
    with pytest.raises(ValueError):
        pack_records(torch.zeros((9, 8), dtype=torch.int32), counts)
    with pytest.raises(ValueError):
        pack_records(lanes, counts[:7])
    with pytest.raises(ValueError):
        pack_records(torch.zeros((8, 2), dtype=torch.int32).T, counts)  # rows not contiguous
    with pytest.raises(ValueError):
        pack_records(lanes, torch.ones(16, dtype=torch.int32)[::2])


@pytest.mark.parametrize("k,num_unique,append", [(15, None, False), (16, 20, False), (33, 17, True),
                                                 (101, None, True), (128, None, False)])
def test_dump_table_of_a_tensor_writes_the_host_routes_bytes(tmp_path, rng, k, num_unique, append):
    NL = records.active_lanes(k)
    lanes, counts = _table(rng, NL, 25, all_t=k % 16 == 0)
    paths = tmp_path / "host.bin", tmp_path / "tensor.bin"
    if append:
        for p in paths:
            p.write_bytes(b"head")
    m_host, m_card = metrics.Metrics(), metrics.Metrics()
    n_host = dump_table(str(paths[0]), lanes, counts, num_unique, append, metrics=m_host)
    n_card = dump_table(str(paths[1]), _lane_major(lanes, pad=3), counts, num_unique, append, metrics=m_card)
    assert n_host == n_card > 0
    assert paths[0].read_bytes() == paths[1].read_bytes()
    # A CPU tensor is packed by the plain version on the host, and its
    # image is not copied: neither a card's record nor a D2H byte.
    assert m_host.counters == {"dump_records_host": n_host}
    assert m_card.counters == {"dump_records_host": n_card}
    assert m_card.timer_calls == {"dump": 1, "dump.format": 1, "dump.format.pack": 1, "dump.format.d2h": 1,
                                  "dump.write": 1}
    assert dump_table(str(tmp_path / "plain.bin"), _lane_major(lanes), counts, num_unique, append) == n_card


def test_altering_a_copy_of_the_counts_changes_the_bytes(tmp_path, rng):
    # What the benchmark's planted fault does to the one dump_table call.
    lanes, counts = _table(rng, 2, 40, zeros=False)
    t = _lane_major(lanes)
    dump_table(str(tmp_path / "a.bin"), t, counts)
    altered = counts.copy()
    altered[0] += 1
    dump_table(str(tmp_path / "b.bin"), t, altered)
    a, b = (tmp_path / "a.bin").read_bytes(), (tmp_path / "b.bin").read_bytes()
    assert a != b and len(a) == len(b)
    assert b == _host_bytes(lanes, altered)


def _input(tmp_path, rng, all_t):
    d = tmp_path / "in"
    d.mkdir()
    seqs = random_seqs(rng, 40, 70)
    if all_t:
        seqs[5] = "T" * 70
        seqs[6] = "T" * 30 + "N" + "T" * 39
    write_fastq(d / "a.fastq", seqs[:20])
    write_fastq(d / "b.fastq", seqs[20:])
    return str(d), seqs


@pytest.mark.parametrize("table_impl,k,canonical", [("two", 21, True), ("one", 21, True), ("two", 16, False),
                                                    ("one", 16, False), ("two", 55, False)])
def test_a_whole_count_dumps_the_host_routes_bytes(tmp_path, rng, monkeypatch, table_impl, k, canonical):
    all_t = k % 16 == 0 and not canonical
    in_dir, seqs = _input(tmp_path, rng, all_t)
    original, seen = engine.dump_table, []

    def to_host(path, lanes, counts, *a, **kw):
        # The same table through the host route: row-major NumPy lanes.
        seen.append(type(lanes))
        if isinstance(lanes, torch.Tensor):
            lanes = np.ascontiguousarray(lanes.numpy().view(np.uint32).T)
        return original(path, lanes, counts, *a, **kw)

    def count(out):
        opts = Options(kmer_length=k, canonical=canonical, input_dir=in_dir, output_file=str(tmp_path / out),
                       table_impl=table_impl, reads_per_chunk=4, table_slots=256)
        return engine.CountEngine(opts, device=CPU).run()

    card = count("card.bin")
    monkeypatch.setattr(engine, "dump_table", to_host)
    host = count("host.bin")
    # The table goes to the dump as a tensor; a two-level count's all-T
    # record is appended after it as one host row.
    allt_appended = all_t and table_impl == "two"
    assert seen == [torch.Tensor] + [np.ndarray] * allt_appended
    got = (tmp_path / "card.bin").read_bytes()
    want = golden.serialize_counter(golden.count_reads(seqs, k, canonical))
    assert got == (tmp_path / "host.bin").read_bytes() == want
    # On the CPU the tensor route packs on the host too: its spans tell it.
    assert card.metrics["timer_calls"]["dump.format.pack"] == 1
    assert "dump.format.pack" not in host.metrics["timer_calls"]
    assert "dump_records_card" not in card.metrics["counters"]
    assert card.metrics["counters"]["dump_records_host"] == card.distinct_kmers
    assert host.metrics["counters"]["dump_records_host"] == host.distinct_kmers == card.distinct_kmers
    assert (card.total_kmers, card.reads) == (host.total_kmers, host.reads)
    if all_t:
        # The all-T record, the largest key, is the dump's last.
        words, counts = records.parse_records(got, k)
        assert (records.words_to_lanes(words[-1:])[0, : records.active_lanes(k)] == M).all() and counts[-1] > 0
