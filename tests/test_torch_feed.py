"""The chunk feed (kmer_counter_tpu_torch/feed.py) on the CPU: the chunks it
hands out equal the ingest's, zero-padded (a short last chunk, files of
other line lengths, the mesh's fixed width); its ring and event
bookkeeping, driven on the CPU with stand-in CUDA calls that log their
order (invariants (a)-(d) of feed.py); and a run whose input or step
raises ends at once, with no ingest thread left.  The feed on the card:
tests/test_torch_cuda.py -k feed."""

import queue
import threading
import time

import numpy as np
import pytest
import torch

from kmer_counter_tpu_torch import engine
from kmer_counter_tpu_torch.config import Options
from kmer_counter_tpu_torch.feed import ChunkFeed
from kmer_counter_tpu_torch.io.fastq import DirectoryInput, FASTQChunk
from kmer_counter_tpu_torch.metrics import Metrics
from kmer_counter_tpu_torch.parallel.mesh import make_mesh

from tests.test_ingest import random_seqs, write_fastq
from tests.test_torch_engine import golden_bytes

CPU = torch.device("cpu")


def _input(tmp_path, rng, lengths=((70, 45), (50, 30), (70, 17))):
    """FASTQ files of (line length, reads): read counts that leave a short
    last chunk, and a file of shorter reads between two longer ones."""
    (tmp_path / "in").mkdir()
    for i, (L, n) in enumerate(lengths):
        write_fastq(tmp_path / "in" / f"f{i}.fastq", random_seqs(rng, n, L))
    return str(tmp_path / "in")


def _padded(reads, rows, width):
    out = np.zeros((rows, width), np.uint8)
    out[: reads.shape[0], : reads.shape[1]] = reads
    return out


@pytest.mark.parametrize("positions,fixed_width", [(1, False), (1, True), (3, True)],
                         ids=["single", "single-fixed-width", "mesh-3"])
@pytest.mark.parametrize("ingest_threads", [1, 3])
def test_feed_hands_out_the_ingest_chunks(tmp_path, rng, positions, fixed_width, ingest_threads):
    """Through the engine's prefetch thread and the feed (a ring of 2
    slots, so every slot is refilled): each chunk equals the ingest's,
    zero rows after a short chunk, zero columns past a shorter file's
    reads where the width is fixed (the mesh), each position's rows its
    share; a shorter file's chunk is a [rows, L] view otherwise."""
    d = _input(tmp_path, rng)
    opts = Options(kmer_length=21, input_dir=d, output_file=str(tmp_path / "o"), ingest_threads=ingest_threads,
                   prefetch_chunks=0)
    eng = engine.CountEngine(opts, device=CPU)
    rpp, L = 7, 70
    rows = rpp * positions
    want = []
    src = DirectoryInput(d)
    while (c := src.read_chunk(rows)) is not None:
        want.append(_padded(c.reads, rows, L if fixed_width else c.line_length))
    src.close()
    feed = ChunkFeed([CPU] * positions, rpp, L, 2)
    stats, metrics = engine.RunStats(), Metrics()
    got = []
    for chunk, slot, slots in eng._chunks(engine._make_source(opts), feed, L if fixed_width else None, stats,
                                          metrics, 0, None):
        views = feed.upload(slot)
        assert len(views) == positions and all(v.shape == (rpp, slot.width) for v in views)
        assert slots == rows * (chunk.line_length - 20)
        got.append(torch.cat(views).numpy().copy())
        feed.consumed()
    assert len(got) == len(want) > 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert metrics.timer_calls["stage"] == len(got)


class _Log:
    """The order of the stand-in CUDA calls, from every thread."""

    def __init__(self):
        self.lock = threading.Lock()
        self.entries = []

    def add(self, *entry):
        with self.lock:
            self.entries.append(entry)
            return len(self.entries) - 1


def stand_in_ops(log):
    """CudaOps with stand-ins: streams and events that log their calls
    (an event's record makes a new version of it), CPU tensors for the
    pinned slots and the device buffers, and copies that log their
    operands and copy at once."""

    class Event:
        count = 0

        def __init__(self):
            Event.count += 1
            self.name, self.version = f"e{Event.count}", 0

        def record(self, stream):
            self.version += 1
            log.add("record", self.name, self.version, stream.name)

        def synchronize(self):
            log.add("sync", self.name, self.version, threading.current_thread().name)

    class Stream:
        def __init__(self, name):
            self.name = name

        def wait_event(self, event):
            log.add("wait", self.name, event.name, event.version)

    compute = Stream("compute")

    class Ops:
        pass

    Ops.event = Event
    Ops.stream = staticmethod(lambda device: Stream(f"copy:{device}"))
    Ops.current_stream = staticmethod(lambda device: compute)
    Ops.pinned = staticmethod(lambda nbytes: torch.empty(nbytes, dtype=torch.uint8))

    def device_buffer(nbytes, device, copy_stream):
        buf = torch.full((nbytes,), 0xEE, dtype=torch.uint8)
        log.add("alloc", str(device), buf.data_ptr())
        return buf

    def copy(stream, dst, src):
        log.add("copy", stream.name, dst.data_ptr(), src.data_ptr())
        dst.copy_(src)

    Ops.device_buffer = staticmethod(device_buffer)
    Ops.copy = staticmethod(copy)
    return Ops


class _Source:
    """``n`` random chunks of ``rows`` reads (the last one short), as
    DirectoryInput gives them."""

    def __init__(self, rng, n, rows, L):
        self.chunks = [rng.integers(65, 90, (rows if i < n - 1 else rows // 2 + 1, L), dtype=np.uint8)
                       for i in range(n)]
        self.i = 0

    def read_chunk(self, max_reads):
        if self.i == len(self.chunks):
            return None
        reads = self.chunks[self.i]
        self.i += 1
        return FASTQChunk(reads, reads.shape[0], reads.shape[1], "x")


def _slot_events(feed):
    return {id(s): [e.name for e in s.copied] for s in feed._free.queue}


@pytest.mark.parametrize("devices", [["cuda:0"], ["cuda:0"] * 3 + ["cuda:1"]], ids=["one-card", "two-cards"])
def test_ring_and_event_order(rng, devices):
    """The ring's bookkeeping on the card's path, with stand-in events
    and the engine's prefetch thread against a consumer that reads each
    chunk: (a) a slot is staged only after the copy-done event recorded
    after its last copy was waited on, in the prefetch thread; (b) a copy
    into a card's buffer comes after its copy stream waited on a consumed
    event recorded after the last read; (c) each read comes after the
    compute stream waited on the copy-done event of that chunk's copy;
    (d) the main thread waits on no event.  Positions that share a card
    share one copy a chunk."""
    log = _Log()
    rpp, L, n = 5, 24, 40
    feed = ChunkFeed(devices, rpp, L, 3, ops=stand_in_ops(log))
    events = _slot_events(feed)
    real_stage = feed.stage

    def stage(slot, reads, width):
        log.add("stage", id(slot))
        real_stage(slot, reads, width)

    feed.stage = stage
    src = _Source(rng, n, feed.rows, L)
    out_q = queue.Queue()
    worker = threading.Thread(target=engine.CountEngine._ingest_worker,
                              args=(src, feed, None, out_q, Metrics()), name="kmer-ingest")
    worker.start()
    cards = sorted(set(devices))
    for i in range(n):
        chunk, slot = out_q.get(timeout=30)
        views = feed.upload(slot)
        log.add("read", i, id(slot))
        np.testing.assert_array_equal(torch.cat(views).numpy(), _padded(src.chunks[i], feed.rows, L))
        feed.consumed()
        if i % 3 == 0:
            time.sleep(0.002)  # a slow step now and then: the producer runs ahead
    assert out_q.get(timeout=30) is engine._END
    worker.join(timeout=30)
    assert not worker.is_alive()

    entries = log.entries
    by_kind = {}
    for at, e in enumerate(entries):
        by_kind.setdefault(e[0], []).append(at)
    copies = [(at, entries[at]) for at in by_kind["copy"]]
    assert len(copies) == n * len(cards)  # one copy a card a chunk
    assert len(by_kind["alloc"]) == len(cards)
    spans = [(s.host.data_ptr(), s.host.data_ptr() + s.host.numel(), id(s)) for s in feed._free.queue
             if s is not None]
    # (a): the copies from a slot, then its events recorded and waited on, then its next staging.
    for at, (_, stream, dst, src_ptr) in copies:
        sid = next(sid for lo, hi, sid in spans if lo <= src_ptr < hi)
        nxt = next((j for j in by_kind["stage"] if j > at and entries[j][1] == sid), len(entries))
        card = cards.index(stream.split(":", 1)[1])
        ev = events[sid][card]
        rec = next(j for j in by_kind["record"] if j > at and entries[j][1] == ev)
        assert rec < nxt
        version = entries[rec][2]
        if nxt < len(entries):
            assert any(rec < j < nxt and entries[j][1:3] == (ev, version) and entries[j][3] == "kmer-ingest"
                       for j in by_kind["sync"]), f"slot staged at {nxt} before the wait on its copy at {at}"
    # (b): each copy stream waited on a consumed event recorded after the last read.
    for at, (_, stream, _, _) in copies:
        last_read = max([j for j in by_kind["read"] if j < at], default=-1)
        waits = [j for j in by_kind["wait"] if j < at and entries[j][1] == stream]
        w = entries[waits[-1]]
        rec = max(j for j in by_kind["record"] if j < waits[-1] and entries[j][1:3] == (w[2], w[3]))
        assert rec > last_read and entries[rec][3] == "compute"
    # (c): each read after the compute stream waited on each card's copy-done event of its chunk.
    for j in by_kind["read"]:
        last_copies = {}
        for at, (_, stream, _, _) in copies:
            if at < j:
                last_copies[stream] = at
        for stream, at in last_copies.items():
            rec = next(r for r in by_kind["record"] if r > at and entries[r][3] == stream)
            assert any(rec < w < j and entries[w][1] == "compute" and entries[w][2:4] == entries[rec][1:3]
                       for w in by_kind["wait"])
    # (d): every host wait is the prefetch thread's.
    assert {entries[j][3] for j in by_kind["sync"]} == {"kmer-ingest"}


def test_zeros_and_release(rng):
    """A drained process's zero chunk is the feed's own buffer, zeroed on
    the compute stream with no copy; after release the next upload
    allocates again and its copy waits on a consumed event recorded at
    the allocation."""
    log = _Log()
    feed = ChunkFeed(["cuda:0"] * 2, 3, 8, 2, ops=stand_in_ops(log))
    slot = feed.acquire()
    reads = rng.integers(65, 90, (6, 8), dtype=np.uint8)
    feed.stage(slot, reads, 8)
    np.testing.assert_array_equal(torch.cat(feed.upload(slot)).numpy(), reads)
    feed.consumed()
    copies = sum(e[0] == "copy" for e in log.entries)
    for _ in range(2):
        zeros = feed.zeros()
        assert [z.shape for z in zeros] == [(3, 8)] * 2 and not any(z.any() for z in zeros)
        feed.consumed()
    assert sum(e[0] == "copy" for e in log.entries) == copies
    feed.release()
    slot = feed.acquire()
    feed.stage(slot, reads[:4, :5], 8)
    start = len(log.entries)
    got = torch.cat(feed.upload(slot)).numpy()
    np.testing.assert_array_equal(got, _padded(reads[:4, :5], 6, 8))
    kinds = [e[0] for e in log.entries[start:]]
    assert kinds[:3] == ["alloc", "record", "wait"] and log.entries[start + 1][3] == "compute"
    assert log.entries[start + 2][2:] == log.entries[start + 1][1:3]


def test_stage_refuses_a_chunk_wider_than_its_slot(rng):
    feed = ChunkFeed([CPU], 4, 10, 2)
    slot = feed.acquire()
    with pytest.raises(ValueError, match="does not fit"):
        feed.stage(slot, np.zeros((4, 11), np.uint8), 11)
    with pytest.raises(ValueError, match="does not fit"):
        feed.stage(slot, np.zeros((5, 10), np.uint8), 10)


def test_a_feed_is_for_cards_or_the_cpu():
    with pytest.raises(ValueError, match="CUDA devices or the CPU"):
        ChunkFeed([CPU, torch.device("cuda:0")], 4, 10, 2)


def _ingest_threads():
    return [t for t in threading.enumerate() if t.name == "kmer-ingest" and t.is_alive()]


@pytest.mark.parametrize("where", ["source", "step"])
@pytest.mark.parametrize("mesh", [False, True], ids=["single", "mesh"])
def test_a_failure_mid_run_raises_at_once_and_leaves_no_ingest_thread(tmp_path, rng, monkeypatch, where, mesh):
    """The input raises after two chunks, or the third step does while the
    prefetch thread waits for a slot (every one in use): run() raises that
    error within seconds and the prefetch thread has ended."""
    from kmer_counter_tpu_torch.ops import pipeline as ops_pipeline
    from kmer_counter_tpu_torch.parallel import pipeline as mesh_pipeline

    d = _input(tmp_path, rng, lengths=((60, 400),))
    opts = Options(kmer_length=21, input_dir=d, output_file=str(tmp_path / "o"), reads_per_chunk=8,
                   prefetch_chunks=0, verbose=0)
    if where == "source":
        real_make = engine._make_source

        def make_source(opts_, shard=None):
            src = real_make(opts_, shard)
            real_read, done = src.read_chunk, [0]

            def read_chunk(n):
                if done[0] == 2:
                    raise OSError("the source failed")
                done[0] += 1
                return real_read(n)

            src.read_chunk = read_chunk
            return src

        monkeypatch.setattr(engine, "_make_source", make_source)
        error = OSError
    else:
        calls = [0]

        def failing(real):
            def step(*args, **kw):
                calls[0] += 1
                if calls[0] == 3:
                    time.sleep(0.2)  # the prefetch thread fills the ring and blocks
                    raise RuntimeError("the step failed")
                return real(*args, **kw)

            return step

        if mesh:
            monkeypatch.setattr(mesh_pipeline.ShardedCounter2, "step", failing(mesh_pipeline.ShardedCounter2.step))
        else:
            monkeypatch.setattr(ops_pipeline, "count_step_two_level", failing(ops_pipeline.count_step_two_level))
        error = RuntimeError
    eng = (engine.MeshCountEngine(opts, mesh=make_mesh(devices=[CPU] * 2)) if mesh
           else engine.CountEngine(opts, device=CPU))
    raised = []

    def run():
        try:
            eng.run()
        except Exception as e:
            raised.append(e)

    t0 = time.perf_counter()
    runner = threading.Thread(target=run)
    runner.start()
    runner.join(timeout=60)
    assert not runner.is_alive(), "the run hangs"
    assert time.perf_counter() - t0 < 10
    assert len(raised) == 1 and isinstance(raised[0], error), raised
    assert not _ingest_threads()


@pytest.mark.parametrize("impl", ["two", "one"])
def test_run_stages_every_chunk_in_the_ingest_thread(tmp_path, rng, impl):
    """A CPU run through the feed: golden's dump, each chunk staged once
    (the ``stage`` timer) and dispatched once."""
    _input(tmp_path, rng)
    opts = Options(kmer_length=21, input_dir=str(tmp_path / "in"), output_file=str(tmp_path / "o.bin"),
                   reads_per_chunk=7, table_impl=impl, table_slots=2000, verbose=0)
    stats = engine.CountEngine(opts, device=CPU).run()
    calls = stats.metrics["timer_calls"]
    assert calls["stage"] == calls["dispatch"] == stats.chunks == 7 + 5 + 3
    assert (tmp_path / "o.bin").read_bytes() == golden_bytes(tmp_path, 21, False)
    assert not _ingest_threads()
