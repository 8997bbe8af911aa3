"""Orchestrator: the chunked count loop over a FASTQ directory —
counterpart of kmer_counter_tpu.engine (single device).

A prefetch thread parses chunks (io.fastq) and stages each in a pinned
slot of the run's feed (feed.py); the main thread enqueues its copy to the
card on the feed's copy stream, then the chunk's extract + append on the
compute stream, which waits on the copy.  Two tables:

  * two-level (``tableImpl=two``, and ``auto``): keys go to a raw region;
    when it is full the table consolidates through the merge-fold-compact
    kernel (ops.table2);
  * one-level (``tableImpl=one``): keys with 0/1 counts go to one append
    buffer; when it is full, ``sort_reduce`` over the whole buffer (the
    multi-lane sort kernel) collapses duplicates (ops.table).

The host mirrors the append offsets exactly, so no chunk step waits on the
device; consolidations read back only the live row count.

With ``tempFileLocation`` set, a consolidation that would take the table
past the run's cap (``budget.py``: from ``gpuMemoryLimit``, or twice
``tableSlots``) first writes the table's live rows to disk as a sorted run
(io.spill); the host merges the runs and the final table into the output.
With ``checkpointDir`` and ``checkpointEvery``, every that many
consolidations the consolidated table, the reads it holds and the
outstanding spill runs are saved (checkpoint.py), and a run with the same
``checkpointDir`` resumes from the snapshot.  ``profile=true`` traces the
run with torch.profiler (metrics.device_trace).

Every phase of a run is a ``Metrics`` timer, and so a ``kmer.<timer>``
span while a profiler records: on the main thread ``run`` (the whole run,
``RunStats.wall_seconds``), ``setup`` (the source and its probe, the plan,
a resume, the feed's ring, the table), ``ingest_wait``, ``dispatch``,
``consolidate``, ``finalize`` (with ``finalize.copy_back``: the copy of the
counts from the card, ``.d2h``), ``close`` (the feed closed, the prefetch
thread joined, the source closed) and ``dump`` (``dump.format``, with
``.pack`` and ``.d2h`` for the lanes left on the device, and
``dump.write``); where the final table joins spill runs, a second
``finalize.copy_back`` after the finalize copies its lanes (``.d2h``) and
transposes them on the host (``.transpose``) instead of the dump; the
``d2h_bytes`` counter is the bytes of those copies (the dump's only where
they crossed from a card);
in the prefetch thread ``ingest``, ``feed.acquire`` (waiting for a free
slot of the ring) and ``stage``.  The counter ``unspanned_us`` is the part
of ``run`` that no timer opened directly inside it covered; with
``ingestThreads`` > 1 the source's ``ingest_blocks_ready``,
``ingest_blocks_waited`` and ``ingest_units`` (io.fastq.ParallelIngest)
are counters too.

``MeshCountEngine`` runs the same loop over the positions of a mesh
(parallel): each counts its rows of every chunk into a table of its own,
and the finalize routes each record to the position that owns its key
range; with several processes each writes its ranges as part files.
``run_count`` takes it for ``meshShape``, more than one visible card or
more than one rank.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import queue
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from kmer_counter_tpu_torch import records
from kmer_counter_tpu_torch import budget as bg
from kmer_counter_tpu_torch.config import Options
from kmer_counter_tpu_torch.feed import ChunkFeed
from kmer_counter_tpu_torch.io.dump import dump_table, load_table
from kmer_counter_tpu_torch.io.fastq import DirectoryInput, ParallelIngest
from kmer_counter_tpu_torch.metrics import Metrics, device_trace
from kmer_counter_tpu_torch.ops.pipeline import chunk_slots
from kmer_counter_tpu_torch.ops.u32 import MASK, SENTINEL, counts_to_host, from_numpy, lanes_to_host, to_numpy
from kmer_counter_tpu_torch.parallel.mesh import allgather_host, global_any, global_max_int, make_mesh
from kmer_counter_tpu_torch.parallel.pipeline import ShardedCounter, ShardedCounter2

_END = object()


@dataclass
class RunStats:
    """End-of-run summary."""

    reads: int = 0
    bases: int = 0
    chunks: int = 0
    consolidations: int = 0
    distinct_kmers: int = 0
    total_kmers: int = 0
    spilled_runs: int = 0
    wall_seconds: float = 0.0
    per_file: dict = field(default_factory=dict)
    metrics: dict = field(default_factory=dict)

    @property
    def kmers_per_second(self) -> float:
        return self.total_kmers / self.wall_seconds if self.wall_seconds else 0.0


def plan_chunks(opts: Options, line_length: int) -> tuple[int, int]:
    """(reads_per_chunk, table_slots) under the ``gpuMemoryLimit`` budget.

    The JAX package's budget model (engine.plan_chunks): a slot is NL+1
    uint32s and consolidation roughly triples the working set, so the
    table gets budget/2 / (slot_bytes * 3) slots; a chunk's worst case,
    reads*(L-k+1) slots, must fit 4x inside the table.  No TPU tile
    rounding: the CUDA kernel masks its own ragged edge.
    """
    k = opts.kmer_length
    if line_length < k:
        raise ValueError(f"line length {line_length} < k={k}: no k-mers can be extracted")
    slot_bytes = (records.active_lanes(k) + 1) * 4
    table_slots = opts.table_slots or max(opts.memory_limit_bytes // 2 // (slot_bytes * 3), 1 << 14)
    P = line_length - k + 1
    reads_per_chunk = opts.reads_per_chunk or max(table_slots // 4 // P, 16)
    if reads_per_chunk * P > table_slots // 2:
        table_slots = 2 * reads_per_chunk * P
    return reads_per_chunk, table_slots


def _make_source(opts: Options, shard=None):
    """The order-preserving parser pool when ingestThreads > 1, else the
    sequential reader; both give the same chunk stream.  ``shard=(rank,
    processes)``: this process's share of the input (io.fastq: whole files
    round-robin, or byte ranges when there are fewer files than
    processes)."""
    if opts.ingest_threads > 1:
        return ParallelIngest(opts.input_dir, threads=opts.ingest_threads, shard=shard)
    return DirectoryInput(opts.input_dir, shard=shard)


def _file_key(path: str) -> str:
    """Checkpoint-manifest key for a source file."""
    return os.path.basename(path) if path else ""


def _absorb(stats: RunStats, chunk) -> None:
    """Count a chunk's reads as absorbed: only once its device step is
    enqueued (or, for reads shorter than k, at once), so that a snapshot
    of a consolidated table counts exactly the reads the table holds."""
    name = _file_key(chunk.path)
    stats.reads += chunk.n_reads
    stats.bases += chunk.n_reads * chunk.line_length
    stats.per_file[name] = stats.per_file.get(name, 0) + chunk.n_reads


def _allt_record(NL: int, allt: int) -> tuple[np.ndarray, np.ndarray]:
    """The all-T record of a two-level count (k % 16 == 0, forward) as host
    rows: T^k packs to all-ones in every active lane, the largest key."""
    return np.full((1, NL), MASK, np.uint32), np.asarray([allt], np.uint32)


def _start_monitor(opts: Options, stats: RunStats, gauge_extra):
    """1 Hz size monitor under verbose >= 2; a no-op context otherwise."""
    if opts.verbose < 2:
        return contextlib.nullcontext()
    from kmer_counter_tpu_torch.metrics import SizeMonitor

    return SizeMonitor(
        lambda: f"reads={stats.reads} chunks={stats.chunks} "
        f"consolidations={stats.consolidations} spills={stats.spilled_runs} {gauge_extra()}"
    )


class CountEngine:
    """Single-device count engine on ``device`` (default: cuda)."""

    def __init__(self, opts: Options, device: torch.device | None = None):
        if opts.input_dir is None:
            raise ValueError("inputFileLocation is required")
        if opts.output_file is None:
            raise ValueError("outputFile is required")
        if opts.table_impl not in ("one", "two", "auto"):
            raise ValueError(f"unknown tableImpl {opts.table_impl!r}")
        device = torch.device("cuda") if device is None else torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not available")
        self.opts = opts
        self.device = device
        self._scheduler = None  # the spill-merge scheduler, once a run spills (io.spill)

    @staticmethod
    def _ingest_worker(source, feed, width, out_q, metrics, skip_reads=0, expected_files=None):
        """Prefetch thread: parse chunks ahead of the device and stage each
        in a slot of ``feed`` (``width`` columns, or the chunk's own line
        length when None); every chunk goes on ``out_q`` with its slot, so
        the feed's ring bounds what waits there.  The thread ends when the
        input does, or, without taking a slot, once the feed is closed.

        ``skip_reads`` reads are consumed and discarded first (checkpoint
        resume; ingest order is deterministic).  ``expected_files`` is the
        checkpoint's per-file absorbed-read manifest: the skip must consume
        exactly those counts, or the input changed since the snapshot and
        the resume would misalign (the error goes to the consumer)."""
        try:
            skipped: dict[str, int] = {}
            while skip_reads > 0:
                with metrics.timer("ingest"):
                    chunk = source.read_chunk(min(feed.rows, skip_reads))
                if chunk is None:
                    break
                skip_reads -= chunk.n_reads
                name = _file_key(chunk.path)
                skipped[name] = skipped.get(name, 0) + chunk.n_reads
            if expected_files is not None and skipped != expected_files:
                out_q.put(
                    RuntimeError(
                        "checkpoint resume drift: the ingest skip consumed "
                        f"{skipped} but the checkpoint absorbed "
                        f"{expected_files} — the input directory's readable "
                        "file set changed since the snapshot; delete the "
                        "checkpoint to recount from scratch"
                    )
                )
                return
            while True:
                with metrics.timer("ingest"):
                    chunk = source.read_chunk(feed.rows)
                if chunk is None:
                    break
                with metrics.timer("feed.acquire"):
                    slot = feed.acquire()
                if slot is None:
                    return
                with metrics.timer("stage"):
                    feed.stage(slot, chunk.reads, width or chunk.line_length)
                out_q.put((dataclasses.replace(chunk, reads=None), slot))
        except Exception as e:  # handed to the consumer, which re-raises it
            out_q.put(e)
        finally:
            out_q.put(_END)

    def _chunks(self, source, feed, width, stats, metrics, skip_reads, expected_files):
        """The chunks that hold k-mers, as (chunk, its staged slot of
        ``feed``, worst-case slots), parsed ahead by the prefetch thread.
        Chunks of reads shorter than k are absorbed here; the caller
        uploads each chunk it gets and absorbs it once its step is
        enqueued.  Closing the generator (the caller raised) closes the
        feed and joins the prefetch thread."""
        k = self.opts.kmer_length
        chunk_q: queue.Queue = queue.Queue()
        ingest = threading.Thread(
            target=self._ingest_worker,
            args=(source, feed, width, chunk_q, metrics, skip_reads, expected_files),
            name="kmer-ingest",
            daemon=True,
        )
        ingest.start()
        try:
            while True:
                with metrics.timer("ingest_wait"):
                    item = chunk_q.get()
                if item is _END:
                    break
                if isinstance(item, Exception):
                    raise item
                chunk, slot = item
                if chunk.line_length < k:
                    feed.give_back(slot)
                    _absorb(stats, chunk)
                    continue
                yield chunk, slot, chunk_slots(feed.rows, chunk.line_length, k)
        finally:
            with metrics.timer("close"):
                feed.close()
                ingest.join()
                source.close()
            for name, value in getattr(source, "counters", {}).items():
                metrics.count(name, value)

    def _feed(self, devices, rows_per_position, line_length):
        """The run's feed (feed.py), its ring allocated here, on the main
        thread, before the prefetch thread starts: prefetchChunks queued
        chunks, one being copied and one being filled."""
        return ChunkFeed(devices, rows_per_position, line_length, max(self.opts.prefetch_chunks, 0) + 2)

    def run(self) -> RunStats:
        opts = self.opts
        stats, metrics = RunStats(), Metrics()
        with metrics.timer("run"):
            self._run(stats, metrics)
        stats.wall_seconds = metrics.timers["run"]
        for name, value in (
            ("reads", stats.reads),
            ("chunks", stats.chunks),
            ("consolidations", stats.consolidations),
            ("distinct_kmers", stats.distinct_kmers),
            ("unspanned_us", round(1e6 * metrics.uncovered("run"))),
        ):
            metrics.count(name, value)
        stats.metrics = metrics.snapshot()
        if opts.verbose:
            print(f"[metrics] {metrics.report()}")
            print(
                f"[engine] reads={stats.reads} bases={stats.bases} "
                f"distinct={stats.distinct_kmers} total={stats.total_kmers} "
                f"chunks={stats.chunks} consolidations={stats.consolidations} "
                f"wall={stats.wall_seconds:.2f}s "
                f"({stats.kmers_per_second/1e6:.2f}M kmers/s)"
            )
        return stats

    def _run(self, stats: RunStats, metrics: Metrics) -> None:
        """The count, from the input directory to the output file."""
        opts = self.opts
        k = opts.kmer_length
        with metrics.timer("setup"):
            source = _make_source(opts)
            usable = [L for L in source.probe_line_lengths() if L >= k]
        if not usable:
            source.close()
            dump_table(opts.output_file, np.zeros((0, records.active_lanes(k)), np.uint32), np.zeros(0, np.uint32),
                       metrics=metrics)
            return
        with metrics.timer("setup"):
            line_length = max(usable)
            reads_per_chunk, table_slots = plan_chunks(opts, line_length)
            resumed = self._resume(stats) if opts.checkpoint_dir else None
            # What a chunk puts on the card sizes the tables' memory plan.
            per_chunk = bg.Chunk(reads_per_chunk * line_length, chunk_slots(reads_per_chunk, line_length, k))
            feed = self._feed([self.device], reads_per_chunk, line_length)
        count = self._count_one_level if opts.table_impl == "one" else self._count_two_level
        with contextlib.closing(self._chunks(source, feed, None, stats, metrics,
                                             resumed.reads_absorbed if resumed else 0,
                                             resumed.files if resumed else None)) as chunks:
            lanes, counts, allt = count(chunks, feed, line_length, reads_per_chunk, table_slots, stats, metrics,
                                        resumed, per_chunk)
        stats.consolidations += 1  # the finalize's
        NL = lanes.shape[0]
        if self._scheduler is not None:
            # The final table joins the spill runs as host rows; the host
            # merge writes the sorted output.
            from kmer_counter_tpu_torch.io import spill as spill_io

            rows = lanes_to_host(lanes, metrics)
            if allt:
                allt_lanes, allt_counts = _allt_record(NL, allt)
                rows, counts = np.concatenate([rows, allt_lanes]), np.concatenate([counts, allt_counts])
            stats.spilled_runs += 1
            self._scheduler.add_run(
                spill_io.write_run(os.path.join(opts.temp_dir, "final_table.run"), rows, counts)
            )
            with metrics.timer("merge"):
                stats.distinct_kmers = self._scheduler.finish(opts.output_file)
            self._scheduler = None
            _, counts_all = load_table(opts.output_file, k)
            stats.total_kmers = int(counts_all.sum(dtype=np.uint64))
        else:
            stats.distinct_kmers = len(counts) + bool(allt)
            stats.total_kmers = int(counts.sum(dtype=np.uint64)) + allt
            dump_table(opts.output_file, lanes, counts, metrics=metrics)
            if allt:
                dump_table(opts.output_file, *_allt_record(NL, allt), append=True, metrics=metrics)

    # ---- checkpoints and spill -------------------------------------------

    def _resume(self, stats: RunStats):
        """The checkpoint to resume from, or None: its absorbed reads are
        counted into ``stats`` and its spill runs re-registered."""
        from kmer_counter_tpu_torch import checkpoint as ckpt

        resumed = ckpt.load(self.opts.checkpoint_dir, self.opts)
        if resumed is None:
            return None
        stats.reads = resumed.reads_absorbed
        stats.per_file = dict(resumed.files or {})
        if resumed.spill_runs:
            self._resume_spill(resumed.spill_runs, stats)
        if self.opts.verbose:
            print(
                f"[engine] resumed checkpoint: {len(resumed.counts)} records, "
                f"{resumed.reads_absorbed} reads absorbed, "
                f"{len(resumed.spill_runs)} spill runs"
            )
        return resumed

    def _checkpoint_due(self, stats: RunStats) -> bool:
        opts = self.opts
        return bool(opts.checkpoint_every and opts.checkpoint_dir
                    and stats.consolidations % opts.checkpoint_every == 0)

    def _save_checkpoint(self, stats: RunStats, lanes: torch.Tensor, counts: torch.Tensor, allt: int = 0):
        """Snapshot a consolidated table (``lanes [NL, U]``, ``counts
        [U]``, unique and ascending): it holds every chunk absorbed so far
        (``stats.reads``), less those in the outstanding spill runs, which
        the snapshot lists."""
        from kmer_counter_tpu_torch import checkpoint as ckpt

        ckpt.save(
            self.opts.checkpoint_dir,
            self.opts,
            to_numpy(lanes).T,
            to_numpy(counts),
            stats.reads,
            files=dict(stats.per_file),
            allt=allt,
            spill_runs=self._scheduler.snapshot_runs() if self._scheduler is not None else None,
        )

    def _merge_scheduler(self, seq_start: int = 0):
        """The host merge of the spill runs (noOfMergersAtOnce runs a
        merge, noOfMergeThreads merges at once)."""
        from kmer_counter_tpu_torch.io import spill as spill_io

        opts = self.opts
        return spill_io.MergeScheduler(opts.temp_dir, opts.kmer_length, fan_in=opts.no_of_mergers_at_once,
                                       threads=opts.no_of_merge_threads, seq_start=seq_start)

    def _resume_spill(self, spill_runs: dict, stats: RunStats):
        """Rebuild the merge scheduler from a checkpoint's spill-run
        manifest (resume across a spill).  Filename sequences restart past
        every existing file in the temp dir, so re-registered runs (and
        orphans of the crashed run) are never overwritten."""
        import re

        opts = self.opts
        if not opts.temp_dir:
            raise RuntimeError("checkpoint lists spill runs but no tempFileLocation is set")
        seqs = [0]
        if os.path.isdir(opts.temp_dir):
            for name in os.listdir(opts.temp_dir):
                m = re.match(r"(?:spill|merge)_(\d+)\.run$", name)
                if m:
                    seqs.append(int(m.group(1)))
        top = max(seqs)
        self._scheduler = self._merge_scheduler(seq_start=top)
        stats.spilled_runs = max(stats.spilled_runs, top)
        for path in spill_runs:
            self._scheduler.add_run(path)

    def _spill(self, lanes: np.ndarray, counts: np.ndarray, stats: RunStats, metrics: Metrics):
        """Write a consolidated table's live rows (``lanes [n, NL]``,
        ``counts [n]`` uint32, unique and ascending) to disk as a sorted
        run."""
        from kmer_counter_tpu_torch.io import spill as spill_io

        opts = self.opts
        if self._scheduler is None:
            self._scheduler = self._merge_scheduler()
        with metrics.timer("spill"):
            stats.spilled_runs += 1
            path = os.path.join(opts.temp_dir, f"spill_{stats.spilled_runs:06d}.run")
            self._scheduler.add_run(spill_io.write_run(path, lanes, counts))
        if opts.verbose:
            print(f"[engine] spilled {counts.shape[0]} records -> {path}")

    # ---- the two tables --------------------------------------------------

    def _count_two_level(self, chunks, feed, line_length, reads_per_chunk, table_slots, stats, metrics, resumed,
                         per_chunk):
        """The two-level chunk loop (counterpart of
        ``CountEngine._run_two_level``); returns the finalized table as
        (lanes ``[NL, U]`` on the device, counts on the host, the all-T
        count): table2.finalize_host.

        With a ``tempFileLocation`` the prefix grows up to the spill cap
        (budget.max_prefix_slots) and its live rows spill past it.  Without
        one the plan alone keeps ``gpuMemoryLimit``: the prefix grows only
        as far as the consolidation's steps stay within it
        (budget.consolidation_prefix_slots), and after each consolidation
        the raw region gives up the slots that the next one, in the worst
        case, would need for the prefix (budget.raw_slots_within), so
        consolidations come more often; where the live rows leave no room
        for a chunk, the count stops before it allocates."""
        from kmer_counter_tpu_torch.ops import table2 as t2
        from kmer_counter_tpu_torch.ops.pipeline import count_step_two_level

        opts = self.opts
        k = opts.kmer_length
        NL = records.active_lanes(k)
        limit = opts.memory_limit_bytes
        # 1:7 prefix:raw split, as in the JAX engine: more chunks per
        # consolidation; the prefix grows on demand.
        cp = max(table_slots // 8, 1)
        cr = max(table_slots - cp, chunk_slots(reads_per_chunk, line_length, k))
        cap = bg.max_prefix_slots(opts, NL, cr, per_chunk) if opts.temp_dir else None
        if opts.verbose:
            print(
                f"[engine] two-level k={k} canonical={opts.canonical} "
                f"L={line_length} reads/chunk={reads_per_chunk} "
                f"prefix={cp} raw={cr} device={self.device}"
            )
        live_bound = 0  # prefix rows in use (exact after a consolidation)
        raw_bound = 0  # raw slots in use (host mirror of table.raw_off)
        with metrics.timer("setup"):
            if resumed is not None:
                # The snapshot's rows, unique and ascending, then sentinel rows
                # with count 0, so the prefix stays ascending as K1 requires.
                # Rows that pass the cap (a snapshot written under another
                # rule) become a run, as at a consolidation.
                rows = records.strip_lanes_to_active(resumed.lanes, k)
                U = len(resumed.counts)
                most = None if cap is not None else bg.consolidation_prefix_slots(limit, NL, cp, cr, U, 0, per_chunk)
                cp, spill = bg.next_prefix(cap, cp, U, 0, most)
                if spill:
                    self._spill(rows, resumed.counts, stats, metrics)
                else:
                    live_bound = U
                if cap is None:
                    cr = bg.raw_slots_within(limit, NL, cp, cr, live_bound, per_chunk)
                prefix_lanes = np.full((NL, cp), 0xFFFFFFFF, np.uint32)
                prefix_counts = np.zeros(cp, np.uint32)
                prefix_lanes[:, :live_bound] = rows[:live_bound].T
                prefix_counts[:live_bound] = resumed.counts[:live_bound]
                table = t2.table_from_numpy(prefix_lanes, prefix_counts, np.zeros((NL, cr), np.uint32), 0,
                                            resumed.allt, self.device)
            else:
                if cap is None:
                    cr = bg.raw_slots_within(limit, NL, cp, cr, 0, per_chunk)
                table = t2.make_table2(cp, cr, NL, self.device)

        def consolidate(final=False):
            # The prefix is sized before the merge so that it can never
            # truncate; where growing it would pass the cap, its live
            # rows spill first (budget.next_prefix).  ``table`` is rebound
            # here, not passed in, so the old buffers are freed before the
            # kernel runs.  The all-T side count stays in the table and is
            # written once, at the end.
            nonlocal table, cp, cr, live_bound
            most = None if cap is not None else bg.consolidation_prefix_slots(
                limit, NL, cp, cr, live_bound, raw_bound, per_chunk)
            new_cp, spill = bg.next_prefix(cap, cp, live_bound, raw_bound, most)
            if spill:
                self._spill(to_numpy(table.prefix_lanes[:, :live_bound]).T,
                            to_numpy(table.prefix_counts[:live_bound]), stats, metrics)
                table.prefix_lanes[:, :live_bound] = SENTINEL
                table.prefix_counts[:live_bound] = 0
                live_bound = 0
            if new_cp > cp:
                if opts.verbose:
                    print(f"[engine] growing prefix to {new_cp} slots")
                table = t2.grow2(table, new_cp, cr)
                cp = new_cp
            with metrics.timer("consolidate"):
                table, live_bound, lost = t2.consolidate3(table, metrics=metrics)
            if lost:
                raise RuntimeError(
                    f"consolidation truncated {lost} live records: "
                    "prefix pre-grow invariant violated"
                )
            if final:
                return  # counted by run() as the finalize's
            stats.consolidations += 1
            if cap is None:
                raw_slots = bg.raw_slots_within(limit, NL, cp, cr, live_bound, per_chunk)
                if raw_slots < cr:
                    if opts.verbose:
                        print(f"[engine] raw region {cr} -> {raw_slots} slots beside {live_bound} live rows")
                    table = t2.grow2(table, cp, raw_slots)
                    cr = raw_slots
            if self._checkpoint_due(stats):
                self._save_checkpoint(stats, table.prefix_lanes[:, :live_bound],
                                      table.prefix_counts[:live_bound], int(table.allt) & MASK)

        with _start_monitor(opts, stats, lambda: f"raw={raw_bound}/{cr} live={live_bound}/{cp}"):
            for chunk, slot, slots in chunks:
                if raw_bound + slots > cr:
                    consolidate()
                    raw_bound = 0
                with metrics.timer("dispatch"):
                    dev_reads, = feed.upload(slot)
                    count_step_two_level(table, dev_reads, k, opts.canonical)
                    feed.consumed()
                raw_bound += slots
                stats.chunks += 1
                _absorb(stats, chunk)

        if raw_bound:
            consolidate(final=True)
        # The raw region is merged: free it before the finalize's sort.
        table.raw_lanes = table.raw_lanes.new_empty((NL, 0))
        with metrics.timer("finalize"):
            # live_bound is exact: a consolidation set it, or the snapshot
            # did (finalize2 sorts those rows).
            return t2.finalize_host(table, k, live_bound, metrics=metrics)

    def _count_one_level(self, chunks, feed, line_length, reads_per_chunk, table_slots, stats, metrics, resumed,
                         per_chunk):
        """The one-level chunk loop (counterpart of
        ``CountEngine._run_one_level``); returns the finalized (lanes,
        counts) as ``_count_two_level`` does."""
        from kmer_counter_tpu_torch.ops import table as t1
        from kmer_counter_tpu_torch.ops.pipeline import extract_chunk

        opts = self.opts
        k = opts.kmer_length
        NL = records.active_lanes(k)
        if opts.verbose:
            print(
                f"[engine] k={k} canonical={opts.canonical} L={line_length} "
                f"reads/chunk={reads_per_chunk} table_slots={table_slots} "
                f"device={self.device}"
            )
        cap = bg.max_table_slots(opts, NL, per_chunk) if opts.temp_dir else None
        with metrics.timer("setup"):
            if resumed is not None:
                # The snapshot's rows and room for a chunk; where the table
                # would grow past the cap for them, they become a run first,
                # as at a consolidation.
                U = len(resumed.counts)
                rows = records.strip_lanes_to_active(resumed.lanes, k)
                slots = chunk_slots(reads_per_chunk, line_length, k)
                table_slots, spill = bg.next_capacity(cap, table_slots, U + slots)
                if spill:
                    self._spill(rows, resumed.counts, stats, metrics)
                    U = 0
                lanes = np.zeros((NL, table_slots), np.uint32)
                counts = np.zeros(table_slots, np.uint32)
                lanes[:, :U] = rows[:U].T
                counts[:U] = resumed.counts[:U]
                table = t1.CountTable(from_numpy(lanes, self.device), from_numpy(counts, self.device), U)
            else:
                table = t1.make_table(table_slots, NL, self.device)
        with _start_monitor(opts, stats, lambda: f"bound={table.offset}/{table.lanes.shape[1]}"):
            for chunk, slot, slots in chunks:
                capacity = table.lanes.shape[1]
                if table.offset + slots > capacity:
                    with metrics.timer("consolidate"):
                        table = t1.consolidate(table)
                    stats.consolidations += 1
                    if self._checkpoint_due(stats):
                        self._save_checkpoint(stats, table.lanes[:, : table.offset], table.counts[: table.offset])
                    if table.offset + slots > capacity:
                        grown, spill = bg.next_capacity(cap, capacity, table.offset + slots)
                        if spill:
                            n = table.offset
                            self._spill(to_numpy(table.lanes[:, :n]).T, to_numpy(table.counts[:n]), stats, metrics)
                            table.counts[:n] = 0
                            table.offset = 0
                            grown, _ = bg.next_capacity(None, capacity, slots)
                        if grown > capacity:
                            if opts.verbose:
                                print(f"[engine] growing table to {grown} slots")
                            table = t1.grow(table, grown)
                with metrics.timer("dispatch"):
                    dev_reads, = feed.upload(slot)
                    t1.append(table, *extract_chunk(dev_reads, k, opts.canonical))
                    feed.consumed()
                stats.chunks += 1
                _absorb(stats, chunk)

        with metrics.timer("finalize"):
            table = t1.consolidate(table)
            # The one-level table counts the all-T k-mer among its rows.
            return table.lanes[:, : table.offset], counts_to_host(table.counts, table.offset, metrics), 0


class MeshCountEngine(CountEngine):
    """The count engine over a mesh (counterpart of the JAX
    ``MeshCountEngine``): the chunk loop drives a ``ShardedCounter2``
    (two-level) or ``ShardedCounter`` (one-level) whose positions count
    their rows of each chunk, and the finalize merges the positions by key
    range (parallel.shuffle) in place of a host gather or a disk merge.

    ``mesh``: the positions (parallel.mesh.make_mesh); by default the first
    ``meshShape[0]`` visible cards (all when unset) of this process, and
    with several ranks the process group of torchrun's variables.  With
    several processes each reads its own files (round-robin by rank), every
    collective runs in lockstep, and each process writes the ranges of its
    positions as ``<outputFile>.partNNNNN`` files and a
    ``<outputFile>.manifest.<rank>.json``.
    """

    def __init__(self, opts: Options, device: torch.device | None = None, mesh=None):
        super().__init__(opts, mesh.local_devices[0] if mesh is not None else device)
        self.mesh = mesh if mesh is not None else make_mesh(
            opts.mesh_shape[0] if opts.mesh_shape else None, device_type=self.device.type)
        self._pos_runs = None  # several processes: the spill runs of each position
        self._route_cap = None  # the most rows a position receives a round of a route (spilling on)
        self.route_balance = None  # rows each position received at the finalize's route
        self.route_rounds = 0  # the most rounds a route of the run took (or would have taken)

    def _position_cap(self, counter, NL: int, line_length: int) -> int:
        """The most slots a position's prefix (two-level) or table
        (one-level) may take before it spills: the single-device cap
        (budget.py) of a position's chunk, with the route's step, under
        ``gpuMemoryLimit / D`` (or ``tableSlots / D``): the limit is the
        whole mesh's, as in the JAX package."""
        import dataclasses

        opts, D = self.opts, self.mesh.size
        per = dataclasses.replace(opts, memory_limit_bytes=max(opts.memory_limit_bytes // D, 1),
                                  table_slots=max(opts.table_slots // D, 1) if opts.table_slots else None)
        chunk = bg.Chunk(counter.reads_per_device * line_length, counter.chunk_slots)
        if isinstance(counter, ShardedCounter2):
            return bg.max_prefix_slots(per, NL, counter.CR, chunk, routed=True)
        return bg.max_table_slots(per, NL, chunk, routed=True)

    def _spill_counter(self, counter, stats: RunStats, metrics: Metrics):
        """Write the counter's consolidated state to disk as sorted runs
        (the counter empties it after).  One process: each position's
        table, a run over the whole key space, to the merge scheduler.
        Several: the records are routed to their owners first (every
        process reaches this point in lockstep: the trigger is
        host-mirrored), then each process writes a run per position it
        owns (a range that arrives in rounds, a run per round), and the end
        merges each range's runs into its part."""
        from kmer_counter_tpu_torch.io import spill as spill_io

        opts = self.opts
        with metrics.timer("spill"):
            if self.mesh.world > 1:
                if self._pos_runs is None:
                    self._pos_runs = {}
                os.makedirs(opts.temp_dir, exist_ok=True)
                for pos, lanes, counts in counter.route_live(self._route_cap):
                    stats.spilled_runs += 1
                    path = os.path.join(opts.temp_dir, f"spill_pos{pos:05d}_{stats.spilled_runs:06d}.run")
                    self._pos_runs.setdefault(pos, []).append(spill_io.write_run(path, lanes, counts))
                    if opts.verbose:
                        print(f"[engine] spilled range {pos}: {len(counts)} records -> {path}")
                return
            if self._scheduler is None:
                self._scheduler = self._merge_scheduler()
            for lanes, counts in counter.live_runs():
                stats.spilled_runs += 1
                path = os.path.join(opts.temp_dir, f"spill_{stats.spilled_runs:06d}.run")
                self._scheduler.add_run(spill_io.write_run(path, lanes, counts))
                if opts.verbose:
                    print(f"[engine] spilled {len(counts)} records -> {path}")

    def _save_mesh_checkpoint(self, counter, stats: RunStats):
        """Snapshot the mesh run (checkpoint.mesh_save) at a consolidation:
        this process's position tables, the reads absorbed, the per-file
        manifest, the frozen splitters and the outstanding spill runs."""
        from kmer_counter_tpu_torch import checkpoint as ckpt

        ckpt.mesh_save(
            self.opts.checkpoint_dir, self.opts, stats.consolidations, counter.export_positions(), stats.reads,
            stats.per_file, mesh_size=self.mesh.size, splitters=counter.splitters, pos_runs=self._pos_runs,
            scheduler_runs=self._scheduler.snapshot_runs() if self._scheduler is not None else None,
            process=self.mesh.rank, processes=self.mesh.world,
        )

    def _load_mesh_checkpoint(self, counter, stats: RunStats, cap, spill):
        """Resume from the newest complete mesh snapshot, agreed in
        lockstep (every process resumes the same epoch, or none does).
        Returns the MeshSnapshot or None."""
        import re
        import sys

        from kmer_counter_tpu_torch import checkpoint as ckpt

        opts, mesh = self.opts, self.mesh
        if not opts.checkpoint_dir:
            return None
        resumed = ckpt.mesh_load(opts.checkpoint_dir, opts, mesh.size, mesh.positions,
                                 process=mesh.rank, processes=mesh.world)
        epochs = allgather_host(mesh, np.array([resumed.epoch if resumed is not None else -1], np.int64))
        if epochs.min() != epochs.max():
            print("[checkpoint] processes disagree on the resume epoch — recounting from scratch",
                  file=sys.stderr)
            return None
        if resumed is None:
            return None
        stats.reads = resumed.reads_absorbed
        stats.per_file = dict(resumed.files or {})
        stats.consolidations = resumed.epoch
        if resumed.pos_runs:
            self._pos_runs = {int(p): list(v) for p, v in resumed.pos_runs.items()}
            # Run numbers restart past every existing file, so re-registered
            # runs (and orphans of the crashed run) are never overwritten.
            seqs = [0]
            if opts.temp_dir and os.path.isdir(opts.temp_dir):
                for name in os.listdir(opts.temp_dir):
                    m = re.search(r"_(\d+)\.run$", name)
                    if m:
                        seqs.append(int(m.group(1)))
            stats.spilled_runs = max(seqs)
        if resumed.scheduler_runs:
            self._resume_spill(resumed.scheduler_runs, stats)
        counter.import_positions(resumed.items, resumed.splitters, cap, spill)
        if opts.verbose:
            total = sum(len(c) for _, _, c, _ in resumed.items)
            print(f"[engine] resumed mesh checkpoint epoch {resumed.epoch}: {total} records (this process), "
                  f"{resumed.reads_absorbed} reads absorbed")
        return resumed

    def run(self) -> RunStats:
        opts = self.opts
        stats, metrics = RunStats(), Metrics()
        with metrics.timer("run"):
            counter = self._run(stats, metrics)
        stats.wall_seconds = metrics.timers["run"]
        for name, value in (("reads", stats.reads), ("chunks", stats.chunks),
                            ("distinct_kmers", stats.distinct_kmers),
                            ("position_consolidations", counter.position_consolidations if counter else 0),
                            ("unspanned_us", round(1e6 * metrics.uncovered("run")))):
            metrics.count(name, value)
        stats.metrics = metrics.snapshot()
        if opts.verbose:
            print(f"[metrics] {metrics.report()}")
            print(f"[engine] reads={stats.reads} distinct={stats.distinct_kmers} total={stats.total_kmers} "
                  f"wall={stats.wall_seconds:.2f}s ({stats.kmers_per_second/1e6:.2f}M kmers/s over "
                  f"{self.mesh.size} positions)")
        return stats

    def _run(self, stats: RunStats, metrics: Metrics):
        """The count over the mesh, from the input directory to the output
        (file or parts); returns the counter, or None for an input with no
        line of k bases."""
        opts, mesh = self.opts, self.mesh
        k = opts.kmer_length
        D, multi = mesh.size, mesh.world > 1

        with metrics.timer("setup"):
            source = _make_source(opts, shard=(mesh.rank, mesh.world) if multi else None)
            usable = [L for L in source.probe_line_lengths() if L >= k]
            if multi:
                # The chunk shape must agree on every process (each step is
                # collective): the largest usable line length of any.
                longest = global_max_int(mesh, max(usable, default=0))
                usable = [longest] if longest >= k else []
        if not usable:
            source.close()
            dump_table(opts.output_file, np.zeros((0, records.active_lanes(k)), np.uint32), np.zeros(0, np.uint32),
                       metrics=metrics)
            return None
        with metrics.timer("setup"):
            line_length = max(usable)
            reads_per_chunk, table_slots = plan_chunks(opts, line_length)
            rpd = max(reads_per_chunk // D, 1)
            NL = records.active_lanes(k)
            # Chunks from shorter files are padded with zero bytes, which
            # encode as invalid bases: one counter at the longest line length.
            per_pos_slots = max(table_slots // D, 4 * rpd * (line_length - k + 1))
            if opts.table_impl == "one":
                counter = ShardedCounter(mesh, k, opts.canonical, per_pos_slots, rpd, line_length)
            else:
                cp = max(per_pos_slots // 4, 1)
                counter = ShardedCounter2(mesh, k, opts.canonical, cp, max(per_pos_slots - cp, 1), rpd, line_length)
            if opts.verbose:
                print(f"[engine] mesh={D} positions ({len(mesh.positions)} in this process) k={k} "
                      f"canonical={opts.canonical} L={line_length} reads/position/chunk={rpd} "
                      f"slots/position={per_pos_slots} device={self.device}")
            cap = self._position_cap(counter, NL, line_length) if opts.temp_dir else None
            # A route gives a position at most as many rows a round as its
            # table may hold: budget.py reckons the route's step at that size.
            self._route_cap = cap

            def spill(c):
                self._spill_counter(c, stats, metrics)

            resumed = self._load_mesh_checkpoint(counter, stats, cap, spill)
            feed = self._feed(mesh.local_devices, rpd, line_length)

        def maybe_consolidate():
            # An explicit consolidation boundary (the counter would
            # otherwise consolidate inside step()), so that the engine can
            # spill and snapshot there.  Every trigger is host-mirrored, so
            # every process reaches the same decision.  The feed's device
            # buffer is freed first: a mesh step holds its chunk on the
            # card only while it runs, as before the feed.
            if not counter.pending_consolidation():
                return
            feed.release()
            with metrics.timer("consolidate"):
                counter.consolidate(cap, spill)
            stats.consolidations += 1
            if self._checkpoint_due(stats):
                with metrics.timer("checkpoint"):
                    self._save_mesh_checkpoint(counter, stats)

        with (_start_monitor(opts, stats, lambda: f"occupied/position={counter.occupied_bound()}"),
              contextlib.closing(self._chunks(source, feed, line_length, stats, metrics,
                                              resumed.reads_absorbed if resumed else 0,
                                              (resumed.files or None) if resumed else None)) as chunks):
            drained = False
            while True:
                chunk, slot, _ = (None, None, None) if drained else next(chunks, (None, None, None))
                drained = chunk is None
                # Lockstep: go on while any process still has data.
                if (drained if not multi else not global_any(mesh, not drained)):
                    break
                maybe_consolidate()
                with metrics.timer("dispatch"):
                    counter.step(feed.upload(slot) if slot is not None else feed.zeros())
                    feed.consumed()
                if chunk is not None:
                    stats.chunks += 1
                    _absorb(stats, chunk)
        feed.release()

        # The all-T side count (two-level, k % 16 == 0, forward): T^k is
        # the largest key, so its record is the last of the last range.
        allt = counter.allt_total() & MASK
        allt_lanes, allt_counts = _allt_record(NL, allt)
        with metrics.timer("consolidate"):
            counter.close(cap, spill)
        if not multi and self._scheduler is None and cap is not None and counter.route_rounds(cap) > 1:
            # The frozen splitters crowd one range past what a position may
            # receive: merge the positions' tables on the host instead.
            self._scheduler = self._merge_scheduler()
        if self._scheduler is not None:
            self._finish_spilled(counter, stats, metrics, allt, allt_lanes, allt_counts)
        elif multi:
            self._finish_parts(counter, stats, metrics, allt, allt_lanes, allt_counts)
        else:
            with metrics.timer("route"):
                lanes, counts = counter.finalize()
            if allt:
                if lanes.shape[0] and np.array_equal(lanes[-1], allt_lanes[0]):
                    raise RuntimeError("all-T key present in the key stream despite the side counter: "
                                       "extract_chunk_keys contract violated")
                lanes, counts = np.concatenate([lanes, allt_lanes]), np.concatenate([counts, allt_counts])
            stats.distinct_kmers = len(counts)
            stats.total_kmers = int(counts.sum(dtype=np.uint64))
            dump_table(opts.output_file, lanes, counts, metrics=metrics)
        self.route_balance = None if counter.balance is None else counter.balance.tolist()
        self.route_rounds = counter.most_rounds
        return counter

    def _finish_spilled(self, counter, stats, metrics, allt, allt_lanes, allt_counts):
        """One process that spilled: the positions' tables join the runs and
        the host merge writes the sorted output; the all-T record last."""
        from kmer_counter_tpu_torch.io import spill as spill_io

        opts = self.opts
        for lanes, counts in counter.local_tables():
            stats.spilled_runs += 1
            path = os.path.join(opts.temp_dir, f"spill_{stats.spilled_runs:06d}.run")
            self._scheduler.add_run(spill_io.write_run(path, lanes, counts))
        with metrics.timer("merge"):
            written = self._scheduler.finish(opts.output_file)
        self._scheduler = None
        if allt:
            written += dump_table(opts.output_file, allt_lanes, allt_counts, append=True, metrics=metrics)
        stats.distinct_kmers = written
        _, counts_all = load_table(opts.output_file, opts.kmer_length)
        stats.total_kmers = int(counts_all.sum(dtype=np.uint64))

    def _finish_parts(self, counter, stats, metrics, allt, allt_lanes, allt_counts):
        """Several processes: each writes the ranges of its positions as
        part files (a range with spill runs, or that the route gave in
        rounds, is the host merge of its runs and its final pieces) and a
        manifest; the parts in name order are the globally sorted table."""
        import json

        from kmer_counter_tpu_torch.io import spill as spill_io

        opts, mesh = self.opts, self.mesh
        with metrics.timer("route"):
            pieces = {}
            for pos, lanes, counts in counter.finalize_local(self._route_cap):
                pieces.setdefault(pos, []).append((lanes, counts))
        written = total = 0
        for pos in mesh.positions:
            part = f"{opts.output_file}.part{pos:05d}"
            runs = (self._pos_runs or {}).get(pos, [])
            if runs or len(pieces[pos]) > 1:
                finals = []
                for q, (lanes, counts) in enumerate(pieces[pos]):
                    finals.append(spill_io.write_run(os.path.join(opts.temp_dir, f"final_pos{pos:05d}_{q:03d}.run"),
                                                     lanes, counts))
                with metrics.timer("merge"):
                    n = spill_io.merge_runs(runs + finals, part, opts.kmer_length)
                for p in runs + finals:
                    try:
                        os.remove(p)
                    except OSError:
                        pass
                total += int(load_table(part, opts.kmer_length)[1].sum(dtype=np.uint64))
            else:
                (lanes, counts), = pieces[pos]
                n = dump_table(part, lanes, counts, metrics=metrics)
                total += int(counts.sum(dtype=np.uint64))
            if allt and pos == mesh.size - 1:
                n += dump_table(part, allt_lanes, allt_counts, append=True, metrics=metrics)
                total += allt
            written += n
        with open(f"{opts.output_file}.manifest.{mesh.rank}.json", "w") as fh:
            json.dump({"process": mesh.rank, "processes": mesh.world, "records": written,
                       "assembly": "cat output.part* (name order) -> sorted table"}, fh)
        stats.distinct_kmers = written
        stats.total_kmers = total


def _mesh_wanted(opts: Options, device: torch.device) -> bool:
    """The JAX dispatch: the mesh engine for ``meshShape``, more than one
    visible card, or more than one rank."""
    cards = torch.cuda.device_count() if device.type == "cuda" and torch.cuda.is_available() else 1
    return opts.mesh_shape is not None or cards > 1 or int(os.environ.get("WORLD_SIZE", "1")) > 1


def run_count(opts: Options, device: torch.device | None = None, mesh=None) -> RunStats:
    """Run the count on ``device`` (default: cuda): the mesh engine when
    ``mesh`` is given or ``_mesh_wanted``, the single-device engine
    otherwise.

    With ``profile=true`` the run is traced by torch.profiler, the trace
    written next to the output file (``<outputFile>.trace/trace.json``).
    """
    device = torch.device("cuda") if device is None else torch.device(device)
    if mesh is not None or _mesh_wanted(opts, device):
        engine = MeshCountEngine(opts, device, mesh)
    else:
        engine = CountEngine(opts, device)
    trace_dir = opts.output_file + ".trace" if opts.profile else None
    with device_trace(trace_dir, engine.device):
        return engine.run()
