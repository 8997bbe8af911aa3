"""Orchestrator: the chunked count loop over a FASTQ directory —
counterpart of kmer_counter_tpu.engine (single device).

A prefetch thread parses chunks (io.fastq) while the main thread enqueues
each chunk's extract + append on the device.  Two tables:

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

Not ported yet (raises NotImplementedError): the multi-device mesh engine
(``meshShape`` or more than one rank).
"""

from __future__ import annotations

import os
import queue
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from kmer_counter_tpu_torch import records
from kmer_counter_tpu_torch import budget as bg
from kmer_counter_tpu_torch.config import Options
from kmer_counter_tpu_torch.io.dump import dump_table, load_table
from kmer_counter_tpu_torch.io.fastq import DirectoryInput, ParallelIngest
from kmer_counter_tpu_torch.metrics import Metrics, device_trace
from kmer_counter_tpu_torch.ops.pipeline import chunk_slots
from kmer_counter_tpu_torch.ops.u32 import MASK, SENTINEL, from_numpy, to_numpy

_END = object()


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to kmer_counter_tpu_torch yet "
        "(the JAX package kmer_counter_tpu has it)"
    )


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
    ingest_seconds: float = 0.0
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


def _make_source(opts: Options):
    """The order-preserving parser pool when ingestThreads > 1, else the
    sequential reader; both give the same chunk stream."""
    if opts.ingest_threads > 1:
        return ParallelIngest(opts.input_dir, threads=opts.ingest_threads)
    return DirectoryInput(opts.input_dir)


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


def _start_monitor(opts: Options, stats: RunStats, gauge_extra):
    """1 Hz size monitor under verbose >= 2; a no-op context otherwise."""
    import contextlib

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
        if opts.mesh_shape is not None or int(os.environ.get("WORLD_SIZE", "1")) > 1:
            raise _not_ported("the multi-device mesh engine (meshShape / several ranks)")
        device = torch.device("cuda") if device is None else torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not available")
        self.opts = opts
        self.device = device
        self._scheduler = None  # the spill-merge scheduler, once a run spills (io.spill)

    @staticmethod
    def _ingest_worker(source, reads_per_chunk, out_q, metrics, skip_reads=0, expected_files=None):
        """Prefetch thread: parse chunks ahead of the device.

        ``skip_reads`` reads are consumed and discarded first (checkpoint
        resume; ingest order is deterministic).  ``expected_files`` is the
        checkpoint's per-file absorbed-read manifest: the skip must consume
        exactly those counts, or the input changed since the snapshot and
        the resume would misalign (the error goes to the consumer)."""
        try:
            skipped: dict[str, int] = {}
            while skip_reads > 0:
                with metrics.timer("ingest"):
                    chunk = source.read_chunk(min(reads_per_chunk, skip_reads))
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
                    chunk = source.read_chunk(reads_per_chunk)
                if chunk is None:
                    break
                out_q.put(chunk)
        except Exception as e:  # handed to the consumer, which re-raises it
            out_q.put(e)
        finally:
            out_q.put(_END)

    def _chunks(self, source, reads_per_chunk, stats, metrics, skip_reads, expected_files):
        """The chunks that hold k-mers, as (chunk, reads ``[reads_per_chunk,
        L] uint8``, worst-case slots), parsed ahead by the prefetch thread.
        Chunks of reads shorter than k are absorbed here; the caller
        absorbs each chunk it yields once its step is enqueued."""
        k = self.opts.kmer_length
        chunk_q: queue.Queue = queue.Queue(maxsize=max(self.opts.prefetch_chunks, 1))
        ingest = threading.Thread(
            target=self._ingest_worker,
            args=(source, reads_per_chunk, chunk_q, metrics, skip_reads, expected_files),
            daemon=True,
        )
        ingest.start()
        while True:
            with metrics.timer("ingest_wait"):
                item = chunk_q.get()
            if item is _END:
                break
            if isinstance(item, Exception):
                raise item
            if item.line_length < k:
                _absorb(stats, item)
                continue
            reads = item.reads
            if reads.shape[0] < reads_per_chunk:
                pad = np.zeros((reads_per_chunk - reads.shape[0], reads.shape[1]), np.uint8)
                reads = np.vstack([reads, pad])
            yield item, reads, chunk_slots(reads_per_chunk, item.line_length, k)
        ingest.join()
        source.close()

    def run(self) -> RunStats:
        opts = self.opts
        k = opts.kmer_length
        stats = RunStats()
        metrics = Metrics()
        t_start = time.perf_counter()

        source = _make_source(opts)
        usable = [L for L in source.probe_line_lengths() if L >= k]
        if not usable:
            dump_table(
                opts.output_file,
                np.zeros((0, records.active_lanes(k)), np.uint32),
                np.zeros(0, np.uint32),
            )
            stats.wall_seconds = time.perf_counter() - t_start
            return stats
        line_length = max(usable)
        reads_per_chunk, table_slots = plan_chunks(opts, line_length)
        resumed = self._resume(stats) if opts.checkpoint_dir else None
        # With spilling on, what a chunk puts on the card sizes the caps.
        per_chunk = None
        if opts.temp_dir:
            per_chunk = bg.Chunk(reads_per_chunk * line_length, chunk_slots(reads_per_chunk, line_length, k))
        chunks = self._chunks(source, reads_per_chunk, stats, metrics,
                              resumed.reads_absorbed if resumed else 0, resumed.files if resumed else None)
        count = self._count_one_level if opts.table_impl == "one" else self._count_two_level
        lanes_np, counts_np = count(chunks, line_length, reads_per_chunk, table_slots, stats, metrics,
                                    resumed, per_chunk)
        stats.consolidations += 1  # the finalize's
        if self._scheduler is not None:
            # The final table joins the spill runs; the host merge writes
            # the sorted output.
            from kmer_counter_tpu_torch.io import spill as spill_io

            stats.spilled_runs += 1
            self._scheduler.add_run(
                spill_io.write_run(os.path.join(opts.temp_dir, "final_table.run"), lanes_np, counts_np)
            )
            with metrics.timer("merge"):
                stats.distinct_kmers = self._scheduler.finish(opts.output_file)
            self._scheduler = None
            _, counts_all = load_table(opts.output_file, k)
            stats.total_kmers = int(counts_all.sum(dtype=np.uint64))
        else:
            stats.distinct_kmers = len(counts_np)
            stats.total_kmers = int(counts_np.sum(dtype=np.uint64))
            dump_table(opts.output_file, lanes_np, counts_np)
        stats.wall_seconds = time.perf_counter() - t_start
        stats.ingest_seconds = metrics.timers.get("ingest", 0.0)
        for name, value in (
            ("reads", stats.reads),
            ("chunks", stats.chunks),
            ("consolidations", stats.consolidations),
            ("distinct_kmers", stats.distinct_kmers),
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

    def _count_two_level(self, chunks, line_length, reads_per_chunk, table_slots, stats, metrics, resumed,
                         per_chunk):
        """The two-level chunk loop (counterpart of
        ``CountEngine._run_two_level``); returns the finalized (lanes,
        counts) on the host."""
        from kmer_counter_tpu_torch.ops import table2 as t2
        from kmer_counter_tpu_torch.ops.pipeline import count_step_two_level

        opts = self.opts
        k = opts.kmer_length
        NL = records.active_lanes(k)
        # 1:7 prefix:raw split, as in the JAX engine: more chunks per
        # consolidation; the prefix grows on demand.
        cp = max(table_slots // 8, 1)
        cr = max(table_slots - cp, chunk_slots(reads_per_chunk, line_length, k))
        cap = bg.max_prefix_slots(opts, NL, cr, per_chunk) if per_chunk else None
        if opts.verbose:
            print(
                f"[engine] two-level k={k} canonical={opts.canonical} "
                f"L={line_length} reads/chunk={reads_per_chunk} "
                f"prefix={cp} raw={cr} device={self.device}"
            )
        live_bound = 0  # prefix rows in use (exact after a consolidation)
        raw_bound = 0  # raw slots in use (host mirror of table.raw_off)
        if resumed is not None:
            # The snapshot's rows, unique and ascending, then sentinel rows
            # with count 0, so the prefix stays ascending as K1 requires.
            # Rows that pass the cap (a snapshot written under another
            # rule) become a run, as at a consolidation.
            rows = records.strip_lanes_to_active(resumed.lanes, k)
            cp, spill = bg.next_prefix(cap, cp, len(resumed.counts), 0)
            if spill:
                self._spill(rows, resumed.counts, stats, metrics)
            else:
                live_bound = len(resumed.counts)
            prefix_lanes = np.full((NL, cp), 0xFFFFFFFF, np.uint32)
            prefix_counts = np.zeros(cp, np.uint32)
            prefix_lanes[:, :live_bound] = rows[:live_bound].T
            prefix_counts[:live_bound] = resumed.counts[:live_bound]
            table = t2.table_from_numpy(prefix_lanes, prefix_counts, np.zeros((NL, cr), np.uint32), 0,
                                        resumed.allt, self.device)
        else:
            table = t2.make_table2(cp, cr, NL, self.device)

        def consolidate(final=False):
            # The prefix is sized before the merge so that it can never
            # truncate; where growing it would pass the cap, its live
            # rows spill first (budget.next_prefix).  ``table`` is rebound
            # here, not passed in, so the old buffers are freed before the
            # kernel runs.  The all-T side count stays in the table and is
            # written once, at the end.
            nonlocal table, cp, live_bound
            new_cp, spill = bg.next_prefix(cap, cp, live_bound, raw_bound)
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
                table, live_bound, lost = t2.consolidate3(table)
            if lost:
                raise RuntimeError(
                    f"consolidation truncated {lost} live records: "
                    "prefix pre-grow invariant violated"
                )
            if final:
                return  # counted by run() as the finalize's
            stats.consolidations += 1
            if self._checkpoint_due(stats):
                self._save_checkpoint(stats, table.prefix_lanes[:, :live_bound],
                                      table.prefix_counts[:live_bound], int(table.allt) & MASK)

        with _start_monitor(opts, stats, lambda: f"raw={raw_bound}/{cr} live={live_bound}/{cp}"):
            for chunk, reads, slots in chunks:
                if raw_bound + slots > cr:
                    consolidate()
                    raw_bound = 0
                with metrics.timer("dispatch"):
                    dev_reads = torch.from_numpy(reads).to(self.device)
                    count_step_two_level(table, dev_reads, k, opts.canonical)
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
            return t2.finalize_host(table, k, live_bound)

    def _count_one_level(self, chunks, line_length, reads_per_chunk, table_slots, stats, metrics, resumed,
                         per_chunk):
        """The one-level chunk loop (counterpart of
        ``CountEngine._run_one_level``); returns the finalized (lanes,
        counts) on the host."""
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
        cap = bg.max_table_slots(opts, NL, per_chunk) if per_chunk else None
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
            for chunk, reads, slots in chunks:
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
                    dev_reads = torch.from_numpy(reads).to(self.device)
                    t1.append(table, *extract_chunk(dev_reads, k, opts.canonical))
                stats.chunks += 1
                _absorb(stats, chunk)

        with metrics.timer("finalize"):
            table = t1.consolidate(table)
            n = table.offset
            lanes = np.ascontiguousarray(to_numpy(table.lanes[:, :n]).T)
            return lanes, to_numpy(table.counts[:n])


def run_count(opts: Options, device: torch.device | None = None) -> RunStats:
    """Run the single-device engine on ``device`` (default: cuda).

    With ``profile=true`` the run is traced by torch.profiler, the trace
    written next to the output file (``<outputFile>.trace/trace.json``).
    """
    engine = CountEngine(opts, device)
    trace_dir = opts.output_file + ".trace" if opts.profile else None
    with device_trace(trace_dir, engine.device):
        return engine.run()
