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

Not ported yet (each raises NotImplementedError): the multi-device mesh
engine (``meshShape`` or more than one rank), checkpoints,
``profile=true``, and spilling to disk.
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
from kmer_counter_tpu_torch.config import Options
from kmer_counter_tpu_torch.io.dump import dump_table
from kmer_counter_tpu_torch.io.fastq import DirectoryInput, ParallelIngest
from kmer_counter_tpu_torch.metrics import Metrics
from kmer_counter_tpu_torch.ops.pipeline import chunk_slots
from kmer_counter_tpu_torch.ops.u32 import to_numpy

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
    return os.path.basename(path) if path else ""


def _start_monitor(opts: Options, stats: RunStats, gauge_extra):
    """1 Hz size monitor under verbose >= 2; a no-op context otherwise."""
    import contextlib

    if opts.verbose < 2:
        return contextlib.nullcontext()
    from kmer_counter_tpu_torch.metrics import SizeMonitor

    return SizeMonitor(
        lambda: f"reads={stats.reads} chunks={stats.chunks} "
        f"consolidations={stats.consolidations} {gauge_extra()}"
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
        if opts.checkpoint_dir:
            raise _not_ported("checkpointing (checkpointDir)")
        if opts.profile:
            raise _not_ported("profile=true")
        device = torch.device("cuda") if device is None else torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not available")
        self.opts = opts
        self.device = device

    @staticmethod
    def _ingest_worker(source, reads_per_chunk, out_q, metrics):
        """Prefetch thread: parse chunks ahead of the device."""
        try:
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

    def _chunks(self, source, reads_per_chunk, stats, metrics):
        """The chunks that hold k-mers, as (reads ``[reads_per_chunk, L]
        uint8``, worst-case slots), parsed ahead by the prefetch thread.
        Every chunk's reads and bases are counted into ``stats``."""
        k = self.opts.kmer_length
        chunk_q: queue.Queue = queue.Queue(maxsize=max(self.opts.prefetch_chunks, 1))
        ingest = threading.Thread(
            target=self._ingest_worker,
            args=(source, reads_per_chunk, chunk_q, metrics),
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
            name = _file_key(item.path)
            stats.reads += item.n_reads
            stats.bases += item.n_reads * item.line_length
            stats.per_file[name] = stats.per_file.get(name, 0) + item.n_reads
            if item.line_length < k:
                continue
            reads = item.reads
            if reads.shape[0] < reads_per_chunk:
                pad = np.zeros((reads_per_chunk - reads.shape[0], reads.shape[1]), np.uint8)
                reads = np.vstack([reads, pad])
            yield reads, chunk_slots(reads_per_chunk, item.line_length, k)
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
        chunks = self._chunks(source, reads_per_chunk, stats, metrics)
        count = self._count_one_level if opts.table_impl == "one" else self._count_two_level
        lanes_np, counts_np = count(chunks, line_length, reads_per_chunk, table_slots, stats, metrics)
        stats.consolidations += 1  # the finalize's
        stats.distinct_kmers = len(counts_np)
        stats.total_kmers = int(counts_np.sum(dtype=np.uint64))
        dump_table(opts.output_file, lanes_np, counts_np)
        stats.wall_seconds = time.perf_counter() - t_start
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

    def _count_two_level(self, chunks, line_length, reads_per_chunk, table_slots, stats, metrics):
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
        if opts.verbose:
            print(
                f"[engine] two-level k={k} canonical={opts.canonical} "
                f"L={line_length} reads/chunk={reads_per_chunk} "
                f"prefix={cp} raw={cr} device={self.device}"
            )
        table = t2.make_table2(cp, cr, NL, self.device)
        live_bound = 0  # prefix rows in use (exact after a consolidation)
        raw_bound = 0  # raw slots in use (host mirror of table.raw_off)

        def consolidate():
            # Pre-grow: live + raw bounds the distinct keys a consolidation
            # can produce, so growing to it first makes truncation
            # impossible.  Geometric, so a cardinality-growing run sees
            # O(log) reallocations.  ``table`` is rebound here, not passed
            # in, so the pre-grow buffers are freed before the kernel runs.
            nonlocal table, cp, live_bound
            if live_bound + raw_bound > cp:
                cp = max(live_bound + raw_bound, 2 * cp)
                if opts.verbose:
                    print(f"[engine] growing prefix to {cp} slots")
                table = t2.grow2(table, cp, cr)
            with metrics.timer("consolidate"):
                table, live_bound, lost = t2.consolidate3(table)
            if lost:
                raise RuntimeError(
                    f"consolidation truncated {lost} live records: "
                    "prefix pre-grow invariant violated"
                )
            stats.consolidations += 1
            if opts.temp_dir and cp + cr > self._max_table_slots(NL):
                raise _not_ported("spilling to disk (tempFileLocation)")

        with _start_monitor(opts, stats, lambda: f"raw={raw_bound}/{cr} live={live_bound}/{cp}"):
            for reads, slots in chunks:
                if raw_bound + slots > cr:
                    consolidate()
                    raw_bound = 0
                with metrics.timer("dispatch"):
                    dev_reads = torch.from_numpy(reads).to(self.device)
                    count_step_two_level(table, dev_reads, k, opts.canonical)
                raw_bound += slots
                stats.chunks += 1

        if live_bound + raw_bound > cp:
            table = t2.grow2(table, live_bound + raw_bound, cr)
        with metrics.timer("finalize"):
            # live_bound is exact here: a consolidation set it, and a merge
            # of a non-empty raw region inside finalize_host replaces it.
            return t2.finalize_host(table, k, live_bound)

    def _count_one_level(self, chunks, line_length, reads_per_chunk, table_slots, stats, metrics):
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
        table = t1.make_table(table_slots, NL, self.device)
        with _start_monitor(opts, stats, lambda: f"bound={table.offset}/{table.lanes.shape[1]}"):
            for reads, slots in chunks:
                if table.offset + slots > table.lanes.shape[1]:
                    with metrics.timer("consolidate"):
                        table = t1.consolidate(table)
                    stats.consolidations += 1
                    if table.offset + slots > table.lanes.shape[1]:
                        if opts.temp_dir and 2 * table.lanes.shape[1] > self._max_table_slots(NL):
                            raise _not_ported("spilling to disk (tempFileLocation)")
                        table = self._grow_for(table, table.offset + slots)
                with metrics.timer("dispatch"):
                    dev_reads = torch.from_numpy(reads).to(self.device)
                    t1.append(table, *extract_chunk(dev_reads, k, opts.canonical))
                stats.chunks += 1

        with metrics.timer("finalize"):
            table = t1.consolidate(table)
            n = table.offset
            lanes = np.ascontiguousarray(to_numpy(table.lanes[:, :n]).T)
            return lanes, to_numpy(table.counts[:n])

    def _grow_for(self, table, needed_slots: int):
        """Double the one-level table's capacity until ``needed_slots``
        fit (cardinality outgrew the planned table)."""
        from kmer_counter_tpu_torch.ops import table as t1

        cap = table.lanes.shape[1]
        while cap < needed_slots:
            cap *= 2
        if self.opts.verbose:
            print(f"[engine] growing table to {cap} slots")
        return t1.grow(table, cap)

    def _max_table_slots(self, NL: int) -> int:
        """The table size past which the JAX engine spills to disk."""
        if self.opts.table_slots:
            return 2 * self.opts.table_slots
        return 4 * max(self.opts.memory_limit_bytes // 2 // ((NL + 1) * 4 * 3), 1 << 14)


def run_count(opts: Options, device: torch.device | None = None) -> RunStats:
    """Run the single-device engine on ``device`` (default: cuda)."""
    return CountEngine(opts, device).run()
