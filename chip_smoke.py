#!/usr/bin/env python3
"""Smoke run of the PyTorch port (kmer_counter_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout; needs CUDA and nvcc
    python3 chip_smoke.py --profile  # the main-path runs, timed and traced instead

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

  1. device   — card name and power limit (nvidia-smi), torch / CUDA versions
  2. build    — nvcc builds every kernel from csrc/, one process per
                source, all started together (six sources); logs each
                kernel instance's registers and spill bytes
  3. main     — the CLI (kmer_counter_tpu_torch.__main__.main) counts 2M
                reads x 100 bp sampled from a 4.6-Mbase genome at k=31
                canonical, gpuMemoryLimit=8e9, with the two-level table;
                the launch counts of K1 (merge_fold_compact), of the sort
                (lane_sort, at finalize) and of K8 (fused_extract, the
                chunk step: once a chunk on every path, once a position a
                chunk on the mesh paths, from the run's own chunk count)
                and of R1 (record_pack, the dump's records packed on the
                card: once in each main path) in
                that run and their launch shapes (for K1 and the merges
                also the live rows of A and B and B's live rows with the
                sentinel key, for K1 and K2 the output width, the prefix's
                CP columns; for K8 R, L, k, canonical and its mode, keys
                or records; for R1 NL, the rows and the kept rows); the dump is
                byte-identical to an independent NumPy count; the run's
                peak device memory is at most gpuMemoryLimit (so in every
                main path)
  4. main_one — the same count with tableImpl=one: every consolidation is a
                sort_reduce through the sort kernel; its launch count and
                shapes; the dump is byte-identical to the same NumPy count
  5. main_variants — the two-level count three more times, with
                table2.consolidate3 bound to each split variant (its
                keywords): each consolidation runs the variant's merge
                kernel (K3 merge_sorted_runs_fold_bitonic or K4
                merge_sorted_runs_fold, both on K1's one-pass fold_kernel,
                or K5 merge_sorted_runs on its split and write passes) and
                the compaction K2 (compact_live), and K1 never; launches
                (the merge and K2 at least twice each, K1 none, R1 once), launch
                shapes, peak device memory (at most gpuMemoryLimit); each
                dump byte-identical to the NumPy count
  6. spill    — the CLI counts 2M reads x 100 bp sampled from a 200-Mbase
                genome (about 10^8 distinct k-mers) at k=31 canonical under
                gpuMemoryLimit=2e9 with tempFileLocation set
                (noOfMergersAtOnce=2, noOfMergeThreads=2), once with each
                table ("spill", "spill_one"): at least two runs spilled
                before the final one, the launches (K1 and the sort; the
                sort), each run's peak device memory at most 2e9, the dump
                byte-identical to the NumPy count; logs each run file
                (records, bytes), each host merge (the native one: the
                phase raises if native/libkmer_io.so is not built) and the
                timers.  The phase's reads are its own (the input line
                names them)
  7. resume   — each spill run again with checkpointDir and
                checkpointEvery=1; a wrapper stops it right after the
                snapshot of the first consolidation that follows a spill
                (one-level: right after the spill that follows that
                snapshot, whose rows it holds), and a second run with the same checkpointDir and
                tempFileLocation resumes it ("resume", "resume_one"). From
                the second run itself: the reads it counted are all but
                the snapshot's, it takes fewer chunks than the run without
                resume, its merges read every run the snapshot lists, the
                runs it writes are numbered after them, and (one-level) its
                first run is the snapshot's rows, which would pass the cap
                in a table with room for a chunk; its peak device memory is
                at most 2e9 and its dump byte-identical to the NumPy count
  8. kernel   — each kernel against its plain torch version on the card:
                K1, K2, K3, K4, K8 and R1 bit-exact (R1 at NL = 1..8,
                ragged sizes, dense and sparse counts, lanes sliced from a
                wider table; K8 in both modes at k =
                1..128 x canonical x four read lengths, on reads longer
                than its tile, and at the edge cases of
                tests/test_torch_cuda.py: lower case, N, zero-padded rows,
                all-T reads, a write at a raw_off into a wider region,
                R = 1, R one past the tile, misaligned reads), and the
                sort and K5 with bit-exact keys and the same payloads under each key, at
                NL = 1, 2, 4, 7 and about 8M rows (K1, K3 and the sort also
                32M), at the edge cases of tests/test_torch_cuda.py (the
                merges also at the K1/K3 kernel's tile, the sort's also on
                lanes sliced from a wider table, K2's also on rows a word
                past a 16-byte boundary) and at each launch shape of phases
                3-7 and 12-15, on operands shaped as that path gives them
                (the prefix's live rows and the raw region's liveness as the
                path had them; K1 and the merges of phases 3-7 also on
                operands of the same size with an 80%-live prefix, as
                earlier runs timed them;
                the sort with sort_reduce's outputs equal too); CUDA-event
                times of kernel, plain version and, where one PyTorch call
                computes the same function, that call; the device time and
                launches of each CUDA kernel in one traced call (the sort's
                merge passes are its merge kernel's launches there); the
                least time the card could take (the bound) per shape:
                bytes that these operands need (the folding merges read
                only the rows that are not the sentinel; K1 and K2 write
                their output's width, the prefix's columns on the main
                paths) and operations
  9. mid_one  — a one-level run at k=55 forward (4 key lanes): 100k reads x
                150 bp, several consolidations; byte-identical to NumPy
 10. small    — CLI runs at k=15, 16 (all-T reads), 55 and 101 (canonical)
                with each table, and with the two-level table under each
                split variant, and a small tableSlots that forces growth;
                each dump byte-identical to the NumPy count
 11. profile  — (last, after every count of the process) a small two-level
                CLI run with profile=true: its torch.profiler trace
                (<outputFile>.trace/trace.json) names fold_kernel,
                leaf_kernel and extract_kernel (extract_kernel's launches
                logged beside the chunks); the dump equals the NumPy count
 12. mesh     — (after phase 5) the main count through engine.run_count on a
                mesh of 4 positions that share the card, with each table
                ("mesh", "mesh_one"): the dump byte-identical to phase 3's
                NumPy count, peak device memory at most gpuMemoryLimit, K1
                launched once for each consolidation of each position
                (two-level), the sort once for each (one-level) and once
                for each position the route gave rows; logs the rows each
                position received (the splitters' balance), the route's
                seconds and the device memory it added beside budget.py's
                reckoning
 13. mesh_mp  — the same count in two processes that share the card over a
                gloo process group (NCCL takes one rank a device), each
                owning 2 positions (this script again, as
                `chip_smoke.py --mesh-worker RANK 2 STORE RUNS_JSON`), with
                each table ("mesh_mp", "mesh_mp_one"; one launch of the
                ranks runs both in turn): 4 part files and 2
                manifests, the parts in name order byte-identical to the
                NumPy count, each rank's launches checked, the ranks' peaks
                together at most gpuMemoryLimit
 14. mesh_spill — (after phase 7) the spill count on 4 positions at
                gpuMemoryLimit=2e9, two-level, with noOfMergersAtOnce=4 and
                noOfMergeThreads=4 (4 runs a spill, and half the merge
                passes of phase 6's setting): at least two runs a position
                spilled mid-run, the host merge, peak at most 2e9, the dump
                byte-identical to phase 6's NumPy count
 15. mesh_resume — the same with a snapshot at every consolidation, stopped
                after the first that lists a run, then resumed (no more
                snapshots): the reads it skipped are the snapshot's, its
                merges read the runs the snapshot lists, its runs are
                numbered after them; the same dump, peak at most 2e9
 16. probes   — (after phase 8) D1-D7, the Mosaic probes under docs/: the
                three ported probe harnesses' main() on the card
                (kmer_counter_tpu_torch/probes/: experiments_mosaic_caps,
                experiments_bitonic_merge, probe_compact_overhead; each
                checks its results against the probe's NumPy test), traced,
                with the launch counts set to 0 just before each and read
                just after: each probe kernel's launches by its wrapper's
                count, by the calls recorded under each D-id and in the
                trace must agree; each D-id at each launch shape of its
                harness, kernel against plain (bit-exact) and against the
                probe's NumPy check, timed (CUDA events, plain version,
                library call, traced device time, bound; row_gather also
                each call's time by CUDA events); each kernel against its
                plain version at the edge cases and random shapes of
                tests/test_torch_cuda.py, and row_gather and tile_compact
                inside torch.cuda.stream(side) (their results, after
                side.synchronize(), equal the plain versions')
 17. feed     — (after phase 15, before phase 8: the process's first
                trace, after the counting phases 3-7 and 12-15; see
                TRACE_MARGIN) the two-level main count once more, traced
                by torch.profiler (its Chrome trace read back): the chunk
                feed (kmer_counter_tpu_torch/feed.py) made exactly one
                pinned host-to-device copy of the chunk's bytes a chunk,
                every one on a stream that ran no K8 launch, and no
                pageable host-to-device copy of a chunk's size; logs the
                engine's timers (dispatch, stage, ingest, ingest_wait), each
                kind of copy, the H2D device time and the device's busy
                share; the dump byte-identical to the NumPy count, the peak
                device memory at most gpuMemoryLimit

The last three lines: the card's name and power limit, one JSON object
describing each kernel (its launches and times summed over phases 3-7
and 12-15, D1-D7's over their harnesses (phase 16),
under "paths" each phase's or harness's own, and under "device_kernels"
its CUDA kernels' traced device time and launches at its largest launch
shape), and {"ok": true, "device": {...}}.

With --profile, phases 1 and 2 are followed by, for each table: three
untraced runs of the main count (wall, engine timers, peak device memory
of each), one that takes the peak device memory of each table stage, and
one under torch.profiler: the device's busy share of that run, its
host-to-device copies (count and device ms, the chunk feed's among them),
its device time per kernel and copy, largest first, the sort's two kernels
(leaf and merge pass) apart, with the sort's share of the busy time,
K1's two kernels (merge pass and fill) with their launches, and K8's
kernel (the chunk step) with its launches.

The reads, the FASTQ files and the reference counts are made here with
NumPy; nothing of the JAX package is imported.
"""

import functools
import json
import os
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
PALLAS = "kmer_counter_tpu/ops/pallas_sort.py"
MFC_CU = "kmer_counter_tpu_torch/csrc/merge_fold_compact.cu"
# Each kernel's entry of the kernels line; "cuda_kernels" names the CUDA
# kernels its wrapper launches.
K1 = dict(name="merge_fold_compact", route="cuda", source=MFC_CU, replaces=f"{PALLAS}:781",
          cuda_kernels="fold_kernel + fill_kernel")
# K6 (leaf_sort, :204) + K7 (_merge_pass, :313) as one sort.
SORT = dict(
    name="lane_sort",
    route="cuda",
    source="kmer_counter_tpu_torch/csrc/lane_sort.cu",
    replaces=f"{PALLAS}:204",
    replaces_also=f"{PALLAS}:313",
    cuda_kernels="leaf_kernel + merge_kernel",
)
# Kernel names of the sort's two kernels and of K1's two (the one-pass
# merge and its fill; K2's fill kernel is no template) in a profiler trace.
SORT_KERNEL_NAMES = ("leaf_kernel<", "merge_kernel<")
K1_KERNEL_NAMES = ("fold_kernel<", "fill_kernel<")
K2 = dict(name="compact_live", route="cuda", source="kmer_counter_tpu_torch/csrc/compact_live.cu",
          replaces=f"{PALLAS}:1573", cuda_kernels="compact_kernel + fill_kernel")
# K3, K4, K5: in K1's source (K3 and K4 run K1's one-pass fold_kernel, B
# stored descending for K3 and ascending for K4; K5 the split and write
# passes); named as in ops.merge_runs.
MERGES = {
    "merge_sorted_runs_fold_bitonic": dict(name="merge_sorted_runs_fold_bitonic", route="cuda",
                                           source=MFC_CU, replaces=f"{PALLAS}:1271",
                                           cuda_kernels="fold_kernel"),
    "merge_sorted_runs_fold": dict(name="merge_sorted_runs_fold", route="cuda", source=MFC_CU,
                                   replaces=f"{PALLAS}:1105", cuda_kernels="fold_kernel"),
    "merge_sorted_runs": dict(name="merge_sorted_runs", route="cuda", source=MFC_CU,
                              replaces=f"{PALLAS}:1804", cuda_kernels="splits_kernel + write_kernel"),
}
# K8: the chunk step's fused encode + extract, a Pallas kernel under docs/.
K8 = dict(name="fused_extract", route="cuda", source="kmer_counter_tpu_torch/csrc/fused_extract.cu",
          replaces="docs/experiments_pallas_extract.py:132", cuda_kernels="extract_kernel")
K8_KERNEL_NAME = "extract_kernel<"
# R1: the dump's records packed on the card.  It replaces no TPU kernel:
# the JAX package formats the dump on the host (kmer_counter_tpu/io/dump.py).
R1 = dict(name="record_pack", route="cuda", source="kmer_counter_tpu_torch/csrc/records.cu", replaces=None,
          cuda_kernels="record_count_kernel + record_scan_kernel + record_pack_kernel")
KERNEL_NAMES = (K1["name"], SORT["name"], K2["name"], *MERGES, K8["name"], R1["name"])
# D1-D7: the Mosaic probes under docs/, three CUDA kernels in one source
# behind ops.probes' three wrappers; the ported probe scripts
# (kmer_counter_tpu_torch/probes/) are the paths that launch them.
# "library_call" says what library_ms times.
PROBES_CU = "kmer_counter_tpu_torch/csrc/probes.cu"
PROBE_HARNESSES = ("experiments_mosaic_caps", "experiments_bitonic_merge", "probe_compact_overhead")
PROBE_WRAPPERS = ("pair_merge", "tile_compact", "row_gather")


def _probe(d, wrapper, replaces, library_call):
    return dict(name=f"{d}_{wrapper}", route="cuda", source=PROBES_CU, replaces=replaces,
                cuda_kernels=f"{wrapper}_kernel", wrapper=wrapper, library_call=library_call)


_SORT_CAT = "torch.sort of the widened concatenation"
PROBE_SPECS = {
    "D1": _probe("D1", "tile_compact", "docs/probe_compact_overhead.py:48",
                 "copy: Tensor.clone; cumsum: torch.cumsum of the dead flags a tile (the scan alone, no add); "
                 "network: ops[:, live != 0] (no per-tile placement, no zeros)"),
    "D2": _probe("D2", "pair_merge", "docs/experiments_bitonic_merge.py:52", _SORT_CAT),
    "D3": _probe("D3", "pair_merge", "docs/experiments_bitonic_merge.py:88", _SORT_CAT),
    "D4": _probe("D4", "row_gather", "docs/experiments_mosaic_caps.py:36", "torch.roll"),
    "D5": _probe("D5", "row_gather", "docs/experiments_mosaic_caps.py:55", "torch.roll"),
    "D6": _probe("D6", "row_gather", "docs/experiments_mosaic_caps.py:75", "Tensor.index_select"),
    "D7": _probe("D7", "pair_merge", "docs/experiments_mosaic_caps.py:196", _SORT_CAT),
}
MAIN_K, MAIN_L, MAIN_READS, MAIN_FILES, MAIN_GENOME = 31, 100, 2_000_000, 4, 4_600_000
MEMORY_LIMIT = 8_000_000_000
# The spill and resume phases: 2M reads x 100 bp from a 200-Mbase genome (about
# 10^8 distinct canonical 31-mers) under gpuMemoryLimit=2e9, the budget the
# configuration's docs give for a real card.
SPILL_READS, SPILL_GENOME, SPILL_LIMIT = 2_000_000, 200_000_000, 2_000_000_000
KERNEL_ROWS = (8 << 20, 32 << 20)  # the kernel phase's random operand sizes (K1, K3, the sort)
NEW_KERNEL_ROWS = 8 << 20  # the same for K2, K4, K5
# The merges that fold (their bound counts only the rows that are not the
# sentinel as read; K5's sentinel rows carry payloads).
FOLDING = ("merge_fold_compact", "merge_sorted_runs_fold_bitonic", "merge_sorted_runs_fold")
# The card's peaks for the bound (the least time the card could take): the
# H100 SXM data sheet's device-memory rate, and its float32 rate outside the
# tensor cores taken for 32-bit integer operations (both at a 700 W limit).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12


def log(obj):
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def require_checkout():
    for d in ("kmer_counter_tpu_torch", "tests"):
        if not os.path.isdir(os.path.join(HERE, d)):
            raise SystemExit(f"chip_smoke.py needs the repository beside it: {d}/ is missing")
    sys.path.insert(0, HERE)


def load_test_cases():
    """tests/test_torch_cuda.py, loaded by path: a site-packages package
    named ``tests`` would shadow the repository's tests/ directory."""
    import importlib.util

    path = os.path.join(HERE, "tests", "test_torch_cuda.py")
    spec = importlib.util.spec_from_file_location("kmer_torch_cuda_cases", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# ---- reads, FASTQ and the independent count (NumPy) -------------------------


def sample_reads(rng, genome_len, n_reads, read_len, invalid_frac, genome=None):
    """[n_reads, read_len] uint8 ASCII reads sampled uniformly from a random
    ACGT genome (or ``genome``, of genome_len bases), a fraction of bases
    replaced by 'N'."""
    import numpy as np

    if genome is None:
        genome = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=genome_len)
    starts = rng.integers(0, genome_len - read_len + 1, size=n_reads)
    reads = genome[starts[:, None] + np.arange(read_len)]
    reads[rng.random(reads.shape) < invalid_frac] = ord("N")
    return reads


def write_fastq(path, reads):
    """4-line FASTQ records ("@r", the read, "+", a quality of 'I's)."""
    import numpy as np

    R, L = reads.shape
    rec = np.empty((R, 2 * L + 7), np.uint8)
    rec[:, :3] = np.frombuffer(b"@r\n", np.uint8)
    rec[:, 3 : 3 + L] = reads
    rec[:, 3 + L : 6 + L] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, 6 + L : 6 + 2 * L] = ord("I")
    rec[:, -1] = ord("\n")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(rec.tobytes())


def numpy_count(reads, k, canonical, block=250_000):
    """Independent count of every k-mer window whose bases are all ACGT
    (either case): 2-bit codes A<C<G<T packed MSB-first into ceil(k/32)
    uint64 words per k-mer; canonical takes the lexicographic minimum of
    the k-mer and its reverse complement.  Blocks of reads are counted on
    every host core (NumPy releases the GIL in its loops and
    sorts), then their counts are summed key by key, a range of keys a
    thread.  Returns (words [U, W] uint64 ascending, counts [U] uint32)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    W = -(-k // 32)
    R, L = reads.shape
    P = L - k + 1
    lut = np.full(256, 255, np.uint8)
    for code, base in enumerate(b"ACGT"):
        lut[base] = lut[base + 32] = code

    def count_block(b0):
        raw = lut[reads[b0 : b0 + block]]
        valid = raw != 255
        c = np.where(valid, raw, 0).astype(np.uint64)
        fwd = np.zeros((W, len(c), P), np.uint64)
        rc = np.zeros_like(fwd) if canonical else None
        for i in range(k):
            win = c[:, i : i + P]
            fwd[i // 32] |= win << np.uint64(62 - 2 * (i % 32))
            if canonical:  # base i of the window is base k-1-i of its reverse complement
                j = k - 1 - i
                rc[j // 32] |= (np.uint64(3) - win) << np.uint64(62 - 2 * (j % 32))
        if canonical:
            take_rc = np.zeros(fwd.shape[1:], bool)
            decided = np.zeros_like(take_rc)
            for w in range(W):
                lt, gt = rc[w] < fwd[w], rc[w] > fwd[w]
                take_rc |= lt & ~decided
                decided |= lt | gt
            fwd = np.where(take_rc, rc, fwd)
        bad = np.concatenate([np.zeros((len(c), 1), np.int64), np.cumsum(~valid, axis=1)], 1)
        keys = fwd[:, bad[:, k : k + P] == bad[:, :P]].T
        keys, counts = sum_by_key(keys, np.ones(len(keys), np.uint64))
        # The block's keys cut into RANGES ranges of the first word's top
        # bits: ranges ascending in key order, each summed on its own.
        cuts = np.searchsorted(keys[:, 0], np.arange(1, RANGES, dtype=np.uint64) << np.uint64(64 - RANGE_BITS))
        return np.split(keys, cuts), np.split(counts, cuts)

    def sum_by_key(keys, counts):
        order = np.argsort(keys[:, 0], kind="stable") if W == 1 else np.lexsort(keys.T[::-1])
        keys, counts = keys[order], counts[order]
        head = np.ones(len(keys), bool)
        head[1:] = (keys[1:] != keys[:-1]).any(axis=1)
        starts = np.flatnonzero(head)
        return keys[starts], np.add.reduceat(counts, starts) if len(starts) else counts[:0]

    RANGE_BITS = 4
    RANGES = 1 << RANGE_BITS
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        blocks = list(pool.map(count_block, range(0, R, block)))
        ranges = list(pool.map(lambda r: sum_by_key(np.concatenate([b[0][r] for b in blocks]),
                                                    np.concatenate([b[1][r] for b in blocks])), range(RANGES)))
    del blocks
    return np.concatenate([r[0] for r in ranges]), np.concatenate([r[1] for r in ranges]).astype(np.uint32)


def dump_bytes(words, counts):
    """The record format of the dump: each key's words (uint64 LE), then
    its count (uint32 LE)."""
    import numpy as np

    U, W = words.shape
    rec = np.empty((U, 8 * W + 4), np.uint8)
    rec[:, : 8 * W] = words.astype("<u8").view(np.uint8).reshape(U, 8 * W)
    rec[:, 8 * W :] = counts.astype("<u4").view(np.uint8).reshape(U, 4)
    return rec.tobytes()


def main_input(tmp):
    """Phases 3-4's reads, written as FASTQ files; returns (reads, argv):
    argv without the table choice, which each phase adds."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    reads = sample_reads(rng, MAIN_GENOME, MAIN_READS, MAIN_L, 0.001)
    in_dir = os.path.join(tmp, "main_in")
    per = MAIN_READS // MAIN_FILES
    for f in range(MAIN_FILES):
        write_fastq(os.path.join(in_dir, f"reads_{f:02d}.fastq"), reads[f * per : (f + 1) * per])
    argv = [f"kmerLength={MAIN_K}", "canonical=true", f"gpuMemoryLimit={MEMORY_LIMIT}",
            f"inputFileLocation={in_dir}", f"outputFile={os.path.join(tmp, 'main_out.bin')}"]
    return reads, argv


# ---- phases -----------------------------------------------------------------


def cuda_ms(fn, reps):
    """Mean device time of fn over reps calls, by CUDA events, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_each(fn, reps):
    """Each of reps back-to-back calls of fn by CUDA events (an event
    recorded between calls), after one warm-up: what a call costs the
    stream when the host issues them as fast as it can."""
    import torch

    fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    events[0].record()
    for e in events[1:]:
        fn()
        e.record()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in zip(events, events[1:])]


def in_turns(kernel, plain, library=None, kernel_reps=5, plain_reps=3):
    """(kernel ms, plain ms, library ms or None), timed in turns: kernel,
    plain, library, library, plain, kernel."""
    k1, p1 = cuda_ms(kernel, kernel_reps), cuda_ms(plain, plain_reps)
    l1 = l2 = None
    if library is not None:
        l1, l2 = cuda_ms(library, kernel_reps), cuda_ms(library, kernel_reps)
    p2, k2 = cuda_ms(plain, plain_reps), cuda_ms(kernel, kernel_reps)
    return (k1 + k2) / 2, (p1 + p2) / 2, None if library is None else (l1 + l2) / 2


def bound(nbytes, ops):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over the
    card's memory rate and the operations over its 32-bit integer rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def merge_bound(NL, na, nb):
    """A merge of two runs (K5; for K1, K3, K4 the bound of earlier runs):
    each row of A and B read once, each output row written once; at most 16
    integer operations a merged row and lane (compares in the split, the
    merge, run heads and ends)."""
    n = na + nb
    return bound(2 * n * (NL + 1) * 4, 16 * n * (NL + 1))


def fold_bound(a_ops, b_ops, NL, out_rows=None):
    """A merge that folds (K1, K3, K4), counting what these operands need:
    their rows that are not the sentinel read once (the sentinel rows, the
    largest keys, come last and fold to nothing, whatever their counts),
    every output row written once (K1: out_rows of them, na+nb by default),
    and 16 integer operations a row and lane merged."""
    import torch

    read = sum(int((torch.stack(list(side[:NL])) != -1).any(0).sum()) for side in (a_ops, b_ops))
    written = a_ops[0].numel() + b_ops[0].numel() if out_rows is None else out_rows
    return bound((read + written) * (NL + 1) * 4, 16 * read * (NL + 1))


def bounds_of(kernel, a_ops, b_ops, NL, out_rows=None):
    """(bound for the line, the every-row bound of earlier runs or None)."""
    every_row = merge_bound(NL, a_ops[0].numel(), b_ops[0].numel())
    if kernel not in FOLDING:
        return every_row, None
    return fold_bound(a_ops, b_ops, NL, out_rows), every_row[0]


# Stopgap for a torch.profiler defect whose cause is not known: on the H100
# with torch 2.11, a trace can lose its first records, counted in records
# and not in time (a 50 ms wait opening a trace does not shorten it).  The
# loss grows with the counts a process runs after its first trace, the
# spilling ones most, with or without the chunk feed: about 20 records a
# trace after this script's counting phases when a probe trace follows
# every count (scripts/trace_loss.py --phases).  So the script takes its
# first trace after the counting phases 3-7 and 12-15, and a trace opens with
# spin kernels (ATen's spin_kernel), not counted: as many as a trace of
# spin kernels alone just lost, and TRACE_MARGIN more.  A trace that kept
# none of them may have lost records after them: it is taken again with
# four times as many.  Phase 11 reads the port's own profile=true trace
# without this opening.
TRACE_MARGIN = 256
TRACE_TRIES = 4


def launch_spins(n):
    import torch

    for _ in range(n):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def trace_warm_up():
    """The spin kernels a trace should open with now: a trace of spin
    kernels alone (4x more until it keeps one) tells how many it loses."""
    import torch
    from torch.autograd import DeviceType

    spins = TRACE_MARGIN
    while True:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            launch_spins(spins)
        kept = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA and "spin_kernel" in e.name)
        if kept:
            return spins - kept + TRACE_MARGIN
        if spins >= 1 << 16:
            raise AssertionError(f"torch.profiler lost every record of a trace of {spins} kernels")
        spins *= 4


def traced(fn):
    """(fn's result, the profiler) of one call of fn traced by torch.profiler
    (the card's activity), opened with spin kernels, the device
    synchronised after it; fn is called again, in a new trace, while a
    trace kept none of its spin kernels (TRACE_TRIES traces at most)."""
    import torch
    from torch.autograd import DeviceType

    spins = trace_warm_up()
    for tries in range(1, TRACE_TRIES + 1):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            launch_spins(spins)
            out = fn()
            torch.cuda.synchronize()
        kept = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA and "spin_kernel" in e.name)
        log({"phase": "trace", "opening_spins": spins, "spins_lost": spins - kept, "try": tries})
        if kept:
            return out, prof
        spins *= 4
    raise AssertionError(f"torch.profiler lost all {spins // 4} opening spin kernels of {TRACE_TRIES} traces")


def traced_kernels(fn):
    """Device time and launches of each kernel in one call of fn, by
    torch.profiler: {kernel name: {"ms": ..., "launches": ...}}."""
    from torch.autograd import DeviceType

    _, prof = traced(fn)
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not any(x in e.name for x in ("Memcpy", "Memset",
                                                                               "spin_kernel")):
            name = e.name.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0]
            k = out.setdefault(name[:80], {"ms": 0.0, "launches": 0})
            k["ms"] += (e.time_range.end - e.time_range.start) / 1e3
            k["launches"] += 1
    return out


def timing(err, ms, plain_ms, bound_ms_by, library_ms=None, every_row_bound_ms=None):
    """One shape's numbers; bound_ms_by is bound()'s pair; every_row_bound_ms
    (the folding merges) the bound that reads every input row."""
    t = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms_by[0],
         "bound_by": bound_ms_by[1], "library_ms": library_ms}
    if every_row_bound_ms is not None:
        t["every_row_bound_ms"] = every_row_bound_ms
    return t


def packed_key(keys):
    """The one int64 sort key of [NL <= 2, n] int32 lanes (unsigned order)."""
    from kmer_counter_tpu_torch.ops.sortcount import _digits

    return _digits(keys)[0]


def library_sort(keys, payload):
    """The library yardstick for a sort or merge at NL <= 2: torch.sort of
    the packed int64 key (stable=False), then a gather of keys and payload;
    the key is packed beforehand, outside the timed call."""
    import torch

    packed = packed_key(keys)

    def call():
        idx = torch.sort(packed, stable=False).indices
        return keys[:, idx], payload[idx]

    return call


def _ri(gen, device):
    import torch

    def ri(lo, hi, size):
        return torch.randint(lo, hi, size, generator=gen, device=device)

    return ri


def random_prefix(keys, na, gen, device, live_a=None):
    """A prefix of na rows from a key pool [NL, pool]: live_a live rows (80%
    by default), sorted, counts 1..5 (2% near 2^32), then sentinel rows with
    count 0."""
    import torch

    from kmer_counter_tpu_torch.ops.sortcount import lex_argsort

    ri = _ri(gen, device)
    NL, pool = keys.shape
    n_live_a = int(na * 0.8) if live_a is None else live_a
    a = keys[:, ri(0, pool, (n_live_a,))]
    a = a[:, lex_argsort(a)]
    ac = ri(1, 6, (n_live_a,)).to(torch.int32)
    big = torch.rand(n_live_a, generator=gen, device=device) < 0.02
    ac = torch.where(big, ri(-(2**31), 0, (n_live_a,)).to(torch.int32), ac)
    a = torch.cat([a, a.new_full((NL, na - n_live_a), -1)], 1)
    ac = torch.cat([ac, ac.new_zeros(na - n_live_a)])
    return [*a.unbind(0), ac]


def key_pool(NL, n, gen, device):
    import torch

    keys = _ri(gen, device)(-(2**31), 2**31, (NL, max(n, 4))).to(torch.int32)
    keys[:, 0] = 0
    return keys


def operand_mix(NL, na, nb, path=None):
    """(key pool size, A's live rows, B's live rows, B's masked windows):
    the 80%-live random mix of earlier runs (a pool of a third of the rows,
    10% of B dead, 5% masked), or, with path = (live_a, live_b, masked_b)
    from a main path's launch, that path's: its prefix's live rows, its raw
    region's liveness and masked windows, from a pool as large as the
    prefix's live rows (or a twentieth of the raw rows, about the coverage
    of the main count)."""
    if path is None:
        return max((na + nb) // 3, 4), int(na * 0.8), nb - int(nb * 0.1), int(nb * 0.05)
    live_a, live_b, masked_b = path
    return max(live_a, live_b // 20, 4), live_a, live_b, masked_b


def random_k1_operands(NL, na, nb, gen, device, path=None):
    """Consolidation-shaped K1 operands made on the card (operand_mix): A =
    sorted prefix rows (counts 1..5, 2% near 2^32) with a sentinel tail; B =
    raw rows drawn with repeats from the same key pool, masked windows
    (sentinel, live) and dead rows (zero key, liveness 0), stored
    descending."""
    import torch

    from kmer_counter_tpu_torch.ops.sortcount import lex_argsort

    pool, live_a, live_b, masked_b = operand_mix(NL, na, nb, path)
    keys = key_pool(NL, pool, gen, device)
    a_ops = random_prefix(keys, na, gen, device, live_a)
    b = keys[:, _ri(gen, device)(0, keys.shape[1], (nb,))]
    b[:, :masked_b] = -1
    b = b[:, lex_argsort(b)]
    n_dead = nb - live_b
    b[:, :n_dead] = 0
    live = torch.ones(nb, dtype=torch.int32, device=device)
    live[:n_dead] = 0
    b, live = b.flip(1).contiguous(), live.flip(0).contiguous()
    return a_ops, [*b.unbind(0), live]


def random_merge_operands(kernel, NL, na, nb, gen, device, path=None):
    """The operands of a split consolidation's merge kernel, made on the
    card as the two-level table gives them (operand_mix): A = a prefix
    (random_prefix); B = a raw region of nb rows drawn with repeats from the
    same key pool (its live rows first, masked windows among them), sorted
    by the table's own helper for that kernel (descending with liveness,
    ascending with liveness, ascending with run-head multiplicities)."""
    import torch

    from kmer_counter_tpu_torch.ops import table2 as t2

    pool, live_a, raw_off, masked_b = operand_mix(NL, na, nb, path)
    keys = key_pool(NL, pool, gen, device)
    a_ops = random_prefix(keys, na, gen, device, live_a)
    raw = keys[:, _ri(gen, device)(0, keys.shape[1], (nb,))]
    raw[:, :masked_b] = -1
    raw[:, raw_off:] = 0
    sort = {"merge_sorted_runs_fold_bitonic": t2._sort_raw_desc,
            "merge_sorted_runs_fold": t2._sort_raw_ones, "merge_sorted_runs": t2._sort_raw}[kernel]
    s, counts = sort(raw.contiguous(), raw_off)
    del raw
    torch.cuda.empty_cache()
    return a_ops, [*s.unbind(0), counts]


def compare_k1(a_ops, b_ops, NL, time_it, out_rows=None):
    """Kernel vs plain on the same operands, writing out_rows columns (na+nb
    by default): bit-exact or raise.  Returns the timing dict (times None
    unless time_it)."""
    import torch

    from kmer_counter_tpu_torch.ops import merge_fold_compact as mfc
    from kmer_counter_tpu_torch.ops.u32 import widen

    # Only a tree that has the argument is given it (scripts/time_kernels.py
    # may time an older one).
    kw = {} if out_rows is None else {"out_rows": out_rows}
    out, live = mfc.merge_fold_compact(a_ops, b_ops, NL, **kw)
    want, want_live = mfc.merge_fold_compact_reference(a_ops, b_ops, NL, **kw)
    torch.cuda.synchronize()
    err = int((widen(out) - widen(want)).abs().max()) if out.numel() else 0
    if int(live) != int(want_live) or not torch.equal(out, want):
        raise AssertionError(
            f"K1 kernel disagrees with plain: NL={NL} na={a_ops[0].numel()} "
            f"nb={b_ops[0].numel()} live {int(live)} vs {int(want_live)}, max_abs_err {err}"
        )
    del out, want
    cost, every_row = bounds_of(K1["name"], a_ops, b_ops, NL, out_rows)
    if not time_it:
        return timing(err, None, None, cost, every_row_bound_ms=every_row)
    ms, plain_ms, _ = in_turns(lambda: mfc.merge_fold_compact(a_ops, b_ops, NL, **kw),
                               lambda: mfc.merge_fold_compact_reference(a_ops, b_ops, NL, **kw))
    return {**timing(err, ms, plain_ms, cost, every_row_bound_ms=every_row),
            "device_kernels": traced_kernels(lambda: mfc.merge_fold_compact(a_ops, b_ops, NL, **kw))}


def k1_random_shapes(device, gen):
    """K1 vs plain on random operands per NL at ~8M and ~32M rows, timed.
    Returns the largest error."""
    max_err = 0
    for NL in (1, 2, 4, 7):
        for n in KERNEL_ROWS:
            na = n // 8
            a_ops, b_ops = random_k1_operands(NL, na, n - na, gen, device)
            t = compare_k1(a_ops, b_ops, NL, time_it=True)
            max_err = max(max_err, t["max_abs_err"])
            log({"phase": "kernel", "kernel": K1["name"], "NL": NL, "na": na, "nb": n - na,
                 "bit_exact": True, **t})
            del a_ops, b_ops
    return max_err


def k1_at_shape(path, shape, gen, device):
    """K1 vs plain, timed, at one main-path launch shape (NL, na, nb,
    live_a, live_b, masked_b, out_rows; out_rows None for na+nb): first on
    operands shaped as the path gave them, then (not on the mesh paths) on
    the 80%-live random mix of the same size.  Returns the path-shaped
    timing."""
    NL, na, nb, *live, out_rows = shape
    out = None
    # The mesh paths' many shapes (each position's live rows differ) are
    # timed on their path-shaped operands only.
    for mix in ("path",) if path.startswith("mesh") else ("path", "random_80pct_live"):
        a_ops, b_ops = random_k1_operands(NL, na, nb, gen, device, live if mix == "path" else None)
        t = compare_k1(a_ops, b_ops, NL, time_it=True, out_rows=out_rows)
        del a_ops, b_ops
        log({"phase": "kernel", "kernel": K1["name"], "path": path, "main_path_launch_shape": True,
             "operands": mix, "NL": NL, "na": na, "nb": nb, "live_a": live[0], "live_b": live[1],
             "masked_b": live[2], "out_rows": out_rows, "bit_exact": True, **t})
        out = out or t
    return out


def phase_kernel(device, cases, shapes_by_path):
    """K1 kernel vs plain: k1_random_shapes, the edge cases (also those of
    the K1/K3 kernel's tile), and each launch shape of a main path
    (k1_at_shape).  Returns per_path_totals's dict."""
    import numpy as np
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED)
    max_err = k1_random_shapes(device, gen)
    for name, build in sorted({**cases.EDGE_CASES, **cases.FOLD_CASES}.items()):
        a_ops, b_ops, NL = cases.operands(build(np.random.default_rng(SEED)), device)
        max_err = max(max_err, compare_k1(a_ops, b_ops, NL, time_it=False)["max_abs_err"])
        log({"phase": "kernel", "kernel": K1["name"], "edge_case": name, "bit_exact": True})
    return per_path_totals(shapes_by_path, lambda path, shape: k1_at_shape(path, shape, gen, device),
                           max_err)


def per_path_totals(shapes_by_path, at_shape, max_err):
    """Runs at_shape(path, shape) -> timing dict once for each distinct
    launch shape (a shape that an earlier path launched too is not timed
    again).  Returns the largest error (with max_err), and ms, plain_ms,
    bound_ms and library_ms as totals over every launch (each shape's times
    times its launch count; library_ms None unless every shape has one),
    over all paths and under "paths" for each; bound_by says which bound
    the largest share of bound_ms came from."""
    import torch

    keys = ("ms", "plain_ms", "bound_ms", "library_ms")
    done, paths, by = {}, {}, Counter()
    largest = None  # the timing of the shape with the largest bound
    for path, shapes in shapes_by_path.items():
        tot = dict.fromkeys(keys, 0.0)
        for shape, count in sorted(Counter(shapes).items()):
            if shape not in done:
                done[shape] = at_shape(path, shape)
                torch.cuda.empty_cache()
            t = done[shape]
            if largest is None or t["bound_ms"] > largest["bound_ms"]:
                largest = t
            max_err = max(max_err, t["max_abs_err"])
            by[t["bound_by"]] += count * t["bound_ms"]
            for key in keys:
                tot[key] = None if tot[key] is None or t[key] is None else tot[key] + count * t[key]
        paths[path] = tot
    out = {"max_abs_err": max_err, "paths": paths,
           "bound_by": by.most_common(1)[0][0] if by else "bytes"}
    for key in keys:
        vals = [p[key] for p in paths.values()]
        out[key] = None if None in vals else sum(vals)
    if largest is not None and "device_kernels" in largest:
        out["device_kernels"] = largest["device_kernels"]
    return out


def random_sort_operands(NL, n, gen, device):
    """Table-shaped sort operands made on the card: keys drawn with repeats
    from a pool of n/3, a fifth of which are all-ones (genuine keys, not
    empty slots), and counts 0..5 as the payload (about a sixth 0)."""
    import torch

    pool = max(n // 3, 4)
    keys = torch.randint(-(2**31), 2**31, (NL, pool), generator=gen, device=device,
                         dtype=torch.int32)
    keys[:, : pool // 5] = -1
    keys = keys[:, torch.randint(0, pool, (n,), generator=gen, device=device)]
    counts = torch.randint(0, 6, (n,), generator=gen, device=device, dtype=torch.int32)
    return keys, counts


def finalize_sort_operands(NL, n, gen, device):
    """Sort operands as the two-level finalize gives them to sort_reduce:
    the prefix's live rows, distinct keys already ascending (none
    all-ones), counts 1..5."""
    import torch

    from kmer_counter_tpu_torch.ops.sortcount import lex_argsort, run_heads

    m = n + n // 8 + 16
    keys = torch.randint(-(2**31), 2**31, (NL, m), generator=gen, device=device, dtype=torch.int32)
    keys = keys[:, lex_argsort(keys)]
    keys = keys[:, run_heads(keys) & (keys != -1).any(0)]
    if keys.shape[1] < n:
        raise RuntimeError(f"drew {keys.shape[1]} distinct keys, need {n}")
    counts = torch.randint(1, 6, (n,), generator=gen, device=device, dtype=torch.int32)
    return keys[:, :n].contiguous(), counts


# The sort's operands at each main path's launch shapes, as that path gives
# them: the two-level runs sort only at finalize, the one-level run sorts
# its whole table at every consolidation.
def route_sort_operands(NL, n, gen, device):
    """Sort operands as a mesh route gives them to sort_reduce: the slices
    that MESH_POSITIONS positions send, concatenated, each unique and
    ascending and each holding most keys of the range (every position
    counted most of the genome)."""
    import torch

    pool, _ = finalize_sort_operands(NL, -(-n // MESH_POSITIONS) + 1, gen, device)
    keys = torch.cat([pool[:, torch.rand(pool.shape[1], generator=gen, device=device) < 0.97]
                      for _ in range(MESH_POSITIONS)], dim=1)
    while keys.shape[1] < n:
        keys = torch.cat([keys, pool], dim=1)
    return keys[:, :n].contiguous(), torch.randint(1, 6, (n,), generator=gen, device=device, dtype=torch.int32)


# The paths whose tables are one-level (a sort of every slot at each
# consolidation).
ONE_LEVEL_PATHS = ("main_one", "spill_one", "resume_one", "mesh_one", "mesh_mp_one")


def sort_operands_for(path, route=False):
    """The one-level table sorts every slot; the two-level finalize sorts
    the prefix's live rows, unique and ascending; a mesh route the slices
    the positions sent (LaunchShapes marks its shapes "route")."""
    if route:
        return route_sort_operands
    return random_sort_operands if path in ONE_LEVEL_PATHS else finalize_sort_operands


def compare_sort(cases, keys, payload, time_it, reduce_too=False):
    """The sort kernel vs its plain version on the same operands: keys
    bit-exact and the same payloads under each key (``cases``: the loaded
    tests/test_torch_cuda.py), or raise; with
    reduce_too, sort_reduce (through the kernel) against sort_reduce's
    second half applied to the plain sort, equal or raise.  Returns the
    timing dict (times None unless time_it; the library call at NL <= 2)."""
    import torch

    from kmer_counter_tpu_torch.ops import lane_sort as ls
    from kmer_counter_tpu_torch.ops.sortcount import reduce_sorted, sort_reduce
    from kmer_counter_tpu_torch.ops.u32 import widen

    NL, n = keys.shape
    got = ls.sort_ops(keys, payload)
    want = ls.sort_ops_reference(keys, payload)
    torch.cuda.synchronize()
    err = int((widen(got[0]) - widen(want[0])).abs().max()) if n else 0
    if not cases.sort_outputs_agree(got, want):
        raise AssertionError(f"sort kernel disagrees with plain: NL={NL} n={n} key max_abs_err {err}")
    del got, want
    if reduce_too:
        u_lanes, u_counts, u_n = sort_reduce(keys, payload)
        eff = torch.where(payload != 0, keys, -1)
        w_lanes, w_counts, w_n = reduce_sorted(*ls.sort_ops_reference(eff, payload))
        if u_n != w_n or not torch.equal(u_counts, w_counts) or not torch.equal(
                u_lanes[:, :u_n], w_lanes[:, :w_n]):
            raise AssertionError(f"sort_reduce through the kernel disagrees with plain: NL={NL} n={n}")
        del u_lanes, u_counts, w_lanes, w_counts, eff
    levels = max((n - 1).bit_length(), 1)
    cost = bound(2 * n * (NL + 1) * 4, 2 * n * NL * levels)  # bytes; compares per lane and merge level
    if not time_it:
        return timing(err, None, None, cost)
    library = library_sort(keys, payload) if NL <= 2 else None
    ms, plain_ms, library_ms = in_turns(lambda: ls.sort_ops(keys, payload),
                                        lambda: ls.sort_ops_reference(keys, payload), library)
    kernels = traced_kernels(lambda: ls.sort_ops(keys, payload))
    passes = sum(k["launches"] for name, k in kernels.items() if SORT_KERNEL_NAMES[1] in name)
    return {**timing(err, ms, plain_ms, cost, library_ms), "leaf_tile_rows": ls.tile_rows(NL),
            "merge_passes": passes, "device_kernels": kernels}


def sort_random_shapes(device, cases, gen):
    """The sort kernel vs plain on random operands per NL at ~8M and ~32M
    rows, timed.  Returns the largest key error."""
    max_err = 0
    for NL in (1, 2, 4, 7):
        for n in KERNEL_ROWS:
            keys, counts = random_sort_operands(NL, n, gen, device)
            t = compare_sort(cases, keys, counts, time_it=True)
            max_err = max(max_err, t["max_abs_err"])
            log({"phase": "kernel", "kernel": SORT["name"], "NL": NL, "n": n, "keys_bit_exact": True,
                 "payloads_conserved": True, **t})
            del keys, counts
    return max_err


def phase_sort_kernel(device, cases, shapes_by_path):
    """The sort kernel vs plain: sort_random_shapes, the edge cases (also
    on lanes that are column slices starting past a 16-byte boundary), and
    each (NL, n) that a main path launched, on operands shaped as that path
    gives them (sort_operands_for).  Returns per_path_totals's dict."""
    import numpy as np
    import torch

    from kmer_counter_tpu_torch.ops.u32 import from_numpy

    gen = torch.Generator(device=device).manual_seed(SEED)
    max_err = sort_random_shapes(device, cases, gen)
    for name, build in sorted(cases.SORT_CASES.items()):
        keys_np, payload_np = build(np.random.default_rng(SEED))
        for layout, (keys, payload) in (
                ("contiguous", (from_numpy(keys_np, device), from_numpy(payload_np, device))),
                ("column_slices", cases.column_slices(keys_np, payload_np, device))):
            t = compare_sort(cases, keys, payload, time_it=False)
            max_err = max(max_err, t["max_abs_err"])
        log({"phase": "kernel", "kernel": SORT["name"], "edge_case": name, "n": keys_np.shape[1],
             "layouts": ["contiguous", "column_slices"], "keys_bit_exact": True,
             "payloads_conserved": True})

    def at_shape(path, shape):
        NL, n, *route = shape
        keys, counts = sort_operands_for(path, bool(route))(NL, n, gen, device)
        t = compare_sort(cases, keys, counts, time_it=True, reduce_too=True)
        log({"phase": "kernel", "kernel": SORT["name"], "path": path, "main_path_launch_shape": True,
             "NL": NL, "n": n, "route": bool(route), "keys_bit_exact": True, "payloads_conserved": True,
             "sort_reduce_equal": True, **t})
        return t

    return per_path_totals(shapes_by_path, at_shape, max_err)


def compare_merge(cases, kernel, a_ops, b_ops, NL, time_it):
    """A merge kernel of ops.merge_runs vs its plain version: bit-exact for
    the folding merges, keys bit-exact and the same payloads under each key
    for merge_sorted_runs, or raise.  Returns (timing dict, bit_exact)."""
    import torch

    from kmer_counter_tpu_torch.ops import merge_runs as mr
    from kmer_counter_tpu_torch.ops.u32 import widen

    fn, ref = getattr(mr, kernel), getattr(mr, kernel + "_reference")
    got, want = fn(a_ops, b_ops, NL), ref(a_ops, b_ops, NL)
    torch.cuda.synchronize()
    err = int((widen(got[:NL]) - widen(want[:NL])).abs().max()) if got.numel() else 0
    if not cases.merge_outputs_agree(kernel, got, want):
        raise AssertionError(f"{kernel} kernel disagrees with plain: NL={NL} na={a_ops[0].numel()} "
                             f"nb={b_ops[0].numel()}, key max_abs_err {err}")
    bit_exact = torch.equal(got, want)
    del got, want
    cost, every_row = bounds_of(kernel, a_ops, b_ops, NL)
    if not time_it:
        return timing(err, None, None, cost, every_row_bound_ms=every_row), bit_exact
    library = None
    if kernel == "merge_sorted_runs" and NL <= 2:
        library = library_sort(torch.cat([torch.stack(a_ops[:NL]), torch.stack(b_ops[:NL])], 1),
                               torch.cat([a_ops[NL], b_ops[NL]]))
    ms, plain_ms, library_ms = in_turns(lambda: fn(a_ops, b_ops, NL), lambda: ref(a_ops, b_ops, NL),
                                        library)
    return {**timing(err, ms, plain_ms, cost, library_ms, every_row),
            "device_kernels": traced_kernels(lambda: fn(a_ops, b_ops, NL))}, bit_exact


def merge_random_shapes(device, cases, gen, kernel):
    """A merge kernel of ops.merge_runs vs plain on random operands per NL
    at ~8M rows (K3 also ~32M), timed.  Returns the largest key error."""
    max_err = 0
    sizes = KERNEL_ROWS if kernel == "merge_sorted_runs_fold_bitonic" else (NEW_KERNEL_ROWS,)
    for NL in (1, 2, 4, 7):
        for n in sizes:
            a_ops, b_ops = random_merge_operands(kernel, NL, n // 8, n - n // 8, gen, device)
            t, exact = compare_merge(cases, kernel, a_ops, b_ops, NL, time_it=True)
            max_err = max(max_err, t["max_abs_err"])
            log({"phase": "kernel", "kernel": kernel, "NL": NL, "na": n // 8, "nb": n - n // 8,
                 "agrees": True, "bit_exact": exact, **t})
            del a_ops, b_ops
    return max_err


def merge_at_shape(cases, kernel, path, shape, gen, device):
    """A merge kernel vs plain, timed, at one main-path launch shape (NL, na,
    nb, live_a, live_b, masked_b), on operands shaped as the path gave them
    and then on the 80%-live random mix of the same size.  Returns the
    path-shaped timing."""
    NL, na, nb, *live = shape
    out = None
    for mix in ("path", "random_80pct_live"):
        a_ops, b_ops = random_merge_operands(kernel, NL, na, nb, gen, device,
                                             live if mix == "path" else None)
        t, exact = compare_merge(cases, kernel, a_ops, b_ops, NL, time_it=True)
        del a_ops, b_ops
        log({"phase": "kernel", "kernel": kernel, "path": path, "main_path_launch_shape": True,
             "operands": mix, "NL": NL, "na": na, "nb": nb, "live_a": live[0], "live_b": live[1],
             "masked_b": live[2], "agrees": True, "bit_exact": exact, **t})
        out = out or t
    return out


def phase_merge_kernels(device, cases, shapes_by_kernel):
    """K3, K4, K5 vs plain: merge_random_shapes, the edge cases (also those
    of the K1/K3 kernel's tile), and each launch shape of a main path
    (merge_at_shape).  Returns {kernel: per_path_totals's dict}."""
    import numpy as np
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED)
    results = {}
    for kernel, shapes_by_path in shapes_by_kernel.items():
        max_err = merge_random_shapes(device, cases, gen, kernel)
        for name, build in sorted({**cases.EDGE_CASES, **cases.FOLD_CASES}.items()):
            case = cases.merge_case_layout(kernel, build(np.random.default_rng(SEED)))
            a_ops, b_ops, NL = cases.operands(case, device)
            t, exact = compare_merge(cases, kernel, a_ops, b_ops, NL, time_it=False)
            max_err = max(max_err, t["max_abs_err"])
            log({"phase": "kernel", "kernel": kernel, "edge_case": name, "agrees": True,
                 "bit_exact": exact})
        results[kernel] = per_path_totals(
            shapes_by_path, lambda path, shape, kernel=kernel: merge_at_shape(cases, kernel, path, shape,
                                                                              gen, device), max_err)
    return results


def compare_k2(ops2d, live, num_keys, time_it, out_rows=None):
    """K2 vs plain on the rows of ops2d [n_ops, n] with the flags ``live``
    (one of those rows, as in the table, or a separate lane), writing
    out_rows columns (n by default): bit-exact or raise.  Returns the
    timing dict; the library call is ops2d[:, live != 0]."""
    import torch

    from kmer_counter_tpu_torch.ops import compact_live as cl
    from kmer_counter_tpu_torch.ops.u32 import widen

    ops = list(ops2d.unbind(0))
    n_ops, n = ops2d.shape
    # Only a tree that has the argument is given it (scripts/time_kernels.py
    # may time an older one).
    kw = {} if out_rows is None else {"out_rows": out_rows}
    width = n if out_rows is None else out_rows
    got = cl.compact_live(ops, live, num_keys, **kw)
    want = cl.compact_live_reference(ops, live, num_keys, **kw)
    torch.cuda.synchronize()
    err = int((widen(got) - widen(want)).abs().max()) if got.numel() else 0
    if not torch.equal(got, want):
        raise AssertionError(f"K2 kernel disagrees with plain: n_ops={len(ops)} n={live.numel()} "
                             f"out_rows={width}, max_abs_err {err}")
    del got, want
    # What this data needs: the flags, the other lanes of the live rows
    # that fit, every output row; a few integer operations a row and lane.
    other = n_ops - any(v.data_ptr() == live.data_ptr() for v in ops)
    kept = min(int((live != 0).sum()), width)
    cost = bound(4 * (n + kept * other + width * n_ops), 4 * n * n_ops)
    if not time_it:
        return timing(err, None, None, cost)
    ms, plain_ms, library_ms = in_turns(lambda: cl.compact_live(ops, live, num_keys, **kw),
                                        lambda: cl.compact_live_reference(ops, live, num_keys, **kw),
                                        lambda: ops2d[:, live != 0])
    return {**timing(err, ms, plain_ms, cost, library_ms),
            "device_kernels": traced_kernels(lambda: cl.compact_live(ops, live, num_keys, **kw))}


def random_k2_operands(n_ops, n, live_rows, gen, device):
    """K2 operands as a split consolidation gives them: n_ops - 1 key lanes
    and a count lane, nonzero (1..5) on live_rows rows spread over the
    table; the count lane is the flags."""
    import torch

    ops2d = torch.randint(-(2**31), 2**31, (n_ops, n), generator=gen, device=device,
                          dtype=torch.int32)
    ops2d[-1] = 0
    where = torch.randperm(n, generator=gen, device=device)[:live_rows]
    ops2d[-1, where] = torch.randint(1, 6, (live_rows,), generator=gen, device=device,
                                     dtype=torch.int32)
    return ops2d


def k2_random_shapes(device, gen):
    """K2 vs plain on random operands per NL at ~8M rows with about a third
    live, timed.  Returns the largest error."""
    max_err = 0
    for NL in (1, 2, 4, 7):
        n = NEW_KERNEL_ROWS
        ops2d = random_k2_operands(NL + 1, n, n // 3, gen, device)
        t = compare_k2(ops2d, ops2d[-1], NL, time_it=True)
        max_err = max(max_err, t["max_abs_err"])
        log({"phase": "kernel", "kernel": K2["name"], "n_ops": NL + 1, "n": n, "live_rows": n // 3,
             "bit_exact": True, **t})
        del ops2d
    return max_err


def phase_k2_kernel(device, cases, shapes_by_path):
    """K2 vs plain: k2_random_shapes, the edge cases (sizes around the
    tile, densities 0 to 1, widths 1 to 9, flags apart from the operands),
    and each (n_ops, n, live rows) that a main path launched.  Returns
    per_path_totals's dict."""
    import numpy as np
    import torch

    from kmer_counter_tpu_torch.ops.u32 import from_numpy

    gen = torch.Generator(device=device).manual_seed(SEED)
    max_err = k2_random_shapes(device, gen)
    for n in cases.COMPACT_SIZES:
        for density in (0.0, 0.5, 0.97, 1.0):
            for n_ops, num_keys in ((3, 2), (1, 1), (9, 8), (3, 0)):
                ops, live = cases.compact_case(np.random.default_rng(n), n_ops - 1, n, density)
                # the rows at 0 and 1 words past a 16-byte boundary
                for start in (0, 1):
                    rows = from_numpy(np.pad(np.stack([*ops, live]), ((0, 0), (start, 0))), device)
                    ops2d = rows[:-1, start:]
                    for flags in (rows[-1, start:], ops2d[-1]):
                        max_err = max(max_err, compare_k2(ops2d, flags, num_keys, False)["max_abs_err"])
    log({"phase": "kernel", "kernel": K2["name"], "edge_cases": "sizes x densities x widths x alignments",
         "sizes": cases.COMPACT_SIZES, "bit_exact": True})

    def at_shape(path, shape):
        n_ops, n, live_rows, out_rows = shape
        ops2d = random_k2_operands(n_ops, n, live_rows, gen, device)
        t = compare_k2(ops2d, ops2d[-1], n_ops - 1, time_it=True, out_rows=out_rows)
        log({"phase": "kernel", "kernel": K2["name"], "path": path, "main_path_launch_shape": True,
             "n_ops": n_ops, "n": n, "live_rows": live_rows, "out_rows": out_rows, "bit_exact": True,
             **t})
        return t

    return per_path_totals(shapes_by_path, at_shape, max_err)


# R1's cases: NL 1..8 at sizes around its 1024-row tile and ragged, with a
# share of zero counts (so the kept rows before most tiles are no multiple
# of 4), on lanes sliced from a wider table.
R1_SIZES = (1, 31, 1023, 1024, 1025, 4097, 100_003)
R1_ZERO_SHARES = (0.0, 0.1, 1.0)


def r1_operands(NL, n, kept, gen, device, pad=0, offset=0):
    """R1's operands made on the card: random lanes [NL, n] as a column
    slice [offset, offset + n) of a table ``offset + n + pad`` wide, and
    counts with ``kept`` nonzero rows spread over the table."""
    import torch

    lanes = torch.randint(-(2**31), 2**31, (NL, offset + n + pad), generator=gen, device=device,
                          dtype=torch.int32)[:, offset:offset + n]
    counts = torch.randint(1, 2**31, (n,), generator=gen, device=device, dtype=torch.int32)
    if kept < n:
        counts[torch.randperm(n, generator=gen, device=device)[: n - kept]] = 0
    return lanes, counts


def compare_r1(lanes, counts, time_it):
    """R1 vs plain: the same bytes or raise.  The bound: each row's lanes
    and count read once, each kept row's record written once, a few
    integer operations a word."""
    import torch

    from kmer_counter_tpu_torch.ops import record_pack as rp

    got = rp.pack_records(lanes, counts)
    want = rp.pack_records_reference(lanes, counts)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"R1 kernel disagrees with plain: lanes {tuple(lanes.shape)}, "
                             f"{got.numel()} bytes against {want.numel()}")
    NL, n = lanes.shape
    written = want.numel()
    del got, want
    cost = bound(4 * (NL + 1) * n + written, 4 * (NL + 1) * n + written // 4)
    if not time_it:
        return timing(0, None, None, cost)
    ms, plain_ms, _ = in_turns(lambda: rp.pack_records(lanes, counts),
                               lambda: rp.pack_records_reference(lanes, counts))
    return {**timing(0, ms, plain_ms, cost),
            "device_kernels": traced_kernels(lambda: rp.pack_records(lanes, counts))}


def r1_at_shape(path, shape, gen, device):
    """R1 at a path's launch shape (NL, rows, kept rows), its lanes a slice
    of a quarter wider table; the line gives the kernels' device time in
    one traced call beside the bound."""
    NL, n, kept = shape
    lanes, counts = r1_operands(NL, n, kept, gen, device, pad=n // 4)
    t = compare_r1(lanes, counts, time_it=True)
    device_ms = sum(k["ms"] for k in t["device_kernels"].values())
    log({"phase": "kernel", "kernel": R1["name"], "path": path, "main_path_launch_shape": True, "NL": NL,
         "rows": n, "kept": kept, "bit_exact": True, **t, "device_ms": device_ms,
         "device_bound_share": t["bound_ms"] / device_ms if device_ms else None})
    return t


def phase_r1_kernel(device, shapes_by_path):
    """R1 vs plain: NL 1..8 at R1_SIZES and R1_ZERO_SHARES on sliced lanes,
    no rows, then each (NL, rows, kept) that a main path launched.
    Returns per_path_totals's dict."""
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED)
    for NL in range(1, 9):
        for n in R1_SIZES:
            for share in R1_ZERO_SHARES:
                compare_r1(*r1_operands(NL, n, n - int(share * n), gen, device, pad=5, offset=n % 3), False)
        compare_r1(*r1_operands(NL, 0, 0, gen, device), False)
    log({"phase": "kernel", "kernel": R1["name"], "edge_cases": "NL 1..8 x sizes x zero shares, sliced lanes",
         "sizes": R1_SIZES, "zero_shares": R1_ZERO_SHARES, "bit_exact": True})
    return per_path_totals(shapes_by_path, lambda path, shape: r1_at_shape(path, shape, gen, device), 0)


class LaunchShapes:
    """Records the shape of each call of the kernel wrappers on the table
    paths: (NL, na, nb, A's live rows, B's live rows, B's live rows with
    the sentinel key) for the merges, the same and the output width for K1,
    (NL, n) for the sort, (NL, n, "route") inside a mesh route,
    (n_ops, n, live rows, output width) for K2, (R, L, k, canonical,
    "keys" or "records") for K8, and (NL, n, kept rows) for R1; the kernel phase compares and times the
    kernels at those shapes.
    ``variant``: consolidate3's keywords, bound to table2.consolidate3 while
    the context is open."""

    def __init__(self, variant=None):
        import functools

        from kmer_counter_tpu_torch.io import dump
        from kmer_counter_tpu_torch.ops import fused_extract, lane_sort, table2

        self._table2, self._lane_sort, self._fx, self._dump = table2, lane_sort, fused_extract, dump
        self.shapes = {name: [] for name in KERNEL_NAMES}
        self._patches = [(table2, "merge_fold_compact", self._merge("merge_fold_compact")),
                         (lane_sort, "sort_ops", self._sort),
                         (table2, "compact_live", self._k2),
                         (fused_extract, "extract_chunk_lanes_major", self._k8_records),
                         (fused_extract, "extract_chunk_keys_into", self._k8_keys),
                         (dump, "pack_records", self._r1)]
        self._patches += [(table2, name, self._merge(name)) for name in MERGES]
        if variant:
            self._patches.append((table2, "consolidate3", functools.partial(table2.consolidate3, **variant)))
        self._reals = {(m, name): getattr(m, name) for m, name, _ in self._patches}

    # The counts are taken piece by piece (table2._count_rows): a sum over a
    # whole lane would widen it to int64 and raise the peak device memory
    # that phase_main holds to gpuMemoryLimit.
    def _merge(self, name):
        import torch

        count = self._table2._count_rows

        def call(a_ops, b_ops, num_keys, **kw):
            na, nb, b_live = a_ops[0].numel(), b_ops[0].numel(), b_ops[num_keys]
            masked = count(nb, lambda p0, p1: (torch.stack([v[p0:p1] for v in b_ops[:num_keys]]) == -1).all(0)
                           & (b_live[p0:p1] != 0))
            shape = (num_keys, na, nb, count(na, lambda p0, p1: a_ops[num_keys][p0:p1] != 0),
                     count(nb, lambda p0, p1: b_live[p0:p1] != 0), masked)
            self.shapes[name].append(shape + ((kw.get("out_rows"),) if name == K1["name"] else ()))
            return self._reals[(self._table2, name)](a_ops, b_ops, num_keys, **kw)

        return call

    def _sort(self, keys, payload):
        self.shapes[SORT["name"]].append(tuple(keys.shape) + (("route",) if RouteProbe.active else ()))
        return self._reals[(self._lane_sort, "sort_ops")](keys, payload)

    def _k2(self, operands, live, num_keys, out_rows=None):
        live_rows = self._table2._count_rows(live.numel(), lambda p0, p1: live[p0:p1] != 0)
        self.shapes[K2["name"]].append((len(operands), live.numel(), live_rows, out_rows))
        return self._reals[(self._table2, "compact_live")](operands, live, num_keys, out_rows)

    def _k8_records(self, reads, k, canonical=False):
        self.shapes[K8["name"]].append((*reads.shape, k, bool(canonical), "records"))
        return self._reals[(self._fx, "extract_chunk_lanes_major")](reads, k, canonical)

    def _k8_keys(self, reads, k, canonical, dst, off, allt):
        self.shapes[K8["name"]].append((*reads.shape, k, bool(canonical), "keys"))
        return self._reals[(self._fx, "extract_chunk_keys_into")](reads, k, canonical, dst, off, allt)

    def _r1(self, lanes, counts):
        kept = self._table2._count_rows(counts.numel(), lambda p0, p1: counts[p0:p1] != 0)
        self.shapes[R1["name"]].append((lanes.shape[0], counts.numel(), kept))
        return self._reals[(self._dump, "pack_records")](lanes, counts)

    def __enter__(self):
        for module, name, fn in self._patches:
            setattr(module, name, fn)
        return self

    def __exit__(self, *exc):
        for module, name, _ in self._patches:
            setattr(module, name, self._reals[(module, name)])


def launch_counts():
    """Every kernel wrapper's launch count, by kernel name."""
    from kmer_counter_tpu_torch.ops import compact_live as cl
    from kmer_counter_tpu_torch.ops import fused_extract as fx
    from kmer_counter_tpu_torch.ops import lane_sort as ls
    from kmer_counter_tpu_torch.ops import merge_fold_compact as mfc
    from kmer_counter_tpu_torch.ops import merge_runs as mr
    from kmer_counter_tpu_torch.ops import record_pack as rp

    return {K1["name"]: mfc.launches, SORT["name"]: ls.launches, K2["name"]: cl.launches,
            **{name: mr.launches[name] for name in MERGES}, K8["name"]: fx.launches, R1["name"]: rp.launches}


def reset_launch_counts():
    from kmer_counter_tpu_torch.ops import compact_live as cl
    from kmer_counter_tpu_torch.ops import fused_extract as fx
    from kmer_counter_tpu_torch.ops import lane_sort as ls
    from kmer_counter_tpu_torch.ops import merge_fold_compact as mfc
    from kmer_counter_tpu_torch.ops import merge_runs as mr
    from kmer_counter_tpu_torch.ops import record_pack as rp

    mfc.launches = ls.launches = cl.launches = fx.launches = rp.launches = 0
    for name in mr.launches:
        mr.launches[name] = 0


def run_main_path(device, argv, impl, variant=None):
    """One CLI run of the main count with tableImpl=impl (and, for the
    two-level table, consolidate3's keywords ``variant``).  The launch
    counts are set to 0 just before it and read just after.  Returns
    (wall s, peak device bytes, {kernel: launches}, LaunchShapes, the
    engine's RunStats)."""
    import torch

    from kmer_counter_tpu_torch import engine
    from kmer_counter_tpu_torch.__main__ import main

    real_run, stats = engine.CountEngine.run, []

    def run(self):
        stats.append(real_run(self))
        return stats[-1]

    engine.CountEngine.run = run
    try:
        with LaunchShapes(variant) as shapes:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            reset_launch_counts()
            t0 = time.perf_counter()
            rc = main(argv + [f"tableImpl={impl}"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = launch_counts()
    finally:
        engine.CountEngine.run = real_run
    if rc != 0:
        raise RuntimeError(f"main() returned {rc} (tableImpl={impl}, variant {variant})")
    return wall, torch.cuda.max_memory_allocated(device), launches, shapes, stats[0]


def check_launches(path, launches, need):
    """need: {kernel: (least, most or None)} launches in the path's run."""
    for name, (least, most) in need.items():
        if launches[name] < least or (most is not None and launches[name] > most):
            raise AssertionError(f"{path}: {name} launched {launches[name]} times "
                                 f"(want >= {least}{'' if most is None else f' and <= {most}'})")


def check_k8_launches(path, launches, chunks, positions=1):
    """K8, the chunk step, once for each chunk on each position."""
    if chunks < 1 or launches[K8["name"]] != chunks * positions:
        raise AssertionError(f"{path}: {K8['name']} launched {launches[K8['name']]} times (want {chunks} chunks x "
                             f"{positions} positions)")


def check_dump(path, want: bytes, what: str):
    with open(path, "rb") as fh:
        if fh.read() != want:
            raise AssertionError(f"{what}: the dump differs from the independent NumPy count")


def phase_main(device, tmp, cases):
    """Phases 3-5: the main count with each table, then with the two-level
    table under each split consolidation variant.  Returns {path: ({kernel:
    launches}, LaunchShapes)} for "main" (two-level), "main_one" and
    "main_<variant>" for each split variant, and (argv, the NumPy count's
    dump, its k-mers) for the mesh phases."""
    import numpy as np

    t0 = time.perf_counter()
    reads, argv = main_input(tmp)
    log({"phase": "main", "data": f"{MAIN_READS} reads x {MAIN_L} bp, {MAIN_GENOME}-base genome, "
         f"{MAIN_FILES} files", "setup_s": time.perf_counter() - t0})
    out = argv[-1].split("=", 1)[1]
    runs = {}
    want = None
    # Each main path's dump is formatted on the card: one record pack.
    plan = [("main", "main", "two", None, {K1["name"]: (2, None), SORT["name"]: (1, None), R1["name"]: (1, 1)}),
            ("main_one", "main_one", "one", None, {SORT["name"]: (2, None), R1["name"]: (1, 1)})]
    for variant in cases.SPLIT_VARIANTS:
        need = {cases.VARIANT_MERGE[variant]: (2, None), K2["name"]: (2, None), K1["name"]: (0, 0),
                R1["name"]: (1, 1)}
        plan.append((f"main_{variant}", "main_variants", "two", variant, need))
    for path, phase, impl, variant, need in plan:
        kw = cases.CONSOLIDATE_VARIANTS[variant] if variant else None
        wall, peak, launches, shapes, stats = run_main_path(device, argv, impl, kw)
        check_launches(path, launches, need)
        check_k8_launches(path, launches, stats.chunks)
        t0 = time.perf_counter()
        if want is None:
            words, counts = numpy_count(reads, MAIN_K, canonical=True)
            want, total = dump_bytes(words, counts), int(counts.sum(dtype=np.int64))
        check_dump(out, want, path)
        entry = {"phase": phase, "cmd": "python -m kmer_counter_tpu_torch " + " ".join(argv[:3])
                 + f" tableImpl={impl}", "wall_s": wall, "kmers": total, "kmers_per_s": total / wall,
                 "distinct_kmers": int(len(counts)), "launches": launches,
                 "launch_shapes": {k: v for k, v in shapes.shapes.items() if v},
                 "peak_device_bytes": peak, "gpu_memory_limit": MEMORY_LIMIT,
                 "byte_identical_to_numpy_count": True, "verify_s": time.perf_counter() - t0}
        if variant:
            entry = {"phase": phase, "variant": variant, "consolidate3": kw, **entry}
        log(entry)
        if peak > MEMORY_LIMIT:
            raise AssertionError(f"{path}: peak device memory {peak} bytes > gpuMemoryLimit {MEMORY_LIMIT}")
        runs[path] = (launches, shapes)
        os.unlink(out)
    return runs, (argv, want, total)


def spill_input(tmp):
    """The spill phases' reads, written as FASTQ files; returns (reads, the
    input directory)."""
    import numpy as np

    reads = sample_reads(np.random.default_rng(SEED + 1), SPILL_GENOME, SPILL_READS, MAIN_L, 0.001)
    in_dir = os.path.join(tmp, "spill_in")
    per = SPILL_READS // MAIN_FILES
    for f in range(MAIN_FILES):
        write_fastq(os.path.join(in_dir, f"reads_{f:02d}.fastq"), reads[f * per : (f + 1) * per])
    return reads, in_dir


class SpillRecorder:
    """While open, records each run file that io.spill.write_run writes
    (records and bytes) and each native merge (runs in, records out,
    seconds); merges run in the scheduler's threads too."""

    def __init__(self):
        from kmer_counter_tpu_torch.io import native, spill

        self.runs, self.merges = [], []
        self._patches = [(spill, "write_run", self._write_run), (native, "native_merge_runs", self._merge)]
        self._reals = {name: getattr(module, name) for module, name, _ in self._patches}

    def _write_run(self, path, lanes, counts):
        out = self._reals["write_run"](path, lanes, counts)
        self.runs.append({"file": os.path.basename(out), "records": int((counts > 0).sum()),
                          "bytes": os.path.getsize(out)})
        return out

    def _merge(self, paths, out_path, k):
        t0 = time.perf_counter()
        n = self._reals["native_merge_runs"](paths, out_path, k)
        self.merges.append({"runs_in": len(paths), "inputs": [os.path.basename(p) for p in paths],
                            "records_out": n, "s": time.perf_counter() - t0})
        return n

    def __enter__(self):
        for module, name, fn in self._patches:
            setattr(module, name, fn)
        return self

    def __exit__(self, *exc):
        for module, name, _ in self._patches:
            setattr(module, name, self._reals[name])


class Crash(Exception):
    """Raised by phase_spill's wrapper: the process dying after a snapshot."""


def phase_spill(device, tmp):
    """Phases 6-7: the CLI spills to disk under gpuMemoryLimit=2e9 with
    each table, then with each table a run with checkpoints stops after the
    snapshot of its first consolidation that follows a spill, and a second
    run resumes it.  Returns {path: ({kernel: launches}, LaunchShapes)} for
    "spill" (two-level), "spill_one", "resume" and "resume_one", and (the
    input directory, the NumPy count's dump, its k-mers) for the mesh's
    spill phases."""
    import json

    import numpy as np

    from kmer_counter_tpu_torch import engine
    from kmer_counter_tpu_torch.io import native

    if not native.available():
        raise RuntimeError("spill: the native merge library is not built (make -C native): the Python "
                           "heap merge would take tens of minutes over 10^8 records")
    t0 = time.perf_counter()
    reads, in_dir = spill_input(tmp)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    words, counts = numpy_count(reads, MAIN_K, canonical=True)
    want, distinct, total = dump_bytes(words, counts), len(counts), int(counts.sum(dtype=np.int64))
    del reads, words, counts
    log({"phase": "spill", "data": f"{SPILL_READS} reads x {MAIN_L} bp, {SPILL_GENOME}-base genome, "
         f"{MAIN_FILES} files", "reads": SPILL_READS, "genome_bases": SPILL_GENOME, "distinct_kmers": distinct,
         "kmers": total, "setup_s": setup_s, "numpy_count_s": time.perf_counter() - t0,
         "merge": "native (native/libkmer_io.so kc_merge_runs)"})
    out = os.path.join(tmp, "spill_out.bin")

    def argv(name, *extra):
        return [f"kmerLength={MAIN_K}", "canonical=true", f"gpuMemoryLimit={SPILL_LIMIT}",
                f"inputFileLocation={in_dir}", f"outputFile={out}",
                f"tempFileLocation={os.path.join(tmp, name + '_tmp')}", "noOfMergersAtOnce=2",
                "noOfMergeThreads=2", "verbose=0", *extra]

    def entry(phase, impl, wall, peak, launches, shapes, stats, rec):
        if not rec.merges:
            raise AssertionError(f"{phase}: no native merge ran")
        if peak > SPILL_LIMIT:
            raise AssertionError(f"{phase}: peak device memory {peak} bytes > gpuMemoryLimit {SPILL_LIMIT}")
        return {"phase": phase, "cmd": "python -m kmer_counter_tpu_torch " + " ".join(argv(phase)[:3])
                + f" tempFileLocation=... noOfMergersAtOnce=2 noOfMergeThreads=2 tableImpl={impl}",
                "wall_s": wall, "kmers_per_s": total / wall, "distinct_kmers": stats.distinct_kmers,
                "consolidations": stats.consolidations, "spilled_runs": stats.spilled_runs,
                "spill_runs_written": rec.runs, "native_merges": rec.merges, "timers_s": stats.metrics["timers_s"],
                "launches": launches, "launch_shapes": {k: v for k, v in shapes.shapes.items() if v},
                "peak_device_bytes": peak, "gpu_memory_limit": SPILL_LIMIT, "byte_identical_to_numpy_count": True}

    runs, chunks = {}, {}
    for path, impl, need in (("spill", "two", {K1["name"]: (2, None), SORT["name"]: (1, None)}),
                             ("spill_one", "one", {SORT["name"]: (2, None)})):
        with SpillRecorder() as rec:
            wall, peak, launches, shapes, stats = run_main_path(device, argv(path), impl)
        check_launches(path, launches, need)
        check_k8_launches(path, launches, stats.chunks)
        check_dump(out, want, path)
        log({**entry("spill", impl, wall, peak, launches, shapes, stats, rec), "path": path,
             "mid_run_spills": stats.spilled_runs - 1})
        if stats.spilled_runs - 1 < 2:
            raise AssertionError(f"{path}: {stats.spilled_runs - 1} mid-run spills (want >= 2)")
        runs[path], chunks[impl] = (launches, shapes), stats.chunks
        os.unlink(out)

    # The resume, with each table: the same count with a snapshot at every
    # consolidation, stopped, then run again with the same checkpointDir
    # and tempFileLocation.  The two-level run stops right after the first
    # snapshot that lists a spill run; the one-level run right after the
    # first spill that follows such a snapshot (a one-level snapshot is
    # taken before its consolidation's spill decision, so it holds the rows
    # that then spill).  What the resume skipped and re-registered is read
    # from the second run itself: the reads it counted (engine._absorb),
    # its chunks, the runs its merges read and the numbers of the runs it
    # wrote.
    import torch

    real = {name: getattr(engine.CountEngine, name) for name in ("_save_checkpoint", "_spill")}
    real_absorb = engine._absorb
    listed_a_run = []

    def save(self, stats, *args, **kw):
        real["_save_checkpoint"](self, stats, *args, **kw)
        if stats.spilled_runs:
            if self.opts.table_impl == "two":
                raise Crash
            listed_a_run.append(True)

    def spill(self, *args, **kw):
        real["_spill"](self, *args, **kw)
        if listed_a_run:
            raise Crash

    def run_number(name):
        return int(name.split("_")[1].split(".")[0]) if name.startswith(("spill_", "merge_")) else None

    for path, impl, need in (("resume", "two", {K1["name"]: (1, None), SORT["name"]: (1, None)}),
                             ("resume_one", "one", {SORT["name"]: (1, None)})):
        ck = os.path.join(tmp, path + "_ck")
        resume_argv = argv(path, f"checkpointDir={ck}", "checkpointEvery=1")
        engine.CountEngine._save_checkpoint, engine.CountEngine._spill = save, spill
        try:
            run_main_path(device, resume_argv, impl)
            raise AssertionError(f"{path}: the run that should stop after a spill ran to its end")
        except Crash:
            pass
        finally:
            for name, fn in real.items():
                setattr(engine.CountEngine, name, fn)
        torch.cuda.empty_cache()
        with open(os.path.join(ck, "checkpoint.json")) as fh:
            manifest = json.load(fh)
        counted = [0]

        def absorb(stats, chunk):
            counted[0] += chunk.n_reads
            real_absorb(stats, chunk)

        engine._absorb = absorb
        try:
            with SpillRecorder() as rec:
                wall, peak, launches, shapes, stats = run_main_path(device, resume_argv, impl)
        finally:
            engine._absorb = real_absorb
        check_launches(path, launches, need)
        check_k8_launches(path, launches, stats.chunks)
        check_dump(out, want, path)
        listed = sorted(os.path.basename(p) for p in manifest.get("spill_runs", []))
        merged = {name for m in rec.merges for name in m["inputs"]}
        reregistered = [name for name in listed if name in merged]
        new_numbers = [run_number(r["file"]) for r in rec.runs if run_number(r["file"]) is not None]
        skipped = SPILL_READS - counted[0]
        log({**entry("resume", impl, wall, peak, launches, shapes, stats, rec), "path": path,
             "reads_skipped": skipped, "snapshot_reads_absorbed": manifest["reads_absorbed"],
             "chunks": stats.chunks, "chunks_without_resume": chunks[impl], "snapshot_runs": listed,
             "runs_reregistered": reregistered, "first_new_run": rec.runs[0] if rec.runs else None,
             "snapshot_records": manifest["records"], "reads": stats.reads})
        if not 0 < skipped < SPILL_READS or skipped != manifest["reads_absorbed"]:
            raise AssertionError(f"{path}: counted {counted[0]} reads itself; the snapshot absorbed "
                                 f"{manifest['reads_absorbed']}")
        if not stats.chunks < chunks[impl] or stats.reads != SPILL_READS:
            raise AssertionError(f"{path}: {stats.chunks} chunks (without resume {chunks[impl]}), "
                                 f"{stats.reads} reads")
        if not listed or reregistered != listed:
            raise AssertionError(f"{path}: the snapshot lists {listed}; the merges read {sorted(merged)}")
        if not new_numbers or min(new_numbers) <= max(run_number(name) for name in listed):
            raise AssertionError(f"{path}: new runs {new_numbers} do not follow the snapshot's {listed}")
        if impl == "one" and rec.runs[0]["records"] != manifest["records"]:
            # The one-level snapshot holds the table before its spill
            # decision: resumed with room for a chunk it would pass the
            # cap, so the resume writes it out as a run first.
            raise AssertionError(f"{path}: the first run has {rec.runs[0]['records']} records, not the "
                                 f"snapshot's {manifest['records']}")
        runs[path] = (launches, shapes)
        os.unlink(out)
    return runs, (in_dir, want, total)


# The mesh phases: MESH_POSITIONS positions of the mesh engine on the one
# card, in one process, or in MESH_RANKS processes that share it over gloo.
MESH_POSITIONS, MESH_RANKS = 4, 2
# A rank's collectives give up after MESH_COLLECTIVE_TIMEOUT_S; the phase
# kills every rank once one fails or MESH_WORKER_TIMEOUT_S pass.
MESH_COLLECTIVE_TIMEOUT_S, MESH_WORKER_TIMEOUT_S = 120, 400


class RouteProbe:
    """While open, wraps parallel.pipeline.route_merge_local: the device
    memory allocated when each route starts, the peak inside it, its
    seconds and the rows each position received.  The peak statistics are
    reset at each route, so the run's peak is the larger of the peaks read
    there and the peak at the end (run_peak).  It also counts the sharded
    counters' steps (``steps``: each is one chunk step on every position
    of this process)."""

    active = False  # inside a route (LaunchShapes marks the sort's shapes there)

    def __init__(self, device):
        from kmer_counter_tpu_torch.parallel import pipeline

        self.device, self._pipeline, self._real = device, pipeline, pipeline.route_merge_local
        self.routes, self._peak_before = [], 0
        self.steps = 0
        self._counters = {cls: cls.step for cls in (pipeline.ShardedCounter, pipeline.ShardedCounter2)}

    def _step(self, real):
        def step(counter, reads):
            self.steps += 1
            return real(counter, reads)

        return step

    def _route(self, mesh, tables, plan):
        import torch

        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(self.device)
        self._peak_before = max(self._peak_before, torch.cuda.max_memory_allocated(self.device))
        torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.perf_counter()
        RouteProbe.active = True
        try:
            out = list(self._real(mesh, tables, plan))
        finally:
            RouteProbe.active = False
        torch.cuda.synchronize()
        sorts = sum(int(plan.round_rows(t)[:, p].sum() > 0) for t in range(plan.rounds) for p in mesh.positions)
        self.routes.append({"s": time.perf_counter() - t0, "NL": int(tables[0][0].shape[0]),
                            "positions": list(mesh.positions), "received_rows": plan.balance.tolist(),
                            "rounds": plan.rounds, "sorts": sorts,
                            "allocated_before": before, "peak": torch.cuda.max_memory_allocated(self.device)})
        return out

    def run_peak(self):
        import torch

        return max(self._peak_before, torch.cuda.max_memory_allocated(self.device))

    def route_entry(self):
        """The finalize's route (the last), with the bytes it added to what
        was allocated and the model's reckoning of them (budget.py: each
        position's received rows copied into one buffer, its sort_reduce,
        and the outputs of the positions before it)."""
        from kmer_counter_tpu_torch import budget as bg

        if not self.routes:
            return {}
        r = self.routes[-1]
        NL, rows = r["NL"], [r["received_rows"][p] for p in r["positions"]]
        out_bytes = 4 * (NL + 1)
        model = max(out_bytes * sum(rows[:i]) + bg.route_bytes_per_row(NL) * n for i, n in enumerate(rows))
        return {"route_s": r["s"], "received_rows": r["received_rows"], "route_rounds": r["rounds"],
                "route_allocated_before": r["allocated_before"],
                "route_peak_bytes": r["peak"], "route_added_bytes": r["peak"] - r["allocated_before"],
                "route_model_added_bytes": model, "routes": len(self.routes)}

    def route_launches(self):
        """Sort launches of the routes: one for each round of each position
        of this process that received rows in it."""
        return sum(r["sorts"] for r in self.routes)

    def __enter__(self):
        self._pipeline.route_merge_local = self._route
        for cls, real in self._counters.items():
            cls.step = self._step(real)
        return self

    def __exit__(self, *exc):
        self._pipeline.route_merge_local = self._real
        for cls, real in self._counters.items():
            cls.step = real


def run_mesh_path(device, argv, mesh):
    """One run of the mesh engine: engine.run_count with the CLI's options
    (Options.from_argv) on ``mesh``.  The launch counts are set to 0 just
    before it and read just after.  Returns (wall s, peak device bytes,
    {kernel: launches}, LaunchShapes, RunStats, RouteProbe)."""
    import torch

    from kmer_counter_tpu_torch import engine
    from kmer_counter_tpu_torch.config import Options

    opts = Options.from_argv(argv)
    with LaunchShapes() as shapes, RouteProbe(device) as probe:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        reset_launch_counts()
        t0 = time.perf_counter()
        stats = engine.run_count(opts, device, mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        peak = probe.run_peak()
    return wall, peak, launches, shapes, stats, probe


def check_mesh_launches(path, impl, launches, position_consolidations, route_launches, positions, chunks, steps):
    """K1 once for each consolidation of each position (two-level), the
    sort once for each (one-level) and once for each position a route
    gave rows to; K8 once for each chunk on each position (the ranks of
    mesh_mp read shards of equal size, so no rank steps on after its
    input ends: one step a chunk)."""
    if steps != chunks:
        raise AssertionError(f"{path}: {steps} steps of the sharded counter for {chunks} chunks")
    check_k8_launches(path, launches, chunks, positions)
    pc = position_consolidations
    if pc < positions:
        raise AssertionError(f"{path}: {pc} position consolidations (want >= {positions})")
    want_k1, want_sort = (pc, route_launches) if impl == "two" else (0, pc + route_launches)
    if launches[K1["name"]] != want_k1 or launches[SORT["name"]] != want_sort:
        raise AssertionError(f"{path}: K1 launched {launches[K1['name']]} times (want {want_k1}), the sort "
                             f"{launches[SORT['name']]} (want {want_sort})")


def phase_mesh(device, tmp, main_ctx):
    """Phase 12: the main count on a mesh of MESH_POSITIONS positions that
    share the card, with each table ("mesh", "mesh_one").  Returns {path:
    ({kernel: launches}, LaunchShapes)}."""
    import torch

    from kmer_counter_tpu_torch.parallel.mesh import make_mesh

    argv, want, total = main_ctx
    out = argv[-1].split("=", 1)[1]
    runs = {}
    for path, impl in (("mesh", "two"), ("mesh_one", "one")):
        mesh = make_mesh(devices=[device] * MESH_POSITIONS)
        wall, peak, launches, shapes, stats, probe = run_mesh_path(
            device, argv + [f"tableImpl={impl}", "verbose=0"], mesh)
        check_dump(out, want, path)
        pc = stats.metrics["counters"]["position_consolidations"]
        check_mesh_launches(path, impl, launches, pc, probe.route_launches(), MESH_POSITIONS, stats.chunks,
                            probe.steps)
        log({"phase": "mesh", "path": path, "positions": MESH_POSITIONS, "position_devices": str(device),
             "cmd": "engine.run_count(Options.from_argv([" + " ".join(argv[:3]) + f" tableImpl={impl}]), "
             f"mesh=make_mesh(devices=[cuda]*{MESH_POSITIONS}))", "wall_s": wall, "kmers_per_s": total / wall,
             "distinct_kmers": stats.distinct_kmers, "consolidations": stats.consolidations,
             "position_consolidations": pc, "launches": launches,
             "launch_shapes": {k: v for k, v in shapes.shapes.items() if v}, **probe.route_entry(),
             "timers_s": stats.metrics["timers_s"], "peak_device_bytes": peak, "gpu_memory_limit": MEMORY_LIMIT,
             "byte_identical_to_numpy_count": True})
        if peak > MEMORY_LIMIT:
            raise AssertionError(f"{path}: peak device memory {peak} bytes > gpuMemoryLimit {MEMORY_LIMIT}")
        runs[path] = (launches, shapes)
        os.unlink(out)
        del mesh
        torch.cuda.empty_cache()
    return runs


class WorkerShapes:
    """The launch shapes a mesh worker reported, as LaunchShapes holds them."""

    def __init__(self, reports):
        self.shapes = {name: [] for name in KERNEL_NAMES}
        for report in reports:
            for name, shapes in report["launch_shapes"].items():
                self.shapes[name] += [tuple(s) for s in shapes]


def mesh_worker(rank, world, store, runs):
    """One rank of phase 13 (``chip_smoke.py --mesh-worker RANK WORLD STORE
    RUNS_JSON``): a gloo process group over the FileStore STORE, a mesh of
    MESH_POSITIONS / WORLD positions on cuda:0, and one run of the mesh
    engine for each [path, argv] of RUNS_JSON, in order; prints each run's
    report as one JSON line."""
    import datetime

    import torch
    import torch.distributed as dist

    from kmer_counter_tpu_torch.parallel.mesh import make_mesh

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py --mesh-worker: CUDA is not available")
    device = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=MESH_COLLECTIVE_TIMEOUT_S))
    try:
        for path, argv in runs:
            mesh = make_mesh(devices=[device] * (MESH_POSITIONS // world))
            wall, peak, launches, shapes, stats, probe = run_mesh_path(device, argv, mesh)
            log({"mesh_worker": rank, "path": path, "positions": mesh.positions, "wall_s": wall,
                 "peak_device_bytes": peak, "launches": launches,
                 "launch_shapes": {k: v for k, v in shapes.shapes.items() if v},
                 "position_consolidations": stats.metrics["counters"]["position_consolidations"],
                 "route_launches": probe.route_launches(), "chunks": stats.chunks, "steps": probe.steps,
                 **probe.route_entry(),
                 "distinct_kmers": stats.distinct_kmers, "reads": stats.reads, "timers_s": stats.metrics["timers_s"]})
            del probe, stats
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


def phase_mesh_mp(device, tmp, main_ctx):
    """Phase 13: the main count in MESH_RANKS processes that share the card
    (gloo: NCCL takes one rank a device), each owning MESH_POSITIONS /
    MESH_RANKS positions, with each table ("mesh_mp", "mesh_mp_one"; one
    launch of the ranks runs both, in turn): the part files in name order
    are the NumPy count's dump.  Returns {path: ({kernel: launches},
    WorkerShapes)}, launches summed over the ranks."""
    argv, want, total = main_ctx
    d = os.path.join(tmp, "mesh_mp")
    os.makedirs(d)
    paths = (("mesh_mp", "two"), ("mesh_mp_one", "one"))
    work = [[path, [a for a in argv if not a.startswith("outputFile=")] + [
        f"outputFile={os.path.join(d, f'out_{impl}.bin')}", f"tableImpl={impl}", "verbose=0"]] for path, impl in paths]
    store = os.path.join(d, "store")
    t0 = time.perf_counter()
    logs = [(open(os.path.join(d, f"rank{r}.out"), "w+"), open(os.path.join(d, f"rank{r}.err"), "w+"))
            for r in range(MESH_RANKS)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mesh-worker", str(rank),
                               str(MESH_RANKS), store, json.dumps(work)],
                              stdout=logs[rank][0], stderr=logs[rank][1], text=True, cwd=HERE)
             for rank in range(MESH_RANKS)]
    try:
        # Wait for every rank; stop at the first that fails, or at the deadline.
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.perf_counter() - t0 > MESH_WORKER_TIMEOUT_S:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    reports = []
    for rank, (p, (out_fh, err_fh)) in enumerate(zip(procs, logs)):
        out_fh.seek(0)
        err_fh.seek(0)
        stdout, stderr = out_fh.read(), err_fh.read()
        out_fh.close()
        err_fh.close()
        if p.returncode != 0:
            raise AssertionError(f"mesh_mp: rank {rank} exited {p.returncode}:\n{stderr[-4000:]}")
        reports += [json.loads(line) for line in stdout.splitlines() if line.startswith('{"mesh_worker"')]
    launch_s = time.perf_counter() - t0
    runs = {}
    for path, impl in paths:
        mine = [r for r in reports if r["path"] == path]
        if len(mine) != MESH_RANKS:
            raise AssertionError(f"{path}: {len(mine)} rank reports (want {MESH_RANKS})")
        parts = sorted(f for f in os.listdir(d) if f.startswith(f"out_{impl}.bin.part"))
        manifests = sorted(f for f in os.listdir(d) if f.startswith(f"out_{impl}.bin.manifest."))
        if parts != [f"out_{impl}.bin.part{p:05d}" for p in range(MESH_POSITIONS)] or len(manifests) != MESH_RANKS:
            raise AssertionError(f"{path}: parts {parts}, manifests {manifests}")
        data = b"".join(open(os.path.join(d, f), "rb").read() for f in parts)
        if data != want:
            raise AssertionError(f"{path}: the parts in name order differ from the independent NumPy count")
        for r in mine:
            check_mesh_launches(f"{path} rank {r['mesh_worker']}", impl, r["launches"], r["position_consolidations"],
                                r["route_launches"], MESH_POSITIONS // MESH_RANKS, r["chunks"], r["steps"])
        launches = {name: sum(r["launches"][name] for r in mine) for name in mine[0]["launches"]}
        peaks = [r["peak_device_bytes"] for r in mine]
        wall = max(r["wall_s"] for r in mine)
        log({"phase": "mesh_mp", "path": path, "ranks": MESH_RANKS, "positions": MESH_POSITIONS,
             "process_group": "gloo (FileStore)", "position_devices": str(device), "wall_s": wall,
             "kmers_per_s": total / wall, "ranks_launch_s": launch_s, "parts": parts, "manifests": manifests,
             "launches": launches, "ranks_reports": mine, "peak_device_bytes_by_rank": peaks,
             "gpu_memory_limit": MEMORY_LIMIT, "byte_identical_to_numpy_count": True})
        if sum(peaks) > MEMORY_LIMIT:
            raise AssertionError(f"{path}: peak device memory {peaks} bytes (summed over the ranks) > "
                                 f"gpuMemoryLimit {MEMORY_LIMIT}")
        runs[path] = (launches, WorkerShapes(mine))
        for f in parts + manifests:
            os.unlink(os.path.join(d, f))
    return runs


def phase_mesh_spill(device, tmp, spill_ctx):
    """Phases 14-15: the spill phase's count (gpuMemoryLimit=2e9) on a mesh
    of MESH_POSITIONS positions on the card, two-level ("mesh_spill"): the
    positions spill their prefixes as runs over the whole key space, and
    the host merges them; then the same with checkpointDir and
    checkpointEvery=1, stopped right after the first snapshot that lists a
    spill run, and resumed with no further snapshots ("mesh_resume").
    Returns {path: ({kernel: launches}, LaunchShapes)}."""
    import glob

    import torch

    from kmer_counter_tpu_torch import engine
    from kmer_counter_tpu_torch.parallel.mesh import make_mesh

    in_dir, want, total = spill_ctx
    out = os.path.join(tmp, "mesh_spill_out.bin")

    def argv(name, *extra):
        return [f"kmerLength={MAIN_K}", "canonical=true", f"gpuMemoryLimit={SPILL_LIMIT}",
                f"inputFileLocation={in_dir}", f"outputFile={out}",
                f"tempFileLocation={os.path.join(tmp, name + '_tmp')}", "noOfMergersAtOnce=4",
                "noOfMergeThreads=4", "tableImpl=two", "verbose=0", *extra]

    def entry(path, wall, peak, launches, shapes, stats, probe, rec):
        pc = stats.metrics["counters"]["position_consolidations"]
        check_mesh_launches(path, "two", launches, pc, 0, MESH_POSITIONS, stats.chunks, probe.steps)
        if not rec.merges:
            raise AssertionError(f"{path}: no native merge ran")
        if peak > SPILL_LIMIT:
            raise AssertionError(f"{path}: peak device memory {peak} bytes > gpuMemoryLimit {SPILL_LIMIT}")
        return {"phase": path, "positions": MESH_POSITIONS, "position_devices": str(device),
                "cmd": "engine.run_count(Options.from_argv([" + " ".join(argv(path)[:3])
                + " tempFileLocation=... noOfMergersAtOnce=4 noOfMergeThreads=4 tableImpl=two]), "
                f"mesh=make_mesh(devices=[cuda]*{MESH_POSITIONS}))", "wall_s": wall, "kmers_per_s": total / wall,
                "distinct_kmers": stats.distinct_kmers, "consolidations": stats.consolidations,
                "position_consolidations": pc, "spilled_runs": stats.spilled_runs, "spill_runs_written": rec.runs,
                "native_merges": rec.merges, "timers_s": stats.metrics["timers_s"], "launches": launches,
                "launch_shapes": {k: v for k, v in shapes.shapes.items() if v}, "peak_device_bytes": peak,
                "gpu_memory_limit": SPILL_LIMIT, "byte_identical_to_numpy_count": True}

    runs = {}
    with SpillRecorder() as rec:
        wall, peak, launches, shapes, stats, probe = run_mesh_path(
            device, argv("mesh_spill"), make_mesh(devices=[device] * MESH_POSITIONS))
    check_dump(out, want, "mesh_spill")
    mid_run = len(rec.runs) - MESH_POSITIONS  # the last MESH_POSITIONS runs are the final tables
    log({**entry("mesh_spill", wall, peak, launches, shapes, stats, probe, rec), "mid_run_spill_runs": mid_run})
    if mid_run < 2 * MESH_POSITIONS:
        raise AssertionError(f"mesh_spill: {mid_run} runs spilled mid-run (want >= {2 * MESH_POSITIONS})")
    runs["mesh_spill"] = (launches, shapes)
    os.unlink(out)
    torch.cuda.empty_cache()

    ck = os.path.join(tmp, "mesh_resume_ck")
    resume_argv = argv("mesh_resume", f"checkpointDir={ck}", "checkpointEvery=1")
    # The resumed run reads the snapshot and takes no more of them.
    resumed_argv = argv("mesh_resume", f"checkpointDir={ck}", "checkpointEvery=0")
    real_save, real_absorb = engine.MeshCountEngine._save_mesh_checkpoint, engine._absorb

    def save(self, counter, stats_):
        real_save(self, counter, stats_)
        if self._scheduler is not None and self._scheduler.snapshot_runs():
            raise Crash

    engine.MeshCountEngine._save_mesh_checkpoint = save
    try:
        run_mesh_path(device, resume_argv, make_mesh(devices=[device] * MESH_POSITIONS))
        raise AssertionError("mesh_resume: the run that should stop after a snapshot ran to its end")
    except Crash:
        pass
    finally:
        engine.MeshCountEngine._save_mesh_checkpoint = real_save
    torch.cuda.empty_cache()
    with open(sorted(glob.glob(os.path.join(ck, "mesh.e*.p000.json")))[-1]) as fh:
        manifest = json.load(fh)
    counted = [0]

    def absorb(stats_, chunk):
        counted[0] += chunk.n_reads
        real_absorb(stats_, chunk)

    engine._absorb = absorb
    try:
        with SpillRecorder() as rec:
            wall, peak, launches, shapes, stats, probe = run_mesh_path(
                device, resumed_argv, make_mesh(devices=[device] * MESH_POSITIONS))
    finally:
        engine._absorb = real_absorb
    check_dump(out, want, "mesh_resume")
    listed = sorted(os.path.basename(p) for p in manifest.get("scheduler_runs", {}))
    merged = {name for m in rec.merges for name in m["inputs"]}
    new_numbers = [int(r["file"].split("_")[1].split(".")[0]) for r in rec.runs]
    skipped = SPILL_READS - counted[0]
    log({**entry("mesh_resume", wall, peak, launches, shapes, stats, probe, rec), "snapshot_epoch": manifest["epoch"],
         "reads_skipped": skipped, "snapshot_reads_absorbed": manifest["reads_absorbed"], "chunks": stats.chunks,
         "snapshot_runs": listed, "reads": stats.reads})
    if not 0 < skipped < SPILL_READS or skipped != manifest["reads_absorbed"] or stats.reads != SPILL_READS:
        raise AssertionError(f"mesh_resume: counted {counted[0]} reads itself; the snapshot absorbed "
                             f"{manifest['reads_absorbed']}")
    if not listed or not set(listed) <= merged:
        raise AssertionError(f"mesh_resume: the snapshot lists {listed}; the merges read {sorted(merged)}")
    if not new_numbers or min(new_numbers) <= max(int(n.split("_")[1].split(".")[0]) for n in listed):
        raise AssertionError(f"mesh_resume: new runs {new_numbers} do not follow the snapshot's {listed}")
    runs["mesh_resume"] = (launches, shapes)
    os.unlink(out)
    return runs


def phase_profile_flag(tmp):
    """Phase 11: a small two-level CLI run with profile=true writes its
    torch.profiler trace next to the output, and the trace names K1's, the
    sort's and K8's kernels; it logs K8's launches in the trace beside the
    run's chunks.  It runs after every count of the process (see
    TRACE_MARGIN)."""
    import json

    import numpy as np

    from kmer_counter_tpu_torch import Options
    from kmer_counter_tpu_torch.__main__ import main
    from kmer_counter_tpu_torch.engine import plan_chunks

    k = MAIN_K
    reads = sample_reads(np.random.default_rng(7), 30_000, 2_000, 150, 0.005)
    d = os.path.join(tmp, "profile_flag")
    write_fastq(os.path.join(d, "in", "a.fastq"), reads)
    out = os.path.join(d, "out.bin")
    argv = [f"kmerLength={k}", "canonical=true", "tableImpl=two", f"inputFileLocation={d}/in",
            f"outputFile={out}", "tableSlots=40000", "profile=true", "verbose=0"]
    chunks = -(-len(reads) // plan_chunks(Options.from_argv(argv), reads.shape[1])[0])
    rc = main(argv)
    if rc != 0:
        raise AssertionError(f"profile=true run: rc={rc}")
    check_dump(out, dump_bytes(*numpy_count(reads, k, True)), "profile=true run")
    trace = os.path.join(out + ".trace", "trace.json")
    with open(trace) as fh:
        events = json.load(fh)["traceEvents"]
    found = {name: sum(name in e.get("name", "") for e in events)
             for name in ("fold_kernel", "leaf_kernel", "extract_kernel")}
    k8 = sum(e.get("cat") == "kernel" and K8_KERNEL_NAME in e.get("name", "") for e in events)
    log({"phase": "profile", "profile_flag": True, "trace": os.path.relpath(trace, tmp),
         "trace_bytes": os.path.getsize(trace), "events": len(events), "kernel_events": found,
         "chunks": chunks, "k8_launches_in_trace": k8, "byte_identical_to_numpy_count": True})
    if not all(found.values()):
        raise AssertionError(f"profile=true: the trace lacks a kernel: {found}")


# ---- the chunk feed ----------------------------------------------------------

H2D_PINNED = "Memcpy HtoD (Pinned -> Device)"


def phase_feed(device, tmp, main_ctx):
    """Phase 17: the two-level main count through engine.run_count under
    torch.profiler, its Chrome trace read back: one pinned host-to-device
    copy of the chunk's bytes (reads_per_chunk x line length: a short chunk
    is padded in its slot) a chunk, on no stream that ran K8, and no
    pageable one of a chunk's size.  Logs the timers, every host-to-device
    copy by kind and the device's busy share first."""
    import torch

    from kmer_counter_tpu_torch import Options
    from kmer_counter_tpu_torch.engine import plan_chunks, run_count

    argv, want, _ = main_ctx
    opts = Options.from_argv(argv + ["tableImpl=two", "verbose=0"])
    chunk_bytes = plan_chunks(opts, MAIN_L)[0] * MAIN_L

    def run():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        return run_count(opts, device)

    stats, prof = traced(run)
    peak = torch.cuda.max_memory_allocated(device)
    check_dump(opts.output_file, want, "feed")
    os.unlink(opts.output_file)
    trace = os.path.join(tmp, "feed_trace.json")
    prof.export_chrome_trace(trace)
    with open(trace) as fh:
        events = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"]
    os.unlink(trace)
    events = [e for e in events if "spin_kernel" not in e["name"]]
    h2d = [e for e in events if e.get("cat") == "gpu_memcpy" and "HtoD" in e["name"]]
    chunk_copies = [e for e in h2d if e["name"] == H2D_PINNED and e["args"].get("bytes") == chunk_bytes]
    k8_streams = sorted({e["args"].get("stream") for e in events
                         if e.get("cat") == "kernel" and K8_KERNEL_NAME in e["name"]})
    busy_s = union_length([(e["ts"], e["ts"] + e["dur"]) for e in events
                           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]) / 1e6
    kinds = Counter((e["name"], e["args"].get("bytes")) for e in h2d)
    log({"phase": "feed", "wall_s": stats.wall_seconds, "chunks": stats.chunks, "chunk_bytes": chunk_bytes,
         "timers_s": stats.metrics["timers_s"], "timer_calls": stats.metrics["timer_calls"],
         "device_busy_s": busy_s, "device_busy_share": busy_s / stats.wall_seconds,
         "h2d_device_ms": sum(e["dur"] for e in h2d) / 1e3,
         "h2d_copies": [{"name": name, "bytes": nbytes, "count": n} for (name, nbytes), n in sorted(
             kinds.items(), key=lambda kv: (kv[0][0], kv[0][1] or 0))],
         "chunk_copy_streams": sorted({e["args"].get("stream") for e in chunk_copies}), "k8_streams": k8_streams,
         "chunk_copy_device_ms": sum(e["dur"] for e in chunk_copies) / 1e3,
         "peak_device_bytes": peak, "gpu_memory_limit": MEMORY_LIMIT})
    if len(chunk_copies) != stats.chunks or stats.chunks < 2:
        raise AssertionError(f"feed: {len(chunk_copies)} pinned copies of {chunk_bytes} bytes for "
                             f"{stats.chunks} chunks")
    if not k8_streams or any(e["args"].get("stream") in k8_streams for e in chunk_copies):
        raise AssertionError(f"feed: a chunk copy ran on K8's stream {k8_streams}")
    pageable = [e for e in h2d if "Pageable" in e["name"] and (e["args"].get("bytes") or 0) >= chunk_bytes]
    if pageable:
        raise AssertionError(f"feed: {len(pageable)} pageable host-to-device copies of a chunk's size")
    if peak > MEMORY_LIMIT:
        raise AssertionError(f"feed: peak device memory {peak} bytes > gpuMemoryLimit {MEMORY_LIMIT}")
    log({"phase": "feed", "pinned_chunk_copies": len(chunk_copies), "on_a_stream_without_k8": True,
         "pageable_chunk_copies": 0, "byte_identical_to_numpy_count": True})


# ---- K8, the chunk step ------------------------------------------------------

# The main path's K8 launch: one chunk of the main count, two-level (keys
# into the raw region), as its launch_shapes log it: (R, L, k, canonical, mode).
MAIN_K8_LAUNCH = (396_825, MAIN_L, MAIN_K, True, "keys")
# Reads a random K8 shape takes, and (R, L) of reads that K8 cuts along the
# row: longer than three of its tiles (3952 window starts a block).
K8_RANDOM_READS = 20_000
K8_LONG = (4, 3 * 4096 + 5)


@functools.lru_cache(maxsize=None)
def _genome(n):
    import numpy as np

    return np.random.default_rng(SEED + 2).choice(np.frombuffer(b"ACGT", np.uint8), size=n)


def path_reads(path, R, L, device):
    """R reads x L bp sampled as ``path`` samples them (the spill paths from
    the 200-Mbase genome, the others from the 4.6-Mbase one), contiguous on
    device."""
    import numpy as np
    import torch

    n = SPILL_GENOME if path.startswith(("spill", "resume", "mesh_spill", "mesh_resume")) else MAIN_GENOME
    reads = sample_reads(np.random.default_rng(SEED + 3), n, R, L, 0.001, genome=_genome(n))
    return torch.from_numpy(reads).to(device)


def k8_bound(R, L, k, canonical, mode):
    """K8's least time: the reads read once and each window's lanes (records:
    and its validity) written once; about 8 integer operations a base to
    encode it, 8 a window and lane (20 with the reverse complement) and 8 a
    window for its validity."""
    from kmer_counter_tpu_torch.records import active_lanes

    NL, n = active_lanes(k), R * (L - k + 1)
    return bound(R * L + 4 * (NL + (mode == "records")) * n,
                 8 * R * L + n * (NL * (20 if canonical else 8) + 8))


def compare_k8(reads, k, canonical, mode, time_it, off=0, trace=True):
    """K8 vs plain in one mode ("records" or "keys") on reads on the card:
    bit-exact or raise.  Keys mode writes at column ``off`` of a region 5
    columns wider, whose other columns must keep their fill, and adds the
    all-T count to a tensor; its plain version is the wrapper's CPU branch
    (the plain keys, their copy into the region, the count's add).  Returns
    the timing dict (times None unless time_it; the traced device time
    when trace); no PyTorch call computes K8's function, so library_ms is
    None."""
    import torch

    from kmer_counter_tpu_torch.ops import fused_extract as fx
    from kmer_counter_tpu_torch.ops.u32 import widen
    from kmer_counter_tpu_torch.records import active_lanes

    R, L = reads.shape
    NL, n = active_lanes(k), R * (L - k + 1)
    what = f"K8 kernel disagrees with plain: R={R} L={L} k={k} canonical={canonical} mode={mode} off={off}"
    if mode == "records":
        def kernel():
            return fx.extract_chunk_lanes_major(reads, k, canonical)

        def plain():
            return fx.extract_chunk_lanes_major_reference(reads, k, canonical)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
    else:
        fill = 0x5A5A5A5A
        dst, dst_plain = (torch.full((NL, off + n + 5), fill, dtype=torch.int32, device=reads.device)
                          for _ in range(2))
        allt, allt_plain = (torch.zeros((), dtype=torch.int64, device=reads.device) for _ in range(2))

        def kernel():
            fx.extract_chunk_keys_into(reads, k, canonical, dst, off, allt)

        def plain():
            lanes, count = fx.extract_chunk_keys_reference(reads, k, canonical)
            dst_plain[:, off : off + n] = lanes
            allt_plain.add_(count)

        kernel()
        plain()
        torch.cuda.synchronize()
        got, want = dst[:, off : off + n], dst_plain[:, off : off + n]
        if int(allt) != int(allt_plain) or not ((dst[:, :off] == fill).all() and (dst[:, off + n :] == fill).all()):
            raise AssertionError(f"{what}: all-T count {int(allt)} vs {int(allt_plain)}, or a column outside "
                                 f"the chunk's was written")
    err = int((widen(got) - widen(want)).abs().max()) if got.numel() else 0
    if not torch.equal(got, want):
        raise AssertionError(f"{what}, max_abs_err {err}")
    del got, want
    cost = k8_bound(R, L, k, canonical, mode)
    if not time_it:
        return timing(err, None, None, cost)
    ms, plain_ms, _ = in_turns(kernel, plain)
    out = timing(err, ms, plain_ms, cost)
    return {**out, "device_kernels": traced_kernels(kernel)} if trace else out


def k8_random_shapes(device, cases):
    """K8 vs plain, timed, in both modes at each k of the gpu tests'
    EXTRACT_KS, canonical or not, L in k, k+1, 100, 151 (K8_RANDOM_READS
    reads), and on reads longer than a tile (K8_LONG) at k = 31 and 127:
    reads from the 4.6-Mbase genome with a tenth of a percent N and, in
    each shape's first reads, lower case and all-T reads.  The traced
    device time at L = 151 and on the long reads.  Returns the largest error."""
    import torch

    max_err = 0
    shapes = [(K8_RANDOM_READS, L, k) for k in cases.EXTRACT_KS for L in sorted({k, k + 1, 100, 151}) if L >= k]
    shapes += [(*K8_LONG, k) for k in (31, 127)]
    for R, L, k in shapes:
        reads = path_reads("main", R, L, device)
        head = reads[: R // 50]
        head += 32 * ((head >= ord("A")) & (head <= ord("Z"))).to(torch.uint8)
        reads[R // 50 : R // 50 + 3] = ord("T")
        for canonical in (False, True):
            for mode in ("keys", "records"):
                t = compare_k8(reads, k, canonical, mode, time_it=True, trace=L == 151 or L == K8_LONG[1])
                max_err = max(max_err, t["max_abs_err"])
                log({"phase": "kernel", "kernel": K8["name"], "R": R, "L": L, "k": k, "canonical": canonical,
                     "mode": mode, "bit_exact": True, **t})
        del reads
    return max_err


def phase_k8_kernel(device, cases, shapes_by_path):
    """K8 vs plain: k8_random_shapes, the edge cases of tests/test_torch_cuda.py
    (EXTRACT_CASES: lower case, N, zero-padded rows, all-T reads, raw_off,
    R = 1, R one past the tile, reads longer than the tile, misaligned
    reads, blocks that begin in a read's tail or start no window, reads
    just below and at the tile, keys at each column mod 4) in both modes, and each (R, L, k, canonical, mode) that a path
    launched, on reads sampled as that path samples them.  Returns
    per_path_totals's dict."""
    import numpy as np

    max_err = k8_random_shapes(device, cases)
    for name, build in sorted(cases.EXTRACT_CASES.items()):
        case = build(np.random.default_rng(SEED))
        reads = cases.extract_reads_on(case["reads"], device, case["start"])
        for mode in ("keys", "records"):
            t = compare_k8(reads, case["k"], case["canonical"], mode, time_it=False, off=case["off"])
            max_err = max(max_err, t["max_abs_err"])
        log({"phase": "kernel", "kernel": K8["name"], "edge_case": name, "R": reads.shape[0], "L": reads.shape[1],
             "k": case["k"], "canonical": case["canonical"], "start": case["start"], "off": case["off"],
             "bit_exact": True})

    def at_shape(path, shape):
        R, L, k, canonical, mode = shape
        t = compare_k8(path_reads(path, R, L, device), k, canonical, mode, time_it=True)
        log({"phase": "kernel", "kernel": K8["name"], "path": path, "main_path_launch_shape": True, "R": R, "L": L,
             "k": k, "canonical": canonical, "mode": mode, "bit_exact": True, **t})
        return t

    return per_path_totals(shapes_by_path, at_shape, max_err)


def time_chunk_step(device, reps=10):
    """The two-level chunk step of the package on sys.path
    (ops.pipeline.count_step_two_level) at the main path's chunk
    (MAIN_K8_LAUNCH, its reads sampled as the main path samples them) into
    a raw region of the main path's width: CUDA-event ms a step (reps steps,
    twice) and each CUDA kernel's device time and launches in one traced
    step, with their sum.  A tree before K8 runs the plain torch chain."""
    from types import SimpleNamespace

    import torch

    from kmer_counter_tpu_torch.ops import pipeline
    from kmer_counter_tpu_torch.records import active_lanes

    R, L, k, canonical, _ = MAIN_K8_LAUNCH
    reads = path_reads("main", R, L, device)
    raw_slots = 97_222_223  # the main path's raw region
    table = SimpleNamespace(raw_lanes=torch.empty((active_lanes(k), raw_slots), dtype=torch.int32, device=device),
                            raw_off=0, allt=torch.zeros((), dtype=torch.int64, device=device))

    def step():
        table.raw_off = 0
        pipeline.count_step_two_level(table, reads, k, canonical)

    ms = [cuda_ms(step, reps), cuda_ms(step, reps)]
    kernels = traced_kernels(step)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    held = torch.cuda.memory_allocated(device)
    step()
    torch.cuda.synchronize()
    log({"chunk_step": "count_step_two_level", "R": R, "L": L, "k": k, "canonical": canonical, "ms": ms,
         "device_ms": sum(v["ms"] for v in kernels.values()), "device_launches": sum(v["launches"] for v in
                                                                                   kernels.values()),
         "device_kernels": kernels, "held_bytes": held,
         "peak_above_held_bytes": torch.cuda.max_memory_allocated(device) - held})


# ---- D1-D7: the probe harnesses and their kernels --------------------------------


class ProbeShapes:
    """Records the shape of each call of the probe wrappers (ops.probes)
    while a harness runs, under the D-id it computes: (G, Ta, Tb, B
    descending) for pair_merge (D2 with G = 1 and D3 with G > 1, B
    descending; D7 B ascending), (mode, n_ops, n) for tile_compact (D1) and
    (R, W, starts, rows, shift) for row_gather (D4 rolls by a negative
    shift, D5 by a positive one, D6 gathers windows)."""

    def __init__(self):
        from kmer_counter_tpu_torch.ops import probes

        self._probes = probes
        self.shapes = {d: [] for d in PROBE_SPECS}
        self._reals = {name: getattr(probes, name) for name in PROBE_WRAPPERS}

    def _pair_merge(self, a, b, *, b_descending):
        d = "D7" if not b_descending else ("D2" if a.shape[0] == 1 else "D3")
        self.shapes[d].append((a.shape[0], a.shape[1], b.shape[1], bool(b_descending)))
        return self._reals["pair_merge"](a, b, b_descending=b_descending)

    def _tile_compact(self, ops, live, mode):
        self.shapes["D1"].append((mode, len(ops), live.numel()))
        return self._reals["tile_compact"](ops, live, mode)

    def _row_gather(self, x, starts, rows, shift):
        d = "D6" if starts.numel() > 1 or shift == 0 else ("D4" if shift < 0 else "D5")
        self.shapes[d].append((*x.shape, tuple(starts.tolist()), rows, shift))
        return self._reals["row_gather"](x, starts, rows, shift)

    def __enter__(self):
        for name in PROBE_WRAPPERS:
            setattr(self._probes, name, getattr(self, f"_{name}"))
        return self

    def __exit__(self, *exc):
        for name, fn in self._reals.items():
            setattr(self._probes, name, fn)


def run_probe_harness(device, harness):
    """One harness's main() on the card (kmer_counter_tpu_torch.probes.<harness>),
    traced: the wrappers' launch counts set to 0 just before it and read
    just after, its launch shapes by D-id, and each CUDA kernel's launches
    in the trace; the three must agree.  Returns (launches by D-id,
    ProbeShapes)."""
    import importlib

    import torch

    from kmer_counter_tpu_torch.ops import probes

    module = importlib.import_module(f"kmer_counter_tpu_torch.probes.{harness}")
    with ProbeShapes() as rec:

        def run():  # again from 0 if the trace is taken again
            for name in probes.launches:
                probes.launches[name] = 0
            for shapes in rec.shapes.values():
                shapes.clear()
            module.main(device)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kernels = traced_kernels(run)
        wall = time.perf_counter() - t0
        counts = dict(probes.launches)
    traced = {w: sum(v["launches"] for k, v in kernels.items() if k.startswith(f"{w}_kernel")) for w in counts}
    recorded = {w: sum(len(rec.shapes[d]) for d, spec in PROBE_SPECS.items() if spec["wrapper"] == w)
                for w in counts}
    if not counts == traced == recorded:
        raise AssertionError(f"{harness}: launches by the wrappers' counts {counts}, in the trace {traced}, "
                             f"by the recorded calls {recorded}")
    by_d = {d: len(shapes) for d, shapes in rec.shapes.items() if shapes}
    log({"phase": "probes", "harness": harness, "wall_s": wall, "launches": counts, "traced_launches": traced,
         "launches_by_probe": by_d})
    return by_d, rec


def probe_at_shape(d, shape, device):
    """D-id d at one launch shape of its harness: kernel against plain
    (bit-exact, or raise) and against the probe's NumPy check, timed in
    turns with its plain version and library call, and traced; the bound
    counts each input byte read once and each output byte written once
    (D1 network: the flags, the live rows of the operands, the output)."""
    import numpy as np
    import torch

    from kmer_counter_tpu_torch.ops import probes
    from kmer_counter_tpu_torch.ops.u32 import from_numpy, to_numpy, widen
    from kmer_counter_tpu_torch.probes import probe_compact_overhead as pco

    wrapper = PROBE_SPECS[d]["wrapper"]
    reps = 5 if wrapper == "tile_compact" else 50
    if wrapper == "pair_merge":
        # uniform keys, each run sorted, B stored descending when asked
        G, ta, tb, desc = shape
        rng = np.random.default_rng(SEED)
        a_np, b_np = (np.sort(rng.integers(0, 2**32, (G, t), dtype=np.uint64).astype(np.uint32), axis=1)
                      for t in (ta, tb))
        a, b = from_numpy(a_np, device), from_numpy(b_np[:, ::-1] if desc else b_np, device)
        got, want = probes.pair_merge(a, b, b_descending=desc), probes.pair_merge_reference(a, b, b_descending=desc)
        check = np.sort(np.concatenate([to_numpy(a), to_numpy(b)], 1), 1)
        n = G * (ta + tb)
        cost = bound(8 * n, 4 * n)
        both = torch.cat([widen(a), widen(b)], 1)
        kernel = functools.partial(probes.pair_merge, a, b, b_descending=desc)
        plain = functools.partial(probes.pair_merge_reference, a, b, b_descending=desc)
        library = functools.partial(torch.sort, both, dim=1)
    elif wrapper == "tile_compact":
        mode, n_ops, n = shape
        ops_np, live_np = pco.make_inputs(n // probes.TILE)
        x, live = from_numpy(ops_np, device), from_numpy(live_np, device)
        ops = list(x.unbind(0))
        got, want = probes.tile_compact(ops, live, mode), probes.tile_compact_reference(ops, live, mode)
        check = pco.expected(mode, ops_np, live_np)
        live_rows = int(np.count_nonzero(live_np))
        cost = {"copy": bound(8 * n_ops * n, 0), "cumsum": bound(4 * (2 * n_ops + 1) * n, (n_ops + 2) * n),
                "network": bound(4 * (n + live_rows * n_ops + n_ops * n), 2 * n)}[mode]
        kernel = functools.partial(probes.tile_compact, ops, live, mode)
        plain = functools.partial(probes.tile_compact_reference, ops, live, mode)
        dead = (live == 0).view(-1, probes.TILE)
        alive = live != 0
        library = {"copy": x.clone, "cumsum": functools.partial(torch.cumsum, dead, 1),
                   "network": lambda: x[:, alive]}[mode]
    else:
        R, W, starts, rows, shift = shape
        x_np = np.random.default_rng(SEED).integers(0, 2**32, (R, W), dtype=np.uint64).astype(np.uint32)
        x, s = from_numpy(x_np, device), torch.tensor(starts, dtype=torch.int32, device=device)
        got, want = probes.row_gather(x, s, rows, shift), probes.row_gather_reference(x, s, rows, shift)
        idx = (np.asarray(starts)[:, None] + shift + np.arange(rows)) % R
        check = x_np[idx]
        cost = bound(4 * (len(starts) + 2 * len(starts) * rows * W), 4 * len(starts) * rows)
        kernel = functools.partial(probes.row_gather, x, s, rows, shift)
        plain = functools.partial(probes.row_gather_reference, x, s, rows, shift)
        flat = torch.from_numpy(idx.reshape(-1)).to(device)
        library = (functools.partial(torch.roll, x, -shift, 0) if len(starts) == 1 and rows == R
                   else functools.partial(x.index_select, 0, flat))
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{d} kernel disagrees with plain at {shape}")
    if not np.array_equal(to_numpy(got).reshape(check.shape), check):
        raise AssertionError(f"{d} kernel disagrees with the probe's NumPy check at {shape}")
    del got, want
    ms, plain_ms, library_ms = in_turns(kernel, plain, library, kernel_reps=reps, plain_reps=max(3, reps // 5))
    out = {**timing(0, ms, plain_ms, cost, library_ms), "device_kernels": traced_kernels(kernel)}
    if wrapper in ("row_gather", "pair_merge"):
        each = sorted(cuda_ms_each(kernel, reps))
        out["per_call_ms"] = {"min": each[0], "median": each[len(each) // 2], "max": each[-1]}
    return out


def probe_kernel_checks(device, cases):
    """Each probe kernel against its plain version, bit-exact: the edge
    cases of tests/test_torch_cuda.py (the probes' shapes, G = 1, lengths
    off the block's range, rows off the 16-byte grid, keys 0 and
    0xFFFFFFFF, pairs of one or two values, A and B starting 1-3 words into
    their buffers, D1's no live row, all live, live last rows) and
    probe_random_shapes."""
    import numpy as np

    for shape in cases.PROBE_MERGE_SHAPES:
        cases.probe_merge_vs_plain(*cases.probe_merge_case(np.random.default_rng(sum(shape)), *shape), device)
    for _, case in sorted(cases.PROBE_MERGE_TIE_CASES.items()):
        cases.probe_merge_vs_plain(*cases.probe_tie_case(np.random.default_rng(SEED), *case), device)
    for start in (1, 2, 3):
        cases.probe_merge_vs_plain(*cases.probe_merge_case(np.random.default_rng(start), 3, 2050, 2046), device, start)
    for name in sorted(cases.PROBE_TILE_CASES):
        cases.probe_tile_vs_plain(*cases.probe_tile_case(np.random.default_rng(SEED), *cases.PROBE_TILE_CASES[name]),
                                  device)
    for name in sorted(cases.PROBE_GATHER_CASES):
        R, W, starts, rows, shift = cases.PROBE_GATHER_CASES[name]
        cases.probe_gather_vs_plain(cases.probe_gather_case(np.random.default_rng(SEED), R, W), starts, rows, shift,
                                    device)
    rng = np.random.default_rng(SEED + 11)
    shapes = cases.probe_random_shapes(rng)
    for G, ta, tb in shapes["pair_merge"]:
        cases.probe_merge_vs_plain(*cases.probe_merge_case(rng, G, ta, tb), device)
    for n_ops, tiles, density in shapes["tile_compact"]:
        cases.probe_tile_vs_plain(*cases.probe_tile_case(rng, n_ops, tiles, density), device)
    for R, W, starts, rows, shift in shapes["row_gather"]:
        cases.probe_gather_vs_plain(cases.probe_gather_case(rng, R, W), starts, rows, shift, device)
    cases.probe_side_stream_vs_plain(device)
    log({"phase": "probes", "bit_exact": True, "side_stream": True,
         "edge_cases": {"pair_merge": len(cases.PROBE_MERGE_SHAPES),
                        "pair_merge_ties": sorted(cases.PROBE_MERGE_TIE_CASES), "pair_merge_row_starts": [1, 2, 3],
                        "tile_compact": sorted(cases.PROBE_TILE_CASES),
                        "row_gather": sorted(cases.PROBE_GATHER_CASES)},
         "random_shapes": {k: len(v) for k, v in shapes.items()}})


def phase_probes(device, cases):
    """D1-D7: the three probe harnesses' main() on the card (each checks its
    results against the probe's NumPy test and raises on a difference),
    their launches (run_probe_harness), each kernel against its plain
    version at the edge cases and random shapes (probe_kernel_checks) and,
    timed, at each launch shape of its harness.  Returns ({D-id:
    per_path_totals's dict}, {D-id: {harness: launches}})."""
    timings, launches = {}, {}
    for harness in PROBE_HARNESSES:
        by_d, rec = run_probe_harness(device, harness)
        for d, count in by_d.items():
            launches[d] = {harness: count}

            def at_shape(path, shape, d=d):
                t = probe_at_shape(d, shape, device)
                log({"phase": "probes", "kernel": PROBE_SPECS[d]["name"], "path": path, "shape": shape,
                     "bit_exact": True, "numpy_check": True, **t})
                return t

            timings[d] = per_path_totals({harness: rec.shapes[d]}, at_shape, 0)
    if sorted(launches) != sorted(PROBE_SPECS):
        raise AssertionError(f"the harnesses launched {sorted(launches)}, not every one of {sorted(PROBE_SPECS)}")
    probe_kernel_checks(device, cases)
    return timings, launches


def phase_mid_one(device, tmp):
    """A one-level run at k=55 forward (4 key lanes) with several
    consolidations."""
    import numpy as np

    from kmer_counter_tpu_torch.__main__ import main
    from kmer_counter_tpu_torch.ops import lane_sort as ls

    k, n_reads, L = 55, 100_000, 150
    reads = sample_reads(np.random.default_rng(k), 2_000_000, n_reads, L, 0.002)
    reads[11] = ord("T")
    d = os.path.join(tmp, "mid_one")
    write_fastq(os.path.join(d, "in", "a.fastq"), reads)
    out = os.path.join(d, "out.bin")
    ls.launches = 0
    t0 = time.perf_counter()
    rc = main([f"kmerLength={k}", "canonical=false", "tableImpl=one", "tableSlots=4000000",
               f"inputFileLocation={d}/in", f"outputFile={out}", "verbose=0"])
    wall, launches = time.perf_counter() - t0, ls.launches
    if rc != 0 or launches < 3:
        raise AssertionError(f"mid one-level run k={k}: rc={rc}, sort launches {launches} (want >= 3)")
    check_dump(out, dump_bytes(*numpy_count(reads, k, False)), f"mid one-level run k={k}")
    log({"phase": "mid_one", "k": k, "canonical": False, "reads": n_reads, "read_length": L,
         "wall_s": wall, "sort_launches": launches, "byte_identical_to_numpy_count": True})


def phase_small(tmp, cases):
    import functools

    import numpy as np

    from kmer_counter_tpu_torch.__main__ import main
    from kmer_counter_tpu_torch.ops import table2

    real = table2.consolidate3
    runs = [("two", None), ("one", None)] + [("two", v) for v in cases.SPLIT_VARIANTS]
    for k, canonical in ((15, False), (16, False), (55, False), (101, True)):
        rng = np.random.default_rng(k)
        reads = sample_reads(rng, 30_000, 2_000, 150, 0.005)
        reads[7] = ord("T")  # all-T windows (the side count of the two-level table at k=16)
        d = os.path.join(tmp, f"small_{k}")
        write_fastq(os.path.join(d, "in", "a.fastq"), reads[:1000])
        write_fastq(os.path.join(d, "in", "b.fastq"), reads[1000:])
        want = dump_bytes(*numpy_count(reads, k, canonical))
        for impl, variant in runs:
            out = os.path.join(d, f"out_{impl}_{variant}.bin")
            if variant:
                table2.consolidate3 = functools.partial(real, **cases.CONSOLIDATE_VARIANTS[variant])
            try:
                rc = main([f"kmerLength={k}", f"canonical={str(canonical).lower()}", f"tableImpl={impl}",
                           f"inputFileLocation={d}/in", f"outputFile={out}", "tableSlots=40000",
                           "verbose=0"])
            finally:
                table2.consolidate3 = real
            what = f"small CLI run k={k} canonical={canonical} tableImpl={impl} variant {variant}"
            if rc != 0:
                raise AssertionError(f"{what}: rc={rc}")
            check_dump(out, want, what)
            log({"phase": "small", "k": k, "canonical": canonical, "table_impl": impl,
                 "variant": variant, "byte_identical_to_numpy_count": True})


def union_length(spans):
    """The length of the union of intervals [(start, end)], in their unit."""
    total, reach = 0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def table_stages():
    """The table stages whose peaks stage_peaks takes by default."""
    from kmer_counter_tpu_torch.ops import pipeline, table, table2

    return [(pipeline, "count_step_two_level"), (table2, "grow2"),
            (table2, "consolidate3"), (table2, "finalize2"),
            (pipeline, "extract_chunk"), (table, "append"), (table, "grow"), (table, "consolidate")]


def stage_peaks(device, run, stages=None):
    """One more run with each stage (module, name) wrapped: the peak device
    memory inside each stage, over its calls, and under "run" that of the
    whole run (the card is synchronised around every call, so the run's
    times are not reported).  Stages may nest (a consolidation's steps
    inside consolidate3): the peak reached inside a stage counts for every
    stage around it."""
    import torch

    open_peaks = [0]  # the peak so far of each open stage, the run first
    peaks = {}

    def fold():  # the peak since the last reset, into every open stage
        torch.cuda.synchronize()
        m = torch.cuda.max_memory_allocated(device)
        open_peaks[:] = [max(p, m) for p in open_peaks]
        torch.cuda.reset_peak_memory_stats(device)

    def wrapped(name, real):
        def call(*args, **kw):
            fold()
            open_peaks.append(0)
            try:
                return real(*args, **kw)
            finally:
                fold()
                peaks[name] = max(peaks.get(name, 0), open_peaks.pop())

        return call

    stages = table_stages() if stages is None else stages
    reals = [getattr(module, name) for module, name in stages]
    for (module, name), real in zip(stages, reals):
        setattr(module, name, wrapped(f"{module.__name__.rsplit('.', 1)[1]}.{name}", real))
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        run()
        fold()
    finally:
        for (module, name), real in zip(stages, reals):
            setattr(module, name, real)
    return {"run": open_peaks[0], **peaks}


def phase_profile(device, tmp, untraced=3, top=15):
    """The main count through engine.run_count, for each table: `untraced`
    timed runs, a run that takes the peak device memory of each table
    stage, then one under torch.profiler.  Device busy time is the union of
    the traced run's kernel and copy intervals."""
    import torch
    from torch.autograd import DeviceType

    from kmer_counter_tpu_torch import Options
    from kmer_counter_tpu_torch.engine import run_count

    _, argv = main_input(tmp)
    argv.append("verbose=0")
    for impl in ("two", "one"):

        def run():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            stats = run_count(Options.from_argv(argv + [f"tableImpl={impl}"]), device)
            torch.cuda.synchronize()
            return stats

        for i in range(untraced):
            stats = run()
            log({"phase": "profile", "table_impl": impl, "run": i, "traced": False,
                 "wall_s": stats.wall_seconds, "kmers_per_s": stats.kmers_per_second,
                 "chunks": stats.chunks, "consolidations": stats.consolidations,
                 "timers_s": stats.metrics["timers_s"],
                 "peak_device_bytes": torch.cuda.max_memory_allocated(device)})
        peaks = stage_peaks(device, run)
        entry = {"phase": "profile", "table_impl": impl, "stage_peak_device_bytes": peaks,
                 "gpu_memory_limit": MEMORY_LIMIT}
        if impl == "two":
            entry["finalize2_below_consolidate3"] = peaks["table2.finalize2"] < peaks["table2.consolidate3"]
        log(entry)

        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            stats = run()
        spans, per_name = [], Counter()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                spans.append((e.time_range.start, e.time_range.end))
                per_name[e.name] += e.time_range.end - e.time_range.start
        if not spans:
            raise RuntimeError("torch.profiler recorded no device activity")
        busy_us = union_length(spans)
        busy_s = busy_us / 1e6
        h2d_us = [e.time_range.end - e.time_range.start for e in prof.events()
                  if e.device_type == DeviceType.CUDA and "Memcpy HtoD" in e.name]
        # The sort's two kernels (leaf and merge pass), each beside its share,
        # and K1's (fold_kernel of either merge, but only K1 runs on these
        # paths, and its fill).
        sort_us = {name: us for name, us in per_name.items()
                   if any(k in name for k in SORT_KERNEL_NAMES)}
        k1_us = {name: us for name, us in per_name.items() if any(k in name for k in K1_KERNEL_NAMES)}
        k1_launches = Counter(e.name for e in prof.events() if e.device_type == DeviceType.CUDA
                              and any(k in e.name for k in K1_KERNEL_NAMES))
        k8_us = sum(us for name, us in per_name.items() if K8_KERNEL_NAME in name)
        k8_launches = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA and K8_KERNEL_NAME in e.name)
        log({"phase": "profile", "table_impl": impl, "traced": True, "wall_s": stats.wall_seconds,
             "timers_s": stats.metrics["timers_s"], "device_busy_s": busy_s,
             "device_busy_share": busy_s / stats.wall_seconds, "device_events": len(spans),
             "h2d_device_ms": sum(h2d_us) / 1e3, "h2d_copies": len(h2d_us),
             "sort_device_ms": sum(sort_us.values()) / 1e3,
             "sort_share_of_busy": sum(sort_us.values()) / busy_us,
             "k1_device_ms": sum(k1_us.values()) / 1e3,
             "k1_kernels": {name[:80]: {"device_ms": us / 1e3, "launches": k1_launches[name]}
                            for name, us in sorted(k1_us.items())},
             "k8_device_ms": k8_us / 1e3, "k8_launches": k8_launches, "chunks": stats.chunks})
        for name, us in sorted(sort_us.items()):
            log({"phase": "profile", "table_impl": impl, "sort_kernel": True, "device_ms": us / 1e3,
                 "name": name[:120]})
        for name, us in per_name.most_common(top):
            log({"phase": "profile", "table_impl": impl, "device_ms": us / 1e3, "name": name[:120]})


def ptxas_report(build_log):
    """Each kernel instance's registers and spill bytes from nvcc's -Xptxas
    -v report: [{"kernel": mangled name, "registers", "spill_stores",
    "spill_loads"}]."""
    import re

    out, current = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            current = out.setdefault(m.group(1), {"kernel": m.group(1)})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and current is not None:
            current["spill_stores"], current["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = out.setdefault(m.group(1), {"kernel": m.group(1)})
        m = re.search(r"Used (\d+) registers", line)
        if m and current is not None:
            current["registers"] = int(m.group(1))
    return [k for k in out.values() if "registers" in k]


def phase_build():
    """Builds every source at once (one nvcc each); logs each build.  At
    once, the build takes as long as the slowest nvcc, not the sum."""
    from kmer_counter_tpu_torch import cuda_build
    from kmer_counter_tpu_torch.ops import compact_live as cl
    from kmer_counter_tpu_torch.ops import fused_extract as fx
    from kmer_counter_tpu_torch.ops import lane_sort as ls
    from kmer_counter_tpu_torch.ops import merge_fold_compact as mfc
    from kmer_counter_tpu_torch.ops import probes
    from kmer_counter_tpu_torch.ops import record_pack as rp

    t0 = time.perf_counter()
    with ThreadPoolExecutor(6) as pool:
        for f in [pool.submit(mfc.tile_rows, 1), pool.submit(ls.tile_rows, 1), pool.submit(cl.tile_rows),
                  pool.submit(fx.tile_bases), pool.submit(probes.kernel_tile), pool.submit(rp.tile_rows)]:
            f.result()
    for source in ("merge_fold_compact", "lane_sort", "compact_live", "fused_extract", "probes", "records"):
        report = cuda_build.build_log.get(source, "")
        log({"phase": "build", "source": f"csrc/{source}.cu", "nvcc_s": cuda_build.build_seconds[source],
             "instances": ptxas_report(report)})
        print(report.strip(), flush=True)
    log({"phase": "build", "wall_s": time.perf_counter() - t0})


def kernel_entry(spec, runs, timing):
    """The kernels line's entry of one kernel: its launches in each main
    path's run (from the launch counts) beside that path's times, and
    their sums (ms, plain_ms, bound_ms and library_ms over every launch)."""
    paths = {path: {"launches": launches[spec["name"]], **timing["paths"][path]}
             for path, (launches, _) in runs.items()}
    return {**spec, "launches": sum(p["launches"] for p in paths.values()),
            **{key: timing[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                            "library_ms")},
            "paths": paths, **({"device_kernels": timing["device_kernels"]} if "device_kernels" in timing
                               else {})}


def timed(phase, *args):
    """phase(*args), then a line with its seconds."""
    t0 = time.perf_counter()
    out = phase(*args)
    log({"phase_seconds": phase.__name__, "seconds": time.perf_counter() - t0})
    return out


def main():
    if sys.argv[1:2] == ["--mesh-worker"] and len(sys.argv) == 6:
        require_checkout()
        return mesh_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], json.loads(sys.argv[5]))
    profile = sys.argv[1:] == ["--profile"]
    if sys.argv[1:] and not profile:
        raise SystemExit(f"usage: {sys.argv[0]} [--profile]")
    require_checkout()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: CUDA is not available — it runs only on an NVIDIA GPU")
    device = torch.device("cuda")

    cases = load_test_cases()
    t_all = time.perf_counter()
    log({"phase": "device", "nvidia_smi": smi_line(), "torch": torch.__version__,
         "cuda": torch.version.cuda, "device_name": torch.cuda.get_device_name(0)})
    phase_build()

    with tempfile.TemporaryDirectory(dir=HERE, prefix="chip_smoke_") as tmp:
        if profile:
            phase_profile(device, tmp)
            print(smi_line(), flush=True)
            return
        runs, main_ctx = timed(phase_main, device, tmp, cases)
        torch.cuda.empty_cache()
        runs.update(timed(phase_mesh, device, tmp, main_ctx))
        runs.update(timed(phase_mesh_mp, device, tmp, main_ctx))
        spill_runs, spill_ctx = timed(phase_spill, device, tmp)
        runs.update(spill_runs)
        torch.cuda.empty_cache()
        runs.update(timed(phase_mesh_spill, device, tmp, spill_ctx))
        del spill_ctx
        torch.cuda.empty_cache()
        # The process's first trace, after phases 3-7 and 12-15 (see
        # TRACE_MARGIN).
        timed(phase_feed, device, tmp, main_ctx)
        del main_ctx
        torch.cuda.empty_cache()

        def shapes_of(name):
            return {path: shapes.shapes[name] for path, (_, shapes) in runs.items()}

        timings = {K1["name"]: timed(phase_kernel, device, cases, shapes_of(K1["name"])),
                   SORT["name"]: timed(phase_sort_kernel, device, cases, shapes_of(SORT["name"])),
                   K2["name"]: timed(phase_k2_kernel, device, cases, shapes_of(K2["name"])),
                   **timed(phase_merge_kernels, device, cases, {name: shapes_of(name) for name in MERGES}),
                   K8["name"]: timed(phase_k8_kernel, device, cases, shapes_of(K8["name"])),
                   R1["name"]: timed(phase_r1_kernel, device, shapes_of(R1["name"]))}
        torch.cuda.empty_cache()
        probe_timings, probe_launches = timed(phase_probes, device, cases)
        torch.cuda.empty_cache()
        timed(phase_mid_one, device, tmp)
        timed(phase_small, tmp, cases)
        timed(phase_profile_flag, tmp)
    log({"phase": "done", "seconds": time.perf_counter() - t_all})

    print(smi_line(), flush=True)
    specs = [K1, SORT, K2, *MERGES.values(), K8, R1]
    entries = [kernel_entry(spec, runs, timings[spec["name"]]) for spec in specs]
    entries += [kernel_entry(spec, {path: ({spec["name"]: n}, None) for path, n in probe_launches[d].items()},
                             probe_timings[d]) for d, spec in PROBE_SPECS.items()]
    log({"kernels": entries})
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
