#!/usr/bin/env python3
"""Smoke run of the PyTorch port (kmer_counter_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout; needs CUDA and nvcc
    python3 chip_smoke.py --profile  # the main-path runs, timed and traced instead

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

  1. device   — card name and power limit (nvidia-smi), torch / CUDA versions
  2. build    — nvcc builds every kernel of the main paths from csrc/, one
                process per source, all started together
  3. main     — the CLI (kmer_counter_tpu_torch.__main__.main) counts 2M
                reads x 100 bp sampled from a 4.6-Mbase genome at k=31
                canonical, gpuMemoryLimit=8e9, with the two-level table;
                the launch counts of K1 (merge_fold_compact) and of the sort
                (lane_sort, at finalize) in that run and their launch
                shapes (for K1 and the merges also the live rows of A and B
                and B's live rows with the sentinel key, for K1 and K2 the
                output width, the prefix's CP columns); the dump is
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
                (the merge and K2 at least twice each, K1 none), launch
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
                K1, K2, K3 and K4 bit-exact, and the sort and K5 with
                bit-exact keys and the same payloads under each key, at
                NL = 1, 2, 4, 7 and about 8M rows (K1, K3 and the sort also
                32M), at the edge cases of tests/test_torch_cuda.py (the
                merges also at the K1/K3 kernel's tile, the sort's also on
                lanes sliced from a wider table, K2's also on rows a word
                past a 16-byte boundary) and at each launch shape of phases
                3-7, on operands shaped as that path gives them (the
                prefix's live rows and the raw region's liveness as the path
                had them; K1 and the merges also on operands of the same
                size with an 80%-live prefix, as earlier runs timed them;
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
 11. profile  — a small two-level CLI run with profile=true: its
                torch.profiler trace (<outputFile>.trace/trace.json) names
                fold_kernel and leaf_kernel; the dump equals the NumPy count

The last three lines: the card's name and power limit, one JSON object
describing each kernel (its launches and times summed over phases 3-7,
under "paths" each phase's own, and under "device_kernels" its CUDA
kernels' traced device time and launches at its largest launch shape),
and {"ok": true, "device": {...}}.

With --profile, phases 1 and 2 are followed by, for each table: three
untraced runs of the main count (wall, engine timers, peak device memory
of each), one that takes the peak device memory of each table stage, and
one under torch.profiler: the device's busy share of that run, its
device time per kernel and copy, largest first, the sort's two kernels
(leaf and merge pass) apart, with the sort's share of the busy time, and
K1's two kernels (merge pass and fill) with their launches.

The reads, the FASTQ files and the reference counts are made here with
NumPy; nothing of the JAX package is imported.
"""

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


def sample_reads(rng, genome_len, n_reads, read_len, invalid_frac):
    """[n_reads, read_len] uint8 ASCII reads sampled uniformly from a random
    ACGT genome, a fraction of bases replaced by 'N'."""
    import numpy as np

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
    the k-mer and its reverse complement.  Returns (words [U, W] uint64
    ascending, counts [U] uint32)."""
    import numpy as np

    W = -(-k // 32)
    R, L = reads.shape
    P = L - k + 1
    lut = np.full(256, 255, np.uint8)
    for code, base in enumerate(b"ACGT"):
        lut[base] = lut[base + 32] = code
    parts = []
    for b0 in range(0, R, block):
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
        parts.append(fwd[:, bad[:, k : k + P] == bad[:, :P]])
    keys = np.concatenate(parts, axis=1)
    if W == 1:
        words, counts = np.unique(keys[0], return_counts=True)
        return words[:, None], counts.astype(np.uint32)
    keys = keys[:, np.lexsort(keys[::-1])].T
    head = np.ones(len(keys), bool)
    head[1:] = (keys[1:] != keys[:-1]).any(axis=1)
    starts = np.flatnonzero(head)
    return keys[starts], np.diff(np.append(starts, len(keys))).astype(np.uint32)


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


def traced_kernels(fn):
    """Device time and launches of each kernel in one call of fn, by
    torch.profiler: {kernel name: {"ms": ..., "launches": ...}}."""
    import torch
    from torch.autograd import DeviceType

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        # A trace can miss its first kernel: launch one first that is not
        # counted (ATen's spin_kernel).
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
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
    operands shaped as the path gave them, then on the 80%-live random mix
    of the same size.  Returns the path-shaped timing."""
    NL, na, nb, *live, out_rows = shape
    out = None
    for mix in ("path", "random_80pct_live"):
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
def sort_operands_for(path):
    """The one-level table sorts every slot; the two-level finalize sorts
    the prefix's live rows, unique and ascending."""
    return random_sort_operands if path in ("main_one", "spill_one") else finalize_sort_operands


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
        NL, n = shape
        keys, counts = sort_operands_for(path)(NL, n, gen, device)
        t = compare_sort(cases, keys, counts, time_it=True, reduce_too=True)
        log({"phase": "kernel", "kernel": SORT["name"], "path": path, "main_path_launch_shape": True,
             "NL": NL, "n": n, "keys_bit_exact": True, "payloads_conserved": True,
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


class LaunchShapes:
    """Records the shape of each call of the kernel wrappers on the table
    paths: (NL, na, nb, A's live rows, B's live rows, B's live rows with
    the sentinel key) for the merges, the same and the output width for K1,
    (NL, n) for the sort, and (n_ops, n, live rows, output width) for K2;
    the kernel phase compares and times the kernels at those shapes.
    ``variant``: consolidate3's keywords, bound to table2.consolidate3 while
    the context is open."""

    def __init__(self, variant=None):
        import functools

        from kmer_counter_tpu_torch.ops import lane_sort, table2

        self._table2, self._lane_sort = table2, lane_sort
        self.shapes = {name: [] for name in (K1["name"], SORT["name"], K2["name"], *MERGES)}
        self._patches = [(table2, "merge_fold_compact", self._merge("merge_fold_compact")),
                         (lane_sort, "sort_ops", self._sort),
                         (table2, "compact_live", self._k2)]
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
        self.shapes[SORT["name"]].append(tuple(keys.shape))
        return self._reals[(self._lane_sort, "sort_ops")](keys, payload)

    def _k2(self, operands, live, num_keys, out_rows=None):
        live_rows = self._table2._count_rows(live.numel(), lambda p0, p1: live[p0:p1] != 0)
        self.shapes[K2["name"]].append((len(operands), live.numel(), live_rows, out_rows))
        return self._reals[(self._table2, "compact_live")](operands, live, num_keys, out_rows)

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
    from kmer_counter_tpu_torch.ops import lane_sort as ls
    from kmer_counter_tpu_torch.ops import merge_fold_compact as mfc
    from kmer_counter_tpu_torch.ops import merge_runs as mr

    return {K1["name"]: mfc.launches, SORT["name"]: ls.launches, K2["name"]: cl.launches,
            **{name: mr.launches[name] for name in MERGES}}


def reset_launch_counts():
    from kmer_counter_tpu_torch.ops import compact_live as cl
    from kmer_counter_tpu_torch.ops import lane_sort as ls
    from kmer_counter_tpu_torch.ops import merge_fold_compact as mfc
    from kmer_counter_tpu_torch.ops import merge_runs as mr

    mfc.launches = ls.launches = cl.launches = 0
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


def check_dump(path, want: bytes, what: str):
    with open(path, "rb") as fh:
        if fh.read() != want:
            raise AssertionError(f"{what}: the dump differs from the independent NumPy count")


def phase_main(device, tmp, cases):
    """Phases 3-5: the main count with each table, then with the two-level
    table under each split consolidation variant.  Returns {path: ({kernel:
    launches}, LaunchShapes)} for "main" (two-level), "main_one" and
    "main_<variant>" for each split variant."""
    import numpy as np

    t0 = time.perf_counter()
    reads, argv = main_input(tmp)
    log({"phase": "main", "data": f"{MAIN_READS} reads x {MAIN_L} bp, {MAIN_GENOME}-base genome, "
         f"{MAIN_FILES} files", "setup_s": time.perf_counter() - t0})
    out = argv[-1].split("=", 1)[1]
    runs = {}
    want = None
    plan = [("main", "main", "two", None, {K1["name"]: (2, None), SORT["name"]: (1, None)}),
            ("main_one", "main_one", "one", None, {SORT["name"]: (2, None)})]
    for variant in cases.SPLIT_VARIANTS:
        need = {cases.VARIANT_MERGE[variant]: (2, None), K2["name"]: (2, None), K1["name"]: (0, 0)}
        plan.append((f"main_{variant}", "main_variants", "two", variant, need))
    for path, phase, impl, variant, need in plan:
        kw = cases.CONSOLIDATE_VARIANTS[variant] if variant else None
        wall, peak, launches, shapes, _ = run_main_path(device, argv, impl, kw)
        check_launches(path, launches, need)
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
    return runs


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
    "spill" (two-level), "spill_one", "resume" and "resume_one"."""
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
    return runs


def phase_profile_flag(tmp):
    """Phase 11: a small two-level CLI run with profile=true writes its
    torch.profiler trace next to the output, and the trace names K1's and
    the sort's kernels."""
    import json

    import numpy as np

    from kmer_counter_tpu_torch.__main__ import main

    k = MAIN_K
    reads = sample_reads(np.random.default_rng(7), 30_000, 2_000, 150, 0.005)
    d = os.path.join(tmp, "profile_flag")
    write_fastq(os.path.join(d, "in", "a.fastq"), reads)
    out = os.path.join(d, "out.bin")
    rc = main([f"kmerLength={k}", "canonical=true", "tableImpl=two", f"inputFileLocation={d}/in",
               f"outputFile={out}", "tableSlots=40000", "profile=true", "verbose=0"])
    if rc != 0:
        raise AssertionError(f"profile=true run: rc={rc}")
    check_dump(out, dump_bytes(*numpy_count(reads, k, True)), "profile=true run")
    trace = os.path.join(out + ".trace", "trace.json")
    with open(trace) as fh:
        events = json.load(fh)["traceEvents"]
    found = {name: sum(name in e.get("name", "") for e in events) for name in ("fold_kernel", "leaf_kernel")}
    log({"phase": "profile", "profile_flag": True, "trace": os.path.relpath(trace, tmp),
         "trace_bytes": os.path.getsize(trace), "events": len(events), "kernel_events": found,
         "byte_identical_to_numpy_count": True})
    if not all(found.values()):
        raise AssertionError(f"profile=true: the trace lacks a kernel: {found}")


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


def table_stages():
    """The table stages whose peaks stage_peaks takes by default."""
    from kmer_counter_tpu_torch.ops import pipeline, table, table2

    return [(pipeline, "count_step_two_level"), (table2, "grow2"),
            (table2, "consolidate3"), (table2, "finalize2"),
            (table, "append"), (table, "grow"), (table, "consolidate")]


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
        busy_us, reach = 0, float("-inf")
        for start, end in sorted(spans):
            if end > reach:
                busy_us += end - max(start, reach)
                reach = end
        busy_s = busy_us / 1e6
        # The sort's two kernels (leaf and merge pass), each beside its share,
        # and K1's (fold_kernel of either merge, but only K1 runs on these
        # paths, and its fill).
        sort_us = {name: us for name, us in per_name.items()
                   if any(k in name for k in SORT_KERNEL_NAMES)}
        k1_us = {name: us for name, us in per_name.items() if any(k in name for k in K1_KERNEL_NAMES)}
        k1_launches = Counter(e.name for e in prof.events() if e.device_type == DeviceType.CUDA
                              and any(k in e.name for k in K1_KERNEL_NAMES))
        log({"phase": "profile", "table_impl": impl, "traced": True, "wall_s": stats.wall_seconds,
             "timers_s": stats.metrics["timers_s"], "device_busy_s": busy_s,
             "device_busy_share": busy_s / stats.wall_seconds, "device_events": len(spans),
             "sort_device_ms": sum(sort_us.values()) / 1e3,
             "sort_share_of_busy": sum(sort_us.values()) / busy_us,
             "k1_device_ms": sum(k1_us.values()) / 1e3,
             "k1_kernels": {name[:80]: {"device_ms": us / 1e3, "launches": k1_launches[name]}
                            for name, us in sorted(k1_us.items())}})
        for name, us in sorted(sort_us.items()):
            log({"phase": "profile", "table_impl": impl, "sort_kernel": True, "device_ms": us / 1e3,
                 "name": name[:120]})
        for name, us in per_name.most_common(top):
            log({"phase": "profile", "table_impl": impl, "device_ms": us / 1e3, "name": name[:120]})


def phase_build():
    """Builds every source at once (one nvcc each); logs each build.  At
    once, the build takes as long as the slowest nvcc, not the sum."""
    from kmer_counter_tpu_torch import cuda_build
    from kmer_counter_tpu_torch.ops import compact_live as cl
    from kmer_counter_tpu_torch.ops import lane_sort as ls
    from kmer_counter_tpu_torch.ops import merge_fold_compact as mfc

    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        for f in [pool.submit(mfc.tile_rows, 1), pool.submit(ls.tile_rows, 1), pool.submit(cl.tile_rows)]:
            f.result()
    for source in ("merge_fold_compact", "lane_sort", "compact_live"):
        log({"phase": "build", "source": f"csrc/{source}.cu", "nvcc_s": cuda_build.build_seconds[source]})
        print(cuda_build.build_log.get(source, "").strip(), flush=True)
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


def main():
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
        runs = phase_main(device, tmp, cases)
        torch.cuda.empty_cache()
        runs.update(phase_spill(device, tmp))
        torch.cuda.empty_cache()

        def shapes_of(name):
            return {path: shapes.shapes[name] for path, (_, shapes) in runs.items()}

        timings = {K1["name"]: phase_kernel(device, cases, shapes_of(K1["name"])),
                   SORT["name"]: phase_sort_kernel(device, cases, shapes_of(SORT["name"])),
                   K2["name"]: phase_k2_kernel(device, cases, shapes_of(K2["name"])),
                   **phase_merge_kernels(device, cases, {name: shapes_of(name) for name in MERGES})}
        torch.cuda.empty_cache()
        phase_mid_one(device, tmp)
        phase_small(tmp, cases)
        phase_profile_flag(tmp)
    log({"phase": "done", "seconds": time.perf_counter() - t_all})

    print(smi_line(), flush=True)
    specs = [K1, SORT, K2, *MERGES.values()]
    log({"kernels": [kernel_entry(spec, runs, timings[spec["name"]]) for spec in specs]})
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
