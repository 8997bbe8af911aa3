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
                shapes; the dump is byte-identical to an independent NumPy
                count
  4. main_one — the same count with tableImpl=one: every consolidation is a
                sort_reduce through the sort kernel; its launch count and
                shapes; the dump is byte-identical to the same NumPy count
  5. kernel   — each kernel against its plain torch version on the card:
                K1 bit-exact, and the sort with bit-exact keys and the same
                payloads under each key, at NL = 1, 2, 4, 7 and about 8M and
                32M rows, at the edge cases of tests/test_torch_cuda.py and
                at each launch shape of phases 3 and 4, on operands shaped
                as that path gives them (the sort with sort_reduce's outputs
                equal too); CUDA-event times of both, per path
  6. mid_one  — a one-level run at k=55 forward (4 key lanes): 100k reads x
                150 bp, several consolidations; byte-identical to NumPy
  7. small    — CLI runs at k=15, 16 (all-T reads), 55 and 101 (canonical)
                with each table and a small tableSlots that forces growth;
                each dump byte-identical to the NumPy count

The last three lines: the card's name and power limit, one JSON object
describing each kernel (its launches and times summed over phases 3-4,
and under "paths" each phase's own), and {"ok": true, "device": {...}}.

With --profile, phases 1 and 2 are followed by, for each table: three
untraced runs of the main count (wall, engine timers, peak device memory
of each), one that takes the peak device memory of each table stage, and
one under torch.profiler: the device's busy share of that run and its
device time per kernel and copy, largest first.

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
K1 = dict(
    name="merge_fold_compact",
    route="cuda",
    source="kmer_counter_tpu_torch/csrc/merge_fold_compact.cu",
    replaces="kmer_counter_tpu/ops/pallas_sort.py:781",
)
# K6 (leaf_sort, :204) + K7 (_merge_pass, :313) as one sort.
SORT = dict(
    name="lane_sort",
    route="cuda",
    source="kmer_counter_tpu_torch/csrc/lane_sort.cu",
    replaces="kmer_counter_tpu/ops/pallas_sort.py:204",
    replaces_also="kmer_counter_tpu/ops/pallas_sort.py:313",
)
MAIN_K, MAIN_L, MAIN_READS, MAIN_FILES, MAIN_GENOME = 31, 100, 2_000_000, 4, 4_600_000
MEMORY_LIMIT = 8_000_000_000
KERNEL_ROWS = (8 << 20, 32 << 20)  # the kernel phase's random operand sizes


def log(obj):
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def require_checkout():
    for d in ("kmer_counter_tpu_torch", "kmer_counter_tpu", "tests"):
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


def in_turns(kernel, plain, kernel_reps=5, plain_reps=3):
    """(kernel ms, plain ms), timed in turns: kernel, plain, plain, kernel."""
    k1, p1, p2, k2 = (cuda_ms(kernel, kernel_reps), cuda_ms(plain, plain_reps),
                      cuda_ms(plain, plain_reps), cuda_ms(kernel, kernel_reps))
    return (k1 + k2) / 2, (p1 + p2) / 2


def random_k1_operands(NL, na, nb, gen, device):
    """Consolidation-shaped K1 operands made on the card: A = sorted prefix
    rows (counts 1..5, 2% near 2^32) with a sentinel tail; B = raw rows
    drawn with repeats from the same key pool, 5% masked windows
    (sentinel, live), 10% dead rows (zero key, liveness 0), stored
    descending."""
    import torch

    from kmer_counter_tpu_torch.ops.sortcount import lex_argsort

    def ri(lo, hi, size):
        return torch.randint(lo, hi, size, generator=gen, device=device)

    pool = max((na + nb) // 3, 4)
    keys = ri(-(2**31), 2**31, (NL, pool)).to(torch.int32)
    keys[:, 0] = 0
    n_live_a = int(na * 0.8)
    a = keys[:, ri(0, pool, (n_live_a,))]
    a = a[:, lex_argsort(a)]
    ac = ri(1, 6, (n_live_a,)).to(torch.int32)
    big = torch.rand(n_live_a, generator=gen, device=device) < 0.02
    ac = torch.where(big, ri(-(2**31), 0, (n_live_a,)).to(torch.int32), ac)
    a = torch.cat([a, a.new_full((NL, na - n_live_a), -1)], 1)
    ac = torch.cat([ac, ac.new_zeros(na - n_live_a)])
    b = keys[:, ri(0, pool, (nb,))]
    b[:, : int(nb * 0.05)] = -1
    b = b[:, lex_argsort(b)]
    n_dead = int(nb * 0.1)
    b[:, :n_dead] = 0
    live = torch.ones(nb, dtype=torch.int32, device=device)
    live[:n_dead] = 0
    b, live = b.flip(1).contiguous(), live.flip(0).contiguous()
    return [*a.unbind(0), ac], [*b.unbind(0), live]


def compare_k1(a_ops, b_ops, NL, time_it):
    """Kernel vs plain on the same operands: bit-exact or raise.  Returns
    (max_abs_err, kernel ms, plain ms) — times None unless time_it."""
    import torch

    from kmer_counter_tpu_torch.ops import merge_fold_compact as mfc
    from kmer_counter_tpu_torch.ops.u32 import widen

    out, live = mfc.merge_fold_compact(a_ops, b_ops, NL)
    want, want_live = mfc.merge_fold_compact_reference(a_ops, b_ops, NL)
    torch.cuda.synchronize()
    err = int((widen(out) - widen(want)).abs().max()) if out.numel() else 0
    if int(live) != int(want_live) or not torch.equal(out, want):
        raise AssertionError(
            f"K1 kernel disagrees with plain: NL={NL} na={a_ops[0].numel()} "
            f"nb={b_ops[0].numel()} live {int(live)} vs {int(want_live)}, max_abs_err {err}"
        )
    if not time_it:
        return err, None, None
    ms, plain_ms = in_turns(lambda: mfc.merge_fold_compact(a_ops, b_ops, NL),
                            lambda: mfc.merge_fold_compact_reference(a_ops, b_ops, NL))
    return err, ms, plain_ms


def phase_kernel(device, shapes_by_path):
    """K1 kernel vs plain: random operands per NL at ~8M and ~32M rows, the
    edge cases, and each (NL, na, nb) that a main path launched.  Returns
    per_path_totals's dict."""
    import numpy as np
    import torch

    cases = load_test_cases()
    EDGE_CASES, operands = cases.EDGE_CASES, cases.operands

    gen = torch.Generator(device=device).manual_seed(SEED)
    max_err = 0
    for NL in (1, 2, 4, 7):
        for n in KERNEL_ROWS:
            na = n // 8
            a_ops, b_ops = random_k1_operands(NL, na, n - na, gen, device)
            err, ms, plain_ms = compare_k1(a_ops, b_ops, NL, time_it=True)
            max_err = max(max_err, err)
            log({"phase": "kernel", "kernel": K1["name"], "NL": NL, "na": na, "nb": n - na,
                 "bit_exact": True, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
            del a_ops, b_ops
    for name, build in sorted(EDGE_CASES.items()):
        a_ops, b_ops, NL = operands(build(np.random.default_rng(SEED)), device)
        err, _, _ = compare_k1(a_ops, b_ops, NL, time_it=False)
        max_err = max(max_err, err)
        log({"phase": "kernel", "kernel": K1["name"], "edge_case": name, "bit_exact": True})

    def at_shape(path, shape):
        NL, na, nb = shape
        a_ops, b_ops = random_k1_operands(NL, na, nb, gen, device)
        err, ms, plain_ms = compare_k1(a_ops, b_ops, NL, time_it=True)
        log({"phase": "kernel", "kernel": K1["name"], "path": path, "main_path_launch_shape": True,
             "NL": NL, "na": na, "nb": nb, "bit_exact": True, "max_abs_err": err,
             "ms": ms, "plain_ms": plain_ms})
        return err, ms, plain_ms

    return per_path_totals(shapes_by_path, at_shape, max_err)


def per_path_totals(shapes_by_path, at_shape, max_err):
    """Runs at_shape(path, shape) -> (max_abs_err, ms, plain_ms) once for
    each distinct launch shape of each path.  Returns the largest error
    (with max_err), and ms / plain_ms as totals over every launch (each
    shape's times times its launch count), over all paths and under
    "paths" for each."""
    import torch

    paths = {}
    for path, shapes in shapes_by_path.items():
        ms = plain_ms = 0.0
        for shape, count in sorted(Counter(shapes).items()):
            err, t, plain_t = at_shape(path, shape)
            torch.cuda.empty_cache()
            max_err = max(max_err, err)
            ms += count * t
            plain_ms += count * plain_t
        paths[path] = {"ms": ms, "plain_ms": plain_ms}
    return {"max_abs_err": max_err, "ms": sum(p["ms"] for p in paths.values()),
            "plain_ms": sum(p["plain_ms"] for p in paths.values()), "paths": paths}


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
# them: the two-level run sorts only at finalize, the one-level run sorts
# its whole table at every consolidation.
SORT_OPERANDS = {"main": finalize_sort_operands, "main_one": random_sort_operands}


def compare_sort(cases, keys, payload, time_it, reduce_too=False):
    """The sort kernel vs its plain version on the same operands: keys
    bit-exact and the same payloads under each key (``cases``: the loaded
    tests/test_torch_cuda.py), or raise; with
    reduce_too, sort_reduce (through the kernel) against sort_reduce's
    second half applied to the plain sort, equal or raise.  Returns
    (max_abs_err of the keys, kernel ms, plain ms) — times None unless
    time_it."""
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
    if not time_it:
        return err, None, None
    ms, plain_ms = in_turns(lambda: ls.sort_ops(keys, payload),
                            lambda: ls.sort_ops_reference(keys, payload))
    return err, ms, plain_ms


def phase_sort_kernel(device, shapes_by_path):
    """The sort kernel vs plain: random operands per NL at ~8M and ~32M
    rows, the edge cases, and each (NL, n) that a main path launched, on
    operands shaped as that path gives them (SORT_OPERANDS).  Returns
    per_path_totals's dict."""
    import numpy as np
    import torch

    from kmer_counter_tpu_torch.ops.u32 import from_numpy

    cases = load_test_cases()
    gen = torch.Generator(device=device).manual_seed(SEED)
    max_err = 0
    for NL in (1, 2, 4, 7):
        for n in KERNEL_ROWS:
            keys, counts = random_sort_operands(NL, n, gen, device)
            err, ms, plain_ms = compare_sort(cases, keys, counts, time_it=True)
            max_err = max(max_err, err)
            log({"phase": "kernel", "kernel": SORT["name"], "NL": NL, "n": n, "keys_bit_exact": True,
                 "payloads_conserved": True, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
            del keys, counts
    for name, build in sorted(cases.SORT_CASES.items()):
        keys_np, payload_np = build(np.random.default_rng(SEED))
        err, _, _ = compare_sort(cases, from_numpy(keys_np, device), from_numpy(payload_np, device),
                                 time_it=False)
        max_err = max(max_err, err)
        log({"phase": "kernel", "kernel": SORT["name"], "edge_case": name, "keys_bit_exact": True,
             "payloads_conserved": True})

    def at_shape(path, shape):
        NL, n = shape
        keys, counts = SORT_OPERANDS[path](NL, n, gen, device)
        err, ms, plain_ms = compare_sort(cases, keys, counts, time_it=True, reduce_too=True)
        log({"phase": "kernel", "kernel": SORT["name"], "path": path, "main_path_launch_shape": True,
             "NL": NL, "n": n, "keys_bit_exact": True, "payloads_conserved": True,
             "sort_reduce_equal": True, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
        return err, ms, plain_ms

    return per_path_totals(shapes_by_path, at_shape, max_err)


class LaunchShapes:
    """Records the shape of each call of the two kernel wrappers, as
    (NL, na, nb) for K1 and (NL, n) for the sort; the kernel phase compares
    and times the kernels at those shapes."""

    def __init__(self):
        from kmer_counter_tpu_torch.ops import lane_sort, table2

        self.k1, self.sort = [], []
        self._patches = [(table2, "merge_fold_compact", self._k1), (lane_sort, "sort_ops", self._sort)]
        self._reals = {name: getattr(module, name) for module, name, _ in self._patches}

    def _k1(self, a_ops, b_ops, num_keys):
        self.k1.append((num_keys, a_ops[0].numel(), b_ops[0].numel()))
        return self._reals["merge_fold_compact"](a_ops, b_ops, num_keys)

    def _sort(self, keys, payload):
        self.sort.append(tuple(keys.shape))
        return self._reals["sort_ops"](keys, payload)

    def __enter__(self):
        for module, name, fn in self._patches:
            setattr(module, name, fn)
        return self

    def __exit__(self, *exc):
        for module, name, _ in self._patches:
            setattr(module, name, self._reals[name])


def run_main_path(device, argv, impl):
    """One CLI run of the main count with tableImpl=impl.  The launch
    counts are set to 0 just before it and read just after.  Returns
    (wall s, peak device bytes, {kernel: launches}, LaunchShapes)."""
    import torch

    from kmer_counter_tpu_torch.__main__ import main
    from kmer_counter_tpu_torch.ops import lane_sort as ls
    from kmer_counter_tpu_torch.ops import merge_fold_compact as mfc

    with LaunchShapes() as shapes:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        mfc.launches = ls.launches = 0
        t0 = time.perf_counter()
        rc = main(argv + [f"tableImpl={impl}"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {K1["name"]: mfc.launches, SORT["name"]: ls.launches}
    if rc != 0:
        raise RuntimeError(f"main() returned {rc} (tableImpl={impl})")
    return wall, torch.cuda.max_memory_allocated(device), launches, shapes


def check_dump(path, want: bytes, what: str):
    with open(path, "rb") as fh:
        if fh.read() != want:
            raise AssertionError(f"{what}: the dump differs from the independent NumPy count")


def phase_main(device, tmp):
    """Phases 3 and 4: the main count with each table.  Returns
    {phase: ({kernel: launches}, LaunchShapes)} for "main" (two-level) and
    "main_one"."""
    import numpy as np

    t0 = time.perf_counter()
    reads, argv = main_input(tmp)
    log({"phase": "main", "data": f"{MAIN_READS} reads x {MAIN_L} bp, {MAIN_GENOME}-base genome, "
         f"{MAIN_FILES} files", "setup_s": time.perf_counter() - t0})
    out = argv[-1].split("=", 1)[1]
    runs = {}
    want = None
    for phase, impl, need in (("main", "two", {K1["name"]: 2, SORT["name"]: 1}),
                              ("main_one", "one", {SORT["name"]: 2})):
        wall, peak, launches, shapes = run_main_path(device, argv, impl)
        for name, least in need.items():
            if launches[name] < least:
                raise AssertionError(f"{phase}: {name} launched {launches[name]} times (want >= {least})")
        t0 = time.perf_counter()
        if want is None:
            words, counts = numpy_count(reads, MAIN_K, canonical=True)
            want, total = dump_bytes(words, counts), int(counts.sum(dtype=np.int64))
        check_dump(out, want, phase)
        log({"phase": phase, "cmd": "python -m kmer_counter_tpu_torch " + " ".join(argv[:3])
             + f" tableImpl={impl}", "wall_s": wall, "kmers": total, "kmers_per_s": total / wall,
             "distinct_kmers": int(len(counts)), "launches": launches, "k1_shapes": shapes.k1,
             "sort_shapes": shapes.sort, "peak_device_bytes": peak, "gpu_memory_limit": MEMORY_LIMIT,
             "byte_identical_to_numpy_count": True, "verify_s": time.perf_counter() - t0})
        runs[phase] = (launches, shapes)
        os.unlink(out)
    return runs


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


def phase_small(tmp):
    import numpy as np

    from kmer_counter_tpu_torch.__main__ import main

    for k, canonical in ((15, False), (16, False), (55, False), (101, True)):
        rng = np.random.default_rng(k)
        reads = sample_reads(rng, 30_000, 2_000, 150, 0.005)
        reads[7] = ord("T")  # all-T windows (the side count of the two-level table at k=16)
        d = os.path.join(tmp, f"small_{k}")
        write_fastq(os.path.join(d, "in", "a.fastq"), reads[:1000])
        write_fastq(os.path.join(d, "in", "b.fastq"), reads[1000:])
        want = dump_bytes(*numpy_count(reads, k, canonical))
        for impl in ("two", "one"):
            out = os.path.join(d, f"out_{impl}.bin")
            rc = main([f"kmerLength={k}", f"canonical={str(canonical).lower()}", f"tableImpl={impl}",
                       f"inputFileLocation={d}/in", f"outputFile={out}", "tableSlots=40000",
                       "verbose=0"])
            if rc != 0:
                raise AssertionError(f"small CLI run k={k} tableImpl={impl}: rc={rc}")
            check_dump(out, want, f"small CLI run k={k} canonical={canonical} tableImpl={impl}")
            log({"phase": "small", "k": k, "canonical": canonical, "table_impl": impl,
                 "byte_identical_to_numpy_count": True})


def stage_peaks(device, run):
    """One more run with each table stage wrapped: the peak device memory
    inside each stage, over its calls (the card is synchronised around
    every call, so the run's times are not reported)."""
    import torch

    from kmer_counter_tpu_torch.ops import pipeline, table, table2

    stages = [(pipeline, "count_step_two_level"), (table2, "grow2"),
              (table2, "consolidate3"), (table2, "finalize2"),
              (table, "append"), (table, "grow"), (table, "consolidate")]
    peaks = {}

    def wrapped(name, real):
        def call(*args):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            out = real(*args)
            torch.cuda.synchronize()
            peaks[name] = max(peaks.get(name, 0), torch.cuda.max_memory_allocated(device))
            return out

        return call

    reals = [getattr(module, name) for module, name in stages]
    for (module, name), real in zip(stages, reals):
        setattr(module, name, wrapped(f"{module.__name__.rsplit('.', 1)[1]}.{name}", real))
    try:
        run()
    finally:
        for (module, name), real in zip(stages, reals):
            setattr(module, name, real)
    return peaks


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
        log({"phase": "profile", "table_impl": impl, "traced": True, "wall_s": stats.wall_seconds,
             "timers_s": stats.metrics["timers_s"], "device_busy_s": busy_s,
             "device_busy_share": busy_s / stats.wall_seconds, "device_events": len(spans)})
        for name, us in per_name.most_common(top):
            log({"phase": "profile", "table_impl": impl, "device_ms": us / 1e3, "name": name[:120]})


def phase_build():
    """Builds both kernels at once (one nvcc each); logs each build.  At
    once, the build takes as long as the slower nvcc (K1's), not the sum of
    both: 17.25 s instead of 26.15 s on the H100 machine."""
    from kmer_counter_tpu_torch import cuda_build
    from kmer_counter_tpu_torch.ops import lane_sort as ls
    from kmer_counter_tpu_torch.ops import merge_fold_compact as mfc

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(mfc.tile_rows), pool.submit(ls.tile_rows, 1)]:
            f.result()
    for name in (K1["name"], SORT["name"]):
        log({"phase": "build", "kernel": name, "nvcc_s": cuda_build.build_seconds[name]})
        print(cuda_build.build_log.get(name, "").strip(), flush=True)
    log({"phase": "build", "wall_s": time.perf_counter() - t0})


def kernel_entry(spec, runs, timing):
    """The kernels line's entry of one kernel: its launches in each main
    path's run (from the launch counts) beside that path's times, and
    their sums."""
    paths = {path: {"launches": launches[spec["name"]], **timing["paths"][path]}
             for path, (launches, _) in runs.items()}
    return {**spec, "launches": sum(p["launches"] for p in paths.values()),
            "max_abs_err": timing["max_abs_err"], "ms": timing["ms"],
            "plain_ms": timing["plain_ms"], "paths": paths}


def main():
    profile = sys.argv[1:] == ["--profile"]
    if sys.argv[1:] and not profile:
        raise SystemExit(f"usage: {sys.argv[0]} [--profile]")
    require_checkout()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: CUDA is not available — it runs only on an NVIDIA GPU")
    device = torch.device("cuda")

    t_all = time.perf_counter()
    log({"phase": "device", "nvidia_smi": smi_line(), "torch": torch.__version__,
         "cuda": torch.version.cuda, "device_name": torch.cuda.get_device_name(0)})
    phase_build()

    with tempfile.TemporaryDirectory(dir=HERE, prefix="chip_smoke_") as tmp:
        if profile:
            phase_profile(device, tmp)
            print(smi_line(), flush=True)
            return
        runs = phase_main(device, tmp)
        torch.cuda.empty_cache()
        k1 = phase_kernel(device, {path: shapes.k1 for path, (_, shapes) in runs.items()})
        sort = phase_sort_kernel(device, {path: shapes.sort for path, (_, shapes) in runs.items()})
        torch.cuda.empty_cache()
        phase_mid_one(device, tmp)
        phase_small(tmp)
    log({"phase": "done", "seconds": time.perf_counter() - t_all})

    print(smi_line(), flush=True)
    log({"kernels": [kernel_entry(K1, runs, k1), kernel_entry(SORT, runs, sort)]})
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
