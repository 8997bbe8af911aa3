"""Bitonic-merge probe (docs/experiments_bitonic_merge.py), ported.

D2: two sorted windows of T = 1024 keys, A ``[8, 128]`` ascending and B
``[8, 128]`` handed over reversed (descending), merged into ``[16, 128]``
= sort(A ++ B) and checked against ``np.sort``.  D3: the same over a grid
of G = 512 pairs, ``[G, 8, 128]`` x 2 → ``[G, 16, 128]``, checked, then
timed over 10 calls (records a second).  Both run ``ops.probes.pair_merge``
with B descending.  The inputs are the original's (``default_rng(0)``).

    python -m kmer_counter_tpu_torch.probes.experiments_bitonic_merge
"""

from __future__ import annotations

import time

import numpy as np
import torch

from kmer_counter_tpu_torch.ops import probes
from kmer_counter_tpu_torch.ops.u32 import from_numpy, to_numpy
from kmer_counter_tpu_torch.probes import ProbeFailed, check, resolve, sync

T = 1024  # keys a side; merged: 2T = 16 rows x 128 lanes
G = 512  # D3's pairs
REPS = 10  # D3's timed calls


def merge(a: torch.Tensor, b_rev: torch.Tensor) -> torch.Tensor:
    """D2: A ``[8, 128]`` ascending and B ``[8, 128]`` descending → ``[16, 128]``."""
    return probes.pair_merge(a.reshape(1, -1), b_rev.reshape(1, -1), b_descending=True).view(-1, 128)


def merge_many(A: torch.Tensor, B_rev: torch.Tensor) -> torch.Tensor:
    """D3: ``[g, 8, 128]`` pairs, B descending → ``[g, 16, 128]``."""
    g = A.shape[0]
    return probes.pair_merge(A.reshape(g, -1), B_rev.reshape(g, -1), b_descending=True).view(g, -1, 128)


def _sorted_u32(rng, shape) -> np.ndarray:
    return np.sort(rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32), axis=-1)


def main(device=None, g: int = G, reps: int = REPS) -> dict:
    """Runs D2, then D3 over g pairs timed over reps calls, on ``device``
    (cuda by default).  Returns {"compile_run_s", "grid_ms"}; raises on a
    wrong result."""
    device = resolve(device)
    rng = np.random.default_rng(0)
    a, b = _sorted_u32(rng, T), _sorted_u32(rng, T)
    t0 = time.perf_counter()
    out = to_numpy(merge(from_numpy(a.reshape(8, 128), device), from_numpy(b[::-1].reshape(8, 128), device)))
    compile_run = time.perf_counter() - t0
    print("compile+run", compile_run, flush=True)
    want = np.sort(np.concatenate([a, b]))
    got = out.reshape(-1)
    ok = np.array_equal(got, want)
    print("merge correct:", ok, flush=True)
    if not ok:
        bad = np.flatnonzero(got != want)[:5]
        raise ProbeFailed(f"D2 merge: first mismatches at {bad}: {got[bad]} against {want[bad]}")

    A, B = _sorted_u32(rng, (g, T)), _sorted_u32(rng, (g, T))
    jA = from_numpy(A.reshape(g, 8, 128), device)
    jB = from_numpy(B[:, ::-1].reshape(g, 8, 128), device)
    o = merge_many(jA, jB)
    check("D3 grid merge", np.array_equal(to_numpy(o).reshape(g, -1), np.sort(np.concatenate([A, B], 1), 1)))
    print("grid merge correct: True", flush=True)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        o = merge_many(jA, jB)
    to_numpy(o[0, 0, :1])
    dt = (time.perf_counter() - t0) / reps
    n = g * 2 * T
    print(f"grid merge: {dt * 1e3:.2f} ms for {n} records -> {n / dt / 1e6:.0f} M rec/s", flush=True)
    return {"compile_run_s": compile_run, "grid_ms": dt * 1e3}


if __name__ == "__main__":
    main()
