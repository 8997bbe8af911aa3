"""Mosaic capability probes (docs/experiments_mosaic_caps.py), ported.

Q1 (D4): ``[16, 128]`` rows rolled by 3 (``np.roll(x, 3, 0)``).
Q2 (D5): the same rows rotated by -3 (``np.roll(x, -3, 0)``).
Q3 (D6): 8-row windows of ``[64, 128]`` at starts 1, 9, 17, 33 held in a
    device tensor (the original's scalar prefetch) → ``[4, 8, 128]``.
Q4 (D7): the merge of two sorted halves of R x 128 keys (R = 512: 64K
    each) into ``[2R, 128]`` = sort(A ++ B), with its time a merge.

Q1-Q3 run ``ops.probes.row_gather``, Q4 ``ops.probes.pair_merge`` with B
ascending.  The inputs are the original's: one ``default_rng(0)`` drawn
in the same order.

    python -m kmer_counter_tpu_torch.probes.experiments_mosaic_caps
"""

from __future__ import annotations

import time

import numpy as np
import torch

from kmer_counter_tpu_torch.ops import probes
from kmer_counter_tpu_torch.ops.u32 import from_numpy, to_numpy
from kmer_counter_tpu_torch.probes import check, resolve, sync

R = 512  # rows a half of Q4: R * 128 = 65,536 keys
REPS = 50  # Q4's timed merges
WINDOW_ROWS = 8
STARTS = (1, 9, 17, 33)  # Q3's window starts, deliberately not multiples of 8


def _u32(rng, shape) -> np.ndarray:
    return rng.integers(0, 2**32, shape, np.uint64).astype(np.uint32)


def roll_rows(x: torch.Tensor, shift: int) -> torch.Tensor:
    """x's rows rotated: output row j is x[(j + shift) mod R]."""
    return probes.row_gather(x, torch.zeros(1, dtype=torch.int32, device=x.device), x.shape[0], shift)[0]


def q1(rng, device) -> str:
    x = _u32(rng, (16, 128))
    out = roll_rows(from_numpy(x, device), -3)
    check("Q1", np.array_equal(to_numpy(out), np.roll(x, 3, 0)))
    return "correct"


def q2(rng, device) -> str:
    x = _u32(rng, (16, 128))
    out = roll_rows(from_numpy(x, device), 3)
    check("Q2", np.array_equal(to_numpy(out), np.roll(x, -3, 0)))
    return "correct"


def q3(rng, device) -> str:
    x = _u32(rng, (64, 128))
    starts = torch.tensor(STARTS, dtype=torch.int32, device=device)
    out = probes.row_gather(from_numpy(x, device), starts, WINDOW_ROWS, 0)
    want = np.stack([x[s : s + WINDOW_ROWS] for s in STARTS])
    check("Q3", np.array_equal(to_numpy(out), want))
    return "correct"


def q4(rng, device, r: int = R, reps: int = REPS) -> str:
    a = np.sort(_u32(rng, r * 128))
    b = np.sort(_u32(rng, r * 128))
    ja, jb = from_numpy(a.reshape(1, -1), device), from_numpy(b.reshape(1, -1), device)

    def f():
        return probes.pair_merge(ja, jb, b_descending=False).view(2 * r, 128)

    got = to_numpy(f()).reshape(-1)
    check("Q4", np.array_equal(got, np.sort(np.concatenate([a, b]))))
    f()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        o = f()
    to_numpy(o[0, :1])
    dt = (time.perf_counter() - t0) / reps
    n = 2 * r * 128
    return f"correct {dt * 1e6:.0f}us for {n} -> {n / dt / 1e6:.0f}M elem/s"


def main(device=None, r: int = R, reps: int = REPS) -> dict:
    """Runs Q1-Q4 on ``device`` (cuda by default); prints a line each and
    returns {label: result}.  Raises on a wrong result."""
    device = resolve(device)
    rng = np.random.default_rng(0)
    results = {}
    for label, run in (("Q1 roll axis0", q1), ("Q2 unaligned row slice+concat", q2),
                       ("Q3 dyn DMA + scalar prefetch", q3),
                       ("Q4 odd-even merge 2x64K", lambda rng, device: q4(rng, device, r, reps))):
        results[label] = run(rng, device)
        print(f"{label}: OK {results[label]}", flush=True)
    return results


if __name__ == "__main__":
    main()
