"""The compaction probe (docs/probe_compact_overhead.py), ported.

Variants (argv-selected, all by default), each over N = N_TILES x TILE
rows (576 tiles of 65,536), 3 operands and a live flag at ~3% density:

  copy     D1's copy body: the operands copied, tile by tile
  cumsum   D1's cumsum body: each operand plus the tile's exclusive count
           of dead rows (mod 2^32)
  network  D1's network body: each tile's live rows moved to its front in
           order, zeros after them; nothing crosses a tile
  full     K2 (``ops.compact_live``, num_keys=2) as the port ships it

The first three run ``ops.probes.tile_compact``.  Each variant's first
call is checked against a NumPy model of it; then it is timed as the
original times it: chains of CHAIN calls, each fed the one before's
output, ending in a read of two scalars on the host, best of REPS.

    python -m kmer_counter_tpu_torch.probes.probe_compact_overhead [copy|cumsum|network|full ...]
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from kmer_counter_tpu_torch.ops import compact_live as cl
from kmer_counter_tpu_torch.ops import probes
from kmer_counter_tpu_torch.ops.u32 import from_numpy, to_numpy
from kmer_counter_tpu_torch.probes import check, resolve

N_TILES = 576
TILE = probes.TILE
N_OPS = 3
CHAIN = 8
REPS = 3
LIVE_DENSITY = 0.03  # ~3% live, uniformly spread (the normal-cardinality regime)
VARIANTS = ("copy", "cumsum", "network", "full")
T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[+{time.perf_counter() - T0:6.1f}s] {msg}", flush=True)


def variant(name: str):
    """The variant's call: (operand lanes, live) → ``[N_OPS, N]``."""
    if name == "full":
        return lambda ops, live: cl.compact_live(ops, live, num_keys=2)
    return lambda ops, live: probes.tile_compact(ops, live, name)


def expected(name: str, ops: np.ndarray, live: np.ndarray) -> np.ndarray:
    """A NumPy model of one call: ``ops`` ``[N_OPS, N]`` uint32."""
    n_ops, n = ops.shape
    alive = live != 0
    if name == "copy":
        return ops
    if name == "full":
        out = np.zeros_like(ops)
        out[:2] = 0xFFFFFFFF
        out[:, : int(alive.sum())] = ops[:, alive]
        return out
    tiles = alive.reshape(-1, TILE)
    x = ops.reshape(n_ops, -1, TILE)
    if name == "cumsum":
        dead = (~tiles).astype(np.uint32)
        return (x + (np.cumsum(dead, axis=1, dtype=np.uint32) - dead)).reshape(n_ops, n)
    t, c = np.nonzero(tiles)
    rank = np.cumsum(tiles, axis=1) - 1
    out = np.zeros_like(x)
    out[:, t, rank[t, c]] = x[:, t, c]
    return out.reshape(n_ops, n)


def make_inputs(n_tiles: int) -> tuple[np.ndarray, np.ndarray]:
    """The original's inputs over n_tiles tiles: (``[N_OPS, N]`` uint32
    operands, ``[N]`` uint32 live flags), from ``default_rng(3)``."""
    n = n_tiles * TILE
    rng = np.random.default_rng(3)
    ops = np.stack([rng.integers(0, 2**32, n, np.uint64).astype(np.uint32) for _ in range(N_OPS)])
    return ops, (rng.random(n) < LIVE_DENSITY).astype(np.uint32)


def run_chain(fn, ops, live, k):
    """k dependent calls, each fed the one before's output; returns the last
    output's lanes, and a sum of two of its scalars read on the host."""
    cur = ops
    for _ in range(k):
        cur = list(fn(cur, live).unbind(0))
    return cur, (int(cur[0][0]) + int(cur[1][-1])) & 0xFFFFFFFF


def main(device=None, n_tiles: int = N_TILES, chain: int = CHAIN, reps: int = REPS, names=None) -> dict:
    """Checks and times each variant in ``names`` (all by default) on
    ``device`` (cuda by default).  Returns {variant: {"first_s", "best_ms",
    "us_per_tile", "times_ms"}}; raises on a wrong result."""
    device = resolve(device)
    n = n_tiles * TILE
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)
    log(f"device: {where}  N={n} ({n_tiles} tiles) ops={N_OPS}")
    ops_np, live_np = make_inputs(n_tiles)
    ops, live = list(from_numpy(ops_np, device).unbind(0)), from_numpy(live_np, device)

    results = {}
    for name in names or VARIANTS:
        fn = variant(name)
        t0 = time.perf_counter()
        first, _ = run_chain(fn, ops, live, 1)
        first_s = time.perf_counter() - t0
        check(name, np.array_equal(to_numpy(torch.stack(first)), expected(name, ops_np, live_np)))
        del first
        log(f"{name}: compile+first run {first_s:.1f}s, correct")
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            run_chain(fn, ops, live, chain)
            times.append((time.perf_counter() - t0) / chain)
        best = min(times)
        log(f"{name}: best {best * 1e3:.2f}ms/call x{chain} "
            f"({best / n_tiles * 1e6:.1f} us/tile, {[f'{t * 1e3:.1f}' for t in times]})")
        results[name] = {"first_s": first_s, "best_ms": best * 1e3, "us_per_tile": best / n_tiles * 1e6,
                         "times_ms": [t * 1e3 for t in times]}
    return results


if __name__ == "__main__":
    main(names=[a for a in sys.argv[1:] if a in VARIANTS] or None)
