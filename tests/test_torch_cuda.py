"""The CUDA kernels against their plain torch versions, on the card.

Every test here needs an NVIDIA GPU (marker ``gpu``) and skips without
one.  This file imports no JAX — the card machine has none — so run it
without the repo's conftest (which configures JAX):

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

Its case builders are shared with the CPU tests that hold the plain
versions against the JAX package (tests/test_torch_merge_fold_compact.py,
test_torch_merge_runs.py, test_torch_compact_live.py,
test_torch_lane_sort.py, test_torch_table2.py, test_torch_engine.py,
test_torch_fused_extract.py, test_torch_probes.py) and with
chip_smoke.py.  Tolerance: bit-exact equality — everything is integer.
The sort and merge_sorted_runs leave the order among equal keys
unspecified, so their payloads are compared as a multiset per key.
"""

import os

import numpy as np
import pytest
import torch

# Rows per merge tile of the CPU cases: the Pallas tile the JAX package's
# interpret-mode tests use, and the rows per block of the K5 CUDA passes.
TILE = 1024
M = 0xFFFFFFFF
# Merged rows per tile of the K1/K3/K4 CUDA kernel (fold_kernel in
# csrc/merge_fold_compact.cu) at NL = 1..8.
FOLD_TILE = {NL: 256 * (16 if NL <= 2 else 8) for NL in range(1, 9)}
# Rows per leaf tile of the sort kernel (csrc/lane_sort.cu) at NL = 1..8,
# and rows per block of the compaction kernel (csrc/compact_live.cu).
SORT_TILE = {1: 16384, 2: 16384, 3: 8192, 4: 8192, 5: 4096, 6: 4096, 7: 4096, 8: 4096}
COMPACT_TILE = 8192
# Sizes of the compaction cases: small, around 4096 rows and around the
# kernel's tile (the odd ones no multiple of 4).
COMPACT_SIZES = [0, 1, 31, 4095, 4096, 4097, COMPACT_TILE - 1, COMPACT_TILE, COMPACT_TILE + 1,
                 2 * COMPACT_TILE + 1, 1_000_003]


def _sorted_rows(rows: np.ndarray) -> np.ndarray:
    return rows[np.lexsort(rows.T[::-1])] if len(rows) else rows


def _case(a_rows, a_counts, b_rows_asc, b_live_asc):
    """Kernel operands from row-major pieces: A [na, NL] ascending with
    counts; B [nb, NL] ascending with liveness, stored DESCENDING."""
    a_rows = np.asarray(a_rows, np.uint32)
    b_rows_asc = np.asarray(b_rows_asc, np.uint32)
    return (
        np.ascontiguousarray(a_rows.T),
        np.asarray(a_counts, np.uint32),
        np.ascontiguousarray(b_rows_asc[::-1].T),
        np.ascontiguousarray(np.asarray(b_live_asc, np.uint32)[::-1]),
    )


def random_case(rng, NL, na, nb, pool=None, sent_frac=0.05, dead_frac=0.1, a_live=0.8):
    """A consolidation-shaped case: A = unique sorted prefix rows with
    counts (some near 2^32), at most a_live of them, and a sentinel/0 tail;
    B = raw rows drawn with repeats from the same key pool, with masked
    windows (sentinel, live) and dead rows (all-zero key, liveness 0)."""
    pool = pool or max((na + nb) // 3, 4)
    keys = rng.integers(0, 2**32, (pool, NL), dtype=np.uint64).astype(np.uint32)
    keys[0] = 0  # the A^k key collides with dead rows
    a_rows = np.unique(keys[rng.integers(0, pool, na)], axis=0)[: int(na * a_live)]
    n_live_a = len(a_rows)
    a_counts = rng.integers(1, 6, n_live_a).astype(np.uint32)
    a_counts[rng.random(n_live_a) < 0.02] = rng.integers(2**31, 2**32, dtype=np.uint64)
    a_rows = np.vstack([a_rows, np.full((na - n_live_a, NL), M, np.uint32)])
    a_counts = np.concatenate([a_counts, np.zeros(na - n_live_a, np.uint32)])
    b_rows = keys[rng.integers(0, pool, nb)]
    n_sent, n_dead = int(nb * sent_frac), int(nb * dead_frac)
    b_rows[:n_sent] = M
    b_rows = _sorted_rows(b_rows)
    b_live = np.ones(nb, np.uint32)
    b_rows[:n_dead] = 0
    b_live[:n_dead] = 0
    return (NL, *_case(a_rows, a_counts, b_rows, b_live))


def _dead_rows_collide(rng):
    # genuine A^k rows (all-zero key) in A and live in B, next to dead
    # all-zero rows of B: the run total is the genuine multiplicity only
    NL, na, nb = 2, TILE, TILE
    a = _sorted_rows(rng.integers(0, 8, (na, NL)).astype(np.uint32))
    b = _sorted_rows(rng.integers(0, 8, (nb, NL)).astype(np.uint32))
    b[: TILE // 4] = 0
    live = np.ones(nb, np.uint32)
    live[: TILE // 8] = 0
    return (NL, *_case(a, np.ones(na, np.uint32), b, live))


def _run_spans_all_tiles(rng):
    NL, na, nb = 1, 2 * TILE, 2 * TILE
    return (NL, *_case(np.full((na, 1), 7), np.ones(na), np.full((nb, 1), 7),
                       rng.integers(0, 2, nb)))


def _run_ends_on_tile_edge(rng):
    NL = 2
    half = np.concatenate([np.full((TILE // 2, NL), 5), np.full((TILE // 2, NL), 9)])
    return (NL, *_case(half, np.ones(TILE), half, np.ones(TILE)))


def _count_wraparound(rng):
    # key 3 totals exactly 2^32 and is dropped; key 4 wraps to 2^31
    h = TILE // 2
    a = np.repeat([[3], [4]], h, axis=0)
    ac = np.concatenate([np.full(h, 1 << 23), np.full(h, 3 << 22)])
    ac[0] -= h  # B adds h live rows of key 3: h * 2^23 = 2^32
    b = np.repeat([[3], [6]], h, axis=0)
    return (1, *_case(a, ac, b, np.ones(TILE)))


def _na_much_larger(rng):
    return random_case(rng, 4, 4 * TILE - 128, 128)


def _na_much_smaller(rng):
    return random_case(rng, 7, 128, 4 * TILE - 128)


def _only_sentinels_and_dead(rng):
    NL, na, nb = 2, TILE, TILE
    return (NL, *_case(np.full((na, NL), M), np.zeros(na), np.vstack(
        [np.zeros((nb // 2, NL)), np.full((nb // 2, NL), M)]),
        np.concatenate([np.zeros(nb // 2), np.ones(nb // 2)])))


EDGE_CASES = {
    "dead_rows_collide_with_a_zero_key": _dead_rows_collide,
    "run_spans_all_tiles": _run_spans_all_tiles,
    "run_ends_on_tile_edge": _run_ends_on_tile_edge,
    "count_wraparound": _count_wraparound,
    "na_much_larger_than_nb": _na_much_larger,
    "na_much_smaller_than_nb": _na_much_smaller,
    "only_sentinels_and_dead_rows": _only_sentinels_and_dead,
}


# Cases at the K1/K3/K4 kernel's own tile (FOLD_TILE): sizes at its edges, the
# sentinel tail starting around a tile edge, a prefix that is almost all
# sentinel tail (as the pre-grown two-level prefix is), an input with no
# other key, keys next to the sentinel, a run over more tiles than a
# look-back round reads (32), and totals that wrap across tiles.
_F2, _F7 = FOLD_TILE[2], FOLD_TILE[7]


def _sentinel_tail_at(rng, S):
    """NL = 2; the first S merged rows are not the sentinel (a third of
    them A's), then A's sentinel tail and B's masked windows."""
    NL, a_live = 2, S // 3
    keys = np.unique(rng.integers(0, 2**31, (S + 100, NL)).astype(np.uint32), axis=0)
    keys = keys[rng.permutation(len(keys))[:S]]
    a_rows = _sorted_rows(keys[:a_live])
    b_rows = _sorted_rows(np.vstack([keys[a_live:], np.full((50, NL), M)]))
    a = np.vstack([a_rows, np.full((_F2 + 7, NL), M)])
    ac = np.concatenate([rng.integers(1, 6, a_live), np.zeros(_F2 + 7)])
    return (NL, *_case(a, ac, b_rows, np.ones(len(b_rows))))


def _next_to_sentinel(rng):
    # keys (M, .., M, M-1) and (M, .., M-1, M) just below the sentinel, live
    # in A and B, then A's sentinel tail and B's masked windows (sentinel,
    # liveness 1)
    NL = 3
    near = np.array([[M, M, M - 1], [M, M - 1, M]], np.uint32)
    a = np.vstack([_sorted_rows(rng.integers(0, 2**31, (_F7, NL))), near[::-1], np.full((3 * _F7, NL), M)])
    ac = np.concatenate([np.ones(_F7 + 2), rng.integers(0, 3, 3 * _F7)])
    b = _sorted_rows(np.vstack([rng.integers(0, 2**31, (_F7 // 2, NL)), np.repeat(near, 5, axis=0),
                                np.full((_F7 // 3, NL), M)]))
    return (NL, *_case(a, ac, b, np.ones(len(b))))


def _run_longer_than_look_back(rng):
    NL, nb = 1, 65 * FOLD_TILE[1] + 17
    b = np.sort(np.concatenate([np.full(nb - 40, 7), np.full(40, 9)]))
    live = np.ones(nb)
    live[rng.integers(0, nb, 1000)] = 0  # the kernel takes liveness as the count
    return (NL, *_case([[5], [7], [M]], [1, 1, 0], b[:, None], live))


def _totals_wrap_across_tiles(rng):
    # key (0, 3): 2^32 - 3T in A + 3T live rows of B, a total of 0, dropped;
    # key (0, 4): 2^32 - 1 + 2T - 1 live rows, wraps to 2T - 2
    NL, T = 2, _F2
    a = [[0, 1], [0, 3], [0, 4], [0, 8], [M, M], [M, M]]
    ac = [1, 2**32 - 3 * T, 2**32 - 1, 5, 0, 0]
    b = np.array([[0, 2]] * 11 + [[0, 3]] * (3 * T) + [[0, 4]] * (2 * T - 1) + [[0, 9]] * 3)
    return (NL, *_case(a, ac, b, np.ones(len(b))))


FOLD_CASES = {
    **{f"n_fold_tile_{d:+d}": (lambda rng, d=d: random_case(rng, 2, _F2 // 3, _F2 - _F2 // 3 + d))
       for d in (-1, 0, 1)},
    "n_two_fold_tiles_plus_1_nl7": lambda rng: random_case(rng, 7, _F7 // 2, 3 * _F7 // 2 + 1),
    **{f"sentinel_tail_at_fold_tile_{d:+d}": (lambda rng, d=d: _sentinel_tail_at(rng, _F2 + d))
       for d in (-1, 0, 1)},
    "prefix_97pct_sentinel": lambda rng: random_case(rng, 2, 20 * _F2, 3 * _F2, a_live=0.03),
    "all_sentinel": lambda rng: (2, *_case(np.full((5 * _F2, 2), M), rng.integers(0, 5, 5 * _F2),
                                           np.full((_F2 + 3, 2), M), np.ones(_F2 + 3))),
    "keys_next_to_the_sentinel": _next_to_sentinel,
    "run_longer_than_look_back": _run_longer_than_look_back,
    "totals_wrap_across_tiles": _totals_wrap_across_tiles,
}


# table2.consolidate3's keyword combinations, which select the JAX
# function's variants: the default runs K1; the split variants run a merge
# kernel (K3, K4 or K5) and then K2.
CONSOLIDATE_VARIANTS = {
    "merge_fold_compact": dict(fold_fused=True, bitonic=True, fused_compact=True),
    "fold_bitonic": dict(fold_fused=True, bitonic=True, fused_compact=False),
    "fold": dict(fold_fused=True, bitonic=False, fused_compact=False),
    "plain": dict(fold_fused=False, bitonic=False, fused_compact=False),
}
SPLIT_VARIANTS = sorted(set(CONSOLIDATE_VARIANTS) - {"merge_fold_compact"})
# The merge kernel that each split variant launches (ops.merge_runs names).
VARIANT_MERGE = {
    "fold_bitonic": "merge_sorted_runs_fold_bitonic",
    "fold": "merge_sorted_runs_fold",
    "plain": "merge_sorted_runs",
}


def compact_case(rng, NL, n, density):
    """K2 operands: NL random key lanes and a count lane (lists of numpy
    uint32 arrays), and live flags, nonzero (any uint32 value) at about
    the given density."""
    ops = list(rng.integers(0, 2**32, (NL + 1, n), dtype=np.uint64).astype(np.uint32))
    live = rng.integers(1, 2**32, n, dtype=np.uint64).astype(np.uint32)
    live[rng.random(n) >= density] = 0
    return ops, live


def ascending_case(case):
    """A case with B read ascending (the layout of K4 and K5)."""
    NL, a, ac, bd, bc = case
    return NL, a, ac, np.ascontiguousarray(bd[:, ::-1]), np.ascontiguousarray(bc[::-1])


def operands(case, device):
    """Case → (a_ops, b_desc_ops, num_keys) as int32 tensors on device."""
    from kmer_counter_tpu_torch.ops.u32 import from_numpy

    NL, a, ac, bd, bc = case
    a_ops = [from_numpy(a[i], device) for i in range(NL)] + [from_numpy(ac, device)]
    b_ops = [from_numpy(bd[i], device) for i in range(NL)] + [from_numpy(bc, device)]
    return a_ops, b_ops, NL


# Window starts (read bytes) per block of the extraction kernel K8
# (csrc/fused_extract.cu): 256 threads stage 16 bytes each, the tile, a
# 128-base halo and 16 bytes of alignment.
EXTRACT_TILE = 3952
# K8's k at random (each at L = k, k+1, 100, 151): every lane count, full
# and partial last lanes.
EXTRACT_KS = [1, 15, 16, 31, 32, 33, 55, 64, 65, 101, 127, 128]


def extract_reads(rng, R, L):
    """[R, L] uint8 reads for K8: A/C/G/T, a quarter lower case, one base in
    200 invalid (N, n, a zero byte, '.', 'U', and 0xC1, 0xE3: A and C but
    for their high bits); with R >= 3, read 1 all T in either case (the
    all-T side count at k % 16 == 0) and the second half of the last read
    zero bytes (a padded read)."""
    bases = np.frombuffer(b"ACGTACGTACGTacgt", np.uint8)
    reads = bases[rng.integers(0, len(bases), (R, L))]
    invalid = np.frombuffer(b"Nn\x00.U\xc1\xe3", np.uint8)
    bad = rng.random((R, L)) < 0.005
    reads[bad] = invalid[rng.integers(0, len(invalid), int(bad.sum()))]
    if R >= 3:
        reads[1] = np.where(rng.random(L) < 0.3, ord("t"), ord("T"))
        reads[-1, L // 2 :] = 0
    return reads


def _extract_case(reads, k, canonical, start=0, off=0):
    """A K8 case: the reads, k, canonical, the reads' byte offset past a
    16-byte boundary (``start``) and the destination column of keys mode."""
    return dict(reads=reads, k=k, canonical=canonical, start=start, off=off)


def _lower(reads):
    return np.where((reads >= ord("A")) & (reads <= ord("Z")), reads + 32, reads).astype(np.uint8)


def _all_t(k):
    reads = np.full((5, k + 40), ord("T"), np.uint8)
    reads[1, ::3] = ord("t")
    reads[2, 7] = ord("N")
    return _extract_case(reads, k, False)


EXTRACT_CASES = {
    "lower_case": lambda rng: _extract_case(_lower(extract_reads(rng, 300, 100)), 31, True),
    "n_bases": lambda rng: _extract_case(np.where(rng.random((300, 100)) < 0.1, np.uint8(ord("N")),
                                                  extract_reads(rng, 300, 100)), 15, False),
    "zero_padded_rows": lambda rng: _extract_case(np.pad(extract_reads(rng, 200, 151), ((0, 100), (0, 0))), 55,
                                                  True),
    **{f"all_t_k{k}": (lambda rng, k=k: _all_t(k)) for k in (16, 32, 64, 128)},
    "raw_off": lambda rng: _extract_case(extract_reads(rng, 500, 100), 31, True, off=1_234_567),
    "raw_off_allt": lambda rng: _extract_case(extract_reads(rng, 500, 100), 32, False, off=999_999),
    "r_1": lambda rng: _extract_case(extract_reads(rng, 1, 151), 101, True),
    "r_one_past_the_tile": lambda rng: _extract_case(extract_reads(rng, EXTRACT_TILE // 100 + 1, 100), 31, True),
    # 52 reads of 76 bases: one tile exactly
    "tile_of_reads_exactly": lambda rng: _extract_case(extract_reads(rng, EXTRACT_TILE // 76, 76), 64, False),
    "long_reads_row_tiled": lambda rng: _extract_case(extract_reads(rng, 3, 3 * EXTRACT_TILE + 5), 127, True),
    "l_equals_k": lambda rng: _extract_case(extract_reads(rng, 5000, 64), 64, True),
    **{f"misaligned_{s}": (lambda rng, s=s: _extract_case(extract_reads(rng, 700, 100), 33, s % 2 == 1, start=s))
       for s in (1, 7, 15)},
    # blocks whose range begins inside a read's last k-1 bases (their first
    # window is the next read's), and a last block that starts no window
    "blocks_begin_in_tails": lambda rng: _extract_case(extract_reads(rng, 2000, 151), 101, True),
    "last_block_without_a_window": lambda rng: _extract_case(extract_reads(rng, _ends_in_a_tail(100, 31), 100), 31,
                                                             True),
    # the row by the multiplier at the longest read below the tile, by a compare at the tile
    "l_below_the_tile": lambda rng: _extract_case(extract_reads(rng, 7, EXTRACT_TILE - 1), 31, True),
    "l_at_the_tile": lambda rng: _extract_case(extract_reads(rng, 5, EXTRACT_TILE), 64, False),
    # keys at a column 0..3 mod 4 on every lane: R makes the region's width
    # (off + n + 5, as extract_vs_plain and chip_smoke.compare_k8 allocate
    # it) a multiple of 4, so each lane's row starts at the same column mod 4
    **{f"dst_column_mod4_{r}": (lambda rng, r=r: _extract_case(extract_reads(rng, 1000 + (3 - r) % 4, 100), 32,
                                                                r % 2 == 0, off=400_000 + r))
       for r in range(4)},
}


def _ends_in_a_tail(L, k):
    """Reads R, about 1000, whose R*L bytes end 1..k-1 bytes past a
    multiple of the tile: the last block begins in the last read's tail."""
    return next(R for R in range(1000, 1000 + EXTRACT_TILE) if 0 < R * L % EXTRACT_TILE < k)


def extract_reads_on(reads, device, start=0):
    """The reads as a contiguous [R, L] uint8 tensor on device whose data
    begins ``start`` bytes past a 16-byte boundary (as a row slice of the
    mesh's chunk may)."""
    R, L = reads.shape
    buf = torch.zeros(R * L + 16, dtype=torch.uint8, device=device)
    out = buf[start : start + R * L].view(R, L)
    out.copy_(torch.from_numpy(np.ascontiguousarray(reads)))
    return out


def _sort_case(keys, payload):
    return np.ascontiguousarray(np.asarray(keys, np.uint32)), np.asarray(payload, np.uint32)


def _sort_random(rng, NL, n, pool=None):
    """Keys drawn with repeats from a pool (a fifth of the rows are
    all-ones), payload = row index + 1."""
    pool = pool or max(n // 3, 1)
    keys = rng.integers(0, 2**32, (NL, pool), dtype=np.uint64).astype(np.uint32)
    keys[:, : max(pool // 5, 1)] = M
    return _sort_case(keys[:, rng.integers(0, pool, n)], np.arange(1, n + 1))


def _sort_all_ones_across_tile_edges(rng):
    # genuine all-ones keys with nonzero payloads, in clusters that
    # straddle every multiple of 1024 rows: the leaf's merge rounds, the
    # merge pass's output tiles and the leaf tiles
    NL, n = 2, 3 * SORT_TILE[2] + 5
    keys = rng.integers(0, 2**32, (NL, n), dtype=np.uint64).astype(np.uint32)
    keys[:, rng.random(n) < 0.4] = M
    for edge in range(1024, n, 1024):
        keys[:, edge - 9 : edge + 9] = M
    return _sort_case(keys, rng.integers(1, 2**32, n, dtype=np.uint64))


SORT_CASES = {
    "n_0": lambda rng: _sort_case(np.zeros((3, 0)), np.zeros(0)),
    "n_1": lambda rng: _sort_case([[M], [5], [M], [0], [1]], [7]),
    "below_one_tile": lambda rng: _sort_random(rng, 2, 700),
    "ragged_n": lambda rng: _sort_random(rng, 3, 100_003),
    "all_equal": lambda rng: _sort_case(np.full((2, 50_000), 7), np.arange(50_000)),
    "all_ones_only": lambda rng: _sort_case(np.full((1, 9000), M), np.arange(1, 9001)),
    "sorted": lambda rng: _sort_case(np.sort(_sort_random(rng, 4, 30_000)[0], axis=1), np.arange(30_000)),
    "reversed": lambda rng: _sort_case(np.sort(_sort_random(rng, 4, 30_000)[0], axis=1)[:, ::-1],
                                       np.arange(30_000)),
    "all_ones_across_tile_edges": _sort_all_ones_across_tile_edges,
    "payload_is_row_index": lambda rng: _sort_case(_sort_random(rng, 7, 77_777, pool=500)[0],
                                                   np.arange(77_777)),
}


def _sort_ordered(rng, NL, n, order):
    keys, payload = _sort_random(rng, NL, n)
    keys = keys[:, np.lexsort(keys[::-1])]
    return _sort_case(keys if order == "presorted" else keys[:, ::-1], payload)


# At the leaf tile's edges (NL = 2 and 7), and at 4 leaf tiles + 1 rows,
# which takes three merge passes (an odd count: the result lies in the
# second buffer), on random, presorted, reversed, all-equal and all-ones keys.
_T2, _T7 = SORT_TILE[2], SORT_TILE[7]
_ODD = 4 * _T2 + 1
SORT_CASES.update({
    "leaf_tile_minus_1": lambda rng: _sort_random(rng, 2, _T2 - 1),
    "leaf_tile": lambda rng: _sort_random(rng, 2, _T2),
    "leaf_tile_plus_1": lambda rng: _sort_random(rng, 2, _T2 + 1),
    "two_leaf_tiles_plus_1": lambda rng: _sort_random(rng, 2, 2 * _T2 + 1),
    "two_leaf_tiles_plus_1_nl7": lambda rng: _sort_random(rng, 7, 2 * _T7 + 1),
    "odd_passes_random": lambda rng: _sort_random(rng, 2, _ODD),
    "odd_passes_presorted": lambda rng: _sort_ordered(rng, 2, _ODD, "presorted"),
    "odd_passes_reversed": lambda rng: _sort_ordered(rng, 2, _ODD, "reversed"),
    "odd_passes_all_equal": lambda rng: _sort_case(np.full((2, _ODD), 7), np.arange(_ODD)),
    "odd_passes_all_ones": lambda rng: _sort_case(np.full((2, _ODD), M), np.arange(1, _ODD + 1)),
})


def column_slices(keys, payload, device, start=1):
    """(keys, payload) numpy rows → int32 tensors that are column slices
    of a wider table starting `start` columns in: with start % 4 != 0 no
    lane starts on a 16-byte boundary."""
    from kmer_counter_tpu_torch.ops.u32 import from_numpy

    NL, n = keys.shape
    width = -(-(n + start) // 4) * 4 + 4  # a multiple of 4: every lane starts `start` words in
    table = np.zeros((NL + 1, width), np.uint32)
    table[:NL, start : start + n] = keys
    table[NL, start : start + n] = payload
    t = from_numpy(table, device)
    return t[:NL, start : start + n], t[NL, start : start + n]


def sort_outputs_agree(got, want) -> bool:
    """(keys, payload) pairs of torch tensors: keys bit-identical, and the
    same payload multiset under each key."""
    from kmer_counter_tpu_torch.ops.sortcount import lex_argsort

    if not torch.equal(got[0], want[0]):
        return False
    rows = [torch.cat([k, p[None]]) for k, p in (got, want)]
    return torch.equal(*[r[:, lex_argsort(r)] for r in rows])


# ---- tests on the card -----------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    return torch.device("cuda")


def _kernel_vs_plain(case, device, out_rows=None):
    from kmer_counter_tpu_torch.ops import merge_fold_compact as mfc

    a_ops, b_ops, NL = operands(case, device)
    before = mfc.launches
    out, live = mfc.merge_fold_compact(a_ops, b_ops, NL, out_rows)
    torch.cuda.synchronize()
    assert mfc.launches == before + (1 if a_ops[0].numel() + b_ops[0].numel() else 0)
    want, want_live = mfc.merge_fold_compact_reference(a_ops, b_ops, NL, out_rows)
    assert int(live) == int(want_live)
    assert torch.equal(out, want)
    return int(live)


@pytest.mark.gpu
def test_kernel_tile_matches_case_tile(cuda):
    from kmer_counter_tpu_torch.ops import merge_fold_compact as mfc

    assert [mfc.tile_rows(NL) for NL in range(1, 9)] == [FOLD_TILE[NL] for NL in range(1, 9)]
    assert mfc.tile_rows(9) == 0
    assert mfc._lib().mfc_tile_rows() == TILE  # the K5 passes


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_kernel_edge_cases(cuda, name):
    _kernel_vs_plain(EDGE_CASES[name](np.random.default_rng(0)), cuda)


# The kernels that run fold_kernel: K1, K3 and K4 (B ascending).
FOLD_KERNELS = ["merge_fold_compact", "merge_sorted_runs_fold_bitonic", "merge_sorted_runs_fold"]


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", FOLD_KERNELS)
@pytest.mark.parametrize("name", sorted(FOLD_CASES))
def test_fold_kernel_cases(cuda, kernel, name):
    # K4 takes each case in its ascending layout (merge_case_layout): B's
    # sentinel rows last, the sentinel tail one row before, at and after a
    # tile edge, a run over 65 tiles, totals that wrap across tiles
    case = FOLD_CASES[name](np.random.default_rng(0))
    if kernel == "merge_fold_compact":
        _kernel_vs_plain(case, cuda)
    else:
        _merge_vs_plain(kernel, case, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("where", ["zero", "below_live", "at_live", "above_live", "all"])
@pytest.mark.parametrize("name", ["n_fold_tile_+1", "prefix_97pct_sentinel", "totals_wrap_across_tiles",
                                  "all_sentinel"])
def test_k1_with_out_rows(cuda, name, where):
    # the output cut to out_rows columns: live rows of rank out_rows and
    # above dropped, the fill stopping at out_rows, the live count whole
    from kmer_counter_tpu_torch.ops import merge_fold_compact as mfc

    case = FOLD_CASES[name](np.random.default_rng(0))
    a_ops, b_ops, NL = operands(case, cuda)
    live = int(mfc.merge_fold_compact_reference(a_ops, b_ops, NL)[1])
    n = a_ops[0].numel() + b_ops[0].numel()
    out_rows = {"zero": 0, "below_live": live // 2, "at_live": live, "above_live": (live + n + 1) // 2,
                "all": n}[where]
    assert _kernel_vs_plain(case, cuda, out_rows) == live


def fold_column_slices(case, device, start):
    """K1/K3/K4 operands whose lanes are column slices of wider tables,
    each starting `start` words in (column_slices below)."""
    NL, a, ac, bd, bc = case
    a_keys, a_counts = column_slices(a, ac, device, start)
    b_keys, b_live = column_slices(bd, bc, device, start)
    return [*a_keys.unbind(0), a_counts], [*b_keys.unbind(0), b_live], NL


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", FOLD_KERNELS)
@pytest.mark.parametrize("start", [1, 2, 3])
@pytest.mark.parametrize("NL", [1, 2, 5])
def test_fold_kernels_on_unaligned_column_slices(cuda, kernel, start, NL):
    # A's and B's lanes start past a 16-byte boundary, and na + nb (the
    # output's row width) is no multiple of 4; K1 also writes an odd
    # out_rows below na + nb
    from kmer_counter_tpu_torch.ops import merge_fold_compact as mfc
    from kmer_counter_tpu_torch.ops import merge_runs as mr

    T = FOLD_TILE[NL]
    case = random_case(np.random.default_rng(start), NL, 2 * T + 1, 3 * T + 2 * start, a_live=0.3)
    if kernel != "merge_fold_compact":  # K1 takes the case as it is, B stored descending
        case = merge_case_layout(kernel, case)
    a_ops, b_ops, _ = fold_column_slices(case, cuda, start)
    assert all(v.data_ptr() % 16 for v in a_ops + b_ops)
    plain = [[v.contiguous() for v in side] for side in (a_ops, b_ops)]
    if kernel == "merge_fold_compact":
        for out_rows in (None, 2 * T + 1):
            out, live = mfc.merge_fold_compact(a_ops, b_ops, NL, out_rows)
            want, want_live = mfc.merge_fold_compact_reference(*plain, NL, out_rows)
            assert int(live) == int(want_live)
            assert torch.equal(out, want)
    else:
        out = getattr(mr, kernel)(a_ops, b_ops, NL)
        assert torch.equal(out, getattr(mr, kernel + "_reference")(*plain, NL))


@pytest.mark.gpu
def test_k1_failed_launch_raises_and_never_falls_back(cuda, monkeypatch):
    from kmer_counter_tpu_torch.cuda_build import ptr_array
    from kmer_counter_tpu_torch.ops import merge_fold_compact as mfc
    from kmer_counter_tpu_torch.ops import merge_runs as mr

    a_ops, b_ops, NL = operands(random_case(np.random.default_rng(0), 2, 100, 100), cuda)
    lib = mfc._lib()
    out = torch.empty((3, 200), dtype=torch.int32, device=cuda)
    scratch = torch.zeros(64, dtype=torch.int64, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    # 9 key lanes; out_rows above na + nb; K4 with out_rows other than na + nb
    for variant, num_keys, out_rows in ((mfc.K1, 9, 200), (mfc.K1, 2, 201), (mfc.K4, 2, 199)):
        assert lib.mfc_fold(ptr_array(a_ops), ptr_array(b_ops), ptr_array(list(out)), variant, num_keys,
                            100, 100, out_rows, scratch.data_ptr(), stream) != 0

    class Refusing:
        def __getattr__(self, name):
            return getattr(lib, name)

        @staticmethod
        def mfc_fold(*args):
            return 9  # cudaErrorInvalidConfiguration

    monkeypatch.setattr(mfc, "_lib", Refusing)

    def counts():
        return (mfc.launches, mr.launches["merge_sorted_runs_fold_bitonic"],
                mr.launches["merge_sorted_runs_fold"])

    before = counts()
    with pytest.raises(RuntimeError, match="launch failed"):
        mfc.merge_fold_compact(a_ops, b_ops, NL)
    with pytest.raises(RuntimeError, match="launch failed"):
        mr.merge_sorted_runs_fold_bitonic(a_ops, b_ops, NL)
    a4, b4, _ = operands(ascending_case(random_case(np.random.default_rng(0), 2, 100, 100)), cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        mr.merge_sorted_runs_fold(a4, b4, NL)
    assert counts() == before


@pytest.mark.gpu
@pytest.mark.parametrize("NL", range(1, 9))
def test_kernel_random(cuda, NL):
    # ragged sizes: na + nb is no multiple of the tile
    _kernel_vs_plain(random_case(np.random.default_rng(NL), NL, 21_001, 150_007), cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("na,nb", [(0, 3000), (3000, 0), (1, 1), (0, 0)])
def test_kernel_empty_and_tiny_sides(cuda, na, nb):
    _kernel_vs_plain(random_case(np.random.default_rng(na + nb), 2, na, nb), cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("k,canonical", [(15, False), (16, False), (55, False), (101, True)])
def test_cli_on_cuda_matches_golden(cuda, tmp_path, k, canonical):
    from kmer_counter_tpu import golden
    from kmer_counter_tpu.utils import seqgen
    from kmer_counter_tpu_torch.__main__ import main

    rng = np.random.default_rng(k)
    reads = seqgen.sample_reads(rng, seqgen.random_genome(rng, 20_000), 600, 150, 0.01)
    reads[3] = ord("T")
    seqgen.write_fastq_file(os.path.join(tmp_path, "in", "a.fastq"), reads[:300])
    seqgen.write_fastq_file(os.path.join(tmp_path, "in", "b.fastq"), reads[300:])
    out = tmp_path / "out.bin"
    rc = main([f"kmerLength={k}", f"canonical={str(canonical).lower()}",
               f"inputFileLocation={tmp_path / 'in'}", f"outputFile={out}",
               "tableSlots=20000", "verbose=0"])
    assert rc == 0
    assert out.read_bytes() == golden.serialize_counter(golden.count_reads(reads, k, canonical))


# ---- the merges K3, K4, K5 and the compaction K2 ----------------------------


def merge_case_layout(kernel, case):
    """A K1-layout case (B stored descending) in the layout of a merge
    kernel of ops.merge_runs: B ascending except for the bitonic one."""
    return case if kernel == "merge_sorted_runs_fold_bitonic" else ascending_case(case)


def merge_outputs_agree(kernel, got, want) -> bool:
    """[NL+1, n] merge outputs: bit-identical for the folding merges; for
    merge_sorted_runs, keys bit-identical and the same payloads under each
    key (the order among equal keys is free)."""
    if kernel != "merge_sorted_runs":
        return torch.equal(got, want)
    return sort_outputs_agree((got[:-1], got[-1]), (want[:-1], want[-1]))


MERGE_KERNELS = ["merge_sorted_runs_fold_bitonic", "merge_sorted_runs_fold", "merge_sorted_runs"]


def _merge_vs_plain(kernel, case, device):
    from kmer_counter_tpu_torch.ops import merge_runs as mr

    a_ops, b_ops, NL = operands(merge_case_layout(kernel, case), device)
    before = mr.launches[kernel]
    got = getattr(mr, kernel)(a_ops, b_ops, NL)
    torch.cuda.synchronize()
    assert mr.launches[kernel] == before + (1 if got.shape[1] else 0)
    want = getattr(mr, kernel + "_reference")(a_ops, b_ops, NL)
    assert merge_outputs_agree(kernel, got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", MERGE_KERNELS)
@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_merge_kernels_edge_cases(cuda, kernel, name):
    _merge_vs_plain(kernel, EDGE_CASES[name](np.random.default_rng(0)), cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", MERGE_KERNELS)
@pytest.mark.parametrize("NL", range(1, 9))
def test_merge_kernels_random(cuda, kernel, NL):
    # ragged sizes: na + nb is no multiple of the tile
    _merge_vs_plain(kernel, random_case(np.random.default_rng(NL), NL, 21_001, 150_007), cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", MERGE_KERNELS)
@pytest.mark.parametrize("na,nb", [(0, 3000), (3000, 0), (1, 1), (0, 0)])
def test_merge_kernels_empty_and_tiny_sides(cuda, kernel, na, nb):
    _merge_vs_plain(kernel, random_case(np.random.default_rng(na + nb), 2, na, nb), cuda)


def _compact_vs_plain(ops, live, num_keys, device):
    from kmer_counter_tpu_torch.ops import compact_live as cl
    from kmer_counter_tpu_torch.ops.u32 import from_numpy

    ops = [from_numpy(v, device) for v in ops]
    live = from_numpy(live, device)
    before = cl.launches
    got = cl.compact_live(ops, live, num_keys)
    torch.cuda.synchronize()
    assert cl.launches == before + (1 if live.numel() else 0)
    assert torch.equal(got, cl.compact_live_reference(ops, live, num_keys))


@pytest.mark.gpu
def test_compact_tile_rows(cuda):
    from kmer_counter_tpu_torch.ops import compact_live as cl

    assert cl.tile_rows() == COMPACT_TILE


@pytest.mark.gpu
@pytest.mark.parametrize("density", [0.0, 0.5, 0.97, 1.0])
@pytest.mark.parametrize("n", COMPACT_SIZES)
def test_compact_kernel(cuda, density, n):
    ops, live = compact_case(np.random.default_rng(n), 2, n, density)
    _compact_vs_plain(ops, live, 2, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("start", [1, 2, 3])
@pytest.mark.parametrize("n", [COMPACT_TILE - 2, 3 * COMPACT_TILE + 5])
def test_compact_kernel_on_unaligned_lanes(cuda, density, start, n):
    # the flags and the operands start past a 16-byte boundary (the tiles
    # then lie across the flags' own 16-byte grid), and the live total is
    # no multiple of 4
    from kmer_counter_tpu_torch.ops import compact_live as cl
    from kmer_counter_tpu_torch.ops.u32 import from_numpy

    ops, live = compact_case(np.random.default_rng(start), 2, n, density)
    rows = from_numpy(np.pad(np.stack([*ops, live]), ((0, 0), (start, 3))), cuda)[:, start : start + n]
    got = cl.compact_live(list(rows[:-1]), rows[-1], 2)
    assert torch.equal(got, cl.compact_live_reference(list(rows[:-1]), rows[-1], 2))


@pytest.mark.gpu
@pytest.mark.parametrize("where", ["one", "below_live", "at_live", "above_live"])
@pytest.mark.parametrize("n", [4097, 3 * COMPACT_TILE + 5, 1_000_003])
def test_compact_kernel_with_out_rows(cuda, n, where):
    # the output cut to out_rows columns, also on flags a word past a
    # 16-byte boundary
    from kmer_counter_tpu_torch.ops import compact_live as cl
    from kmer_counter_tpu_torch.ops.u32 import from_numpy

    ops, live = compact_case(np.random.default_rng(n), 2, n, 0.3)
    n_live = int((live != 0).sum())
    out_rows = {"one": 1, "below_live": n_live // 3, "at_live": n_live, "above_live": n - 1}[where]
    rows = from_numpy(np.pad(np.stack([*ops, live]), ((0, 0), (1, 3))), cuda)[:, 1 : 1 + n]
    for flags, operands_ in ((from_numpy(live, cuda), [from_numpy(v, cuda) for v in ops]),
                             (rows[-1], list(rows[:-1]))):
        before = cl.launches
        got = cl.compact_live(operands_, flags, 2, out_rows)
        torch.cuda.synchronize()
        assert cl.launches == before + 1 and got.shape == (3, out_rows)
        assert torch.equal(got, cl.compact_live_reference(operands_, flags, 2, out_rows))


@pytest.mark.gpu
@pytest.mark.parametrize("n_ops,num_keys", [(1, 1), (5, 4), (9, 8), (3, 0)])
def test_compact_kernel_widths(cuda, n_ops, num_keys):
    ops, live = compact_case(np.random.default_rng(n_ops), n_ops - 1, 300_001, 0.3)
    _compact_vs_plain(ops, live, num_keys, cuda)
    _compact_vs_plain(ops, ops[-1], num_keys, cuda)  # the flags are one of the operands


@pytest.mark.gpu
@pytest.mark.parametrize("variant", SPLIT_VARIANTS)
@pytest.mark.parametrize("k,canonical", [(16, False), (31, True), (55, False)])
def test_cli_on_cuda_with_each_split_consolidation_matches_golden(cuda, tmp_path, monkeypatch, variant,
                                                                  k, canonical):
    import functools

    from kmer_counter_tpu import golden
    from kmer_counter_tpu.utils import seqgen
    from kmer_counter_tpu_torch.__main__ import main
    from kmer_counter_tpu_torch.ops import compact_live as cl
    from kmer_counter_tpu_torch.ops import merge_fold_compact as mfc
    from kmer_counter_tpu_torch.ops import merge_runs as mr
    from kmer_counter_tpu_torch.ops import table2 as t2

    monkeypatch.setattr(t2, "consolidate3",
                        functools.partial(t2.consolidate3, **CONSOLIDATE_VARIANTS[variant]))
    rng = np.random.default_rng(k)
    reads = seqgen.sample_reads(rng, seqgen.random_genome(rng, 20_000), 600, 150, 0.01)
    reads[3] = ord("T")
    seqgen.write_fastq_file(os.path.join(tmp_path, "in", "a.fastq"), reads)
    out = tmp_path / "out.bin"
    before = (mr.launches[VARIANT_MERGE[variant]], cl.launches, mfc.launches)
    rc = main([f"kmerLength={k}", f"canonical={str(canonical).lower()}", "tableImpl=two",
               f"inputFileLocation={tmp_path / 'in'}", f"outputFile={out}", "tableSlots=20000",
               "readsPerChunk=100", "verbose=0"])
    assert rc == 0
    after = (mr.launches[VARIANT_MERGE[variant]], cl.launches, mfc.launches)
    assert after[0] >= before[0] + 2 and after[1] >= before[1] + 2 and after[2] == before[2]
    assert out.read_bytes() == golden.serialize_counter(golden.count_reads(reads, k, canonical))


# ---- the multi-lane sort (K6 + K7) -------------------------------------------


def _sort_vs_plain(case, device):
    from kmer_counter_tpu_torch.ops import lane_sort as ls
    from kmer_counter_tpu_torch.ops.u32 import from_numpy

    keys, payload = from_numpy(case[0], device), from_numpy(case[1], device)
    before = ls.launches
    got = ls.sort_ops(keys, payload)
    torch.cuda.synchronize()
    assert ls.launches == before + (1 if payload.numel() else 0)
    assert sort_outputs_agree(got, ls.sort_ops_reference(keys, payload))
    return got


@pytest.mark.gpu
def test_sort_tile_rows(cuda):
    from kmer_counter_tpu_torch.ops import lane_sort as ls

    assert [ls.tile_rows(NL) for NL in range(1, 9)] == [SORT_TILE[NL] for NL in range(1, 9)]
    assert ls.tile_rows(9) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("NL", range(1, 9))
def test_sort_kernel_random(cuda, NL):
    _sort_vs_plain(_sort_random(np.random.default_rng(NL), NL, 250_001 + NL), cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SORT_CASES))
def test_sort_kernel_cases(cuda, name):
    _sort_vs_plain(SORT_CASES[name](np.random.default_rng(0)), cuda)


@pytest.mark.gpu
def test_sort_kernel_payload_is_a_permutation(cuda):
    n = 1_000_003
    keys, _ = _sort_random(np.random.default_rng(1), 2, n, pool=1000)
    _, payload = _sort_vs_plain((keys, np.arange(n)), cuda)
    assert torch.equal(torch.sort(payload).values, torch.arange(n, dtype=torch.int32, device=cuda))


@pytest.mark.gpu
def test_sort_failed_launch_raises_and_never_falls_back(cuda, monkeypatch):
    from kmer_counter_tpu_torch.cuda_build import ptr_array
    from kmer_counter_tpu_torch.ops import lane_sort as ls

    keys = torch.zeros((2, 10), dtype=torch.int32, device=cuda)
    lib = ls._lib()
    bad = ptr_array([keys[0], keys[1], keys[0]])
    assert lib.ls_sort(bad, bad, bad, 9, 10, torch.cuda.current_stream().cuda_stream) < 0

    class Refusing:
        def __getattr__(self, name):
            return getattr(lib, name)

        @staticmethod
        def ls_sort(*args):
            return -9  # cudaErrorInvalidConfiguration

    monkeypatch.setattr(ls, "_lib", Refusing)
    before = ls.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        ls.sort_ops(keys, keys[0].clone())
    assert ls.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("NL", [1, 2, 5])
def test_sort_kernel_on_unaligned_column_slices(cuda, NL):
    from kmer_counter_tpu_torch.ops import lane_sort as ls

    keys, payload = column_slices(*_sort_random(np.random.default_rng(NL), NL, 2 * SORT_TILE[NL] + 3),
                                  cuda)
    assert keys.data_ptr() % 16 and payload.data_ptr() % 16
    got = ls.sort_ops(keys, payload)
    assert sort_outputs_agree(got, ls.sort_ops_reference(keys.contiguous(), payload.contiguous()))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, SORT_TILE[2], SORT_TILE[2] + 1, _ODD])
def test_sort_is_one_call_of_the_library(cuda, monkeypatch, n):
    from kmer_counter_tpu_torch.ops import lane_sort as ls

    lib, calls = ls._lib(), []

    class Counting:
        def __getattr__(self, name):
            return getattr(lib, name)

        @staticmethod
        def ls_sort(*args):
            calls.append(args[4])
            return lib.ls_sort(*args)

    monkeypatch.setattr(ls, "_lib", Counting)
    _sort_vs_plain(_sort_random(np.random.default_rng(n), 2, n), cuda)
    assert calls == [n]
    assert ls.merge_passes(2, n) == {1: 0, SORT_TILE[2]: 0, SORT_TILE[2] + 1: 1, _ODD: 3}[n]


@pytest.mark.gpu
@pytest.mark.parametrize("k,canonical", [(15, False), (16, False), (55, False), (101, True)])
def test_one_level_cli_on_cuda_matches_golden(cuda, tmp_path, k, canonical):
    from kmer_counter_tpu import golden
    from kmer_counter_tpu.utils import seqgen
    from kmer_counter_tpu_torch.__main__ import main
    from kmer_counter_tpu_torch.ops import lane_sort as ls

    rng = np.random.default_rng(k)
    reads = seqgen.sample_reads(rng, seqgen.random_genome(rng, 20_000), 600, 150, 0.01)
    reads[3] = ord("T")  # the all-T key is an ordinary all-ones key here
    seqgen.write_fastq_file(os.path.join(tmp_path, "in", "a.fastq"), reads)
    out = tmp_path / "out.bin"
    before = ls.launches
    rc = main([f"kmerLength={k}", f"canonical={str(canonical).lower()}", "tableImpl=one",
               f"inputFileLocation={tmp_path / 'in'}", f"outputFile={out}",
               "tableSlots=20000", "readsPerChunk=100", "verbose=0"])
    assert rc == 0
    assert ls.launches >= before + 2  # a consolidation in the loop, and the finalize
    assert out.read_bytes() == golden.serialize_counter(golden.count_reads(reads, k, canonical))


# ---- the mesh: the route's sort and a 4-position count on one card --------


@pytest.mark.gpu
@pytest.mark.parametrize("NL", [1, 2, 4])
def test_route_on_cuda_matches_plain(cuda, NL):
    """parallel.shuffle.route_merge_local over 4 positions on the card (each
    non-empty range's sort_reduce through the sort kernel) against the same
    route on the CPU (the plain sort): the same ranges, bit for bit."""
    from kmer_counter_tpu_torch.ops import lane_sort as ls
    from kmer_counter_tpu_torch.ops.u32 import from_numpy
    from kmer_counter_tpu_torch.parallel import shuffle
    from kmer_counter_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(NL)
    tables = []
    for u in (50_000, 0, 123_457, 7):
        keys = np.unique(rng.integers(0, 2**32, (u, NL), dtype=np.uint64).astype(np.uint32) >> 2, axis=0)
        tables.append((np.ascontiguousarray(keys.T), rng.integers(1, 9, len(keys)).astype(np.uint32)))
    outs = {}
    for name, device in (("cuda", torch.device("cuda")), ("cpu", torch.device("cpu"))):
        mesh = make_mesh(devices=[device] * 4)
        on = [(from_numpy(lanes, device), from_numpy(counts, device)) for lanes, counts in tables]
        splitters = shuffle.sampled_splitters_host(mesh, [lanes[0] for lanes, _ in on])
        before = ls.launches
        plan = shuffle.plan_route(mesh, on, splitters)
        routed = [(pos, lanes.cpu(), counts.cpu()) for pos, lanes, counts in shuffle.route_merge_local(mesh, on, plan)]
        # One sort a position that received rows (the empty position's
        # samples, all-ones, leave the last range empty here).
        assert plan.rounds == 1
        assert ls.launches - before == (sum(1 for n in plan.balance if n) if name == "cuda" else 0)
        outs[name] = routed, plan.balance
    for (cpos, cl, cc), (ppos, pl, pc) in zip(outs["cuda"][0], outs["cpu"][0]):
        assert cpos == ppos
        assert torch.equal(cl, pl) and torch.equal(cc, pc)
    assert (outs["cuda"][1] == outs["cpu"][1]).all()


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["two", "one"])
def test_mesh_count_on_cuda_matches_golden(cuda, tmp_path, impl):
    """A 4-position mesh on one card: each position's consolidations
    launch K1 (two-level) or the sort (one-level), the route launches the
    sort once a position; the dump is golden's."""
    from kmer_counter_tpu import golden
    from kmer_counter_tpu.utils import seqgen
    from kmer_counter_tpu_torch.config import Options
    from kmer_counter_tpu_torch.engine import run_count
    from kmer_counter_tpu_torch.ops import lane_sort as ls
    from kmer_counter_tpu_torch.ops import merge_fold_compact as mfc
    from kmer_counter_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(31)
    reads = seqgen.sample_reads(rng, seqgen.random_genome(rng, 50_000), 3_000, 120, 0.01)
    seqgen.write_fastq_file(os.path.join(tmp_path, "in", "a.fastq"), reads[:2000])
    seqgen.write_fastq_file(os.path.join(tmp_path, "in", "b.fastq"), reads[2000:])
    out = tmp_path / "out.bin"
    opts = Options(kmer_length=31, canonical=True, table_impl=impl, input_dir=str(tmp_path / "in"),
                   output_file=str(out), table_slots=60_000, reads_per_chunk=400, verbose=0)
    k1, sort = mfc.launches, ls.launches
    stats = run_count(opts, mesh=make_mesh(devices=[torch.device("cuda")] * 4))
    k1, sort = mfc.launches - k1, ls.launches - sort
    per_position = stats.metrics["counters"]["position_consolidations"]
    if impl == "two":
        assert k1 == per_position >= 8 and sort == 4
    else:
        assert k1 == 0 and sort == per_position + 4 and per_position >= 8
    assert out.read_bytes() == golden.serialize_counter(golden.count_reads(reads, 31, True))


@pytest.mark.gpu
def test_two_ranks_spill_route_in_rounds_on_cuda(cuda, tmp_path):
    """Two gloo ranks sharing the card (tests/torch_multiproc_worker.py),
    2 positions each, spilling, with each table: the splitters freeze at
    the first spill over uniform reads, the poly-A reads after it crowd the
    lowest range, which arrives in rounds (gloo's all-to-all of CUDA
    tensors, a run per round); the parts in name order are golden's."""
    import re
    import subprocess
    import sys

    from kmer_counter_tpu import golden
    from kmer_counter_tpu.utils import seqgen

    rng = np.random.default_rng(11)
    reads = []
    for i in range(2):  # rank i reads f{i}, then f{i+2}
        uniform = seqgen.sample_reads(rng, seqgen.random_genome(rng, 20_000), 128, 60)
        poly = seqgen.sample_reads(rng, seqgen.random_genome(rng, 20_000), 128, 60)
        poly[:, :30] = ord("A")
        seqgen.write_fastq_file(os.path.join(tmp_path, "in", f"f{i}.fastq"), uniform)
        seqgen.write_fastq_file(os.path.join(tmp_path, "in", f"f{i + 2}.fastq"), poly)
        reads += [uniform, poly]
    want = golden.serialize_counter(golden.count_reads(np.concatenate(reads), 31, True))
    worker = os.path.join(os.path.dirname(__file__), "torch_multiproc_worker.py")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    jobs = []
    for impl in ("two", "one"):
        jobs += ["--"] * bool(jobs) + [str(tmp_path / "in"), str(tmp_path / impl / "out.bin"), impl, "31", "4000",
                                       str(tmp_path / f"spill_{impl}")]
        (tmp_path / impl).mkdir()
    env = {**os.environ, "PYTHONPATH": repo, "KMER_TEST_DEVICE": "cuda", "KMER_TEST_POSITIONS": "2"}
    procs = [subprocess.Popen([sys.executable, worker, str(rank), "2", str(tmp_path / "store"), *jobs], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert [p.returncode for p in procs] == [0, 0], logs
    for impl in ("two", "one"):
        lines = [line for log in logs for line in log.splitlines() if f"{os.sep}{impl}{os.sep}out.bin " in line]
        assert len(lines) == 2 and all(int(re.search(r"rounds=(\d+)", line).group(1)) > 1 for line in lines), logs
        parts = sorted(f for f in os.listdir(tmp_path / impl) if ".part" in f)
        assert len(parts) == 4
        assert b"".join((tmp_path / impl / f).read_bytes() for f in parts) == want, impl


# ---- K8: the fused encode + extract ------------------------------------------


def extract_vs_plain(reads, k, canonical, off=0):
    """K8 in both modes against its plain versions on the card: records
    bit-exact; keys written at column ``off`` of a wider region, the
    columns around them untouched, the all-T count added to what ``allt``
    held.  Returns the all-T count."""
    from kmer_counter_tpu_torch.ops import fused_extract as fx
    from kmer_counter_tpu_torch.records import active_lanes

    R, L = reads.shape
    n = R * (L - k + 1)
    before = fx.launches
    got = fx.extract_chunk_lanes_major(reads, k, canonical)
    want = fx.extract_chunk_lanes_major_reference(reads, k, canonical)
    torch.cuda.synchronize()
    assert torch.equal(got, want), f"records k={k} canonical={canonical} R={R} L={L}"
    dst = torch.full((active_lanes(k), off + n + 5), 0x5A5A5A5A, dtype=torch.int32, device=reads.device)
    allt = torch.full((), 3, dtype=torch.int64, device=reads.device)
    fx.extract_chunk_keys_into(reads, k, canonical, dst, off, allt)
    want_keys, want_allt = fx.extract_chunk_keys_reference(reads, k, canonical)
    torch.cuda.synchronize()
    assert torch.equal(dst[:, off : off + n], want_keys), f"keys k={k} canonical={canonical} R={R} L={L}"
    assert (dst[:, :off] == 0x5A5A5A5A).all() and (dst[:, off + n :] == 0x5A5A5A5A).all()
    assert int(allt) == 3 + int(want_allt)
    assert fx.launches == before + 2
    return int(want_allt)


@pytest.mark.gpu
def test_extract_tile_bases(cuda):
    from kmer_counter_tpu_torch.ops import fused_extract as fx

    assert fx.tile_bases() == EXTRACT_TILE


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(EXTRACT_CASES))
def test_extract_kernel_cases(cuda, name):
    case = EXTRACT_CASES[name](np.random.default_rng(0))
    reads = extract_reads_on(case["reads"], cuda, case["start"])
    if name.startswith("dst_column_mod4"):
        R, L = case["reads"].shape
        assert (case["off"] + R * (L - case["k"] + 1) + 5) % 4 == 0 and case["off"] % 4 == int(name[-1])
    allt = extract_vs_plain(reads, case["k"], case["canonical"], case["off"])
    if name.startswith("all_t") or name == "raw_off_allt":
        assert allt > 0


@pytest.mark.gpu
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", EXTRACT_KS)
def test_extract_kernel_random(cuda, k, canonical):
    rng = np.random.default_rng(k)
    for L in sorted({k, k + 1, 100, 151}):
        if L >= k:
            extract_vs_plain(extract_reads_on(extract_reads(rng, 3000, L), cuda), k, canonical)


@pytest.mark.gpu
def test_extract_failed_launch_raises_and_never_falls_back(cuda, monkeypatch):
    from kmer_counter_tpu_torch.ops import fused_extract as fx

    reads = extract_reads_on(extract_reads(np.random.default_rng(0), 10, 40), cuda)
    lib = fx._lib()
    dst = torch.zeros((2, 400), dtype=torch.int32, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    # k=0, L<k, a destination narrower than the windows, keys mode without allt
    for k, L, ld, allt in ((0, 40, 400, 1), (41, 40, 400, 1), (20, 40, 209, 1), (20, 40, 400, 0)):
        assert lib.fx_extract(reads.data_ptr(), 10, L, k, 0, 1, dst.data_ptr(), ld, 0,
                              dst.data_ptr() if allt else None, stream) != 0

    class Refusing:
        def __getattr__(self, name):
            return getattr(lib, name)

        @staticmethod
        def fx_extract(*args):
            return 9  # cudaErrorInvalidConfiguration

    monkeypatch.setattr(fx, "_lib", Refusing)
    before = fx.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        fx.extract_chunk_lanes_major(reads, 20)
    with pytest.raises(RuntimeError, match="launch failed"):
        fx.extract_chunk_keys_into(reads, 20, False, dst, 0, torch.zeros((), dtype=torch.int64, device=cuda))
    assert fx.launches == before


# ---- D1-D7: the probe kernels (ops.probes, csrc/probes.cu) ---------------------

# Output keys a block of pair_merge_kernel where a pair fits one block (a pair
# spread over blocks takes half as many); rows a tile of tile_compact_kernel;
# rows a part of its network (a CTA of the tile's cluster of eight) and the
# CTA's threads (32 rows each).
PROBE_MERGE_TILE = 2048
PROBE_TILE = 65536
PROBE_PART = PROBE_TILE // 8
PROBE_NET_THREADS = PROBE_PART // 32


def probe_keys(rng, shape, ascending=True):
    """uint32 keys along the last axis: random (half at or above 2^31), with
    runs of duplicates and a tenth each of 0 and 0xFFFFFFFF; sorted
    ascending, or not at all."""
    keys = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    pick = rng.random(shape)
    keys[pick < 0.1] = 0
    keys[(pick >= 0.1) & (pick < 0.2)] = M
    keys[(pick >= 0.2) & (pick < 0.3)] = np.uint32(0x80000000)
    keys[(pick >= 0.3) & (pick < 0.4)] = np.uint32(12345)
    return np.sort(keys, axis=-1) if ascending else keys


# (G, Ta, Tb): the probes' shapes (D2, D3, D7), G = 1, empty and tiny sides,
# lengths that are no multiple of the block's range, one side much longer;
# rows of A, B and the output that start 1, 2 or 3 words past a 16-byte
# boundary (Ta, Tb or Ta + Tb not a multiple of 4, G > 1).
PROBE_MERGE_SHAPES = [(1, 1024, 1024), (512, 1024, 1024), (1, 65536, 65536), (1, 0, 5), (1, 5, 0), (1, 1, 1),
                      (3, 2047, 2049), (2, 2048, 2048), (1, 10000, 3), (1, 3, 10000), (7, 4095, 1),
                      (1, 100000, 70001), (64, 333, 777), (5, 0, 0), (3, 1025, 1023), (5, 2050, 2046),
                      (2, 65537, 65535), (3, 1026, 1025), (2, 3, 2046), (3, 2050, 2048), (4, 4097, 0)]
# Pairs whose merge-path splits fall inside runs of equal keys, across the
# edges of the blocks: (G, Ta, Tb, the values the keys take).
PROBE_MERGE_TIE_CASES = {"all_equal": (3, 5000, 3001, (12345,)), "all_equal_top": (2, 2049, 4095, (M,)),
                         "two_values": (2, 6001, 4097, (0, M)),
                         "two_values_sign": (3, 2050, 2046, (0x7FFFFFFF, 0x80000000))}


def probe_merge_case(rng, G, ta, tb):
    """(a [G, ta], b [G, tb]) uint32, both ascending."""
    return probe_keys(rng, (G, ta)), probe_keys(rng, (G, tb))


def probe_tie_case(rng, G, ta, tb, values):
    """(a [G, ta], b [G, tb]) uint32, both ascending, every key one of values."""
    v = np.asarray(values, np.uint32)
    return tuple(np.sort(v[rng.integers(0, len(v), (G, t))], axis=1) for t in (ta, tb))


# Live totals of the "residues" tiles: each residue mod 4 (the zero tail's
# scalar head), below 4, and past one and two parts (a tail that begins
# inside a later part).
PROBE_RESIDUE_TOTALS = (1, 2, 3, 4, 2001, PROBE_PART + 1, PROBE_PART + 2, 2 * PROBE_PART + 3)


def probe_tile_case(rng, n_ops, tiles, live):
    """(ops [n_ops, tiles*TILE] uint32, live [tiles*TILE] uint32): live is a
    density, or "none", "all", "edges" (each tile's first and last rows
    live, and the last row of every 4096), "residues" (tile t has
    PROBE_RESIDUE_TOTALS[t % 8] live rows, at random), "across" (runs of 78
    live rows across each boundary between parts, 1% elsewhere) or
    "last_part" (half the rows of each tile's last part, none before); a
    live flag is any nonzero word."""
    n = tiles * PROBE_TILE
    ops = probe_keys(rng, (n_ops, n), ascending=False)
    flags = rng.integers(1, 2**32, n, dtype=np.uint64).astype(np.uint32)
    r = np.arange(n) % PROBE_TILE
    if live == "none":
        on = np.zeros(n, bool)
    elif live == "all":
        on = np.ones(n, bool)
    elif live == "edges":
        on = (r == 0) | (r % 4096 == 4095)
    elif live == "residues":
        on = np.zeros(n, bool)
        for t in range(tiles):
            total = PROBE_RESIDUE_TOTALS[t % len(PROBE_RESIDUE_TOTALS)]
            on[t * PROBE_TILE + rng.choice(PROBE_TILE, total, replace=False)] = True
    elif live == "across":
        d = r[:, None] - np.arange(PROBE_PART, PROBE_TILE, PROBE_PART)  # rows past each boundary
        on = ((d >= -37) & (d < 41)).any(1) | (rng.random(n) < 0.01)
    elif live == "last_part":
        on = (r >= PROBE_TILE - PROBE_PART) & (rng.random(n) < 0.5)
    else:
        on = rng.random(n) < live
    return ops, np.where(on, flags, 0).astype(np.uint32)


PROBE_TILE_CASES = {"none_live": (3, 2, "none"), "all_live": (3, 2, "all"), "tile_edges_live": (3, 3, "edges"),
                    "probe_density": (3, 4, 0.03), "one_op": (1, 1, 0.5), "nine_ops": (9, 2, 0.97),
                    "total_residues": (3, 8, "residues"), "run_across_parts": (3, 2, "across"),
                    "last_part_only": (2, 2, "last_part")}


# (R, W, starts, rows, shift): D4, D5, D6, then odd widths and counts,
# shifts past R either way, windows at both ends of x.
PROBE_GATHER_CASES = {"d4_roll_3": (16, 128, [0], 16, -3), "d5_roll_minus_3": (16, 128, [0], 16, 3),
                      "d6_windows": (64, 128, [1, 9, 17, 33], 8, 0), "one_row": (1, 1, [0], 1, 5),
                      "wide_shift": (7, 3, [0, 2, 4], 3, -20), "ends": (100, 130, [0, 99, 50], 1, 0),
                      "whole_many": (33, 128, [0] * 9, 33, 40)}


def probe_gather_case(rng, R, W):
    return rng.integers(0, 2**32, (R, W), dtype=np.uint64).astype(np.uint32)


def probe_random_shapes(rng, count=20):
    """count random shapes of each probe kernel: {"pair_merge": [(G, ta, tb)],
    "tile_compact": [(n_ops, tiles, density)], "row_gather": [(R, W,
    starts, rows, shift)]}."""
    merge = [(int(rng.integers(1, 9)), int(rng.integers(0, 9000)), int(rng.integers(0, 9000)))
             for _ in range(count)]
    tiles = [(int(rng.integers(1, 10)), int(rng.integers(1, 4)), float(rng.choice([0.0, 0.001, 0.03, 0.5, 1.0])))
             for _ in range(count)]
    gather = []
    for _ in range(count):
        R = int(rng.integers(1, 300))
        rows = int(rng.integers(1, R + 1))
        G = int(rng.integers(1, 12))
        starts = [int(s) for s in rng.integers(0, R - rows + 1, G)]
        gather.append((R, int(rng.choice([1, 3, 128, 130])), starts, rows, int(rng.integers(-2 * R, 2 * R + 1))))
    return {"pair_merge": merge, "tile_compact": tiles, "row_gather": gather}


def probe_merge_vs_plain(a, b, device, start=0):
    """pair_merge on the card against its plain version, B in either order;
    bit-exact and equal to np.sort of each pair.  A and B are contiguous
    views that begin ``start`` words into their buffers."""
    from kmer_counter_tpu_torch.ops import probes
    from kmer_counter_tpu_torch.ops.u32 import from_numpy

    def on_device(x):
        buf = torch.zeros(x.size + start, dtype=torch.int32, device=device)
        view = buf[start:].view(x.shape)
        view.copy_(from_numpy(x, device))
        return view

    want = np.sort(np.concatenate([a, b], axis=1), axis=1)
    for desc in (False, True):
        ta, tb = (on_device(x) for x in (a, b[:, ::-1] if desc else b))
        before = probes.launches["pair_merge"]
        got = probes.pair_merge(ta, tb, b_descending=desc)
        torch.cuda.synchronize()
        assert probes.launches["pair_merge"] == before + (1 if got.numel() else 0)
        plain = probes.pair_merge_reference(ta, tb, b_descending=desc)
        assert torch.equal(got, plain), f"G={a.shape[0]} ta={a.shape[1]} tb={b.shape[1]} desc={desc}"
        np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32), want)


def probe_tile_vs_plain(ops, live, device):
    from kmer_counter_tpu_torch.ops import probes

    t_ops = [torch.from_numpy(v.view(np.int32).copy()).to(device) for v in ops]
    t_live = torch.from_numpy(live.view(np.int32).copy()).to(device)
    for mode in ("copy", "cumsum", "network"):
        before = probes.launches["tile_compact"]
        got = probes.tile_compact(t_ops, t_live, mode)
        torch.cuda.synchronize()
        assert probes.launches["tile_compact"] == before + 1
        assert torch.equal(got, probes.tile_compact_reference(t_ops, t_live, mode)), mode


def probe_gather_vs_plain(x, starts, rows, shift, device):
    from kmer_counter_tpu_torch.ops import probes

    tx = torch.from_numpy(x.view(np.int32).copy()).to(device)
    ts = torch.tensor(starts, dtype=torch.int32, device=device)
    before = probes.launches["row_gather"]
    got = probes.row_gather(tx, ts, rows, shift)
    torch.cuda.synchronize()
    assert probes.launches["row_gather"] == before + 1
    assert torch.equal(got, probes.row_gather_reference(tx, ts, rows, shift))
    idx = (np.asarray(starts)[:, None] + shift + np.arange(rows)) % x.shape[0]
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32), x[idx])


def probe_side_stream_vs_plain(device):
    """row_gather and tile_compact (each mode) launched inside
    torch.cuda.stream(side).  Their inputs are written on side after a spin
    of tens of milliseconds, so a launch on any other stream would read them
    unwritten (zeros); after side.synchronize() each result equals its
    plain version's."""
    from kmer_counter_tpu_torch.ops import probes

    rng = np.random.default_rng(5)
    x_np = probe_gather_case(rng, 64, 128)
    ops_np, live_np = probe_tile_case(rng, 3, 2, 0.03)
    src = [torch.from_numpy(a.view(np.int32).copy()).to(device) for a in (x_np, *ops_np, live_np)]
    bufs = [torch.zeros_like(t) for t in src]
    starts = torch.tensor([1, 9, 17, 33], dtype=torch.int32, device=device)
    torch.cuda.synchronize()
    side = torch.cuda.Stream(device)
    with torch.cuda.stream(side):
        torch.cuda._sleep(50_000_000)
        for buf, t in zip(bufs, src):
            buf.copy_(t)
        x, *ops, live = bufs
        gathered = probes.row_gather(x, starts, 8, 0)
        compacted = {mode: probes.tile_compact(ops, live, mode) for mode in probes.MODES}
    side.synchronize()
    x, *ops, live = src
    assert torch.equal(gathered, probes.row_gather_reference(x, starts, 8, 0))
    for mode, got in compacted.items():
        assert torch.equal(got, probes.tile_compact_reference(ops, live, mode)), mode


@pytest.mark.gpu
def test_probe_tile_matches_case_tile(cuda):
    from kmer_counter_tpu_torch.ops import probes

    assert probes.kernel_tile() == probes.TILE == PROBE_TILE


@pytest.mark.gpu
@pytest.mark.parametrize("shape", PROBE_MERGE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_probe_pair_merge_kernel(cuda, shape):
    probe_merge_vs_plain(*probe_merge_case(np.random.default_rng(sum(shape)), *shape), cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(PROBE_MERGE_TIE_CASES))
def test_probe_pair_merge_kernel_ties_across_blocks(cuda, name):
    probe_merge_vs_plain(*probe_tie_case(np.random.default_rng(3), *PROBE_MERGE_TIE_CASES[name]), cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("start", [1, 2, 3])
@pytest.mark.parametrize("shape", [(3, 2050, 2046), (2, 4097, 3001)], ids=lambda s: "x".join(map(str, s)))
def test_probe_pair_merge_kernel_on_unaligned_rows(cuda, shape, start):
    probe_merge_vs_plain(*probe_merge_case(np.random.default_rng(start), *shape), cuda, start)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(PROBE_TILE_CASES))
def test_probe_tile_compact_kernel(cuda, name):
    probe_tile_vs_plain(*probe_tile_case(np.random.default_rng(0), *PROBE_TILE_CASES[name]), cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(PROBE_GATHER_CASES))
def test_probe_row_gather_kernel(cuda, name):
    R, W, starts, rows, shift = PROBE_GATHER_CASES[name]
    probe_gather_vs_plain(probe_gather_case(np.random.default_rng(0), R, W), starts, rows, shift, cuda)


@pytest.mark.gpu
def test_probe_kernels_random_shapes(cuda):
    rng = np.random.default_rng(11)
    shapes = probe_random_shapes(rng)
    for G, ta, tb in shapes["pair_merge"]:
        probe_merge_vs_plain(*probe_merge_case(rng, G, ta, tb), cuda)
    for n_ops, tiles, density in shapes["tile_compact"]:
        probe_tile_vs_plain(*probe_tile_case(rng, n_ops, tiles, density), cuda)
    for R, W, starts, rows, shift in shapes["row_gather"]:
        probe_gather_vs_plain(probe_gather_case(rng, R, W), starts, rows, shift, cuda)


@pytest.mark.gpu
def test_probe_kernels_follow_the_current_stream(cuda):
    probe_side_stream_vs_plain(cuda)


def wrapper_stream_case(name, rng):
    """(inputs as NumPy arrays, the wrapper, its plain version, whether two
    results agree, its launch count) of one wrapper of the port, at a small
    shape."""
    from kmer_counter_tpu_torch.ops import compact_live as cl
    from kmer_counter_tpu_torch.ops import fused_extract as fx
    from kmer_counter_tpu_torch.ops import lane_sort as ls
    from kmer_counter_tpu_torch.ops import merge_fold_compact as mfc
    from kmer_counter_tpu_torch.ops import probes

    def k1(fn):
        return lambda *v: fn(list(v[:3]), list(v[3:]), 2)

    def k1_agree(got, want):
        return torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])

    if name == "fused_extract":
        return ([extract_reads(rng, 3000, 100)], lambda r: fx.extract_chunk_lanes_major(r, 31, True),
                lambda r: fx.extract_chunk_lanes_major_reference(r, 31, True), torch.equal, lambda: fx.launches)
    if name == "lane_sort":
        return (list(_sort_random(rng, 2, 50_000)), ls.sort_ops, ls.sort_ops_reference, sort_outputs_agree,
                lambda: ls.launches)
    if name == "merge_fold_compact":
        _, a, ac, bd, bc = random_case(rng, 2, 20_000, 30_000)
        return ([*a, ac, *bd, bc], k1(mfc.merge_fold_compact), k1(mfc.merge_fold_compact_reference), k1_agree,
                lambda: mfc.launches)
    if name == "compact_live":
        ops, live = compact_case(rng, 2, 50_000, 0.5)
        return ([*ops, live], lambda *v: cl.compact_live(list(v[:-1]), v[-1], 2),
                lambda *v: cl.compact_live_reference(list(v[:-1]), v[-1], 2), torch.equal, lambda: cl.launches)
    a, b = probe_merge_case(rng, 3, 5000, 3001)
    return ([a, np.ascontiguousarray(b[:, ::-1])], lambda a, b: probes.pair_merge(a, b, b_descending=True),
            lambda a, b: probes.pair_merge_reference(a, b, b_descending=True), torch.equal,
            lambda: probes.launches["pair_merge"])


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["fused_extract", "lane_sort", "merge_fold_compact", "compact_live", "pair_merge"])
def test_wrapper_follows_the_current_stream(cuda, name):
    """The wrapper launched inside torch.cuda.stream(side).  Its inputs are
    written on side after a spin of tens of milliseconds, so a launch on any
    other stream would read them unwritten (zeros); after side.synchronize()
    its result equals its plain version's, and it launched its kernel once."""
    inputs, kernel, plain, agree, count = wrapper_stream_case(name, np.random.default_rng(9))
    src = [torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x).to(cuda) for x in inputs]
    bufs = [torch.zeros_like(t) for t in src]
    torch.cuda.synchronize()
    before = count()
    side = torch.cuda.Stream(cuda)
    with torch.cuda.stream(side):
        torch.cuda._sleep(50_000_000)
        for buf, t in zip(bufs, src):
            buf.copy_(t)
        got = kernel(*bufs)
    side.synchronize()
    assert count() == before + 1
    assert agree(got, plain(*src))


@pytest.mark.gpu
def test_stream_helper_returns_the_current_stream(cuda):
    from kmer_counter_tpu_torch import cuda_build

    index = torch.cuda.current_device()
    assert cuda_build.current_stream(index) == torch.cuda.current_stream().cuda_stream
    side = torch.cuda.Stream(cuda)
    with torch.cuda.stream(side):
        assert cuda_build.current_stream(index) == side.cuda_stream != torch.cuda.default_stream().cuda_stream
    assert cuda_build.current_stream(index) == torch.cuda.default_stream().cuda_stream


@pytest.mark.gpu
def test_probe_harnesses_on_cuda(cuda, capsys):
    from kmer_counter_tpu_torch.probes import experiments_bitonic_merge, experiments_mosaic_caps
    from kmer_counter_tpu_torch.probes import probe_compact_overhead

    experiments_mosaic_caps.main(cuda, reps=3)
    experiments_bitonic_merge.main(cuda, reps=3)
    probe_compact_overhead.main(cuda, n_tiles=8, chain=2, reps=1)
    out = capsys.readouterr().out
    assert out.count(": OK correct") == 4 and "merge correct: True" in out and out.count(", correct") == 4


@pytest.mark.gpu
def test_probe_failed_launch_raises_and_never_falls_back(cuda, monkeypatch):
    from kmer_counter_tpu_torch.ops import probes

    lib = probes._lib()
    x = torch.zeros((PROBE_TILE,), dtype=torch.int32, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = probes.ptr_array([x])
    # no rows, a row count off the tile, a mode past network, a misaligned lane
    assert lib.pr_tile_compact(ptrs, ptrs, 1, x.data_ptr(), PROBE_TILE - 1, 0, stream) != 0
    assert lib.pr_tile_compact(ptrs, ptrs, 1, x.data_ptr(), PROBE_TILE, 3, stream) != 0
    assert lib.pr_tile_compact(ptrs, ptrs, 1, x.data_ptr() + 4, PROBE_TILE, 0, stream) != 0
    assert lib.pr_pair_merge(x.data_ptr(), x.data_ptr(), x.data_ptr(), 0, 1, 1, 0, stream) != 0
    assert lib.pr_row_gather(x.data_ptr(), x.data_ptr(), x.data_ptr(), 0, 1, 1, 1, 0, stream) != 0

    class Refusing:
        def __getattr__(self, name):
            return getattr(lib, name)

        @staticmethod
        def pr_pair_merge(*args):
            return 9  # cudaErrorInvalidConfiguration

        pr_tile_compact = pr_row_gather = pr_pair_merge

    monkeypatch.setattr(probes, "_lib", Refusing)
    before = dict(probes.launches)
    with pytest.raises(RuntimeError, match="launch failed"):
        probes.pair_merge(x.view(1, -1), x.view(1, -1), b_descending=True)
    with pytest.raises(RuntimeError, match="launch failed"):
        probes.tile_compact([x], x, "copy")
    with pytest.raises(RuntimeError, match="launch failed"):
        probes.row_gather(x.view(-1, 128), x[:1], 1, 0)
    assert probes.launches == before
