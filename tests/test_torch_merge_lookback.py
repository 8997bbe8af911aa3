"""A numpy model of the one-pass K1/K3/K4 kernel (fold_kernel in
csrc/merge_fold_compact.cu) against the plain versions.

The CUDA kernel runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py).  Its cross-tile protocol is modelled here: the rows that
are not the sentinel come first in the merged stream (S of them; B is
stored descending for K1 and K3, its sentinel rows first, and ascending
for K4, its sentinel rows last), so only tiles that start before S are
merged; each such tile folds its rows into a Fold (head_sum, tail, live,
has_end), publishes it, looks back over the tiles before it (a window of
32 tiles a round) for the fold of every row before it, and publishes its
inclusive fold; then it writes K1's live rows of rank below out_rows at
their rank, or K3's and K4's folded counts at their merged index.
Sentinel tiles read nothing; for K3 and K4 they get the sentinel and
count 0, as do the rows from S on of the tile that holds row S-1.  K1's
fill writes rows [min(live total, out_rows), out_rows) (the tile that
holds row S-1 publishes the live total).  Blocks complete in order and in
a shuffled order.  tests/test_torch_merge_fold_compact.py and
test_torch_merge_runs.py hold the model in K4's layout against the plain
K1 and K4.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from kmer_counter_tpu_torch.ops import merge_fold_compact as mfc
from kmer_counter_tpu_torch.ops import merge_runs as mr
from kmer_counter_tpu_torch.ops.u32 import to_numpy

from tests.test_torch_cuda import EDGE_CASES, FOLD_CASES, FOLD_TILE, ascending_case, operands, random_case

CPU = torch.device("cpu")
M = 0xFFFFFFFF
AGGREGATE, INCLUSIVE = 1, 2  # status flags of a tile; 0: nothing published yet
WINDOW = 32  # tiles a look-back round reads (one per lane of a warp)
IDENTITY = (0, 0, 0, 0)  # Fold: (head_sum, tail, live, has_end)


def combine(x, y):
    """The kernel's combine(): the fold of x's rows followed by y's."""
    xh, xt, xl, xe = x
    yh, yt, yl, ye = y
    if not xe:
        return ((xt + yh) & M, yt, yl, 1) if ye else (0, (xt + yt) & M, 0, 0)
    if not ye:
        return (xh, (xt + yt) & M, xl, 1)
    return (xh, yt, xl + yl + int((xt + yh) & M != 0), 1)


def live_count(f):
    """Live runs ended in f's rows when they start at the stream's first row."""
    return f[2] + int(bool(f[3]) and f[0] != 0)


def fold_rows(counts, ends):
    """The Fold of a stretch of rows, vectorised."""
    cs = np.cumsum(counts.astype(np.int64))
    if not ends.any():
        return (0, int(cs[-1]) & M if len(cs) else 0, 0, 0)
    idx = np.flatnonzero(ends)
    between = np.diff(cs[idx]) & M  # totals of the runs after the first end
    return (int(cs[idx[0]]) & M, int(cs[-1] - cs[idx[-1]]) & M, int((between != 0).sum()), 1)


def merged_stream(case, b_desc=True):
    """The merge of a case, B stored descending (K1's layout) or ascending
    (K4's), A first on ties: keys [n, NL], counts, run ends, and S, the
    rows that are not the sentinel."""
    NL, a, ac, b, bc = case
    if b_desc:
        b, bc = b[:, ::-1], bc[::-1]
    keys = np.concatenate([a, b], 1).T
    cnt = np.concatenate([ac, bc]).astype(np.int64)
    order = np.lexsort(keys.T[::-1], axis=0) if len(cnt) else np.zeros(0, np.int64)
    keys, cnt = keys[order], cnt[order]
    ends = np.ones(len(cnt), bool)
    ends[:-1] = (keys[1:] != keys[:-1]).any(axis=1)
    S = int((~(keys == M).all(axis=1)).sum())
    assert (keys[:S] != M).any(axis=1).all() and (keys[S:] == M).all()
    return keys, cnt, ends, S


def _block(t, T, stream, status, pays, result, stats, window):
    """One block of the kernel on tile t, as a generator that yields
    wherever another block may run (see the module docstring)."""
    keys, cnt, ends, S = stream
    d0 = t * T
    if d0 >= S:
        return  # a sentinel tile
    e = min(d0 + T, len(cnt), S)
    agg = fold_rows(cnt[d0:e], ends[d0:e])
    if t > 0:
        status[t], pays[t] = AGGREGATE, agg
        yield
    before, end = IDENTITY, t
    while end > 0:
        idx = [i for i in range(end - 1, end - 1 - window, -1)]
        flags = [status[i] if i >= 0 else INCLUSIVE for i in idx]
        stop = next((k for k, f in enumerate(flags) if f == INCLUSIVE), window)
        if any(f == 0 for f in flags[:stop]):
            stats["spins"] += 1
            yield
            continue
        stats["rounds"] += 1
        part = IDENTITY
        for i in reversed(idx[: stop + 1]):  # the window's tiles in order
            part = combine(part, pays[i] if i >= 0 else IDENTITY)
        before = combine(part, before)
        if stop < window:
            break
        end -= window
    incl = combine(before, agg)
    status[t], pays[t] = INCLUSIVE, incl
    result["before"][t] = before
    if e == S:
        result["live_total"] = live_count(incl)
    yield


def emulate(case, T, resident=1, seed=0, window=WINDOW, b_desc=True, out_rows=None):
    """The kernel's protocol for tiles of T rows: tickets go out in tile
    order to at most `resident` blocks at once, and a block drawn at random
    (seeded) takes each next step; resident=1 runs the tiles in order.
    ``b_desc``: B stored descending (K1, K3) or ascending (K4);
    ``out_rows``: K1's output width (na+nb by default).  Returns (K1 out,
    K1 live total, K3's or K4's out, per-tile folds before each tile,
    stats)."""
    NL = case[0]
    stream = merged_stream(case, b_desc)
    keys, cnt, ends, S = stream
    n = len(cnt)
    out_rows = n if out_rows is None else out_rows
    tiles = -(-n // T)
    status, pays = [0] * tiles, [None] * tiles
    result = {"before": {}, "live_total": 0}
    stats = Counter()
    rng = np.random.default_rng(seed)
    blocks, ticket = [], 0
    while blocks or ticket < tiles:
        while len(blocks) < resident and ticket < tiles:
            blocks.append(_block(ticket, T, stream, status, pays, result, stats, window))
            ticket += 1
        k = int(rng.integers(len(blocks)))
        try:
            next(blocks[k])
        except StopIteration:
            blocks.pop(k)
    # Each tile's writes, from the fold of the rows before it.
    k1 = np.full((NL + 1, out_rows), 0x5A5A5A5A, np.uint32)  # no row the kernel leaves unwritten
    k3 = np.full((NL + 1, n), 0x5A5A5A5A, np.uint32)
    k3[:NL, S:], k3[NL, S:] = M, 0  # sentinel tiles, and the sentinel rows of the last tile
    for t, before in result["before"].items():
        d0, e = t * T, min(t * T + T, S)
        idx = d0 + np.flatnonzero(ends[d0:e])
        cs = np.cumsum(cnt[d0:e])
        totals = cs[idx - d0] - np.concatenate([[0], cs[idx[:-1] - d0]])
        if len(totals):
            totals[0] += before[1]  # the carry: counts of the run open at d0
        totals &= M
        k3[:NL, d0:e] = keys[d0:e].T
        k3[NL, d0:e] = 0
        k3[NL, idx] = totals
        live = idx[totals != 0]
        pos = live_count(before) + np.arange(len(live))
        fits = pos < out_rows  # live rows of rank out_rows and above are not written
        k1[:NL, pos[fits]] = keys[live[fits]].T
        k1[NL, pos[fits]] = totals[totals != 0][fits]
    lt = result["live_total"]
    k1[:NL, min(lt, out_rows):], k1[NL, min(lt, out_rows):] = M, 0  # K1's fill
    return k1, lt, k3, result["before"], stats


def check_model(case, T, b_desc=True, out_rows=None, **kw):
    """The model on a K1-layout case, in K1's layout (b_desc) or K4's (B
    ascending, tests/test_torch_cuda.merge_case_layout), against the plain
    K1 (with out_rows) and the plain K3 or K4.  Returns the folds before
    each tile and the protocol's stats."""
    layout = case if b_desc else ascending_case(case)
    k1, lt, fold, before, stats = emulate(layout, T, b_desc=b_desc, out_rows=out_rows, **kw)
    a_ops, b_ops, NL = operands(case, CPU)
    want_k1, want_lt = mfc.merge_fold_compact(a_ops, b_ops, NL, out_rows)
    if b_desc:
        want_fold = mr.merge_sorted_runs_fold_bitonic(a_ops, b_ops, NL)
    else:
        want_fold = mr.merge_sorted_runs_fold(*operands(layout, CPU))
    assert lt == int(want_lt)
    np.testing.assert_array_equal(k1, to_numpy(want_k1))
    np.testing.assert_array_equal(fold, to_numpy(want_fold))
    return before, stats


def _fold_case(name):
    return FOLD_CASES[name](np.random.default_rng(0))


@pytest.mark.parametrize("order", ["in_order", "shuffled"])
@pytest.mark.parametrize("name", sorted(FOLD_CASES))
def test_lookback_model_at_the_kernel_tile_matches_plain(name, order):
    """The cases of the kernel's own tile: its edges, the sentinel tail one
    row before, at and after a tile edge, a 97%-sentinel prefix, no live
    key, keys next to the sentinel, a run over 65 tiles, totals that wrap
    across tiles; 300 blocks resident in the shuffled order."""
    case = _fold_case(name)
    kw = {"resident": 300, "seed": 1} if order == "shuffled" else {}
    _, stats = check_model(case, FOLD_TILE[case[0]], **kw)
    if order == "in_order":
        assert stats["spins"] == 0  # every look-back finds its predecessor's inclusive fold


@pytest.mark.parametrize("T", [1, 3, 64])
@pytest.mark.parametrize("name", ["random", *sorted(EDGE_CASES)])
def test_lookback_model_at_small_tiles_matches_plain_and_the_split_kernels(name, T):
    """Many tiles, shuffled, with look-back rounds of 4 tiles (walks over
    several rounds); the fold before each tile that the look-back finds
    gives the same carry and output offset as the fold of every merged row
    before the tile taken in one piece (what the split kernels' per-tile
    scans computed)."""
    rng = np.random.default_rng(T)
    case = random_case(rng, 3, 700, 900) if name == "random" else EDGE_CASES[name](rng)
    before, stats = check_model(case, T, resident=300, seed=T, window=4)
    _, cnt, ends, _ = merged_stream(case)
    for t, f in before.items():
        whole = fold_rows(cnt[: t * T], ends[: t * T])
        assert (f[1], live_count(f)) == (whole[1], live_count(whole))
    if T <= 3 and len(before) > 100:
        assert stats["spins"] > 0 and stats["rounds"] > len(before)


@pytest.mark.parametrize("order", ["in_order", "shuffled"])
@pytest.mark.parametrize("name", sorted(FOLD_CASES))
def test_lookback_model_in_k4_layout_at_the_kernel_tile_matches_plain(name, order):
    """The same cases with B ascending (K4): B's sentinel rows come last,
    and its dead rows (all-zero keys, count 0) first."""
    case = _fold_case(name)
    kw = {"resident": 300, "seed": 2} if order == "shuffled" else {}
    _, stats = check_model(case, FOLD_TILE[case[0]], b_desc=False, **kw)
    if order == "in_order":
        assert stats["spins"] == 0


@pytest.mark.parametrize("where", ["zero", "below_live", "at_live", "above_live"])
@pytest.mark.parametrize("name", ["random", *sorted(EDGE_CASES)])
def test_lookback_model_k1_with_out_rows_matches_plain(name, where):
    """K1 writing out_rows columns: live rows of rank out_rows and above
    are dropped, the fill stops at out_rows, the live total counts every
    live row."""
    rng = np.random.default_rng(len(name))
    case = random_case(rng, 3, 700, 900) if name == "random" else EDGE_CASES[name](rng)
    a_ops, b_ops, NL = operands(case, CPU)
    live = int(mfc.merge_fold_compact(a_ops, b_ops, NL)[1])
    n = a_ops[0].numel() + b_ops[0].numel()
    out_rows = {"zero": 0, "below_live": live // 2, "at_live": live, "above_live": (live + n + 1) // 2}[where]
    check_model(case, 64, out_rows=out_rows, resident=300, seed=5, window=4)


def test_lookback_model_run_longer_than_the_window_walks_many_rounds():
    """One run over 65 kernel tiles, here cut in tiles of 512 rows: with the
    tiles published only as aggregates (300 resident blocks in a shuffled
    order), look-backs walk more than one window of 32 tiles."""
    case = _fold_case("run_longer_than_look_back")
    _, stats = check_model(case, FOLD_TILE[1] // 8, resident=300, seed=3)
    assert stats["rounds"] > -(-len(merged_stream(case)[1]) // (FOLD_TILE[1] // 8))


@pytest.mark.parametrize("seed", range(4))
def test_fold_is_associative_over_any_cut(seed):
    """The fold of a stretch equals the combine of the folds of its pieces,
    however it is cut: the kernel folds rows per thread, threads per block
    (cub scan) and tiles per look-back window."""
    rng = np.random.default_rng(seed)
    n = 500
    counts = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.int64)
    counts[rng.random(n) < 0.3] = 0
    ends = rng.random(n) < rng.choice([0.01, 0.2, 0.9])
    whole = fold_rows(counts, ends)
    cuts = np.sort(rng.choice(np.arange(1, n), rng.integers(1, 60), replace=False))
    acc = IDENTITY
    for lo, hi in zip([0, *cuts], [*cuts, n]):
        acc = combine(acc, fold_rows(counts[lo:hi], ends[lo:hi]))
    assert acc[1:] == whole[1:] and (acc[0] == whole[0] or not whole[3])
    rows = IDENTITY
    for c, e in zip(counts, ends):
        rows = combine(rows, (int(c) & M, 0, 0, 1) if e else (0, int(c) & M, 0, 0))
    assert rows[1:] == whole[1:] and (rows[0] == whole[0] or not whole[3])
