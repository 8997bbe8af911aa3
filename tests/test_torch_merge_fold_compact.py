"""The plain merge-fold-compact (K1) vs the JAX Pallas kernel.

``pallas_sort.merge_fold_compact_bitonic`` runs in interpret mode at a
1024-row tile (slow: each case stays within 4 tiles); the port runs on CPU
tensors, so its wrapper takes the plain version.  Exact equality of every
output row, fill included, and of live_count.

The CUDA kernels run only on the card (tests/test_torch_cuda.py,
chip_smoke.py).  The cross-tile logic of the split passes — per-tile
stats, then torch scans (``tile_carry_and_offsets``), then per-tile
compaction; K4 runs them — is checked here against the plain K1 by
computing the same per-tile numbers in numpy.  The one-pass kernel that
runs K1 and K3 has its model in tests/test_torch_merge_lookback.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_counter_tpu.ops import pallas_sort as ps
from kmer_counter_tpu.ops import table2 as jax_t2
from kmer_counter_tpu_torch.ops import merge_fold_compact as mfc
from kmer_counter_tpu_torch.ops.u32 import to_numpy

from tests.test_torch_cuda import EDGE_CASES, TILE, operands, random_case

CPU = torch.device("cpu")
M = 0xFFFFFFFF


def _jax_k1(case):
    NL, a, ac, bd, bc = case
    out, live = ps.merge_fold_compact_bitonic(
        [*(jnp.asarray(a[i]) for i in range(NL)), jnp.asarray(ac)],
        [*(jnp.asarray(bd[i]) for i in range(NL)), jnp.asarray(bc)],
        num_keys=NL,
        tile=TILE,
        interpret=True,
    )
    return np.stack([np.asarray(o) for o in out]), int(live)


def _port_k1(case):
    a_ops, b_ops, NL = operands(case, CPU)
    out, live = mfc.merge_fold_compact(a_ops, b_ops, NL)
    return to_numpy(out), int(live)


def _check_vs_jax(case):
    got, got_live = _port_k1(case)
    want, want_live = _jax_k1(case)
    assert got_live == want_live
    np.testing.assert_array_equal(got, want)
    return got_live


@pytest.mark.parametrize("NL", [1, 2, 4, 7])
def test_plain_k1_matches_pallas_random(NL):
    case = random_case(np.random.default_rng(NL), NL, 3 * TILE // 4, 5 * TILE // 4)
    assert _check_vs_jax(case) > 0


@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_plain_k1_matches_pallas_edge_cases(name):
    _check_vs_jax(EDGE_CASES[name](np.random.default_rng(0)))


def test_count_wraparound_case_drops_the_zero_total():
    out, live = _port_k1(EDGE_CASES["count_wraparound"](np.random.default_rng(0)))
    assert live == 2
    assert out[:, :2].tolist() == [[4, 6], [1 << 31, TILE // 2]]


def test_jax_k1_over_counts_after_grow2_zero_padding():
    """Pins a fault of the JAX package (ROADMAP Queue 3): table2.grow2 pads
    the prefix with ZERO keys after the sentinel fill, so the prefix handed
    to the merge kernel is no longer ascending, and the kernel's merge-path
    windows then overlap: rows are counted twice.  The port's grow2 pads
    with the sentinel key, which keeps A ascending."""
    rng = np.random.default_rng(3)
    live = np.unique(rng.integers(1, 5000, 700).astype(np.uint32))[:600]
    pl = np.full((1, TILE), M, np.uint32)
    pc = np.zeros(TILE, np.uint32)
    pl[0, : len(live)] = live
    pc[: len(live)] = rng.integers(1, 5, len(live))
    table = jax_t2.TwoLevelTable(
        jnp.asarray(pl), jnp.asarray(pc), jnp.zeros((1, 2 * TILE), jnp.uint32),
        jnp.int32(0), jnp.uint32(0),
    )
    grown = jax_t2.grow2(table, 2 * TILE, 2 * TILE)
    a = np.asarray(grown.prefix_lanes)
    ac = np.asarray(grown.prefix_counts)
    assert (a[0, TILE:] == 0).all()  # zero keys after the sentinel fill
    b = np.sort(rng.integers(0, 6000, 2 * TILE).astype(np.uint32))[::-1].copy()
    bc = np.ones(2 * TILE, np.uint32)
    b[-100:], bc[-100:] = 0, 0
    true_total = int(ac.sum(dtype=np.int64) + bc.sum(dtype=np.int64))

    want, want_live = _port_k1((1, a, ac, b[None], bc))
    assert int(want[1, :want_live].sum(dtype=np.int64)) == true_total
    # the JAX kernel on the zero-padded prefix: more rows and counts than exist
    got, got_live = _jax_k1((1, a, ac, b[None], bc))
    assert got_live > want_live
    assert int(got[1, :got_live].sum(dtype=np.int64)) > true_total
    # the same rows padded the port's way (sentinel) agree with JAX exactly
    a_sent = np.where(np.arange(2 * TILE) >= TILE, M, a).astype(np.uint32)
    _check_vs_jax((1, a_sent, ac, b[None], bc))


def tile_scan(case, T):
    """The merge and the per-tile scan of the CUDA kernel's fold variants
    in numpy for a tile of T rows (tile t holds merged rows [t*T,
    (t+1)*T)): the merged keys ``[n, NL]`` and counts, run ends, sentinel
    rows, each row's (flag, seg) of the block's segmented scan, and the
    per-tile stats as stats_kernel writes them."""
    NL, a, ac, bd, bc = case
    keys = np.concatenate([a, bd[:, ::-1]], 1).T
    cnt = np.concatenate([ac, bc[::-1]]).astype(np.int64)
    order = np.lexsort(keys.T[::-1])
    keys, cnt = keys[order], cnt[order]
    n = len(cnt)
    differs = (keys[1:] != keys[:-1]).any(axis=1)
    head = np.concatenate([[True], differs])
    end = np.concatenate([differs, [True]])
    sent = (keys == M).all(axis=1)
    tiles = -(-n // T)
    stats = np.zeros((mfc.NUM_STATS, tiles), np.int64)
    rows = []  # per row: (flag, seg) of the block's segmented scan
    for t in range(tiles):
        flag = seg = tot = 0
        for p in range(t * T, min(t * T + T, n)):
            if head[p]:
                flag, seg = 1, 0
            seg = (seg + cnt[p]) & M
            tot = (tot + cnt[p]) & M
            rows.append((flag, seg))
            if end[p]:
                stats[mfc.HAS_END, t] = 1
                if flag:
                    stats[mfc.LIVE_LOCAL, t] += int(not sent[p] and seg != 0)
                else:
                    stats[[mfc.HAS_OPEN, mfc.OPEN_SUM, mfc.OPEN_SENT], t] = [1, seg, sent[p]]
            if p == min(t * T + T, n) - 1:
                stats[mfc.TAIL, t] = 0 if end[p] else seg
        stats[mfc.TILE_SUM, t] = tot
    return keys, cnt, end, sent, rows, stats


def _emulate_kernel(case, T):
    """K1's passes in numpy for a tile of T rows: tile_scan, then
    mfc.tile_carry_and_offsets, then compaction as the write pass does it."""
    NL = case[0]
    keys, _, end, sent, rows, stats = tile_scan(case, T)
    n, tiles = len(rows), stats.shape[1]
    carry, out_off, live_total = mfc.tile_carry_and_offsets(torch.from_numpy(stats))
    out = np.full((NL + 1, n), M, np.uint32)
    out[NL] = 0
    for t in range(tiles):
        pos = int(out_off[t])
        for p in range(t * T, min(t * T + T, n)):
            flag, seg = rows[p]
            total = seg if flag else (int(carry[t]) + seg) & M
            if end[p] and not sent[p] and total != 0:
                out[:NL, pos], out[NL, pos] = keys[p], total
                pos += 1
    return out, int(live_total)


@pytest.mark.parametrize("T", [1, 3, 64, TILE])
@pytest.mark.parametrize("name", ["random", *sorted(EDGE_CASES)])
def test_kernel_tile_logic_matches_plain(name, T):
    rng = np.random.default_rng(T)
    case = random_case(rng, 3, 700, 900) if name == "random" else EDGE_CASES[name](rng)
    got, got_live = _emulate_kernel(case, T)
    want, want_live = _port_k1(case)
    assert got_live == want_live
    np.testing.assert_array_equal(got, want)
