"""The plain merge-fold-compact (K1) vs the JAX Pallas kernel.

``pallas_sort.merge_fold_compact_bitonic`` runs in interpret mode at a
1024-row tile (slow: each case stays within 4 tiles); the port runs on CPU
tensors, so its wrapper takes the plain version.  Exact equality of every
output row, fill included, and of live_count.

The CUDA kernels run only on the card (tests/test_torch_cuda.py,
chip_smoke.py).  The one-pass kernel that runs K1, K3 and K4 has its
model in tests/test_torch_merge_lookback.py; here that model runs in K4's
layout (B ascending) against the plain K1 and K4, and K1's ``out_rows``
(the output cut to the prefix's columns) is held against the JAX kernel's
output cut the same way.
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
from tests.test_torch_merge_lookback import check_model

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


def _port_k1(case, out_rows=None):
    a_ops, b_ops, NL = operands(case, CPU)
    out, live = mfc.merge_fold_compact(a_ops, b_ops, NL, out_rows)
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


@pytest.mark.parametrize("where", ["below_live", "at_live", "above_live"])
def test_plain_k1_with_out_rows_matches_pallas_cut_to_the_prefix(where):
    """What consolidate3 asks of K1: the output's first out_rows columns
    and the count of every live row, against the JAX kernel's output cut as
    _c3_merge_compact_bitonic cuts it ([:cp]); out_rows below the live
    count is the consolidation that loses records."""
    case = random_case(np.random.default_rng(11), 2, TILE, TILE, a_live=0.5)
    want, want_live = _jax_k1(case)
    out_rows = {"below_live": want_live // 3, "at_live": want_live, "above_live": TILE + 5}[where]
    got, got_live = _port_k1(case, out_rows)
    assert got_live == want_live and got.shape == (3, out_rows)
    np.testing.assert_array_equal(got, want[:, :out_rows])


@pytest.mark.parametrize("name", ["random", *sorted(EDGE_CASES)])
def test_plain_k1_with_out_rows_is_the_full_output_cut(name):
    rng = np.random.default_rng(7)
    case = random_case(rng, 3, 700, 900) if name == "random" else EDGE_CASES[name](rng)
    full, live = _port_k1(case)
    for out_rows in sorted({0, 1, live // 2, live, live + 1, full.shape[1]} & set(range(full.shape[1] + 1))):
        got, got_live = _port_k1(case, out_rows)
        assert got_live == live
        np.testing.assert_array_equal(got, full[:, :out_rows])
    a_ops, b_ops, NL = operands(case, CPU)
    with pytest.raises(ValueError, match="out_rows"):
        mfc.merge_fold_compact(a_ops, b_ops, NL, full.shape[1] + 1)


@pytest.mark.parametrize("T", [1, 3, 64, TILE])
@pytest.mark.parametrize("name", ["random", *sorted(EDGE_CASES)])
def test_kernel_tile_logic_matches_plain(name, T):
    """The one-pass kernel's model in K4's layout (B ascending, sentinel
    rows last), tiles in order: its compacted output against the plain K1,
    its folded output against the plain K4."""
    rng = np.random.default_rng(T)
    case = random_case(rng, 3, 700, 900) if name == "random" else EDGE_CASES[name](rng)
    _, stats = check_model(case, T, b_desc=False)
    assert stats["spins"] == 0
