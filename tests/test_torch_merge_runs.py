"""The plain merges K3, K4 and K5 (ops.merge_runs) vs the JAX Pallas kernels.

``pallas_sort.merge_sorted_runs_fold_bitonic`` (K3), ``merge_sorted_runs_fold``
(K4) and ``merge_sorted_runs`` (K5) run in interpret mode at a 1024-row
tile (slow: each case stays within 4 tiles); the port runs on CPU tensors,
so its wrappers take the plain versions.  K3 and K4 must match bit for
bit; K5 leaves the order among equal keys to the kernel, so its keys must
match bit for bit and its payloads as a multiset per key.

The CUDA kernels run only on the card (tests/test_torch_cuda.py,
chip_smoke.py).  K3 and K4 run the one-pass kernel of K1, whose numpy
model (tests/test_torch_merge_lookback.py) is held here in K4's layout
against the plain K4, with the tiles completing in a shuffled order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_counter_tpu.ops import pallas_sort as ps
from kmer_counter_tpu_torch.ops import merge_runs as mr
from kmer_counter_tpu_torch.ops.u32 import to_numpy

from tests.test_torch_cuda import EDGE_CASES, TILE, ascending_case, operands, random_case
from tests.test_torch_merge_lookback import check_model

CPU = torch.device("cpu")
M = 0xFFFFFFFF

# Consolidation-shaped cases (K1's layout: B stored descending), at most 4
# tiles: NL 1, 2, 4; counts near 2^32 (random_case) and a total that wraps;
# heavy duplicates; a run across every tile edge and runs ending on one;
# dead rows colliding with a genuine all-zero key.
CASES = {
    "heavy_dups_nl2": lambda rng: random_case(rng, 2, TILE, TILE, pool=40),
    "random_nl4": lambda rng: random_case(rng, 4, TILE // 2, 3 * TILE // 2),
    **{name: EDGE_CASES[name] for name in ("dead_rows_collide_with_a_zero_key", "run_spans_all_tiles",
                                            "run_ends_on_tile_edge", "count_wraparound")},
}
# Cases the JAX functions are not run on (they only add plain-vs-emulation
# coverage): wide records and lopsided sides.
MORE_CASES = {name: EDGE_CASES[name] for name in sorted(set(EDGE_CASES) - set(CASES))}

KERNELS = {  # name: (port wrapper, Pallas function, B stored descending)
    "K3": (mr.merge_sorted_runs_fold_bitonic, ps.merge_sorted_runs_fold_bitonic, True),
    "K4": (mr.merge_sorted_runs_fold, ps.merge_sorted_runs_fold, False),
    "K5": (mr.merge_sorted_runs, ps.merge_sorted_runs, False),
}


def _kernel_case(case, desc):
    """The case in the kernel's layout; for K5 (desc False and a payload)
    see _k5_case."""
    return case if desc else ascending_case(case)


def _k5_case(case):
    """K5's operands: B ascending; all-ones rows carry payload 0, since the
    JAX kernel loses the payload of an all-ones row (pinned below)."""
    NL, a, ac, b, bc = ascending_case(case)
    ac = np.where((a == M).all(axis=0), 0, ac).astype(np.uint32)
    bc = np.where((b == M).all(axis=0), 0, bc).astype(np.uint32)
    return NL, a, ac, b, bc


def _port(fn, case):
    a_ops, b_ops, NL = operands(case, CPU)
    return to_numpy(fn(a_ops, b_ops, NL))


def _jax(fn, case):
    NL, a, ac, b, bc = case
    out = fn([*(jnp.asarray(a[i]) for i in range(NL)), jnp.asarray(ac)],
             [*(jnp.asarray(b[i]) for i in range(NL)), jnp.asarray(bc)],
             NL, tile=TILE, interpret=True)
    return np.stack([np.asarray(v) for v in out])


def _by_key_then_payload(rows):
    return rows[:, np.lexsort(rows[::-1])]


def _numpy_merge(case):
    """Independent numpy merge of A and B (B ascending): rows [NL+1, n],
    stable, A first on equal keys."""
    NL, a, ac, b, bc = case
    rows = np.concatenate([np.vstack([a, ac]), np.vstack([b, bc])], 1)
    return rows[:, np.lexsort(rows[:NL][::-1])]


def _numpy_fold(rows, NL):
    """Run totals mod 2^32 on each run's last row; sentinel runs 0."""
    keys, counts = rows[:NL], rows[NL].astype(np.int64)
    n = keys.shape[1]
    out = np.zeros(n, np.uint32)
    start = 0
    for i in range(n):
        if i == n - 1 or (keys[:, i] != keys[:, i + 1]).any():
            if not (keys[:, i] == M).all():
                out[i] = counts[start : i + 1].sum() & M
            start = i + 1
    return np.vstack([keys, out[None]])


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_plain_merges_match_pallas(kernel, name):
    port_fn, jax_fn, desc = KERNELS[kernel]
    case = CASES[name](np.random.default_rng(len(name)))
    case = _kernel_case(case, desc) if kernel != "K5" else _k5_case(case)
    got, want = _port(port_fn, case), _jax(jax_fn, case)
    NL = case[0]
    if kernel == "K5":
        np.testing.assert_array_equal(got[:NL], want[:NL])
        np.testing.assert_array_equal(_by_key_then_payload(got), _by_key_then_payload(want))
    else:
        np.testing.assert_array_equal(got, want)
        assert got[NL].any()


@pytest.mark.parametrize("n", [(1, 0), (0, 1), (5, 3), (777, 1301), (3001, 17)])
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_plain_merges_at_ragged_sizes_match_numpy(kernel, n):
    """Sizes the JAX functions refuse (no multiple of their tile)."""
    port_fn, _, desc = KERNELS[kernel]
    na, nb = n
    case = random_case(np.random.default_rng(na + nb), 3, na, nb, pool=max((na + nb) // 4, 2))
    got = _port(port_fn, _kernel_case(case, desc))
    merged = _numpy_merge(ascending_case(case))
    want = merged if kernel == "K5" else _numpy_fold(merged, 3)
    np.testing.assert_array_equal(got, want)


def test_empty_merge():
    case = random_case(np.random.default_rng(0), 2, 0, 0)
    for port_fn, _, desc in KERNELS.values():
        assert _port(port_fn, _kernel_case(case, desc)).shape == (3, 0)


def test_jax_k5_loses_all_ones_payload_port_keeps_it():
    """A fault of the JAX package (ROADMAP Queue 3): _merge_pair_call masks
    window slack to (all-ones key, payload 0) by key and keeps half of the
    merged rows, so slack rows can take the place of genuine all-ones rows
    and their payloads are lost.  The port's merge windows come from exact
    splits, so no slack row exists."""
    rng = np.random.default_rng(0)
    a = np.sort(rng.integers(0, 2**31, TILE).astype(np.uint32))[None]
    b = np.sort(rng.integers(0, 2**31, TILE).astype(np.uint32))[None]
    a[0, -3:], b[0, -2:] = M, M
    ap = np.arange(1, TILE + 1, dtype=np.uint32)
    case = (1, a, ap, b, ap + TILE)
    want_ones = sorted([*ap[-3:], *(ap + TILE)[-2:]])
    jax_out = _jax(ps.merge_sorted_runs, case)
    np.testing.assert_array_equal(jax_out[0], np.sort(np.concatenate([a[0], b[0]])))
    assert sorted(jax_out[1, jax_out[0] == M]) != want_ones  # the payloads are gone
    port = _port(mr.merge_sorted_runs, case)
    np.testing.assert_array_equal(port[0], jax_out[0])
    assert sorted(port[1, port[0] == M]) == want_ones


@pytest.mark.parametrize("T", [1, 3, 64, TILE])
@pytest.mark.parametrize("name", ["random", *sorted(CASES), *sorted(MORE_CASES)])
def test_kernel_fold_tile_logic_matches_plain(name, T):
    """K4 on the one-pass kernel: its model with B ascending (sentinel rows
    last), 300 blocks resident in a shuffled order, against the plain K4
    (and its compacted output against the plain K1)."""
    rng = np.random.default_rng(T)
    build = {**CASES, **MORE_CASES}.get(name)
    case = random_case(rng, 3, 700, 900) if build is None else build(rng)
    check_model(case, T, b_desc=False, resident=300, seed=T)


@pytest.mark.parametrize("fn", [mr.merge_sorted_runs_fold_bitonic, mr.merge_sorted_runs_fold,
                                mr.merge_sorted_runs])
def test_wrappers_have_no_fallback_for_other_devices(fn):
    ops = [torch.zeros(4, dtype=torch.int32, device="meta") for _ in range(2)]
    with pytest.raises(RuntimeError, match="no kernel"):
        fn(ops, ops, 1)
