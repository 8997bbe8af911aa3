"""Port sort_reduce / lex_argsort vs the JAX sort_reduce and numpy.

Exact equality: slots [0, num_unique) of the lanes, every count, and
num_unique (slots past num_unique have unspecified keys by contract).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_counter_tpu.ops.sortcount import sort_reduce as jax_sort_reduce
from kmer_counter_tpu_torch.ops.sortcount import lex_argsort, sort_reduce
from kmer_counter_tpu_torch.ops.u32 import from_numpy, to_numpy

CPU = torch.device("cpu")


def _check(lanes: np.ndarray, counts: np.ndarray):
    u_lanes, u_counts, n = sort_reduce(from_numpy(lanes, CPU), from_numpy(counts, CPU))
    j_lanes, j_counts, j_n = jax_sort_reduce(jnp.asarray(lanes), jnp.asarray(counts))
    assert n == int(j_n)
    np.testing.assert_array_equal(to_numpy(u_lanes)[:, :n], np.asarray(j_lanes)[:, :n])
    np.testing.assert_array_equal(to_numpy(u_counts), np.asarray(j_counts))
    return n


@pytest.mark.parametrize("NL", [1, 2, 3, 5, 8])
def test_lex_argsort_is_unsigned_lexicographic(rng, NL):
    lanes = rng.choice(np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32), (NL, 500))
    perm = lex_argsort(from_numpy(lanes, CPU)).numpy()
    want = np.lexsort(lanes[::-1])  # stable too
    np.testing.assert_array_equal(perm, want)


@pytest.mark.parametrize("NL", [1, 2, 3, 5, 8])
def test_sort_reduce_matches_jax(rng, NL):
    N = 700
    lanes = rng.integers(0, 6, (NL, N)).astype(np.uint32)
    lanes[0] |= rng.choice(np.array([0, 0x80000000], np.uint32), N)
    counts = rng.integers(0, 4, N).astype(np.uint32)
    assert _check(lanes, counts) > 0


def test_sort_reduce_counts_wrap_mod_2_32(rng):
    lanes = np.array([[5, 5, 5, 9, 9, 2, 2]], np.uint32)
    counts = np.array([0xFFFFFFFF, 2, 0, 0x80000000, 0x80000000, 7, 0xFFFFFFF0], np.uint32)
    n = _check(lanes, counts)
    # key 5 wraps to 1; key 9 wraps to exactly 0 but stays (count 0), as
    # in the JAX version: only the trailing group — here the empty row's
    # sentinel group — is dropped when it sums to 0.
    assert n == 3

    lanes = np.array([[5, 5, 9, 9]], np.uint32)
    counts = np.array([0xFFFFFFFF, 2, 0x80000000, 0x80000000], np.uint32)
    # without empty rows key 9 is the trailing group, and is dropped
    assert _check(lanes, counts) == 1


def test_sort_reduce_wrap_to_zero_mid_table_is_kept():
    lanes = np.array([[3, 3, 4, 0xFFFFFFFF]], np.uint32)
    counts = np.array([0x80000000, 0x80000000, 1, 0], np.uint32)
    assert _check(lanes, counts) == 2


@pytest.mark.parametrize("NL", [1, 4])
def test_sort_reduce_empty_input(NL):
    lanes = np.zeros((NL, 64), np.uint32)
    counts = np.zeros(64, np.uint32)
    assert _check(lanes, counts) == 0


def test_sort_reduce_sentinel_key_with_count_is_kept():
    # a real all-ones key (the all-T k-mer at k % 16 == 0) merges with the
    # empty rows' sentinel group and keeps its count
    lanes = np.array([[0xFFFFFFFF, 1, 0xFFFFFFFF, 7]], np.uint32)
    counts = np.array([3, 1, 0, 0], np.uint32)
    assert _check(lanes, counts) == 2
