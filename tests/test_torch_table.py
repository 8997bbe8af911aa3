"""Port one-level table (ops.table) and its chunk step (pipeline.extract_chunk)
vs the JAX ops.table / ops.pipeline.extract_chunk, on the same state.

Exact equality: offsets, every count, and the key lanes of the slots in
use (slots past the offset have count 0 and unspecified keys by contract).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_counter_tpu import golden, records
from kmer_counter_tpu.ops import table as jt
from kmer_counter_tpu.ops.pipeline import extract_chunk as jax_extract_chunk
from kmer_counter_tpu_torch.ops import table as t1
from kmer_counter_tpu_torch.ops.pipeline import extract_chunk
from kmer_counter_tpu_torch.ops.u32 import from_numpy, to_numpy

from conftest import random_reads

CPU = torch.device("cpu")
M = 0xFFFFFFFF


def _columns(lanes: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """(key, count) columns in a canonical order."""
    rows = np.vstack([lanes, counts[None]])
    return rows[:, np.lexsort(rows[::-1])]


def assert_same_state(port: t1.CountTable, jax_table: jt.CountTable):
    n = int(jax_table.offset)
    assert port.offset == n
    np.testing.assert_array_equal(to_numpy(port.counts), np.asarray(jax_table.counts))
    np.testing.assert_array_equal(to_numpy(port.lanes)[:, :n], np.asarray(jax_table.lanes)[:, :n])


@pytest.mark.parametrize("k", [15, 16, 31, 55, 101])
@pytest.mark.parametrize("canonical", [False, True])
def test_extract_chunk_matches_jax(rng, k, canonical):
    reads = random_reads(rng, 9, k + 20, invalid_frac=0.05)
    reads[2] = ord("T")  # all-T windows: ordinary all-ones keys with count 1
    lanes, counts = extract_chunk(torch.from_numpy(reads), k, canonical)
    j_lanes, j_counts = (np.asarray(v) for v in jax_extract_chunk(jnp.asarray(reads), k, canonical))
    got_l, got_c = to_numpy(lanes), to_numpy(counts)
    assert got_l.shape == j_lanes.shape == (records.active_lanes(k), 9 * 21)
    assert set(np.unique(got_c)) <= {0, 1} and got_c.sum() == j_counts.sum() > 0
    # the JAX extract is position-major for NL <= 2, the port read-major:
    # equal as multisets of the valid windows
    np.testing.assert_array_equal(_columns(got_l[:, got_c == 1], got_c[got_c == 1]),
                                  _columns(j_lanes[:, j_counts == 1], j_counts[j_counts == 1]))
    if k % 16 == 0 and not canonical:
        assert (got_l[:, got_c == 1] == M).all(axis=0).sum() >= 21  # read 2's windows


def _chunk(rng, NL, n):
    """A raw chunk: keys with repeats (some all-ones, i.e. the all-T key,
    with count 1), counts 0/1."""
    lanes = rng.integers(0, 6, (NL, n)).astype(np.uint32)
    lanes[:, rng.random(n) < 0.1] = M
    return lanes, (rng.random(n) < 0.8).astype(np.uint32)


@pytest.mark.parametrize("NL", [1, 2, 5])
def test_append_consolidate_grow_match_jax(rng, NL):
    port, jax_table = t1.make_table(64, NL, CPU), jt.make_table(64, NL)
    for step in range(6):
        lanes, counts = _chunk(rng, NL, 20)
        if port.offset + 20 > port.lanes.shape[1]:
            port, jax_table = t1.consolidate(port), jt.consolidate(jax_table)
            assert_same_state(port, jax_table)
        if step == 4:
            port, jax_table = t1.grow(port, 128), jt.grow(jax_table, 128)
            assert_same_state(port, jax_table)
        port = t1.append(port, from_numpy(lanes, CPU), from_numpy(counts, CPU))
        jax_table = jt.append(jax_table, jnp.asarray(lanes), jnp.asarray(counts), jnp.int32(20))
        assert_same_state(port, jax_table)
    port, jax_table = t1.consolidate(port), jt.consolidate(jax_table)
    assert_same_state(port, jax_table)
    assert port.lanes.shape[1] == 128 and 0 < port.offset < 128


def test_consolidate_counts_like_golden(rng):
    k = 16
    reads = random_reads(rng, 12, 40, invalid_frac=0.03)
    reads[4] = ord("T")
    table = t1.make_table(12 * 25, records.active_lanes(k), CPU)
    for half in (reads[:6], reads[6:]):
        t1.append(table, *extract_chunk(torch.from_numpy(half), k, False))
    table = t1.consolidate(table)
    words, counts = golden.table_from_counter(golden.count_reads(reads, k, False))
    n = table.offset
    np.testing.assert_array_equal(to_numpy(table.lanes)[:, :n], records.words_to_lanes(words)[:, :1].T)
    np.testing.assert_array_equal(to_numpy(table.counts)[:n], counts)
    assert to_numpy(table.lanes)[0, n - 1] == M and to_numpy(table.counts)[n - 1] == 25  # T^16


def test_append_raises_on_overflow_and_grow_cannot_shrink():
    table = t1.make_table(10, 1, CPU)
    t1.append(table, torch.zeros((1, 6), dtype=torch.int32), torch.ones(6, dtype=torch.int32))
    with pytest.raises(ValueError, match="overflows"):
        t1.append(table, torch.zeros((1, 5), dtype=torch.int32), torch.ones(5, dtype=torch.int32))
    assert table.offset == 6
    with pytest.raises(ValueError, match="shrink"):
        t1.grow(table, 8)
