"""Port encode/extract vs the JAX package's, on the same reads.

Exact equality: every output is integer.  Key multisets are compared
sorted, since the JAX package orders windows position-major when NL <= 2
(pipeline._extract_flat) and the port read-major.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_counter_tpu.ops.encode import encode_reads as jax_encode
from kmer_counter_tpu.ops.pipeline import extract_chunk_keys as jax_extract
from kmer_counter_tpu_torch.ops.encode import encode_reads
from kmer_counter_tpu_torch.ops.pipeline import extract_chunk_keys
from kmer_counter_tpu_torch.ops.u32 import to_numpy

from conftest import random_reads

CPU = torch.device("cpu")


def _rows_sorted(lanes_nl_n: np.ndarray) -> np.ndarray:
    rows = np.ascontiguousarray(lanes_nl_n.T)
    return rows[np.lexsort(rows.T[::-1])]


def _mixed_reads(rng, n_reads, L):
    """ACGT reads with N bases and some lower case."""
    reads = random_reads(rng, n_reads, L, invalid_frac=0.03)
    lower = (rng.random(reads.shape) < 0.2) & (reads != ord("N"))
    return np.where(lower, reads + 32, reads).astype(np.uint8)


def test_encode_matches_jax_on_every_byte():
    reads = np.arange(256, dtype=np.uint8).reshape(4, 64)
    codes, valid = encode_reads(torch.from_numpy(reads))
    j_codes, j_valid = jax_encode(jnp.asarray(reads))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(j_codes).astype(np.int64))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(j_valid))


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", [1, 15, 16, 31, 32, 33, 55, 64, 101, 128])
def test_extract_chunk_keys_matches_jax(rng, k, canonical):
    L = max(k + 12, 40)
    reads = _mixed_reads(rng, 9, L)
    if k % 16 == 0:
        reads[2] = ord("T")  # all-T windows: the side count in forward mode
        reads[3, : L // 2] = ord("t")
    lanes, allt = extract_chunk_keys(torch.from_numpy(reads), k, canonical)
    j_lanes, j_allt = jax_extract(jnp.asarray(reads), k, canonical)
    assert lanes.dtype == torch.int32
    np.testing.assert_array_equal(
        _rows_sorted(to_numpy(lanes)), _rows_sorted(np.asarray(j_lanes))
    )
    assert int(allt) == int(j_allt)
    if k % 16 == 0 and not canonical:
        assert int(allt) > 0


@pytest.mark.parametrize("k", [16, 32])
def test_all_t_reads_forward(k):
    reads = np.full((4, k + 20), ord("T"), np.uint8)
    reads[1, 7] = ord("N")
    lanes, allt = extract_chunk_keys(torch.from_numpy(reads), k, False)
    j_lanes, j_allt = jax_extract(jnp.asarray(reads), k, False)
    # 21 windows per read; the N at position 7 masks windows 0..7 of read 1
    assert int(allt) == int(j_allt) == 3 * 21 + 13
    # every all-T window went to the side count: the key stream is all sentinel
    assert (to_numpy(lanes) == 0xFFFFFFFF).all()
    np.testing.assert_array_equal(_rows_sorted(to_numpy(lanes)), _rows_sorted(np.asarray(j_lanes)))
