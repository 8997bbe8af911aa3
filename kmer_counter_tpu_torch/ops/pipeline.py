"""Per-chunk counting step — counterpart of kmer_counter_tpu.ops.pipeline.

extract_chunk: encode → extract, keys with 0/1 counts (the one-level
table's chunk); extract_chunk_keys: the same with sentinel masking (+ the
all-T side count); count_step_two_level: that, written straight into the
raw region at ``raw_off``.  All three run K8 (ops.fused_extract): its
CUDA kernel for CUDA reads, its plain torch version for CPU reads.
"""

from __future__ import annotations

import torch

from kmer_counter_tpu_torch.ops import fused_extract as fx
from kmer_counter_tpu_torch.records import active_lanes


def extract_chunk(
    reads: torch.Tensor, k: int, canonical: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """One chunk's raw k-mer records, unsorted: (lanes ``[NL, R*(L-k+1)]
    int32``, counts ``int32``, 1 for a valid window and 0 for a masked
    one).  No sentinel masking and no all-T side count: in the one-level
    table the all-T k-mer is an ordinary all-ones key with count 1."""
    out = fx.extract_chunk_lanes_major(reads, k, canonical)
    return out[:-1], out[-1]


def extract_chunk_keys(
    reads: torch.Tensor, k: int, canonical: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """One chunk's k-mer keys with validity in-band.

    Returns (lanes ``[NL, R*(L-k+1)] int32`` read-major, allt ``int64``
    0-d tensor).  Masked windows get the all-ones sentinel key.  When
    k % 16 == 0 in forward mode a valid all-T k-mer is bit-identical to
    the sentinel, so those windows are tallied into ``allt`` instead
    (canonical(T^k) = A^k, so canonical runs never produce it).
    """
    R, L = reads.shape
    lanes = torch.empty((active_lanes(k), chunk_slots(R, L, k)), dtype=torch.int32, device=reads.device)
    allt = torch.zeros((), dtype=torch.int64, device=reads.device)
    fx.extract_chunk_keys_into(reads, k, canonical, lanes, 0, allt)
    return lanes, allt


def count_step_two_level(table, reads: torch.Tensor, k: int, canonical: bool = False):
    """Extract one chunk's keys into ``table``'s raw region at the
    host-mirrored ``raw_off`` and add its all-T windows to ``table.allt``;
    raises ValueError if they would pass the region's end (consolidate
    first).

    Unlike the JAX version, which returns a new table from a donated one,
    this updates the table's tensors in place and returns the same table.
    """
    table.raw_off += fx.extract_chunk_keys_into(reads, k, canonical, table.raw_lanes, table.raw_off, table.allt)
    return table


def chunk_slots(n_reads: int, line_length: int, k: int) -> int:
    """Worst-case k-mer slots for a chunk."""
    return n_reads * max(line_length - k + 1, 0)
