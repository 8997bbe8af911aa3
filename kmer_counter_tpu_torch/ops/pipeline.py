"""Per-chunk counting step — counterpart of kmer_counter_tpu.ops.pipeline.

extract_chunk: encode → extract, keys with 0/1 counts (the one-level
table's chunk); extract_chunk_keys: the same with sentinel masking (+ the
all-T side count); count_step_two_level: that plus the append at
``raw_off``.
"""

from __future__ import annotations

import torch

from kmer_counter_tpu_torch.ops.encode import encode_reads
from kmer_counter_tpu_torch.ops.extract import extract_kmer_lanes
from kmer_counter_tpu_torch.ops.u32 import MASK, narrow


def _extract_flat(reads: torch.Tensor, k: int, canonical: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(lanes ``[NL, R*(L-k+1)] int64``, window validity ``[R*(L-k+1)]``),
    read-major."""
    codes, valid = encode_reads(reads)
    lanes, wvalid = extract_kmer_lanes(codes, valid, k, canonical)
    NL, R, P = lanes.shape
    return lanes.reshape(NL, R * P), wvalid.reshape(R * P)


def extract_chunk(
    reads: torch.Tensor, k: int, canonical: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """One chunk's raw k-mer records, unsorted: (lanes ``[NL, R*(L-k+1)]
    int32``, counts ``int32``, 1 for a valid window and 0 for a masked
    one).  No sentinel masking and no all-T side count: in the one-level
    table the all-T k-mer is an ordinary all-ones key with count 1."""
    flat, wv = _extract_flat(reads, k, canonical)
    return narrow(flat), wv.to(torch.int32)


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
    flat, wv = _extract_flat(reads, k, canonical)
    if k % 16 == 0 and not canonical:
        is_allt = (flat == MASK).all(dim=0) & wv
        allt = is_allt.sum()
        wv = wv & ~is_allt
    else:
        allt = torch.zeros((), dtype=torch.int64, device=reads.device)
    return narrow(torch.where(wv, flat, MASK)), allt


def count_step_two_level(table, reads: torch.Tensor, k: int, canonical: bool = False):
    """Extract one chunk's keys and append them to ``table``'s raw region
    at the host-mirrored ``raw_off``.

    Unlike the JAX version, which returns a new table from a donated one,
    this updates the table's tensors in place and returns the same table.
    """
    lanes, allt = extract_chunk_keys(reads, k, canonical)
    n = lanes.shape[1]
    off = table.raw_off
    if off + n > table.raw_lanes.shape[1]:
        raise ValueError(
            f"raw append of {n} slots at {off} overflows the raw region "
            f"({table.raw_lanes.shape[1]} slots): consolidate first"
        )
    table.raw_lanes[:, off : off + n] = lanes
    table.raw_off = off + n
    table.allt += allt
    return table


def chunk_slots(n_reads: int, line_length: int, k: int) -> int:
    """Worst-case k-mer slots for a chunk."""
    return n_reads * max(line_length - k + 1, 0)
