"""One-level count table — counterpart of kmer_counter_tpu.ops.table.

A device-resident append buffer of (key lanes, count) records: each chunk's
raw records (ops.pipeline.extract_chunk) are written at the running offset,
and when the buffer would overflow, ``consolidate`` collapses duplicates
with one ``sort_reduce`` over the whole buffer — a sort through the
multi-lane sort kernel (ops.lane_sort) — and re-compacts to the front.

Invariant (as in the JAX package): rows at or past ``offset`` have count
0.  The host mirrors ``offset`` exactly, so appends never read the device;
a consolidation reads back the unique count.  Unlike the JAX version,
which returns new arrays from donated ones, ``append`` writes in place.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from kmer_counter_tpu_torch.ops.sortcount import sort_reduce


@dataclass
class CountTable:
    """Device state of the one-level table (int32 = uint32 bits)."""

    lanes: torch.Tensor  # [NL, C]
    counts: torch.Tensor  # [C], 0 = empty slot
    offset: int  # slots in use (host-mirrored)


def make_table(capacity: int, num_lanes: int, device: torch.device) -> CountTable:
    return CountTable(
        lanes=torch.zeros((num_lanes, capacity), dtype=torch.int32, device=device),
        counts=torch.zeros(capacity, dtype=torch.int32, device=device),
        offset=0,
    )


def append(table: CountTable, chunk_lanes: torch.Tensor, chunk_counts: torch.Tensor) -> CountTable:
    """Write a chunk's records at ``offset`` in place and advance it by the
    chunk's width; raises if they do not fit (consolidate or grow first)."""
    n = chunk_lanes.shape[1]
    off = table.offset
    if off + n > table.lanes.shape[1]:
        raise ValueError(
            f"append of {n} slots at {off} overflows the table "
            f"({table.lanes.shape[1]} slots): consolidate first"
        )
    table.lanes[:, off : off + n] = chunk_lanes
    table.counts[off : off + n] = chunk_counts
    table.offset = off + n
    return table


def consolidate(table: CountTable) -> CountTable:
    """Collapse duplicates across everything appended so far; the new
    offset is the number of distinct keys."""
    lanes, counts, num_unique = sort_reduce(table.lanes, table.counts)
    return CountTable(lanes, counts, num_unique)


def grow(table: CountTable, capacity: int) -> CountTable:
    """Copy into a larger buffer; the new slots are empty (count 0)."""
    NL, C = table.lanes.shape
    if capacity < C:
        raise ValueError("grow() cannot shrink the table")
    lanes = torch.zeros((NL, capacity), dtype=torch.int32, device=table.lanes.device)
    lanes[:, :C] = table.lanes
    counts = torch.zeros(capacity, dtype=torch.int32, device=table.counts.device)
    counts[:C] = table.counts
    return CountTable(lanes, counts, table.offset)
