"""Two-level count table — counterpart of kmer_counter_tpu.ops.table2.

A deduplicated, sorted prefix (key lanes + counts) plus a keys-only raw
region that chunk steps append to.  Consolidation sorts the live raw rows
descending and merges them into the prefix with the merge-fold-compact
kernel (ops.merge_fold_compact), which folds duplicate keys and compacts.

One consolidation path is ported: the JAX package's default (bitonic +
fused compact, table2.py:495-508).  consolidate2, the odd-even, split and
monolithic variants, the ``KMER_TPU_*`` switches and the VMEM tile
choices existed only for Mosaic and the TPU compile path.

Empty prefix slots hold the sentinel key with count 0 — at creation, after
a consolidation and after ``grow2`` — so the prefix stays ascending, which
the kernel requires.  (The JAX grow2 pads with zero keys instead.)

All-T special case (k % 16 == 0, forward): the all-T k-mer equals the
sentinel, so it is counted in the side scalar ``allt`` and re-materialized
by ``finalize_host`` as the last (maximum) record.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from kmer_counter_tpu_torch.ops.merge_fold_compact import merge_fold_compact
from kmer_counter_tpu_torch.ops.sortcount import lex_argsort, sort_reduce
from kmer_counter_tpu_torch.ops.u32 import MASK, SENTINEL, from_numpy, to_numpy


@dataclass
class TwoLevelTable:
    """Device state of the two-level count table (int32 = uint32 bits)."""

    prefix_lanes: torch.Tensor  # [NL, CP], ascending; rows may be views
    prefix_counts: torch.Tensor  # [CP], 0 = empty slot (sentinel key)
    raw_lanes: torch.Tensor  # [NL, CR] keys only; sentinel = masked window
    raw_off: int  # raw slots in use (host-mirrored, exact)
    allt: torch.Tensor  # 0-d int64: all-T side count (mod 2^32 when read)


def make_table2(
    prefix_slots: int, raw_slots: int, num_lanes: int, device: torch.device
) -> TwoLevelTable:
    return TwoLevelTable(
        prefix_lanes=torch.full((num_lanes, prefix_slots), SENTINEL, dtype=torch.int32, device=device),
        prefix_counts=torch.zeros(prefix_slots, dtype=torch.int32, device=device),
        raw_lanes=torch.zeros((num_lanes, raw_slots), dtype=torch.int32, device=device),
        raw_off=0,
        allt=torch.zeros((), dtype=torch.int64, device=device),
    )


def _sort_raw_desc(raw_lanes: torch.Tensor, raw_off: int):
    """The raw region sorted DESCENDING with positional 0/1 liveness
    (counterpart of ``_c3_sort_raw_desc``): the first ``raw_off`` rows are
    live — masked windows included, as sentinel keys that the kernel drops
    — and sort descending; the dead rows after them become all-zero keys
    with liveness 0, which sort last in descending order.  A dead row's
    key equals a genuine A^k key, so liveness never comes from the key."""
    NL, CR = raw_lanes.shape
    live = raw_lanes[:, :raw_off]
    s_desc = torch.zeros_like(raw_lanes)
    s_desc[:, :raw_off] = live[:, lex_argsort(live).flip(0)]
    ones = torch.zeros(CR, dtype=torch.int32, device=raw_lanes.device)
    ones[:raw_off] = 1
    return s_desc, ones


def consolidate3(table: TwoLevelTable) -> tuple[TwoLevelTable, int, int]:
    """Merge the raw region into the prefix.

    Returns (table', live, lost): live = prefix rows in use afterwards;
    lost = live records that did not fit the prefix (must be 0: the
    caller grows the prefix first).  The new prefix is a copy of the
    first CP columns of the kernel's [NL+1, CP+CR] output, so the CR-column
    tail is freed with it; the raw buffer is reused.
    """
    NL, CP = table.prefix_lanes.shape
    s_desc, ones = _sort_raw_desc(table.raw_lanes, table.raw_off)
    out, live_count = merge_fold_compact(
        [*table.prefix_lanes.unbind(0), table.prefix_counts],
        [*s_desc.unbind(0), ones],
        NL,
    )
    del s_desc, ones
    live_count = int(live_count)
    prefix = out[:, :CP].clone()
    del out
    out_table = TwoLevelTable(
        prefix_lanes=prefix[:NL],
        prefix_counts=prefix[NL],
        raw_lanes=table.raw_lanes,
        raw_off=0,
        allt=table.allt,
    )
    return out_table, min(live_count, CP), max(live_count - CP, 0)


def grow2(table: TwoLevelTable, prefix_slots: int, raw_slots: int) -> TwoLevelTable:
    """Copy into larger buffers; new prefix slots get the sentinel key
    and count 0, so the prefix stays ascending.  A raw region that keeps
    its size is shared with ``table``, not copied."""
    NL, CP = table.prefix_lanes.shape
    CR = table.raw_lanes.shape[1]
    if prefix_slots < CP or raw_slots < CR:
        raise ValueError("grow2() cannot shrink the table")
    device = table.prefix_lanes.device
    prefix_lanes = torch.full((NL, prefix_slots), SENTINEL, dtype=torch.int32, device=device)
    prefix_lanes[:, :CP] = table.prefix_lanes
    prefix_counts = torch.zeros(prefix_slots, dtype=torch.int32, device=device)
    prefix_counts[:CP] = table.prefix_counts
    raw_lanes = table.raw_lanes
    if raw_slots > CR:
        raw_lanes = torch.zeros((NL, raw_slots), dtype=torch.int32, device=device)
        raw_lanes[:, :CR] = table.raw_lanes
    return TwoLevelTable(prefix_lanes, prefix_counts, raw_lanes, table.raw_off, table.allt)


def finalize2(table: TwoLevelTable, live: int | None = None):
    """(lanes, counts, num_unique) of the prefix per the sort_reduce
    contract; the raw region must already be merged.

    ``live`` is the exact count of prefix rows in use after a
    consolidation (consolidate3 packs them, unique and ascending, to the
    front): only those rows are sorted.  None sorts the whole prefix, as
    for a table carried from the JAX package (table_from_numpy), whose
    prefix may hold two rows of one key.
    """
    if live is None:
        return sort_reduce(table.prefix_lanes, table.prefix_counts)
    return sort_reduce(table.prefix_lanes[:, :live], table.prefix_counts[:live])


def finalize_host(table: TwoLevelTable, k: int, live: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """The checked host-side finalize: merges any outstanding raw region
    (a nonzero ``lost`` is a hard error), deduplicates, and re-materializes
    the all-T record.  ``live``: the exact prefix rows in use, when the
    caller holds it (see finalize2); a merge here supplies its own.
    Returns (lanes ``[U, NL] uint32``, counts ``[U] uint32``) sorted
    ascending, ready for io.dump.dump_table."""
    if table.raw_off > 0:
        table, live, lost = consolidate3(table)
        if lost:
            raise RuntimeError(
                f"two-level consolidation truncated {lost} live records: "
                "prefix region undersized (grow2 before finalize)"
            )
    lanes, counts, n = finalize2(table, live)
    NL = table.prefix_lanes.shape[0]
    out_lanes = to_numpy(lanes[:, :n]).T if n else np.zeros((0, NL), np.uint32)
    out_counts = to_numpy(counts[:n])
    allt = int(table.allt) & MASK
    if allt:
        # T^k packs to all-ones in every active lane: the maximum key, so
        # appending keeps the table sorted.
        tk = np.full((1, NL), 0xFFFFFFFF, np.uint32)
        if out_lanes.shape[0] and np.array_equal(out_lanes[-1], tk[0]):
            raise RuntimeError(
                "all-T key present in the key stream despite the side "
                "counter: extract_chunk_keys contract violated"
            )
        out_lanes = np.concatenate([out_lanes, tk], axis=0)
        out_counts = np.concatenate([out_counts, np.asarray([allt], np.uint32)])
    return np.ascontiguousarray(out_lanes), out_counts


def table_from_numpy(
    prefix_lanes: np.ndarray,
    prefix_counts: np.ndarray,
    raw_lanes: np.ndarray,
    raw_off: int,
    allt: int,
    device: torch.device,
) -> TwoLevelTable:
    """A table from uint32 numpy arrays (e.g. a JAX TwoLevelTable's
    fields taken with np.asarray)."""
    return TwoLevelTable(
        prefix_lanes=from_numpy(prefix_lanes, device),
        prefix_counts=from_numpy(prefix_counts, device),
        raw_lanes=from_numpy(raw_lanes, device),
        raw_off=int(raw_off),
        allt=torch.tensor(int(allt), dtype=torch.int64, device=device),
    )


def table_to_numpy(table: TwoLevelTable):
    """(prefix_lanes, prefix_counts, raw_lanes) as numpy uint32, raw_off,
    and allt as a uint32 value — the arguments of table_from_numpy."""
    return (
        to_numpy(table.prefix_lanes),
        to_numpy(table.prefix_counts),
        to_numpy(table.raw_lanes),
        table.raw_off,
        int(table.allt) & MASK,
    )
