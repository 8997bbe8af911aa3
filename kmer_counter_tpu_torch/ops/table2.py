"""Two-level count table — counterpart of kmer_counter_tpu.ops.table2.

A deduplicated, sorted prefix (key lanes + counts) plus a keys-only raw
region that chunk steps append to.  Consolidation sorts the live raw rows
and merges them into the prefix, folding duplicate keys and compacting.

``consolidate3`` takes the JAX function's keywords with its meanings and
runs each variant through the counterparts of its kernels: the default
(bitonic + fused compact) through the merge-fold-compact kernel K1
(ops.merge_fold_compact); the split variants through a merge kernel
(K3, K4 or K5, ops.merge_runs) and the compaction kernel K2
(ops.compact_live).  All four give the same result.  The sorts and the
fold between the kernels are plain torch, as they were XLA (not Pallas)
in the JAX package.  Not ported: consolidate2, the monolithic programs
(``KMER_TPU_MONO_CONSOLIDATE``; eager PyTorch has no single program), the
``KMER_TPU_*`` switches and the VMEM tile choices.

Empty prefix slots hold the sentinel key with count 0 — at creation, after
a consolidation and after ``grow2`` — so the prefix stays ascending, which
the kernel requires.  (The JAX grow2 pads with zero keys instead.)

All-T special case (k % 16 == 0, forward): the all-T k-mer equals the
sentinel, so it is counted in the side scalar ``allt``, which
``finalize_host`` returns beside the table for the caller to write as the
last (maximum) record.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from kmer_counter_tpu_torch.metrics import span
from kmer_counter_tpu_torch.ops.compact_live import compact_live
from kmer_counter_tpu_torch.ops.merge_fold_compact import merge_fold_compact
from kmer_counter_tpu_torch.ops.merge_runs import (
    merge_sorted_runs,
    merge_sorted_runs_fold,
    merge_sorted_runs_fold_bitonic,
)
from kmer_counter_tpu_torch.ops.sortcount import lex_argsort, lex_digits, run_heads, run_totals, sort_reduce
from kmer_counter_tpu_torch.ops.u32 import MASK, SENTINEL, counts_to_host, from_numpy, narrow, to_numpy, widen


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


def _sort_raw_ones(raw_lanes: torch.Tensor, raw_off: int):
    """The raw region sorted ascending with 0/1 liveness for a folding
    merge (counterpart of ``_c3_sort_raw_ones``): the first ``raw_off``
    rows sorted, sentinel keys after them; liveness is 0 on sentinel rows
    (masked windows included) and 1 elsewhere."""
    live = raw_lanes[:, :raw_off]
    s = torch.full_like(raw_lanes, SENTINEL)
    s[:, :raw_off] = live[:, lex_argsort(live)]
    return s, (~(s == SENTINEL).all(dim=0)).to(torch.int32)


def _sort_raw(raw_lanes: torch.Tensor, raw_off: int):
    """The raw region sorted ascending with its multiplicities on run heads
    (counterpart of ``_c3_sort_raw`` + ``_raw_counts_in_place``): a head
    row carries its run's length, every other row 0, sentinel rows 0."""
    s, _ = _sort_raw_ones(raw_lanes, raw_off)
    head_idx = torch.nonzero(run_heads(s)).squeeze(1)
    lengths = torch.diff(head_idx, append=head_idx.new_tensor([s.shape[1]]))
    counts = torch.zeros(s.shape[1], dtype=torch.int32, device=s.device)
    counts[head_idx] = lengths.to(torch.int32)
    counts[(s == SENTINEL).all(dim=0)] = 0
    return s, counts


# Rows that _fold_counts_in_place widens to int64 at once (128 MB a copy),
# and that _count_rows counts at once.
FOLD_PIECE = 1 << 24


def _count_rows(n: int, rows_true) -> int:
    """How many of rows [0, n) ``rows_true(p0, p1)`` (a bool tensor for rows
    [p0, p1)) marks, FOLD_PIECE rows at a time: torch sums a bool tensor by
    widening it to int64 first, 8 bytes a row of the whole table."""
    return sum(int(rows_true(p, min(p + FOLD_PIECE, n)).sum()) for p in range(0, n, FOLD_PIECE))


def _fold_counts_in_place(lanes: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Each run's total count (mod 2^32) on the run's HEAD row, 0 on its
    other rows and on sentinel rows; keys untouched (counterpart of
    ``table2._fold_counts_in_place``; K3/K4 put totals on the LAST row,
    and after the compaction both give the same prefix).

    Unlike the JAX function it writes ``counts`` in place (and returns
    it), so that the merged table is not copied.  The rows are sorted, so
    the sentinel rows are the last ones: they are set to 0, and only the
    rows before them are folded, FOLD_PIECE rows at a time; a run that
    spans pieces gets the sums of its rows in later pieces added to its
    head."""
    S = _count_rows(counts.shape[0], lambda p0, p1: (lanes[:, p0:p1] != SENTINEL).any(dim=0))
    counts[S:] = 0
    head = -1  # the row of the run open at the end of the last piece
    for p0 in range(0, S, FOLD_PIECE):
        p1 = min(p0 + FOLD_PIECE, S)
        lo = max(p0 - 1, 0)  # the row before the piece tells whether p0 starts a run
        heads = torch.nonzero(run_heads(lanes[:, lo:p1])[p0 - lo :]).squeeze(1)
        c = widen(counts[p0:p1])
        csum = torch.cumsum(c, 0)
        counts[p0:p1] = 0
        lead = p1 - p0 if heads.numel() == 0 else int(heads[0])  # rows of the open run
        if lead:
            counts[head] = narrow(widen(counts[head]) + csum[lead - 1])
        if heads.numel():
            counts[p0 + heads] = narrow(run_totals(c, heads))
            head = p0 + int(heads[-1])
    return counts


def _raw_sort(sort, table: TwoLevelTable, metrics):
    """``sort(raw_lanes, raw_off)`` (one of the raw sorts above) inside the
    ``consolidate.raw_sort`` timer, with the rows it sorts and its stable
    sort passes (one a two-lane digit) counted; nothing is synchronised."""
    if metrics is not None:
        metrics.count("raw_sort_rows", table.raw_off)
        metrics.count("raw_sort_passes", lex_digits(table.raw_lanes.shape[0]))
    with span(metrics, "consolidate.raw_sort"):
        return sort(table.raw_lanes, table.raw_off)


def consolidate3(
    table: TwoLevelTable, *, fold_fused: bool = True, bitonic: bool = True, fused_compact: bool = True,
    metrics=None,
) -> tuple[TwoLevelTable, int, int]:
    """Merge the raw region into the prefix.

    Returns (table', live, lost): live = prefix rows in use afterwards;
    lost = live records that did not fit the prefix (must be 0: the
    caller grows the prefix first).  The compacting kernel (K1 or K2)
    writes only the CP columns of the new prefix, and counts every live
    record; the raw buffer is reused.

    The keywords select the JAX function's variants, with its meanings:
    ``bitonic`` merges a descending raw sort and implies the fold; with
    ``fused_compact`` the merge also compacts (K1), without it the merge
    (K3) leaves the compaction to K2.  ``bitonic=False`` merges an
    ascending raw sort, with the fold in the merge kernel (K4) when
    ``fold_fused``, else with multiplicities from the sort, a plain merge
    (K5) and the fold in torch; then K2.  Every variant returns the same.

    ``metrics``: the raw sort, whichever the variant, is timed there
    (``consolidate.raw_sort``) and counted (``raw_sort_rows``,
    ``raw_sort_passes``).
    """
    NL, CP = table.prefix_lanes.shape
    a_ops = [*table.prefix_lanes.unbind(0), table.prefix_counts]
    if bitonic and fused_compact:
        s_desc, ones = _raw_sort(_sort_raw_desc, table, metrics)
        out, live_count = merge_fold_compact(a_ops, [*s_desc.unbind(0), ones], NL, out_rows=CP)
        del s_desc, ones
    else:
        if bitonic:
            s_desc, ones = _raw_sort(_sort_raw_desc, table, metrics)
            merged = merge_sorted_runs_fold_bitonic(a_ops, [*s_desc.unbind(0), ones], NL)
            del s_desc, ones
        else:
            s, counts = _raw_sort(_sort_raw_ones if fold_fused else _sort_raw, table, metrics)
            merge = merge_sorted_runs_fold if fold_fused else merge_sorted_runs
            merged = merge(a_ops, [*s.unbind(0), counts], NL)
            del s, counts
            if not fold_fused:
                _fold_counts_in_place(merged[:NL], merged[NL])
        folded = merged[NL]
        live_count = _count_rows(folded.shape[0], lambda p0, p1: folded[p0:p1] != 0)
        out = compact_live(list(merged.unbind(0)), folded, NL, out_rows=CP)
        del merged, folded
    live_count = int(live_count)
    out_table = TwoLevelTable(
        prefix_lanes=out[:NL],
        prefix_counts=out[NL],
        raw_lanes=table.raw_lanes,
        raw_off=0,
        allt=table.allt,
    )
    return out_table, min(live_count, CP), max(live_count - CP, 0)


def grow2(table: TwoLevelTable, prefix_slots: int, raw_slots: int) -> TwoLevelTable:
    """Copy into larger buffers; new prefix slots get the sentinel key
    and count 0, so the prefix stays ascending.  A prefix that keeps its
    size, and a raw region that keeps its size, are shared with ``table``,
    not copied.  The prefix never shrinks; the raw region may, to no fewer
    slots than it has in use (the prefix then takes the memory it gave
    up)."""
    NL, CP = table.prefix_lanes.shape
    CR = table.raw_lanes.shape[1]
    if prefix_slots < CP or raw_slots < table.raw_off:
        raise ValueError("grow2() cannot shrink the prefix, or the raw region below its rows in use")
    device = table.prefix_lanes.device
    prefix_lanes, prefix_counts = table.prefix_lanes, table.prefix_counts
    if prefix_slots > CP:
        prefix_lanes = torch.full((NL, prefix_slots), SENTINEL, dtype=torch.int32, device=device)
        prefix_lanes[:, :CP] = table.prefix_lanes
        prefix_counts = torch.zeros(prefix_slots, dtype=torch.int32, device=device)
        prefix_counts[:CP] = table.prefix_counts
    raw_lanes = table.raw_lanes
    if raw_slots != CR:
        # a grown region keeps every row, a shrunk one the rows in use
        keep = CR if raw_slots > CR else table.raw_off
        raw_lanes = torch.zeros((NL, raw_slots), dtype=torch.int32, device=device)
        raw_lanes[:, :keep] = table.raw_lanes[:, :keep]
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


def finalize_host(table: TwoLevelTable, k: int, live: int | None = None,
                  metrics=None) -> tuple[torch.Tensor, np.ndarray, int]:
    """The checked finalize: merges any outstanding raw region (a nonzero
    ``lost`` is a hard error), deduplicates, and checks that the all-T key
    is not among the rows.  ``live``: the exact prefix rows in use, when
    the caller holds it (see finalize2); a merge here supplies its own.
    ``metrics``: the counts' copy back is timed and counted there
    (u32.counts_to_host).  Returns (lanes ``[NL, U] int32``, lane-major on
    the table's device, counts ``[U] uint32`` on the host, the all-T
    count) sorted ascending: the lanes and counts ready for
    io.dump.dump_table, and the all-T record, when its count is not 0, the
    table's last (T^k packs to all-ones in every active lane: the maximum
    key)."""
    if table.raw_off > 0:
        table, live, lost = consolidate3(table, metrics=metrics)
        if lost:
            raise RuntimeError(
                f"two-level consolidation truncated {lost} live records: "
                "prefix region undersized (grow2 before finalize)"
            )
    lanes, counts, n = finalize2(table, live)
    allt = int(table.allt) & MASK
    if allt and n and bool((lanes[:, n - 1] == SENTINEL).all()):
        raise RuntimeError(
            "all-T key present in the key stream despite the side "
            "counter: extract_chunk_keys contract violated"
        )
    return lanes[:, :n], counts_to_host(counts, n, metrics), allt


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
