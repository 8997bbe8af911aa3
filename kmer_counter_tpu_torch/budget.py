"""Peak device memory of the single-device table paths, and the spill
decision that keeps a run with a ``tempFileLocation`` under its budget.

Each step's peak is reckoned from the tensors it holds at once.  Two
per-row costs live inside torch and were measured instead, by
``scripts/consolidate_peaks.py`` on an NVIDIA H100 80GB HBM3 (700 W) in the
2M-read k=31 canonical count (NL=2, a prefix of 166,666,500 slots, a raw
region of 97,222,223 slots, 83,333,250 live raw rows, 396,825 reads x
100 bp a chunk):

  * the raw sort (``table2._sort_raw_desc``: the int64 sort key,
    ``torch.sort``'s values, indices and scratch, the permutation's flip
    and the gather) peaked at 7,616,856,576 bytes: 48.3 bytes a live raw
    row beyond the table, the sorted copy and the chunk's reads;
  * the chunk step (``count_step_two_level``: int64 bases, the pack tree,
    the key lanes) peaked at 4,826,825,216 bytes: 72.3 bytes a window
    beyond the table and the reads.

``scripts/consolidate_peaks.py --spill [--k K]`` prints each step's
measured peak beside the one reckoned here; tests/test_torch_spill.py
holds the model to those measurements.  At k=55 (NL=4, the 2e9 spill
count) the raw sort took about 71 bytes a live raw row against the 73
reckoned, and every other step stayed under the model too; keys of five
lanes or more (k >= 65) have not been measured.

The JAX engine spills only once the table has grown past four times its
planned size, after the growth; that passes the budget on the card (a
consolidation holds about 29 bytes of peak a table slot at NL=2).  Here
the decision comes first: every step's peak is affine in the prefix's (or
the table's) slots, so the model gives, once a run is planned, the most
slots each table may take (``max_prefix_slots``, ``max_table_slots``); a
consolidation whose grown prefix (or table) would pass that cap spills the
table's live rows to a sorted run instead.
"""

from __future__ import annotations

from dataclasses import dataclass

# Added to every step: the CUDA caching allocator counts a large tensor's
# block rounded up (by less than 2 MiB when the block is not split).
_ALLOCATOR_SLACK = 16 << 20
# Bytes a live raw row costs the raw sort (see above): one int64 sort
# digit at NL <= 2, and for wider keys an LSD pass per digit that holds
# every digit, the permutation, the gathered digit and torch.sort's 40
# bytes a row (reckoned; two digits measured at NL=4).
_RAW_SORT_ONE_DIGIT = 49


def raw_sort_bytes_per_row(NL: int) -> int:
    digits = -(-NL // 2)
    return _RAW_SORT_ONE_DIGIT if digits == 1 else 8 * digits + 57


def chunk_step_bytes_per_window(NL: int) -> int:
    """Temporaries of the chunk step a window (72.3 measured at NL=2,
    canonical; the int64 lanes grow with NL)."""
    return 32 + 24 * NL


def sort_reduce_bytes_per_row(NL: int) -> int:
    """``sortcount.sort_reduce`` over n rows: the sort holds the masked
    keys (and their mask) and its two (NL+1)-row buffers; the reduce holds
    the sorted rows and at most four int64 vectors of the rows or the
    runs."""
    return max(12 * NL + 9, 4 * NL + 37)


@dataclass
class Chunk:
    """What a chunk puts on the card: its reads (bytes) and windows."""

    read_bytes: int
    windows: int


def route_bytes_per_row(NL: int) -> int:
    """A round of the mesh's route (parallel.shuffle.route_merge_local) for
    one position: the rows it receives, copied into one buffer, then
    ``sort_reduce`` over them."""
    return 4 * (NL + 1) + sort_reduce_bytes_per_row(NL)


def two_level_peaks(NL: int, cp: int, cr: int, raw_rows: int, chunk: Chunk,
                    grow_from: int | None = None, finalize_rows: int | None = None,
                    route_rows: int | None = None) -> dict[str, int]:
    """Peak bytes of each step of a consolidation of ``raw_rows`` raw rows
    into a prefix of ``cp`` slots (grown from ``grow_from`` slots), then
    of the chunk steps that follow, and (``finalize_rows``) of the
    finalize's sort of that many live rows, with the raw region freed;
    (``route_rows``) of a mesh position's route of that many received
    rows beside its prefix.  Keys are the table stages' names."""
    prefix, raw = 4 * (NL + 1) * cp, 4 * NL * cr
    held = prefix + raw + chunk.read_bytes + _ALLOCATOR_SLACK  # the last chunk's reads stay on the card
    peaks = {
        "count_step_two_level": held + chunk_step_bytes_per_window(NL) * chunk.windows,
        "_sort_raw_desc": held + 4 * NL * cr + raw_sort_bytes_per_row(NL) * raw_rows,
        # K1: the old prefix, its CP-column output, the sorted raw rows and
        # their liveness
        "merge_fold_compact": held + prefix + 4 * (NL + 1) * cr,
    }
    if grow_from is not None and grow_from < cp:
        peaks["grow2"] = held + 4 * (NL + 1) * grow_from
    if finalize_rows is not None:
        peaks["finalize2"] = (prefix + chunk.read_bytes + _ALLOCATOR_SLACK
                              + sort_reduce_bytes_per_row(NL) * min(finalize_rows, cp))
    if route_rows is not None:
        peaks["route_merge_local"] = (prefix + chunk.read_bytes + _ALLOCATOR_SLACK
                                      + route_bytes_per_row(NL) * route_rows)
    return peaks


def one_level_peaks(NL: int, capacity: int, chunk: Chunk, grow_from: int | None = None,
                    route_rows: int | None = None) -> dict[str, int]:
    """Peak bytes of each step of the one-level table at ``capacity``
    slots (grown from ``grow_from``): the chunk's extraction and append,
    a consolidation (``sort_reduce`` over every slot), and (``route_rows``)
    a mesh position's route of that many received rows."""
    table = 4 * (NL + 1) * capacity
    held = table + chunk.read_bytes + _ALLOCATOR_SLACK
    peaks = {
        "extract_chunk": held + (chunk_step_bytes_per_window(NL) + 4 * (NL + 1)) * chunk.windows,
        "consolidate": held + sort_reduce_bytes_per_row(NL) * capacity,
    }
    if grow_from is not None and grow_from < capacity:
        peaks["grow"] = held + 4 * (NL + 1) * grow_from
    if route_rows is not None:
        peaks["route_merge_local"] = held + route_bytes_per_row(NL) * route_rows
    return peaks


def _most_slots(limit: int, peaks_at) -> int:
    """The most slots n at which every step of ``peaks_at(n)`` stays within
    ``limit``: each step's peak is affine in n."""
    at0, at1 = peaks_at(0), peaks_at(1)
    return max(min((limit - at0[step]) // (at1[step] - at0[step]) for step in at0), 0)


def max_prefix_slots(opts, NL: int, cr: int, chunk: Chunk, routed: bool = False) -> int:
    """The most slots the two-level prefix may grow to in a run with a
    ``tempFileLocation``: with ``tableSlots`` set, prefix and raw region
    together twice that (the JAX engine's cap); otherwise every step within
    ``gpuMemoryLimit``, with a full raw region of ``cr`` rows and a
    finalize that sorts the whole prefix (``routed``: a mesh position, whose
    route receives at most as many rows a round as its prefix may hold:
    the engine passes this cap to the route as its row budget, and a range
    that the splitters crowd past it arrives in rounds).  grow2 holds less
    than K1 (``grow_from`` < ``cp``), so it sets no cap."""
    if opts.table_slots:
        return 2 * opts.table_slots - cr
    return _most_slots(opts.memory_limit_bytes, lambda cp: two_level_peaks(
        NL, cp, cr, cr, chunk, finalize_rows=cp, route_rows=cp if routed else None))


def max_table_slots(opts, NL: int, chunk: Chunk, routed: bool = False) -> int:
    """The most slots the one-level table may grow to in a run with a
    ``tempFileLocation``: twice ``tableSlots`` when set, as in the JAX
    engine, else every step within ``gpuMemoryLimit`` (the growth copy
    holds less than the consolidation's sort; ``routed`` as in
    max_prefix_slots)."""
    if opts.table_slots:
        return 2 * opts.table_slots
    return _most_slots(opts.memory_limit_bytes, lambda capacity: one_level_peaks(
        NL, capacity, chunk, route_rows=capacity if routed else None))


def next_prefix(cap: int | None, cp: int, live: int, raw: int) -> tuple[int, bool]:
    """(prefix slots for the next two-level consolidation, whether the
    prefix's ``live`` rows spill to disk first).

    ``live + raw`` bounds the distinct keys a consolidation can produce, so
    a prefix of that many slots can never truncate.  It grows
    geometrically, so a cardinality-growing run sees O(log) reallocations;
    with a ``cap`` (max_prefix_slots; spilling on) no further than it, and
    where ``live + raw`` passes it the live rows spill and the emptied
    prefix takes the raw rows alone."""
    need = live + raw
    if need <= cp:
        return cp, False
    grown = max(need, 2 * cp)
    if cap is None:
        return grown, False
    if need <= cap:
        return min(grown, cap), False
    return max(cp, raw), live > 0


def next_capacity(cap: int | None, capacity: int, needed: int) -> tuple[int, bool]:
    """(one-level table slots for the next chunk, whether the consolidated
    table spills to disk first): the capacity doubles until ``needed``
    slots fit; past a ``cap`` (max_table_slots; spilling on) the table
    spills instead, and the emptied table keeps its size."""
    grown = capacity
    while grown < needed:
        grown *= 2
    if grown == capacity or cap is None or grown <= cap:
        return grown, False
    return capacity, True
