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
    beyond the table and the reads.  That was the plain torch chain; the
    chunk step now runs the fused extraction kernel (ops.fused_extract),
    which allocates nothing in the two-level step and only its
    ``[NL+1, n]`` output in the one-level one.  The per-window cost is
    kept as measured, a conservative bound, so the caps (and the spill
    decisions tests/test_torch_spill.py pins) stay where they were.

``scripts/consolidate_peaks.py --spill [--k K]`` (or ``--workload CELL``)
prints each step's measured peak beside the one reckoned here;
tests/test_torch_spill.py holds the model to those measurements.  At NL=4
the raw sort's LSD passes took 72.2-72.5 bytes a raw row beyond the sorted
copy at every size measured, 12.5M to 58.3M rows (torch 2.11), against the
73 reckoned: the model reads 1.4% above the 2e9 spill count at k=55 and
0.7% above gpubench's k55f_two count (k=55 forward, 8e9), whose second
consolidation sorts 48,234,496 raw rows (a file's short last chunk fills
a whole chunk's rows, the rest masked windows).  Keys of five lanes or more
(k >= 65) have not been measured.

The JAX engine spills only once the table has grown past four times its
planned size, after the growth; that passes the budget on the card (a
consolidation holds about 29 bytes of peak a table slot at NL=2).  Here
the decision comes first: every step's peak grows with the prefix's (or
the table's) slots, so the model gives, once a run is planned, the most
slots each table may take (``max_prefix_slots``, ``max_table_slots``); a
consolidation whose grown prefix (or table) would pass that cap spills the
table's live rows to a sorted run instead.  Without a ``tempFileLocation``
the two-level plan alone keeps the budget: the prefix grows only as far as
the consolidation at hand fits (``consolidation_prefix_slots``), and after
each consolidation the raw region gives up the slots the next one would
need for the prefix (``raw_slots_within``), down to a chunk's windows.
"""

from __future__ import annotations

from dataclasses import dataclass

# Added to every step: the CUDA caching allocator counts a tensor's block
# rounded up (by less than 2 MiB when a large block is not split), and
# 16 MiB covers that in every step measured.  Under a budget that 16 MiB
# alone would pass (the tiny cells' 8e6 bytes) a step adds 1/_SLACK_SHARE
# of the bytes it holds instead: such a step holds no block of more than a
# few MiB, and the tiny cells' counts on an H100 peaked within the plans
# this gives.
_ALLOCATOR_SLACK = 16 << 20
_SLACK_SHARE = 64


def _with_slack(bytes_: int, limit: int | None) -> int:
    """A step's peak under a budget of ``limit`` bytes (None: one that the
    fixed slack fits): the bytes its tensors hold and the allocator's
    rounding of their blocks."""
    if limit is not None and limit <= _ALLOCATOR_SLACK:
        return bytes_ + min(_ALLOCATOR_SLACK, bytes_ // _SLACK_SHARE)
    return bytes_ + _ALLOCATOR_SLACK


# Bytes a live raw row costs the raw sort (see above): one int64 sort
# digit at NL <= 2, and for wider keys an LSD pass per digit that holds
# every digit, the permutation, the gathered digit and torch.sort's 40
# bytes a row (two digits measured at NL=4: 72.2-72.5).
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
                    route_rows: int | None = None, limit: int | None = None) -> dict[str, int]:
    """Peak bytes of each step of a consolidation of ``raw_rows`` raw rows
    into a prefix of ``cp`` slots (grown from ``grow_from`` slots), then
    of the chunk steps that follow, and (``finalize_rows``) of the
    finalize's sort of that many live rows, with the raw region freed;
    (``route_rows``) of a mesh position's route of that many received
    rows beside its prefix.  Keys are the table stages' names; ``limit``
    is the budget (_with_slack)."""
    prefix, raw = 4 * (NL + 1) * cp, 4 * NL * cr
    # the chunk feed's one device buffer (feed.py) holds a chunk's reads
    held = prefix + raw + chunk.read_bytes
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
        peaks["finalize2"] = prefix + chunk.read_bytes + sort_reduce_bytes_per_row(NL) * min(finalize_rows, cp)
    if route_rows is not None:
        peaks["route_merge_local"] = prefix + chunk.read_bytes + route_bytes_per_row(NL) * route_rows
    return {step: _with_slack(bytes_, limit) for step, bytes_ in peaks.items()}


def one_level_peaks(NL: int, capacity: int, chunk: Chunk, grow_from: int | None = None,
                    route_rows: int | None = None, limit: int | None = None) -> dict[str, int]:
    """Peak bytes of each step of the one-level table at ``capacity``
    slots (grown from ``grow_from``): the chunk's extraction and append,
    a consolidation (``sort_reduce`` over every slot), and (``route_rows``)
    a mesh position's route of that many received rows; ``limit`` as in
    two_level_peaks."""
    table = 4 * (NL + 1) * capacity
    # the chunk feed's one device buffer (feed.py) holds a chunk's reads
    held = table + chunk.read_bytes
    peaks = {
        "extract_chunk": held + (chunk_step_bytes_per_window(NL) + 4 * (NL + 1)) * chunk.windows,
        "consolidate": held + sort_reduce_bytes_per_row(NL) * capacity,
    }
    if grow_from is not None and grow_from < capacity:
        peaks["grow"] = held + 4 * (NL + 1) * grow_from
    if route_rows is not None:
        peaks["route_merge_local"] = held + route_bytes_per_row(NL) * route_rows
    return {step: _with_slack(bytes_, limit) for step, bytes_ in peaks.items()}


def _most_slots(limit: int, peaks_at, most: int | None = None) -> int:
    """The most slots n (up to ``most``) at which every step of
    ``peaks_at(n)`` stays within ``limit``, or 0: every step's peak grows
    with n (by at least a byte a slot), so a bisection finds it."""
    lo, hi = 0, limit + 1 if most is None else most
    if max(peaks_at(hi).values()) <= limit:
        return hi
    while hi - lo > 1:  # peaks_at(lo) within the limit, or lo == 0; peaks_at(hi) past it
        mid = (lo + hi) // 2
        if max(peaks_at(mid).values()) <= limit:
            lo = mid
        else:
            hi = mid
    return lo


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
        NL, cp, cr, cr, chunk, finalize_rows=cp, route_rows=cp if routed else None, limit=opts.memory_limit_bytes))


def max_table_slots(opts, NL: int, chunk: Chunk, routed: bool = False) -> int:
    """The most slots the one-level table may grow to in a run with a
    ``tempFileLocation``: twice ``tableSlots`` when set, as in the JAX
    engine, else every step within ``gpuMemoryLimit`` (the growth copy
    holds less than the consolidation's sort; ``routed`` as in
    max_prefix_slots)."""
    if opts.table_slots:
        return 2 * opts.table_slots
    return _most_slots(opts.memory_limit_bytes, lambda capacity: one_level_peaks(
        NL, capacity, chunk, route_rows=capacity if routed else None, limit=opts.memory_limit_bytes))


def _raw_room(limit: int, NL: int, cp: int, cr: int, live: int, chunk: Chunk) -> int:
    """The most raw slots r, up to ``cr``, at which a consolidation of r raw
    rows, all new, beside ``live`` rows in a prefix of ``cp`` slots (grown
    to ``live + r`` where that is more) keeps every step within ``limit``:
    the chunk steps, the growth, the raw sort, K1 and a finalize of those
    rows."""
    return _most_slots(limit, lambda r: two_level_peaks(
        NL, max(cp, live + r), r, r, chunk, grow_from=cp, finalize_rows=live + r, limit=limit), most=cr)


def consolidation_prefix_slots(limit: int, NL: int, cp: int, cr: int, live: int, raw: int, chunk: Chunk) -> int:
    """The most slots the prefix may grow to (from ``cp``) for a
    consolidation of ``raw`` raw rows beside ``live`` live rows in a run
    without a ``tempFileLocation``: the consolidation's steps, the chunk
    steps after it and a finalize of its rows all within ``limit``.
    raw_slots_within has kept it at ``live + raw`` or more; a prefix grown
    past what the next consolidation leaves room for costs the raw region
    the difference after this one."""
    return _most_slots(limit, lambda n: two_level_peaks(
        NL, n, cr, raw, chunk, grow_from=cp, finalize_rows=min(live + raw, n), limit=limit))


def raw_slots_within(limit: int, NL: int, cp: int, cr: int, live: int, chunk: Chunk) -> int:
    """The raw region (at most ``cr`` slots) of a two-level table with
    ``live`` rows in a prefix of ``cp`` slots, in a run without a
    ``tempFileLocation``: the most slots at which the next consolidation
    keeps ``limit`` in the worst case (_raw_room).  Where the live rows
    leave no room for a chunk's windows (``chunk.windows``) the count
    cannot go on within the limit: RuntimeError, raised before anything is
    allocated."""
    r = _raw_room(limit, NL, cp, cr, live, chunk)
    if r < chunk.windows:
        raise RuntimeError(
            f"gpuMemoryLimit={limit} leaves room for {r} raw slots beside {live} distinct k-mers in a "
            f"prefix of {cp} slots, fewer than a chunk's {chunk.windows} windows: raise gpuMemoryLimit, "
            f"or set tempFileLocation so that the table spills to disk")
    return r


def next_prefix(cap: int | None, cp: int, live: int, raw: int, most: int | None = None) -> tuple[int, bool]:
    """(prefix slots for the next two-level consolidation, whether the
    prefix's ``live`` rows spill to disk first).

    ``live + raw`` bounds the distinct keys a consolidation can produce, so
    a prefix of that many slots can never truncate.  It grows
    geometrically, so a cardinality-growing run sees O(log) reallocations;
    with a ``cap`` (max_prefix_slots; spilling on) no further than it, and
    where ``live + raw`` passes it the live rows spill and the emptied
    prefix takes the raw rows alone.  Without a cap, no further than
    ``most`` (consolidation_prefix_slots), and never below ``live + raw``."""
    need = live + raw
    if need <= cp:
        return cp, False
    grown = max(need, 2 * cp)
    if cap is None:
        return (grown if most is None else max(need, min(grown, most))), False
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
