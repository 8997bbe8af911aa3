"""Multi-lane sort + segment reduce — counterpart of
kmer_counter_tpu.ops.sortcount.

``device_sort`` is the hand-written multi-lane sort (ops.lane_sort, K6 +
K7 in CUDA) that ``sort_reduce`` sorts with; ``lex_argsort`` is its
plain version and stays the raw sort of ops.table2 (XLA's ``lax.sort`` on
the TPU, not a Pallas kernel).

Contract of ``sort_reduce`` (as in the JAX package): slots
[0, num_unique) hold distinct keys ascending with their summed counts;
slots past num_unique have count 0 and unspecified keys; counts wrap
mod 2^32.
"""

from __future__ import annotations

import torch

from kmer_counter_tpu_torch.ops.u32 import MASK, SENTINEL, narrow, widen


def _digits(lanes: torch.Tensor) -> list[torch.Tensor]:
    """Lanes ``[NL, N] int32`` → int64 sort digits, most significant
    first.  Two lanes pack into one digit ``((hi ^ 0x80000000) << 32) |
    lo``: flipping hi's sign bit makes signed int64 order equal unsigned
    (hi, lo) order."""
    NL = lanes.shape[0]
    out = []
    for i in range(0, NL, 2):
        if i + 1 < NL:
            hi = (lanes[i] ^ torch.iinfo(torch.int32).min).to(torch.int64)
            out.append((hi << 32) | widen(lanes[i + 1]))
        else:
            out.append(widen(lanes[i]))
    return out


def lex_digits(num_lanes: int) -> int:
    """The int64 digits of ``num_lanes`` lanes: ``lex_argsort``'s stable
    sort passes."""
    return -(-num_lanes // 2)


def lex_argsort(lanes: torch.Tensor) -> torch.Tensor:
    """Stable permutation sorting ``[NL, N] int32`` lanes ascending as
    unsigned lexicographic keys (the counterpart of
    sortcount.device_sort).  One int64 sort for NL <= 2; stable LSD
    passes over two-lane digits beyond."""
    digits = _digits(lanes)
    perm = torch.sort(digits[-1], stable=True).indices
    for d in reversed(digits[:-1]):
        perm = perm[torch.sort(d[perm], stable=True).indices]
    return perm


def run_heads(s_lanes: torch.Tensor) -> torch.Tensor:
    """Bool ``[N]``: the first row of each run of equal keys (sorted)."""
    head = torch.ones(s_lanes.shape[1], dtype=torch.bool, device=s_lanes.device)
    if s_lanes.shape[1] > 1:
        head[1:] = (s_lanes[:, 1:] != s_lanes[:, :-1]).any(dim=0)
    return head


def run_totals(counts64: torch.Tensor, head_idx: torch.Tensor) -> torch.Tensor:
    """Per-run sums (int64, mod 2^32) of sorted counts given run-head
    indices."""
    csum = torch.cumsum(counts64, dim=0)
    end_idx = torch.cat([head_idx[1:] - 1, head_idx.new_tensor([counts64.shape[0] - 1])])
    return (csum[end_idx] - csum[head_idx] + counts64[head_idx]) & MASK


def device_sort(keys: torch.Tensor, payload: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``keys [NL, N]`` sorted ascending with ``payload [N]`` riding along
    (counterpart of sortcount.device_sort): ops.lane_sort.sort_ops."""
    from kmer_counter_tpu_torch.ops.lane_sort import sort_ops

    return sort_ops(keys, payload)


def sort_reduce(
    lanes: torch.Tensor, counts: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Collapse duplicate keys: (unique_lanes ``[NL, N] int32``,
    unique_counts ``[N] int32``, num_unique).  Rows with count 0 are
    ignored (their keys become the sentinel, which sorts last)."""
    if lanes.shape[1] == 0:
        return lanes.clone(), counts.clone(), 0
    eff = torch.where(counts != 0, lanes, SENTINEL)
    s, s_counts = device_sort(eff, counts)
    del eff  # freed before the reduce, which holds its largest temporaries
    return reduce_sorted(s, s_counts)


def reduce_sorted(
    s: torch.Tensor, counts: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """The second half of ``sort_reduce``: sorted keys ``s`` and their
    counts → (unique_lanes, unique_counts, num_unique).

    Works in place: ``s`` and ``counts`` (a sort's fresh outputs) become
    the unique lanes and counts, so the reduce allocates no table-sized
    output beside them; its temporaries are int64 vectors of the rows or
    the runs (the running sum of the counts, the run heads and ends)."""
    head_idx = torch.nonzero(run_heads(s)).squeeze(1)
    U = head_idx.shape[0]
    # Each run's total is the difference of the running sum at its end and
    # at the end of the run before.  The int32 counts are summed as signed
    # values, which agree with their uint32 values mod 2^32.  Each
    # temporary is freed as soon as it is used, so that at most four int64
    # vectors are alive at once.
    csum = torch.cumsum(counts, 0, dtype=torch.int64)
    ends = csum[torch.cat([head_idx[1:] - 1, head_idx.new_tensor([counts.shape[0] - 1])])]
    del csum
    s[:, :U] = s[:, head_idx]
    s[:, U:] = SENTINEL
    del head_idx
    totals = torch.diff(ends, prepend=ends.new_zeros(1))
    del ends
    counts[:U] = narrow(totals)
    counts[U:] = 0
    # Drop the trailing group when it sums to 0 mod 2^32 (the all-sentinel
    # group of empty rows), exactly as the JAX version does.
    num_unique = U - int(U > 0 and (int(totals[-1]) & MASK) == 0)
    return s, counts, num_unique
