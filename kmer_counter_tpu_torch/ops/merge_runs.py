"""Merges of two sorted runs (K3, K4, K5) — counterparts of
kmer_counter_tpu.ops.pallas_sort.merge_sorted_runs_fold_bitonic,
merge_sorted_runs_fold and merge_sorted_runs.

Each wrapper launches its variant of the hand-written CUDA kernels in
``csrc/merge_fold_compact.cu`` (ops.merge_fold_compact.launch: K3 and K4
the one-pass kernel they share with K1, B stored descending for K3 and
ascending for K4; K5 the split and write passes, since its sentinel rows
carry payloads and cannot be skipped), which replace the Pallas kernels
``pallas_sort._merge_pair_fold_bitonic_call``, ``_merge_pair_fold_call``
and ``_merge_pair_call``, for CUDA tensors, and runs its plain torch
version only for tensors on the CPU.  There is no fallback: on any other
device, or when the kernel cannot be built or launched, it raises.

Contract (both versions): A and B are each NL key lanes + one value lane,
1-D contiguous int32 tensors holding uint32 bits; A is sorted ascending,
B ascending or (the ``_bitonic`` variant) DESCENDING.  The result is
``[NL+1, na+nb] int32``, the rows of both merged ascending:

* ``merge_sorted_runs_fold_bitonic`` / ``merge_sorted_runs_fold``: the
  value lane is a count; every run of equal keys carries its total count
  mod 2^32 on its LAST row and 0 on every other row; runs whose key is the
  all-ones sentinel carry 0.  Deterministic, so the kernel and the plain
  version agree bit for bit.
* ``merge_sorted_runs``: the value lane rides along as a payload.  The
  kernel puts A's rows before B's on equal keys, as the plain version's
  stable sort does; the JAX kernel's order among equal keys differs, so
  only each key's payload multiset is held against it.
"""

from __future__ import annotations

from typing import Sequence

import torch

from kmer_counter_tpu_torch.ops import merge_fold_compact as mfc
from kmer_counter_tpu_torch.ops.sortcount import lex_argsort, run_heads, run_totals
from kmer_counter_tpu_torch.ops.u32 import SENTINEL, narrow, widen

# Kernel launches per wrapper (one per call on a non-empty CUDA tensor; the
# plain versions do not count).
launches = {"merge_sorted_runs_fold_bitonic": 0, "merge_sorted_runs_fold": 0, "merge_sorted_runs": 0}


def _run(name: str, variant: int, reference, a_ops, b_ops, num_keys: int) -> torch.Tensor:
    mfc.check_operands(a_ops, b_ops, num_keys)
    device = a_ops[0].device
    if device.type == "cpu":
        return reference(a_ops, b_ops, num_keys)
    if device.type != "cuda":
        raise RuntimeError(f"{name} has no kernel for device {device}")
    out, _ = mfc.launch(variant, a_ops, b_ops, num_keys)
    if out.shape[1]:
        launches[name] += 1
    return out


def merge_sorted_runs_fold_bitonic(
    a_ops: Sequence[torch.Tensor], b_desc_ops: Sequence[torch.Tensor], num_keys: int
) -> torch.Tensor:
    """K3: A ascending ⊕ B descending, each run's total on its last row."""
    return _run("merge_sorted_runs_fold_bitonic", mfc.K3, merge_sorted_runs_fold_bitonic_reference,
                a_ops, b_desc_ops, num_keys)


def merge_sorted_runs_fold(
    a_ops: Sequence[torch.Tensor], b_ops: Sequence[torch.Tensor], num_keys: int
) -> torch.Tensor:
    """K4: A ascending ⊕ B ascending, each run's total on its last row."""
    return _run("merge_sorted_runs_fold", mfc.K4, merge_sorted_runs_fold_reference,
                a_ops, b_ops, num_keys)


def merge_sorted_runs(
    a_ops: Sequence[torch.Tensor], b_ops: Sequence[torch.Tensor], num_keys: int
) -> torch.Tensor:
    """K5: A ascending ⊕ B ascending, the payload riding along."""
    return _run("merge_sorted_runs", mfc.K5, merge_sorted_runs_reference, a_ops, b_ops, num_keys)


# ---- plain versions ----------------------------------------------------------


def merge_sorted_runs_reference(a_ops, b_ops, num_keys: int) -> torch.Tensor:
    """Plain K5: a stable lexicographic sort of A's rows, then B's."""
    rows = torch.cat([torch.stack(list(a_ops)), torch.stack(list(b_ops))], 1)
    return rows[:, lex_argsort(rows[:num_keys])]


def fold_on_last_rows(merged: torch.Tensor, num_keys: int) -> torch.Tensor:
    """Sorted rows ``[NL+1, n]`` → the same keys with each run's total
    count (mod 2^32) on its last row, 0 elsewhere and on sentinel runs."""
    keys, counts = merged[:num_keys], merged[num_keys]
    folded = torch.zeros_like(counts)
    if counts.shape[0]:
        head_idx = torch.nonzero(run_heads(keys)).squeeze(1)
        totals = run_totals(widen(counts), head_idx)
        end_idx = torch.cat([head_idx[1:] - 1, head_idx.new_tensor([counts.shape[0] - 1])])
        alive = ~(keys[:, end_idx] == SENTINEL).all(dim=0)
        folded[end_idx[alive]] = narrow(totals[alive])
    return torch.cat([keys, folded[None]])


def merge_sorted_runs_fold_reference(a_ops, b_ops, num_keys: int) -> torch.Tensor:
    """Plain K4: the plain merge, then the fold onto run-end rows."""
    return fold_on_last_rows(merge_sorted_runs_reference(a_ops, b_ops, num_keys), num_keys)


def merge_sorted_runs_fold_bitonic_reference(a_ops, b_desc_ops, num_keys: int) -> torch.Tensor:
    """Plain K3: plain K4 of A and B read ascending."""
    return merge_sorted_runs_fold_reference(a_ops, [v.flip(0) for v in b_desc_ops], num_keys)
