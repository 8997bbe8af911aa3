"""Merge + run fold + compaction (K1) — counterpart of
kmer_counter_tpu.ops.pallas_sort.merge_fold_compact_bitonic.

``merge_fold_compact`` launches the hand-written CUDA kernel in
``csrc/merge_fold_compact.cu`` (which replaces the Pallas kernel
``pallas_sort._merge_pair_fold_compact_bitonic_call``) for CUDA tensors,
and runs ``merge_fold_compact_reference``, its plain torch version, only
for tensors on the CPU.  There is no fallback: on any other device, or
when the kernel cannot be built or launched, it raises.

Contract (both versions): ``a_ops`` is NL key lanes + a count, sorted
ascending (count 0 = empty row); ``b_desc_ops`` is NL key lanes + 0/1
liveness, sorted DESCENDING.  Every operand is a 1-D contiguous int32
tensor holding uint32 bits.  The result is ``(out, live_count)``: ``out``
is ``[NL+1, out_rows] int32`` (key lanes, then counts; ``out_rows`` <=
na+nb, na+nb by default) with one row per distinct non-sentinel key whose
total count mod 2^32 is not 0, ascending and dense at the front, as many
as fit, and sentinel keys with count 0 after them — the JAX function's
output cut to its first ``out_rows`` columns, as
``table2._c3_merge_compact_bitonic`` cuts it to the prefix;
``live_count`` is a 0-d int64 tensor on the operands' device that counts
every such row, also those past ``out_rows``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from kmer_counter_tpu_torch import cuda_build
from kmer_counter_tpu_torch.cuda_build import ptr_array
from kmer_counter_tpu_torch.ops.sortcount import lex_argsort, run_heads, run_totals
from kmer_counter_tpu_torch.ops.u32 import SENTINEL, narrow, widen

MAX_KEYS = 8
# Kernel launches through ``merge_fold_compact`` (one per call on a CUDA
# tensor; the plain version does not count).
launches = 0
_LIB = None  # the typed library, once built and loaded (_lib)


def check_operands(a_ops: Sequence[torch.Tensor], b_ops: Sequence[torch.Tensor], num_keys: int):
    """Raises on operands the merge kernels do not take."""
    if not 1 <= num_keys <= MAX_KEYS:
        raise ValueError(f"num_keys must be in [1, {MAX_KEYS}], got {num_keys}")
    if len(a_ops) != num_keys + 1 or len(b_ops) != num_keys + 1:
        raise ValueError("operands must be num_keys key lanes + one count")
    device = a_ops[0].device
    for side in (a_ops, b_ops):
        n = side[0].shape[0]
        for v in side:
            if v.dtype != torch.int32:
                raise TypeError(f"operands must be int32 (uint32 bits), got {v.dtype}")
            if v.dim() != 1 or v.shape[0] != n:
                raise ValueError("operands of one side must be 1-D and of equal length")
            if v.device != device:
                raise ValueError("all operands must be on one device")
            if not v.is_contiguous():
                raise ValueError("operands must be contiguous")


def _out_rows(a_ops, b_ops, out_rows: int | None) -> int:
    n = a_ops[0].shape[0] + b_ops[0].shape[0]
    out_rows = n if out_rows is None else out_rows
    if not 0 <= out_rows <= n:
        raise ValueError(f"out_rows must be in [0, {n}], got {out_rows}")
    return out_rows


def merge_fold_compact(
    a_ops: Sequence[torch.Tensor], b_desc_ops: Sequence[torch.Tensor], num_keys: int,
    out_rows: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1: the kernel for CUDA tensors, the plain version for CPU tensors."""
    check_operands(a_ops, b_desc_ops, num_keys)
    out_rows = _out_rows(a_ops, b_desc_ops, out_rows)
    device = a_ops[0].device
    if device.type == "cpu":
        return merge_fold_compact_reference(a_ops, b_desc_ops, num_keys, out_rows)
    if device.type != "cuda":
        raise RuntimeError(f"merge_fold_compact has no kernel for device {device}")
    return _launch(a_ops, b_desc_ops, num_keys, out_rows)


def merge_fold_compact_reference(
    a_ops: Sequence[torch.Tensor], b_desc_ops: Sequence[torch.Tensor], num_keys: int,
    out_rows: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch K1: concatenate A and the flipped B, stable
    lexicographic sort, run boundaries, int64 run sums masked to 32 bits,
    boolean-mask compaction."""
    NL = num_keys
    out_rows = _out_rows(a_ops, b_desc_ops, out_rows)
    device = a_ops[0].device
    n = a_ops[0].shape[0] + b_desc_ops[0].shape[0]
    out = torch.full((NL + 1, out_rows), SENTINEL, dtype=torch.int32, device=device)
    out[NL] = 0
    if n == 0:
        return out, torch.zeros((), dtype=torch.int64, device=device)
    keys = torch.cat([torch.stack(list(a_ops[:NL])), torch.stack(list(b_desc_ops[:NL])).flip(1)], 1)
    counts = widen(torch.cat([a_ops[NL], b_desc_ops[NL].flip(0)]))
    perm = lex_argsort(keys)
    s = keys[:, perm]
    head_idx = torch.nonzero(run_heads(s)).squeeze(1)
    totals = run_totals(counts[perm], head_idx)
    run_keys = s[:, head_idx]
    alive = ~(run_keys == SENTINEL).all(dim=0) & (totals != 0)
    live = int(alive.sum())
    kept = min(live, out_rows)
    out[:NL, :kept] = run_keys[:, alive][:, :kept]
    out[NL, :kept] = narrow(totals[alive][:kept])
    return out, torch.tensor(live, dtype=torch.int64, device=device)


# ---- the CUDA kernel -------------------------------------------------------
#
# csrc/merge_fold_compact.cu holds two designs: K1, K3 and K4 run its
# one-pass fold_kernel (K1 then its fill kernel), K5 the split and write
# passes; ``launch`` runs one variant.  K1 is used here, the other three by
# ops.merge_runs.

# The variants (enum Variant in the .cu source): the Pallas functions they
# replace are merge_fold_compact_bitonic (K1), merge_sorted_runs_fold_bitonic
# (K3), merge_sorted_runs_fold (K4) and merge_sorted_runs (K5).
K1, K3, K4, K5 = range(4)
NUM_VARIANTS = 4
# The word of fold_kernel's scratch where K1 leaves its live row count
# (enum Header in the .cu source).
LIVE_TOTAL_WORD = 3


def _lib() -> ctypes.CDLL:
    """The library with its entry points typed: built and loaded at the
    first call, then kept in _LIB (no lock on the launch path)."""
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("merge_fold_compact")
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        lib.mfc_num_variants.argtypes, lib.mfc_num_variants.restype = [], i
        lib.mfc_fold_tile_rows.argtypes, lib.mfc_fold_tile_rows.restype = [i], i
        lib.mfc_fold_scratch_words.argtypes, lib.mfc_fold_scratch_words.restype = [i, ll], ll
        lib.mfc_fold.argtypes = [ptrs, ptrs, ptrs, i, i, ll, ll, ll, vp, vp]
        lib.mfc_fold.restype = i
        lib.mfc_tile_rows.argtypes, lib.mfc_tile_rows.restype = [], i
        lib.mfc_splits.argtypes = [ptrs, ptrs, i, ll, ll, vp, vp]
        lib.mfc_splits.restype = i
        lib.mfc_write.argtypes = [ptrs, ptrs, ptrs, i, ll, ll, vp, vp]
        lib.mfc_write.restype = i
        if lib.mfc_num_variants() != NUM_VARIANTS:
            raise RuntimeError("merge_fold_compact.cu and its wrapper disagree on its layout")
        _LIB = lib
    return _LIB


def tile_rows(num_keys: int) -> int:
    """Merged rows per tile of the K1/K3/K4 kernel at num_keys key lanes
    (builds the kernel if needed)."""
    return _lib().mfc_fold_tile_rows(num_keys)


def _launch(a_ops, b_ops, num_keys, out_rows):
    global launches
    out, live_total = launch(K1, a_ops, b_ops, num_keys, out_rows)
    if a_ops[0].shape[0] + b_ops[0].shape[0]:
        launches += 1
    return out, live_total


def launch(variant: int, a_ops, b_ops, num_keys: int, out_rows: int | None = None):
    """Runs the kernel of ``variant`` on checked CUDA operands: K1, K3 and
    K4 the one-pass kernel (K1 then its fill), on a zeroed scratch of
    status words; K5 the splits, then the write pass.  ``out_rows``: K1's
    output width (na+nb by default; the others write na+nb rows).  Returns
    ``(out [NL+1, out_rows], live_total)``; live_total is a 0-d int64
    tensor for K1, else None."""
    lib = _lib()
    device = a_ops[0].device
    NL = num_keys
    na, nb = a_ops[0].shape[0], b_ops[0].shape[0]
    n = na + nb
    out_rows = n if out_rows is None else out_rows
    out = torch.empty((NL + 1, out_rows), dtype=torch.int32, device=device)
    if n == 0:
        return out, (torch.zeros((), dtype=torch.int64, device=device) if variant == K1 else None)
    stream = cuda_build.current_stream(a_ops[0].get_device())
    a_ptrs, b_ptrs, out_ptrs = ptr_array(a_ops), ptr_array(b_ops), ptr_array(list(out.unbind(0)))
    if variant != K5:
        scratch = torch.zeros(lib.mfc_fold_scratch_words(NL, n), dtype=torch.int64, device=device)
        err = lib.mfc_fold(a_ptrs, b_ptrs, out_ptrs, variant, NL, na, nb, out_rows, scratch.data_ptr(),
                           stream)
        if err:
            raise RuntimeError(f"merge_fold_compact launch failed: cudaError {err}")
        return out, (scratch[LIVE_TOTAL_WORD] if variant == K1 else None)
    tiles = -(-n // lib.mfc_tile_rows())
    splits = torch.empty(tiles + 1, dtype=torch.int64, device=device)
    err = lib.mfc_splits(a_ptrs, b_ptrs, NL, na, nb, splits.data_ptr(), stream)
    if err:
        raise RuntimeError(f"merge_fold_compact splits launch failed: cudaError {err}")
    err = lib.mfc_write(a_ptrs, b_ptrs, out_ptrs, NL, na, nb, splits.data_ptr(), stream)
    if err:
        raise RuntimeError(f"merge_fold_compact write launch failed: cudaError {err}")
    return out, None
