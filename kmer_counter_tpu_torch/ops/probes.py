"""The Mosaic probes under docs/ (D1–D7) — counterparts of the Pallas
kernels in docs/probe_compact_overhead.py, docs/experiments_bitonic_merge.py
and docs/experiments_mosaic_caps.py.

Three wrappers, one hand-written CUDA kernel each (``csrc/probes.cu``):

- ``pair_merge(a, b, *, b_descending)`` (D2, D3, D7): G pairs of sorted
  runs, ``a`` ``[G, Ta]`` ascending and ``b`` ``[G, Tb]`` stored descending
  (D2, D3: the probe hands B over reversed) or ascending (D7), merged into
  ``[G, Ta+Tb]`` = sort(A ++ B) in unsigned order.  The runs are not
  checked for order, as no merge of the port checks them.
- ``tile_compact(ops, live, mode)`` (D1): ``ops`` are 1 to 9 lanes of N
  rows and ``live`` one more, N a multiple of ``TILE``; the result is
  ``[len(ops), N]``, one of D1's three kernel bodies applied to each tile
  of ``TILE`` rows on its own: ``"copy"`` the operands; ``"cumsum"`` each
  operand plus the tile's exclusive count of rows with ``live == 0``,
  mod 2^32; ``"network"`` the tile's rows with ``live != 0`` moved to its
  front in order, zeros after them.  D1's fourth variant, ``full``, is K2
  (``ops.compact_live``).
- ``row_gather(x, starts, rows, shift)`` (D4, D5, D6): ``x`` ``[R, W]``
  and ``starts`` a ``[G]`` int32 tensor on x's device; output row j of
  window g is input row ``(starts[g] + shift + j) mod R``, ``[G, rows,
  W]``.  The contract is ``0 <= starts[g]`` and ``starts[g] + rows <= R``
  (D6's windows lie inside x; D4 and D5 roll one window of all R rows by
  ``shift``).  The plain version raises on a violation; the kernel reads
  the starts on the device with no host synchronisation, so it checks
  nothing and reads every row mod R, inside x whatever the starts.

Operands are int32 tensors holding uint32 bits (``ops.u32``).  A CUDA
tensor runs the kernel, a CPU tensor the plain version beside it; on any
other device, or when the kernel cannot be built or launched, the wrapper
raises.  There is no fallback.

``row_gather``'s and ``pair_merge``'s kernels take 1.5-7 us on the card at
the probes' shapes, so the host's work per call sets their pace; the
launch path of all three wrappers is kept short: checks that read cheap
tensor attributes (no ``torch.device`` built, a message only on failure),
the typed library kept in a module global once loaded (no lock), and the
stream's raw handle (``cuda_build.current_stream``).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from kmer_counter_tpu_torch import cuda_build
from kmer_counter_tpu_torch.cuda_build import ptr_array
from kmer_counter_tpu_torch.ops.u32 import narrow, widen

# D1's tile: rows compacted together (pallas_sort.TILE in the JAX package).
TILE = 65536
MODES = ("copy", "cumsum", "network")
MAX_OPS = 9
# Calls of each wrapper that launched its kernel (once per call on a CUDA
# tensor with an output row; the plain versions do not count).
launches = {"pair_merge": 0, "tile_compact": 0, "row_gather": 0}
_I32 = torch.int32
_LIB = None  # the typed library, once built and loaded (_lib)


def _int32_on_one_device(tensors, what):
    # CUDA tensors compare device indices; others (CPU, or a device with
    # no kernel, which _device_kind refuses) their torch.device.
    first = tensors[0]
    index = first.get_device() if first.is_cuda else None
    for v in tensors:
        if v.dtype is not _I32:
            raise TypeError(f"{what} must be int32 (uint32 bits), got {v.dtype}")
        if (v.get_device() != index) if v.is_cuda else (v.device != first.device):
            raise ValueError(f"{what} must be on one device")
        if not v.is_contiguous():
            raise ValueError(f"{what} must be contiguous")


def _device_kind(t: torch.Tensor, name: str) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{name} has no kernel for device {t.device}")
    return t.device.type


# ---- pair_merge (D2, D3, D7) -------------------------------------------------


def pair_merge(a: torch.Tensor, b: torch.Tensor, *, b_descending: bool) -> torch.Tensor:
    """D2/D3/D7: the kernel for CUDA tensors, the plain version for CPU ones."""
    _int32_on_one_device([a, b], "a and b")
    if a.dim() != 2 or b.dim() != 2 or a.shape[0] != b.shape[0]:
        raise ValueError(f"a and b must be [G, Ta] and [G, Tb], got {tuple(a.shape)} and {tuple(b.shape)}")
    if not a.is_cuda and _device_kind(a, "pair_merge") == "cpu":
        return pair_merge_reference(a, b, b_descending=b_descending)
    out = torch.empty((a.shape[0], a.shape[1] + b.shape[1]), dtype=torch.int32, device=a.device)
    if out.numel():
        err = _lib().pr_pair_merge(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0], a.shape[1],
                                   b.shape[1], int(bool(b_descending)), cuda_build.current_stream(a.get_device()))
        _launched("pair_merge", err)
    return out


def pair_merge_reference(a: torch.Tensor, b: torch.Tensor, *, b_descending: bool) -> torch.Tensor:
    """Plain torch D2/D3/D7: a sort of each pair's concatenation, widened
    to int64 so that keys of 2^31 and above sort after the others.  B's
    order does not matter to a sort."""
    del b_descending
    return narrow(torch.sort(torch.cat([widen(a), widen(b)], dim=1), dim=1).values)


# ---- tile_compact (D1) -------------------------------------------------------


def _check_tiles(ops: Sequence[torch.Tensor], live: torch.Tensor, mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if not 1 <= len(ops) <= MAX_OPS:
        raise ValueError(f"tile_compact takes 1 to {MAX_OPS} operands, got {len(ops)}")
    _int32_on_one_device([*ops, live], "operands and live")
    n = live.shape[0] if live.dim() == 1 else -1
    if any(v.dim() != 1 or v.shape[0] != n for v in ops) or n < 0:
        raise ValueError("operands and live must be 1-D and of equal length")
    if n % TILE:
        raise ValueError(f"the row count must be a multiple of TILE={TILE}, got {n}")
    # The kernel moves 16 bytes at a time.
    if any(v.data_ptr() % 16 for v in (*ops, live)):
        raise ValueError("operands and live must start on a 16-byte boundary")


def tile_compact(ops: Sequence[torch.Tensor], live: torch.Tensor, mode: str) -> torch.Tensor:
    """D1's three bodies: the kernel for CUDA tensors, the plain version for
    CPU ones."""
    _check_tiles(ops, live, mode)
    if not live.is_cuda and _device_kind(live, "tile_compact") == "cpu":
        return tile_compact_reference(ops, live, mode)
    k, n = len(ops), live.shape[0]
    out = torch.empty((k, n), dtype=_I32, device=live.device)
    if n:
        first, row = out.data_ptr(), 4 * n  # out's rows, one an operand
        outs = (ctypes.c_void_p * k)(*range(first, first + k * row, row))
        err = _lib().pr_tile_compact(ptr_array(ops), outs, k, live.data_ptr(), n, MODES.index(mode),
                                     cuda_build.current_stream(live.get_device()))
        _launched("tile_compact", err)
    return out


def tile_compact_reference(ops: Sequence[torch.Tensor], live: torch.Tensor, mode: str) -> torch.Tensor:
    """Plain torch D1: ``clone``; a per-tile cumsum of the dead rows added
    mod 2^32; or each live row scattered to its in-tile rank (inclusive
    cumsum - 1), zeros elsewhere."""
    x = torch.stack(list(ops))
    if mode == "copy":
        return x.clone()
    n_ops, n = x.shape
    alive = (live != 0).view(n // TILE, TILE)
    if mode == "cumsum":
        dead = (~alive).to(torch.int64)
        delta = (torch.cumsum(dead, dim=1) - dead).view(1, n)
        return narrow(widen(x) + delta)
    rank = torch.cumsum(alive.to(torch.int64), dim=1) - 1
    dst = (rank + torch.arange(0, n, TILE, device=x.device).view(-1, 1))[alive]
    out = torch.zeros_like(x)
    out[:, dst] = x[:, alive.view(n)]
    return out


# ---- row_gather (D4, D5, D6) -------------------------------------------------


def _check_rows(x: torch.Tensor, starts: torch.Tensor, rows: int) -> None:
    _int32_on_one_device([x, starts], "x and starts")
    if x.dim() != 2 or starts.dim() != 1:
        raise ValueError(f"x must be [R, W] and starts [G], got {tuple(x.shape)} and {tuple(starts.shape)}")
    if not 0 <= rows <= x.shape[0]:
        raise ValueError(f"rows must be in [0, {x.shape[0]}], got {rows}")


def row_gather(x: torch.Tensor, starts: torch.Tensor, rows: int, shift: int) -> torch.Tensor:
    """D4/D5/D6: the kernel for CUDA tensors, the plain version for CPU ones."""
    _check_rows(x, starts, rows)
    if not x.is_cuda and _device_kind(x, "row_gather") == "cpu":
        return row_gather_reference(x, starts, rows, shift)
    R, W = x.shape
    G = starts.shape[0]
    out = torch.empty((G, rows, W), dtype=_I32, device=x.device)
    if G * rows * W:
        err = _lib().pr_row_gather(x.data_ptr(), starts.data_ptr(), out.data_ptr(), R, W, G, rows, shift,
                                   cuda_build.current_stream(x.get_device()))
        _launched("row_gather", err)
    return out


def row_gather_reference(x: torch.Tensor, starts: torch.Tensor, rows: int, shift: int) -> torch.Tensor:
    """Plain torch D4/D5/D6: the rows' indices, then ``index_select``."""
    _check_rows(x, starts, rows)
    R, W = x.shape
    s = starts.to(torch.int64)
    if bool(((s < 0) | (s + rows > R)).any()):
        raise ValueError(f"every window must lie inside x: 0 <= start and start + {rows} <= {R}")
    idx = (s.view(-1, 1) + shift + torch.arange(rows, device=x.device)) % R
    return x.index_select(0, idx.view(-1)).view(starts.shape[0], rows, W)


# ---- the CUDA kernels --------------------------------------------------------


def _lib() -> ctypes.CDLL:
    """The library with its entry points typed: built and loaded at the
    first call, then kept in _LIB."""
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("probes")
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        lib.pr_tile.argtypes, lib.pr_tile.restype = [], i
        lib.pr_pair_merge.argtypes, lib.pr_pair_merge.restype = [vp, vp, vp, ll, ll, ll, i, vp], i
        lib.pr_tile_compact.argtypes, lib.pr_tile_compact.restype = [ptrs, ptrs, i, vp, ll, i, vp], i
        lib.pr_row_gather.argtypes, lib.pr_row_gather.restype = [vp, vp, vp, ll, ll, ll, i, ll, vp], i
        _LIB = lib
    return _LIB


def kernel_tile() -> int:
    """D1's tile in the CUDA source (builds it if needed)."""
    return _lib().pr_tile()


def _launched(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    launches[name] += 1
