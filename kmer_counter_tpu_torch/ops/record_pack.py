"""The dump's record image, packed where the finalized table lies.

``pack_records`` launches the hand-written CUDA kernel in
``csrc/records.cu`` for CUDA tensors, and runs ``pack_records_reference``,
its plain torch version, only for tensors on the CPU.  There is no
fallback: on any other device, or when the kernel cannot be built or
launched, it raises.  The kernel replaces no TPU kernel: the JAX package
formats the dump on the host (``kmer_counter_tpu/io/dump.py``, with
``records.lanes_to_words`` and ``records.serialize_table``); io.dump takes
this route for a table still on the card, so that only the record image is
copied back.

Contract (both versions): ``lanes`` is the lane-major table ``[NL, n]
int32`` (uint32 bits, 1 <= NL <= 8), its rows contiguous within a lane and
its lanes any stride apart (a column slice such as ``table.lanes[:, :n]``
needs no copy); ``counts`` is ``[n] int32``, contiguous, on the same
device.  The result is a 1-D ``uint8`` tensor on that device: the
reference records (``records.serialize_table(records.lanes_to_words(...))``)
of the rows whose count is not 0, in row order — ceil(NL/2) little-endian
uint64 key words, word w = lane[2w] << 32 | lane[2w+1] (a zero lane NL for
an odd NL), then the little-endian uint32 count.
"""

from __future__ import annotations

import ctypes

import torch

from kmer_counter_tpu_torch import cuda_build

MAX_LANES = 8
# Calls of ``pack_records`` that launched the kernels (count, scan, pack:
# counted once per call on a CUDA table with a row; the plain version does
# not count).
launches = 0
_LIB = None  # the typed library, once built and loaded (_lib)


def record_words(num_lanes: int) -> int:
    """uint32 words of a record: 2 ceil(NL/2) key words, then the count."""
    return 2 * ((num_lanes + 1) // 2) + 1


def _check(lanes: torch.Tensor, counts: torch.Tensor):
    if lanes.dtype is not torch.int32 or counts.dtype is not torch.int32:
        raise TypeError(f"lanes and counts must be int32 (uint32 bits), got {lanes.dtype} and {counts.dtype}")
    if lanes.dim() != 2 or not 1 <= lanes.shape[0] <= MAX_LANES:
        raise ValueError(f"lanes must be [NL, n] with 1 <= NL <= {MAX_LANES}, got {tuple(lanes.shape)}")
    if counts.dim() != 1 or counts.shape[0] != lanes.shape[1]:
        raise ValueError(f"counts must be [n] for lanes {tuple(lanes.shape)}, got {tuple(counts.shape)}")
    if lanes.device != counts.device:
        raise ValueError("lanes and counts must be on one device")
    if lanes.shape[1] > 1 and lanes.stride(1) != 1:
        raise ValueError("each lane's rows must be contiguous")
    if not counts.is_contiguous():
        raise ValueError("counts must be contiguous")


def pack_records(lanes: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """The kept rows' records: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    _check(lanes, counts)
    if lanes.device.type == "cpu":
        return pack_records_reference(lanes, counts)
    if lanes.device.type != "cuda":
        raise RuntimeError(f"pack_records has no kernel for device {lanes.device}")
    return _launch(lanes, counts)


def pack_records_reference(lanes: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Plain torch: the kept rows gathered, their lanes swapped into
    (low half, high half) pairs and the count appended, as int32 words
    read as bytes (the host is little-endian, as the record format)."""
    NL = lanes.shape[0]
    keep = counts != 0
    kept = lanes[:, keep]
    rec = torch.zeros((kept.shape[1], record_words(NL)), dtype=torch.int32, device=lanes.device)
    for w in range((NL + 1) // 2):
        if 2 * w + 1 < NL:
            rec[:, 2 * w] = kept[2 * w + 1]
        rec[:, 2 * w + 1] = kept[2 * w]
    rec[:, -1] = counts[keep]
    return rec.reshape(-1).view(torch.uint8)


# ---- the CUDA kernel -------------------------------------------------------


def _lib() -> ctypes.CDLL:
    """The library with its entry points typed: built and loaded at the
    first call, then kept in _LIB (no lock on the launch path)."""
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("records")
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.rp_tile_rows.argtypes, lib.rp_tile_rows.restype = [], i
        lib.rp_num_tiles.argtypes, lib.rp_num_tiles.restype = [ll], ll
        lib.rp_pack.argtypes, lib.rp_pack.restype = [vp, ll, i, vp, ll, vp, vp, vp], i
        _LIB = lib
    return _LIB


def tile_rows() -> int:
    """Rows per CUDA block (builds the kernel if needed)."""
    return _lib().rp_tile_rows()


def _launch(lanes: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    global launches
    NL, n = lanes.shape
    if n == 0:
        return torch.empty(0, dtype=torch.uint8, device=lanes.device)
    lib = _lib()
    rw = record_words(NL)
    out = torch.empty(n * rw, dtype=torch.int32, device=lanes.device)
    # The kept rows before each tile, then the kept total (the kernels write all).
    scratch = torch.empty(lib.rp_num_tiles(n) + 1, dtype=torch.int64, device=lanes.device)
    err = lib.rp_pack(lanes.data_ptr(), lanes.stride(0), NL, counts.data_ptr(), n, scratch.data_ptr(),
                      out.data_ptr(), cuda_build.current_stream(lanes.get_device()))
    if err:
        raise RuntimeError(f"pack_records launch failed: cudaError {err}")
    launches += 1
    kept = int(scratch[-1])  # waits for the launches
    return out[: kept * rw].view(torch.uint8)
