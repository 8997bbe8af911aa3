"""Fused encode + extract (K8) — counterpart of
docs/experiments_pallas_extract.py ``extract_chunk_lanes_major``.

The wrappers launch the hand-written CUDA kernel in
``csrc/fused_extract.cu`` (which replaces that Pallas kernel) for CUDA
tensors, and run the plain torch versions (``ops.encode.encode_reads``
and ``ops.extract.extract_kmer_lanes``) only for tensors on the CPU.
There is no fallback: on any other device, or when the kernel cannot be
built or launched, they raise.

Two entry points, one kernel:

- ``extract_chunk_lanes_major(reads, k, canonical)`` is K8's contract:
  ``[R, L] uint8`` ASCII reads → ``[NL+1, R*P] int32`` (uint32 bits),
  P = L-k+1, NL = ceil(k/16), read-major: rows 0..NL-1 the key lanes of
  every window (masked or not), row NL its validity (1, or 0 when a base
  is not A/C/G/T in either case).  The Pallas kernel needs R to be a
  multiple of its block; any R works here.
- ``extract_chunk_keys_into(reads, k, canonical, dst, off, allt)`` is
  ``pipeline.extract_chunk_keys``' contract written in place: the key
  lanes of the chunk's n = R*P windows go to ``dst[:, off:off+n]``, a
  masked window as the all-ones sentinel in every lane, and when k % 16
  == 0 in forward mode the valid all-T windows (the sentinel's bits) are
  added to ``allt`` (a one-element int64 tensor).  The two-level chunk
  step writes the raw region this way, at ``raw_off``, with no chunk-sized
  temporary and no host synchronisation.
"""

from __future__ import annotations

import ctypes

import torch

from kmer_counter_tpu_torch import cuda_build
from kmer_counter_tpu_torch.ops.encode import encode_reads
from kmer_counter_tpu_torch.ops.extract import extract_kmer_lanes
from kmer_counter_tpu_torch.ops.u32 import MASK, narrow
from kmer_counter_tpu_torch.records import active_lanes

MAX_K = 128
# Kernel launches made by the two wrappers (one per call on a CUDA tensor
# with at least one window; the plain versions do not count).
launches = 0


def _check(reads: torch.Tensor, k: int) -> int:
    """Checks the reads and k; returns the chunk's window count R*P."""
    if reads.dtype != torch.uint8:
        raise TypeError(f"reads must be uint8 ASCII, got {reads.dtype}")
    if reads.dim() != 2:
        raise ValueError(f"reads must be [R, L], got shape {tuple(reads.shape)}")
    if not reads.is_contiguous():
        raise ValueError("reads must be contiguous")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")
    R, L = reads.shape
    if L - k + 1 <= 0:
        raise ValueError(f"line length {L} shorter than k={k}")
    return R * (L - k + 1)


def _device_of(reads: torch.Tensor) -> str:
    if reads.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"fused_extract has no kernel for device {reads.device}")
    return reads.device.type


def extract_chunk_lanes_major(reads: torch.Tensor, k: int, canonical: bool = False) -> torch.Tensor:
    """K8 (records): the kernel for CUDA tensors, the plain version for CPU tensors."""
    n = _check(reads, k)
    if _device_of(reads) == "cpu":
        return extract_chunk_lanes_major_reference(reads, k, canonical)
    out = torch.empty((active_lanes(k) + 1, n), dtype=torch.int32, device=reads.device)
    if n:
        _launch(reads, k, canonical, False, out, 0, None)
    return out


def extract_chunk_keys_into(reads: torch.Tensor, k: int, canonical: bool, dst: torch.Tensor, off: int,
                            allt: torch.Tensor) -> int:
    """K8 (keys) into ``dst[:, off:off+n]`` and ``allt``; returns n.  The
    kernel for CUDA tensors, the plain version for CPU tensors."""
    n = _check(reads, k)
    NL = active_lanes(k)
    if dst.dtype != torch.int32 or dst.dim() != 2 or dst.shape[0] != NL or dst.stride(1) != 1:
        raise ValueError(f"dst must be an int32 [{NL}, C] tensor with unit column stride")
    if not 0 <= off <= dst.shape[1] - n:
        raise ValueError(f"{n} windows at column {off} overflow dst ({dst.shape[1]} columns)")
    if allt.dtype != torch.int64 or allt.numel() != 1:
        raise ValueError("allt must be a one-element int64 tensor")
    if dst.device != reads.device or allt.device != reads.device:
        raise ValueError("reads, dst and allt must be on one device")
    if _device_of(reads) == "cpu":
        lanes, count = extract_chunk_keys_reference(reads, k, canonical)
        dst[:, off : off + n] = lanes
        allt += count.reshape(allt.shape)
        return n
    if n:
        _launch(reads, k, canonical, True, dst, off, allt)
    return n


# ---- the plain versions ------------------------------------------------------


def _extract_flat(reads: torch.Tensor, k: int, canonical: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(lanes ``[NL, R*P] int64``, window validity ``[R*P] bool``), read-major."""
    codes, valid = encode_reads(reads)
    lanes, wvalid = extract_kmer_lanes(codes, valid, k, canonical)
    NL, R, P = lanes.shape
    return lanes.reshape(NL, R * P), wvalid.reshape(R * P)


def extract_chunk_lanes_major_reference(reads: torch.Tensor, k: int, canonical: bool = False) -> torch.Tensor:
    """Plain K8 (records): ops.encode and ops.extract, then the lanes and
    the validity stacked into one ``[NL+1, R*P] int32`` tensor."""
    flat, wv = _extract_flat(reads, k, canonical)
    return torch.cat([narrow(flat), wv.to(torch.int32)[None]])


def extract_chunk_keys_reference(reads: torch.Tensor, k: int, canonical: bool = False):
    """Plain K8 (keys): (lanes ``[NL, R*P] int32``, allt ``int64`` 0-d);
    masked windows and (k % 16 == 0, forward) valid all-T windows hold the
    sentinel, and the latter are counted in allt."""
    flat, wv = _extract_flat(reads, k, canonical)
    if k % 16 == 0 and not canonical:
        is_allt = (flat == MASK).all(dim=0) & wv
        allt = is_allt.sum()
        wv = wv & ~is_allt
    else:
        allt = torch.zeros((), dtype=torch.int64, device=reads.device)
    return narrow(torch.where(wv, flat, MASK)), allt


# ---- the CUDA kernel ---------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("fused_extract")
    if not getattr(lib, "_fx_typed", False):
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.fx_tile_bases.argtypes, lib.fx_tile_bases.restype = [], i
        lib.fx_extract.argtypes = [vp, ll, ll, i, i, i, vp, ll, ll, vp, vp]
        lib.fx_extract.restype = i
        lib._fx_typed = True
    return lib


def tile_bases() -> int:
    """Window starts (read bytes) per CUDA block (builds the kernel if needed)."""
    return _lib().fx_tile_bases()


def _launch(reads, k, canonical, keys, dst, off, allt):
    global launches
    lib = _lib()
    R, L = reads.shape
    stream = torch.cuda.current_stream(reads.device).cuda_stream
    err = lib.fx_extract(reads.data_ptr(), R, L, k, int(canonical), int(keys), dst.data_ptr(), dst.stride(0), off,
                         None if allt is None else allt.data_ptr(), stream)
    if err:
        raise RuntimeError(f"fused_extract launch failed: cudaError {err}")
    launches += 1
