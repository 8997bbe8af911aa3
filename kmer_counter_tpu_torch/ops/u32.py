"""uint32 values carried in ``torch.int32`` tensors.

torch's uint32 dtype cannot shift, compare or add on the CPU, so the port
stores key lanes and counts as int32 tensors holding the uint32 bit
pattern (the CUDA kernels read them as ``uint32_t*``).  Plain torch code
widens to int64 (values 0..2^32-1) before any compare, shift or add and
narrows back afterwards; numpy uint32 appears only at the host boundary.
"""

from __future__ import annotations

import numpy as np
import torch

from kmer_counter_tpu_torch.metrics import span

MASK = 0xFFFFFFFF
# The all-ones sentinel key lane (0xFFFFFFFF) as an int32 bit pattern.
SENTINEL = -1


def widen(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns → int64 values in [0, 2^32)."""
    return x.to(torch.int64) & MASK


def narrow(x: torch.Tensor) -> torch.Tensor:
    """int64 values (taken mod 2^32) → int32 bit patterns."""
    x = x & MASK
    return (x - ((x >> 31) << 32)).to(torch.int32)


def from_numpy(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """numpy uint32 → int32 tensor with the same bits on ``device``."""
    a = np.array(a, dtype=np.uint32, order="C").view(np.int32)  # a copy
    return torch.from_numpy(a).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 tensor → numpy uint32 with the same bits (host copy)."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def counts_to_host(counts: torch.Tensor, n: int, metrics=None) -> np.ndarray:
    """The first ``n`` counts of a finalized table on the host, ``[n]
    uint32``, in a pinned buffer for a CUDA table: the copy back of both
    count loops (the lanes stay where they lie, for io.dump).  With
    ``metrics``, in its ``finalize.copy_back`` span, the copy in
    ``finalize.copy_back.d2h`` and its bytes counted as ``d2h_bytes``."""
    with span(metrics, "finalize.copy_back"):
        with span(metrics, "finalize.copy_back.d2h"):
            host = torch.empty(n, dtype=torch.int32, pin_memory=counts.is_cuda)
            host.copy_(counts[:n])
    if metrics is not None:
        metrics.count("d2h_bytes", 4 * n)
    return host.numpy().view(np.uint32)


def lanes_to_host(lanes: torch.Tensor, metrics=None) -> np.ndarray:
    """Lane-major lanes ``[NL, n]`` as host rows ``[n, NL] uint32``,
    contiguous: for a finalized table that joins spill runs.  With
    ``metrics``, in its ``finalize.copy_back`` span, which holds the copy
    (``finalize.copy_back.d2h``, its bytes counted as ``d2h_bytes``) and
    then the transpose on the host (``finalize.copy_back.transpose``)."""
    with span(metrics, "finalize.copy_back"):
        with span(metrics, "finalize.copy_back.d2h"):
            host = to_numpy(lanes)
        with span(metrics, "finalize.copy_back.transpose"):
            host = np.ascontiguousarray(host.T)
    if metrics is not None:
        metrics.count("d2h_bytes", 4 * host.size)
    return host
