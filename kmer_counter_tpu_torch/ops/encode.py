"""Base encoding — counterpart of kmer_counter_tpu.ops.encode.

A = 0, C = 1, G = 2, T = 3; lower case is accepted; any other byte
encodes as 3 with its validity bit cleared.
"""

from __future__ import annotations

import torch


def encode_reads(reads: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """ASCII reads ``[R, L] uint8`` → (codes ``[R, L] int64``, valid
    ``[R, L] bool``).  Codes are int64 because extraction shifts them."""
    c = reads.to(torch.uint8)
    upper = torch.where((c >= ord("a")) & (c <= ord("z")), c - 32, c)
    is_a = upper == ord("A")
    is_c = upper == ord("C")
    is_g = upper == ord("G")
    is_t = upper == ord("T")
    valid = is_a | is_c | is_g | is_t
    codes = torch.full(c.shape, 3, dtype=torch.int64, device=c.device)
    codes = torch.where(is_a, 0, torch.where(is_c, 1, torch.where(is_g, 2, codes)))
    return codes, valid
