"""Windowed k-mer extraction — counterpart of kmer_counter_tpu.ops.extract.

The same design as the JAX version: a four-level shift-or pack tree
builds, for every offset p, the 16 bases starting at p MSB-first in 32
bits; each key lane of each window is a slice of that tree (tail-masked
for a partial last lane); reverse-complement lanes come from the same
tree by complement (XOR) and a fixed 2-bit-group reversal; window
validity is a log-doubling sliding OR over the invalid mask.

Only the read-major form is ported.  The JAX package's transposed ``_t``
twins (extract.py:165-230) exist for TPU tile padding; window order is
not observable after the raw sort, so they have no counterpart here.

Lane values are int64 in [0, 2^32) throughout (see ops.u32).
"""

from __future__ import annotations

import torch

from kmer_counter_tpu_torch.records import BASES_PER_LANE, active_lanes
from kmer_counter_tpu_torch.ops.u32 import MASK


def _pack_tree(codes: torch.Tensor) -> torch.Tensor:
    """codes ``[R, L] int64`` → ``A [R, L]`` with A[:, p] packing bases
    p..p+15 MSB-first in 32 bits (zero-padded past the read end).

    A_{m+1}[p] = A_m[p] << 2*2^m | A_m[p + 2^m]; after level m a value
    holds 2^(m+1) bases, so it never exceeds 32 bits."""
    R, _ = codes.shape
    A = torch.cat([codes, codes.new_zeros((R, BASES_PER_LANE - 1))], dim=1)
    for m in range(4):
        sh = 1 << m
        A = (A[:, : A.shape[1] - sh] << (2 * sh)) | A[:, sh:]
    return A


def _rev_groups(v: torch.Tensor) -> torch.Tensor:
    """Reverse the sixteen 2-bit groups of each 32-bit value."""
    m1, m2, m3 = 0x33333333, 0x0F0F0F0F, 0x00FF00FF
    v = ((v & m1) << 2) | ((v >> 2) & m1)
    v = ((v & m2) << 4) | ((v >> 4) & m2)
    v = ((v & m3) << 8) | ((v >> 8) & m3)
    return ((v << 16) & MASK) | (v >> 16)


def _fwd_lanes(A: torch.Tensor, k: int, P: int) -> list[torch.Tensor]:
    """Forward key lanes: lane i of window p is A[p + 16i], tail-masked
    for the partial last lane (active lanes only)."""
    lanes = []
    for i in range(active_lanes(k)):
        base0 = i * BASES_PER_LANE
        n_bases = min(BASES_PER_LANE, k - base0)
        v = A[:, base0 : base0 + P]
        if n_bases < BASES_PER_LANE:
            drop = 2 * (BASES_PER_LANE - n_bases)
            v = (v >> drop) << drop
        lanes.append(v)
    return lanes


def _rc_lanes(A: torch.Tensor, k: int, P: int) -> list[torch.Tensor]:
    """Reverse-complement key lanes from the same tree: rc lane i covers
    window bases [k-16(i+1), k-16i) reversed and complemented; the
    partial last lane reverses the window's first n bases, left-aligned."""
    lanes = []
    for i in range(active_lanes(k)):
        n_bases = min(BASES_PER_LANE, k - i * BASES_PER_LANE)
        if n_bases == BASES_PER_LANE:
            off = k - BASES_PER_LANE * (i + 1)
            lanes.append(_rev_groups(A[:, off : off + P] ^ MASK))
        else:
            v = _rev_groups(A[:, 0:P] ^ MASK)
            lanes.append((v << (2 * (BASES_PER_LANE - n_bases))) & MASK)
    return lanes


def _lex_min(a: list[torch.Tensor], b: list[torch.Tensor]) -> list[torch.Tensor]:
    """Elementwise lexicographic min of two lane lists."""
    a_lt = torch.zeros(a[0].shape, dtype=torch.bool, device=a[0].device)
    for i in reversed(range(len(a))):
        a_lt = torch.where(a[i] == b[i], a_lt, a[i] < b[i])
    return [torch.where(a_lt, x, y) for x, y in zip(a, b)]


def _window_valid(valid: torch.Tensor, k: int) -> torch.Tensor:
    """valid ``[R, L] bool`` → window validity ``[R, P] bool``."""
    cur = ~valid
    covered = 1
    while covered < k:
        step = min(covered, k - covered)
        cur = cur[:, : cur.shape[1] - step] | cur[:, step:]
        covered += step
    P = valid.shape[1] - k + 1
    return ~cur[:, :P]


def extract_kmer_lanes(
    codes: torch.Tensor, valid: torch.Tensor, k: int, canonical: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """All k-mer windows of a chunk: (lanes ``[NLa, R, P] int64``,
    window_valid ``[R, P] bool``), P = L - k + 1, NLa = active_lanes(k).
    k-mers never cross reads."""
    R, L = codes.shape
    P = L - k + 1
    if P <= 0:
        raise ValueError(f"line length {L} shorter than k={k}")
    A = _pack_tree(codes)
    lanes = _fwd_lanes(A, k, P)
    if canonical:
        lanes = _lex_min(_rc_lanes(A, k, P), lanes)
    return torch.stack(lanes, dim=0), _window_valid(valid, k)
