"""Independent NumPy count of every valid k-mer window and the dump's
record format: a frozen copy of ``numpy_count`` and ``dump_bytes`` from
the repository's ``chip_smoke.py``.  Imports nothing of the counter under
test, of JAX or of the JAX package."""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def numpy_count(reads, k, canonical, block=250_000):
    """Independent count of every k-mer window whose bases are all ACGT
    (either case): 2-bit codes A<C<G<T packed MSB-first into ceil(k/32)
    uint64 words per k-mer; canonical takes the lexicographic minimum of
    the k-mer and its reverse complement.  Blocks of reads are counted on
    every host core (NumPy releases the GIL in its loops and sorts), then
    their counts are summed key by key, a range of keys a thread.
    Returns (words [U, W] uint64 ascending, counts [U] uint32)."""
    W = -(-k // 32)
    R, L = reads.shape
    P = L - k + 1
    lut = np.full(256, 255, np.uint8)
    for code, base in enumerate(b"ACGT"):
        lut[base] = lut[base + 32] = code

    def count_block(b0):
        raw = lut[reads[b0 : b0 + block]]
        valid = raw != 255
        c = np.where(valid, raw, 0).astype(np.uint64)
        fwd = np.zeros((W, len(c), P), np.uint64)
        rc = np.zeros_like(fwd) if canonical else None
        for i in range(k):
            win = c[:, i : i + P]
            fwd[i // 32] |= win << np.uint64(62 - 2 * (i % 32))
            if canonical:  # base i of the window is base k-1-i of its reverse complement
                j = k - 1 - i
                rc[j // 32] |= (np.uint64(3) - win) << np.uint64(62 - 2 * (j % 32))
        if canonical:
            take_rc = np.zeros(fwd.shape[1:], bool)
            decided = np.zeros_like(take_rc)
            for w in range(W):
                lt, gt = rc[w] < fwd[w], rc[w] > fwd[w]
                take_rc |= lt & ~decided
                decided |= lt | gt
            fwd = np.where(take_rc, rc, fwd)
        bad = np.concatenate([np.zeros((len(c), 1), np.int64), np.cumsum(~valid, axis=1)], 1)
        keys = fwd[:, bad[:, k : k + P] == bad[:, :P]].T
        keys, counts = sum_by_key(keys, np.ones(len(keys), np.uint64))
        # The block's keys cut into RANGES ranges of the first word's top
        # bits: ranges ascending in key order, each summed on its own.
        cuts = np.searchsorted(keys[:, 0], np.arange(1, RANGES, dtype=np.uint64) << np.uint64(64 - RANGE_BITS))
        return np.split(keys, cuts), np.split(counts, cuts)

    def sum_by_key(keys, counts):
        order = np.argsort(keys[:, 0], kind="stable") if W == 1 else np.lexsort(keys.T[::-1])
        keys, counts = keys[order], counts[order]
        head = np.ones(len(keys), bool)
        head[1:] = (keys[1:] != keys[:-1]).any(axis=1)
        starts = np.flatnonzero(head)
        return keys[starts], np.add.reduceat(counts, starts) if len(starts) else counts[:0]

    RANGE_BITS = 4
    RANGES = 1 << RANGE_BITS
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        blocks = list(pool.map(count_block, range(0, R, block)))
        ranges = list(pool.map(lambda r: sum_by_key(np.concatenate([b[0][r] for b in blocks]),
                                                    np.concatenate([b[1][r] for b in blocks])), range(RANGES)))
    del blocks
    return np.concatenate([r[0] for r in ranges]), np.concatenate([r[1] for r in ranges]).astype(np.uint32)


def dump_bytes(words, counts):
    """The record format of the dump: each key's words (uint64 LE), then
    its count (uint32 LE)."""
    U, W = words.shape
    rec = np.empty((U, 8 * W + 4), np.uint8)
    rec[:, : 8 * W] = words.astype("<u8").view(np.uint8).reshape(U, 8 * W)
    rec[:, 8 * W :] = counts.astype("<u4").view(np.uint8).reshape(U, 4)
    return rec.tobytes()
