"""The comparison that decides ``correct``: records of a dump against the
reference's, as bytes.  Exact: the limit of every number here is 0."""

from __future__ import annotations

import numpy as np

_MIX = (np.uint64(0x9E3779B97F4A7C15), np.uint64(0xBF58476D1CE4E5B9), np.uint64(0x94D049BB133111EB))


def _record_hashes(dump: bytes, record_size: int) -> np.ndarray:
    """A 64-bit hash of each whole record (its 8-byte key words and its
    4-byte count), sorted."""
    rows = np.frombuffer(dump, np.uint8).reshape(-1, record_size)
    h = np.zeros(len(rows), np.uint64)
    with np.errstate(over="ignore"):
        for w in range((record_size - 4) // 8):
            h = (h ^ rows[:, 8 * w : 8 * w + 8].copy().view("<u8")[:, 0]) * _MIX[0]
            h ^= h >> np.uint64(29)
        h = (h ^ rows[:, -4:].copy().view("<u4")[:, 0].astype(np.uint64)) * _MIX[1]
        h ^= h >> np.uint64(32)
        h *= _MIX[2]
    return np.sort(h)


def records_wrong(dump: bytes, ref: bytes, record_size: int) -> int:
    """Records that are in one of the two dumps and not in the other,
    counted with their repeats, each record taken whole (key words and
    count); at least 1 whenever the dumps differ (records out of order).  0
    when the dumps are byte-equal; a dump whose length is not a whole
    number of records counts every record of both."""
    if dump == ref:
        return 0
    if len(dump) % record_size or len(ref) % record_size:
        return (len(dump) + len(ref)) // record_size + 1
    a, b = _record_hashes(dump, record_size), _record_hashes(ref, record_size)
    values = np.union1d(a, b)
    count_a = np.searchsorted(a, values, "right") - np.searchsorted(a, values, "left")
    count_b = np.searchsorted(b, values, "right") - np.searchsorted(b, values, "left")
    return max(int(np.abs(count_a - count_b).sum()), 1)
