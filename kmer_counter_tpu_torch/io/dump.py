"""Binary count-table dump in the reference record format.

The port's own copy of kmer_counter_tpu/io/dump.py.

Replaces DumpResults (KMerCounter.cpp:91-106) and FileDump
(FileDump.cpp:51-58).  Two documented reference defects are fixed
(SURVEY.md §7.1): all ``ceil(k/32)`` key words are written (the reference
hardcodes 8 key bytes, truncating k>32 — KMerCounter.cpp:102), and records
are written globally sorted ascending (the dormant merge pipeline's
intended output) rather than in hash-iteration order.

Given the run's ``Metrics``, ``dump_table`` is its ``dump`` span, which
holds ``dump.format`` (the trim, the count filter, ``lanes_to_words`` and
``serialize_table``) and then ``dump.write`` (opening the file and the
write).
"""

from __future__ import annotations

import os

import numpy as np

from kmer_counter_tpu_torch import records
from kmer_counter_tpu_torch.metrics import span


def dump_table(
    path: str,
    lanes: np.ndarray,
    counts: np.ndarray,
    num_unique: int | None = None,
    append: bool = False,
    metrics=None,
) -> int:
    """Write a (lanes, counts) table as reference-format records.

    ``lanes`` is the device layout ``[N, NL] uint32``; rows past
    ``num_unique`` (or with count 0) are skipped.  Returns records written.
    With ``metrics`` (metrics.Metrics), the call is its ``dump`` span and
    the formatting and the write its ``dump.format`` and ``dump.write``.
    """
    with span(metrics, "dump"):
        with span(metrics, "dump.format"):
            lanes = np.asarray(lanes)
            counts = np.asarray(counts)
            if num_unique is not None:
                lanes = lanes[:num_unique]
                counts = counts[:num_unique]
            keep = counts > 0
            if not keep.all():
                lanes, counts = lanes[keep], counts[keep]
            words = records.lanes_to_words(lanes)
            data = records.serialize_table(words, counts)
        with span(metrics, "dump.write"):
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            with open(path, "ab" if append else "wb") as fh:
                fh.write(data)
    return len(counts)


def load_table(path: str, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Read a record file back as (words [U, W] uint64, counts [U] uint32)."""
    with open(path, "rb") as fh:
        return records.parse_records(fh.read(), k)
