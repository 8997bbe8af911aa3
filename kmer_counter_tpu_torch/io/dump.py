"""Binary count-table dump in the reference record format.

The port's own copy of kmer_counter_tpu/io/dump.py, with a second route
for a table that is still a tensor.

Replaces DumpResults (KMerCounter.cpp:91-106) and FileDump
(FileDump.cpp:51-58).  Two documented reference defects are fixed
(SURVEY.md §7.1): all ``ceil(k/32)`` key words are written (the reference
hardcodes 8 key bytes, truncating k>32 — KMerCounter.cpp:102), and records
are written globally sorted ascending (the dormant merge pipeline's
intended output) rather than in hash-iteration order.

``dump_table`` takes its route from its input.  NumPy lanes ``[N, NL]``
are formatted on the host (the count filter, ``lanes_to_words``,
``serialize_table``).  Lane-major tensor lanes ``[NL, N]`` (the finalized
table, still on the card) are formatted where they lie: the counts are
uploaded, ``ops.record_pack`` writes the records of the rows with a
nonzero count (the kernel on the card, its plain version on the CPU), and
the image comes back in one copy into a pinned host buffer.  Both write
the same bytes.

Given the run's ``Metrics``, ``dump_table`` is its ``dump`` span, which
holds ``dump.format`` and then ``dump.write`` (opening the file and the
write).  On the tensor route ``dump.format`` holds the counts' upload,
``dump.format.pack`` and ``dump.format.d2h`` (the image's copy from the
card, its bytes added to the ``d2h_bytes`` counter).  The counters
``dump_records_card`` and ``dump_records_host`` count the records formatted
on the card and on the host (a CPU tensor's by the plain pack).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from kmer_counter_tpu_torch import records
from kmer_counter_tpu_torch.metrics import span
from kmer_counter_tpu_torch.ops.record_pack import pack_records, record_words


def dump_table(
    path: str,
    lanes: np.ndarray | torch.Tensor,
    counts: np.ndarray,
    num_unique: int | None = None,
    append: bool = False,
    metrics=None,
) -> int:
    """Write a (lanes, counts) table as reference-format records.

    ``lanes`` is ``[N, NL] uint32`` on the host, or a lane-major ``[NL, N]
    int32`` tensor (uint32 bits) on any device; ``counts`` is ``[N]
    uint32`` on the host.  Rows past ``num_unique`` (or with count 0) are
    skipped.  Returns records written.  With ``metrics``
    (metrics.Metrics), the call is its ``dump`` span and the formatting and
    the write its ``dump.format`` and ``dump.write``.
    """
    with span(metrics, "dump"):
        with span(metrics, "dump.format"):
            counts = np.asarray(counts)
            if num_unique is not None:
                lanes = lanes[:, :num_unique] if isinstance(lanes, torch.Tensor) else lanes[:num_unique]
                counts = counts[:num_unique]
            if isinstance(lanes, torch.Tensor):
                data = _format_tensor(lanes, counts, metrics)
                n = len(data) // (4 * record_words(lanes.shape[0]))
                route = "dump_records_card" if lanes.is_cuda else "dump_records_host"
            else:
                data, n = _format_host(lanes, counts)
                route = "dump_records_host"
        with span(metrics, "dump.write"):
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            with open(path, "ab" if append else "wb") as fh:
                fh.write(data)
    if metrics is not None:
        metrics.count(route, n)
    return n


def _format_host(lanes: np.ndarray, counts: np.ndarray) -> tuple[bytes, int]:
    lanes = np.asarray(lanes)
    keep = counts > 0
    if not keep.all():
        lanes, counts = lanes[keep], counts[keep]
    return records.serialize_table(records.lanes_to_words(lanes), counts), len(counts)


def _format_tensor(lanes: torch.Tensor, counts: np.ndarray, metrics) -> memoryview:
    """The records of a lane-major tensor table, formatted on its device;
    returned as a view of a host buffer (pinned for a CUDA table)."""
    counts = np.ascontiguousarray(counts, dtype=np.uint32)
    dev_counts = torch.from_numpy(counts.view(np.int32)).to(lanes.device)
    with span(metrics, "dump.format.pack"):
        image = pack_records(lanes, dev_counts)
    del dev_counts
    with span(metrics, "dump.format.d2h"):
        if image.is_cuda:
            host = torch.empty(image.shape, dtype=torch.uint8, pin_memory=True)
            host.copy_(image)
            if metrics is not None:
                metrics.count("d2h_bytes", host.numel())
            image = host
    return memoryview(image.numpy())


def load_table(path: str, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Read a record file back as (words [U, W] uint64, counts [U] uint32)."""
    with open(path, "rb") as fh:
        return records.parse_records(fh.read(), k)
