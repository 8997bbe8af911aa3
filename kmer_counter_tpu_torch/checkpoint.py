"""Periodic partial-table snapshot and resume.

The reference has no checkpointing (SURVEY.md §5); its dormant spill files
were "restartable artifacts in spirit" only.  Here the consolidated count
table *is* the engine's entire state, so a checkpoint is cheap and exact:

  * snapshot: the consolidated table in the standard record format
    (records.py §2.2) plus a JSON manifest recording the configuration
    fingerprint, how many reads have been fully absorbed, the per-file
    breakdown of those reads, and the out-of-band all-T count (the
    two-level table's sentinel-aliased key, ops.table2 docstring);
  * resume: load the table back into the accumulator and skip the absorbed
    read prefix during ingest (ingest order is deterministic: sorted files,
    sequential reads).  The per-file breakdown is verified against what the
    skip actually consumed — per-file fault tolerance (io.fastq) means the
    read *sequence* can silently change between runs if a file's
    readability changes, which would otherwise misalign the resume.

Counts are exact on resume because a chunk is only marked absorbed after
the device step that includes it has been enqueued and the snapshot is
taken from a consolidated table that contains it.

The port's own copy of kmer_counter_tpu/checkpoint.py, less the mesh
snapshots (``MeshSnapshot``, ``mesh_save``, ``mesh_load``), which belong to
the multi-device engine.  The files are the same, byte for byte, so either
package resumes the other's snapshot.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple

import numpy as np

from kmer_counter_tpu_torch import records

MANIFEST = "checkpoint.json"
TABLE = "table.bin"

class Snapshot(NamedTuple):
    """A loaded checkpoint."""

    lanes: np.ndarray  # [U, W] uint32 ABI-width, sorted
    counts: np.ndarray  # [U] uint32
    reads_absorbed: int
    files: dict[str, int] | None  # per-file absorbed reads (None: old ckpt)
    allt: int  # out-of-band all-T count (two-level table)
    # Outstanding disk-spill run files at snapshot time (path -> size in
    # bytes).  The snapshot table holds only the post-spill partial table;
    # the rest of the counts live in these runs, which resume re-registers
    # with the merge scheduler.  Empty dict when no spill was active.
    spill_runs: dict[str, int]


def config_fingerprint(opts) -> dict:
    return {
        "kmer_length": opts.kmer_length,
        "canonical": opts.canonical,
        "input_dir": os.path.abspath(opts.input_dir) if opts.input_dir else None,
    }


def save(
    ckpt_dir: str,
    opts,
    lanes: np.ndarray,
    counts: np.ndarray,
    reads_absorbed: int,
    files: dict[str, int] | None = None,
    allt: int = 0,
    spill_runs: list[str] | None = None,
) -> None:
    """Atomically write table + manifest (write tmp, then rename).

    ``spill_runs``: outstanding disk-spill run files (a quiescent
    MergeScheduler.snapshot_runs() view) — recorded with sizes so resume
    can verify them before re-registering."""
    os.makedirs(ckpt_dir, exist_ok=True)
    words = records.lanes_to_words(np.asarray(lanes))
    keep = np.asarray(counts) > 0
    data = records.serialize_table(words[keep], np.asarray(counts)[keep])
    tmp_table = os.path.join(ckpt_dir, TABLE + ".tmp")
    with open(tmp_table, "wb") as fh:
        fh.write(data)
    os.replace(tmp_table, os.path.join(ckpt_dir, TABLE))
    manifest = {
        "config": config_fingerprint(opts),
        "reads_absorbed": int(reads_absorbed),
        "records": int(keep.sum()),
        "allt": int(allt),
    }
    if spill_runs:
        manifest["spill_runs"] = {
            os.path.abspath(p): os.path.getsize(p) for p in spill_runs
        }
    if files is not None:
        manifest["files"] = {k: int(v) for k, v in files.items()}
    tmp_manifest = os.path.join(ckpt_dir, MANIFEST + ".tmp")
    with open(tmp_manifest, "w") as fh:
        json.dump(manifest, fh)
    os.replace(tmp_manifest, os.path.join(ckpt_dir, MANIFEST))


def load(ckpt_dir: str, opts) -> Snapshot | None:
    """Returns a Snapshot, or None if absent/mismatched.

    A manifest whose config fingerprint differs from the current run is
    ignored (counting k=31 cannot resume a k=15 snapshot).
    """
    manifest_path = os.path.join(ckpt_dir, MANIFEST)
    table_path = os.path.join(ckpt_dir, TABLE)
    if not (os.path.exists(manifest_path) and os.path.exists(table_path)):
        return None
    with open(manifest_path) as fh:
        manifest = json.load(fh)
    if manifest.get("config") != config_fingerprint(opts):
        return None
    spill_runs = {
        str(p): int(sz) for p, sz in manifest.get("spill_runs", {}).items()
    }
    for p, sz in spill_runs.items():
        if not os.path.exists(p) or os.path.getsize(p) != sz:
            # A listed run vanished or changed: resuming would silently
            # lose its counts — recount from scratch instead.
            import sys

            print(
                f"[checkpoint] ignoring snapshot: spill run {p} missing or "
                "resized since the snapshot was taken",
                file=sys.stderr,
            )
            return None
    with open(table_path, "rb") as fh:
        words, counts = records.parse_records(fh.read(), opts.kmer_length)
    lanes = records.words_to_lanes(words)
    return Snapshot(
        lanes,
        counts,
        int(manifest["reads_absorbed"]),
        manifest.get("files"),
        int(manifest.get("allt", 0)),
        spill_runs,
    )
