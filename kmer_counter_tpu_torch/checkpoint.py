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

The port's own copy of kmer_counter_tpu/checkpoint.py, with the mesh
snapshots (``MeshSnapshot``, ``mesh_save``, ``mesh_load``) of the mesh
engine; their rank and process count come from torch.distributed (or are
passed in) where the JAX version asks jax.  The files are the same, byte
for byte, so either package resumes the other's snapshot.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple

import numpy as np

from kmer_counter_tpu_torch import records

MANIFEST = "checkpoint.json"
TABLE = "table.bin"

# Mesh checkpoints (MeshCountEngine): one table file per mesh position and
# one manifest per process, both stamped with the epoch (the consolidation
# count at snapshot time).  A resume candidate epoch is valid only when
# EVERY process committed its manifest at that epoch — a crash mid-save
# leaves the previous epoch intact and loadable.  Requires a directory
# shared by all processes.
MESH_MANIFEST = "mesh.e{epoch:06d}.p{proc:03d}.json"
MESH_TABLE = "mesh.e{epoch:06d}.pos{pos:05d}.bin"
_MESH_KEEP_EPOCHS = 2

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


class MeshSnapshot(NamedTuple):
    """A loaded mesh checkpoint (this process's view)."""

    epoch: int  # consolidation count at snapshot time
    items: list  # [(pos, lanes [U, NL] row-major, counts [U], allt)]
    reads_absorbed: int  # reads THIS process had absorbed
    files: dict  # this process's per-file absorbed reads
    splitters: list | None  # frozen route splitters (None: not yet frozen)
    pos_runs: dict  # {pos: [run paths]} multi-process spill state
    scheduler_runs: dict  # {path: size} single-process spill state


def mesh_config_fingerprint(opts, mesh_size: int, processes: int) -> dict:
    fp = config_fingerprint(opts)
    fp["mesh_devices"] = int(mesh_size)
    fp["processes"] = int(processes)
    return fp


def _rank_world(process, processes) -> tuple[int, int]:
    """This process's rank and the process count: as given, else from
    torch.distributed (0 and 1 without a process group)."""
    if process is None or processes is None:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank(), dist.get_world_size()
        return 0, 1
    return int(process), int(processes)


def mesh_save(
    ckpt_dir: str,
    opts,
    epoch: int,
    items,
    reads_absorbed: int,
    files: dict,
    mesh_size: int,
    splitters=None,
    pos_runs: dict | None = None,
    scheduler_runs: list | None = None,
    process: int | None = None,
    processes: int | None = None,
) -> None:
    """Write this process's shard of a mesh checkpoint at ``epoch``.

    Every process calls this in lockstep (the trigger is host-mirrored
    consolidation state).  Per-position tables are written first
    (tmp+rename), the per-process manifest last, so a crash mid-save can
    never produce a manifest that references missing/partial tables; a
    crash before every process commits leaves the epoch incomplete, and
    mesh_load falls back to the newest COMPLETE epoch.  Old epochs are
    pruned after commit (keep the last _MESH_KEEP_EPOCHS).
    """
    import glob
    import sys

    proc, nproc = _rank_world(process, processes)
    os.makedirs(ckpt_dir, exist_ok=True)
    positions = {}
    for pos, lanes, counts, allt in items:
        words = records.lanes_to_words(np.asarray(lanes))
        data = records.serialize_table(words, np.asarray(counts))
        path = os.path.join(ckpt_dir, MESH_TABLE.format(epoch=epoch, pos=pos))
        with open(path + ".tmp", "wb") as fh:
            fh.write(data)
        os.replace(path + ".tmp", path)
        positions[str(pos)] = {"records": int(len(counts)), "allt": int(allt)}
    manifest = {
        "config": mesh_config_fingerprint(
            opts, mesh_size, nproc
        ),
        "epoch": int(epoch),
        "process": int(proc),
        "reads_absorbed": int(reads_absorbed),
        "files": {k: int(v) for k, v in (files or {}).items()},
        "positions": positions,
    }
    if splitters is not None:
        manifest["splitters"] = [int(s) for s in np.asarray(splitters)]
    if pos_runs:
        manifest["pos_runs"] = {
            str(pos): {
                os.path.abspath(p): os.path.getsize(p) for p in paths
            }
            for pos, paths in pos_runs.items()
        }
    if scheduler_runs:
        manifest["scheduler_runs"] = {
            os.path.abspath(p): os.path.getsize(p) for p in scheduler_runs
        }
    mpath = os.path.join(
        ckpt_dir, MESH_MANIFEST.format(epoch=epoch, proc=proc)
    )
    with open(mpath + ".tmp", "w") as fh:
        json.dump(manifest, fh)
    os.replace(mpath + ".tmp", mpath)
    # Prune this process's old epochs (manifests + the positions it owns).
    floor = epoch - _MESH_KEEP_EPOCHS
    for old in glob.glob(os.path.join(ckpt_dir, "mesh.e*.p*.json")):
        base = os.path.basename(old)
        try:
            e = int(base.split(".")[1][1:])
            p = int(base.split(".")[2][1:])
        except (IndexError, ValueError):
            continue
        if p == proc and e <= floor:
            try:
                os.remove(old)
                for pos in positions:
                    tp = os.path.join(
                        ckpt_dir, MESH_TABLE.format(epoch=e, pos=int(pos))
                    )
                    if os.path.exists(tp):
                        os.remove(tp)
            except OSError as exc:
                print(f"[checkpoint] prune: {exc}", file=sys.stderr)


def mesh_load(
    ckpt_dir: str, opts, mesh_size: int, my_positions: list,
    process: int | None = None, processes: int | None = None,
) -> "MeshSnapshot | None":
    """Load the newest COMPLETE mesh checkpoint epoch, or None.

    Complete = every process committed its manifest at that epoch with a
    matching config fingerprint, every table file this process needs
    exists, and every recorded spill run still exists at its recorded
    size.  All processes scan the same shared directory, so they pick the
    same epoch deterministically; the engine double-checks in lockstep.
    """
    import glob
    import sys

    proc, nproc = _rank_world(process, processes)
    by_epoch: dict[int, set] = {}
    for path in glob.glob(os.path.join(ckpt_dir, "mesh.e*.p*.json")):
        base = os.path.basename(path)
        try:
            e = int(base.split(".")[1][1:])
            p = int(base.split(".")[2][1:])
        except (IndexError, ValueError):
            continue
        by_epoch.setdefault(e, set()).add(p)
    want_fp = mesh_config_fingerprint(opts, mesh_size, nproc)
    for epoch in sorted(by_epoch, reverse=True):
        if by_epoch[epoch] != set(range(nproc)):
            continue
        try:
            manifests = []
            for p in range(nproc):
                with open(
                    os.path.join(
                        ckpt_dir, MESH_MANIFEST.format(epoch=epoch, proc=p)
                    )
                ) as fh:
                    manifests.append(json.load(fh))
        except (OSError, ValueError):
            continue
        if any(m.get("config") != want_fp for m in manifests):
            continue
        mine = manifests[proc]
        if sorted(int(p) for p in mine["positions"]) != sorted(my_positions):
            print(
                "[checkpoint] ignoring mesh snapshot: position ownership "
                "changed (mesh/process layout differs from the snapshot)",
                file=sys.stderr,
            )
            return None
        ok = True
        for runs in (
            [mine.get("scheduler_runs", {})]
            + list(mine.get("pos_runs", {}).values())
        ):
            for p, sz in runs.items():
                if not os.path.exists(p) or os.path.getsize(p) != int(sz):
                    print(
                        f"[checkpoint] ignoring mesh snapshot: spill run {p}"
                        " missing or resized",
                        file=sys.stderr,
                    )
                    ok = False
        if not ok:
            return None
        items = []
        for pos_s, meta in mine["positions"].items():
            pos = int(pos_s)
            path = os.path.join(
                ckpt_dir, MESH_TABLE.format(epoch=epoch, pos=pos)
            )
            if not os.path.exists(path):
                ok = False
                break
            with open(path, "rb") as fh:
                words, counts = records.parse_records(
                    fh.read(), opts.kmer_length
                )
            if len(counts) != int(meta["records"]):
                ok = False
                break
            items.append(
                (pos, records.words_to_lanes(words), counts, int(meta["allt"]))
            )
        if not ok:
            continue
        return MeshSnapshot(
            epoch=epoch,
            items=items,
            reads_absorbed=int(mine["reads_absorbed"]),
            files=mine.get("files", {}),
            splitters=mine.get("splitters"),
            pos_runs={
                int(pos): list(runs)
                for pos, runs in mine.get("pos_runs", {}).items()
            },
            scheduler_runs={
                str(p): int(sz)
                for p, sz in mine.get("scheduler_runs", {}).items()
            },
        )
    return None
