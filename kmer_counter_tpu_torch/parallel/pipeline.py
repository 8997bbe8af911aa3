"""Sharded count tables: data-parallel counting and the prefix-routed
merge — counterpart of kmer_counter_tpu.parallel.pipeline.

Each position of the mesh (parallel.mesh) holds the table of the
single-device engine: ``ShardedCounter2`` an ``ops.table2.TwoLevelTable``
(consolidated through K1, the merge-fold-compact kernel),
``ShardedCounter`` an ``ops.table.CountTable`` (consolidated through
``sort_reduce``, the sort kernel).  A step takes this process's rows of
the global chunk: position d counts rows [d*rpd, (d+1)*rpd) of it, as in
the JAX package, so every position's table, and the sampled splitters,
are the JAX package's.  The finalize routes every record to its
key-range owner (parallel.shuffle); concatenated in position order the
range tables are the globally sorted table.

Host-facing contract, as in the JAX package: the host mirrors the bounds
that decide every consolidation, growth and spill (the raw offset, the
largest live count of any position after a consolidation), and takes the
global max over processes, so that every process reaches the same
decision in lockstep.  Unlike the JAX package, an empty prefix slot holds
the sentinel key (at creation, growth, resume and reset), so the prefix
stays ascending as K1 requires; the JAX mesh pads with key 0.

``consolidate(cap, spill)`` takes the engine's spill decision
(``budget.next_prefix`` / ``budget.next_capacity``): where growing for the
next chunk would pass ``cap``, ``spill(counter)`` writes the consolidated
state out first (``live_runs`` or ``route_live``), and the counter then
empties it.
"""

from __future__ import annotations

import numpy as np
import torch

from kmer_counter_tpu_torch import budget as bg
from kmer_counter_tpu_torch.ops import table as t1
from kmer_counter_tpu_torch.ops import table2 as t2
from kmer_counter_tpu_torch.ops.pipeline import count_step_two_level, extract_chunk
from kmer_counter_tpu_torch.ops.u32 import MASK, SENTINEL, from_numpy, to_numpy
from kmer_counter_tpu_torch.parallel.mesh import Mesh, global_max_int, global_sum_int
from kmer_counter_tpu_torch.parallel.shuffle import plan_route, route_merge_local, sampled_splitters_host
from kmer_counter_tpu_torch.records import active_lanes


class _Sharded:
    """What both counters share: the rows of each position, the frozen
    splitters, the route and the exports.  A subclass provides
    ``live_tables()`` (each position's consolidated live rows as device
    tensors) and ``_consolidated()`` (merges what is pending)."""

    def __init__(self, mesh: Mesh, k: int, canonical: bool, reads_per_device: int, line_length: int):
        self.mesh = mesh
        self.k = k
        self.canonical = canonical
        self.D = mesh.size
        self.NL = active_lanes(k)
        self.reads_per_device = reads_per_device
        self.line_length = line_length
        self.chunk_slots = reads_per_device * (line_length - k + 1)
        if self.chunk_slots <= 0:
            raise ValueError("line_length shorter than k")
        # Frozen splitters ([D-1] uint32): set at the first route and
        # reused, so spill epochs and the final merge cut the same ranges.
        self.splitters = None
        self.balance = None  # rows each position received at the last route
        self.most_rounds = 0  # the most rounds any route took
        self.position_consolidations = 0  # consolidations summed over this process's positions

    def _device_rows(self, reads):
        """This process's rows of the chunk on each position's device: the
        per-position views that the engine's feed placed there
        (feed.ChunkFeed: one pinned copy a card, on its copy stream), or, on
        CPU positions, a host array ``[P*rpd, L] uint8`` viewed in place."""
        if isinstance(reads, list):
            return reads
        if any(d.type != "cpu" for d in self.mesh.local_devices):
            raise TypeError("host rows reach a card only through feed.ChunkFeed")
        rpd = self.reads_per_device
        reads = torch.from_numpy(np.ascontiguousarray(reads))
        return [reads[i * rpd:(i + 1) * rpd] for i in range(len(self.mesh.local_devices))]

    def _ensure_splitters(self):
        """Sample and freeze the splitters at the first route, from the
        live tables as they stand (every process in lockstep; the samples
        are pooled on the host group)."""
        if self.D > 1 and self.splitters is None:
            self.splitters = sampled_splitters_host(self.mesh, [lanes[0] for lanes, _ in self.live_tables()])
        return self.splitters

    def _plan(self, max_rows=None):
        tables = self.live_tables()
        return tables, plan_route(self.mesh, tables, self._ensure_splitters(), max_rows)

    def route_rounds(self, max_rows: int) -> int:
        """The rounds a route of the live tables as they stand would take
        with at most ``max_rows`` rows a position a round (a collective)."""
        rounds = self._plan(max_rows)[1].rounds
        self.most_rounds = max(self.most_rounds, rounds)
        return rounds

    def route_live(self, max_rows: int | None = None) -> list[tuple[int, np.ndarray, np.ndarray]]:
        """The cross-position merge of the live tables as they stand (no
        consolidation: a spill routes the consolidated rows while raw rows
        wait): (position, keys ``[U, NL]`` row-major, counts ``[U]``) of
        each key range this process owns (parallel.shuffle), a range in
        several pieces (each sorted and unique, their keys overlapping)
        where its rows pass ``max_rows`` (each piece is copied to the host
        before the next round)."""
        tables, plan = self._plan(max_rows)
        self.balance = plan.balance
        self.most_rounds = max(self.most_rounds, plan.rounds)
        return [(pos, to_numpy(lanes).T, to_numpy(counts))
                for pos, lanes, counts in route_merge_local(self.mesh, tables, plan)]

    def finalize_local(self, max_rows: int | None = None) -> list[tuple[int, np.ndarray, np.ndarray]]:
        """Merge what is pending, then route: (position, keys ``[U, NL]``
        row-major, counts ``[U]``) of the key ranges this process owns, in
        pieces as route_live; concatenated over every process in position
        order, one piece a range, they are the globally sorted table."""
        self._consolidated()
        return self.route_live(max_rows)

    def finalize(self) -> tuple[np.ndarray, np.ndarray]:
        """The merged table of a one-process mesh: (keys ``[U, NL]``
        row-major, counts ``[U]``), globally sorted.  The all-T side count
        is not included (allt_total)."""
        if self.mesh.world > 1:
            raise RuntimeError("finalize() gathers every range: one process only (use finalize_local)")
        parts = self.finalize_local()
        return (np.concatenate([p[1] for p in parts]).reshape(-1, self.NL),
                np.concatenate([p[2] for p in parts]))

    def live_runs(self) -> list[tuple[np.ndarray, np.ndarray]]:
        """Each position's live table as it stands, as a sorted run: (keys
        ``[U, NL]`` row-major, counts ``[U]``)."""
        return [(to_numpy(lanes).T, to_numpy(counts)) for lanes, counts in self.live_tables()]

    def local_tables(self) -> list[tuple[np.ndarray, np.ndarray]]:
        """Each position's consolidated table as a sorted run: (keys
        ``[U, NL]`` row-major, counts ``[U]``), no collective beyond the
        bounds' agreement."""
        self._consolidated()
        return self.live_runs()

    def export_positions(self) -> list[tuple[int, np.ndarray, np.ndarray, int]]:
        """Checkpoint export: (position, keys ``[U, NL]`` row-major, counts
        ``[U]``, all-T count) for each position this process owns."""
        self._consolidated()
        return [(pos, to_numpy(lanes).T, to_numpy(counts), allt)
                for pos, (lanes, counts), allt in zip(self.mesh.positions, self.live_tables(), self._allts())]

    def _allts(self) -> list[int]:
        return [0] * len(self.mesh.positions)

    def allt_total(self) -> int:
        """The all-T side count summed over every position (mod 2^32 where
        it is written)."""
        return global_sum_int(self.mesh, sum(self._allts()))

    def _by_pos(self, items):
        """{position: (keys [U, NL], counts [U], allt)} of a snapshot's
        items, and the most rows any position of any process holds."""
        by_pos = {pos: (lanes, counts, allt) for pos, lanes, counts, allt in items}
        max_u = global_max_int(self.mesh, max((len(c) for _, c, _ in by_pos.values()), default=0))
        return by_pos, max_u


class ShardedCounter2(_Sharded):
    """Two-level table on each position: a keys-only raw region that the
    chunk step appends to, and a sorted prefix that K1 merges it into."""

    def __init__(self, mesh: Mesh, k: int, canonical: bool, prefix_slots: int, raw_slots: int,
                 reads_per_device: int, line_length: int):
        super().__init__(mesh, k, canonical, reads_per_device, line_length)
        self.CP = max(prefix_slots, 1)
        self.CR = max(raw_slots, self.chunk_slots)
        self.raw_bound = 0  # raw slots in use (host-mirrored, exact, the same on every position)
        self.live_bound = 0  # the most live prefix rows of any position (exact)
        self.live = [0] * len(mesh.positions)  # each position's live prefix rows
        self.tables = [t2.make_table2(self.CP, self.CR, self.NL, d) for d in mesh.local_devices]

    def step(self, reads):
        """Count one chunk: this process's rows (``_device_rows``)."""
        if self.pending_consolidation():
            self.consolidate()
        for table, rows in zip(self.tables, self._device_rows(reads)):
            count_step_two_level(table, rows, self.k, self.canonical)
        self.raw_bound += self.chunk_slots

    def pending_consolidation(self) -> bool:
        """True when the next step() consolidates first."""
        return self.raw_bound + self.chunk_slots > self.CR

    def occupied_bound(self) -> int:
        """Bound on any position's live records (host-mirrored)."""
        return self.live_bound + self.raw_bound

    def consolidate(self, cap: int | None = None, spill=None):
        """Merge every position's raw region into its prefix (K1).  The
        prefix is sized first so that it cannot truncate
        (``budget.next_prefix``: geometric growth; with a ``cap``, where
        the grown prefix would pass it, ``spill(self)`` writes the live
        prefix rows out and the prefix empties instead)."""
        new_cp, do_spill = bg.next_prefix(cap, self.CP, self.live_bound, self.raw_bound)
        if do_spill:
            spill(self)
            self._empty_prefixes()
        if new_cp > self.CP:
            for i in range(len(self.tables)):
                self.tables[i] = t2.grow2(self.tables[i], new_cp, self.CR)
            self.CP = new_cp
        lives, lost = [], 0
        for i in range(len(self.tables)):
            self.tables[i], live, lost_i = t2.consolidate3(self.tables[i])
            self.position_consolidations += 1
            lives.append(live)
            lost = max(lost, lost_i)
        if global_max_int(self.mesh, lost) > 0:
            raise RuntimeError("mesh consolidation truncated live records: prefix pre-grow invariant violated")
        self.live = lives
        self.live_bound = global_max_int(self.mesh, max(lives))
        self.raw_bound = 0

    def _consolidated(self):
        if self.raw_bound > 0:
            self.consolidate()

    def live_tables(self):
        return [(t.prefix_lanes[:, :u], t.prefix_counts[:u]) for t, u in zip(self.tables, self.live)]

    def _allts(self):
        return [int(t.allt) & MASK for t in self.tables]

    def _empty_prefixes(self):
        """The live rows become sentinel rows with count 0 (the rows after
        them are already)."""
        for t, u in zip(self.tables, self.live):
            t.prefix_lanes[:, :u] = SENTINEL
            t.prefix_counts[:u] = 0
        self.live = [0] * len(self.tables)
        self.live_bound = 0

    def close(self, cap: int | None = None, spill=None):
        """Merge the raw regions (under ``cap``, as consolidate) and free
        them: the state the finalize routes or the spill merge reads."""
        if self.raw_bound > 0:
            self.consolidate(cap, spill)
        for t in self.tables:
            t.raw_lanes = t.raw_lanes.new_empty((self.NL, 0))
        self.CR = 0

    def reset(self):
        """Empty the table (after a spill), keeping its buffers and the
        all-T side count: every prefix slot holds the sentinel key with
        count 0, as at creation (the JAX reset zeroes only the counts)."""
        self._empty_prefixes()
        for t in self.tables:
            t.raw_off = 0
        self.raw_bound = 0

    def _set_prefixes(self, by_pos, cp: int):
        """Fresh prefixes of ``cp`` slots holding each position's rows of
        ``by_pos``, then sentinel rows with count 0 (the JAX restore pads
        with key 0), and its all-T count."""
        self.CP = cp
        for i, pos in enumerate(self.mesh.positions):
            rows, counts, allt = by_pos.get(pos, (np.zeros((0, self.NL), np.uint32), np.zeros(0, np.uint32), 0))
            u = len(counts)
            lanes = np.full((self.NL, cp), 0xFFFFFFFF, np.uint32)
            cnt = np.zeros(cp, np.uint32)
            lanes[:, :u] = np.asarray(rows, np.uint32)[:, :self.NL].T
            cnt[:u] = counts
            dev = self.mesh.local_devices[i]
            t = self.tables[i]
            self.tables[i] = t2.TwoLevelTable(from_numpy(lanes, dev), from_numpy(cnt, dev), t.raw_lanes, 0,
                                              torch.tensor(int(allt), dtype=torch.int64, device=dev))
            self.live[i] = u
        self.live_bound = global_max_int(self.mesh, max(self.live))
        self.raw_bound = 0

    def import_positions(self, items, splitters=None, cap: int | None = None, spill=None):
        """Checkpoint restore, the inverse of export_positions (every
        process in lockstep, with its own positions' items).  Where a
        prefix that holds the snapshot would pass ``cap``, the rows spill
        at once (``spill(self)``) and the prefix starts empty."""
        by_pos, max_u = self._by_pos(items)
        new_cp, do_spill = bg.next_prefix(cap, self.CP, max_u, 0)
        if splitters is not None:
            self.splitters = np.asarray(splitters, np.uint32)
        self._set_prefixes(by_pos, max(new_cp, max_u))
        if do_spill:
            spill(self)
            self._set_prefixes({pos: (by_pos[pos][0][:0], by_pos[pos][1][:0], by_pos[pos][2]) for pos in by_pos},
                               new_cp)


class ShardedCounter(_Sharded):
    """One-level table on each position: an append buffer of (key, 0/1
    count) rows, collapsed by ``sort_reduce`` (the sort kernel)."""

    def __init__(self, mesh: Mesh, k: int, canonical: bool, table_slots: int, reads_per_device: int,
                 line_length: int):
        super().__init__(mesh, k, canonical, reads_per_device, line_length)
        if self.chunk_slots > table_slots:
            raise ValueError("per-position chunk exceeds table capacity")
        self.table_slots = table_slots
        self.host_bound = 0  # slots in use on any position (exact after a consolidation)
        self._appended = False  # rows appended since the last consolidation
        self.tables = [t1.make_table(table_slots, self.NL, d) for d in mesh.local_devices]

    def step(self, reads):
        """Count one chunk: this process's rows (``_device_rows``)."""
        if self.pending_consolidation():
            self.consolidate()
        for table, rows in zip(self.tables, self._device_rows(reads)):
            t1.append(table, *extract_chunk(rows, self.k, self.canonical))
        self.host_bound += self.chunk_slots
        self._appended = True

    def pending_consolidation(self) -> bool:
        return self.host_bound + self.chunk_slots > self.table_slots

    def occupied_bound(self) -> int:
        return self.host_bound

    def _consolidated(self):
        if not self._appended:
            return
        for i in range(len(self.tables)):
            self.tables[i] = t1.consolidate(self.tables[i])
        self.position_consolidations += len(self.tables)
        self.host_bound = global_max_int(self.mesh, max(t.offset for t in self.tables))
        self._appended = False

    def consolidate(self, cap: int | None = None, spill=None):
        """Collapse every position's table, then make room for the next
        chunk (``budget.next_capacity``: doubling; with a ``cap``, where the
        grown table would pass it, ``spill(self)`` writes the tables out
        and they empty instead)."""
        self._consolidated()
        need = self.host_bound + self.chunk_slots
        if need <= self.table_slots:
            return
        grown, do_spill = bg.next_capacity(cap, self.table_slots, need)
        if do_spill:
            spill(self)
            self.reset()
            grown, _ = bg.next_capacity(None, self.table_slots, self.chunk_slots)
        if grown > self.table_slots:
            for i in range(len(self.tables)):
                self.tables[i] = t1.grow(self.tables[i], grown)
            self.table_slots = grown

    def live_tables(self):
        return [(t.lanes[:, :t.offset], t.counts[:t.offset]) for t in self.tables]

    def close(self, cap: int | None = None, spill=None):
        """Collapse what was appended (no growth follows)."""
        del cap, spill
        self._consolidated()

    def reset(self):
        """Empty the tables (after a spill), keeping their buffers."""
        for t in self.tables:
            t.counts.zero_()
            t.offset = 0
        self.host_bound = 0

    def _set_tables(self, by_pos, slots: int):
        self.table_slots = slots
        for i, pos in enumerate(self.mesh.positions):
            rows, counts = by_pos[pos][:2] if pos in by_pos else (np.zeros((0, self.NL), np.uint32), [])
            u = len(counts)
            lanes = np.zeros((self.NL, slots), np.uint32)
            cnt = np.zeros(slots, np.uint32)
            lanes[:, :u] = np.asarray(rows, np.uint32)[:, :self.NL].T
            cnt[:u] = counts
            dev = self.mesh.local_devices[i]
            self.tables[i] = t1.CountTable(from_numpy(lanes, dev), from_numpy(cnt, dev), u)
        self.host_bound = global_max_int(self.mesh, max(t.offset for t in self.tables))

    def import_positions(self, items, splitters=None, cap: int | None = None, spill=None):
        """Checkpoint restore (see ShardedCounter2.import_positions): the
        tables double until the snapshot and a chunk fit; past ``cap`` the
        snapshot's rows spill at once and the tables start empty."""
        by_pos, max_u = self._by_pos(items)
        grown, do_spill = bg.next_capacity(cap, self.table_slots, max_u + self.chunk_slots)
        if splitters is not None:
            self.splitters = np.asarray(splitters, np.uint32)
        if not do_spill:
            self._set_tables(by_pos, grown)
            return
        slots = self.table_slots
        self._set_tables(by_pos, bg.next_capacity(None, slots, max_u)[0])
        spill(self)
        self._set_tables({}, slots)
