"""Prefix-routed merge of per-position partial count tables — counterpart
of kmer_counter_tpu.parallel.shuffle.

Every record goes to the position that owns its key range, and each owner
collapses its range with one ``sort_reduce`` (the multi-lane sort kernel on
the card).  The partition is monotonic in the lead lane, so position d's
range table is entirely below position d+1's, and the global dump is the
range tables concatenated in position order.

The range boundaries are sampled splitters, as in the JAX package: each
position contributes S regular samples of the lead lane of its live rows,
the pooled samples are sorted, and their D-1 quantiles are the boundaries
(sample-sort regular sampling), the same values bit for bit.

The exchange differs from the JAX one, which pads every destination's
bucket to a fixed capacity (XLA's static shapes), detects overflow and
retries at twice the capacity.  A consolidated table is ascending and the
owner is monotonic in the key, so ``searchsorted`` of the splitters over
the live rows cuts each destination's slice, contiguous, with no sort and
no filler; the slice sizes are exchanged first, then the rows with exact
split sizes (``all_to_all_single``; a copy between positions of one
process).  Nothing can overflow, so ``mergeSlack`` has no effect here.
What bounds a position's receive buffers is a row budget instead: where
the splitters crowd more rows into one range than the budget allows, the
range arrives in rounds of sources (plan_route), each sort-reduced on its
own, and the caller merges the pieces (on the host, as spill runs).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from kmer_counter_tpu_torch.ops.sortcount import sort_reduce
from kmer_counter_tpu_torch.ops.u32 import to_numpy, widen
from kmer_counter_tpu_torch.parallel.mesh import Mesh, allgather_host

SPLITTER_SAMPLES = 64  # samples a position contributes (regular sampling)


def sampled_splitters_host(mesh: Mesh, lead_lanes: list, samples: int = SPLITTER_SAMPLES) -> np.ndarray:
    """[D-1] uint32 range boundaries from the pooled samples of every
    position: ``lead_lanes`` holds, for each position this process owns,
    the lead lane of its live rows (ascending, int32 bits).  An empty
    position contributes the maximum value.  The samples of every process
    are pooled, in rank order, so every process computes the same
    splitters."""
    S = samples
    i = np.arange(S, dtype=np.int64)
    local = np.empty((len(lead_lanes), S), np.uint32)
    for row, lane0 in enumerate(lead_lanes):
        U = lane0.shape[0]
        if U == 0:
            local[row] = np.uint32(0xFFFFFFFF)
        else:
            idx = np.minimum(((2 * i + 1) * U) // (2 * S), U - 1)
            local[row] = to_numpy(lane0[torch.from_numpy(idx).to(lane0.device)])
    pooled = np.sort(allgather_host(mesh, local).reshape(-1))
    assert pooled.size == mesh.size * S, (pooled.size, mesh.size, S)
    return pooled[np.arange(1, mesh.size) * S]


def split_sizes(lanes: torch.Tensor, splitters: np.ndarray | None, num_positions: int) -> np.ndarray:
    """Rows of an ascending table (``lanes [NL, U]``) that each position
    owns: [D] int64, the table's contiguous slices in order."""
    U = lanes.shape[1]
    if num_positions == 1:
        return np.array([U], np.int64)
    s = torch.from_numpy(np.asarray(splitters, np.uint32).astype(np.int64)).to(lanes.device)
    edges = torch.searchsorted(widen(lanes[0]), s).cpu().numpy()
    return np.diff(np.concatenate([[0], edges, [U]])).astype(np.int64)


@dataclass
class RoutePlan:
    """Who sends whom how many rows, and in how many rounds.

    ``sizes[i, e]``: rows local position i sends position e (its slice);
    ``every[s, e]``: the same for every position s of the mesh (sizes of
    every process, in rank order); ``groups[e]``: the sources of position
    e, one list a round."""

    sizes: np.ndarray
    every: np.ndarray
    groups: list

    @property
    def rounds(self) -> int:
        return max(len(g) for g in self.groups)

    @property
    def balance(self) -> np.ndarray:
        """Rows each position receives ([D] int64)."""
        return self.every.sum(axis=0)

    def round_rows(self, t: int) -> np.ndarray:
        """``every`` restricted to round t: [D, D], the rows of sources
        outside a destination's group of that round zeroed."""
        out = np.zeros_like(self.every)
        for e, groups in enumerate(self.groups):
            if t < len(groups):
                out[groups[t], e] = self.every[groups[t], e]
        return out


def route_groups(every: np.ndarray, max_rows: int | None) -> list:
    """For each destination position, its sources in rounds: consecutive
    sources whose rows together stay within ``max_rows`` share a round (a
    source whose slice alone passes it has a round of its own); without
    ``max_rows``, one round of every source.  A destination that receives
    nothing has one empty round."""
    out = []
    for e in range(every.shape[1]):
        groups, cur, rows = [], [], 0
        for s_, n in enumerate(every[:, e].tolist()):
            if n == 0:
                continue
            if cur and max_rows is not None and rows + n > max_rows:
                groups.append(cur)
                cur, rows = [], 0
            cur.append(s_)
            rows += n
        groups.append(cur)
        out.append(groups)
    return out


def plan_route(mesh: Mesh, tables: list, splitters: np.ndarray | None, max_rows: int | None = None) -> RoutePlan:
    """The slices of ``tables`` (as route_merge_local) and their rounds:
    a position receives at most ``max_rows`` rows a round (a slice larger
    than that alone excepted), so that the receive buffers and the
    ``sort_reduce`` of a round stay within the memory budget however the
    splitters cut the key space (they are sampled once, from the tables
    of the first route, and the keys that come later may crowd one range).
    Every process computes the same plan (the sizes are pooled on the
    host group)."""
    D = mesh.size
    sizes = np.stack([split_sizes(lanes, splitters, D) for lanes, _ in tables])  # [P, D]
    every = allgather_host(mesh, sizes).reshape(D, D)
    return RoutePlan(sizes, every, route_groups(every, max_rows))


def route_merge_local(mesh: Mesh, tables: list, plan: RoutePlan):
    """Exchange records so that each position holds exactly its key range,
    merged: a generator of pieces.

    ``tables``: for each position this process owns, in order, its live
    rows (``lanes [NL, U] int32``, ``counts [U] int32``, unique and
    ascending: the sort_reduce / consolidation contract).  ``plan``:
    plan_route over them, with the [D-1] splitters (sampled_splitters_host;
    the same on every call of a run, so that spill epochs and the final
    merge cut the same ranges; None when D = 1).

    Yields, round by round, (position, lanes ``[NL, n]``, counts ``[n]``)
    for each position this process owns that receives rows in the round
    (every position in the first): the distinct keys of the rows it
    received, ascending, with their summed counts.  With one round a
    position's piece is its range's table; with several, its pieces
    overlap in keys and merge into it.  Every process draws every piece
    (the rounds are collectives), and copies a piece off the card before
    it draws the next where it would bound the memory.
    """
    P = len(tables)
    NL = tables[0][0].shape[0]
    sizes = plan.sizes
    starts = np.concatenate([np.zeros((P, 1), np.int64), np.cumsum(sizes, axis=1)], axis=1)

    def piece(i, e):  # the rows of local position i that position e owns: (lanes, counts)
        lanes, counts = tables[i]
        return lanes[:, starts[i, e]:starts[i, e + 1]], counts[starts[i, e]:starts[i, e + 1]]

    first = mesh.positions[0]
    for t in range(plan.rounds):
        rows = plan.round_rows(t)  # [source, destination] of this round
        received = _exchange(mesh, piece, rows, NL) if mesh.world > 1 else None
        for j, e in enumerate(mesh.positions):
            n_in = int(rows[:, e].sum())
            if t > 0 and n_in == 0:
                continue
            if received is not None:
                got, received[j] = received[j], None
            else:
                # Each source's rows straight into one buffer (no copy of
                # the whole tables first): [NL+1, n] on its device.
                got = torch.empty((NL + 1, n_in), dtype=torch.int32, device=mesh.device_of(e))
                off = 0
                for i in range(P):
                    if rows[first + i, e]:
                        lanes, counts = piece(i, e)
                        got[:NL, off:off + counts.shape[0]] = lanes
                        got[NL, off:off + counts.shape[0]] = counts
                        off += counts.shape[0]
            lanes, counts, n = sort_reduce(got[:NL], got[NL].contiguous())
            del got
            yield e, lanes[:, :n], counts[:n]


def _exchange(mesh: Mesh, piece, rows: np.ndarray, NL: int):
    """The cross-process part of one round of route_merge_local: one
    ``all_to_all_single`` of rows ``[n, NL+1]`` with exact split sizes.
    ``rows[s, e]``: what source position s sends position e this round.
    The send buffer is ordered (destination rank, destination position,
    source position), so each destination position's rows from one rank
    are contiguous.  Returns, for each position this process owns, the rows
    it received, ``[NL+1, n]`` on its device."""
    import torch.distributed as dist

    P, W = len(mesh.positions), mesh.world
    every = rows.reshape(W, P, -1)  # [rank, local source, destination]
    sizes = every[mesh.rank]
    dev = mesh.local_devices[0]
    order = [(i, e) for s_ in range(W) for e in range(s_ * P, (s_ + 1) * P) for i in range(P) if sizes[i, e]]
    send = torch.empty((int(sizes.sum()), NL + 1), dtype=torch.int32, device=dev)
    off = 0
    for i, e in order:
        lanes, counts = piece(i, e)
        n = counts.shape[0]
        send[off:off + n, :NL] = lanes.t()
        send[off:off + n, NL] = counts
        off += n
    in_splits = [int(sizes[:, s_ * P:(s_ + 1) * P].sum()) for s_ in range(W)]
    mine = slice(mesh.positions[0], mesh.positions[-1] + 1)
    out_splits = [int(every[r][:, mine].sum()) for r in range(W)]
    recv = send.new_empty((sum(out_splits), NL + 1))
    dist.all_to_all_single(recv, send, out_splits, in_splits, group=mesh.group)
    del send
    # Each position's rows: one [NL+1, n] buffer on its device.
    received = []
    for j in range(P):
        pieces, off = [], 0
        for r in range(W):
            before = int(every[r][:, mine][:, :j].sum())
            n = int(every[r][:, mesh.positions[j]].sum())
            pieces.append(recv[off + before:off + before + n])
            off += out_splits[r]
        received.append(torch.cat(pieces).t().contiguous().to(mesh.local_devices[j]))
    return received
