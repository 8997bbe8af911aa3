"""The mesh of the count engine — counterpart of
kmer_counter_tpu.parallel.mesh.

A mesh is an ordered list of *positions*, each on a ``torch.device``.
Reads are data-parallel across the positions during counting, and the
k-mer key space is range-partitioned across them during the merge
(parallel.shuffle).  Every process owns the same number of positions, in
rank order: rank r owns positions [r*P, (r+1)*P).  Positions may share a
device (several positions on one card, or eight on the CPU, as the JAX
tests' eight virtual CPU devices); the exchange between positions of one
process is a copy, and between processes an ``all_to_all_single``.

Collectives: the data exchange runs on the default process group (NCCL
for cuda positions unless the caller set up another); host agreements
(ints, flags, splitter samples) run on a gloo group, which is the default
group itself when that is gloo.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass, field

import numpy as np
import torch

# How long a collective may wait for the other processes before it fails.
DEFAULT_TIMEOUT = datetime.timedelta(seconds=600)


@dataclass
class Mesh:
    """Positions in order, the devices of this process's positions, and
    the process groups of the exchange (None: one process)."""

    local_devices: list  # torch.device of each position this process owns
    rank: int = 0
    world: int = 1
    group: object = None  # data exchange (all_to_all_single)
    host_group: object = None  # host agreements (gloo)
    positions: list = field(init=False)

    def __post_init__(self):
        P = len(self.local_devices)
        if P < 1:
            raise ValueError("a mesh needs at least one position")
        self.positions = list(range(self.rank * P, (self.rank + 1) * P))

    @property
    def size(self) -> int:
        """D: positions of the whole mesh."""
        return len(self.local_devices) * self.world

    def device_of(self, pos: int) -> torch.device:
        return self.local_devices[pos - self.positions[0]]


def init_distributed(device_type: str = "cuda") -> None:
    """Join the process group that torchrun's variables describe (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT), unless a group exists already
    (a caller that set one up is used as it is) or there is one process.
    NCCL for cuda positions, gloo for the CPU; no other backend is tried."""
    import torch.distributed as dist

    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return
    dist.init_process_group(backend="nccl" if device_type == "cuda" else "gloo", init_method="env://",
                            timeout=DEFAULT_TIMEOUT)


def make_mesh(num_positions: int | None = None, devices=None, device_type: str = "cuda") -> Mesh:
    """The mesh of this process.

    ``devices``: the devices of this process's positions, in order (they
    may repeat).  Without them, one process takes the first
    ``num_positions`` visible cards (all of them when None; the CPU is one
    device), as the JAX version takes the first devices: meshShape=4 on a
    one-card machine is a one-position mesh.  With several processes each
    takes ``num_positions / world`` cards (one when None) from its
    LOCAL_RANK on.
    """
    import torch.distributed as dist

    init_distributed(device_type if devices is None else torch.device(devices[0]).type)
    rank, world = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
    if devices is None:
        visible = torch.cuda.device_count() if device_type == "cuda" else 1
        if world > 1:
            per = max((num_positions or world) // world, 1)
            first = int(os.environ.get("LOCAL_RANK", "0")) * per
            if device_type == "cpu":
                devices = [torch.device("cpu")] * per
            else:
                devices = [torch.device(device_type, first + i) for i in range(per)]
        else:
            n = min(num_positions or visible, visible)
            devices = ([torch.device("cpu")] if device_type == "cpu"
                       else [torch.device(device_type, i) for i in range(max(n, 1))])
    devices = [torch.device(d) for d in devices]
    group = host_group = None
    if world > 1:
        group = dist.group.WORLD
        host_group = group if dist.get_backend() == "gloo" else dist.new_group(backend="gloo", timeout=DEFAULT_TIMEOUT)
    return Mesh(devices, rank, world, group, host_group)


def allgather_host(mesh: Mesh, local: np.ndarray) -> np.ndarray:
    """``local`` (the same shape and dtype on every process) from every
    process, stacked in rank order: [world, *local.shape].  One process:
    ``local[None]``."""
    local = np.ascontiguousarray(local)
    if mesh.world <= 1:
        return local[None]
    import torch.distributed as dist

    t = torch.from_numpy(local.view(np.uint8).reshape(-1).copy())
    out = [torch.empty_like(t) for _ in range(mesh.world)]
    dist.all_gather(out, t, group=mesh.host_group)
    return np.stack([o.numpy().view(local.dtype).reshape(local.shape) for o in out])


def global_max_int(mesh: Mesh, x: int) -> int:
    """The max of a per-process int over every process (host-mirrored
    bounds gate the next collective, so every process must agree)."""
    return int(allgather_host(mesh, np.array([x], np.int64)).max())


def global_sum_int(mesh: Mesh, x: int) -> int:
    return int(allgather_host(mesh, np.array([x], np.int64)).sum())


def global_any(mesh: Mesh, flag: bool) -> bool:
    return bool(allgather_host(mesh, np.array([flag], np.bool_)).any())
