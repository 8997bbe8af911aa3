"""The asynchronous chunk feed: pinned staging in the ingest thread, the
copy to the card on a stream of its own, and one device buffer a card,
ordered by events.

The counterpart of the JAX engine's ``jax.device_put(reads, self.device)``
(kmer_counter_tpu/engine.py:450) and of the mesh's placement
(kmer_counter_tpu/parallel/pipeline.py:77, :94), which return before the
copy ends; the JAX package has no module of this name.

A ring of ``depth`` host slots, each ``rows x width`` bytes (page-locked on
a card), is allocated once a run on the main thread, before the ingest
thread starts.  The ingest thread takes a free slot (``acquire``), fills
it (``stage``: the chunk's rows, then zero bytes, which encode as invalid
bases) and queues it.  The main thread ``upload``s it: on each card's copy
stream, one copy of each run of that card's positions into the card's one
device buffer, then the slot's copy-done event for that card; then the
slot goes back to the free list.  The compute stream (the current stream)
waits on that event before the step; after the step the main thread marks
the buffer ``consumed``.  Positions that share a card share its buffer and
its copy.

Invariants (tests/test_torch_feed.py checks them with stand-in events,
tests/test_torch_cuda.py on the card):

  (a) a slot is written only after its copy-done events have completed:
      ``acquire`` waits on them in the ingest thread, and the main thread
      records them before it hands the slot back through the free-list
      queue (never by ring position);
  (b) a device buffer is written only after the consumed event of its last
      reader: recorded on the compute stream after the step that read it,
      or, for a buffer just allocated, at its allocation (the memory may
      have served the compute stream's earlier work);
  (c) every step is ordered after its own copy: the compute stream waits
      on the copy-done event;
  (d) nothing on the chunk path synchronises the card or copies from
      pageable memory: the only host waits are (a)'s, in the ingest thread.

On the CPU the slots are plain memory, ``upload`` hands out
``torch.from_numpy`` views of the slot's rows and the slot returns to the
free list at ``consumed``: no stream, no event, nothing pinned.  That path
is taken because the device is the CPU; a failure to pin or a CUDA error
raises and nothing falls back to a pageable copy.
"""

from __future__ import annotations

import queue

import numpy as np
import torch


class CudaOps:
    """The CUDA calls the feed makes, in one place, so that a test can put
    stand-ins that record their order in its place."""

    @staticmethod
    def event():
        # blocking: the ingest thread sleeps in synchronize() rather than spin
        return torch.cuda.Event(blocking=True)

    @staticmethod
    def stream(device):
        return torch.cuda.Stream(device)

    @staticmethod
    def current_stream(device):
        return torch.cuda.current_stream(device)

    @staticmethod
    def pinned(nbytes: int) -> torch.Tensor:
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)

    @staticmethod
    def device_buffer(nbytes: int, device, copy_stream) -> torch.Tensor:
        buf = torch.empty(nbytes, dtype=torch.uint8, device=device)
        buf.record_stream(copy_stream)  # its memory is reused only after the copies into it
        return buf

    @staticmethod
    def copy(stream, dst: torch.Tensor, src: torch.Tensor):
        with torch.cuda.stream(stream):
            dst.copy_(src, non_blocking=True)


class Slot:
    """A staging slot of the ring: ``host`` (flat uint8, pinned on a card)
    and its NumPy view, the width its chunk was staged at, and one
    copy-done event a card (none on the CPU)."""

    def __init__(self, host: torch.Tensor, copied: list):
        self.host = host
        self.array = host.numpy()
        self.copied = copied
        self.width = 0


class _Card:
    """One card of the feed: its copy stream, its device buffer (its
    positions' rows in position order, allocated at the first upload) and
    the buffer's consumed event; ``runs`` are the copies a chunk takes,
    (first row in the slot, first row in the buffer, rows)."""

    def __init__(self, ops, device: torch.device, rows: int, width: int, runs: list):
        self.ops, self.device, self.nbytes, self.runs = ops, device, rows * width, runs
        self.stream = ops.stream(device)
        self.consumed = ops.event()
        self.buf = None

    def buffer(self) -> torch.Tensor:
        if self.buf is None:
            self.buf = self.ops.device_buffer(self.nbytes, self.device, self.stream)
            self.consumed.record(self.ops.current_stream(self.device))  # (b) for fresh memory
        return self.buf


class ChunkFeed:
    """The feed of one run: positions on ``devices`` (one for the
    single-device engine), each taking ``rows_per_position`` rows of a
    chunk in order; slots ``width`` bytes a row (the longest usable line
    length), ``depth`` of them.  ``ops``: the CUDA calls (CudaOps)."""

    def __init__(self, devices, rows_per_position: int, width: int, depth: int, ops=CudaOps):
        devices = [torch.device(d) for d in devices]
        self.rows_per_position = rows_per_position
        self.positions = len(devices)
        self.rows = rows_per_position * self.positions
        self.width = width
        self.ops = ops
        self.on_cpu = all(d.type == "cpu" for d in devices)
        if not self.on_cpu and any(d.type != "cuda" for d in devices):
            raise ValueError(f"a feed serves CUDA devices or the CPU, not {devices}")
        nbytes = self.rows * width
        self._cards: list[_Card] = []
        self._where: list[tuple] = []  # each position's (card, index among the card's positions)
        if self.on_cpu:
            slots = [Slot(torch.from_numpy(np.empty(nbytes, np.uint8)), []) for _ in range(depth)]
        else:
            by_device: dict[torch.device, list[int]] = {}
            for p, d in enumerate(devices):
                by_device.setdefault(d, []).append(p)
            cards = {}
            for d, positions in by_device.items():
                runs = []
                for j, p in enumerate(positions):
                    row, at = p * rows_per_position, j * rows_per_position
                    if runs and runs[-1][0] + runs[-1][2] == row and runs[-1][1] + runs[-1][2] == at:
                        runs[-1][2] += rows_per_position
                    else:
                        runs.append([row, at, rows_per_position])
                cards[d] = _Card(ops, d, len(positions) * rows_per_position, width, runs)
                self._cards.append(cards[d])
            self._where = [(cards[d], by_device[d].index(p)) for p, d in enumerate(devices)]
            slots = [Slot(ops.pinned(nbytes), [ops.event() for _ in self._cards]) for _ in range(depth)]
        self._free: queue.Queue = queue.Queue()
        for slot in slots:
            self._free.put(slot)
        self._held: list[Slot] = []  # CPU: the slot the step reads, until consumed
        self._zeros = None  # CPU: the zero chunk
        self._zeroed = False  # a card: the buffers hold the zero chunk
        self._closed = False

    # ---- the ingest thread ------------------------------------------------

    def acquire(self) -> Slot | None:
        """A free slot once its copies have completed (a), or None once the
        feed is closed (blocks while every slot is in use)."""
        slot = None if self._closed else self._free.get()
        if slot is None:
            return None
        for event in slot.copied:
            event.synchronize()
        return slot

    def stage(self, slot: Slot, reads: np.ndarray, width: int):
        """Copy a chunk's rows ``[n, L] uint8`` into ``slot`` as a ``[rows,
        width]`` chunk; rows past n and columns past L are zero bytes."""
        n, L = reads.shape
        if n > self.rows or L > width or width > self.width:
            raise ValueError(f"a [{n}, {L}] chunk does not fit a [{self.rows}, {width}] slot of width {self.width}")
        view = slot.array[: self.rows * width].reshape(self.rows, width)
        view[:n, :L] = reads
        view[:n, L:] = 0
        view[n:] = 0
        slot.width = width

    # ---- the main thread --------------------------------------------------

    def upload(self, slot: Slot) -> list[torch.Tensor]:
        """The staged chunk on each position's device: ``[rows_per_position,
        width] uint8`` views, one a position.  On a card the copies are
        enqueued on the copy streams and the slot is back on the free
        list; on the CPU the views are the slot's own rows."""
        W = slot.width
        self._zeroed = False
        if self.on_cpu:
            self._held.append(slot)
            return self._slices(torch.from_numpy(slot.array[: self.rows * W]), W)
        for card, copied in zip(self._cards, slot.copied):
            buf = card.buffer()
            card.stream.wait_event(card.consumed)  # (b)
            for row, at, n in card.runs:
                self.ops.copy(card.stream, buf[at * W:(at + n) * W], slot.host[row * W:(row + n) * W])
            copied.record(card.stream)
            self.ops.current_stream(card.device).wait_event(copied)  # (c)
        self._free.put(slot)  # after its events are recorded (a)
        return self._buffer_views(W)

    def zeros(self) -> list[torch.Tensor]:
        """A zero chunk at full width on each position's device, for a
        lockstep step of a process whose input has ended: on a card the
        feed's own buffer, zeroed once on the compute stream (after every
        step that read it; no copy follows)."""
        W = self.width
        if self.on_cpu:
            if self._zeros is None:
                self._zeros = torch.zeros(self.rows * W, dtype=torch.uint8)
            return self._slices(self._zeros, W)
        if not self._zeroed:
            for card in self._cards:
                card.buffer().zero_()
            self._zeroed = True
        return self._buffer_views(W)

    def consumed(self):
        """The step that read the last upload (or zeros) is enqueued: the
        next copy into each device buffer waits for it (b); on the CPU the
        slot it read goes back to the free list."""
        for card in self._cards:
            card.consumed.record(self.ops.current_stream(card.device))
        while self._held:
            self._free.put(self._held.pop())

    def give_back(self, slot: Slot):
        """A slot whose chunk is not uploaded (reads shorter than k)."""
        self._free.put(slot)

    def release(self):
        """Free the device buffers; the next upload allocates them again.
        The mesh engine calls it before a consolidation: its steps held a
        chunk on the card only while they ran."""
        for card in self._cards:
            card.buf = None
        self._zeroed = False

    def close(self):
        """Wake an ingest thread blocked in ``acquire``: it gets None, now
        and at every later call."""
        self._closed = True
        self._free.put(None)

    def _slices(self, flat: torch.Tensor, W: int) -> list[torch.Tensor]:
        """Each position's ``[rows_per_position, W]`` rows of a flat chunk."""
        n = self.rows_per_position * W
        return [flat[p * n:(p + 1) * n].view(-1, W) for p in range(self.positions)]

    def _buffer_views(self, W: int) -> list[torch.Tensor]:
        """Each position's rows in its card's buffer."""
        n = self.rows_per_position * W
        return [card.buf[j * n:(j + 1) * n].view(-1, W) for card, j in self._where]
