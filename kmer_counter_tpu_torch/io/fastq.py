"""Streaming FASTQ ingest producing dense device-ready chunks.

The port's own copy of kmer_counter_tpu/io/fastq.py.

Replaces the reference's ingest stack (InputFileHandler.cpp:22-105,
FASTQFileReader.cpp:18-97, FASTQData.{h,cpp}):

  * A directory of FASTQ files is scanned and served in deterministic
    (sorted) order — the reference uses raw readdir order
    (InputFileHandler.cpp:27-43).
  * Each file's fixed read length is taken from its first sequence line
    (FASTQFileReader.cpp:28-38).
  * The reference identifies sequence lines heuristically — "a line whose
    next line starts with '+'" (FASTQFileReader.cpp:57-74), which miscounts
    when a quality line happens to start with '+'.  This parser is strict
    4-line FASTQ (header/sequence/plus/quality), which is identical on
    well-formed files and robust on the rest; a malformed group raises.
  * Instead of concatenating bare sequence bytes into a flat buffer
    (FASTQData), chunks are dense ``[R, L] uint8`` ASCII matrices — the
    shape the device pipeline consumes directly.  Reads shorter than the
    file's line length are right-padded with zero bytes, which the encoder
    masks invalid, so they contribute exactly their own windows.

Parsing is NumPy-vectorized over large blocks (newline scan + gather); the
optional C++ fast path lives in io.native.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

_BLOCK_BYTES = 8 << 20


@dataclass
class FASTQChunk:
    """Dense chunk of reads — the FASTQData analog (FASTQData.h:21-38)."""

    reads: np.ndarray  # [R, L] uint8 ASCII, zero-padded rows
    n_reads: int
    line_length: int
    path: str = ""  # source file (set by DirectoryInput; checkpoint manifest)


class FASTQReader:
    """Streaming parser for one FASTQ file (FASTQFileReader analog).

    ``byte_range=(start, end)`` restricts parsing to the records whose
    header line begins in [start, end): the reader seeks to ``start``,
    resynchronizes to the next record boundary (a line starting with '@'
    whose line+2 starts with '+', which rejects '@'-leading quality
    lines), and stops at the first header at or past ``end`` — so
    adjacent ranges partition a file exactly, enabling byte-range ingest
    sharding across hosts when files are fewer than processes.
    """

    def __init__(self, path: str, byte_range: tuple[int, int] | None = None):
        self.path = path
        self._fh = open(path, "rb")
        self._carry = b""
        self._phase = 0  # line index mod 4 within the current record
        self._eof = False
        self._pending: list[np.ndarray] = []  # parsed seq lines (uint8)
        self._limit = None  # absolute byte limit for record headers
        self._pos = 0  # absolute offset of the first unconsumed byte
        # Fixed read length from the first record's sequence line
        # (FASTQFileReader.cpp:28-38).  Read until two lines are available.
        head = b""
        while head.count(b"\n") < 2:
            more = self._fh.read(_BLOCK_BYTES)
            if not more:
                break
            head += more
        self._fh.seek(0)
        lines = head.split(b"\n")
        if len(lines) < 2 or not lines[0].startswith(b"@"):
            raise ValueError(f"{path}: not a FASTQ file")
        self.line_length = len(lines[1].rstrip(b"\r"))
        if self.line_length == 0:
            raise ValueError(f"{path}: empty first sequence line")
        if byte_range is not None:
            start, end = byte_range
            self._limit = end
            self._seek_to_record(max(start, 0))

    def _seek_to_record(self, start: int):
        """Position the stream at the first record header at or after
        ``start`` (no-op for start == 0)."""
        if start == 0:
            return
        # Read from start-1 so every line start is identified by the
        # newline before it (a header exactly at `start` is then found).
        base = start - 1
        self._fh.seek(base)
        window = b""
        while True:
            more = self._fh.read(_BLOCK_BYTES)
            window += more
            nls = np.flatnonzero(
                np.frombuffer(window, dtype=np.uint8) == ord("\n")
            ).tolist()
            # candidate line starts (absolute) after each newline
            for j, nl in enumerate(nls):
                ls = nl + 1
                if ls >= len(window) or window[ls] != ord("@"):
                    continue
                # the +2 line must start with '+': need two more newlines
                if j + 2 >= len(nls):
                    break  # extend window
                plus = nls[j + 2] + 1
                if plus < len(window) and window[plus] == ord("+"):
                    self._fh.seek(base + ls)
                    self._pos = base + ls
                    return
            if not more:
                # no record begins in the remainder of the file
                self._fh.seek(0, 2)
                self._pos = self._fh.tell()
                self._eof = True
                return

    def close(self):
        self._fh.close()

    def _parse_block(self) -> bool:
        """Read one block, push its sequence lines into _pending.

        Returns False once the file is fully consumed and drained.
        """
        if self._eof:
            return False
        block = self._fh.read(_BLOCK_BYTES)
        data = self._carry + block
        if not block:
            self._eof = True
            self._carry = b""
            if not data:
                self._check_complete()
                return False
            # Final unterminated line counts as a line.
            if not data.endswith(b"\n"):
                data += b"\n"
        else:
            cut = data.rfind(b"\n")
            if cut == -1:
                self._carry = data
                return True
            self._carry = data[cut + 1 :]
            data = data[: cut + 1]
        arr = np.frombuffer(data, dtype=np.uint8)
        ends = np.flatnonzero(arr == ord("\n"))
        if ends.size == 0:
            return True
        starts = np.concatenate([[0], ends[:-1] + 1])
        # Sequence lines are record line 1 of each 4-line group.
        line_idx = self._phase + np.arange(ends.size)
        if self._limit is not None:
            # Stop at the first record header at or past the byte limit
            # (records belong to the shard whose range holds their header).
            is_header = (line_idx & 3) == 0
            over = is_header & (self._pos + starts >= self._limit)
            if over.any():
                cut = int(np.argmax(over))
                ends, starts, line_idx = ends[:cut], starts[:cut], line_idx[:cut]
                self._eof = True
                self._carry = b""
                if ends.size == 0:
                    return False
        self._pos += len(data)  # data excludes the new carry tail
        # Structural validation: phase tracking alone would silently
        # desynchronize on a malformed file (a missing line shifts
        # quality lines into sequence position until — maybe — the
        # line-length check trips).  Headers must start with '@' and
        # separator lines with '+'; an empty line fails both (its first
        # byte is the newline itself).  Fail loudly instead of desyncing.
        firsts = arr[starts]
        bad_hdr = ((line_idx & 3) == 0) & (firsts != ord("@"))
        bad_sep = ((line_idx & 3) == 2) & (firsts != ord("+"))
        if bad_hdr.any() or bad_sep.any():
            at = int(np.argmax(bad_hdr | bad_sep))
            kind = "header '@'" if bad_hdr[at] else "separator '+'"
            raise ValueError(
                f"{self.path}: malformed FASTQ — expected a {kind} line at "
                f"byte offset {self._pos - len(data) + int(starts[at])} "
                "(missing or extra line upstream?)"
            )
        is_seq = (line_idx & 3) == 1
        self._phase = int(line_idx[-1] + 1) & 3
        for s, e in zip(starts[is_seq], ends[is_seq]):
            line = arr[s:e]
            if line.size and line[-1] == ord("\r"):
                line = line[:-1]
            if line.size > self.line_length:
                raise ValueError(
                    f"{self.path}: sequence line of {line.size} bases exceeds "
                    f"the file's line length {self.line_length}"
                )
            self._pending.append(line)
        if self._eof and self._limit is None:
            self._check_complete()
        return True

    def _check_complete(self):
        """At true EOF the file must end on a record boundary (phase 0);
        a nonzero phase means the last record was truncated mid-stream."""
        if self._phase != 0:
            raise ValueError(
                f"{self.path}: malformed FASTQ — file ends mid-record "
                f"({self._phase} of 4 lines in the final record)"
            )

    def read_chunk(self, max_reads: int) -> FASTQChunk | None:
        """Up to ``max_reads`` reads as a dense matrix; None when exhausted
        (the readData/isComplete pair, FASTQFileReader.cpp:49-93)."""
        while len(self._pending) < max_reads and self._parse_block():
            pass
        if not self._pending:
            return None
        take, self._pending = self._pending[:max_reads], self._pending[max_reads:]
        out = np.zeros((len(take), self.line_length), dtype=np.uint8)
        for i, line in enumerate(take):
            out[i, : line.size] = line
        return FASTQChunk(out, len(take), self.line_length)

    @property
    def exhausted(self) -> bool:
        return self._eof and not self._pending


def scan_fastq_dir(
    directory: str,
    extensions=(".fastq", ".fq", ".txt"),
    shard: tuple[int, int] | None = None,
    shard_mode: str = "auto",
) -> tuple[list[str], tuple[int, int] | None]:
    """Sorted FASTQ file list + optional per-process byte shard — the
    directory-scan logic shared by DirectoryInput and ParallelIngest.

    ``shard=(index, count)`` splits ingest across count processes
    (multi-host data sharding, SURVEY.md §2.3 'Multi-GPU/multi-node').
    ``shard_mode``: 'files' round-robins whole files; 'bytes' gives every
    process a byte range of *every* file (records whose header starts in
    the range), which balances even a single giant file; 'auto' picks
    bytes when there are fewer files than processes.

    Returns (paths, byte_shard) where byte_shard is None for file mode.
    """
    if not os.path.isdir(directory):
        raise FileNotFoundError(f"input directory not found: {directory}")
    names = sorted(
        n
        for n in os.listdir(directory)
        if os.path.isfile(os.path.join(directory, n))
        and (n.endswith(extensions) or not extensions)
    )
    if not names:
        raise FileNotFoundError(f"no FASTQ files in {directory}")
    paths = [os.path.join(directory, n) for n in names]
    byte_shard = None
    if shard is not None:
        idx, count = shard
        if shard_mode == "auto":
            shard_mode = "bytes" if len(paths) < count else "files"
        if shard_mode == "files":
            paths = [p for i, p in enumerate(paths) if i % count == idx]
            if not paths:
                raise FileNotFoundError(
                    f"no FASTQ files for shard {idx}/{count} in {directory}"
                )
        elif shard_mode == "bytes":
            byte_shard = (idx, count)
        else:
            raise ValueError(f"unknown shard_mode: {shard_mode!r}")
    return paths, byte_shard


class DirectoryInput:
    """Serves chunks across every FASTQ file in a directory
    (InputFileHandler analog, InputFileHandler.cpp:22-105).

    Files are consumed in sorted order; a chunk never spans files (matching
    the reference, which serves each chunk from the current front reader).
    """

    def __init__(
        self,
        directory: str,
        extensions=(".fastq", ".fq", ".txt"),
        use_native: bool | None = None,
        shard: tuple[int, int] | None = None,
        shard_mode: str = "auto",
    ):
        """See ``scan_fastq_dir`` for the shard semantics."""
        self.paths, self._byte_shard = scan_fastq_dir(
            directory, extensions, shard, shard_mode
        )
        self._factory = self._pick_factory(use_native)
        self._index = -1
        self._reader = None
        self._advance()
        if self._reader is None:
            raise FileNotFoundError(f"no readable FASTQ files in {directory}")

    @staticmethod
    def _pick_factory(use_native: bool | None):
        """Native C++ parser when built (native/kmer_io.cpp), else Python."""
        if use_native is False:
            return FASTQReader
        from kmer_counter_tpu_torch.io import native

        if native.available():
            return native.NativeFASTQReader
        if use_native:
            raise RuntimeError("native library not built (make -C native)")
        return FASTQReader

    @property
    def line_length(self) -> int | None:
        """Line length of the current front file (InputFileHandler.cpp:97-105)."""
        return self._reader.line_length if self._reader else None

    def probe_line_lengths(self) -> list[int]:
        """Read length of every file (header probe only, no data parsing) —
        lets the engine plan chunk shapes before streaming starts."""
        lengths = []
        for i, path in enumerate(self.paths):
            if i == self._index and self._reader is not None:
                lengths.append(self._reader.line_length)
                continue
            try:
                probe = self._factory(path)
            except (OSError, ValueError):
                continue  # unreadable files are skipped at read time too
            lengths.append(probe.line_length)
            probe.close()
        return lengths

    def read_chunk(self, max_reads: int) -> FASTQChunk | None:
        while self._reader is not None:
            try:
                chunk = self._reader.read_chunk(max_reads)
            except (OSError, ValueError) as e:
                # Per-file fault tolerance: warn and move to the next file,
                # like the reference's open-failure handling
                # (InputFileHandler.cpp:44-46) — a bad file must not kill a
                # long multi-file run.
                import sys

                print(
                    f"[ingest] skipping rest of {self.paths[self._index]}: {e}",
                    file=sys.stderr,
                )
                chunk = None
            if chunk is not None:
                chunk.path = self.paths[self._index]
                return chunk
            self._advance()
        return None

    def _open(self, path: str):
        if self._byte_shard is None:
            return self._factory(path)
        idx, count = self._byte_shard
        size = os.path.getsize(path)
        byte_range = (size * idx // count, size * (idx + 1) // count)
        try:
            return self._factory(path, byte_range=byte_range)
        except RuntimeError:
            # Native .so built without kc_open_range: Python fallback.
            return FASTQReader(path, byte_range=byte_range)

    def _advance(self):
        if self._reader is not None:
            self._reader.close()
        self._reader = None
        while self._index + 1 < len(self.paths):
            self._index += 1
            try:
                self._reader = self._open(self.paths[self._index])
                return
            except (OSError, ValueError) as e:
                import sys

                print(
                    f"[ingest] skipping {self.paths[self._index]}: {e}",
                    file=sys.stderr,
                )
        self._index = len(self.paths)

    def close(self):
        if self._reader is not None:
            self._reader.close()
            self._reader = None


# A file, or a byte shard's range, of at least this many bytes is cut into
# parse units; below it the file stays one unit.
_SPLIT_BYTES = 4 << 20
# The most bytes of a file one unit spans.
_UNIT_BYTES = 32 << 20


def plan_units(lo: int, hi: int, threads: int, split_bytes: int = _SPLIT_BYTES,
               unit_bytes: int = _UNIT_BYTES) -> list[tuple[int, int]]:
    """Byte ranges of equal size that partition ``[lo, hi)`` into parse
    units: one range below ``split_bytes``; else ``threads`` ranges, or as
    many more as keep each within ``unit_bytes``."""
    span = max(hi - lo, 0)
    n = 1 if span < split_bytes else max(threads, -(-span // max(unit_bytes, 1)))
    return [(lo + span * s // n, lo + span * (s + 1) // n) for s in range(n)]


def tail_phase(path: str) -> int:
    """The lines of ``path``'s last record, mod 4: 0 where the file ends on
    a record boundary, as a whole-file parse checks at its end.  The last
    record header is found as ``FASTQReader`` resynchronizes: a line that
    starts with '@' whose line + 2 starts with '+'."""
    with open(path, "rb") as fh:
        size = fh.seek(0, 2)
        span = 1 << 16
        while True:
            base = max(size - span, 0)
            fh.seek(base)
            lines = fh.read().split(b"\n")
            if lines[-1] == b"":
                lines.pop()  # nothing follows the final newline
            first = 0 if base == 0 else 1  # the window's first line may be cut
            for i in range(len(lines) - 3, first - 1, -1):
                if lines[i][:1] == b"@" and lines[i + 2][:1] == b"+":
                    return (len(lines) - i) % 4
            if base == 0:
                return len(lines) % 4  # the first line is the first header
            span *= 4


def joins_at(path: str, b: int) -> bool:
    """Whether ``path``'s records run on unbroken across byte ``b``, as a
    cut into units there assumes: the record a parse from ``b``
    resynchronizes to (as ``FASTQReader`` does: a line that starts with '@'
    whose line + 2 starts with '+') is the file's first, or none follows,
    or the four lines before it form a record ('@' and '+' in their
    places).  Where they do not, a whole-file parse fails near ``b``."""
    with open(path, "rb") as fh:
        span = 1 << 16
        while True:
            base = max(b - span, 0)
            fh.seek(base)
            data = fh.read(b + span - base)
            eof = len(data) < b + span - base
            lines = data.split(b"\n")
            first = 0 if base == 0 else 1  # the window's first line may be cut
            whole = len(lines) if eof else len(lines) - 1  # the last may be cut
            at = base
            for j, line in enumerate(lines[: whole - 2]):
                if j >= first and at >= b and line[:1] == b"@" and lines[j + 2][:1] == b"+":
                    if j - 4 >= first:
                        return lines[j - 4][:1] == b"@" and lines[j - 2][:1] == b"+"
                    if base == 0:
                        return j == 0
                    break  # too little before the record: a wider window
                at += len(line) + 1
            else:
                if eof:
                    return True  # no record starts at or past b
            span *= 4


@dataclass(frozen=True)
class _Unit:
    path: str
    byte_range: tuple[int, int] | None  # None: the whole file
    file_index: int
    check_start: bool  # a cut inside the file (or shard) begins the unit
    check_end: bool  # the last unit of a cut file: check the file's end


class ParallelIngest:
    """Order-preserving multi-threaded FASTQ ingest (DirectoryInput drop-in).

    N parser threads work on independent *units* — whole files, or
    byte-range units of larger ones (the FASTQReader record-resync
    guarantees adjacent ranges partition a file exactly) — while the
    consumer reassembles their chunks in the order the sequential
    DirectoryInput produces: sorted files, reads in file order, chunks
    never spanning files.  Checkpoint resume therefore sees the identical
    deterministic read sequence.

    This is the analog of the reference's 8-stream reader overlap +
    per-chunk worker threads (KMerCounter.cpp:117-147): one parser thread
    tops out far below the card, so parsing fans out while the device runs.

    The unit plan (``plan_units``) follows only from what can be observed:
    a file, or a byte shard's range, of ``segment_bytes`` or more is cut
    into ``threads`` units, or into as many more as keep each within
    ``unit_bytes``; a smaller one stays one unit.  A worker parses its
    whole unit ahead, never waiting for the consumer inside it, in blocks
    of ``unit_chunk_reads`` reads.  Where a file is cut, each unit's worker
    checks that the records run on across the cut it starts at
    (``joins_at``), and the last unit's that the file ends on a record
    boundary (``tail_phase``; where it does not, the unit's last block
    gives way to the error a whole-file parse raises there), so a malformed
    file fails as it does whole.  After a unit's error the consumer warns
    once and skips the rest of that file, as DirectoryInput does.

    Memory bound: a worker starts only a unit within ``threads + 2`` units
    of the one the consumer reads, so at most ``threads + 2`` units are
    parsed or held at once: at most ``(threads + 2) * unit_bytes`` bytes of
    the files (and one record a unit that ends past its range).  A record
    of a read of L bases takes at least 2L + 6 bytes of the file and its
    parsed row L bytes, so where reads fill the file's line length the
    parsed rows held (``buffered_bytes``, high-water mark
    ``buffered_peak``) stay within ``L / (2L + 6)`` of those bytes, under
    half of them; a shorter read is padded to L.

    ``counters``: ``ingest_blocks_ready`` and ``ingest_blocks_waited``, the
    blocks the consumer took already parsed and those it waited for, and
    ``ingest_units``, the units of the plan.
    """

    def __init__(
        self,
        directory: str,
        threads: int = 4,
        extensions=(".fastq", ".fq", ".txt"),
        use_native: bool | None = None,
        shard: tuple[int, int] | None = None,
        shard_mode: str = "auto",
        segment_bytes: int = _SPLIT_BYTES,
        unit_bytes: int = _UNIT_BYTES,
        unit_chunk_reads: int = 16384,
    ):
        import collections
        import threading

        self.paths, byte_shard = scan_fastq_dir(
            directory, extensions, shard, shard_mode
        )
        self._factory = DirectoryInput._pick_factory(use_native)
        self._chunk_reads = unit_chunk_reads
        threads = max(threads, 1)
        self._units: list[_Unit] = []
        for fi, p in enumerate(self.paths):
            try:
                size = os.path.getsize(p)
            except OSError:
                size = 0
            lo, hi = 0, size
            if byte_shard is not None:
                idx, count = byte_shard
                lo, hi = size * idx // count, size * (idx + 1) // count
            ranges = plan_units(lo, hi, threads, segment_bytes, unit_bytes)
            if byte_shard is None and len(ranges) == 1:
                self._units.append(_Unit(p, None, fi, False, False))
                continue
            for j, br in enumerate(ranges):
                # A byte shard's reader checks neither the shard's ends nor
                # the file's (DirectoryInput's neither); a whole-file parse
                # checks the file's end.
                last = byte_shard is None and j == len(ranges) - 1
                self._units.append(_Unit(p, br, fi, j > 0, last))
        self._buffers = [collections.deque() for _ in self._units]
        # One lock for the window, the buffers and their bytes.
        self._cv = threading.Condition()
        self._next_unit = 0
        self._window = threads + 2
        self._closed = False
        self.buffered_bytes = 0
        self.buffered_peak = 0
        self.blocks_ready = 0
        self.blocks_waited = 0
        # consumer state
        self._cur = 0  # unit index being consumed
        self._skipping = -1  # index of the file whose rest is skipped
        self._line_length_cache: dict[str, int | None] = {}
        self._cur_chunk: FASTQChunk | None = None
        self._cur_off = 0
        self._threads = [
            threading.Thread(target=self._worker, daemon=True)
            for _ in range(threads)
        ]
        for t in self._threads:
            t.start()

    @property
    def counters(self) -> dict[str, int]:
        return {
            "ingest_blocks_ready": self.blocks_ready,
            "ingest_blocks_waited": self.blocks_waited,
            "ingest_units": len(self._units),
        }

    # ---- workers ---------------------------------------------------------

    def _worker(self):
        while True:
            with self._cv:
                while (not self._closed and self._next_unit < len(self._units)
                       and self._next_unit >= self._cur + self._window):
                    self._cv.wait()
                if self._closed or self._next_unit >= len(self._units):
                    return
                i = self._next_unit
                self._next_unit += 1
            self._parse_unit(i)

    def _live(self, unit: _Unit) -> bool:
        """Whether the consumer still wants ``unit``'s blocks."""
        return not self._closed and unit.file_index != self._skipping

    def _parse_unit(self, i: int):
        unit = self._units[i]
        try:
            if unit.check_start and not joins_at(unit.path, unit.byte_range[0]):
                raise ValueError(
                    f"{unit.path}: malformed FASTQ — no record boundary "
                    f"near byte offset {unit.byte_range[0]}"
                )
            phase = tail_phase(unit.path) if unit.check_end else 0
            reader = self._open_unit(unit)
            try:
                held = None  # the last block, held back where the file ends mid-record
                while self._live(unit):
                    c = reader.read_chunk(self._chunk_reads)
                    if c is None:
                        break
                    if c.n_reads < self._chunk_reads:
                        c.reads = c.reads.copy()  # no unused rows held
                    c.path = unit.path
                    if phase:
                        held, c = c, held
                    if c is not None:
                        self._put(i, c)
                if phase:
                    raise ValueError(
                        f"{unit.path}: malformed FASTQ — file ends mid-record "
                        f"({phase} of 4 lines in the final record)"
                    )
            finally:
                reader.close()
        except (OSError, ValueError) as e:
            self._put(i, e)  # surfaced by the consumer as a skip warning
        self._put(i, None)  # unit sentinel

    def _put(self, i: int, item):
        with self._cv:
            if self._closed:
                return
            if isinstance(item, FASTQChunk):
                self.buffered_bytes += item.reads.nbytes
                self.buffered_peak = max(self.buffered_peak, self.buffered_bytes)
            self._buffers[i].append(item)
            self._cv.notify_all()

    def _open_unit(self, unit: _Unit):
        if unit.byte_range is None:
            return self._factory(unit.path)
        try:
            return self._factory(unit.path, byte_range=unit.byte_range)
        except RuntimeError:
            return FASTQReader(unit.path, byte_range=unit.byte_range)

    # ---- DirectoryInput-compatible consumer API --------------------------

    def probe_line_lengths(self) -> list[int]:
        lengths = []
        for path in self.paths:
            try:
                probe = self._factory(path)
            except (OSError, ValueError):
                continue
            lengths.append(probe.line_length)
            probe.close()
        return lengths

    @property
    def line_length(self) -> int | None:
        """Current unit's fixed read length (memoized per path: the probe
        opens and reads the file head, which would otherwise re-run on
        EVERY access — VERDICT r4 item 7)."""
        if self._cur >= len(self._units):
            return None
        path = self._units[self._cur].path
        if path not in self._line_length_cache:
            try:
                probe = self._factory(path)
            except (OSError, ValueError):
                self._line_length_cache[path] = None
            else:
                self._line_length_cache[path] = probe.line_length
                probe.close()
        return self._line_length_cache[path]

    def _take(self):
        """(the current unit's next item, whether the consumer waited)."""
        buf = self._buffers[self._cur]
        with self._cv:
            waited = not buf
            while not buf:
                self._cv.wait()
            return buf.popleft(), waited

    def _release(self, chunk: FASTQChunk):
        with self._cv:
            self.buffered_bytes -= chunk.reads.nbytes

    def _peek_block(self):
        """(rows_view, file_idx, line_length, path) of the next unconsumed
        rows, or None when all input is drained.  Does not consume."""
        import sys

        while self._cur < len(self._units):
            if self._cur_chunk is not None:
                c = self._cur_chunk
                return (
                    c.reads[self._cur_off :],
                    self._units[self._cur].file_index,
                    c.line_length,
                    c.path,
                )
            unit = self._units[self._cur]
            item, waited = self._take()
            if item is None:
                with self._cv:
                    self._cur += 1
                    self._cv.notify_all()
            elif unit.file_index == self._skipping:
                if isinstance(item, FASTQChunk):
                    self._release(item)
            elif isinstance(item, Exception):
                print(f"[ingest] skipping rest of {unit.path}: {item}", file=sys.stderr)
                self._skipping = unit.file_index  # the unit sentinel follows
            else:
                if waited:
                    self.blocks_waited += 1
                else:
                    self.blocks_ready += 1
                self._cur_chunk = item
                self._cur_off = 0
        return None

    def _consume(self, n: int):
        self._cur_off += n
        if self._cur_chunk is not None and self._cur_off >= self._cur_chunk.n_reads:
            self._release(self._cur_chunk)
            self._cur_chunk = None
            self._cur_off = 0

    def read_chunk(self, max_reads: int) -> FASTQChunk | None:
        blocks = []
        have = 0
        fi0 = None
        L = 0
        path0 = ""
        while have < max_reads:
            got = self._peek_block()
            if got is None:
                break
            rows, fi, L_b, path = got
            if fi0 is None:
                fi0, L, path0 = fi, L_b, path
            elif fi != fi0:
                break  # a chunk never spans files (DirectoryInput contract)
            take = min(max_reads - have, len(rows))
            blocks.append(rows[:take])
            self._consume(take)
            have += take
        if have == 0:
            return None
        reads = blocks[0] if len(blocks) == 1 else np.vstack(blocks)
        # views may alias a buffered chunk being released; copy defensively
        return FASTQChunk(np.ascontiguousarray(reads), have, L, path0)

    def close(self):
        with self._cv:
            self._closed = True
            for buf in self._buffers:
                buf.clear()
            self.buffered_bytes = 0
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=2.0)
