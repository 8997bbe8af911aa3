"""The dump sink: the count's ``outputFile`` is a pipe, and a thread of the
harness reads each dump from it as the program writes it.  So a window of
counts writes no dump to disk: the program's single write of its records
goes through the pipe, not into the page cache.

The first dump read is kept whole (the one compared with the reference);
each later dump is compared with it, block by block, as it is read."""

from __future__ import annotations

import errno
import fcntl
import os
import threading
import time

import numpy as np

BLOCK = 1 << 20
JOIN_SECONDS = 300.0


def _first_unlike(a: bytes, b: bytes) -> int:
    """The first offset at which a and b differ (the shorter's length when
    one is the other's start)."""
    n = min(len(a), len(b))
    diff = np.flatnonzero(np.frombuffer(a, np.uint8, n) != np.frombuffer(b, np.uint8, n))
    return int(diff[0]) if len(diff) else n


class DumpSink:
    """One named pipe, ``path``, in ``directory``; one dump at a time."""

    def __init__(self, directory: str):
        self.path = os.path.join(directory, "dump.fifo")
        os.mkfifo(self.path)
        self._thread = None

    def start(self, expect: bytes | None = None) -> str:
        """Start reading the next dump: kept whole when ``expect`` is None,
        else compared with ``expect``.  Returns the path to write it to."""
        if self._thread is not None:
            raise RuntimeError("the previous dump was not finished")
        self._expect = expect
        self._connected = threading.Event()
        self._result = None
        self._thread = threading.Thread(target=self._read, name="gpubench-dump-sink", daemon=True)
        self._thread.start()
        return self.path

    def _read(self) -> None:
        expect, kept = self._expect, bytearray()
        nbytes, first_diff = 0, None
        try:
            fd = os.open(self.path, os.O_RDONLY)  # waits for the writer
            self._connected.set()
            try:
                try:
                    fcntl.fcntl(fd, fcntl.F_SETPIPE_SZ, BLOCK)
                except OSError:
                    pass  # the system's pipe size limit; a smaller pipe only reads slower
                while True:
                    block = os.read(fd, BLOCK)
                    if not block:
                        break
                    if expect is None:
                        kept += block
                    elif first_diff is None and expect[nbytes : nbytes + len(block)] != block:
                        first_diff = nbytes + _first_unlike(block, expect[nbytes : nbytes + len(block)])
                    nbytes += len(block)
            finally:
                os.close(fd)
            if expect is not None and first_diff is None and nbytes != len(expect):
                first_diff = min(nbytes, len(expect))
            self._result = dict(nbytes=nbytes, first_diff=first_diff, data=bytes(kept) if expect is None else None)
        except Exception as e:  # handed to finish()
            self._result = dict(error=repr(e), nbytes=nbytes, first_diff=0, data=None)

    def _unstick(self) -> None:
        """End a reader still waiting for a writer that never came: open the
        pipe for writing and close it, so that it reads an empty dump."""
        while self._thread.is_alive() and not self._connected.is_set():
            try:
                fd = os.open(self.path, os.O_WRONLY | os.O_NONBLOCK)
            except OSError as e:
                if e.errno != errno.ENXIO:
                    raise
                time.sleep(0.001)  # the reader has not opened the pipe yet
                continue
            os.close(fd)
            break

    def finish(self) -> dict:
        """The dump's reading, once the program has returned (or raised):
        ``nbytes``, ``first_diff`` (offset of the first byte unlike
        ``expect``, None if equal), ``data`` (the dump, when kept) and
        ``error`` if reading failed."""
        if self._thread is None:
            raise RuntimeError("no dump was started")
        self._unstick()
        self._thread.join(JOIN_SECONDS)
        alive, self._thread = self._thread.is_alive(), None
        if alive:
            raise RuntimeError(f"the dump sink did not finish reading in {JOIN_SECONDS:.0f} s")
        return self._result

    def close(self) -> None:
        if self._thread is not None:
            self.finish()
        if os.path.exists(self.path):
            os.unlink(self.path)
