"""Metrics, stage timers and profiling hooks.

The reference's only observability is printf progress spam in the CUDA
driver (GPUHandler.cu:399-403,422-424,450-451) and a 1 Hz hashtable-size
monitor thread (KMerCounter.cpp:92-96).  This module provides the
structured equivalent (SURVEY.md §5): named stage timers, monotonic
counters, an optional background table-size monitor, and a
``torch.profiler`` trace context for device-level analysis.

The port's own copy of kmer_counter_tpu/metrics.py; its ``device_trace``
records with ``torch.profiler`` where the original uses ``jax.profiler``.

Every timer is also a span: while a torch.profiler session records, the
block runs inside ``record_function("kmer.<timer>")``, so the program's
phases land in the same trace as the kernels, copies and CUDA runtime
calls, on the profiler's clock.  With no profiler recording a timer costs
its two clock reads, two flag reads and its place on the thread's stack
of open timers.  That stack gives ``uncovered``: the part of a timer's
time that no timer opened directly inside it covered.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import defaultdict

import torch
from torch.autograd import profiler as _profiler

SPAN_PREFIX = "kmer."


def profiler_recording() -> bool:
    """Whether a torch.profiler session records: the flag the profiler sets
    for every thread while it runs, or the calling thread's own state."""
    return getattr(_profiler, "_is_profiler_enabled", False) or torch.autograd._profiler_enabled()


class Metrics:
    """Thread-safe counters + cumulative stage timers (each a profiler span
    while a profiler records)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._open = threading.local()  # .names: this thread's open timers
        self.counters: dict[str, int] = defaultdict(int)
        self.timers: dict[str, float] = defaultdict(float)
        self.timer_calls: dict[str, int] = defaultdict(int)
        # Seconds of the timers opened directly inside each timer, on the
        # same thread.
        self._inner: dict[str, float] = defaultdict(float)

    def count(self, name: str, delta: int = 1):
        with self._lock:
            self.counters[name] += delta

    @contextlib.contextmanager
    def timer(self, name: str):
        names = self._open.__dict__.setdefault("names", [])
        parent = names[-1] if names else None
        names.append(name)
        t0 = time.perf_counter()
        try:
            if profiler_recording():
                with torch.profiler.record_function(SPAN_PREFIX + name):
                    yield
            else:
                yield
        finally:
            dt = time.perf_counter() - t0
            names.pop()
            with self._lock:
                self.timers[name] += dt
                self.timer_calls[name] += 1
                if parent is not None:
                    self._inner[parent] += dt

    def uncovered(self, name: str) -> float:
        """Seconds of the ``name`` timers that no timer opened directly
        inside them, on the same thread, covered."""
        with self._lock:
            return self.timers.get(name, 0.0) - self._inner.get(name, 0.0)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": dict(self.counters),
                "timers_s": {k: round(v, 6) for k, v in self.timers.items()},
                "timer_calls": dict(self.timer_calls),
            }

    def report(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True)


class SizeMonitor:
    """Optional 1 Hz monitor of a callable gauge — the modern form of the
    reference's hashtable-size monitor thread (KMerCounter.cpp:92-96)."""

    def __init__(self, gauge, interval_s: float = 1.0, sink=print):
        self._gauge = gauge
        self._interval = interval_s
        self._sink = sink
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.wait(self._interval):
            try:
                self._sink(f"[monitor] {self._gauge()}")
            except Exception:
                pass

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=2 * self._interval)


def span(metrics: Metrics | None, name: str):
    """``metrics.timer(name)``, or nothing where there is no ``metrics``."""
    return contextlib.nullcontext() if metrics is None else metrics.timer(name)


def _all_threads_config():
    """The profiler setting that also records threads started inside the
    trace (the prefetch thread), or None where this torch has none."""
    try:
        return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


@contextlib.contextmanager
def device_trace(trace_dir: str | None, device=None):
    """torch.profiler trace of the host and, when ``device`` is a CUDA
    device, of the card, written to ``trace_dir`` as a Chrome trace
    (``trace.json``, which chrome://tracing and Perfetto open); a no-op when
    trace_dir is falsy.  The trace holds the ``kmer.<timer>`` spans of the
    main thread and, where this torch can record threads started inside a
    trace, of the prefetch thread (``kmer.ingest``, ``kmer.feed.acquire``,
    ``kmer.stage``)."""
    if not trace_dir:
        yield
        return
    import os

    activities = [torch.profiler.ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    config = _all_threads_config()
    extra = {} if config is None else {"experimental_config": config}
    with torch.profiler.profile(activities=activities, **extra) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
