"""Metrics, stage timers and profiling hooks.

The reference's only observability is printf progress spam in the CUDA
driver (GPUHandler.cu:399-403,422-424,450-451) and a 1 Hz hashtable-size
monitor thread (KMerCounter.cpp:92-96).  This module provides the
structured equivalent (SURVEY.md §5): named stage timers, monotonic
counters, an optional background table-size monitor, and a
``torch.profiler`` trace context for device-level analysis.

The port's own copy of kmer_counter_tpu/metrics.py; its ``device_trace``
records with ``torch.profiler`` where the original uses ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import defaultdict


class Metrics:
    """Thread-safe counters + cumulative stage timers."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: dict[str, int] = defaultdict(int)
        self.timers: dict[str, float] = defaultdict(float)
        self.timer_calls: dict[str, int] = defaultdict(int)

    def count(self, name: str, delta: int = 1):
        with self._lock:
            self.counters[name] += delta

    @contextlib.contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.timers[name] += dt
                self.timer_calls[name] += 1

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


@contextlib.contextmanager
def device_trace(trace_dir: str | None, device=None):
    """torch.profiler trace of the host and, when ``device`` is a CUDA
    device, of the card, written to ``trace_dir`` as a Chrome trace
    (``trace.json``, which chrome://tracing and Perfetto open); a no-op when
    trace_dir is falsy."""
    if not trace_dir:
        yield
        return
    import os

    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
