"""Spans, the profiler trace and what the per-layer metrics read from it.

Spans: ``record_function`` ranges opened by the harness's own wrappers
around the engine's calls into each layer (installed only in a traced
run).  The engine imports the layer functions when it calls them, so
replacing a module's attribute reaches its calls.

The program opens spans of its own, ``kmer.<timer>`` (one for each of
its timers, while a profiler records): they are kept too, under their
full names, so that a reader can take the device time of a program phase
(``kmer.consolidate``, ``kmer.dump.format``) as it takes a layer's.

The trace: torch.profiler with CPU and CUDA activity over the window,
exported as a Chrome trace and read back into plain events:

    {"kind": "span", "name": <layer>, "ts", "dur", "tid"}    a harness span, its prefix stripped
    {"kind": "span", "name": "kmer.<timer>", ...}            a program span, its name whole
    {"kind": "launch", "corr", "ts", "tid"}                  a CUDA runtime or driver call
    {"kind": "device", "name", "ts", "dur", "corr"}          a kernel, copy or fill

(times in microseconds).  A device event belongs to a span's name when
the call that launched it (same correlation id) falls inside one of the
spans of that name on the same thread, whatever the kernel's name.

The opening with spin kernels is a copy of ``traced`` / ``trace_warm_up``
in the repository's ``chip_smoke.py``: a stopgap for a torch.profiler
defect, a trace that loses its first records."""

from __future__ import annotations

import bisect
import contextlib
import functools
import importlib
import json
import os

PREFIX = "gpubench."
# The program's own spans (``metrics.SPAN_PREFIX`` of the program, which the
# benchmark does not import).
PROGRAM_PREFIX = "kmer."
PROGRAM = "kmer_counter_tpu_torch"
# layer span -> the functions it wraps, as (module, attribute).
SPANS = {
    "chunk_step": (("ops.pipeline", "count_step_two_level"), ("ops.pipeline", "extract_chunk"),
                   ("ops.table", "append")),
    "consolidate": (("ops.table2", "consolidate3"), ("ops.table2", "grow2"),
                    ("ops.table", "consolidate"), ("ops.table", "grow")),
    "finalize": (("ops.table2", "finalize_host"),),
    "dump": (("engine", "dump_table"),),
}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPIN = "spin_kernel"
TRACE_MARGIN = 256
TRACE_TRIES = 4


# ---- spans ------------------------------------------------------------------


def _span(name, fn):
    import torch

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(PREFIX + name):
            return fn(*args, **kwargs)

    return wrapped


def _spanned_chunks(fn):
    """``CountEngine._chunks`` with each wait for the next chunk in an
    ``ingest_wait`` span."""
    import torch

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        gen = fn(*args, **kwargs)
        try:
            while True:
                with torch.profiler.record_function(PREFIX + "ingest_wait"):
                    try:
                        item = next(gen)
                    except StopIteration:
                        return
                yield item
        finally:
            gen.close()

    return wrapped


@contextlib.contextmanager
def spans_installed():
    """The layer spans around the program's functions for the block's
    length; a function the program no longer has is left out (its layer
    then reads nothing)."""
    undo = []
    for name, targets in SPANS.items():
        for module_name, attr in targets:
            try:
                module = importlib.import_module(f"{PROGRAM}.{module_name}")
            except ImportError:
                continue
            fn = getattr(module, attr, None)
            if fn is None:
                continue
            setattr(module, attr, _span(name, fn))
            undo.append((module, attr, fn))
    engine = importlib.import_module(f"{PROGRAM}.engine")
    chunks = getattr(getattr(engine, "CountEngine", None), "_chunks", None)
    if chunks is not None:
        engine.CountEngine._chunks = _spanned_chunks(chunks)
        undo.append((engine.CountEngine, "_chunks", chunks))
    try:
        yield
    finally:
        for owner, attr, fn in reversed(undo):
            setattr(owner, attr, fn)


# ---- the trace's opening (copied from chip_smoke.py) --------------------------


def launch_spins(n):
    import torch

    for _ in range(n):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def trace_warm_up():
    """The spin kernels a trace should open with now: a trace of spin
    kernels alone (4x more until it keeps one) tells how many it loses."""
    import torch
    from torch.autograd import DeviceType

    spins = TRACE_MARGIN
    while True:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            launch_spins(spins)
        kept = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA and SPIN in e.name)
        if kept:
            return spins - kept + TRACE_MARGIN
        if spins >= 1 << 16:
            raise AssertionError(f"torch.profiler lost every record of a trace of {spins} kernels")
        spins *= 4


def traced(fn, trace_path, log):
    """(fn's result, the trace's events, the opening's record) of one call
    of fn under torch.profiler (host and card), opened with spin kernels;
    fn is called again, in a new trace with four times the spins, while a
    trace kept none of them (TRACE_TRIES traces at most).  The Chrome trace
    is written to ``trace_path``, read back and deleted."""
    import torch

    spins = trace_warm_up()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for tries in range(1, TRACE_TRIES + 1):
        with torch.profiler.profile(activities=acts) as prof:
            launch_spins(spins)
            out = fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(trace_path)
        try:
            with open(trace_path) as fh:
                events = read_chrome_trace(json.load(fh))
        finally:
            os.unlink(trace_path)
        kept = sum(1 for e in events if e["kind"] == "device" and SPIN in e["name"])
        opening = {"opening_spins": spins, "spins_lost": spins - kept, "try": tries}
        log({"phase": "trace", **opening})
        if kept:
            return out, events, opening
        spins *= 4
    raise AssertionError(f"torch.profiler lost all {spins // 4} opening spin kernels of {TRACE_TRIES} traces")


# ---- reading the trace --------------------------------------------------------


def read_chrome_trace(trace: dict) -> list[dict]:
    """A Chrome trace's complete events as the plain events above: the
    harness's spans under their layer names, the program's under their
    whole ``kmer.`` names, so that neither can take the other's name."""
    out = []
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat", ""), e.get("args") or {}
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            out.append(dict(kind="device", name=e["name"], ts=ts, dur=dur, corr=args.get("correlation")))
        elif cat in LAUNCH_CATS:
            out.append(dict(kind="launch", corr=args.get("correlation"), ts=ts, tid=e.get("tid")))
        elif cat == "user_annotation" and e["name"].startswith((PREFIX, PROGRAM_PREFIX)):
            out.append(dict(kind="span", name=e["name"].removeprefix(PREFIX), ts=ts, dur=dur, tid=e.get("tid")))
    return out


def _merged(intervals):
    """Sorted, non-overlapping (start, end) intervals covering the given ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _inside(merged, t) -> bool:
    i = bisect.bisect_right(merged, [t, float("inf")]) - 1
    return i >= 0 and merged[i][0] <= t <= merged[i][1]


def window_of(events, name="count"):
    """(start, end) in microseconds from the first ``name`` span's start to
    the last one's end, or None."""
    spans = [e for e in events if e["kind"] == "span" and e["name"] == name]
    if not spans:
        return None
    return min(e["ts"] for e in spans), max(e["ts"] + e["dur"] for e in spans)


def layer_device_us(events, layer) -> tuple[float, int]:
    """(device microseconds, device events) of everything launched inside
    the spans named ``layer``: a harness layer (``consolidate``) or a
    program span (``kmer.consolidate``)."""
    spans: dict = {}
    for e in events:
        if e["kind"] == "span" and e["name"] == layer:
            spans.setdefault(e["tid"], []).append((e["ts"], e["ts"] + e["dur"]))
    spans = {tid: _merged(v) for tid, v in spans.items()}
    if not spans:
        return 0.0, 0
    launches = {e["corr"]: e for e in events if e["kind"] == "launch" and e["corr"] is not None}
    total, n = 0.0, 0
    for e in events:
        if e["kind"] != "device":
            continue
        host = launches.get(e["corr"])
        if host is not None and host["tid"] in spans and _inside(spans[host["tid"]], host["ts"]):
            total += e["dur"]
            n += 1
    return total, n


def busy_us(events, window) -> float:
    """Microseconds of ``window`` in which some kernel, copy or fill ran
    on the card (the union of their intervals, clipped to the window)."""
    lo, hi = window
    iv = [(max(e["ts"], lo), min(e["ts"] + e["dur"], hi)) for e in events if e["kind"] == "device"]
    return sum(e - s for s, e in _merged([(s, e) for s, e in iv if e > s]))


def idle_gaps(events, window, main_tid, top=10):
    """The ``top`` longest stretches of ``window`` with nothing on the card,
    each named by the innermost span, the harness's or the program's, of
    the main thread at its middle (``kmer.dump.write``; "count" when none
    inside a count, "between counts" outside): [[name, seconds], ...]."""
    lo, hi = window
    busy = _merged([(e["ts"], e["ts"] + e["dur"]) for e in events if e["kind"] == "device"])
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        gaps.append((t, hi))
    spans = [e for e in events if e["kind"] == "span" and e["tid"] == main_tid]
    out = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = (s + e) / 2
        inner = [x for x in spans if x["ts"] <= mid <= x["ts"] + x["dur"]]
        name = min(inner, key=lambda x: x["dur"])["name"] if inner else "between counts"
        out.append([name, (e - s) / 1e6])
    return out


def device_ops(events, window, top=10):
    """The ``top`` device operations by time in ``window``, launches of one
    name summed: [[name, seconds], ...]."""
    lo, hi = window
    by_name: dict = {}
    for e in events:
        if e["kind"] == "device" and lo <= e["ts"] <= hi:
            by_name[short_name(e["name"])] = by_name.get(short_name(e["name"]), 0.0) + e["dur"] / 1e6
    return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]


def short_name(name: str) -> str:
    """A kernel's name without its arguments; a copy's or fill's whole."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0][:96]


def main_tid(events):
    """The thread that ran the ``count`` spans."""
    for e in events:
        if e["kind"] == "span" and e["name"] == "count":
            return e["tid"]
    return None
