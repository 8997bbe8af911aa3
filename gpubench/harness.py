"""One run of a cell: set-up, the measured window, the comparison with the
reference, and the result line.

A run, on the card:

1. set-up (``setup_s``, from the process's start): CUDA, the cell's read
   set made from the seed and written as FASTQ files into ``TMPDIR``, and
   one warm-up count of it (which loads, and in a checkout's first run
   builds, the program's kernels).  The warm-up's dump is kept: it is the
   one compared with the reference;
2. the window: whole counts back to back for ``--seconds``, each a call of
   the program's CLI entry (``kmer_counter_tpu_torch.__main__.main``) in
   this process, from the FASTQ directory to the dump, which goes through
   a named pipe (sink.py) and is compared byte for byte with the first;
   with ``--trace 1`` under torch.profiler, with the layer spans of
   trace.py;
3. after the window, the state freed: the reference (reference/count.py)
   counts the same reads, and the first dump is compared with it.

The result is the last line of standard output; the numbers compared,
each beside its limit, are the last lines of standard error and the last
key of the result."""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

from gpubench import cells, roofline
from gpubench import trace as tr
from gpubench.reference import compare
from gpubench.reference.count import dump_bytes, numpy_count
from gpubench.sink import DumpSink
from gpubench.traffic import generate

FORBIDDEN = ("jax", "jaxlib", "flax", "kmer_counter_tpu")
CACHE_DIR = os.path.join(cells.BENCH_DIR, "cache")


def log(obj) -> None:
    print(json.dumps(obj), file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name, compared whole,
    is JAX's, Flax's or the JAX package's."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


@dataclasses.dataclass
class Count:
    """One call of the CLI: its wall (s), error, dump reading, peak and
    the engine's RunStats."""

    wall: float
    error: str | None
    dump: dict
    peak: int | None
    stats: object | None

    def unlike(self) -> bool:
        return self.dump.get("first_diff") is not None or "error" in self.dump


class Counter:
    """Calls the program's CLI entry in this process on the cell's read set,
    its dump read from the sink; keeps each call's RunStats, caught from
    the engine's ``run_count``."""

    def __init__(self, argv: list[str], device, sink: DumpSink, spans: bool):
        import torch

        from kmer_counter_tpu_torch import __main__ as cli
        from kmer_counter_tpu_torch import engine

        if not os.path.abspath(cli.__file__).startswith(cells.ROOT + os.sep):
            raise RuntimeError(f"the program was imported from {cli.__file__}, not from this checkout")
        self.torch, self.cli, self.engine = torch, cli, engine
        self.argv, self.device, self.sink, self.spans = argv, device, sink, spans
        self.cuda = device is None or torch.device(device).type == "cuda"
        self._stats = []
        run_count = engine.run_count

        def caught(*args, **kwargs):
            stats = run_count(*args, **kwargs)
            self._stats.append(stats)
            return stats

        self._restore = run_count
        engine.run_count = caught

    def close(self) -> None:
        self.engine.run_count = self._restore

    def count(self, expect: bytes | None) -> Count:
        torch = self.torch
        if self.cuda:
            torch.cuda.reset_peak_memory_stats()
        self._stats.clear()
        span = torch.profiler.record_function(tr.PREFIX + "count") if self.spans else contextlib.nullcontext()
        error = None
        t0 = time.perf_counter()
        with span:
            path = self.sink.start(expect)
            try:
                with contextlib.redirect_stdout(sys.stderr):
                    rc = self.cli.main([*self.argv, f"outputFile={path}"], self.device)
                if rc != 0:
                    error = f"main returned {rc}"
            except Exception as e:
                traceback.print_exc(file=sys.stderr)
                error = repr(e)
            dump = self.sink.finish()
            if self.cuda:
                torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() if self.cuda else None
        return Count(wall, error, dump, peak, self._stats[-1] if self._stats else None)


@dataclasses.dataclass
class Window:
    """What a per-layer metric's reader reads: the traced window's counts
    (each with the engine's RunStats) and trace events, the cell's data
    (reads, read length, k, windows, valid windows, distinct keys), the
    device's busy seconds and the traced window's length."""

    counts: list
    data: dict
    events: list | None = None
    busy_s: float | None = None
    window_s: float | None = None

    def timer_ms_per_count(self, name: str):
        """The program's timer ``name`` summed over the counts, ms a count."""
        timers = [c.stats.metrics.get("timers_s", {}) for c in self.counts if c.stats is not None]
        if not timers or not any(name in t for t in timers):
            return None
        return 1e3 * sum(t.get(name, 0.0) for t in timers) / len(self.counts)

    def roofline_pct(self, layer: str, bytes_per_count: int):
        """The share of its roofline of the device work launched inside the
        ``layer`` spans, for ``bytes_per_count`` a count."""
        if not self.events:
            return None
        us, n = tr.layer_device_us(self.events, layer)
        return roofline.roofline_pct(bytes_per_count, len(self.counts), us) if n else None


def reference_digest(cell, seed: int, reads: np.ndarray, log=log, cache_dir: str = CACHE_DIR
                     ) -> tuple[dict, bytes | None]:
    """(the reference's digest, its dump or None): the digest from the cache
    (a fixed directory in the checkout, keyed by the traffic, the seed, k,
    canonical and the generator's and reference's sources), else counted
    now, its dump returned and its digest cached."""
    k, canonical = int(cell.flags["kmerLength"]), bool(cell.flags.get("canonical", False))
    key = hashlib.sha256(json.dumps([cell.traffic, seed, k, canonical], sort_keys=True).encode())
    for src in (generate.__file__, sys.modules[numpy_count.__module__].__file__):
        with open(src, "rb") as fh:
            key.update(fh.read())
    path = os.path.join(cache_dir, key.hexdigest()[:32] + ".json")
    if os.path.exists(path):
        with open(path) as fh:
            return json.load(fh), None
    t0 = time.perf_counter()
    words, counts = numpy_count(reads, k, canonical)
    ref = dump_bytes(words, counts)
    digest = dict(sha256=hashlib.sha256(ref).hexdigest(), nbytes=len(ref), records=int(len(counts)),
                  kmers=int(counts.sum(dtype=np.uint64)), record_size=8 * words.shape[1] + 4)
    del words, counts
    log({"phase": "reference", "seconds": time.perf_counter() - t0, **digest})
    os.makedirs(cache_dir, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(digest, fh)
    os.replace(tmp, path)
    return digest, ref


def judge(cell, seed, reads, first: bytes, log=log, cache_dir: str = CACHE_DIR) -> tuple[int, dict]:
    """(records of the first dump unlike the reference's, the reference's
    digest)."""
    digest, ref = reference_digest(cell, seed, reads, log, cache_dir)
    if ref is None and hashlib.sha256(first).hexdigest() == digest["sha256"] and len(first) == digest["nbytes"]:
        return 0, digest
    if ref is None:  # the cached digest differs: count again to say how far
        k, canonical = int(cell.flags["kmerLength"]), bool(cell.flags.get("canonical", False))
        ref = dump_bytes(*numpy_count(reads, k, canonical))
    return compare.records_wrong(first, ref, digest["record_size"]), digest


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between order statistics."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def power_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e!r}"


def _checks(cell, warm, attempted, records_wrong) -> tuple[dict, set]:
    """(the numbers compared, each with its limit; the ids of the failed
    counts: raised, unlike the first dump, over the memory limit, or all of
    them when the first dump is wrong)."""
    limit = int(cell.flags["gpuMemoryLimit"])
    over = [c for c in attempted if c.peak is not None and c.peak > limit]
    checks = {
        "records_wrong": {"value": records_wrong, "limit": 0},
        "dumps_unlike_first": {"value": sum(1 for c in attempted if c.unlike()), "limit": 0},
        "counts_raised": {"value": sum(1 for c in attempted if c.error), "limit": 0},
        "counts_over_memory": {"value": len(over), "limit": 0},
        "peak_bytes": {"value": max(c.peak or 0 for c in [warm, *attempted]), "limit": limit},
    }
    failed = {id(c) for c in attempted if records_wrong or c.error or c.unlike()} | {id(c) for c in over}
    return checks, failed


def _per_layer(cell, win: Window, events) -> tuple[dict, dict]:
    """(the cell's per-layer metrics that found something to read, the
    trace's breakdown); sets the window's busy and traced seconds."""
    extra = {}
    span = tr.window_of(events) if events else None
    if span is not None:
        win.window_s = (span[1] - span[0]) / 1e6
        win.busy_s = tr.busy_us(events, span) / 1e6
        extra["breakdown"] = {"device_ops": tr.device_ops(events, span),
                              "idle_gaps": tr.idle_gaps(events, span, tr.main_tid(events))}
    metrics = {}
    for m in cell.per_layer:
        value = cell.readers[m["name"]](win)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics, extra


def run(cell, seed: int, seconds: float, traced: bool, device=None, t_start: float | None = None,
        log=log, cache_dir: str = CACHE_DIR, program_flags: dict | None = None) -> dict:
    """One run of ``cell``; ``device`` None is the card.  Returns the result
    (the ``checks`` key last).  ``program_flags`` changes the program's
    flags, not the reference's (the control)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    cuda = device is None or torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.init()
    tmp = tempfile.mkdtemp(prefix="gpubench-")
    try:
        t0 = time.perf_counter()
        reads = generate.make_reads(cell.traffic, seed)
        t1 = time.perf_counter()
        generate.write_read_set(os.path.join(tmp, "in"), cell.traffic, reads)
        t2 = time.perf_counter()
        sink = DumpSink(tmp)
        argv = cell.argv(program_flags) + [f"inputFileLocation={os.path.join(tmp, 'in')}"]
        runs, events = [], None
        with tr.spans_installed() if traced else contextlib.nullcontext():
            counter = Counter(argv, device, sink, traced)
            try:
                warm = counter.count(None)
                if warm.error or "error" in warm.dump:
                    raise RuntimeError(f"the warm-up count failed: {warm.error or warm.dump['error']}")
                first = warm.dump["data"]
                setup_s = time.perf_counter() - t_start
                log({"phase": "setup", "setup_s": setup_s, "before_data_s": t0 - t_start, "reads_s": t1 - t0,
                     "fastq_s": t2 - t1, "warm_up_s": warm.wall, "dump_bytes": len(first), "peak_bytes": warm.peak})

                def window():
                    counts, w0 = [], time.perf_counter()
                    while time.perf_counter() - w0 < seconds:
                        counts.append(counter.count(first))
                    runs.append(counts)
                    return counts, time.perf_counter() - w0

                if traced and cuda:
                    (counts, window_s), events, _ = tr.traced(window, os.path.join(tmp, "trace.json"), log)
                else:
                    counts, window_s = window()
            finally:
                counter.close()
                sink.close()
        attempted = [c for r in runs for c in r]
        walls = [c.wall for c in counts]
        log({"phase": "window", "counts": len(counts), "window_s": window_s, "walls_s": walls,
             "count_p50_s": percentile(walls, 50) if walls else None,
             "count_p95_s": percentile(walls, 95) if walls else None,
             "peak_bytes": max(c.peak or 0 for c in [warm, *attempted]), "card": power_line() if cuda else "cpu"})
        del counter
        if cuda:
            torch.cuda.empty_cache()

        records_wrong, digest = judge(cell, seed, reads, first, log, cache_dir)
        checks, failed = _checks(cell, warm, attempted, records_wrong)
        correct = bool(counts) and all(v["value"] <= v["limit"] for v in checks.values())
        extra = {}
        if traced:
            R, L = reads.shape
            k = int(cell.flags["kmerLength"])
            data = dict(reads=R, read_length=L, k=k, windows=R * max(L - k + 1, 0), valid_windows=digest["kmers"],
                        distinct=digest["records"])
            win = Window(counts=counts, data=data, events=events)
            metrics, extra = _per_layer(cell, win, events)
        else:
            values = {
                "setup_s": setup_s,
                "kmers_per_s": sum(digest["kmers"] for c in counts if id(c) not in failed) / window_s,
            }
            metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                       for m in cell.end_to_end if m["name"] in values}
        dev = {"platform": "gpu" if cuda else "cpu", "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
               "count": cell.chips, "memory_peak_bytes": checks["peak_bytes"]["value"]}
        if traced:
            dev.update(busy_s=win.busy_s, window_s=win.window_s)
        return {"correct": correct, "attempted": len(attempted), "failed": len(failed), "metrics": metrics,
                "device": dev, **extra, "checks": checks}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def limit_visible_cards(chips: int) -> None:
    """A cell on n chips sees the first n cards, so a one-chip cell runs the
    single-device engine on a machine with more."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    ids = visible.split(",") if visible else [str(i) for i in range(chips)]
    os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(ids[:chips])


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse_args(argv)
    cell = cells.resolve(args.workload)
    limit_visible_cards(cell.chips)
    # The program builds with nvcc into its own directory in the checkout;
    # any other kernel cache goes into the checkout too, at fixed paths.
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE_DIR, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE_DIR, "torch_extensions")
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"gpubench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"available={torch.cuda.is_available()} count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run(cell, args.seed, args.seconds, bool(args.trace), None, t_start)
    found = forbidden_modules()
    if found:
        print(f"gpubench: modules loaded that must not be: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']} limit {check['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
