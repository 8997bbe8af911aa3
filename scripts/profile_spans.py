#!/usr/bin/env python3
"""Whole counts of a benchmark cell's read set, plain and with
``profile=true``, and what the program's spans show in each trace.

    python3 scripts/profile_spans.py --workload k31c_two.ecoli_err --seed N [--counts 3] [--root DIR]

Imports the program from ``--root`` (default: this checkout), so the same
script times another tree, e.g. a parent commit unpacked under
``_checkout/``.  The cell's read set (gpubench/traffic, from the seed) is
written once as FASTQ into TMPDIR; after one warm-up count come
``--counts`` rounds of a plain count and a ``profile=true`` count with the
cell's flags, each the wall of one call of the CLI entry
(``__main__.main``).  Each trace (``<outputFile>.trace/trace.json``) is
read back: the main thread's ``kmer.*`` spans summed by name, the
prefetch thread's, the part of ``kmer.run`` that no other main-thread
span covers, the rate of the device-to-host copies launched inside
``kmer.run`` (the ``d2h_bytes`` counter, the finalize's copy of the counts
and the dump's record image, over their device time), and the longest stretches with nothing on the card, each named by
the innermost program span at its middle.  A tree without the spans gives
the walls alone.  One JSON line a count on standard output, and one with
the medians last."""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREFIX = "kmer."
D2H = "Memcpy DtoH"


def program_spans(trace: dict) -> list[dict]:
    """The trace's ``kmer.*`` ranges as span events under their full names."""
    out = []
    for e in trace.get("traceEvents", []):
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e.get("name", "").startswith(PREFIX):
            out.append(dict(kind="span", name=e["name"], ts=float(e["ts"]), dur=float(e.get("dur", 0.0)),
                            tid=e.get("tid")))
    return out


def uncovered_us(run: dict, inner: list[dict]) -> float:
    """Microseconds of the ``run`` span that none of ``inner`` covers."""
    lo, hi = run["ts"], run["ts"] + run["dur"]
    covered, end = 0.0, lo
    for s, e in sorted((max(x["ts"], lo), min(x["ts"] + x["dur"], hi)) for x in inner):
        if e > end:
            covered += e - max(s, end)
            end = e
    return run["dur"] - covered


def read_trace(path: str, d2h_bytes: int | None, tr) -> dict:
    """What one count's trace shows of the program's spans."""
    with open(path) as fh:
        trace = json.load(fh)
    spans = program_spans(trace)
    runs = [s for s in spans if s["name"] == PREFIX + "run"]
    if len(runs) != 1:
        return {"program_spans": len(spans)}
    run = runs[0]
    main = [s for s in spans if s["tid"] == run["tid"] and s is not run]
    other = [s for s in spans if s["tid"] != run["tid"]]
    events = tr.read_chrome_trace(trace) + spans
    window = (run["ts"], run["ts"] + run["dur"])
    d2h = [e for e in events if e["kind"] != "device" or e["name"].startswith(D2H)]
    us, n = tr.layer_device_us(d2h, PREFIX + "run")
    by_name: dict = {}
    for group, key in ((main, "main_ms"), (other, "prefetch_ms")):
        sums: dict = {}
        for s in group:
            sums[s["name"]] = sums.get(s["name"], 0.0) + s["dur"] / 1e3
        by_name[key] = sums
    return {
        "run_ms": run["dur"] / 1e3,
        **by_name,
        "unspanned_ms": uncovered_us(run, main) / 1e3,
        "d2h_copies": n,
        "d2h_device_ms": us / 1e3,
        "d2h_gbps": d2h_bytes / (us * 1e3) if n and us > 0 and d2h_bytes else None,
        "device_busy_ms": tr.busy_us(events, window) / 1e3,
        "idle_gaps": tr.idle_gaps(events, window, run["tid"], top=6),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--counts", type=int, default=3)
    p.add_argument("--root", default=HERE, help="the tree whose program is counted")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, HERE)
    from gpubench import cells
    from gpubench import trace as tr
    from gpubench.traffic import generate

    cell = cells.resolve(args.workload, HERE)
    sys.path.insert(0, root)
    import torch

    from kmer_counter_tpu_torch import __main__ as cli
    from kmer_counter_tpu_torch import engine

    if not os.path.abspath(cli.__file__).startswith(root + os.sep):
        raise RuntimeError(f"the program was imported from {cli.__file__}, not from {root}")
    caught = []
    run_count = engine.run_count

    def catching(*a, **kw):
        caught.append(run_count(*a, **kw))
        return caught[-1]

    engine.run_count = catching
    device = torch.device(args.device)
    tmp = tempfile.mkdtemp(prefix="profile-spans-")
    try:
        reads = generate.make_reads(cell.traffic, args.seed)
        generate.write_read_set(os.path.join(tmp, "in"), cell.traffic, reads)
        del reads
        base = cell.argv() + [f"inputFileLocation={os.path.join(tmp, 'in')}"]

        def count(profile: bool, i: int) -> dict:
            out = os.path.join(tmp, f"out{i}.bin")
            argv = base + [f"outputFile={out}"] + (["profile=true"] if profile else [])
            caught.clear()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(sys.stderr):
                rc = cli.main(argv, device)
            if device.type == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            stats = caught[-1] if caught else None
            line = {"profile": profile, "count": i, "rc": rc, "wall_s": wall,
                    "run_s": stats.wall_seconds if stats else None}
            if profile:
                d2h = (stats.metrics.get("counters", {}).get("d2h_bytes") if stats else None)
                line.update(read_trace(out + ".trace/trace.json", d2h, tr))
                shutil.rmtree(out + ".trace", ignore_errors=True)
            os.unlink(out)
            return line

        count(False, 0)  # warm-up: loads the kernels (and builds them in a fresh tree)
        lines = []
        for i in range(1, args.counts + 1):
            for profile in (False, True):
                lines.append(count(profile, i))
                print(json.dumps(lines[-1]), flush=True)
        summary = {"root": root, "workload": args.workload, "seed": args.seed, "torch": torch.__version__,
                   "card": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu"}
        for profile in (False, True):
            walls = [x["wall_s"] for x in lines if x["profile"] is profile]
            summary["profile_wall_s" if profile else "plain_wall_s"] = statistics.median(walls)
        print(json.dumps(summary), flush=True)
    finally:
        engine.run_count = run_count
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
