#!/usr/bin/env python3
"""Which records a torch.profiler trace loses once a process has run
counts, on one NVIDIA GPU.

    python3 scripts/trace_loss.py              # this checkout
    python3 scripts/trace_loss.py --root DIR   # another tree of the port

Imports ``kmer_counter_tpu_torch`` from DIR (an unpacked ``git archive``
of another commit), writes a FASTQ file of 400,000 random 100 bp reads
and, in one process, takes probe traces: 64 in-place adds on the card,
each probe's CUDA activity exported as a Chrome trace.  A probe prints
how many of its 64 launch calls have no kernel record ("n_lost", and the
first indices lost), and, for the kept kernels, the kernel's start less
its launch call's start ("lag_us": a negative lag means the card's
timestamps run behind the host's).  A probe with ``gap_s`` first waits
that long inside the trace: a loss that is a time window shrinks with
it, a loss counted in records does not.

The sequence: two probes on a fresh process; one two-level count
(8 chunks of 50,000 reads, k=31 canonical); three probes; a second
count traced whole (its K8 launches and chunk-sized host-to-device
copies against its chunks); four more counts (one-level, and 50 chunks
with each table); three probes; a sixth count traced whole; two probes.
Run it for two trees in turns to compare them.

    python3 scripts/trace_loss.py --phases [--root DIR]

runs instead DIR's chip_smoke.py phases that count (main, feed where the
tree has it, mesh, mesh_mp, spill, mesh_spill, in chip_smoke.py's order),
with a probe after every ``engine.run_count`` of the process (tagged with
the run's table, spill and checkpoint settings, also when the run raised;
none after a run that a phase traces itself) and after each phase: where
in a whole smoke run the loss begins.
"""

import argparse
import json
import os
import sys
import tempfile
import time


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    help="the tree whose kmer_counter_tpu_torch is imported")
    ap.add_argument("--label", default=None, help="the name printed on each line (default: --root)")
    ap.add_argument("--phases", action="store_true", help="probe through chip_smoke.py's counting phases")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    label = args.label or args.root
    sys.path.insert(0, root)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import kmer_counter_tpu_torch

    if not kmer_counter_tpu_torch.__file__.startswith(root):
        raise SystemExit(f"imported {kmer_counter_tpu_torch.__file__}, not the tree under {root}")
    if not torch.cuda.is_available():
        raise SystemExit("trace_loss.py runs only on an NVIDIA GPU")
    from kmer_counter_tpu_torch import Options
    from kmer_counter_tpu_torch.engine import run_count

    device = torch.device("cuda")
    x = torch.ones(1 << 16, device=device)
    torch.cuda.synchronize()

    def read_trace(prof):
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as fh:
                return [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"]

    def probe(tag, gap_s=0.0, n=64):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            if gap_s:
                time.sleep(gap_s)
            for _ in range(n):
                x.add_(1)
            torch.cuda.synchronize()
        events = read_trace(prof)
        launches = {e["args"]["correlation"]: e for e in events
                    if e.get("cat") == "cuda_runtime" and "aunchKernel" in e["name"]}
        kernels = {e["args"]["correlation"]: e for e in events if e.get("cat") == "kernel"}
        order = sorted(launches)
        lost = [i for i, c in enumerate(order) if c not in kernels]
        lags = [kernels[c]["ts"] - launches[c]["ts"] for c in order if c in kernels]
        print(json.dumps({"who": label, "tag": tag, "gap_s": gap_s, "launch_records": len(launches),
                          "kernel_records": len(kernels), "lost_idx": lost[:4], "n_lost": len(lost),
                          "lag_us_first": lags[:3], "lag_us_min": min(lags) if lags else None,
                          "lag_us_median": sorted(lags)[len(lags) // 2] if lags else None}), flush=True)

    if args.phases:
        return smoke_phases(root, device, probe)

    with tempfile.TemporaryDirectory() as d:
        rng = np.random.default_rng(1)
        R, L = 400_000, 100
        reads = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (R, L))]
        rec = np.empty((R, 2 * L + 7), np.uint8)
        rec[:, :3] = np.frombuffer(b"@r\n", np.uint8)
        rec[:, 3:3 + L] = reads
        rec[:, 3 + L:6 + L] = np.frombuffer(b"\n+\n", np.uint8)
        rec[:, 6 + L:6 + 2 * L] = ord("I")
        rec[:, -1] = ord("\n")
        os.makedirs(os.path.join(d, "in"))
        rec.tofile(os.path.join(d, "in", "a.fastq"))

        def opts(impl, reads_per_chunk):
            return Options.from_argv(["kmerLength=31", "canonical=true", f"tableImpl={impl}",
                                      f"inputFileLocation={d}/in", f"outputFile={d}/o.bin",
                                      f"readsPerChunk={reads_per_chunk}", "verbose=0", "tableSlots=4000000"])

        def traced_run(tag, o):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                stats = run_count(o, device)
                torch.cuda.synchronize()
            events = read_trace(prof)
            k8 = [e for e in events if e.get("cat") == "kernel" and "extract_kernel<" in e["name"]]
            h2d = [e for e in events if e.get("cat") == "gpu_memcpy" and "HtoD" in e["name"]
                   and (e["args"].get("bytes") or 0) >= 50_000 * L]
            print(json.dumps({"who": label, "tag": tag, "chunks": stats.chunks, "k8_in_trace": len(k8),
                              "chunk_h2d_in_trace": len(h2d)}), flush=True)

        probe("fresh")
        probe("fresh")
        run_count(opts("two", 50_000), device)
        torch.cuda.synchronize()
        probe("after 1 run")
        probe("after 1 run")
        probe("after 1 run", 0.05)
        traced_run("second run traced", opts("two", 50_000))
        for impl, reads_per_chunk in (("one", 50_000), ("two", 8_000), ("one", 8_000)):
            run_count(opts(impl, reads_per_chunk), device)
        torch.cuda.synchronize()
        probe("after 5 runs")
        probe("after 5 runs")
        probe("after 5 runs", 0.05)
        traced_run("sixth run traced", opts("two", 8_000))
        probe("end")
        probe("end", 0.05)


def smoke_phases(root, device, probe):
    """chip_smoke.py's counting phases from ``root``, a probe after every
    run_count and after each phase."""
    import importlib.util

    import torch

    from kmer_counter_tpu_torch import engine

    spec = importlib.util.spec_from_file_location("chip_smoke_of_tree", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cs.require_checkout()
    real, runs = engine.run_count, [0]

    def run_count(opts, *args, **kw):
        runs[0] += 1
        tag = (f"run {runs[0]}: {opts.table_impl}, spill={bool(opts.temp_dir)}, "
               f"checkpoint={bool(opts.checkpoint_dir)}, mesh={kw.get('mesh') is not None or len(args) > 1}")
        try:
            return real(opts, *args, **kw)
        except BaseException:
            tag += ", raised"
            raise
        finally:
            torch.cuda.synchronize()
            if not torch._C._autograd._profiler_enabled():  # not inside a phase's own trace
                probe(tag)

    engine.run_count = run_count
    cases = cs.load_test_cases()
    cs.phase_build()
    probe("fresh, kernels built")
    with tempfile.TemporaryDirectory(dir=root, prefix="chip_smoke_") as tmp:
        _, main_ctx = cs.phase_main(device, tmp, cases)
        torch.cuda.empty_cache()
        probe("after phase main")
        if hasattr(cs, "phase_feed"):
            cs.phase_feed(device, tmp, main_ctx)
            torch.cuda.empty_cache()
            probe("after phase feed")
        cs.phase_mesh(device, tmp, main_ctx)
        probe("after phase mesh")
        cs.phase_mesh_mp(device, tmp, main_ctx)
        probe("after phase mesh_mp")
        del main_ctx
        _, spill_ctx = cs.phase_spill(device, tmp)
        torch.cuda.empty_cache()
        probe("after phase spill")
        cs.phase_mesh_spill(device, tmp, spill_ctx)
        torch.cuda.empty_cache()
        probe("after phase mesh_spill")


if __name__ == "__main__":
    main()
