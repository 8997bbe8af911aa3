#!/usr/bin/env python3
"""Peak device memory of each step of the two-level consolidation, on one
NVIDIA GPU.

    python3 scripts/consolidate_peaks.py              # this checkout
    python3 scripts/consolidate_peaks.py --root DIR   # another tree of the port

Runs chip_smoke.py's main count (2M reads x 100 bp, k=31 canonical,
gpuMemoryLimit=8e9, the two-level table) once with the default
consolidation and once with table2.consolidate3 bound to each split
variant, with each step of a consolidation wrapped by chip_smoke.py's
stage_peaks: the raw sort (_sort_raw_desc, _sort_raw_ones, _sort_raw), the
merge kernel (K1, K3, K4 or K5), the torch fold of K5's variant
(_fold_counts_in_place) and the compaction K2, and around them
consolidate3, the chunk step (count_step_two_level, and inside it K8's
extract_chunk_keys_into where the tree has K8), grow2 and finalize2.
Prints, per path, the
run's peak device memory, each step's, and the steps whose peak is the
run's ("set_by": the innermost; consolidate3 alone means a line of its own
between or after its steps, such as a copy of the prefix).  Then counts
the default path once more with each step's peak beside the one budget.py
reckons, and its plan (as with ``--workload`` below).

``--root`` imports ``kmer_counter_tpu_torch`` from DIR (an unpacked ``git
archive`` of another commit); the input and the wrapping stay this
checkout's.

    python3 scripts/consolidate_peaks.py --spill [--k K]

runs instead chip_smoke.py's spill count (2M reads x 100 bp from a
200-Mbase genome, k=31 canonical or K, gpuMemoryLimit=2e9,
tempFileLocation set) with each table, and prints beside each step's
measured peak the peak that kmer_counter_tpu_torch.budget reckons for it:
the largest over the run's calls of that step, at the sizes each call was
given (the table's slots, the raw rows, the rows the finalize sorts).  A
step measured above its reckoned peak means the model, and so the caps
the engine spills at, is too optimistic there.

    python3 scripts/consolidate_peaks.py --workload CELL --seed N [--root DIR]

counts instead a benchmark cell's read set (gpubench: its configuration's
flags, its traffic made from the seed; CELL a workload of BENCHMARK.json,
or CONFIG.TRAFFIC, the files of those names, declared or not), once to
load the kernels and once measured, and prints, beside each step's
measured and reckoned peaks, the table's plan: each consolidation's prefix
and raw slots and raw rows, each growth, and the rows the finalize sorts
(two-level), or each sort's and growth's slots (one-level).
"""

import argparse
import functools
import importlib.util
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = ("_sort_raw_desc", "_sort_raw_ones", "_sort_raw", "merge_fold_compact", "merge_sorted_runs_fold_bitonic",
         "merge_sorted_runs_fold", "merge_sorted_runs", "_fold_counts_in_place", "compact_live")


def k8_stages(name):
    """[(ops.fused_extract, name)] where the tree on sys.path has K8, else []."""
    try:
        from kmer_counter_tpu_torch.ops import fused_extract
    except ImportError:
        return []
    return [(fused_extract, name)]


def reckoned_count(cs, device, opts, line_length):
    """One count of ``opts`` with each step's peak measured, and the peak
    the budget model reckons for it at the sizes each call was given (the
    table's slots, the raw rows, the growth, the rows the finalize sorts);
    returns (the run's measured peak, step -> measured peak, step ->
    reckoned peak, the table's plan: one entry a consolidation, growth and
    finalize, in order)."""
    import torch

    from kmer_counter_tpu_torch import budget, records
    from kmer_counter_tpu_torch.engine import plan_chunks, run_count
    from kmer_counter_tpu_torch.ops import pipeline, table, table2
    from kmer_counter_tpu_torch.ops.pipeline import chunk_slots

    k = opts.kmer_length
    NL = records.active_lanes(k)
    reads_per_chunk, _ = plan_chunks(opts, line_length)
    chunk = budget.Chunk(reads_per_chunk * line_length, chunk_slots(reads_per_chunk, line_length, k))
    limit = opts.memory_limit_bytes
    model, plan = {}, []

    def keep(peaks, steps=None):
        for step, bytes_ in peaks.items():
            if steps is None or step in steps:
                model[step] = max(model.get(step, 0), bytes_)

    def consolidate3(t, *a, **kw):
        cp, cr = t.prefix_lanes.shape[1], t.raw_lanes.shape[1]
        plan.append({"consolidate": {"prefix": cp, "raw": cr, "raw_rows": t.raw_off}})
        keep(budget.two_level_peaks(NL, cp, cr, t.raw_off, chunk, limit=limit))

    def grow2(t, cp, cr):
        plan.append({"grow": {"prefix": [t.prefix_lanes.shape[1], cp], "raw": [t.raw_lanes.shape[1], cr]}})
        keep(budget.two_level_peaks(NL, cp, cr, 0, chunk, grow_from=t.prefix_lanes.shape[1], limit=limit), ["grow2"])

    def finalize2(t, live=None):
        rows = t.prefix_lanes.shape[1] if live is None else live
        plan.append({"finalize": {"prefix": t.prefix_lanes.shape[1], "rows": rows}})
        keep(budget.two_level_peaks(NL, t.prefix_lanes.shape[1], 0, 0, chunk, finalize_rows=rows, limit=limit),
             ["finalize2"])

    def consolidate(t):
        plan.append({"consolidate": {"slots": t.lanes.shape[1], "rows": t.offset}})
        keep(budget.one_level_peaks(NL, t.lanes.shape[1], chunk, limit=limit))

    def grow(t, n):
        plan.append({"grow": {"slots": [t.lanes.shape[1], n]}})
        keep(budget.one_level_peaks(NL, n, chunk, grow_from=t.lanes.shape[1], limit=limit), ["grow"])

    sizes = {(table2, "consolidate3"): consolidate3, (table2, "grow2"): grow2, (table2, "finalize2"): finalize2,
             (table, "consolidate"): consolidate, (table, "grow"): grow}

    def reckoned(size, real):
        def call(*args, **kw):
            size(*args, **kw)
            return real(*args, **kw)

        return call

    if opts.table_impl == "one":
        stages = [(pipeline, "extract_chunk"), *k8_stages("extract_chunk_lanes_major"), (table, "append"),
                  (table, "grow"), (table, "consolidate")]
    else:
        stages = [(pipeline, "count_step_two_level"), *k8_stages("extract_chunk_keys_into"), (table2, "grow2"),
                  (table2, "consolidate3"), (table2, "finalize2"), (table2, "_sort_raw_desc"),
                  (table2, "merge_fold_compact")]
    reals = {key: getattr(*key) for key in sizes}
    for (module, name), size in sizes.items():
        setattr(module, name, reckoned(size, reals[(module, name)]))
    try:
        peaks = cs.stage_peaks(device, lambda: run_count(opts, device), stages)
    finally:
        for (module, name), real in reals.items():
            setattr(module, name, real)
    torch.cuda.empty_cache()
    measured = {name.rsplit(".", 1)[1]: p for name, p in peaks.items() if name != "run"}
    return peaks["run"], measured, {step: model.get(step) for step in measured}, plan


def report(cs, path, opts, run_peak, measured, model, plan, **extra):
    from kmer_counter_tpu_torch import records

    reckoned = [m for m in model.values() if m is not None]
    cs.log({"path": path, "k": opts.kmer_length, "NL": records.active_lanes(opts.kmer_length),
            "canonical": opts.canonical, **extra, "peak_device_bytes": run_peak,
            "gpu_memory_limit": opts.memory_limit_bytes, "step_peak_device_bytes": measured,
            "reckoned_peak_bytes": model, "reckoned_run_peak_bytes": max(reckoned) if reckoned else None,
            "steps_above_reckoned": sorted(step for step, m in measured.items()
                                           if model[step] is not None and m > model[step]),
            "plan": plan})


def spill_peaks(cs, device, tmp, k):
    """Measured and reckoned peaks of each step of the spill count at k,
    per table (see the module docstring)."""
    from kmer_counter_tpu_torch import Options
    from kmer_counter_tpu_torch.engine import plan_chunks

    _, in_dir = cs.spill_input(tmp)
    for impl in ("two", "one"):
        argv = [f"kmerLength={k}", "canonical=true", f"gpuMemoryLimit={cs.SPILL_LIMIT}",
                f"inputFileLocation={in_dir}", f"outputFile={os.path.join(tmp, 'out.bin')}",
                f"tempFileLocation={os.path.join(tmp, 'spill_' + impl)}", "verbose=0", f"tableImpl={impl}"]
        opts = Options.from_argv(argv)
        report(cs, "spill" if impl == "two" else "spill_one", opts, *reckoned_count(cs, device, opts, cs.MAIN_L),
               reads_per_chunk=plan_chunks(opts, cs.MAIN_L)[0])


def cell_peaks(cs, device, tmp, workload, seed):
    """Measured and reckoned peaks of each step, and the plan, of one count
    of a benchmark cell's read set with the cell's flags (a first count
    loads the kernels).  ``workload`` is a cell of BENCHMARK.json, or
    ``CONFIG.TRAFFIC``: the configuration file and the traffic mix of those
    names under gpubench/, declared or not."""
    sys.path.insert(1, HERE)
    from gpubench import cells
    from gpubench.traffic import generate

    from kmer_counter_tpu_torch import Options
    from kmer_counter_tpu_torch.engine import run_count

    try:
        cell = cells.resolve(workload)
    except KeyError:
        config, traffic = workload.split(".", 1)
        files = [os.path.join(cells.BENCH_DIR, folder, f"{name}.json")
                 for folder, name in (("configs", config), ("traffic", traffic))]
        loaded = []
        for path in files:
            with open(path) as fh:
                loaded.append(json.load(fh))
        cell = cells.Cell(name=workload, config=loaded[0], traffic=loaded[1], chips=1, end_to_end=[], per_layer=[])
    reads = generate.make_reads(cell.traffic, seed)
    in_dir = os.path.join(tmp, "in")
    generate.write_read_set(in_dir, cell.traffic, reads)
    opts = Options.from_argv(cell.argv() + [f"inputFileLocation={in_dir}",
                                            f"outputFile={os.path.join(tmp, 'out.bin')}", "verbose=0"])
    run_count(opts, device)
    report(cs, workload, opts, *reckoned_count(cs, device, opts, reads.shape[1]), seed=seed,
           reads_per_chunk=opts.reads_per_chunk)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--spill", action="store_true", help="the spill count, measured beside the budget model")
    ap.add_argument("--k", type=int, default=None, help="k of the spill count (default chip_smoke.py's, 31)")
    ap.add_argument("--workload", default=None, help="a benchmark cell whose read set and flags to count")
    ap.add_argument("--seed", type=int, default=1, help="the cell's seed (with --workload)")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("consolidate_peaks.py needs an NVIDIA GPU")
    from kmer_counter_tpu_torch import Options
    from kmer_counter_tpu_torch.engine import run_count
    from kmer_counter_tpu_torch.ops import pipeline, table2

    if not table2.__file__.startswith(root + os.sep):
        raise SystemExit(f"imported {table2.__file__}, not the tree under {root}")
    cs.log(cs.smi_line())
    cs.log({"tree": os.path.relpath(root, HERE)})
    device = torch.device("cuda")
    if args.spill or args.workload:
        with tempfile.TemporaryDirectory(dir=HERE, prefix="chip_smoke_") as tmp:
            if args.workload:
                cell_peaks(cs, device, tmp, args.workload, args.seed)
            else:
                spill_peaks(cs, device, tmp, args.k or cs.MAIN_K)
        return
    cases = cs.load_test_cases()
    stages = [(pipeline, "count_step_two_level"), *k8_stages("extract_chunk_keys_into"), (table2, "grow2"),
              (table2, "consolidate3"), (table2, "finalize2"), *((table2, name) for name in STEPS)]
    real = table2.consolidate3
    with tempfile.TemporaryDirectory(dir=HERE, prefix="chip_smoke_") as tmp:
        _, argv = cs.main_input(tmp)
        opts = Options.from_argv(argv + ["verbose=0", "tableImpl=two"])
        for variant in ("merge_fold_compact", *cases.SPLIT_VARIANTS):
            kw = cases.CONSOLIDATE_VARIANTS[variant]
            table2.consolidate3 = functools.partial(real, **kw)
            try:
                peaks = cs.stage_peaks(device, lambda: run_count(opts, device), stages)
            finally:
                table2.consolidate3 = real
            torch.cuda.empty_cache()
            set_by = [name for name, p in peaks.items() if name != "run" and p == peaks["run"]]
            cs.log({"path": "main" if variant == "merge_fold_compact" else f"main_{variant}",
                    "consolidate3": kw, "peak_device_bytes": peaks["run"], "gpu_memory_limit": cs.MEMORY_LIMIT,
                    "set_by": [name for name in set_by if name != "table2.consolidate3"] or set_by,
                    "step_peak_device_bytes": peaks})
        report(cs, "main", opts, *reckoned_count(cs, device, opts, cs.MAIN_L))


if __name__ == "__main__":
    main()
