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
between or after its steps, such as a copy of the prefix).

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
"""

import argparse
import functools
import importlib.util
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


def spill_peaks(cs, device, tmp, k):
    """Measured and reckoned peaks of each step of the spill count at k,
    per table (see the module docstring)."""
    import torch

    from kmer_counter_tpu_torch import Options, budget, records
    from kmer_counter_tpu_torch.engine import plan_chunks, run_count
    from kmer_counter_tpu_torch.ops import pipeline, table, table2
    from kmer_counter_tpu_torch.ops.pipeline import chunk_slots

    _, in_dir = cs.spill_input(tmp)
    NL = records.active_lanes(k)
    for impl in ("two", "one"):
        argv = [f"kmerLength={k}", "canonical=true", f"gpuMemoryLimit={cs.SPILL_LIMIT}",
                f"inputFileLocation={in_dir}", f"outputFile={os.path.join(tmp, 'out.bin')}",
                f"tempFileLocation={os.path.join(tmp, 'spill_' + impl)}", "verbose=0", f"tableImpl={impl}"]
        opts = Options.from_argv(argv)
        reads_per_chunk, _ = plan_chunks(opts, cs.MAIN_L)
        chunk = budget.Chunk(reads_per_chunk * cs.MAIN_L, chunk_slots(reads_per_chunk, cs.MAIN_L, k))
        model = {}

        def keep(peaks, steps=None):
            for step, bytes_ in peaks.items():
                if steps is None or step in steps:
                    model[step] = max(model.get(step, 0), bytes_)

        # The model at the sizes each call is given (the table's slots, the
        # raw rows, the growth, the rows the finalize sorts).
        sizes = {
            (table2, "consolidate3"): lambda t, *a, **kw: keep(budget.two_level_peaks(
                NL, t.prefix_lanes.shape[1], t.raw_lanes.shape[1], t.raw_off, chunk)),
            (table2, "grow2"): lambda t, cp, cr: keep(budget.two_level_peaks(
                NL, cp, cr, 0, chunk, grow_from=t.prefix_lanes.shape[1]), ["grow2"]),
            (table2, "finalize2"): lambda t, live=None: keep(budget.two_level_peaks(
                NL, t.prefix_lanes.shape[1], 0, 0, chunk,
                finalize_rows=t.prefix_lanes.shape[1] if live is None else live), ["finalize2"]),
            (table, "consolidate"): lambda t: keep(budget.one_level_peaks(NL, t.lanes.shape[1], chunk)),
            (table, "grow"): lambda t, n: keep(budget.one_level_peaks(
                NL, n, chunk, grow_from=t.lanes.shape[1]), ["grow"]),
        }

        def reckoned(size, real):
            def call(*args, **kw):
                size(*args, **kw)
                return real(*args, **kw)

            return call

        if impl == "one":
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
        model_steps = {step: model.get(step) for step in measured}
        cs.log({"path": "spill" if impl == "two" else "spill_one", "k": k, "NL": NL,
                "reads_per_chunk": reads_per_chunk, "peak_device_bytes": peaks["run"],
                "gpu_memory_limit": cs.SPILL_LIMIT, "step_peak_device_bytes": measured,
                "reckoned_peak_bytes": model_steps, "reckoned_run_peak_bytes": max(model.values()),
                "steps_above_reckoned": sorted(step for step, m in measured.items()
                                               if model_steps[step] is not None and m > model_steps[step])})


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--spill", action="store_true", help="the spill count, measured beside the budget model")
    ap.add_argument("--k", type=int, default=None, help="k of the spill count (default chip_smoke.py's, 31)")
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
    if args.spill:
        with tempfile.TemporaryDirectory(dir=HERE, prefix="chip_smoke_") as tmp:
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


if __name__ == "__main__":
    main()
