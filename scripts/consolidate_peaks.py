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
consolidate3, the chunk step, grow2 and finalize2.  Prints, per path, the
run's peak device memory, each step's, and the steps whose peak is the
run's ("set_by": the innermost; consolidate3 alone means a line of its own
between or after its steps, such as a copy of the prefix).

``--root`` imports ``kmer_counter_tpu_torch`` from DIR (an unpacked ``git
archive`` of another commit); the input and the wrapping stay this
checkout's.
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    root = os.path.abspath(ap.parse_args().root)
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
    cases = cs.load_test_cases()
    stages = [(pipeline, "count_step_two_level"), (table2, "grow2"), (table2, "consolidate3"),
              (table2, "finalize2"), *((table2, name) for name in STEPS)]
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
