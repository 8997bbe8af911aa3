#!/usr/bin/env python3
"""Where a tile's time goes in the K1/K3/K4 kernel (fold_kernel in
csrc/merge_fold_compact.cu), on one NVIDIA GPU.

    python3 scripts/fold_phases.py              # as the package launches it
    python3 scripts/fold_phases.py --one-block  # one block an SM

Copies the package to _checkout/fold_phases/ (git-ignored) and edits the
copy's kernel so that thread 0 of each block stores clock64() at each phase
boundary of its tile (ticket and counts, splits, staging, merge, fold and
scan, look-back, writes) and the global timer at its start, in scratch
words after the status words.  Then it runs K1 (writing the prefix's na
columns, as consolidate3 asks), K3 and K4 on chip_smoke.py's operands at
time_kernels.py's MAIN_LAUNCH (path-shaped and 80%-live) and K1 at 32M
random rows, NL=2, and prints per phase the median, mean and 90th
percentile in SM clock cycles over the tiles that merged rows, the median
of a sentinel tile, and the span of the tiles' start times.  --one-block
asks for enough shared memory that one block runs on an SM at a time: the
phases without contention from other blocks.
"""

import argparse
import importlib.util
import os
import shutil
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("split", "stage", "merge", "fold_scan", "look_back", "write")


def stamp(k):
    return f"  if (threadIdx.x == 0) {{ dbg[s.t * 8 + {k}] = clock64(); }}\n"


# (text of the kernel, the same with a stamp before or after it)
EDITS = [
    ("  __syncthreads();\n\n  // 1. nsa and nsb",
     "  __syncthreads();\n  if (threadIdx.x == 0) { unsigned long long g; asm volatile(\"mov.u64 %0, %%globaltimer;\" "
     ": \"=l\"(g)); dbg[s.t * 8 + 7] = g; }\n" + stamp(0) + "\n  // 1. nsa and nsb"),
    ("  {  // B's ascending rows [j0, j1)\n", stamp(1) + "  {  // B's ascending rows [j0, j1)\n"),
    ("  const int len = (int)(s.end(kT) - s.d0(kT));\n", stamp(2) + "  const int len = (int)(s.end(kT) - s.d0(kT));\n"),
    ("  // Run ends among the thread's rows", stamp(3) + "  // Run ends among the thread's rows"),
    ("  // 4. Publish, look back, publish.", stamp(4) + "  // 4. Publish, look back, publish."),
    ("  const Fold mine = combine(s_before, excl);", stamp(5) + "  const Fold mine = combine(s_before, excl);"),
    ("kFoldThreads);\n    }\n    return;\n", "kFoldThreads);\n    }\n" + stamp(6) + "    return;\n"),
    ("  }\n}\n\n// K1's rows [min(live total", "  }\n" + stamp(6) + "}\n\n// K1's rows [min(live total"),
    ("  unsigned long long* status = scratch + kHeaderWords;\n",
     "  unsigned long long* status = scratch + kHeaderWords;\n"
     "  long long* dbg = (long long*)(status + kStatusWords * ((na + nb + kT - 1) / kT));\n"),
    ("return tile ? kHeaderWords + kStatusWords * lanes::num_tiles(n, tile) : -1;",
     "return tile ? kHeaderWords + (kStatusWords + 8) * lanes::num_tiles(n, tile) : -1;"),
]
ONE_BLOCK = [("  return (NL + 1) * padded(fold_tile<NL>()) * 4;", "  return 200000;")]
# The wrapper keeps its last scratch, to be read here.
WRAPPER = [("        return out, (scratch[LIVE_TOTAL_WORD] if variant == K1 else None)",
            "        globals()['last_scratch'] = scratch\n"
            "        return out, (scratch[LIVE_TOTAL_WORD] if variant == K1 else None)")]


def edit(path, edits):
    with open(path) as fh:
        text = fh.read()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"{path}: cannot find the text to edit: {old[:60]!r}")
        text = text.replace(old, new)
    with open(path, "w") as fh:
        fh.write(text)


def module_at(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--one-block", action="store_true")
    one_block = ap.parse_args().one_block
    root = os.path.join(HERE, "_checkout", "fold_phases" + ("_one_block" if one_block else ""))
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(HERE, "kmer_counter_tpu_torch"), os.path.join(root, "kmer_counter_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    pkg = os.path.join(root, "kmer_counter_tpu_torch")
    edit(os.path.join(pkg, "csrc", "merge_fold_compact.cu"), EDITS + (ONE_BLOCK if one_block else []))
    edit(os.path.join(pkg, "ops", "merge_fold_compact.py"), WRAPPER)
    sys.path.insert(0, root)
    cs = module_at("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    tk = module_at("time_kernels", os.path.join(HERE, "scripts", "time_kernels.py"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("fold_phases.py needs an NVIDIA GPU")
    from kmer_counter_tpu_torch.ops import merge_fold_compact as mfc
    from kmer_counter_tpu_torch.ops import merge_runs as mr

    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(cs.SEED)
    cs.log(cs.smi_line())

    def phases(label, fn, NL, n):
        for _ in range(4):
            fn()
        torch.cuda.synchronize()
        tiles = -(-n // mfc.tile_rows(NL))
        d = mfc.last_scratch[8 + 6 * tiles:].view(tiles, 8).cpu().numpy()
        merged = d[:, 1] != 0
        dur = {p: d[merged, k + 1] - d[merged, k] for k, p in enumerate(PHASES)}
        start = d[:, 7] - d[:, 7].min()
        cs.log({"label": label, "one_block": one_block, "tiles": tiles, "merged_tiles": int(merged.sum()),
                "start_span_us": float(start.max() / 1e3),
                "cycles_median": {p: float(np.median(v)) for p, v in dur.items()},
                "cycles_mean": {p: float(v.mean()) for p, v in dur.items()},
                "cycles_p90": {p: float(np.percentile(v, 90)) for p, v in dur.items()},
                "sentinel_tile_cycles_median": float(np.median(d[~merged, 6] - d[~merged, 0]))
                if (~merged).any() else None})

    NL, na, nb, *live = tk.MAIN_LAUNCH
    for mix in ("path", "random_80pct_live"):
        shaped = live if mix == "path" else None
        a, b = cs.random_k1_operands(NL, na, nb, gen, device, shaped)
        phases(f"K1 main {mix}", lambda: mfc.merge_fold_compact(a, b, NL, na), NL, na + nb)
        phases(f"K3 main {mix}", lambda: mr.merge_sorted_runs_fold_bitonic(a, b, NL), NL, na + nb)
        del a, b
        a, b = cs.random_merge_operands("merge_sorted_runs_fold", NL, na, nb, gen, device, shaped)
        phases(f"K4 main {mix}", lambda: mr.merge_sorted_runs_fold(a, b, NL), NL, na + nb)
        del a, b
        torch.cuda.empty_cache()
    n = 32 << 20
    a, b = cs.random_k1_operands(2, n // 8, n - n // 8, gen, device)
    phases("K1 NL=2 32M rows random_80pct_live", lambda: mfc.merge_fold_compact(a, b, 2), 2, n)


if __name__ == "__main__":
    main()
