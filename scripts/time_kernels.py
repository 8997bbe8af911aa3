#!/usr/bin/env python3
"""Times the kernels of one tree of the port on one NVIDIA GPU with
chip_smoke.py's own kernel-phase code: its random operands per NL (the
sort, K1 and K3 at about 8M and 32M rows, K2 at about 8M rows a third
live, K4 and K5 at about 8M rows, K8 at each k of its random shapes),
K1 and K3-K5 at the main path's largest launch shape on operands shaped as
that path gives them (MAIN_LAUNCH) and on the 80%-live mix of earlier
runs, K8 at the main path's chunk (chip_smoke.MAIN_K8_LAUNCH), its checks
against the plain versions, its CUDA-event timing in turns and its traced
device time per CUDA kernel; and ``chunk_step``, the two-level chunk step
(ops.pipeline.count_step_two_level) at the main path's chunk, whatever
kernels the tree runs there (chip_smoke.time_chunk_step: a tree before K8
runs the plain torch chain); and ``probes``, D1-D7 (chip_smoke.phase_probes:
the three probe harnesses traced, then each probe kernel at each launch
shape of its harness against its plain version and the probe's NumPy
check, timed, and at the edge and random shapes).  So one chip call can
time two commits in turns (A, B, B, A):

    python3 scripts/time_kernels.py              # this checkout
    python3 scripts/time_kernels.py --root DIR   # another tree of the port
    python3 scripts/time_kernels.py --kernels merge_fold_compact,merge_sorted_runs_fold_bitonic
    python3 scripts/time_kernels.py --kernels chunk_step --root DIR
    python3 scripts/time_kernels.py --kernels probes --root DIR

``--root`` imports ``kmer_counter_tpu_torch`` from DIR (an unpacked ``git
archive`` of another commit), which builds its kernels from its own
``csrc/``; the operands, checks and timing stay this checkout's.
``--kernels`` times only the named ones (chip_smoke.py's names,
``chunk_step`` and ``probes``).  Prints
the card's name and power limit, chip_smoke.py's kernel lines, then each
source's nvcc report (registers, spills).
"""

import argparse
import importlib.util
import inspect
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The largest launch of K1 in chip_smoke.py's main path (its third
# consolidation), as its launch_shapes log it: (NL, na, nb, A's live rows,
# B's live rows, B's live rows with the sentinel key); K1 writes na columns
# there (the prefix's).
MAIN_LAUNCH = (2, 166_666_500, 97_222_223, 4_599_964, 55_555_500, 21_626_652)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--kernels", default=None, help="comma-separated; default: all")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_kernels.py needs an NVIDIA GPU")
    from kmer_counter_tpu_torch import cuda_build
    from kmer_counter_tpu_torch.ops import lane_sort
    from kmer_counter_tpu_torch.ops import merge_fold_compact as mfc

    if not lane_sort.__file__.startswith(root + os.sep):
        raise SystemExit(f"imported {lane_sort.__file__}, not the tree under {root}")
    cs.log(cs.smi_line())
    cs.log({"tree": os.path.relpath(root, HERE)})
    device = torch.device("cuda")
    cases = cs.load_test_cases()
    gen = torch.Generator(device=device).manual_seed(cs.SEED)
    names = args.kernels.split(",") if args.kernels else [
        cs.SORT["name"], cs.K2["name"], cs.K1["name"], *cs.MERGES, cs.K8["name"], "chunk_step", "probes"]
    for name in names:
        if name == "chunk_step":
            cs.time_chunk_step(device)
        elif name == "probes":
            cs.phase_probes(device, cases)
        elif name == cs.K8["name"]:
            cs.k8_random_shapes(device, cases)
            R, L, k, canonical, mode = cs.MAIN_K8_LAUNCH
            t = cs.compare_k8(cs.path_reads("main", R, L, device), k, canonical, mode, time_it=True)
            cs.log({"phase": "kernel", "kernel": name, "path": "main", "main_path_launch_shape": True, "R": R,
                    "L": L, "k": k, "canonical": canonical, "mode": mode, "bit_exact": True, **t})
        elif name == cs.SORT["name"]:
            cs.sort_random_shapes(device, cases, gen)
        elif name == cs.K2["name"]:
            cs.k2_random_shapes(device, gen)
        elif name == cs.K1["name"]:
            cs.k1_random_shapes(device, gen)
            # the prefix's columns, where the tree's K1 takes an output width
            takes_width = "out_rows" in inspect.signature(mfc.merge_fold_compact).parameters
            out_rows = MAIN_LAUNCH[1] if takes_width else None
            cs.k1_at_shape("main", (*MAIN_LAUNCH, out_rows), gen, device)
        else:
            cs.merge_random_shapes(device, cases, gen, name)
            cs.merge_at_shape(cases, name, "main", MAIN_LAUNCH, gen, device)
        torch.cuda.empty_cache()
    for source in sorted(cuda_build.build_seconds):
        cs.log(f"# {source}: nvcc {cuda_build.build_seconds[source]:.2f} s\n"
               f"{cuda_build.build_log.get(source, '').strip()}")


if __name__ == "__main__":
    main()
