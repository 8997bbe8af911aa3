#!/usr/bin/env python3
"""Times the sort (K6+K7) and K2 of one tree of the port on one NVIDIA GPU
with chip_smoke.py's own kernel-phase code: its random operands per NL
(the sort at about 8M and 32M rows, K2 at about 8M rows a third live), its
checks against the plain versions, its CUDA-event timing in turns and its
traced device time per kernel.  So one chip call can time two commits in
turns (A, B, B, A):

    python3 scripts/time_kernels.py              # this checkout
    python3 scripts/time_kernels.py --root DIR   # another tree of the port

``--root`` imports ``kmer_counter_tpu_torch`` from DIR (an unpacked ``git
archive`` of another commit), which builds its kernels from its own
``csrc/``; the operands, checks and timing stay this checkout's.  Prints
the card's name and power limit, chip_smoke.py's kernel lines, then each
source's nvcc report (registers, spills).
"""

import argparse
import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
        raise SystemExit("time_kernels.py needs an NVIDIA GPU")
    from kmer_counter_tpu_torch import cuda_build
    from kmer_counter_tpu_torch.ops import lane_sort

    if not lane_sort.__file__.startswith(root + os.sep):
        raise SystemExit(f"imported {lane_sort.__file__}, not the tree under {root}")
    cs.log(cs.smi_line())
    cs.log({"tree": os.path.relpath(root, HERE)})
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(cs.SEED)
    cs.sort_random_shapes(device, cs.load_test_cases(), gen)
    cs.k2_random_shapes(device, gen)
    for source in ("lane_sort", "compact_live"):
        cs.log(f"# {source}: nvcc {cuda_build.build_seconds[source]:.2f} s\n"
               f"{cuda_build.build_log.get(source, '').strip()}")


if __name__ == "__main__":
    main()
