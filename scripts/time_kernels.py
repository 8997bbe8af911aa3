#!/usr/bin/env python3
"""Times the kernels of one tree of the port on one NVIDIA GPU with
chip_smoke.py's own kernel-phase code: its random operands per NL (the
sort, K1 and K3 at about 8M and 32M rows, K2 at about 8M rows a third
live, K4 and K5 at about 8M rows, K8 at each k of its random shapes),
K1 and K3-K5 at the main path's largest launch shape on operands shaped as
that path gives them (MAIN_LAUNCH) and on the 80%-live mix of earlier
runs, K8 at each of its launch shapes on the paths (K8_PATH_LAUNCHES), its checks
against the plain versions, its CUDA-event timing in turns and its traced
device time per CUDA kernel; and ``chunk_step``, the two-level chunk step
(ops.pipeline.count_step_two_level) at the main path's chunk, whatever
kernels the tree runs there (chip_smoke.time_chunk_step: a tree before K8
runs the plain torch chain); and ``probes``, D1-D7 (chip_smoke.phase_probes:
the three probe harnesses traced, then each probe kernel at each launch
shape of its harness against its plain version and the probe's NumPy
check, timed (row_gather and pair_merge also each call by CUDA events),
at the edge and random shapes and on a side stream; then
pair_merge_kernel's launch floor, its device time at one key); and
``row_gather_host`` and ``pair_merge_host``, the host's microseconds a
call of each piece of that wrapper's launch path (launch_path_host
below).  So one chip call can time two commits in turns (A, B, B, A):

    python3 scripts/time_kernels.py              # this checkout
    python3 scripts/time_kernels.py --root DIR   # another tree of the port
    python3 scripts/time_kernels.py --kernels merge_fold_compact,merge_sorted_runs_fold_bitonic
    python3 scripts/time_kernels.py --kernels chunk_step --root DIR
    python3 scripts/time_kernels.py --kernels probes,pair_merge_host --root DIR

``--root`` imports ``kmer_counter_tpu_torch`` from DIR (an unpacked ``git
archive`` of another commit), which builds its kernels from its own
``csrc/``; the operands, checks and timing stay this checkout's.
``--kernels`` times only the named ones (chip_smoke.py's names,
``chunk_step``, ``probes``, ``row_gather_host``, ``pair_merge_host`` and
``record_pack``, the dump's record pack at the benchmark's two table sizes).
Prints the card's name and power limit, chip_smoke.py's kernel lines, then each
source's nvcc report (registers and spill bytes of each instance, then
the report itself).
"""

import argparse
import importlib.util
import inspect
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The largest launch of K1 in chip_smoke.py's main path (its third
# consolidation), as its launch_shapes log it: (NL, na, nb, A's live rows,
# B's live rows, B's live rows with the sentinel key); K1 writes na columns
# there (the prefix's).
MAIN_LAUNCH = (2, 166_666_500, 97_222_223, 4_599_964, 55_555_500, 21_626_652)
# K8's distinct launches on chip_smoke.py's paths, as their launch_shapes
# log them, (R, L, k, canonical, mode) under a path that makes each: a
# chunk of the main count (keys two-level, records one-level), a position's
# chunk on the mesh (and a chunk of the spill paths), a position's chunk of
# mesh_spill.
K8_PATH_LAUNCHES = {"main": (396_825, 100, 31, True, "keys"), "main_one": (396_825, 100, 31, True, "records"),
                    "mesh": (99_206, 100, 31, True, "keys"), "mesh_one": (99_206, 100, 31, True, "records"),
                    "mesh_spill": (24_801, 100, 31, True, "keys")}


def launch_path_host(cs, device, wrapper, reps=1000):
    """Host microseconds a call of a probe wrapper and of each piece of its
    launch path, ``reps`` calls issued back to back with no synchronisation
    (after 100 unmeasured), beside its library call: the wrapper's checks,
    the output's torch.empty, the current stream's handle both ways (the
    Stream object's and the raw binding's), and the launch (the typed ctypes
    call of the library).  ``row_gather`` at D4's shape ([16, 128], one
    start, shift -3) beside torch.roll, ``pair_merge`` at D2's (1 pair of
    2 x 1024 keys, B descending) beside torch.sort.  Only names that every
    tree of the port has."""
    import torch

    from kmer_counter_tpu_torch.ops import probes

    i32 = torch.int32
    lib = probes._lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    if wrapper == "row_gather":
        x = torch.zeros((16, 128), dtype=i32, device=device)
        s = torch.zeros(1, dtype=i32, device=device)
        out = torch.empty((1, 16, 128), dtype=i32, device=device)
        call, library = (lambda: probes.row_gather(x, s, 16, -3)), ("torch.roll", lambda: torch.roll(x, 3, 0))
        checks = lambda: probes._check_rows(x, s, 16)
        launch = lambda: lib.pr_row_gather(x.data_ptr(), s.data_ptr(), out.data_ptr(), 16, 128, 1, 16, -3, stream)
    else:
        x = torch.sort(torch.randint(0, 2**31, (1, 1024), dtype=torch.int64, device=device)).values.to(i32)
        s = x.flip(1)
        out = torch.empty((1, 2048), dtype=i32, device=device)
        both = torch.cat([x, s], 1).to(torch.int64)
        call, library = (lambda: probes.pair_merge(x, s, b_descending=True)), ("torch.sort", lambda: torch.sort(both))
        checks = lambda: probes._int32_on_one_device([x, s], "a and b")
        launch = lambda: lib.pr_pair_merge(x.data_ptr(), s.data_ptr(), out.data_ptr(), 1, 1024, 1024, 1, stream)
    index = x.get_device()
    pieces = {"wrapper": call, library[0]: library[1], "checks": checks,
              "torch.empty": lambda: torch.empty(out.shape, dtype=i32, device=x.device),
              "current_stream().cuda_stream": lambda: torch.cuda.current_stream(x.device).cuda_stream,
              "raw stream handle": lambda: torch._C._cuda_getCurrentRawStream(index), "launch": launch}
    us = {}
    for name, fn in pieces.items():
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        us[name] = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
    cs.log({"phase": "probes", f"{wrapper}_host_us": us, "reps": reps})


def pair_merge_floor(cs, device, reps=50):
    """pair_merge_kernel's launch floor: its device time at one key (G = 1,
    Ta = 1, Tb = 0), traced over reps calls."""
    import torch

    from kmer_counter_tpu_torch.ops import probes

    a = torch.ones((1, 1), dtype=torch.int32, device=device)
    b = torch.ones((1, 0), dtype=torch.int32, device=device)

    def calls():
        for _ in range(reps):
            probes.pair_merge(a, b, b_descending=True)

    calls()
    traced = cs.traced_kernels(calls)
    cs.log({"phase": "probes", "pair_merge_floor_device_ms": {
        name: v["ms"] / v["launches"] for name, v in traced.items() if name.startswith("pair_merge_kernel")},
        "launches": {name: v["launches"] for name, v in traced.items()}})


# The dump's record pack (R1, csrc/records.cu) at the benchmark's finalized
# tables, k = 31 (NL = 2): the distinct rows of the clean E. coli-sized
# count and of the count with 1% substitutions, every count nonzero.
RECORD_PACK_ROWS = {"ecoli": 4_641_652, "ecoli_err": 39_900_000}


def record_pack(cs, device):
    """R1 at RECORD_PACK_ROWS: chip_smoke.py's line for a launch shape
    (checked against the plain version, CUDA-event times of both, the
    kernels' device time in a traced call, the bound)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(cs.SEED)
    for name, n in RECORD_PACK_ROWS.items():
        cs.r1_at_shape(name, (2, n, n), gen, device)
        torch.cuda.empty_cache()


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
        cs.SORT["name"], cs.K2["name"], cs.K1["name"], *cs.MERGES, cs.K8["name"], "chunk_step", "probes",
        "row_gather_host", "pair_merge_host", "record_pack"]
    for name in names:
        if name == "chunk_step":
            cs.time_chunk_step(device)
        elif name == "probes":
            cs.phase_probes(device, cases)
            pair_merge_floor(cs, device)
        elif name == "record_pack":
            record_pack(cs, device)
        elif name in ("row_gather_host", "pair_merge_host"):
            launch_path_host(cs, device, name.removesuffix("_host"))
        elif name == cs.K8["name"]:
            cs.k8_random_shapes(device, cases)
            for path, (R, L, k, canonical, mode) in K8_PATH_LAUNCHES.items():
                t = cs.compare_k8(cs.path_reads(path, R, L, device), k, canonical, mode, time_it=True)
                cs.log({"phase": "kernel", "kernel": name, "path": path, "main_path_launch_shape": True, "R": R,
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
        report = cuda_build.build_log.get(source, "")
        cs.log({"source": source, "nvcc_s": cuda_build.build_seconds[source], "instances": cs.ptxas_report(report)})
        cs.log(f"# {source}: nvcc {cuda_build.build_seconds[source]:.2f} s\n{report.strip()}")


if __name__ == "__main__":
    main()
