#!/usr/bin/env python3
"""Where a block's time goes in pair_merge_kernel (D2, D3, D7;
csrc/probes.cu), on one NVIDIA GPU.

    python3 scripts/merge_phases.py DIR[:NAME[:EDIT,...]] ...
    python3 scripts/merge_phases.py _checkout/parent:parent .:tree .:tree_f128:fit128 _checkout/parent:parent2 .:tree2

For each tree of the port named (this checkout ``.``, or an unpacked ``git
archive`` of another commit), copies its ``kmer_counter_tpu_torch/`` to
``_checkout/merge_phases_NAME/`` (git-ignored), applies the named EDITS to
the copy's probes.cu (variants of the block shape), and edits the copy's
pair_merge_kernel so that thread 0 of each block stores clock64() at its
start, after each of the kernel's three __syncthreads (the split, the
staging, the merge) and at its end, and %globaltimer and %smid at its start,
in a device array the copy reads back.  Then, in a process of its own, it
runs pair_merge at D2's, D3's and D7's shapes (uniform keys, as
chip_smoke.probe_at_shape draws them) and at one key (the launch floor):
bit-exact against the plain version, CUDA-event ms a call over 200 calls
issued back to back, device µs of each of 50 launches by torch.profiler,
and the stamps of one more launch, printed as one JSON line a tree: per
phase (split, stage, merge, store, block) the median, mean and 90th
percentile in SM clock cycles over the blocks.  The stamps themselves cost
a few instructions a phase.  Prints the card's name, power limit and SM
clock before and after.
"""

import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"D2": (1, 1024, 1024, True), "D3": (512, 1024, 1024, True), "D7": (1, 65536, 65536, False),
          "floor": (1, 1, 0, True)}
PHASES = ("split", "stage", "merge", "store")
BLOCKS = 65536  # blocks a launch stamps, at most

DEFS = f'''
__device__ long long pm_stamps[8 * {BLOCKS}];
#define PM_STAMP(k) do {{ if (threadIdx.x == 0 && blockIdx.x < {BLOCKS}) pm_stamps[blockIdx.x * 8ll + (k)] = clock64(); }} while (0)
'''
START = (f"  PM_STAMP(0);\n  if (threadIdx.x == 0 && blockIdx.x < {BLOCKS}) {{ unsigned long long gt; unsigned sm;"
         " asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(gt)); asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(sm));"
         " pm_stamps[blockIdx.x * 8ll + 7] = (long long)gt; pm_stamps[blockIdx.x * 8ll + 6] = sm; }\n")
TAIL = f'''
extern "C" int pr_stamps(void* host) {{ return (int)cudaMemcpyFromSymbol(host, pm_stamps, sizeof(long long) * 8 * {BLOCKS}); }}
extern "C" int pr_stamps_clear() {{
  void* p;
  const cudaError_t e = cudaGetSymbolAddress(&p, pm_stamps);
  return (int)(e ? e : cudaMemset(p, 0, sizeof(long long) * 8 * {BLOCKS}));
}}
'''
# Variants of the block shape tried on a copy of this tree's source.
EDITS = {"fit128": ("using FitShape = MergeShape<256, 8>;", "using FitShape = MergeShape<128, 16>;"),
         "spread8": ("using SpreadShape = MergeShape<256, 4>;", "using SpreadShape = MergeShape<256, 8>;"),
         "spread128": ("using SpreadShape = MergeShape<256, 4>;", "using SpreadShape = MergeShape<128, 8>;")}


def instrument(src: str) -> str:
    """probes.cu with pair_merge_kernel's stamps: the kernel's body is the
    text from the brace that ends its signature to the next unindented
    brace, and a stamp follows each __syncthreads."""
    k = src.index("    pair_merge_kernel(const uint32_t* a")
    i = src.rindex("template <", 0, k)
    body_start = src.index("{\n", k) + 2
    body_end = src.index("\n}\n", body_start)
    body = src[body_start:body_end]
    parts = body.split("__syncthreads();")
    assert len(parts) == 4, "pair_merge_kernel's body has not three __syncthreads"
    body = parts[0] + "".join(f"__syncthreads(); PM_STAMP({n + 1});" + p for n, p in enumerate(parts[1:]))
    body = START + body + "\n  PM_STAMP(4);"
    return src[:i] + DEFS + src[i:body_start] + body + src[body_end:] + TAIL


def prepare(root, name, edits):
    dst = os.path.join(HERE, "_checkout", f"merge_phases_{name}")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(root, "kmer_counter_tpu_torch"), os.path.join(dst, "kmer_counter_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    cu = os.path.join(dst, "kmer_counter_tpu_torch", "csrc", "probes.cu")
    with open(cu) as fh:
        src = fh.read()
    for e in edits:
        old, new = EDITS[e]
        if src.count(old) != 1:
            raise SystemExit(f"{root}: cannot apply {e}")
        src = src.replace(old, new)
    with open(cu, "w") as fh:
        fh.write(instrument(src))
    return dst


def run_tree(dst, name):
    """Runs in a process of its own: the copy's package is imported."""
    sys.path.insert(0, dst)
    import ctypes

    import numpy as np
    import torch

    from kmer_counter_tpu_torch import cuda_build
    from kmer_counter_tpu_torch.ops import probes

    if not probes.__file__.startswith(dst):
        raise SystemExit(f"imported {probes.__file__}, not the copy under {dst}")
    lib = probes._lib()
    lib.pr_stamps.argtypes, lib.pr_stamps.restype = [ctypes.c_void_p], ctypes.c_int
    lib.pr_stamps_clear.argtypes, lib.pr_stamps_clear.restype = [], ctypes.c_int
    report = {"tree": name, "nvcc": [line.strip() for line in cuda_build.build_log.get("probes", "").splitlines()
                                     if "pair_merge" in line or "registers" in line or "spill" in line]}
    device = torch.device("cuda")
    for d, (G, ta, tb, desc) in SHAPES.items():
        rng = np.random.default_rng(0)
        a_np, b_np = (np.sort(rng.integers(0, 2**32, (G, t), dtype=np.uint64).astype(np.uint32), axis=1)
                      for t in (ta, tb))
        a = torch.from_numpy(a_np.view(np.int32)).to(device)
        b = torch.from_numpy(np.ascontiguousarray(b_np[:, ::-1] if desc else b_np).view(np.int32)).to(device)

        def call():
            return probes.pair_merge(a, b, b_descending=desc)

        exact = bool(torch.equal(call(), probes.pair_merge_reference(a, b, b_descending=desc)))
        for _ in range(20):
            call()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(200):
            call()
        end.record()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(50):
                call()
            torch.cuda.synchronize()
        device_us = [e.time_range.end - e.time_range.start for e in prof.events() if "pair_merge_kernel" in e.name]
        if lib.pr_stamps_clear():
            raise RuntimeError("clearing the stamps failed")
        call()
        torch.cuda.synchronize()
        host = np.zeros(8 * BLOCKS, np.int64)
        if lib.pr_stamps(host.ctypes.data):
            raise RuntimeError("reading the stamps failed")
        st = host.reshape(-1, 8)
        st = st[(st[:, 0] > 0) & (st[:, 4] > 0)]  # the blocks that merged
        cycles = {p: st[:, n + 1] - st[:, n] for n, p in enumerate(PHASES)}
        cycles["block"] = st[:, 4] - st[:, 0]
        report[d] = {"shape": [G, ta, tb, desc], "bit_exact": exact, "blocks": int(len(st)),
                     "event_ms_per_call": start.elapsed_time(end) / 200,
                     "device_us": {"min": min(device_us), "median": float(np.median(device_us)),
                                   "max": max(device_us), "launches": len(device_us)},
                     "cycles": {p: {"median": float(np.median(v)), "mean": float(v.mean()),
                                    "p90": float(np.percentile(v, 90))} for p, v in cycles.items()},
                     "start_span_ns": int(st[:, 7].max() - st[:, 7].min()), "sms": len(set(st[:, 6].tolist()))}
    print(json.dumps(report), flush=True)


def main():
    if sys.argv[1] == "--tree":
        run_tree(sys.argv[2], sys.argv[3])
        return
    smi = ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm", "--format=csv,noheader"]
    subprocess.run(smi, check=True)
    for spec in sys.argv[1:]:
        parts = spec.split(":")
        root = os.path.abspath(parts[0])
        name = parts[1] if len(parts) > 1 else os.path.basename(root)
        dst = prepare(root, name, parts[2].split(",") if len(parts) > 2 else [])
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--tree", dst, name], capture_output=True,
                           text=True)
        sys.stdout.write(r.stdout)
        if r.returncode:
            print(f"# {name} failed (exit {r.returncode})\n{r.stderr[-4000:]}", flush=True)
    subprocess.run(smi, check=True)


if __name__ == "__main__":
    main()
