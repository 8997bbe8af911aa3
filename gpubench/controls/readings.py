#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from, on the card,
at a cell's own size, in one process:

    python3 gpubench/controls/readings.py --workload k31c_two.ecoli_err \\
        --seeds 11,12,13 --control-seeds 21,22,23 [--faults 31] [--seconds 3]

For each of ``--seeds`` a run of the program as configured (the lower
reading), for each of ``--control-seeds`` a run of the control (the
program with ``canonical`` switched, against the configuration's
reference), and with ``--faults`` a run of each planted fault of
faults.py (or those named by ``--fault-names``) on each of those seeds
(each must come out not correct).  A run here is a harness run with a
short window (``--seconds``).  One JSON line a run on standard output,
then a summary line."""

import argparse
import contextlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from gpubench import cells, harness  # noqa: E402
from gpubench.controls import faults  # noqa: E402


def ints(s):
    return [int(x) for x in s.split(",") if x]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=ints, default=[])
    p.add_argument("--control-seeds", type=ints, default=[])
    p.add_argument("--faults", type=ints, default=[])
    p.add_argument("--fault-names", default=",".join(faults.FAULTS))
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    cell = cells.resolve(args.workload)
    runs = [("program", s, None) for s in args.seeds]
    runs += [("control", s, None) for s in args.control_seeds]
    runs += [(f, s, f) for s in args.faults for f in args.fault_names.split(",")]
    summary = {}
    for kind, seed, fault in runs:
        flags = faults.control_flags(cell) if kind == "control" else None
        with faults.planted(fault) if fault else contextlib.nullcontext():
            r = harness.run(cell, seed, args.seconds, False, program_flags=flags)
        line = {"kind": kind, "seed": seed, "correct": r["correct"], "attempted": r["attempted"],
                "checks": {k: v["value"] for k, v in r["checks"].items()}}
        print(json.dumps(line), flush=True)
        s = summary.setdefault(kind, {"runs": 0, "correct": 0, "max": {}, "min": {}})
        s["runs"] += 1
        s["correct"] += bool(r["correct"])
        for k, v in line["checks"].items():
            s["max"][k] = max(s["max"].get(k, v), v)
            s["min"][k] = min(s["min"].get(k, v), v)
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
