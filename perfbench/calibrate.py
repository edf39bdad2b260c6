"""Readings for a cell's limits: the program's comparison numbers on many
seeds and, on the same sampled requests, the control's (the reference
computed in fp8, put in the program's place), all in one process:

    python3 perfbench/calibrate.py --workload <cell> --seeds 11,12,13 \
        --seconds 4 [--control 1]

One JSON line per seed on standard output.  Each seed runs the cell's own
set-up and a short window at the cell's load (``--seconds``), then the
check of as many sampled requests as a run compares.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from perfbench.harness.main import run_cell  # noqa: E402
from perfbench.harness.spec import Cell  # noqa: E402


def readings(cell, seeds, seconds, control, device="cuda"):
    """[(seed, result, run)] of one short run per seed."""
    out = []
    for seed in seeds:
        res, run = run_cell(cell, seed, seconds, 0, device, control=control)
        out.append((seed, res, run))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--control", type=int, default=1)
    args = ap.parse_args(argv)
    cell = Cell(args.workload)
    seeds = [int(x) for x in args.seeds.split(",")]
    for seed, res, run in readings(cell, seeds, args.seconds,
                                   bool(args.control)):
        ctl = [r["control"] for r in run.readings if "control" in r]
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "correct": res["correct"], "attempted": res["attempted"],
            "metrics": res["metrics"],
            "memory_peak_bytes": res["device"]["memory_peak_bytes"],
            "program": [
                {k: v for k, v in r.items() if k != "control"}
                for r in run.readings],
            "control": ctl}), flush=True)


if __name__ == "__main__":
    main()
