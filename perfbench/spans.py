"""Run one cell as ``perfbench/run.py`` does, with the engine's spans and
counters recorded, and print one JSON line:

    python3 perfbench/spans.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1> [--sync-debug 1]

The line holds the run's metrics and ``engine``, the per-request means of
``perfbench.harness.spans.engine_parts`` over the window's finished
requests; with ``--trace 1`` also ``program_gaps``, the traced
sub-window's longest idle gaps labelled by the program's spans (beside
``idle_gaps``, the harness's own labels).  ``--sync-debug 1`` (on a card)
has torch flag every call that synchronizes the host with the card and
counts them by the innermost open span (``syncs.<span>`` in ``engine``):
a check of ``host.waits``, which should exceed them by ``_run``'s two
explicit synchronizes.
"""
import os
import sys
import time

T_START = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import perfbench.run  # noqa: E402,F401  (the benchmark's process set-up)

import argparse  # noqa: E402
import json  # noqa: E402
from contextlib import nullcontext  # noqa: E402

from repro_torch.obs import use_ledger  # noqa: E402

from perfbench.harness.main import run_cell  # noqa: E402
from perfbench.harness.spans import (RequestLedger, engine_parts,  # noqa: E402
                                     program_gaps, sync_debug)
from perfbench.harness.spec import Cell  # noqa: E402


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--sync-debug", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell(args.workload)
    led = RequestLedger()
    with use_ledger(led), \
            sync_debug(led) if args.sync_debug else nullcontext():
        result, run = run_cell(cell, args.seed, args.seconds, args.trace,
                               "cuda", T_START)
    out = {"workload": args.workload, "seed": args.seed,
           "trace": args.trace, "sync_debug": args.sync_debug,
           "correct": result["correct"],
           "metrics": {k: m["value"] for k, m in result["metrics"].items()},
           "plans": result.get("plans"), "device": result["device"],
           "engine": engine_parts(led, run.ok)}
    if run.digest is not None:
        out["idle_gaps"] = result["breakdown"]["idle_gaps"]
        out["program_gaps"] = program_gaps(led, run.digest, run.traced)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
