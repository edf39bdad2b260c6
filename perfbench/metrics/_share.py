"""What the readers share: a kernel's roofline share over the traced
sub-window."""
from __future__ import annotations

import importlib
import sys

from perfbench.harness.flops import request_forwards
from perfbench.harness.peaks import BF16_FLOPS, HBM_BYTES_S


def roofline_share(run, kernel: str):
    """100 x (least time the traced requests' calls of ``kernel`` need at
    the H100's peaks) / (their device time); None without a trace, or when
    the trace holds none of them or another number than the plans call
    for."""
    if run.digest is None:
        return None
    mod = importlib.import_module(f"perfbench.roofline.{kernel}")
    bound, expected = 0.0, 0
    for r in run.traced:
        for kind in request_forwards(r["plan"], run.branches):
            for c in mod.calls(run.config, kind, run.branches, run.b,
                               run.s):
                flops, nbytes = mod.cost(c)
                bound += max(flops / BF16_FLOPS, nbytes / HBM_BYTES_S)
                expected += 1
    seconds, n = run.digest.op_seconds(
        mod.match, getattr(mod, "MEMSET_BEFORE", False))
    if expected == 0 or n == 0:
        return None
    if n != expected:
        print(f"{kernel}: {n} calls in the trace, {expected} expected from "
              "the plans; roofline not read", file=sys.stderr)
        return None
    return 100.0 * bound / seconds
