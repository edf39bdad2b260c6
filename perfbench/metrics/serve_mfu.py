"""The served forwards' share of the bf16 peak: the FLOPs of every plan
and monolithic forward of the window (the benchmark's own shape
arithmetic) over the window's seconds x 989e12, in %."""
from perfbench.harness.peaks import BF16_FLOPS


def read(run):
    if not run.ok or run.window_s <= 0:
        return None
    return 100.0 * sum(r["flops"] for r in run.ok) / (run.window_s
                                                      * BF16_FLOPS)
