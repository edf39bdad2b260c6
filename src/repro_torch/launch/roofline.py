"""The dry-run's roofline table, from ``launch.dryrun``'s JSON reports.

The port of ``benchmarks/roofline.py``.  It reads ``dryrun_out/*.json``
(``python -m repro_torch.launch.dryrun --all``) and prints, per mesh, the
compute, memory and collective seconds of every (arch, input shape) at
the H100 constants of ``launch.mesh`` (computed, not measured), the
bottleneck, the peak memory per card, the useful-FLOP ratio and a one-line
suggestion:

    PYTHONPATH=src python -m repro_torch.launch.roofline [--md] [--mesh 16x16|all]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.dryrun import ALL_SHAPES, OUT_DIR


def load_all(d=OUT_DIR):
    rows = []
    for f in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(f) as fh:
            rows.append(json.load(fh))
    return rows


def _rows(rows, mesh):
    rows = [r for r in rows if r["mesh"] == mesh]
    rows.sort(key=lambda r: (r["arch"], ALL_SHAPES.index(r["shape"])))
    return rows


def table(rows, mesh="16x16"):
    hdr = (f"{'arch':20s} {'shape':12s} {'comp_s':>9s} {'mem_s':>9s} "
           f"{'coll_s':>9s} {'bound':>10s} {'peak_GB':>8s} {'useful':>7s}")
    lines = [hdr, "-" * len(hdr)]
    for r in _rows(rows, mesh):
        rl = r["roofline"]
        lines.append(
            f"{r['arch']:20s} {r['shape']:12s} {rl['compute_s']:9.4f} "
            f"{rl['memory_s']:9.4f} {rl['collective_s']:9.4f} "
            f"{rl['bottleneck']:>10s} {r['memory']['peak_gb']:8.2f} "
            f"{r['useful_flops_ratio']:7.2f}")
    return "\n".join(lines)


def markdown(rows, mesh="16x16"):
    out = ["| arch | shape | compute s | memory s | collective s | bottleneck "
           "| peak GB/card | useful FLOP ratio | 1-line fix |", "|" + "---|" * 9]
    for r in _rows(rows, mesh):
        rl = r["roofline"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {rl['compute_s']:.4f} | "
            f"{rl['memory_s']:.4f} | {rl['collective_s']:.4f} | "
            f"{rl['bottleneck']} | {r['memory']['peak_gb']:.2f} | "
            f"{r['useful_flops_ratio']:.2f} | {suggest(r)} |")
    return "\n".join(out)


def markdown_meshes(rows, meshes=("16x16", "2x16x16")):
    """One markdown row per arch, one column per input shape: the
    bottleneck and its seconds, the peak GB per card and the useful-FLOP
    ratio, each mesh's figures side by side ("a / b"; "—" where a
    combination has no report)."""
    by = {(r["arch"], r["shape"], r["mesh"]): r for r in rows}
    archs = sorted({r["arch"] for r in rows})

    def cell(arch, shape):
        got = [by.get((arch, shape, m)) for m in meshes]
        if not any(got):
            return "—"
        first = next(r for r in got if r)
        bound = first["roofline"]["bottleneck"]

        def each(fmt, get):
            return " / ".join(fmt.format(get(r)) if r else "—" for r in got)

        secs = each("{:.3g}", lambda r: r["roofline"][
            r["roofline"]["bottleneck"] + "_s"])
        peak = each("{:.1f}", lambda r: r["memory"]["peak_gb"])
        return (f"{bound} {secs} s, {peak} GB, useful "
                f"{first['useful_flops_ratio']:.2f}")

    head = " / ".join(meshes)
    out = [f"| arch | " + " | ".join(ALL_SHAPES) + " |",
           "|" + "---|" * (len(ALL_SHAPES) + 1)]
    out[0] = (f"| arch ({head}: bottleneck, its seconds, peak GB per card; "
              f"useful FLOP ratio) | " + " | ".join(ALL_SHAPES) + " |")
    for arch in archs:
        out.append(f"| {arch} | "
                   + " | ".join(cell(arch, sh) for sh in ALL_SHAPES) + " |")
    return "\n".join(out)


def suggest(r):
    b = r["roofline"]["bottleneck"]
    if b == "compute":
        if r["useful_flops_ratio"] < 0.4:
            return "cut non-model FLOPs (dispatch/remat/causal-skip)"
        return "increase per-card batch or cut remat recompute"
    if b == "memory":
        return "fuse elementwise chains; bf16 scan inputs; bigger blocks"
    return "overlap collectives; shrink all-gathered dims; 2D sharding"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=OUT_DIR)
    ap.add_argument("--mesh", default="16x16",
                    help='"16x16", "2x16x16", or "all" (--md: one row per '
                         'arch, both meshes side by side)')
    ap.add_argument("--md", action="store_true")
    args = ap.parse_args()
    rows = load_all(args.dir)
    if not rows:
        print("no dry-run results found; run python -m "
              "repro_torch.launch.dryrun --all")
        return
    if args.md and args.mesh == "all":
        print(markdown_meshes(rows))
    else:
        print((markdown if args.md else table)(rows, args.mesh))


if __name__ == "__main__":
    main()
