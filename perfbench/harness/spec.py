"""What one run measures: the cell of ``BENCHMARK.json`` and the files it
names, found by name (``configs/<file>``, ``traffic/<traffic>.json``,
``limits/<config>.json``), and the metrics that the cell reports."""
from __future__ import annotations

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"


class Cell:
    def __init__(self, name: str, root: Path = ROOT):
        bench = json.loads((root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                             f"{sorted(cells)}")
        self.name = name
        self.cell = cells[name]
        self.chips = self.cell["chips"]
        entry = {c["name"]: c for c in bench["configs"]}[self.cell["config"]]
        self.config = json.loads((root / entry["file"]).read_text())
        self.traffic = json.loads(
            (root / "perfbench" / "traffic" / f"{self.cell['traffic']}.json")
            .read_text())
        self.limits = json.loads(
            (root / "perfbench" / "limits" / f"{self.cell['config']}.json")
            .read_text())
        self.end_to_end = [m for m in bench["end_to_end"] if _in(m, name)]
        self.per_layer = [m for m in bench["per_layer"] if _in(m, name)]


def _in(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])
