"""The control comes out not correct: the plain reference put in the
program's place and computed in fp8 (both operands of every product
rounded to float8 e4m3 under a per-tensor scale), the nearest precision
below the configurations' bfloat16, fails a number that the program
passes.  On the CPU at a tiny cut; on the card at each cell's own size on
three seeds (``pytest -m gpu perfbench/tests``)."""
import json

import pytest
import torch

from perfbench import calibrate
from perfbench.harness.check import compare
from perfbench.harness.spec import ROOT, Cell
from perfbench.tests.tiny import tiny_cell

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _assert_control_fails(cell, runs):
    for seed, res, run in runs:
        assert res["correct"], (seed, res["compared"])
        for r in run.readings:
            _, ok = compare(r["control"], cell.limits)
            assert not ok, (seed, r["control"])


@pytest.mark.parametrize("name", ["moe-serve-loose", "vl-serve-tight"])
def test_control_fails_at_a_tiny_cut(name):
    cell = tiny_cell(name)
    _assert_control_fails(cell, calibrate.readings(cell, [21], 0.05, True,
                                                   "cpu"))


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = Cell(name)
    _assert_control_fails(cell, calibrate.readings(cell, [31, 32, 33], 4.0,
                                                   True, "cuda"))
