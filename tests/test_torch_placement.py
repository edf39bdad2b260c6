"""The sequential placement scans of the port (``repro_torch.kernels
.placement``), on the CPU where they run their eager twins.

The scans as a whole are held against the JAX driver in
``test_torch_driver.py``; these tests pin their contract directly:
first-maximum BestFit choices with RAM-aware score updates, the repair's
most-headroom fallback and whole-task failure, and per-cell trip counts
under grid batching.  The CUDA kernels are held against these twins in
``test_torch_gpu.py`` and by ``chip_smoke.py``.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.kernels import placement

f8, i4, i8 = torch.float64, torch.int32, torch.int64


def _bestfit_case():
    """Two cells, K=3 slots, F=2, n=3 workers."""
    G, K, F, n = 2, 3, 2, 3
    ram = torch.tensor([[[2.0, 2.0], [5.0, 5.0], [1.0, 1.0]],
                        [[4.0, 4.0], [4.0, 4.0], [4.0, 4.0]]], dtype=f8)
    cap = torch.tensor([6.0, 6.0, 10.0], dtype=f8)
    mips = torch.tensor([4000.0, 4000.0, 8000.0], dtype=f8)
    static = 0.3 * mips / mips.max()
    load0 = torch.zeros((G, n), dtype=f8)
    ram_free0 = cap.expand(G, n).clone()
    score0 = -load0 + static + 0.1 * ram_free0 / cap
    pos = torch.tensor([[0, 1, 2, 3, 4, 5], [4, 5, 0, 0, 0, 0]], dtype=i8)
    n_new = torch.tensor([5, 2], dtype=i8)
    req = torch.full((G, K, F), -1, dtype=i4)
    return pos, n_new, ram, ram_free0, load0, score0, static, cap, req


def test_bestfit_scan_greedy_sequence():
    args = _bestfit_case()
    out = placement.bestfit_scan(*args)
    # cell 0: the big worker 2 has the best score, then its load drops it
    # below worker 0; worker 0 (4 MB left) cannot take the 5 MB fragments,
    # so they go to 1 and, when 1 is full too, back to 2; the sixth
    # fragment is past n_new and stays -1
    assert out[0].tolist() == [[2, 0], [1, 2], [0, -1]]
    # cell 1: only its two real fragments are placed
    assert out[1].tolist() == [[-1, -1], [-1, -1], [2, 0]]


def test_bestfit_scan_no_worker_fits_takes_first_index():
    pos, n_new, ram, ram_free0, load0, score0, static, cap, req = \
        _bestfit_case()
    ram = torch.full_like(ram, 50.0)
    out = placement.bestfit_scan(pos, n_new, ram, ram_free0, load0, score0,
                                 static, cap, req)
    # every worker is masked to -1e9: argmax keeps the first maximum
    assert out[0, 0, 0] == 0


def test_bestfit_scan_cells_are_independent():
    args = _bestfit_case()
    both = placement.bestfit_scan(*args)
    for g in range(2):
        one = placement.bestfit_scan(*[a[g:g + 1] if a.dim() > 1 or
                                       a.shape[0] == 2 else a for a in args])
        assert torch.equal(one[0], both[g])


def _repair_case():
    """One cell, n=2 workers of 10 MB; slots in admission order 2, 0, 1."""
    K, F, n = 3, 2, 2
    order = torch.tensor([[2, 0, 1]], dtype=i8)
    alive = torch.ones((1, K), dtype=torch.bool)
    done = torch.tensor([[[False, True], [False, False], [False, True]]])
    chain = torch.tensor([[False, True, False]])
    stage = torch.zeros((1, K), dtype=i4)
    ram = torch.tensor([[[6.0, 6.0], [3.0, 3.0], [7.0, 7.0]]], dtype=f8)
    req = torch.tensor([[[0, -1], [0, 0], [0, -1]]], dtype=i4)
    cap = torch.tensor([10.0, 10.0], dtype=f8)
    worker2 = req.clone()
    placed = torch.ones((1, K), dtype=torch.bool)
    return order, alive, done, chain, stage, req, ram, cap, worker2, placed


def test_repair_scan_fallback_and_failure():
    order, alive, done, chain, stage, req, ram, cap, w2, placed = \
        _repair_case()
    trip = torch.tensor([3], dtype=i8)
    worker, placed_out = placement.repair_scan(
        order, trip, alive, done, chain, stage, req, ram, cap, w2, placed)
    # slot 2 (7 MB) fits worker 0; slot 0 (6 MB) no longer fits worker 0
    # and moves to worker 1 (most headroom); slot 1 is a chain whose active
    # stage (3 MB) exactly fills worker 0, and whose second stage is
    # admitted without holding RAM
    assert worker[0].tolist() == [[1, -1], [0, 0], [0, -1]]
    assert placed_out[0].tolist() == [True, True, True]


def test_repair_scan_fails_a_task_that_fits_nowhere():
    order, alive, done, chain, stage, req, ram, cap, w2, placed = \
        _repair_case()
    ram[0, 1] = 9.0                  # the chain's stage needs 9 MB
    trip = torch.tensor([3], dtype=i8)
    worker, placed_out = placement.repair_scan(
        order, trip, alive, done, chain, stage, req, ram, cap, w2, placed)
    assert worker[0, 1].tolist() == [-1, -1]
    assert placed_out[0].tolist() == [True, False, True]


def test_repair_scan_zero_trip_is_identity():
    order, alive, done, chain, stage, req, ram, cap, w2, placed = \
        _repair_case()
    trip = torch.tensor([0], dtype=i8)
    worker, placed_out = placement.repair_scan(
        order, trip, alive, done, chain, stage, req, ram, cap, w2, placed)
    assert torch.equal(worker, w2) and torch.equal(placed_out, placed)


def test_kernel_wrappers_reject_bad_operands():
    """The CUDA wrappers validate operands before building or launching."""
    args = list(_bestfit_case())
    args[0] = args[0].int()
    with pytest.raises(ValueError, match="pos"):
        placement.bestfit_scan_cuda(*args)
    order, alive, done, chain, stage, req, ram, cap, w2, placed = \
        _repair_case()
    with pytest.raises(ValueError, match="trip"):
        placement.repair_scan_cuda(order, torch.tensor([3]).int(), alive,
                                   done, chain, stage, req, ram, cap, w2,
                                   placed)
    with pytest.raises(ValueError, match="ram"):
        placement.repair_scan_cuda(order, torch.tensor([3]), alive, done,
                                   chain, stage, req, ram.float(), cap, w2,
                                   placed)
