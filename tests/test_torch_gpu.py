"""The CUDA kernel against its eager twin, on the card.

Runs only where a CUDA device is present (``-m gpu``); skips elsewhere.
The file imports no JAX, so it also runs on a machine that has PyTorch
and the CUDA toolkit only:

    PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_ref import substep_fuzz
from repro_torch.kernels.edge_substep import OUT_NAMES, edge_substep
from repro_torch.kernels.ref import (CARRY_NAMES, SHARED_NAMES, STATIC_NAMES,
                                     edge_substep_ref)

KW = dict(substeps=7, dt=1.5, swap_slowdown=0.5, nic_cap=50.0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(seed, k=12, f=4, n=6, grid=None):
    """The reference's substep fuzz, optionally with a grid axis of
    ``grid`` independent cells sharing cell 0's cluster rows."""
    rng = np.random.RandomState(seed)
    cells = [substep_fuzz(rng, k, f, n) for _ in range(grid or 1)]
    names = CARRY_NAMES + STATIC_NAMES
    if grid is None:
        return [cells[0][name] for name in names]
    return [cells[0][name] if name in SHARED_NAMES else
            np.stack([c[name] for c in cells]) for name in names]


def _check(got, want):
    for name, g, w in zip(OUT_NAMES, got, want):
        g, w = g.cpu(), w.cpu()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if g.dtype.is_floating_point:
            torch.testing.assert_close(g, w, rtol=1e-12, atol=0.0,
                                       msg=name)
        else:
            assert torch.equal(g, w), name


@pytest.mark.gpu
@pytest.mark.parametrize("seed", range(8))
def test_kernel_matches_twin(cuda, seed):
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
            for a in _inputs(seed)]
    before = edge_substep.launches
    got = edge_substep(*args, **KW)
    again = edge_substep(*args, **KW)
    torch.cuda.synchronize()
    assert edge_substep.launches == before + 2
    _check(got, edge_substep_ref(*args, **KW))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
def test_kernel_grid_matches_twin(cuda):
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
            for a in _inputs(99, k=300, f=8, n=50, grid=5)]
    _check(edge_substep(*args, **KW), edge_substep_ref(*args, **KW))


@pytest.mark.gpu
def test_placement_kernels_match_twins(cuda):
    """Both placement scans against their twins at every interval of a
    small grid on a tenth-RAM fleet (the repair walks live slots there)."""
    from repro_torch.env.cluster import make_cluster
    from repro_torch.env.torchsim import driver, engines, kernels
    from repro_torch.env.torchsim.arrays import (ClusterArrays,
                                                 compile_trace,
                                                 default_capacity,
                                                 stack_traces, to_device)
    from repro_torch.env.torchsim.policies import make_static_decider
    from repro_torch.kernels import placement
    cluster = make_cluster(ram_scale=0.1)
    traces = [compile_trace(make_static_decider("bestfit-rr"), lam=8.0,
                            seed=s, n_intervals=6, substeps=4,
                            cluster=cluster) for s in range(3)]
    trace = to_device(stack_traces(traces), cuda)
    cl = to_device(ClusterArrays.from_cluster(cluster).as_dict(), cuda)
    G, F, n = len(traces), trace["instr"].shape[-1], cl["ram"].shape[0]
    state = kernels.init_state(G, default_capacity(traces), F, n, cuda)
    acc = driver._init_acc(G, n, cuda)
    walked = 0
    for t in range(6):
        arr, _ = engines.StaticEngine().decide({}, trace, t)
        state = kernels.admit(state, arr)
        ops = kernels.bestfit_operands(state, cl)
        req = placement.bestfit_scan(*ops)
        assert torch.equal(req, placement.bestfit_scan_ref(*ops)), t
        ops = kernels.repair_operands(state, cl, req)
        got = placement.repair_scan(*ops)
        want = placement.repair_scan_ref(*ops)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), t
        walked += int(ops[1].sum())
        state = kernels.apply_requests(state, cl, req)
        state, acc, _ = driver._interval_physics(
            state, acc, trace["bw_mult"][:, t], cl, 4, 75.0, 300.0, 0.5)
        state["alive"] = state["alive"] & ~state["task_done"]
    assert walked > 0
