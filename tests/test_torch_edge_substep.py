"""The port's edge-substep twin against the JAX Pallas kernel.

``repro_torch.kernels.ref.edge_substep_ref`` (the eager twin, and the
path CPU tensors take through ``repro_torch.kernels.edge_substep``) must
match ``repro.kernels.edge_substep.edge_substep`` (interpret mode) and
``repro.kernels.ref.edge_substep_ref`` on the reference's own fuzz:
K=12, F=4, N=6, 7 substeps, dt=1.5, 8 seeds, ``stage == F`` included.
float64 at rtol=1e-12 (atol 0), bools and ints exact.  The CUDA kernel
itself is held against the twin in ``test_torch_gpu.py`` and by
``chip_smoke.py``.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from _torch_ref import substep_fuzz
from repro_torch.kernels import edge_substep as port_es
from repro_torch.kernels.ref import (CARRY_NAMES, OUT_NAMES, STATIC_NAMES,
                                     edge_substep_ref)

K, F, N = 12, 4, 6
SUBSTEPS, DT = 7, 1.5
KW = dict(substeps=SUBSTEPS, dt=DT, swap_slowdown=0.5, nic_cap=50.0)


def rand_inputs(rng: np.random.RandomState):
    fz = substep_fuzz(rng, K, F, N)
    return [fz[name] for name in CARRY_NAMES + STATIC_NAMES]


def _torch(args):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in args]


def _jax_outs(args, impl):
    if impl == "pallas":
        from repro.kernels.edge_substep import edge_substep
        fn = lambda *a: edge_substep(*a, **KW, interpret=True)  # noqa: E731
    else:
        from repro.kernels.ref import edge_substep_ref as ref_fn
        fn = lambda *a: ref_fn(*a, **KW)  # noqa: E731
    with jax.enable_x64(True):
        return [np.asarray(o) for o in fn(*args)]


def assert_outs_match(got, want, what=""):
    for name, g, w in zip(OUT_NAMES, got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        assert g.shape == w.shape, f"{what} {name}: {g.shape} vs {w.shape}"
        assert g.dtype == w.dtype, f"{what} {name}: {g.dtype} vs {w.dtype}"
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=0,
                                       err_msg=f"{what} {name}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {name}")


@pytest.mark.parametrize("impl", ["pallas", "jnp_ref"])
@pytest.mark.parametrize("seed", range(8))
def test_twin_matches_jax_fuzzed(seed, impl):
    args = rand_inputs(np.random.RandomState(seed))
    assert_outs_match(edge_substep_ref(*_torch(args), **KW),
                      _jax_outs(args, impl), f"seed {seed}")


def test_fuzz_reaches_out_of_range_stage():
    """The fuzz above includes chains whose stage ran off the last column
    (stage == F), the case JAX's filling gather covers."""
    hits = 0
    for seed in range(8):
        args = dict(zip(CARRY_NAMES + STATIC_NAMES,
                        rand_inputs(np.random.RandomState(seed))))
        hits += int((args["stage"] == F).sum())
    assert hits > 0


def test_out_of_range_stage_on_live_chains():
    """stage == F on placed, unfinished chains with undone columns: the
    fill semantics (not runnable, no RAM, no transfer, reads as done)
    match the Pallas kernel."""
    args = rand_inputs(np.random.RandomState(42))
    named = dict(zip(CARRY_NAMES + STATIC_NAMES, args))
    rows = np.arange(0, K, 3)
    named["chain"][rows] = True
    named["placed"][rows] = True
    named["task_done"][rows] = False
    named["stage"][rows] = F
    named["done"][rows, 0] = False
    named["worker"][rows, 0] = 1
    named["instr"][rows, 0] = 5.0
    named["transfer"][rows, :] = 3.0
    args = [named[k] for k in CARRY_NAMES + STATIC_NAMES]
    assert_outs_match(edge_substep_ref(*_torch(args), **KW),
                      _jax_outs(args, "pallas"), "stage==F")


def test_batched_twin_matches_per_row():
    rows = [rand_inputs(np.random.RandomState(100 + i)) for i in range(3)]
    shared = set(port_es.SHARED_NAMES)
    names = CARRY_NAMES + STATIC_NAMES
    stacked = [torch.from_numpy(np.ascontiguousarray(cols[0])) if name in
               shared else torch.from_numpy(np.stack(cols))
               for name, cols in zip(names, zip(*rows))]
    # the cluster rows are shared by the grid: give every row cell 0's
    for r in rows:
        for name in shared:
            r[names.index(name)] = rows[0][names.index(name)]
    outs_b = edge_substep_ref(*stacked, **KW)
    for i, r in enumerate(rows):
        outs_1 = edge_substep_ref(*_torch(r), **KW)
        for name, b, o in zip(OUT_NAMES, outs_b, outs_1):
            assert torch.equal(b[i], o), f"row {i} {name}"


def test_cpu_tensors_take_the_twin():
    """Dispatch is by device: CPU tensors run the twin and launch no
    kernel."""
    args = _torch(rand_inputs(np.random.RandomState(7)))
    before = port_es.edge_substep.launches
    got = port_es.edge_substep(*args, **KW)
    assert port_es.edge_substep.launches == before
    for g, w in zip(got, edge_substep_ref(*args, **KW)):
        assert torch.equal(g, w)


def test_kernel_wrapper_rejects_bad_operands():
    """The CUDA wrapper validates dtype and shape before it builds or
    launches anything."""
    args = [a[None] if name not in port_es.SHARED_NAMES else a
            for name, a in zip(CARRY_NAMES + STATIC_NAMES,
                               _torch(rand_inputs(np.random.RandomState(1))))]
    bad = list(args)
    bad[0] = bad[0].float()
    with pytest.raises(ValueError, match="instr"):
        port_es.edge_substep_cuda(*bad, **KW)
    bad = list(args)
    bad[3] = bad[3].long()
    with pytest.raises(ValueError, match="stage"):
        port_es.edge_substep_cuda(*bad, **KW)
