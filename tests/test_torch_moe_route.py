"""The port's MoE routing against the reference's.

On the CPU ``repro_torch.kernels.moe_route`` runs its eager twin
``ref.moe_route_ref``; it is held against the reference's
``ref.moe_route_ref`` and the Pallas kernel (interpret mode, as
``tests/test_kernels.py`` runs it) at that file's shapes and block sizes,
with its tolerances: expert ids and slots exactly, gates within atol 1e-5
(one float32 softmax and division, summed in other orders).  Inputs are
made with numpy.  Where every remaining probability underflows to 0 the
Pallas kernel picks expert 0 again; the port follows ``moe_route_ref``
(distinct experts, the lower index first), as the model's ``lax.top_k``
router does.  The CUDA kernel against the twin needs a card and skips
here (``tests/test_torch_gpu.py``).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.moe_route import moe_route as pallas_moe_route
from repro_torch.kernels.moe_route import moe_route
from repro_torch.kernels.ref import moe_route_ref

GATE_ATOL = 1e-5


def _check(got, want):
    eid, gate, slot = got
    weid, wgate, wslot = (np.asarray(a) for a in want)
    assert eid.dtype == torch.int32 and slot.dtype == torch.int32
    assert gate.dtype == torch.float32
    np.testing.assert_array_equal(eid.numpy(), weid)
    np.testing.assert_array_equal(slot.numpy(), wslot)
    np.testing.assert_allclose(gate.numpy(), wgate, atol=GATE_ATOL)


@pytest.mark.parametrize("S,E,k,block", [
    (64, 8, 2, 32), (100, 16, 4, 32), (33, 4, 1, 16),
])
def test_twin_matches_reference_and_pallas(S, E, k, block):
    logits = np.random.RandomState(42 + S).randn(S, E).astype(np.float32)
    before = moe_route.launches
    got = moe_route(torch.from_numpy(logits), k)
    assert moe_route.launches == before          # the CPU runs the twin
    _check(got, jref.moe_route_ref(jnp.asarray(logits), k))
    _check(got, pallas_moe_route(jnp.asarray(logits), k, block=block,
                                 interpret=True))


def test_ties_break_to_the_lower_index():
    """Logits on a coarse grid tie often; the twin's order among equal
    probabilities is lax.top_k's."""
    rng = np.random.RandomState(5)
    logits = (np.round(rng.randn(256, 60) * 4) / 4).astype(np.float32)
    _check(moe_route_ref(torch.from_numpy(logits), 4),
           jref.moe_route_ref(jnp.asarray(logits), 4))


def test_slots_are_dense_per_expert():
    logits = np.random.RandomState(7).randn(200, 8).astype(np.float32)
    eid, _, slot = moe_route(torch.from_numpy(logits), 2)
    eid, slot = eid.numpy().ravel(), slot.numpy().ravel()
    for e in range(8):
        s = np.sort(slot[eid == e])
        assert (s == np.arange(len(s))).all()    # 0..n_e-1 exactly once


def test_grouped_form_equals_per_group_calls():
    """(G, gs, E): G independent routings, the slot counters starting at 0
    in every group."""
    logits = torch.from_numpy(
        np.random.RandomState(8).randn(3, 40, 6).astype(np.float32))
    grouped = moe_route(logits, 3)
    for g in range(3):
        one = moe_route(logits[g], 3)
        for a, b in zip(grouped, one):
            assert torch.equal(a[g], b)
    assert int(grouped[2][1].min()) == 0


def test_underflow_diverges_from_pallas():
    """Every probability but one underflows: the twin takes distinct
    experts [0, 1] with slots [0, 0], as moe_route_ref; the Pallas kernel
    takes expert 0 twice, with slots [0, 1]."""
    logits = np.array([[0.0, -200.0, -200.0, -200.0]], np.float32)
    eid, gate, slot = moe_route(torch.from_numpy(logits), 2)
    assert eid.tolist() == [[0, 1]] and slot.tolist() == [[0, 0]]
    assert gate.tolist() == [[1.0, 0.0]]
    _check((eid, gate, slot), jref.moe_route_ref(jnp.asarray(logits), 2))
    peid, _, pslot = pallas_moe_route(jnp.asarray(logits), 2,
                                      interpret=True)
    assert np.asarray(peid).tolist() == [[0, 0]]
    assert np.asarray(pslot).tolist() == [[0, 1]]


def test_rejects_bad_shapes():
    with pytest.raises(ValueError, match="top_k"):
        moe_route(torch.zeros((4, 3)), 4)
    with pytest.raises(ValueError, match="logits"):
        moe_route(torch.zeros((2, 2, 2, 2)), 1)
