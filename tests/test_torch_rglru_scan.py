"""The port's RG-LRU scan against the reference's.

On the CPU ``repro_torch.kernels.rglru_scan`` runs its eager twin
``ref.rglru_scan_ref``; it is held against the reference's
``ref.rglru_scan_ref``, the Pallas kernel (interpret mode, at the chunk
and channel block of ``tests/test_kernels.py``: chunk 16, w_block 32) and
the model's chunked associative scan ``rglru.linear_recurrence``, at that
file's shapes and tolerances: atol 1e-5 in float32 (the twin and
``rglru_scan_ref`` combine in sequence order, the associative scan in a
tree order within each chunk), 3e-2 with bfloat16 inputs (read as they
are and combined in float32 on every side).  Inputs are made with numpy.
The CUDA kernel against the twin needs a card and skips here
(``tests/test_torch_gpu.py``).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.rglru_scan import rglru_scan as pallas_scan
from repro.models import rglru as jrglru
from repro_torch.kernels.rglru_scan import rglru_scan

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
#: the reference test's shapes, and one s that is a multiple of neither
#: the Pallas chunk (16) nor linear_recurrence's (64), over a ragged w
SHAPES = [(2, 37, 24), (1, 64, 128), (3, 83, 40)]


def _inputs(seed, b, s, w):
    """The reference test's distributions: a in [0.8, 1), bx 0.1·normal."""
    rng = np.random.RandomState(seed)
    return (rng.uniform(0.8, 1.0, (b, s, w)).astype(np.float32),
            (rng.randn(b, s, w) * 0.1).astype(np.float32))


@pytest.mark.parametrize("b,s,w", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_twin_matches_reference(b, s, w, dtype):
    a, bx = _inputs(11 + s, b, s, w)
    before = rglru_scan.launches
    got = rglru_scan(torch.from_numpy(a).to(getattr(torch, dtype)),
                     torch.from_numpy(bx).to(getattr(torch, dtype)))
    assert rglru_scan.launches == before          # the CPU runs the twin
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, s, w)
    ja, jbx = (jnp.asarray(x, getattr(jnp, dtype)) for x in (a, bx))
    got, tol = got.numpy(), TOL[dtype]
    np.testing.assert_allclose(got, np.asarray(jref.rglru_scan_ref(ja, jbx)),
                               atol=tol)
    np.testing.assert_allclose(got, np.asarray(pallas_scan(
        ja, jbx, chunk=16, w_block=32, interpret=True)), atol=tol)
    h, h_last = jrglru.linear_recurrence(ja.astype(jnp.float32),
                                         jbx.astype(jnp.float32))
    np.testing.assert_allclose(got, np.asarray(h), atol=tol)
    np.testing.assert_allclose(got[:, -1], np.asarray(h_last), atol=tol)


def test_twin_is_the_sequential_recurrence():
    """h_1 = bx_1 exactly, and each later step is a float32 product then
    a sum, computed here step by step in numpy."""
    a, bx = _inputs(3, 2, 9, 5)
    got = rglru_scan(torch.from_numpy(a), torch.from_numpy(bx)).numpy()
    h = np.zeros((2, 5), np.float32)
    for t in range(9):
        h = (a[:, t] * h).astype(np.float32) + bx[:, t]
        np.testing.assert_array_equal(got[:, t], h)


def test_rejects_mismatched_operands():
    a = torch.zeros((1, 4, 3))
    with pytest.raises(ValueError, match="one"):
        rglru_scan(a, torch.zeros((1, 4, 2)))
    with pytest.raises(ValueError, match="dtypes"):
        rglru_scan(a, a.double())
