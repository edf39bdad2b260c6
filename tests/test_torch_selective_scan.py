"""The port's selective scan against the reference's.

On the CPU ``repro_torch.kernels.selective_scan`` runs its eager twin
``ref.selective_scan_ref``; it is held against the reference's
``ref.selective_scan_ref``, the Pallas kernel (interpret mode, at the
chunk and channel block of ``tests/test_kernels.py``) and the model's
chunked associative scan ``ssm.selective_scan``, at that file's shapes
and tolerance, rtol/atol 1e-5: the twin and ``selective_scan_ref`` sum
the recurrence in sequence order, the associative scan in a tree order
within each chunk.  Inputs are made with numpy.  The CUDA kernel against
the twin needs a card and skips here (``tests/test_torch_gpu.py``).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.selective_scan import selective_scan as pallas_scan
from repro.models import ssm as jssm
from repro_torch.kernels.selective_scan import selective_scan

TOL = dict(rtol=1e-5, atol=1e-5)
SHAPES = [(2, 37, 16, 4, 16), (1, 128, 64, 16, 32), (3, 15, 8, 2, 8)]


def _inputs(seed, b, s, d, n):
    rng = np.random.RandomState(seed)
    return (rng.uniform(0.5, 1.0, (b, s, d, n)).astype(np.float32),
            (rng.randn(b, s, d, n) * 0.1).astype(np.float32),
            rng.randn(b, s, n).astype(np.float32))


@pytest.mark.parametrize("b,s,d,n,chunk", SHAPES)
def test_twin_matches_reference(b, s, d, n, chunk):
    arrs = _inputs(42 + s, b, s, d, n)
    before = selective_scan.launches
    got = selective_scan(*(torch.from_numpy(a) for a in arrs))
    assert selective_scan.launches == before      # the CPU runs the twin
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, s, d)
    jarrs = [jnp.asarray(a) for a in arrs]
    got = got.numpy()
    np.testing.assert_allclose(got, np.asarray(jref.selective_scan_ref(
        *jarrs)), **TOL)
    np.testing.assert_allclose(got, np.asarray(pallas_scan(
        *jarrs, chunk=chunk, d_block=8, interpret=True)), **TOL)
    y, _ = jssm.selective_scan(*jarrs, chunk=chunk)
    np.testing.assert_allclose(got, np.asarray(y), **TOL)


@pytest.mark.parametrize("b,s,d,n,chunk", SHAPES[:2])
def test_twin_bfloat16_inputs(b, s, d, n, chunk):
    """bfloat16 inputs (``ssm_scan_bf16``) are read as they are and
    combined in float32 on both sides."""
    arrs = _inputs(7 + s, b, s, d, n)
    got = selective_scan(*(torch.from_numpy(a).bfloat16() for a in arrs))
    jarrs = [jnp.asarray(a, jnp.bfloat16) for a in arrs]
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jref.selective_scan_ref(*jarrs)), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas_scan(
        *jarrs, chunk=chunk, d_block=8, interpret=True)), **TOL)


def test_rejects_mismatched_operands():
    dA = torch.zeros((1, 4, 3, 2))
    with pytest.raises(ValueError, match="C"):
        selective_scan(dA, dA, torch.zeros((1, 4, 3)))
    with pytest.raises(ValueError, match="dtypes"):
        selective_scan(dA, dA.double(), torch.zeros((1, 4, 2)))
