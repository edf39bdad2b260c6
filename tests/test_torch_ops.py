"""The four model kernels as ``torch.library`` operators
(``repro_torch::*``, ``kernels.ops``): ``opcheck`` of every operator on
the CPU, the fake implementations against the CPU implementations, and
the dispatchers reaching the kernels only through the operators.

The card's side (``opcheck`` on CUDA tensors) is in
``tests/test_torch_gpu.py``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attn_bwd_op,
                                                 flash_attn_fwd_op)
from repro_torch.kernels.moe_route import (moe_route, moe_route_bwd_op,
                                           moe_route_fwd_op)
from repro_torch.kernels.rglru_scan import (rglru_scan, rglru_scan_bwd_op,
                                            rglru_scan_fwd_op)
from repro_torch.kernels.selective_scan import (selective_scan,
                                                selective_scan_bwd_op,
                                                selective_scan_fwd_op)
from repro_torch.launch.flopcount import count_fn


def _t(rng, shape, dtype=torch.float32, grad=False):
    t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return t.to(dtype).requires_grad_(grad)


def _flash_args(rng, grad, dtype=torch.float32, pos=False, b=2, sq=5, sk=5,
                h=4, kvh=2, hd=16, causal=True, window=0):
    q = _t(rng, (b, sq, h, hd), dtype, grad)
    k = _t(rng, (b, sk, kvh, hd), dtype, grad)
    v = _t(rng, (b, sk, kvh, hd), dtype, grad)
    pq = pk = None
    if pos:
        pq = torch.from_numpy(rng.integers(0, 8, (b, sq)).astype(np.int32))
        pk = torch.from_numpy(rng.integers(0, 8, (b, sk)).astype(np.int32))
    return (q, k, v, causal, window, pq, pk, grad)


def _flash_bwd_args(rng, dtype=torch.float32, pos=False):
    q, k, v, causal, window, pq, pk, _ = _flash_args(rng, False, dtype, pos)
    o, lse = flash_attn_fwd_op(q, k, v, causal, window, pq, pk, True)
    return (q, k, v, o, lse, _t(rng, q.shape, dtype), causal, window, pq, pk)


def _scan_args(rng, grad, final_state=False, b=2, s=7, d=3, n=4):
    dA = torch.sigmoid(_t(rng, (b, s, d, n))).requires_grad_(grad)
    return (dA, _t(rng, (b, s, d, n), grad=grad), _t(rng, (b, s, n),
                                                     grad=grad), final_state)


def _route_logits(rng, grouped, grad=False):
    shape = (3, 6, 8) if grouped else (6, 8)
    return _t(rng, shape, grad=grad)


def _route_bwd_args(rng):
    logits = _route_logits(rng, True)
    gate, eid, _ = moe_route_fwd_op(logits, 2)
    return (logits, eid, _t(rng, gate.shape))


#: (name, operator, args builder) of every case opcheck runs
CASES = [
    ("flash_fwd", flash_attn_fwd_op, lambda r: _flash_args(r, False)),
    ("flash_fwd_grad", flash_attn_fwd_op, lambda r: _flash_args(r, True)),
    ("flash_fwd_pos_window", flash_attn_fwd_op,
     lambda r: _flash_args(r, True, pos=True, window=3)),
    ("flash_fwd_noncausal_bf16", flash_attn_fwd_op,
     lambda r: _flash_args(r, False, torch.bfloat16, sk=3, causal=False)),
    ("flash_bwd", flash_attn_bwd_op, lambda r: _flash_bwd_args(r)),
    ("flash_bwd_pos", flash_attn_bwd_op,
     lambda r: _flash_bwd_args(r, pos=True)),
    ("scan_fwd", selective_scan_fwd_op, lambda r: _scan_args(r, False)),
    ("scan_fwd_state", selective_scan_fwd_op,
     lambda r: _scan_args(r, False, True)),
    ("scan_fwd_grad", selective_scan_fwd_op, lambda r: _scan_args(r, True)),
    ("scan_bwd", selective_scan_bwd_op,
     lambda r: _scan_args(r, False)[:3] + (_t(r, (2, 7, 3)),)),
    ("rglru_fwd", rglru_scan_fwd_op, lambda r: (torch.sigmoid(
        _t(r, (2, 9, 5))), _t(r, (2, 9, 5)))),
    ("rglru_fwd_grad", rglru_scan_fwd_op, lambda r: (torch.sigmoid(
        _t(r, (2, 9, 5))).requires_grad_(), _t(r, (2, 9, 5), grad=True))),
    ("rglru_bwd", rglru_scan_bwd_op, lambda r: (
        torch.sigmoid(_t(r, (2, 9, 5))), _t(r, (2, 9, 5)), _t(r, (2, 9, 5)))),
    ("route_fwd", moe_route_fwd_op, lambda r: (_route_logits(r, False), 2)),
    ("route_fwd_grouped_grad", moe_route_fwd_op,
     lambda r: (_route_logits(r, True, True), 3)),
    ("route_bwd", moe_route_bwd_op, _route_bwd_args),
]


@pytest.mark.parametrize("name,op,make", CASES, ids=[c[0] for c in CASES])
def test_opcheck_on_cpu(name, op, make):
    torch.library.opcheck(op, make(np.random.default_rng(0)))


@pytest.mark.parametrize("name,op,make", CASES, ids=[c[0] for c in CASES])
def test_fake_outputs_match_the_cpu_implementation(name, op, make):
    args = make(np.random.default_rng(1))
    with torch.no_grad():
        real = op(*args)
    mode = FakeTensorMode()
    fake_args = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                 for a in args]
    with mode, torch.no_grad():
        fake = op(*fake_args)
    real = real if isinstance(real, tuple) else (real,)
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert len(real) == len(fake)
    for r, f in zip(real, fake):
        assert (tuple(r.shape), r.dtype, r.stride()) \
            == (tuple(f.shape), f.dtype, f.stride())


def test_every_kernel_operator_has_a_cost_rule():
    for op in (flash_attn_fwd_op, flash_attn_bwd_op, selective_scan_fwd_op,
               selective_scan_bwd_op, rglru_scan_fwd_op, rglru_scan_bwd_op,
               moe_route_fwd_op, moe_route_bwd_op):
        assert op in ops.COST_RULES
        assert op.namespace == "repro_torch"


def test_dispatchers_reach_the_kernels_only_through_the_operators():
    """A counter sees one operator per dispatcher call, and nothing that
    the CPU twin does inside it."""
    rng = np.random.default_rng(2)
    q, k, v = _flash_args(rng, False)[:3]
    dA, dBx, C, _ = _scan_args(rng, False)
    a, bx = torch.sigmoid(_t(rng, (1, 4, 3))), _t(rng, (1, 4, 3))
    logits = _route_logits(rng, True)
    calls = [
        (lambda: flash_attention(q, k, v), "repro_torch.flash_attn_fwd"),
        (lambda: selective_scan(dA, dBx, C), "repro_torch.selective_scan_fwd"),
        (lambda: rglru_scan(a, bx), "repro_torch.rglru_scan_fwd"),
        (lambda: moe_route(logits, 2), "repro_torch.moe_route_fwd"),
    ]
    for fn, name in calls:
        counter = count_fn(fn)
        assert dict(counter.ops) == {f"{name}.default": 1}, counter.ops


def test_gradients_go_through_the_backward_operators():
    rng = np.random.default_rng(3)
    q, k, v = _flash_args(rng, True)[:3]
    counter = count_fn(lambda: flash_attention(q, k, v).sum().backward())
    assert counter.ops["repro_torch.flash_attn_fwd.default"] == 1
    assert counter.ops["repro_torch.flash_attn_bwd.default"] == 1
    dA, dBx, C, _ = _scan_args(rng, True)
    counter = count_fn(lambda: selective_scan(dA, dBx, C).sum().backward())
    assert counter.ops["repro_torch.selective_scan_bwd.default"] == 1
    a = torch.sigmoid(_t(rng, (1, 4, 3))).detach().requires_grad_()
    counter = count_fn(lambda: rglru_scan(a, a * 2).sum().backward())
    assert counter.ops["repro_torch.rglru_scan_bwd.default"] == 1
    logits = _route_logits(rng, True, True)
    counter = count_fn(lambda: moe_route(logits, 2)[1].sum().backward())
    assert counter.ops["repro_torch.moe_route_bwd.default"] == 1


def test_meta_tensors_get_shapes_and_other_devices_raise():
    with torch.device("meta"):
        q, k = torch.empty(2, 9, 4, 16), torch.empty(2, 9, 2, 16)
        logits = torch.empty(3, 8, 6)
    out = flash_attention(q, k, k)
    assert out.device.type == "meta" and out.shape == q.shape
    eid, gate, slot = moe_route(logits, 2)
    assert eid.shape == (3, 8, 2) and eid.dtype == torch.int32
    with pytest.raises(ValueError, match="unsupported device"):
        ops.check_device(_FakeDevice(), "flash_attention")


class _FakeDevice:
    """A tensor-like on a device the operators do not serve."""
    device = torch.device("xpu")


def test_a_final_state_with_a_gradient_raises():
    dA, dBx, C, _ = _scan_args(np.random.default_rng(4), True)
    with pytest.raises(ValueError, match="not the final state"):
        selective_scan(dA, dBx, C, final_state=True)
