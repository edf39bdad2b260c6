"""The model kernels as ``torch.library`` operators (namespace
``repro_torch``).

The Pallas kernels of the reference are JAX primitives: ``make_jaxpr``,
``eval_shape`` and GSPMD see each call.  Here each hand-written kernel is
an operator that PyTorch's dispatcher sees in the same way: a CUDA
implementation (the kernel's ``ctypes`` launch), a CPU implementation (its
eager twin), a fake implementation (shapes, dtypes and strides only; it
also serves the meta device), an autograd formula that calls the
backward operator, a cost rule (``COST_RULES``, read by
``launch.flopcount``) and a DTensor sharding rule.  So a
``TorchDispatchMode`` (the FLOP counter, ``FakeTensorMode``, DTensor)
sees one call per kernel launch, never what the CPU twin does inside.

``define(name, schema, ...)`` registers one operator; the kernel modules
(``flash_attention``, ``selective_scan``, ``rglru_scan``, ``moe_route``)
call it when they are imported.
"""
from __future__ import annotations

import torch

LIB = torch.library.Library("repro_torch", "FRAGMENT")

#: operator overload -> cost(args) -> (dot FLOPs, other FLOPs); the bytes
#: of an operator are its own traffic (each input read once, each output
#: written once), which the counter takes from the call
COST_RULES = {}


def define(name, schema, *, cpu, cuda, fake, cost, backward=None,
           setup_context=None, sharding=None):
    """Register ``repro_torch::name`` with ``schema`` (the part after the
    name) and return its default overload."""
    LIB.define(name + schema)
    LIB.impl(name, cpu, "CPU")
    LIB.impl(name, cuda, "CUDA")
    qual = f"repro_torch::{name}"
    torch.library.register_fake(qual, fake, lib=LIB)
    if backward is not None:
        torch.library.register_autograd(qual, backward,
                                        setup_context=setup_context, lib=LIB)
    op = getattr(torch.ops.repro_torch, name).default
    COST_RULES[op] = cost
    if sharding is not None and torch.distributed.is_available():
        from torch.distributed.tensor.experimental import register_sharding
        register_sharding(op)(sharding)
    return op


def call(op, grad, *args):
    """``op(*args)``; without a gradient wanted (``grad`` false) below
    autograd, which skips the Python autograd formula's wrapper on the
    host-bound decode and serving paths (dispatch modes, DTensor and fake
    tensors still see the call)."""
    if grad:
        return op(*args)
    with torch._C._AutoDispatchBelowAutograd():
        return op(*args)


def check_device(t, what):
    """Raise for a tensor on a device the operators do not serve: the CUDA
    kernel, the CPU twin and the meta device's shapes are the only paths,
    with no fallback from one to another."""
    if t.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{what}: unsupported device {t.device}")
