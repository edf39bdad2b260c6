"""RG-LRU scan: the hand-written CUDA kernel and its dispatcher.

Replaces the Pallas TPU kernel ``src/repro/kernels/rglru_scan.py::
rglru_scan`` (``pl.pallas_call`` at line 53), and in the model the chunked
associative scan ``src/repro/models/rglru.py::linear_recurrence``, which
computes the same function.

``rglru_scan(a, bx)`` takes a, bx (b, s, w) of one dtype (float32 or
bfloat16) and returns h (b, s, w) float32 of h_t = a_t·h_{t-1} + bx_t,
h_0 = 0, combined in float32.  A CUDA tensor launches the kernel
(``csrc/rglru_scan.cu``: one thread per (batch row, channel), h in a
register, the sequence walked in order with 16 steps loaded ahead); a CPU
tensor runs the eager twin ``ref.rglru_scan_ref``.  There is no fallback
from one to the other.  ``rglru_scan.launches`` counts kernel launches.

The dispatcher reaches the kernel only through the operator
``repro_torch::rglru_scan_fwd`` (``kernels.ops``; cost rule
``selective_scan.scan_cost`` of w lanes, the reference's
``linear_recurrence`` being the same chunked scan; DTensor rule a split
over the batch or the channels).

Training: its autograd formula keeps a and the output h and calls
``repro_torch::rglru_scan_bwd``: on a CUDA tensor the backward kernel of
``csrc/rglru_scan.cu`` (gh walked down the sequence, one thread per
channel, the forward's register buffers of steps loaded ahead; equal to
the twin bitwise), on a CPU tensor the twin ``ref.rglru_scan_bwd_ref``.
``rglru_scan_bwd.launches`` counts backward launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.build import LIBRARIES
from repro_torch.kernels.selective_scan import scan_cost
from repro_torch.kernels.ref import rglru_scan_bwd_ref, rglru_scan_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(a, bx):
    if a.dim() != 3 or tuple(bx.shape) != tuple(a.shape):
        raise ValueError(f"rglru_scan: a {tuple(a.shape)} and bx "
                         f"{tuple(bx.shape)} must be one (b, s, w)")
    if a.dtype != bx.dtype:
        raise ValueError(f"rglru_scan: dtypes differ: {a.dtype}, "
                         f"{bx.dtype}")
    if a.device != bx.device:
        raise ValueError("rglru_scan: operands on different devices")


def _entry(symbol, pointers, ints):
    """The library's C entry point ``symbol``, typed once per process."""
    return LIBRARIES.entry("rglru_scan", symbol, pointers, ints)


def _launcher():
    """The forward's C entry point, typed once per process."""
    return _entry("rglru_scan_launch", 3, 4)


def rglru_scan_cuda(a, bx):
    """Launch the CUDA kernel on contiguous CUDA tensors; returns a freshly
    allocated h."""
    _check(a, bx)
    if a.dtype not in _DTYPE_CODE:
        raise ValueError(f"rglru_scan: dtype {a.dtype} is not float32 or "
                         f"bfloat16")
    for name, t in (("a", a), ("bx", bx)):
        if not t.is_contiguous():
            raise ValueError(f"rglru_scan: {name} must be contiguous")
    b, s, w = a.shape
    h = torch.empty((b, s, w), dtype=torch.float32, device=a.device)
    if h.numel() == 0:
        return h
    fn = _launcher()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(a.data_ptr(), bx.data_ptr(), h.data_ptr(), b, s, w,
                _DTYPE_CODE[a.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error "
                           f"{rc}")
    rglru_scan.launches += 1
    return h


def rglru_scan_bwd_cuda(a, h, gh):
    """Launch the backward kernel on CUDA tensors: a the forward's input,
    h its output and gh (b, s, w) h's gradient; returns freshly allocated
    (g_a, g_bx) in a's dtype."""
    if a.dim() != 3 or tuple(h.shape) != tuple(a.shape) \
            or tuple(gh.shape) != tuple(a.shape):
        raise ValueError(f"rglru_scan_bwd: a {tuple(a.shape)}, h "
                         f"{tuple(h.shape)}, gh {tuple(gh.shape)} must be "
                         f"one (b, s, w)")
    if a.dtype not in _DTYPE_CODE or h.dtype != torch.float32:
        raise ValueError(f"rglru_scan_bwd: a {a.dtype}, h {h.dtype}")
    if not a.is_contiguous() or not h.is_contiguous():
        raise ValueError("rglru_scan_bwd: a and h must be contiguous")
    gh = gh.float().contiguous()
    g_a, g_bx = torch.empty_like(a), torch.empty_like(a)
    if a.numel() == 0:
        return g_a, g_bx
    b, s, w = a.shape
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _entry("rglru_scan_bwd_launch", 5, 4)(
            a.data_ptr(), h.data_ptr(), gh.data_ptr(), g_a.data_ptr(),
            g_bx.data_ptr(), b, s, w, _DTYPE_CODE[a.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"rglru_scan backward launch failed: CUDA error "
                           f"{rc}")
    rglru_scan_bwd.launches += 1
    return g_a, g_bx


def _fwd_cost(args, opts):
    b, s, w = args[0].shape
    return scan_cost(b, s, w)


def _bwd_cost(args, opts):
    """(dot, other) FLOPs of the backward kernel: 3 operations per (row,
    step, channel): gh = gh_out + the carry, the carry a·gh, g_a =
    gh·h_prev."""
    b, s, w = args[0].shape
    return 0.0, 3.0 * b * s * w


def _sharding(*args, n_out):
    """Placements of one mesh dimension: replicated, or split over the
    batch or the channels (every operand (b, s, w))."""
    from torch.distributed.tensor import Replicate, Shard
    n_in = len(args)
    return [([p] * n_out, [p] * n_in)
            for p in (Replicate(), Shard(0), Shard(2))]


def _bwd_fake(a, h, gh):
    return a.new_empty(a.shape), a.new_empty(a.shape)


rglru_scan_bwd_op = ops.define(
    "rglru_scan_bwd", "(Tensor a, Tensor h, Tensor gh) -> (Tensor, Tensor)",
    cpu=rglru_scan_bwd_ref, cuda=rglru_scan_bwd_cuda, fake=_bwd_fake,
    cost=_bwd_cost, sharding=lambda *a: _sharding(*a, n_out=2))


def _setup(ctx, inputs, output):
    ctx.save_for_backward(inputs[0], output)


def _backward(ctx, gh):
    a, h = ctx.saved_tensors
    return rglru_scan_bwd_op(a, h, gh)


rglru_scan_fwd_op = ops.define(
    "rglru_scan_fwd", "(Tensor a, Tensor bx) -> Tensor",
    cpu=rglru_scan_ref, cuda=rglru_scan_cuda,
    fake=lambda a, bx: a.new_empty(a.shape, dtype=torch.float32),
    cost=_fwd_cost, backward=_backward, setup_context=_setup,
    sharding=lambda *a: _sharding(*a, n_out=1))


def rglru_scan_bwd(a, h, gh):
    """The backward (``repro_torch::rglru_scan_bwd``): the CUDA kernel on
    CUDA tensors, the eager twin on CPU tensors."""
    ops.check_device(a, "rglru_scan_bwd")
    return rglru_scan_bwd_op(a, h, gh)


rglru_scan_bwd.launches = 0


def rglru_scan(a, bx):
    """The recurrence (``repro_torch::rglru_scan_fwd``): the CUDA kernel on
    CUDA tensors, the eager twin on CPU tensors, shapes only on the meta
    device; differentiable in a and bx."""
    _check(a, bx)
    ops.check_device(a, "rglru_scan")
    grad = torch.is_grad_enabled() and (a.requires_grad or bx.requires_grad)
    return ops.call(rglru_scan_fwd_op, grad, a, bx)


rglru_scan.launches = 0
