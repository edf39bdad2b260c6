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

Training: when grad is enabled and a or bx requires it, the call goes
through ``RglruScanFn`` (on both devices), which keeps a and the output h
and whose backward is ``rglru_scan_bwd``: on a CUDA tensor the backward
kernel of ``csrc/rglru_scan.cu`` (gh walked down the sequence, one thread
per channel, the forward's register buffers of steps loaded ahead; equal
to the twin bitwise), on a CPU tensor the twin
``ref.rglru_scan_bwd_ref``.
``rglru_scan_bwd.launches`` counts backward launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import LIBRARIES
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


def rglru_scan_bwd(a, h, gh):
    """The backward: the CUDA kernel on CUDA tensors, the eager twin on
    CPU tensors."""
    if a.device.type == "cpu":
        return rglru_scan_bwd_ref(a, h, gh)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan_bwd: unsupported device {a.device}")
    return rglru_scan_bwd_cuda(a, h, gh)


rglru_scan_bwd.launches = 0


class RglruScanFn(torch.autograd.Function):
    """The recurrence with its gradient (``rglru_scan_bwd``)."""

    @staticmethod
    def forward(ctx, a, bx):
        h = rglru_scan_ref(a, bx) if a.device.type == "cpu" \
            else rglru_scan_cuda(a, bx)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, gh):
        a, h = ctx.saved_tensors
        return rglru_scan_bwd(a, h, gh)


def rglru_scan(a, bx):
    """The recurrence: the CUDA kernel on CUDA tensors, the eager twin on
    CPU tensors; through ``RglruScanFn`` when a gradient is wanted."""
    if torch.is_grad_enabled() and (a.requires_grad or bx.requires_grad):
        _check(a, bx)
        if a.device.type not in ("cpu", "cuda"):
            raise ValueError(f"rglru_scan: unsupported device {a.device}")
        return RglruScanFn.apply(a, bx)
    if a.device.type == "cpu":
        _check(a, bx)
        return rglru_scan_ref(a, bx)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan: unsupported device {a.device}")
    return rglru_scan_cuda(a, bx)


rglru_scan.launches = 0
