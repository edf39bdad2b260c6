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
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import LIBRARIES
from repro_torch.kernels.ref import rglru_scan_ref

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


_LAUNCHER = []


def _launcher():
    """The library's C entry point, typed once per process."""
    if not _LAUNCHER:
        fn = LIBRARIES.get("rglru_scan").rglru_scan_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        _LAUNCHER.append(fn)
    return _LAUNCHER[0]


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


def rglru_scan(a, bx):
    """The recurrence: the CUDA kernel on CUDA tensors, the eager twin on
    CPU tensors."""
    if a.device.type == "cpu":
        _check(a, bx)
        return rglru_scan_ref(a, bx)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan: unsupported device {a.device}")
    return rglru_scan_cuda(a, bx)


rglru_scan.launches = 0
