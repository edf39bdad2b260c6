"""Selective scan (Mamba-1): the hand-written CUDA kernel and its dispatcher.

Replaces the Pallas TPU kernel ``src/repro/kernels/selective_scan.py::
selective_scan`` (``pl.pallas_call`` at line 61), and in the model the
chunked associative scan ``src/repro/models/ssm.py::selective_scan``, which
computes the same function.

``selective_scan(dA, dBx, C, final_state=False)`` takes dA, dBx (b, s,
d_in, n) of one dtype (float32 or bfloat16) and C (b, s, n), and returns
y (b, s, d_in) float32 of h_t = dA_t·h_{t-1} + dBx_t, y_t = <h_t, C_t>,
h_0 = 0, with the state in float32; with ``final_state`` it returns
(y, h_s), the state after the last step (b, d_in, n) float32 that
``models.ssm.mamba_prefill`` caches (the reference's
``ssm.selective_scan`` returns it too).  A CUDA tensor launches the kernel (``csrc/selective_scan.cu``: one
thread per (batch row, channel), its n <= 16 states in registers, the
sequence walked in order); a CPU tensor runs the eager twin
``ref.selective_scan_ref``.  There is no fallback from one to the other.
``selective_scan.launches`` counts kernel launches.

The dispatcher reaches the kernel only through the operator
``repro_torch::selective_scan_fwd`` (``kernels.ops``; cost rule
``scan_cost``, DTensor rule a split over the batch or the channels).

Training: its autograd formula (of y, not the final state) calls
``repro_torch::selective_scan_bwd``: on a CUDA tensor the backward
kernels of ``csrc/selective_scan.cu`` (a thread per (channel, state); a
forward pass keeps the state at every L-th step, then each chunk of L
steps is recomputed from its checkpoint and gh walked down it; g_C
summed over channel blocks through written partials; no atomics), on a
CPU tensor the twin ``ref.selective_scan_bwd_ref``.
``selective_scan_bwd.launches`` counts backward calls.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.build import LIBRARIES
from repro_torch.kernels.ref import selective_scan_bwd_ref, selective_scan_ref

#: the kernel keeps at most this many states per channel in registers
MAX_STATE = 16
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(dA, dBx, C):
    if dA.dim() != 4 or tuple(dBx.shape) != tuple(dA.shape):
        raise ValueError(f"selective_scan: dA {tuple(dA.shape)} and dBx "
                         f"{tuple(dBx.shape)} must be one (b, s, d_in, n)")
    b, s, _, n = dA.shape
    if tuple(C.shape) != (b, s, n):
        raise ValueError(f"selective_scan: C {tuple(C.shape)} is not "
                         f"{(b, s, n)}")
    if dA.dtype != dBx.dtype:
        raise ValueError(f"selective_scan: dtypes differ: {dA.dtype}, "
                         f"{dBx.dtype}")
    if not (dA.device == dBx.device == C.device):
        raise ValueError("selective_scan: operands on different devices")


def _entry(symbol, pointers, ints):
    """The library's C entry point ``symbol``, typed once per process."""
    return LIBRARIES.entry("selective_scan", symbol, pointers, ints)


def _launcher():
    """The forward's C entry point, typed once per process."""
    return _entry("selective_scan_launch", 5, 5)


def selective_scan_cuda(dA, dBx, C, final_state=False):
    """Launch the CUDA kernel on contiguous CUDA tensors; returns a freshly
    allocated y, or (y, h_final).  A bfloat16 C is converted to float32
    (exactly)."""
    _check(dA, dBx, C)
    b, s, d_in, n = dA.shape
    if dA.dtype not in _DTYPE_CODE:
        raise ValueError(f"selective_scan: dtype {dA.dtype} is not float32 "
                         f"or bfloat16")
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"selective_scan: state dim {n} outside "
                         f"[1, {MAX_STATE}]")
    for name, t in (("dA", dA), ("dBx", dBx)):
        if not t.is_contiguous():
            raise ValueError(f"selective_scan: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"selective_scan: {name} must be 16-byte "
                             f"aligned")
    C = C.float().contiguous()
    y = torch.empty((b, s, d_in), dtype=torch.float32, device=dA.device)
    h = torch.zeros((b, d_in, n), dtype=torch.float32, device=dA.device) \
        if final_state else None
    if y.numel() == 0:
        return (y, h) if final_state else y
    fn = _launcher()
    with torch.cuda.device(dA.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(dA.data_ptr(), dBx.data_ptr(), C.data_ptr(), y.data_ptr(),
                None if h is None else h.data_ptr(),
                b, s, d_in, n, _DTYPE_CODE[dA.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"selective_scan kernel launch failed: CUDA "
                           f"error {rc}")
    selective_scan.launches += 1
    return (y, h) if final_state else y


def _bwd_scratch(b, s, d_in, n):
    """Shapes of the backward's float32 scratch, from the built library:
    the checkpoints (b, ceil(s / L), d_in, n), h before every L-th step,
    and the g_C partials (b, s, ceil(d_in / channels per CTA), n)."""
    dims = (ctypes.c_int * 2)()
    rc = _entry("selective_scan_bwd_scratch", 1, 3)(
        ctypes.addressof(dims), s, d_in, n, None)
    if rc != 0:
        raise RuntimeError(f"selective_scan backward scratch: CUDA error "
                           f"{rc}")
    return (b, dims[0], d_in, n), (b, s, dims[1], n)


def selective_scan_bwd_cuda(dA, dBx, C, gy):
    """Launch the backward kernels on CUDA tensors: gy (b, s, d_in) the
    gradient of y; returns freshly allocated (g_dA, g_dBx) in the inputs'
    dtype and g_C (b, s, n) float32."""
    _check(dA, dBx, C)
    b, s, d_in, n = dA.shape
    if dA.dtype not in _DTYPE_CODE or not 1 <= n <= MAX_STATE:
        raise ValueError(f"selective_scan_bwd: {dA.dtype} with state dim "
                         f"{n} is not built")
    if tuple(gy.shape) != (b, s, d_in):
        raise ValueError(f"selective_scan_bwd: gy {tuple(gy.shape)} is not "
                         f"{(b, s, d_in)}")
    for name, t in (("dA", dA), ("dBx", dBx)):
        if not t.is_contiguous():
            raise ValueError(f"selective_scan_bwd: {name} must be "
                             f"contiguous")
    C = C.float().contiguous()
    gy = gy.float().contiguous()
    g_dA, g_dBx = torch.empty_like(dA), torch.empty_like(dBx)
    g_C = torch.empty((b, s, n), dtype=torch.float32, device=dA.device)
    if g_dA.numel() == 0:
        return g_dA, g_dBx, g_C.zero_()
    ckpt_shape, partial_shape = _bwd_scratch(b, s, d_in, n)
    ckpt = torch.empty(ckpt_shape, dtype=torch.float32, device=dA.device)
    partial = torch.empty(partial_shape, dtype=torch.float32,
                          device=dA.device)
    with torch.cuda.device(dA.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _entry("selective_scan_bwd_launch", 9, 5)(
            dA.data_ptr(), dBx.data_ptr(), C.data_ptr(), gy.data_ptr(),
            ckpt.data_ptr(), g_dA.data_ptr(), g_dBx.data_ptr(),
            partial.data_ptr(), g_C.data_ptr(), b, s, d_in, n,
            _DTYPE_CODE[dA.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"selective_scan backward launch failed: CUDA "
                           f"error {rc}")
    selective_scan_bwd.launches += 1
    return g_dA, g_dBx, g_C


#: the reference's chunk (``repro.models.ssm.selective_scan``)
CHUNK = 64
#: what the reference's counter counts per (batch row, channel, state)
#: for one chunk of its associative scan: the up- and down-sweeps of
#: ``lax.associative_scan``, the carry's injection (2 per step) and the
#: last state's slice; plus 3 scalar operations per chunk
CHUNK_OPS = 741


def scan_cost(b, s, lanes, n=None):
    """(dot, other) FLOPs of a chunked scan of ``lanes`` = b·d_in·n (or
    b·w) independent recurrences over s steps, as the reference's counter
    counts its jnp twin: the sequence padded to whole chunks (each padded
    input entry a copy), ``CHUNK_OPS`` per lane and chunk; with ``n``
    (the selective scan: lanes = d_in·n per row) also y_t = <h_t, C_t>,
    a product of 2·b·s_pad·d_in·n.  ``lanes`` excludes the batch."""
    s_pad = -(-s // CHUNK) * CHUNK
    chunks = s_pad // CHUNK
    other = chunks * (CHUNK_OPS * b * lanes + 3)
    if s_pad != s:
        other += 2 * b * s_pad * lanes + (b * s_pad * n if n else 0)
    dot = 2.0 * b * s_pad * lanes if n else 0.0
    return dot, float(other)


def _h_none(dA):
    """The final-state output of a call that did not ask for it: (b, d_in,
    0) float32, which shards like the real one."""
    return dA.new_empty((dA.shape[0], dA.shape[2], 0), dtype=torch.float32)


def _fwd_cpu(dA, dBx, C, final_state):
    if final_state:
        return selective_scan_ref(dA, dBx, C, final_state=True)
    return selective_scan_ref(dA, dBx, C), _h_none(dA)


def _fwd_cuda(dA, dBx, C, final_state):
    if final_state:
        return selective_scan_cuda(dA, dBx, C, final_state=True)
    return selective_scan_cuda(dA, dBx, C), _h_none(dA)


def _fwd_fake(dA, dBx, C, final_state):
    b, s, d_in, n = dA.shape
    return (dA.new_empty((b, s, d_in), dtype=torch.float32),
            dA.new_empty((b, d_in, n if final_state else 0),
                         dtype=torch.float32))


def _fwd_cost(args, opts):
    b, s, d_in, n = args[0].shape
    return scan_cost(b, s, d_in * n, n)


def _bwd_cost(args, opts):
    """(dot, other) FLOPs of the backward kernels: g_C = Σ_d gy·h, a
    product of 2·b·s·d_in·n, and 8 operations per (row, step, channel,
    state): the state formed twice (the checkpoint pass, then each chunk
    from its checkpoint; a product and a sum each), gh = C·gy + the carry
    (2), the carry dA·gh (1) and g_dA = gh·h (1)."""
    b, s, d_in, n = args[0].shape
    return 2.0 * b * s * d_in * n, 8.0 * b * s * d_in * n


def _fwd_sharding(dA, dBx, C, final_state):
    """Placements of one mesh dimension: replicated, split over the
    batch, or over the channels (C replicated)."""
    from torch.distributed.tensor import Replicate, Shard
    R = Replicate()
    return [([R, R], [R, R, R, None]),
            ([Shard(0), Shard(0)], [Shard(0)] * 3 + [None]),
            ([Shard(2), Shard(1)], [Shard(2), Shard(2), R, None])]


def _bwd_sharding(dA, dBx, C, gy):
    """As the forward's; over the channels g_C is a partial sum."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    R = Replicate()
    return [([R, R, R], [R, R, R, R]),
            ([Shard(0)] * 3, [Shard(0)] * 4),
            ([Shard(2), Shard(2), Partial()], [Shard(2), Shard(2), R,
                                                Shard(2)])]


def _bwd_cpu(dA, dBx, C, gy):
    _check(dA, dBx, C)
    return selective_scan_bwd_ref(dA, dBx, C, gy)


def _bwd_fake(dA, dBx, C, gy):
    return (dA.new_empty(dA.shape), dBx.new_empty(dBx.shape),
            dA.new_empty(C.shape, dtype=torch.float32))


selective_scan_bwd_op = ops.define(
    "selective_scan_bwd",
    "(Tensor dA, Tensor dBx, Tensor C, Tensor gy) -> (Tensor, Tensor, Tensor)",
    cpu=_bwd_cpu, cuda=selective_scan_bwd_cuda, fake=_bwd_fake,
    cost=_bwd_cost, sharding=_bwd_sharding)


def _setup(ctx, inputs, output):
    dA, dBx, C, _ = inputs
    ctx.save_for_backward(dA, dBx, C)


def _backward(ctx, gy, g_h):
    dA, dBx, C = ctx.saved_tensors
    g_dA, g_dBx, g_C = selective_scan_bwd_op(dA, dBx, C, gy)
    return g_dA, g_dBx, g_C.to(C.dtype), None


selective_scan_fwd_op = ops.define(
    "selective_scan_fwd",
    "(Tensor dA, Tensor dBx, Tensor C, bool final_state) -> (Tensor, Tensor)",
    cpu=_fwd_cpu, cuda=_fwd_cuda, fake=_fwd_fake, cost=_fwd_cost,
    backward=_backward, setup_context=_setup, sharding=_fwd_sharding)


def selective_scan_bwd(dA, dBx, C, gy):
    """The backward (``repro_torch::selective_scan_bwd``): the CUDA kernels
    on CUDA tensors, the eager twin on CPU tensors."""
    _check(dA, dBx, C)
    ops.check_device(dA, "selective_scan_bwd")
    return selective_scan_bwd_op(dA, dBx, C, gy)


selective_scan_bwd.launches = 0


def selective_scan(dA, dBx, C, final_state=False):
    """The scan (``repro_torch::selective_scan_fwd``): the CUDA kernel on
    CUDA tensors, the eager twin on CPU tensors, shapes only on the meta
    device; differentiable in y (a final state asked for with a gradient
    raises)."""
    _check(dA, dBx, C)
    ops.check_device(dA, "selective_scan")
    grad = torch.is_grad_enabled() and (dA.requires_grad or dBx.requires_grad
                                        or C.requires_grad)
    if final_state and grad:
        raise ValueError("selective_scan: the gradient covers y, not the "
                         "final state")
    y, h = ops.call(selective_scan_fwd_op, grad, dA, dBx, C,
                    bool(final_state))
    return (y, h) if final_state else y


selective_scan.launches = 0
