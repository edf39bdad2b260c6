"""MoE routing: the hand-written CUDA kernel and its dispatcher.

Replaces the Pallas TPU kernel ``src/repro/kernels/moe_route.py::moe_route``
(``pl.pallas_call`` at line 83), and in the model the jnp path of
``src/repro/models/moe.py`` (``router_topk`` and the one-hot cumsum of
slots), which computes the same function.

``moe_route(logits, top_k)`` takes float32 logits (S, E), or (G, gs, E)
for G independent token groups, and returns (eid int32, gate float32,
slot int32), each (S, k) or (G, gs, k): the softmax's k largest
probabilities (distinct experts, the lower index first on ties), their
gates normalised to sum 1, and each entry's rank among the earlier
entries of its expert in (token, choice) order, per group.  A CUDA tensor
launches the kernel (``csrc/moe_route.cu``: one launch, a CTA per tile of
tokens and a sub-warp per token, the tiles' per-expert counts chained by
a decoupled look-back in tile order, exact slots without unordered
atomics; ``moe_route_plan`` gives the launch shape); a CPU tensor runs
the eager twin ``ref.moe_route_ref``.  There is no fallback from one to the
other.  ``moe_route.launches`` counts kernel launches (one per call).

The dispatcher reaches the kernel only through the operator
``repro_torch::moe_route_fwd`` (``kernels.ops``; it returns (gate, eid,
slot); cost rule ``route_cost``, DTensor rule a split over the groups).

Training: eid and slot carry no gradient, and the operator's autograd
formula for the gates calls ``repro_torch::moe_route_bwd``: on a CUDA
tensor the kernel ``route_bwd_kernel`` of ``csrc/moe_route.cu`` (through
the normalisation by max(Σ, 1e-9), then the softmax; the forward's
layout: a sub-warp of lanes per token, the row in registers, the picks
broadcast by shuffles), on a CPU tensor the twin
``ref.moe_route_bwd_ref``.  ``moe_route_bwd.launches`` counts its
launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.build import LIBRARIES
from repro_torch.kernels.ref import moe_route_bwd_ref, moe_route_ref

#: the kernel's largest expert count (csrc/moe_route.cu MAX_E)
MAX_EXPERTS = 1024


def _check(logits, top_k):
    if logits.dim() not in (2, 3):
        raise ValueError("moe_route: logits must be (S, E) or (G, gs, E), "
                         f"got {tuple(logits.shape)}")
    E = logits.shape[-1]
    if not 1 <= top_k <= E:
        raise ValueError(f"moe_route: top_k={top_k} outside [1, {E}]")


_FNS = []


def _library():
    """The library's C entry points, typed once per process."""
    if not _FNS:
        lib = LIBRARIES.get("moe_route")
        launch = lib.moe_route_launch
        launch.restype = ctypes.c_int
        launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        scratch = lib.moe_route_scratch
        scratch.restype = ctypes.c_longlong
        scratch.argtypes = [ctypes.c_int] * 4
        plan = lib.moe_route_plan
        plan.restype = None
        plan.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
        _FNS.extend((launch, scratch, plan))
    return _FNS


def moe_route_plan(gs, E, top_k) -> dict:
    """The kernel's launch shape for groups of ``gs`` tokens over ``E``
    experts (builds the library on first use)."""
    out = (ctypes.c_int * 7)()
    _library()[2](gs, E, top_k, out)
    return dict(zip(("logits_per_lane", "lanes_per_token", "tokens_per_cta",
                     "threads", "tiles", "rank_warps", "smem_bytes"), out))


def moe_route_cuda(logits, top_k):
    """Launch the CUDA kernel on contiguous float32 CUDA logits; returns
    freshly allocated outputs."""
    _check(logits, top_k)
    if logits.dtype != torch.float32:
        raise ValueError(f"moe_route: logits must be float32, got "
                         f"{logits.dtype}")
    if not logits.is_contiguous():
        raise ValueError("moe_route: logits must be contiguous")
    E = logits.shape[-1]
    if E > MAX_EXPERTS:
        raise ValueError(f"moe_route: {E} experts > {MAX_EXPERTS}")
    lg = logits if logits.dim() == 3 else logits[None]
    G, gs, _ = lg.shape
    dev = logits.device
    eid = torch.empty((G, gs, top_k), dtype=torch.int32, device=dev)
    gate = torch.empty((G, gs, top_k), dtype=torch.float32, device=dev)
    slot = torch.empty((G, gs, top_k), dtype=torch.int32, device=dev)
    if G and gs:
        launch, scratch_words, _ = _library()
        scratch = torch.empty((scratch_words(G, gs, E, top_k),),
                              dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            rc = launch(lg.data_ptr(), eid.data_ptr(), gate.data_ptr(),
                        slot.data_ptr(), scratch.data_ptr(), G, gs, E,
                        top_k, stream)
        if rc != 0:
            raise RuntimeError(f"moe_route kernel launch failed: CUDA error "
                               f"{rc}")
        moe_route.launches += 1
    out = (eid, gate, slot)
    return out if logits.dim() == 3 else tuple(o[0] for o in out)


#: the backward kernel's largest top_k (csrc/moe_route.cu MAX_K)
MAX_BWD_K = 64


def moe_route_bwd_cuda(logits, eid, g_gate):
    """Launch the gates' backward kernel on CUDA tensors: logits (G, gs, E)
    or (S, E) float32, the forward's eid and the gates' gradient g_gate of
    eid's shape; returns freshly allocated g_logits float32 of logits'
    shape."""
    _check(logits, eid.shape[-1])
    k = eid.shape[-1]
    if logits.dtype != torch.float32 or not logits.is_contiguous():
        raise ValueError("moe_route_bwd: logits must be contiguous float32")
    if tuple(eid.shape) != tuple(logits.shape[:-1]) + (k,) \
            or tuple(g_gate.shape) != tuple(eid.shape):
        raise ValueError(f"moe_route_bwd: eid {tuple(eid.shape)} / g_gate "
                         f"{tuple(g_gate.shape)} do not match logits "
                         f"{tuple(logits.shape)}")
    E = logits.shape[-1]
    if E > MAX_EXPERTS or k > MAX_BWD_K:
        raise ValueError(f"moe_route_bwd: E={E}, k={k} past the kernel's "
                         f"{MAX_EXPERTS}, {MAX_BWD_K}")
    eid = eid.to(torch.int32).contiguous()
    g_gate = g_gate.float().contiguous()
    g_logits = torch.empty_like(logits)
    tokens = logits.numel() // E
    if tokens == 0:
        return g_logits
    fn = LIBRARIES.entry("moe_route", "moe_route_bwd_launch", 4, 4)
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(logits.data_ptr(), eid.data_ptr(), g_gate.data_ptr(),
                g_logits.data_ptr(), 1, tokens, E, k, stream)
    if rc != 0:
        raise RuntimeError(f"moe_route backward launch failed: CUDA error "
                           f"{rc}")
    moe_route_bwd.launches += 1
    return g_logits


def route_cost(groups, gs, E, k):
    """(dot, other) FLOPs of routing ``groups`` groups of ``gs`` tokens:
    what the reference's counter counts for its twin
    (``repro.kernels.ref.moe_route_ref``, per group) — the softmax (3 per
    logit, 3 per token), top-k (2 per pick), the gates' normalisation (2
    per token, 1 per pick), the one-hot slot count (4 per pick and
    expert) and its sum (1 per pick)."""
    per = 3 * gs * E + 5 * gs + 4 * gs * k + 4 * gs * k * E
    return 0.0, float(groups * per)


def _fwd_cost(args, opts):
    logits, k = args[0], args[1]
    groups = logits.shape[0] if logits.dim() == 3 else 1
    return route_cost(groups, logits.shape[-2], logits.shape[-1], k)


def _bwd_cost(args, opts):
    """(dot, other) FLOPs of the backward kernel: per token 6 per expert
    (the softmax again, the scatter of g_v, g_logits = p∘(g_p − Σ)) and
    8 per pick (the picked probabilities, their sum and the
    normalisation's vjp)."""
    logits, eid = args[0], args[1]
    tokens = logits.numel() // logits.shape[-1]
    return 0.0, float(tokens * (6 * logits.shape[-1] + 8 * eid.shape[-1]))


def _sharding(*args, n_out):
    """Placements of one mesh dimension: replicated, or (grouped logits)
    split over the groups, whose slots are counted within each group."""
    from torch.distributed.tensor import Replicate, Shard
    tensors = [a for a in args if hasattr(a, "shape")]
    opts = [([Replicate()] * n_out, [Replicate() if hasattr(a, "shape")
                                     else None for a in args])]
    if len(tensors[0].shape) == 3:
        opts.append(([Shard(0)] * n_out, [Shard(0) if hasattr(a, "shape")
                                          else None for a in args]))
    return opts


def _gate_first(out):
    """The operator returns (gate, eid, slot): the float output first."""
    eid, gate, slot = out
    return gate, eid, slot


def _fwd_cpu(logits, top_k):
    return tuple(t.contiguous() for t in
                 _gate_first(moe_route_ref(logits, top_k)))


def _fwd_cuda(logits, top_k):
    return _gate_first(moe_route_cuda(logits, top_k))


def _fwd_fake(logits, top_k):
    shape = tuple(logits.shape[:-1]) + (top_k,)
    return (logits.new_empty(shape, dtype=torch.float32),
            logits.new_empty(shape, dtype=torch.int32),
            logits.new_empty(shape, dtype=torch.int32))


moe_route_bwd_op = ops.define(
    "moe_route_bwd", "(Tensor logits, Tensor eid, Tensor g_gate) -> Tensor",
    cpu=moe_route_bwd_ref, cuda=moe_route_bwd_cuda,
    fake=lambda logits, eid, g_gate: logits.new_empty(
        logits.shape, dtype=torch.float32),
    cost=_bwd_cost, sharding=lambda *a: _sharding(*a, n_out=1))


def _setup(ctx, inputs, output):
    _, eid, slot = output
    ctx.mark_non_differentiable(eid, slot)
    ctx.save_for_backward(inputs[0], eid)


def _backward(ctx, g_gate, g_eid, g_slot):
    logits, eid = ctx.saved_tensors
    if g_gate is None:
        return None, None
    return moe_route_bwd_op(logits, eid, g_gate).to(logits.dtype), None


moe_route_fwd_op = ops.define(
    "moe_route_fwd",
    "(Tensor logits, int top_k) -> (Tensor, Tensor, Tensor)",
    cpu=_fwd_cpu, cuda=_fwd_cuda, fake=_fwd_fake, cost=_fwd_cost,
    backward=_backward, setup_context=_setup,
    sharding=lambda *a: _sharding(*a, n_out=3))


def moe_route_bwd(logits, eid, g_gate):
    """The gates' backward (``repro_torch::moe_route_bwd``): the CUDA
    kernel on CUDA tensors, the eager twin on CPU tensors."""
    ops.check_device(logits, "moe_route_bwd")
    return moe_route_bwd_op(logits, eid, g_gate)


moe_route_bwd.launches = 0


def moe_route(logits, top_k):
    """Routing (``repro_torch::moe_route_fwd``): the CUDA kernel on CUDA
    tensors, the eager twin on CPU tensors, shapes only on the meta
    device; the gates differentiable in the logits."""
    _check(logits, top_k)
    ops.check_device(logits, "moe_route")
    grad = torch.is_grad_enabled() and logits.requires_grad
    gate, eid, slot = ops.call(moe_route_fwd_op, grad, logits, int(top_k))
    return eid, gate, slot


moe_route.launches = 0
