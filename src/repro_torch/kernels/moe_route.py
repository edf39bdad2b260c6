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

Training: when grad is enabled and the logits require it, the call goes
through ``MoeRouteFn`` (on both devices); eid and slot carry no gradient,
and the gates' backward is ``moe_route_bwd``: on a CUDA tensor the kernel
``route_bwd_kernel`` of ``csrc/moe_route.cu`` (through the normalisation by
max(Σ, 1e-9), then the softmax; the forward's layout: a sub-warp of lanes
per token, the row in registers, the picks broadcast by shuffles), on a
CPU tensor the twin ``ref.moe_route_bwd_ref``.  ``moe_route_bwd.launches``
counts its launches.
"""
from __future__ import annotations

import ctypes

import torch

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


def moe_route_bwd(logits, eid, g_gate):
    """The gates' backward: the CUDA kernel on CUDA tensors, the eager twin
    on CPU tensors."""
    if logits.device.type == "cpu":
        return moe_route_bwd_ref(logits, eid, g_gate)
    if logits.device.type != "cuda":
        raise ValueError(f"moe_route_bwd: unsupported device "
                         f"{logits.device}")
    return moe_route_bwd_cuda(logits, eid, g_gate)


moe_route_bwd.launches = 0


class MoeRouteFn(torch.autograd.Function):
    """Routing with the gates' gradient (``moe_route_bwd``); eid and slot
    are not differentiable."""

    @staticmethod
    def forward(ctx, logits, top_k):
        out = moe_route_ref(logits, top_k) if logits.device.type == "cpu" \
            else moe_route_cuda(logits, top_k)
        eid, _, slot = out
        ctx.mark_non_differentiable(eid, slot)
        ctx.save_for_backward(logits, eid)
        return out

    @staticmethod
    def backward(ctx, g_eid, g_gate, g_slot):
        logits, eid = ctx.saved_tensors
        if g_gate is None:
            return None, None
        return moe_route_bwd(logits, eid, g_gate).to(logits.dtype), None


def moe_route(logits, top_k):
    """Routing: the CUDA kernel on CUDA tensors, the eager twin on CPU
    tensors; through ``MoeRouteFn`` when the gates' gradient is wanted."""
    if torch.is_grad_enabled() and logits.requires_grad:
        _check(logits, top_k)
        if logits.device.type not in ("cpu", "cuda"):
            raise ValueError(f"moe_route: unsupported device "
                             f"{logits.device}")
        return MoeRouteFn.apply(logits, top_k)
    if logits.device.type == "cpu":
        _check(logits, top_k)
        return moe_route_ref(logits, top_k)
    if logits.device.type != "cuda":
        raise ValueError(f"moe_route: unsupported device {logits.device}")
    return moe_route_cuda(logits, top_k)


moe_route.launches = 0
