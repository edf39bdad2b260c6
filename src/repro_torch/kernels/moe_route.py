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
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import LIBRARIES
from repro_torch.kernels.ref import moe_route_ref

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


def moe_route(logits, top_k):
    """Routing: the CUDA kernel on CUDA tensors, the eager twin on CPU
    tensors."""
    if logits.device.type == "cpu":
        _check(logits, top_k)
        return moe_route_ref(logits, top_k)
    if logits.device.type != "cuda":
        raise ValueError(f"moe_route: unsupported device {logits.device}")
    return moe_route_cuda(logits, top_k)


moe_route.launches = 0
