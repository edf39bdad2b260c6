"""Edge-substep physics: the hand-written CUDA kernel and its dispatcher.

Replaces the Pallas TPU kernel ``src/repro/kernels/edge_substep.py::
edge_substep`` (``pl.pallas_call`` at line 192).  ``edge_substep`` takes
the operands in ``CARRY_NAMES + STATIC_NAMES`` order and returns the
``OUT_NAMES`` tuple, with an optional leading grid axis G on every
operand except the shared cluster rows ``mips``/``cap``/``net_bw``.

Dispatch is by the tensors' device: a CUDA tensor launches the kernel
(``csrc/edge_substep.cu``, a thread-block cluster per grid cell, the
substep loop inside the kernel), a CPU tensor runs the eager twin
``ref.edge_substep_ref``.  There is no fallback from one to the other: a
launch the card refuses raises with its CUDA error.
``edge_substep.launches`` counts kernel launches; ``edge_substep_plan``
reports the launch shape the kernel takes for a grid.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import LIBRARIES
from repro_torch.kernels.ref import (CARRY_NAMES, OUT_NAMES, SHARED_NAMES,
                                     STATIC_NAMES, edge_substep_ref)

__all__ = ["CARRY_NAMES", "STATIC_NAMES", "OUT_NAMES", "edge_substep",
           "edge_substep_cuda", "edge_substep_plan"]

f8, i4, b1 = torch.float64, torch.int32, torch.bool

#: dtype and per-cell shape of every operand ("K", "F", "n" symbolic)
_SPEC = {
    "instr": (f8, ("K", "F")), "done": (b1, ("K", "F")),
    "transfer": (f8, ("K", "F")), "stage": (i4, ("K",)),
    "task_done": (b1, ("K",)), "resp": (f8, ("K",)), "now": (f8, (1,)),
    "metrics": (f8, (9,)), "worker": (i4, ("K", "F")),
    "ram_task": (f8, ("K",)), "out_bytes": (f8, ("K", "F")),
    "nfrag": (i4, ("K",)), "chain": (b1, ("K",)), "placed": (b1, ("K",)),
    "sla": (f8, ("K",)), "arrival": (f8, ("K",)), "acc_t": (f8, ("K",)),
    "wait_s": (f8, ("K",)), "decision": (i4, ("K",)),
    "bw_mult": (f8, ("n",)), "mips": (f8, ("n",)), "cap": (f8, ("n",)),
    "net_bw": (f8, ("n",)),
}

_MAX_N = 128     # csrc/edge_substep.cu MAX_N


def _check(args, G, K, F, n, device):
    dims = {"K": K, "F": F, "n": n}
    for name, t in zip(CARRY_NAMES + STATIC_NAMES, args):
        dtype, shp = _SPEC[name]
        want = tuple(dims.get(d, d) for d in shp)
        if name not in SHARED_NAMES:
            want = (G,) + want
        if t.dtype != dtype or tuple(t.shape) != want:
            raise ValueError(f"edge_substep: {name} must be {dtype} of shape "
                             f"{want}, got {t.dtype} {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"edge_substep: {name} is on {t.device}, "
                             f"expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"edge_substep: {name} must be contiguous")


def edge_substep_cuda(*args, substeps: int, dt: float, swap_slowdown: float,
                      nic_cap: float):
    """Launch the CUDA kernel on G-batched CUDA operands; returns the
    ``OUT_NAMES`` tuple of freshly allocated outputs."""
    instr, worker, mips = args[0], args[8], args[20]
    G, K, F = worker.shape
    n = mips.shape[0]
    if n > _MAX_N:
        raise ValueError(f"edge_substep: n={n} workers > kernel limit "
                         f"{_MAX_N}")
    _check(args, G, K, F, n, instr.device)
    outs = (torch.empty_like(args[0]), torch.empty_like(args[1]),
            torch.empty_like(args[2]), torch.empty_like(args[3]),
            torch.empty_like(args[4]), torch.empty_like(args[5]),
            torch.empty_like(args[6]), torch.empty_like(args[7]),
            torch.empty((G, n), dtype=f8, device=instr.device),
            torch.empty((G, n), dtype=f8, device=instr.device))
    if G == 0:
        return outs
    lib = LIBRARIES.get("edge_substep")
    fn = lib.edge_substep_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_double,
                   ctypes.c_double, ctypes.c_double, ctypes.c_void_p]
    ptrs = (ctypes.c_void_p * (len(args) + len(outs)))(
        *[t.data_ptr() for t in args], *[t.data_ptr() for t in outs])
    with torch.cuda.device(instr.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(ptrs, G, K, F, n, int(substeps), float(dt),
                float(swap_slowdown), float(nic_cap), stream)
    if rc != 0:
        raise RuntimeError(f"edge_substep kernel launch failed: CUDA error "
                           f"{rc} ({_error_string(lib, rc)})")
    edge_substep.launches += 1
    return outs


def _error_string(lib, rc):
    fn = lib.edge_substep_error_string
    fn.restype = ctypes.c_char_p
    fn.argtypes = [ctypes.c_int]
    return fn(rc).decode()


def edge_substep_plan(G: int, K: int, F: int) -> dict:
    """The kernel's launch shape for G cells of K tasks and F fragments
    (builds the library on first use; needs a CUDA device): CTAs per
    cluster, threads per CTA, dynamic shared memory per CTA, whether the
    carries stay on chip, and how many clusters the card runs at once."""
    lib = LIBRARIES.get("edge_substep")
    fn = lib.edge_substep_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int)]
    out = (ctypes.c_int * 5)()
    rc = fn(G, K, F, out)
    if rc != 0:
        raise RuntimeError(f"edge_substep_plan: CUDA error {rc} "
                           f"({_error_string(lib, rc)})")
    return {"cluster": out[0], "threads": out[1], "smem_bytes": out[2],
            "on_chip": bool(out[3]), "max_active_clusters": out[4]}


def edge_substep(instr, done, transfer, stage, task_done, resp, now,
                 metrics, worker, ram_task, out_bytes, nfrag, chain,
                 placed, sla, arrival, acc_t, wait_s, decision, bw_mult,
                 mips, cap, net_bw, *, substeps, dt, swap_slowdown, nic_cap):
    """One interval of substep physics: the CUDA kernel on CUDA tensors,
    the eager twin on CPU tensors."""
    args = (instr, done, transfer, stage, task_done, resp, now, metrics,
            worker, ram_task, out_bytes, nfrag, chain, placed, sla, arrival,
            acc_t, wait_s, decision, bw_mult, mips, cap, net_bw)
    kw = dict(substeps=substeps, dt=dt, swap_slowdown=swap_slowdown,
              nic_cap=nic_cap)
    if instr.device.type == "cpu":
        return edge_substep_ref(*args, **kw)
    if instr.device.type != "cuda":
        raise ValueError(f"edge_substep: unsupported device {instr.device}")
    if instr.dim() == 2:       # one cell: add and drop the grid axis
        outs = edge_substep_cuda(*[a if name in SHARED_NAMES else a[None]
                                   for name, a in zip(CARRY_NAMES
                                                      + STATIC_NAMES, args)],
                                 **kw)
        return tuple(o[0] for o in outs)
    return edge_substep_cuda(*args, **kw)


edge_substep.launches = 0
