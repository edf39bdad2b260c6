"""The sequential placement scans: CUDA kernels and their eager twins.

``bestfit_scan`` walks a cell's unplaced fragments in admission order and
picks each one's BestFit worker; ``repair_scan`` walks its live slots in
admission order and repairs RAM-infeasible requests.  Both are greedy
sequences (each step sees the previous steps' RAM), batched over grid
cells, and each cell stops at its own trip count.

On CUDA tensors each runs its kernel in ``csrc/placement.cu`` (a CTA per
cell, no host round trip: BestFit walks with one warp that keeps the
per-worker state in registers and stages its operands 32 steps ahead; the
repair gathers the walked slots into shared memory with three warps while
a fourth walks them, ``repair_scan_plan`` gives the layout); on CPU
tensors the eager twins below run, one Python iteration per step to the
grid's largest trip count, masking each cell's steps past its own.
``bestfit_scan.launches`` and ``repair_scan.launches`` count kernel
launches.  In the JAX reference
these are the ``lax.fori_loop`` bodies of ``repro.env.jaxsim.kernels
.bestfit_requests`` and ``.apply_requests``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import LIBRARIES

f8, i4, i8, b1 = torch.float64, torch.int32, torch.int64, torch.bool

_MAX_N = 128     # csrc/placement.cu MAX_N


def _expect(t, name, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {dtype} of shape {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(device):
    with torch.cuda.device(device):
        return torch.cuda.current_stream().cuda_stream


# ------------------------------------------------------------- BestFit


def bestfit_scan_ref(pos, n_new, ram, ram_free0, load0, score0, static,
                     cap, req):
    """Eager twin: ``pos`` (G, P) flat fragment indices (slot·F + f) in
    admission order, the first ``n_new`` (G,) of each row real; per-worker
    free RAM / load / score (G, n) at the start; ``static``/``cap`` (n,);
    ``req`` (G, K, F) the current workers.  Returns the request tensor
    with each scanned fragment's BestFit worker."""
    G = pos.shape[0]
    dev = pos.device
    req = req.clone()
    flat = req.view(G, -1)
    ram_f = ram.reshape(G, -1)
    ram_free, load, score = ram_free0.clone(), load0.clone(), score0.clone()
    trips = min(int(n_new.max()), pos.shape[1]) if G else 0
    gi = torch.arange(G, device=dev)
    for i in range(trips):
        act = i < n_new
        p = pos[:, i]
        rm = ram_f[gi, p]
        buf = torch.where(ram_free < rm[:, None], -1e9, score)
        w = torch.argmax(buf, dim=1)
        nf = ram_free[gi, w] - rm
        nl = load[gi, w] + 1.0
        ns = -nl + static[w] + 0.1 * nf / cap[w]
        flat[gi, p] = torch.where(act, w.to(i4), flat[gi, p])
        ram_free[gi, w] = torch.where(act, nf, ram_free[gi, w])
        load[gi, w] = torch.where(act, nl, load[gi, w])
        score[gi, w] = torch.where(act, ns, score[gi, w])
    return req


def bestfit_scan(pos, n_new, ram, ram_free0, load0, score0, static, cap,
                 req):
    """BestFit requests: the kernel on CUDA tensors, the twin on CPU
    tensors (see ``bestfit_scan_ref`` for the operands)."""
    args = (pos, n_new, ram, ram_free0, load0, score0, static, cap, req)
    if pos.device.type == "cpu":
        return bestfit_scan_ref(*args)
    if pos.device.type != "cuda":
        raise ValueError(f"bestfit_scan: unsupported device {pos.device}")
    return bestfit_scan_cuda(*args)


def bestfit_scan_cuda(pos, n_new, ram, ram_free0, load0, score0, static, cap,
                      req):
    """Validate the operands and launch the BestFit kernel; returns a new
    request tensor."""
    G, K, F = req.shape
    n = cap.shape[0]
    dev = pos.device
    if n > _MAX_N:
        raise ValueError(f"bestfit_scan: n={n} workers > {_MAX_N}")
    P = pos.shape[1]
    _expect(pos, "pos", i8, (G, P), dev)
    _expect(n_new, "n_new", i8, (G,), dev)
    _expect(ram, "ram", f8, (G, K, F), dev)
    for name, t in (("ram_free0", ram_free0), ("load0", load0),
                    ("score0", score0)):
        _expect(t, name, f8, (G, n), dev)
    _expect(static, "static", f8, (n,), dev)
    _expect(cap, "cap", f8, (n,), dev)
    _expect(req, "req", i4, (G, K, F), dev)
    out = req.clone()
    if G == 0 or P == 0:
        return out
    fn = LIBRARIES.get("placement").bestfit_scan_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int] + [ctypes.c_void_p] * 7 + [
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    rc = fn(pos.data_ptr(), n_new.data_ptr(), G, P, ram.data_ptr(),
            ram_free0.data_ptr(), load0.data_ptr(), score0.data_ptr(),
            static.data_ptr(), cap.data_ptr(), out.data_ptr(), K * F, n,
            _stream(dev))
    if rc != 0:
        raise RuntimeError(f"bestfit_scan kernel launch failed: CUDA error "
                           f"{rc}")
    bestfit_scan.launches += 1
    return out


bestfit_scan.launches = 0


# -------------------------------------------------------------- repair


def repair_scan_ref(order, trip, alive, done, chain, stage, req, ram, cap,
                    worker2, placed):
    """Eager twin: walk the first ``trip`` (G,) slots of ``order`` (G, K)
    and admit each live fragment's requested worker ``req`` (G, K, F) if
    its RAM fits, else the worker with the most headroom if that fits,
    else fail the whole task (workers −1, not placed).  ``worker2`` and
    ``placed`` are the starting assignment; returns the repaired
    (worker2, placed)."""
    G, K, F = req.shape
    n = cap.shape[0]
    dev = req.device
    worker2, placed = worker2.clone(), placed.clone()
    trips = int(trip.max()) if G else 0
    gi = torch.arange(G, device=dev)
    ram_used = torch.zeros((G, n), dtype=f8, device=dev)
    for i in range(trips):
        slot = order[:, i]
        pb = alive[gi, slot] & (i < trip)
        ok = torch.ones(G, dtype=b1, device=dev)
        chain_s, stage_s = chain[gi, slot], stage[gi, slot]
        for f in range(F):
            act = pb & ~done[gi, slot, f] & ok
            holds = ~chain_s | (stage_s == f)
            w = req[gi, slot, f].clamp(0, n - 1).long()
            rm = ram[gi, slot, f]
            infeas = act & holds & (ram_used[gi, w] + rm > cap[w])
            headroom = cap - ram_used
            cand = torch.argmax(headroom, dim=1)
            fb_ok = headroom[gi, cand] >= rm
            w2 = torch.where(infeas & fb_ok, cand, w)
            admit_f = act & (~infeas | fb_ok)
            ok = ok & ~(infeas & ~fb_ok)
            worker2[gi, slot, f] = torch.where(admit_f, w2.to(i4),
                                               worker2[gi, slot, f])
            ram_used[gi, w2] = ram_used[gi, w2] + torch.where(
                admit_f & holds, rm, 0.0)
        fail = pb & ~ok
        worker2[gi, slot] = torch.where(fail[:, None], -1, worker2[gi, slot])
        placed[gi, slot] = torch.where(pb, ok, placed[gi, slot])
    return worker2, placed


def repair_scan(order, trip, alive, done, chain, stage, req, ram, cap,
                worker2, placed):
    """RAM feasibility repair: the kernel on CUDA tensors, the twin on
    CPU tensors (see ``repair_scan_ref`` for the operands)."""
    args = (order, trip, alive, done, chain, stage, req, ram, cap, worker2,
            placed)
    if order.device.type == "cpu":
        return repair_scan_ref(*args)
    if order.device.type != "cuda":
        raise ValueError(f"repair_scan: unsupported device {order.device}")
    return repair_scan_cuda(*args)


def repair_scan_cuda(order, trip, alive, done, chain, stage, req, ram, cap,
                     worker2, placed):
    """Validate the operands and launch the repair kernel; returns new
    (worker2, placed) tensors."""
    G, K, F = req.shape
    n = cap.shape[0]
    dev = order.device
    if n > _MAX_N:
        raise ValueError(f"repair_scan: n={n} workers > {_MAX_N}")
    _expect(order, "order", i8, (G, K), dev)
    _expect(trip, "trip", i8, (G,), dev)
    for name, t in (("alive", alive), ("chain", chain)):
        _expect(t, name, b1, (G, K), dev)
    _expect(placed, "placed", b1, (G, K), dev)
    _expect(stage, "stage", i4, (G, K), dev)
    _expect(done, "done", b1, (G, K, F), dev)
    _expect(req, "req", i4, (G, K, F), dev)
    _expect(worker2, "worker2", i4, (G, K, F), dev)
    _expect(ram, "ram", f8, (G, K, F), dev)
    _expect(cap, "cap", f8, (n,), dev)
    worker2, placed = worker2.clone(), placed.clone()
    if G == 0:
        return worker2, placed
    fn = LIBRARIES.get("placement").repair_scan_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 9 + [
                       ctypes.c_int, ctypes.c_void_p]
    rc = fn(order.data_ptr(), trip.data_ptr(), G, K, F, alive.data_ptr(),
            done.data_ptr(), chain.data_ptr(), stage.data_ptr(),
            req.data_ptr(), ram.data_ptr(), cap.data_ptr(),
            worker2.data_ptr(), placed.data_ptr(), n, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"repair_scan kernel launch failed: CUDA error "
                           f"{rc}")
    repair_scan.launches += 1
    return worker2, placed


repair_scan.launches = 0


def repair_scan_plan(F: int) -> dict:
    """The repair kernel's layout for F fragments per slot (builds the
    library on first use): warps per CTA (one walks, the others gather),
    slots per gathered chunk, dynamic shared memory per CTA (two chunk
    buffers)."""
    fn = LIBRARIES.get("placement").repair_scan_plan
    fn.restype = None
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    out = (ctypes.c_int * 3)()
    fn(F, out)
    return {"warps": out[0], "chunk": out[1], "smem_bytes": out[2]}
