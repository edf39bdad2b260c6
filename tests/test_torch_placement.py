"""The sequential placement scans of the port (``repro_torch.kernels
.placement``), on the CPU where they run their eager twins.

The scans as a whole are held against the JAX driver in
``test_torch_driver.py``; these tests pin their contract directly:
first-maximum BestFit choices with RAM-aware score updates, the repair's
most-headroom fallback and whole-task failure, and per-cell trip counts
under grid batching.  The CUDA kernels are held against these twins in
``test_torch_gpu.py`` and by ``chip_smoke.py``.

The repair kernel does not walk the operands as the twin does: it gathers
the walked slots into compacted records a chunk at a time, then walks the
records with a cached headroom argmax.  ``_gather_walk`` below is a plain
emulation of that order, held bitwise against the twin here, where the
kernel itself cannot run.  Likewise ``_keyed_walk`` emulates the BestFit
kernel: its operands staged 32 steps at a time, its per-lane state and its
argmax over order-preserving 64-bit keys reduced in two 32-bit halves and
then by index.
"""
from __future__ import annotations

import struct

import numpy as np
import pytest
import torch

from _torch_ref import bestfit_fuzz, repair_fuzz
from repro_torch.kernels import placement

f8, i4, i8 = torch.float64, torch.int32, torch.int64


def _bestfit_case():
    """Two cells, K=3 slots, F=2, n=3 workers."""
    G, K, F, n = 2, 3, 2, 3
    ram = torch.tensor([[[2.0, 2.0], [5.0, 5.0], [1.0, 1.0]],
                        [[4.0, 4.0], [4.0, 4.0], [4.0, 4.0]]], dtype=f8)
    cap = torch.tensor([6.0, 6.0, 10.0], dtype=f8)
    mips = torch.tensor([4000.0, 4000.0, 8000.0], dtype=f8)
    static = 0.3 * mips / mips.max()
    load0 = torch.zeros((G, n), dtype=f8)
    ram_free0 = cap.expand(G, n).clone()
    score0 = -load0 + static + 0.1 * ram_free0 / cap
    pos = torch.tensor([[0, 1, 2, 3, 4, 5], [4, 5, 0, 0, 0, 0]], dtype=i8)
    n_new = torch.tensor([5, 2], dtype=i8)
    req = torch.full((G, K, F), -1, dtype=i4)
    return pos, n_new, ram, ram_free0, load0, score0, static, cap, req


def test_bestfit_scan_greedy_sequence():
    args = _bestfit_case()
    out = placement.bestfit_scan(*args)
    # cell 0: the big worker 2 has the best score, then its load drops it
    # below worker 0; worker 0 (4 MB left) cannot take the 5 MB fragments,
    # so they go to 1 and, when 1 is full too, back to 2; the sixth
    # fragment is past n_new and stays -1
    assert out[0].tolist() == [[2, 0], [1, 2], [0, -1]]
    # cell 1: only its two real fragments are placed
    assert out[1].tolist() == [[-1, -1], [-1, -1], [2, 0]]


def test_bestfit_scan_no_worker_fits_takes_first_index():
    pos, n_new, ram, ram_free0, load0, score0, static, cap, req = \
        _bestfit_case()
    ram = torch.full_like(ram, 50.0)
    out = placement.bestfit_scan(pos, n_new, ram, ram_free0, load0, score0,
                                 static, cap, req)
    # every worker is masked to -1e9: argmax keeps the first maximum
    assert out[0, 0, 0] == 0


def test_bestfit_scan_cells_are_independent():
    args = _bestfit_case()
    both = placement.bestfit_scan(*args)
    for g in range(2):
        one = placement.bestfit_scan(*[a[g:g + 1] if a.dim() > 1 or
                                       a.shape[0] == 2 else a for a in args])
        assert torch.equal(one[0], both[g])


def _repair_case():
    """One cell, n=2 workers of 10 MB; slots in admission order 2, 0, 1."""
    K, F, n = 3, 2, 2
    order = torch.tensor([[2, 0, 1]], dtype=i8)
    alive = torch.ones((1, K), dtype=torch.bool)
    done = torch.tensor([[[False, True], [False, False], [False, True]]])
    chain = torch.tensor([[False, True, False]])
    stage = torch.zeros((1, K), dtype=i4)
    ram = torch.tensor([[[6.0, 6.0], [3.0, 3.0], [7.0, 7.0]]], dtype=f8)
    req = torch.tensor([[[0, -1], [0, 0], [0, -1]]], dtype=i4)
    cap = torch.tensor([10.0, 10.0], dtype=f8)
    worker2 = req.clone()
    placed = torch.ones((1, K), dtype=torch.bool)
    return order, alive, done, chain, stage, req, ram, cap, worker2, placed


def test_repair_scan_fallback_and_failure():
    order, alive, done, chain, stage, req, ram, cap, w2, placed = \
        _repair_case()
    trip = torch.tensor([3], dtype=i8)
    worker, placed_out = placement.repair_scan(
        order, trip, alive, done, chain, stage, req, ram, cap, w2, placed)
    # slot 2 (7 MB) fits worker 0; slot 0 (6 MB) no longer fits worker 0
    # and moves to worker 1 (most headroom); slot 1 is a chain whose active
    # stage (3 MB) exactly fills worker 0, and whose second stage is
    # admitted without holding RAM
    assert worker[0].tolist() == [[1, -1], [0, 0], [0, -1]]
    assert placed_out[0].tolist() == [True, True, True]


def test_repair_scan_fails_a_task_that_fits_nowhere():
    order, alive, done, chain, stage, req, ram, cap, w2, placed = \
        _repair_case()
    ram[0, 1] = 9.0                  # the chain's stage needs 9 MB
    trip = torch.tensor([3], dtype=i8)
    worker, placed_out = placement.repair_scan(
        order, trip, alive, done, chain, stage, req, ram, cap, w2, placed)
    assert worker[0, 1].tolist() == [-1, -1]
    assert placed_out[0].tolist() == [True, False, True]


def test_repair_scan_zero_trip_is_identity():
    order, alive, done, chain, stage, req, ram, cap, w2, placed = \
        _repair_case()
    trip = torch.tensor([0], dtype=i8)
    worker, placed_out = placement.repair_scan(
        order, trip, alive, done, chain, stage, req, ram, cap, w2, placed)
    assert torch.equal(worker, w2) and torch.equal(placed_out, placed)


def test_kernel_wrappers_reject_bad_operands():
    """The CUDA wrappers validate operands before building or launching."""
    args = list(_bestfit_case())
    args[0] = args[0].int()
    with pytest.raises(ValueError, match="pos"):
        placement.bestfit_scan_cuda(*args)
    order, alive, done, chain, stage, req, ram, cap, w2, placed = \
        _repair_case()
    with pytest.raises(ValueError, match="trip"):
        placement.repair_scan_cuda(order, torch.tensor([3]).int(), alive,
                                   done, chain, stage, req, ram, cap, w2,
                                   placed)
    with pytest.raises(ValueError, match="ram"):
        placement.repair_scan_cuda(order, torch.tensor([3]), alive, done,
                                   chain, stage, req, ram.float(), cap, w2,
                                   placed)


# ------------------------------------------- the repair kernel's walk order


def _gather_walk(order, trip, alive, done, chain, stage, req, ram, cap,
                 worker2, placed, chunk, stats=None):
    """Plain emulation of ``repair_kernel`` in ``csrc/placement.cu``.

    Per cell, the walk steps are taken ``chunk`` at a time.  Gather: a
    slot that is not alive is dropped; each kept slot gives one record
    per fragment that is not done (clamped requested worker, whether it
    holds RAM, its column, its RAM) and a slot-boundary mark (the end of
    its records).  Walk: the records alone, with the per-worker RAM in
    use and a cached first maximum of the headroom that is recomputed
    only when an admission may have moved it.  The kernel stores each
    result as the walk makes it; nothing in the walk reads them, so here
    a chunk's writes are collected and applied at its end, in walk
    order, which leaves the same tensors.  ``stats`` counts fallbacks,
    failed tasks, argmax recomputes and reuses."""
    G, K, F = req.shape
    n = cap.shape[0]
    order, trip, alive, done, chain, stage, req, ram = (
        t.numpy() for t in (order, trip, alive, done, chain, stage, req,
                            ram))
    capl = cap.tolist()
    w2, pl = worker2.clone().numpy(), placed.clone().numpy()
    st = stats if stats is not None else {}
    for key in ("fallback", "failed", "argmax", "reused"):
        st.setdefault(key, 0)
    for g in range(G):
        trips = max(0, min(int(trip[g]), K))
        used = [0.0] * n
        cand, hc, dirty = -1, 0.0, False
        for i0 in range(0, trips, chunk):
            slots, ends, recs = [], [], []
            for i in range(i0, min(i0 + chunk, trips)):
                slot = int(order[g, i])
                if not alive[g, slot]:
                    continue
                ch, sg = bool(chain[g, slot]), int(stage[g, slot])
                for f in range(F):
                    if not done[g, slot, f]:
                        w = min(max(int(req[g, slot, f]), 0), n - 1)
                        recs.append((w, not ch or f == sg, f,
                                     float(ram[g, slot, f])))
                slots.append(slot)
                ends.append(len(recs))
            writes, r = [], 0
            for slot, end in zip(slots, ends):
                ok = True
                while r < end:
                    w, holds, f, rm = recs[r]
                    if holds:
                        u = used[w]
                        if u + rm > capl[w]:
                            if cand < 0 or dirty or \
                                    capl[cand] - used[cand] != hc:
                                head = [capl[v] - used[v] for v in range(n)]
                                cand = max(range(n),
                                           key=lambda v: (head[v], -v))
                                hc, dirty = head[cand], False
                                st["argmax"] += 1
                            else:
                                st["reused"] += 1
                            if not hc >= rm:
                                ok = False
                                break
                            w, u = cand, used[cand]
                            st["fallback"] += 1
                        used[w] = u + rm
                        dirty = dirty or not rm >= 0.0
                    writes.append((slot, f, w))
                    r += 1
                if not ok:
                    writes.extend((slot, f, -1) for f in range(F))
                    r = end
                    st["failed"] += 1
                writes.append((slot, None, ok))
            for slot, f, v in writes:
                if f is None:
                    pl[g, slot] = v
                else:
                    w2[g, slot, f] = v
    return torch.from_numpy(w2), torch.from_numpy(pl)


def _fuzz_ops(seed):
    rng = np.random.RandomState(seed)
    g, k, f, n = (rng.randint(1, 4), rng.randint(1, 80), rng.randint(1, 9),
                  rng.randint(1, 12))
    return [torch.from_numpy(np.ascontiguousarray(a))
            for a in repair_fuzz(rng, g, k, f, n)]


@pytest.mark.parametrize("seed", range(6))
def test_gather_walk_matches_twin_fuzzed(seed):
    ops = _fuzz_ops(seed)
    want = placement.repair_scan_ref(*ops)
    for chunk in (1, 3, 64):
        got = _gather_walk(*ops, chunk)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), chunk


def test_gather_walk_fuzz_reaches_every_path():
    """The fuzz above takes fallbacks, fails tasks, and both recomputes
    and reuses the cached headroom argmax."""
    stats = {}
    for seed in range(6):
        _gather_walk(*_fuzz_ops(seed), 3, stats)
    assert min(stats.values()) > 0, stats


def test_gather_walk_matches_twin_on_real_intervals():
    """Every interval of the small tenth-RAM grid that
    ``test_placement_kernels_match_twins`` runs on the card, here on the
    CPU: the emulation equals the twin at chunks of 1, 7 and 64 slots."""
    from repro_torch.env.cluster import make_cluster
    from repro_torch.env.torchsim import driver, engines, kernels
    from repro_torch.env.torchsim.arrays import (ClusterArrays,
                                                 compile_trace,
                                                 default_capacity,
                                                 stack_traces, to_device)
    from repro_torch.env.torchsim.policies import make_static_decider
    cpu = torch.device("cpu")
    cluster = make_cluster(ram_scale=0.1)
    traces = [compile_trace(make_static_decider("bestfit-rr"), lam=8.0,
                            seed=s, n_intervals=6, substeps=4,
                            cluster=cluster) for s in range(3)]
    trace = to_device(stack_traces(traces), cpu)
    cl = to_device(ClusterArrays.from_cluster(cluster).as_dict(), cpu)
    G, F, n = len(traces), trace["instr"].shape[-1], cl["ram"].shape[0]
    state = kernels.init_state(G, default_capacity(traces), F, n, cpu)
    acc = driver._init_acc(G, n, cpu)
    walked = 0
    for t in range(6):
        arr, _ = engines.StaticEngine().decide({}, trace, t)
        state = kernels.admit(state, arr)
        req = placement.bestfit_scan(*kernels.bestfit_operands(state, cl))
        ops = kernels.repair_operands(state, cl, req)
        want = placement.repair_scan_ref(*ops)
        for chunk in (1, 7, 64):
            got = _gather_walk(*ops, chunk)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), \
                (t, chunk)
        walked += int(ops[1].sum())
        state = kernels.apply_requests(state, cl, req)
        state, acc, _ = driver._interval_physics(
            state, acc, trace["bw_mult"][:, t], cl, 4, 75.0, 300.0, 0.5)
        state["alive"] = state["alive"] & ~state["task_done"]
    assert walked > 0


# ------------------------------------------ the BestFit kernel's keyed walk

_M64 = (1 << 64) - 1


def _order_key(x):
    """``order_key`` of ``csrc/placement.cu``: x + 0.0 (-0.0 becomes +0.0),
    the sign-flipped bits of a double, NaN above every number."""
    x = x + 0.0
    if x != x:
        return _M64
    b = struct.unpack("<Q", struct.pack("<d", x))[0]
    return (~b & _M64) if b >> 63 else b | (1 << 63)


def _keyed_walk(pos, n_new, ram, ram_free0, load0, score0, static, cap, req,
                stats=None):
    """Plain emulation of ``bestfit_kernel`` in ``csrc/placement.cu``.

    Per cell, the steps are staged 32 at a time (step 32c + l in lane l,
    read only below the cell's trip count).  Worker w lives in lane w % 32
    at j = w // 32.  A step masks each worker's score (-1e9 where the
    fragment's RAM does not fit), keeps each lane's first largest key, then
    takes the warp's largest high half, the largest low half among the
    lanes that hold it, and the smallest index among the lanes that hold
    both; the winner's lane updates its state with the twin's arithmetic.
    ``stats`` counts steps, steps decided by the low half or the index
    (ties on the high half), and steps where no worker fits."""
    G, K, F = req.shape
    n, P = cap.shape[0], pos.shape[1]
    out = req.clone().numpy().reshape(G, K * F)
    posn, ramn = pos.numpy(), ram.numpy().reshape(G, K * F)
    stl, cpl = static.tolist(), cap.tolist()
    st = stats if stats is not None else {}
    for key in ("steps", "hi_ties", "masked"):
        st.setdefault(key, 0)
    for g in range(G):
        fr, ld = ram_free0[g].tolist(), load0[g].tolist()
        sc = score0[g].tolist()
        trips = max(0, min(int(n_new[g]), P))
        for c0 in range(0, trips, 32):
            chunk = [(int(posn[g, i]), float(ramn[g, posn[g, i]]))
                     for i in range(c0, min(c0 + 32, trips))]
            for p, rm in chunk:
                lanes = []
                for lane in range(32):
                    bk, bi = 0, 0x7fffffff
                    for w in range(lane, n, 32):
                        k = _order_key(-1e9 if fr[w] < rm else sc[w])
                        if k > bk:
                            bk, bi = k, w
                    lanes.append((bk, bi))
                mh = max(k >> 32 for k, _ in lanes)
                ml = max((k & 0xffffffff) if k >> 32 == mh else 0
                         for k, _ in lanes)
                w = min(i for k, i in lanes
                        if k >> 32 == mh and k & 0xffffffff == ml)
                w = 0 if w >= n else w
                st["steps"] += 1
                st["hi_ties"] += sum(k >> 32 == mh for k, _ in lanes) > 1
                st["masked"] += all(f < rm for f in fr)
                nf = fr[w] - rm
                nl = ld[w] + 1.0
                sc[w] = -nl + stl[w] + 0.1 * nf / cpl[w]
                fr[w], ld[w] = nf, nl
                out[g, p] = w
    return torch.from_numpy(out.reshape(G, K, F))


def _bestfit_ops(seed, g, k, f, n, n_new=None, ties=False):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(np.ascontiguousarray(a))
            for a in bestfit_fuzz(rng, g, k, f, n, n_new=n_new, ties=ties)]


@pytest.mark.parametrize("n", (1, 31, 32, 33, 50, 128))
def test_keyed_walk_matches_twin_fuzzed(n):
    for seed, ties in ((n, False), (n + 1000, True)):
        ops = _bestfit_ops(seed, 3, 9, 4, n, ties=ties)
        assert torch.equal(_keyed_walk(*ops),
                           placement.bestfit_scan_ref(*ops)), (seed, ties)


def test_keyed_walk_ties_reach_every_path():
    """The tied fuzz decides steps by the low half or the index and takes
    steps where no worker fits."""
    stats = {}
    for n in (33, 50):
        _keyed_walk(*_bestfit_ops(n + 1000, 3, 9, 4, n, ties=True), stats)
    assert min(stats.values()) > 0, stats


@pytest.mark.parametrize("first,second", ((-0.0, 0.0), (0.0, -0.0)))
def test_keyed_walk_signed_zeros_take_the_first(first, second):
    """-0.0 and +0.0 are equal maxima: the lower index wins either way,
    as torch.argmax has it (a raw bit key would order them)."""
    pos, n_new, ram, free0, load0, score0, static, cap, req = _bestfit_ops(
        5, 1, 4, 2, 40, n_new=[1])
    score0[:] = -1.0
    score0[0, 3], score0[0, 35] = first, second
    free0[:] = 100.0
    ops = (pos, n_new, ram, free0, load0, score0, static, cap, req)
    want = placement.bestfit_scan_ref(*ops)
    p = int(pos[0, 0])
    assert int(want.view(-1)[p]) == 3
    assert torch.equal(_keyed_walk(*ops), want)


def test_keyed_walk_nan_scores_take_the_first_nan():
    """torch.argmax takes the first NaN; the key puts NaN above every
    number."""
    ops = _bestfit_ops(6, 1, 4, 2, 40, n_new=[1])
    ops[5][0, 7] = float("nan")
    ops[5][0, 20] = float("nan")
    want = placement.bestfit_scan_ref(*ops)
    assert int(want.view(-1)[int(ops[0][0, 0])]) == 7
    assert torch.equal(_keyed_walk(*ops), want)


def test_keyed_walk_every_worker_masked_takes_worker_zero():
    ops = _bestfit_ops(7, 2, 6, 3, 50, n_new=[18, 5])
    ops[2][:] = 1e6                          # no fragment fits anywhere
    want = placement.bestfit_scan_ref(*ops)
    got = _keyed_walk(*ops)
    assert torch.equal(got, want)
    for g, m in enumerate((18, 5)):
        assert (got.view(2, -1)[g, ops[0][g, :m]] == 0).all()


@pytest.mark.parametrize("trips", (0, 1, 31, 32, 33, 63, 64, 65, 96))
def test_keyed_walk_staging_chunk_boundaries(trips):
    """Trips of 0, and at the staging chunk's boundaries +-1, beside cells
    of other trip counts in the same grid."""
    n_new = [trips, 70 - trips // 2, 0]
    ops = _bestfit_ops(100 + trips, 3, 20, 5, 50, n_new=n_new)
    assert torch.equal(_keyed_walk(*ops), placement.bestfit_scan_ref(*ops))


def test_keyed_walk_reads_only_up_to_n_new():
    """pos past n_new is padding the walk never reads: poisoning it (and
    the RAM it would point at) changes nothing below n_new."""
    ops = _bestfit_ops(8, 2, 10, 4, 50, n_new=[13, 33])
    want = _keyed_walk(*ops)
    poisoned = [t.clone() for t in ops]
    poisoned[0][0, 13:] = 10 ** 12
    poisoned[0][1, 33:] = -(10 ** 12)
    assert torch.equal(_keyed_walk(*poisoned), want)
    assert torch.equal(want, placement.bestfit_scan_ref(*ops))


def test_keyed_walk_matches_twin_on_real_intervals():
    """Three real intervals of the tenth-RAM lambda=8 grid of
    ``test_gather_walk_matches_twin_on_real_intervals``: the emulation
    equals the twin."""
    from repro_torch.env.cluster import make_cluster
    from repro_torch.env.torchsim import driver, engines, kernels
    from repro_torch.env.torchsim.arrays import (ClusterArrays,
                                                 compile_trace,
                                                 default_capacity,
                                                 stack_traces, to_device)
    from repro_torch.env.torchsim.policies import make_static_decider
    cpu = torch.device("cpu")
    cluster = make_cluster(ram_scale=0.1)
    traces = [compile_trace(make_static_decider("bestfit-rr"), lam=8.0,
                            seed=s, n_intervals=6, substeps=4,
                            cluster=cluster) for s in range(3)]
    trace = to_device(stack_traces(traces), cpu)
    cl = to_device(ClusterArrays.from_cluster(cluster).as_dict(), cpu)
    G, F, n = len(traces), trace["instr"].shape[-1], cl["ram"].shape[0]
    state = kernels.init_state(G, default_capacity(traces), F, n, cpu)
    acc = driver._init_acc(G, n, cpu)
    steps = 0
    for t in range(3):
        arr, _ = engines.StaticEngine().decide({}, trace, t)
        state = kernels.admit(state, arr)
        ops = kernels.bestfit_operands(state, cl)
        req = placement.bestfit_scan_ref(*ops)
        assert torch.equal(_keyed_walk(*ops), req), t
        steps += int(ops[1].sum())
        state = kernels.apply_requests(state, cl, req)
        state, acc, _ = driver._interval_physics(
            state, acc, trace["bw_mult"][:, t], cl, 4, 75.0, 300.0, 0.5)
        state["alive"] = state["alive"] & ~state["task_done"]
    assert steps > 0
