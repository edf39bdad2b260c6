#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
(the substep physics and the two placement scans), holds each against
its eager PyTorch twin (fuzzed slot states and one real main-path
interval; float64 at rtol=1e-12, bools and ints exact, bitwise identical
over two runs), then drives the main path — ``run_grid_batched`` for
``bestfit-rr`` and for the ``"mab"`` deploy policy over a 16-cell
(8 seeds × λ∈{6, 24}) grid on the 50-worker Table-3 fleet, 100 intervals
of 30 substeps — counting every kernel's launches, and cross-checks the GPU
driver against the committed golden fixture and against the CPU path.

Prints the card (``nvidia-smi`` name and power limit), per-phase
numbers, a ``{"kernels": [...]}`` JSON line and, as the last line,
``{"ok": true, "device": {...}}``.  Exits non-zero on any failure, on a
machine without CUDA, or when run outside a checkout of the repository.
Imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

RTOL = 1e-12                       # kernel vs twin, float64 carries
GOLDEN = os.path.join(ROOT, "tests", "data",
                      "golden_static_bestfit_rr.json")
GOLDEN_RTOL, GOLDEN_ATOL = 1e-6, 1e-12
#: the literal MAB state of the reference's golden fixtures
MAB_LITERAL = {"R": np.array([700.0, 1800.0, 3500.0]),
               "Q": np.array([[0.8, 0.6], [0.3, 0.7]]),
               "N": np.array([[20.0, 10.0], [5.0, 25.0]]),
               "eps": 0.4, "rho": 0.06, "t": 40}
MAIN = dict(seeds=tuple(range(8)), lams=(6.0, 24.0), n_intervals=100,
            substeps=30)
H100_BYTES_S = 3.35e12             # HBM3, NVIDIA H100 SXM data sheet
H100_FP64_S = 34e12                # FP64 (non-tensor), same data sheet


def log(*a):
    print(*a, flush=True)


def fuzz_inputs(rng, K=12, F=4, N=6):
    """One consistent fuzzed slot state (the reference's fuzz of
    tests/test_edge_substep.py): padding columns born done with worker -1,
    stage in [0, F], positive physical quantities."""
    nfrag = rng.randint(1, F + 1, K).astype(np.int32)
    colpad = np.arange(F)[None, :] >= nfrag[:, None]
    done = rng.rand(K, F) < 0.35
    done |= colpad
    worker = rng.randint(0, N, (K, F)).astype(np.int32)
    worker[colpad] = -1
    placed = rng.rand(K) < 0.8
    worker[~placed] = -1
    task_done = done.all(axis=1) & (rng.rand(K) < 0.5)
    stage = np.minimum(done.argmin(axis=1).astype(np.int32), nfrag - 1)
    stage[done.all(axis=1)] = nfrag[done.all(axis=1)]
    return [np.where(done, 0.0, rng.uniform(1e3, 5e4, (K, F))), done,
            np.where(done, 0.0, rng.uniform(0.0, 30.0, (K, F))), stage,
            task_done, np.where(task_done, rng.uniform(1.0, 50.0, K), 0.0),
            np.asarray([rng.uniform(0.0, 900.0)]), rng.uniform(0.0, 10.0, 9),
            worker, rng.uniform(0.5, 8.0, K), rng.uniform(0.1, 40.0, (K, F)),
            nfrag, rng.rand(K) < 0.5, placed, rng.uniform(5.0, 60.0, K),
            rng.uniform(0.0, 600.0, K), rng.uniform(0.5, 1.0, K),
            rng.uniform(0.0, 10.0, K), rng.randint(0, 3, K).astype(np.int32),
            rng.uniform(0.3, 1.0, N), rng.uniform(2e3, 8e3, N),
            rng.uniform(4.0, 16.0, N), rng.uniform(100.0, 1000.0, N)]


def compare(outs_k, outs_r, names, where):
    """Kernel vs twin: floats at RTOL (atol 0), bools and ints exact;
    returns the largest absolute float difference, or raises naming every
    output that disagrees."""
    import torch
    worst, bad = 0.0, []
    for name, a, b in zip(names, outs_k, outs_r):
        a, b = a.cpu(), b.cpu()
        if a.shape != b.shape or a.dtype != b.dtype:
            bad.append(f"{name} {tuple(a.shape)}/{a.dtype} vs "
                       f"{tuple(b.shape)}/{b.dtype}")
        elif a.dtype.is_floating_point:
            diff = float((a - b).abs().max()) if a.numel() else 0.0
            worst = max(worst, diff)
            if not torch.allclose(a, b, rtol=RTOL, atol=0.0):
                bad.append(f"{name} max abs diff {diff:.3e}")
        elif not torch.equal(a, b):
            bad.append(f"{name} differs at {int((a != b).sum())} entries")
    if bad:
        raise AssertionError(f"{where}: kernel vs twin: " + "; ".join(bad))
    return worst


def bitwise_equal(xs, ys):
    import torch
    return all(torch.equal(x, y) for x, y in zip(xs, ys))


def cuda_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main_path_interval(n_warm=30):
    """The kernels' operands at one real interval of the main-path grid
    (bestfit-rr, G=16, K=default_capacity): the program's stages run for
    ``n_warm`` intervals (by then the λ=24 cells are overloaded and their
    RAM repair walks hundreds of slots), then the next interval's BestFit
    scan, repair scan and physics operands are returned."""
    import torch
    from repro_torch.env.cluster import NIC_CAP_MB, make_cluster
    from repro_torch.env.torchsim import driver, engines, kernels
    from repro_torch.env.torchsim.arrays import (ClusterArrays,
                                                 compile_trace,
                                                 default_capacity,
                                                 stack_traces, to_device)
    from repro_torch.env.torchsim.policies import make_static_decider
    dev = torch.device("cuda")
    dec = make_static_decider("bestfit-rr")
    traces = [compile_trace(dec, lam=lam, seed=seed,
                            n_intervals=MAIN["n_intervals"],
                            substeps=MAIN["substeps"])
              for lam in MAIN["lams"] for seed in MAIN["seeds"]]
    K = default_capacity(traces)
    trace = to_device(stack_traces(traces), dev)
    cl = to_device(ClusterArrays.from_cluster(make_cluster()).as_dict(), dev)
    G, F, n = len(traces), trace["instr"].shape[-1], cl["ram"].shape[0]
    t0 = traces[0]
    dt = t0.interval_s / t0.substeps
    eng = engines.StaticEngine()
    state = kernels.init_state(G, K, F, n, dev)
    acc = driver._init_acc(G, n, dev)
    for t in range(n_warm + 1):
        arr, _ = eng.decide({}, trace, t)
        state = kernels.admit(state, arr)
        if t == n_warm:
            break
        state = kernels.place(state, cl)
        state, acc, _ = driver._interval_physics(
            state, acc, trace["bw_mult"][:, t], cl, t0.substeps, dt,
            t0.interval_s, 0.5)
        state["alive"] = state["alive"] & ~state["task_done"]
    bestfit = kernels.bestfit_operands(state, cl)
    req = kernels.bestfit_requests(state, cl)
    repair = kernels.repair_operands(state, cl, req)
    state = kernels.apply_requests(state, cl, req)
    state["wait_s"] = state["wait_s"] + \
        (state["alive"] & ~state["placed"]).to(torch.float64) * t0.interval_s
    physics = [state["instr"], state["done"], state["transfer"],
               state["stage"], state["task_done"], state["resp"],
               acc["now"][:, None], acc["metrics"], state["worker"],
               state["ram"][..., 0].contiguous(), state["out_bytes"],
               state["nfrag"], state["chain"], state["placed"],
               state["sla"], state["arrival_s"], state["acc"],
               state["wait_s"], state["decision"],
               trace["bw_mult"][:, n_warm].contiguous(), cl["mips"],
               cl["ram"], cl["net_bw"]]
    kw = dict(substeps=t0.substeps, dt=dt, swap_slowdown=0.5,
              nic_cap=NIC_CAP_MB)
    return bestfit, repair, physics, kw


def _record(name, source, replaces, err, ms, plain_ms, nbytes, flops):
    """One entry of the kernels JSON line; the bound is the larger of the
    bytes over the HBM rate and the FP64 operations over the FP64 rate."""
    b_ms = nbytes / H100_BYTES_S * 1e3
    o_ms = flops / H100_FP64_S * 1e3
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "library_ms": None}


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def kernel_phase():
    """Every kernel of the main path vs its twin on the card; returns the
    kernel records."""
    import torch
    from repro_torch.kernels import placement
    from repro_torch.kernels.edge_substep import (OUT_NAMES, edge_substep,
                                                  edge_substep_cuda)
    from repro_torch.kernels.ref import edge_substep_ref
    dev = torch.device("cuda")
    kw = dict(substeps=7, dt=1.5, swap_slowdown=0.5, nic_cap=50.0)
    for seed in range(8):
        args = [torch.from_numpy(np.asarray(a)).to(dev)
                for a in fuzz_inputs(np.random.RandomState(seed))]
        k1 = edge_substep(*args, **kw)
        k2 = edge_substep(*args, **kw)
        torch.cuda.synchronize()
        compare(k1, edge_substep_ref(*args, **kw), OUT_NAMES,
                f"fuzz seed {seed}")
        if not bitwise_equal(k1, k2):
            raise AssertionError(f"fuzz seed {seed}: two runs differ")
    log("edge_substep fuzz: 8 seeds K=12 F=4 N=6 substeps=7 match the twin "
        f"(rtol={RTOL}), bitwise repeatable")

    bestfit, repair, args, kw = main_path_interval()
    G, K, F = args[8].shape
    n = args[20].shape[0]
    records = []

    # BestFit scan: each step reads a fragment's RAM and index and writes
    # its worker; the per-worker rows are read and written once
    b1 = placement.bestfit_scan(*bestfit)
    b2 = placement.bestfit_scan(*bestfit)
    bref = placement.bestfit_scan_ref(*bestfit)
    torch.cuda.synchronize()
    compare([b1], [bref], ["req"], "bestfit_scan")
    if not torch.equal(b1, b2):
        raise AssertionError("bestfit_scan: two runs differ")
    steps = int(bestfit[1].sum())
    ms = cuda_ms(lambda: placement.bestfit_scan(*bestfit), 10)
    plain_ms = cuda_ms(lambda: placement.bestfit_scan_ref(*bestfit), 1)
    log(f"bestfit_scan at a main-path interval: G={G} K={K} F={F} n={n}, "
        f"{int(bestfit[1].max())} fragments in the longest cell ({steps} "
        f"over the grid): matches the twin exactly; {ms:.4f} ms/call (twin "
        f"{plain_ms:.4f} ms/call)")
    records.append(_record(
        "bestfit_scan", "src/repro_torch/kernels/csrc/placement.cu",
        "src/repro/env/jaxsim/kernels.py:202", 0.0, ms, plain_ms,
        _nbytes(list(bestfit[3:8])) + steps * (8 + 8 + 4), 0.0))

    # repair scan: each walked slot reads its task row and fragment rows
    # and writes its workers and placed flag
    r1 = placement.repair_scan(*repair)
    r2 = placement.repair_scan(*repair)
    rref = placement.repair_scan_ref(*repair)
    torch.cuda.synchronize()
    compare(r1, rref, ["worker", "placed"], "repair_scan")
    if not bitwise_equal(r1, r2):
        raise AssertionError("repair_scan: two runs differ")
    walked = int(repair[1].sum())
    ms = cuda_ms(lambda: placement.repair_scan(*repair), 10)
    plain_ms = cuda_ms(lambda: placement.repair_scan_ref(*repair), 1)
    log(f"repair_scan at a main-path interval: {int(repair[1].max())} slots "
        f"in the longest cell ({walked} over the grid): matches the twin "
        f"exactly; {ms:.4f} ms/call (twin {plain_ms:.4f} ms/call)")
    records.append(_record(
        "repair_scan", "src/repro_torch/kernels/csrc/placement.cu",
        "src/repro/env/jaxsim/kernels.py:271", 0.0, ms, plain_ms,
        walked * (8 + 1 + 1 + 4 + 1 + F * (1 + 4 + 8 + 4)) + n * 8, 0.0))

    # substep physics
    k1 = edge_substep_cuda(*args, **kw)
    k2 = edge_substep_cuda(*args, **kw)
    ref = edge_substep_ref(*args, **kw)
    torch.cuda.synchronize()
    err = compare(k1, ref, OUT_NAMES, "main-path interval")
    if not bitwise_equal(k1, k2):
        raise AssertionError("main-path interval: two runs differ")
    live = int((~args[1]).sum())
    ms = cuda_ms(lambda: edge_substep_cuda(*args, **kw), 20)
    plain_ms = cuda_ms(lambda: edge_substep_ref(*args, **kw), 3)
    # FP64 work this interval needs: ~8 operations per live fragment per
    # substep (census add, rate, burn-down, compare)
    rec = _record("edge_substep",
                  "src/repro_torch/kernels/csrc/edge_substep.cu",
                  "src/repro/kernels/edge_substep.py:192", err, ms,
                  plain_ms, _nbytes(list(args) + list(k1)),
                  8.0 * live * kw["substeps"])
    log(f"edge_substep at a main-path interval: G={G} K={K} F={F} n={n} "
        f"substeps={kw['substeps']}, {live} live fragments: matches the "
        f"twin (max abs err {err:.3e}), bitwise repeatable; {ms:.4f} "
        f"ms/call (twin {plain_ms:.4f} ms/call), bound {rec['bound_ms']:.5f}"
        f" ms ({rec['bound_by']})")
    records.append(rec)
    return records


def _counters():
    from repro_torch.kernels import placement
    from repro_torch.kernels.edge_substep import edge_substep
    return {"edge_substep": edge_substep,
            "bestfit_scan": placement.bestfit_scan,
            "repair_scan": placement.repair_scan}


def main_path(policy, **kw):
    """One main-path grid through run_grid_batched with every kernel's
    launch count set to 0 just before and read just after; returns
    (records, wall s, launches per kernel, phase seconds)."""
    import torch
    from repro_torch.launch.experiments import run_grid_batched
    phase_s = {}
    torch.cuda.synchronize()
    for fn in _counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    recs = run_grid_batched(policy, **MAIN, device="cuda", phase_s=phase_s,
                            **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in _counters().items()}
    for name, count in launches.items():
        if count != MAIN["n_intervals"]:
            raise AssertionError(f"{policy}: {name} launched {count} times, "
                                 f"expected once per interval "
                                 f"({MAIN['n_intervals']})")
    for r in recs:
        if r["dropped_tasks"] != 0:
            raise AssertionError(f"{policy}: dropped tasks in {r}")
        if not r["tasks_completed"] > 0:
            raise AssertionError(f"{policy}: no task completed in {r}")
        if not 0.0 <= r["reward"] <= 1.0:
            raise AssertionError(f"{policy}: reward out of [0, 1] in {r}")
    tasks = sum(r["tasks_completed"] for r in recs)
    log(f"main path {policy}: G={len(recs)} T={MAIN['n_intervals']} "
        f"substeps={MAIN['substeps']}: wall {wall:.3f} s, "
        f"{len(recs) / wall:.3f} traces/s, {tasks / wall:.1f} tasks/s "
        f"({int(tasks)} tasks); launches {launches}; phases "
        + ", ".join(f"{k} {v:.3f} s" for k, v in phase_s.items())
        + f", host trace compile + upload + summaries "
        f"{wall - sum(phase_s.values()):.3f} s"
        + f"; mean reward {np.mean([r['reward'] for r in recs]):.4f}")
    return recs, wall, launches, phase_s


def cross_checks():
    from repro_torch.env.torchsim import (compile_trace, compile_trace_dual,
                                          make_static_decider,
                                          run_grid_arrays_learned,
                                          run_trace_arrays)
    with open(GOLDEN) as f:
        golden = json.load(f)["summary"]
    tr = compile_trace(make_static_decider("bestfit-rr"), lam=5.0, seed=0,
                       n_intervals=8, substeps=4)
    got = run_trace_arrays(tr, device="cuda")
    for k, v in golden.items():
        if not np.isclose(got[k], v, rtol=GOLDEN_RTOL, atol=GOLDEN_ATOL):
            raise AssertionError(f"golden {k}: fixture {v!r} vs cuda "
                                 f"{got[k]!r}")
    log("cross-check: the cuda driver reproduces "
        "golden_static_bestfit_rr.json at rtol=1e-6")
    traces = [compile_trace_dual(lam=5.0, seed=s, n_intervals=8, substeps=4)
              for s in range(3)]
    on_gpu = run_grid_arrays_learned(traces, MAB_LITERAL, device="cuda")
    on_cpu = run_grid_arrays_learned(traces, MAB_LITERAL, device="cpu")
    for g, c in zip(on_gpu, on_cpu):
        for k in c:
            if not np.isclose(g[k], c[k], rtol=1e-9, atol=1e-12):
                raise AssertionError(f"mab grid {k}: cuda {g[k]!r} vs cpu "
                                     f"{c[k]!r}")
    log("cross-check: a G=3 'mab' grid on cuda matches the cpu path at "
        "rtol=1e-9")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core.mab import mab_state_from_numpy
    from repro_torch.kernels.build import LIBRARIES

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")

    t0 = time.perf_counter()
    build_logs = LIBRARIES.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s")
    for name, text in build_logs.items():
        for line in text.strip().splitlines():
            log(f"  [{name}] {line}")

    records = kernel_phase()

    _, _, launches, _ = main_path("bestfit-rr")
    for rec in records:
        rec["launches"] = launches[rec["name"]]
    mab_state = mab_state_from_numpy(MAB_LITERAL, device="cuda")
    main_path("mab", mab_state=mab_state)

    cross_checks()

    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    if leaked:
        raise AssertionError(f"JAX or the JAX package was imported: {leaked}")

    log(f"card: {card}")
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
