"""The CUDA kernels against their eager twins, and the serving path, on
the card.

Runs only where a CUDA device is present (``-m gpu``); skips elsewhere.
The file imports no JAX, so it also runs on a machine that has PyTorch
and the CUDA toolkit only:

    PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_ref import chip_smoke, repair_fuzz, route_plan, substep_fuzz
from repro_torch.kernels.edge_substep import OUT_NAMES, edge_substep
from repro_torch.kernels.ref import (CARRY_NAMES, SHARED_NAMES, STATIC_NAMES,
                                     edge_substep_ref)

KW = dict(substeps=7, dt=1.5, swap_slowdown=0.5, nic_cap=50.0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(seed, k=12, f=4, n=6, grid=None):
    """The reference's substep fuzz, optionally with a grid axis of
    ``grid`` independent cells sharing cell 0's cluster rows."""
    rng = np.random.RandomState(seed)
    cells = [substep_fuzz(rng, k, f, n) for _ in range(grid or 1)]
    names = CARRY_NAMES + STATIC_NAMES
    if grid is None:
        return [cells[0][name] for name in names]
    return [cells[0][name] if name in SHARED_NAMES else
            np.stack([c[name] for c in cells]) for name in names]


def _check(got, want):
    for name, g, w in zip(OUT_NAMES, got, want):
        g, w = g.cpu(), w.cpu()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if g.dtype.is_floating_point:
            torch.testing.assert_close(g, w, rtol=1e-12, atol=0.0,
                                       msg=name)
        else:
            assert torch.equal(g, w), name


@pytest.mark.gpu
@pytest.mark.parametrize("seed", range(8))
def test_kernel_matches_twin(cuda, seed):
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
            for a in _inputs(seed)]
    before = edge_substep.launches
    got = edge_substep(*args, **KW)
    again = edge_substep(*args, **KW)
    torch.cuda.synchronize()
    assert edge_substep.launches == before + 2
    _check(got, edge_substep_ref(*args, **KW))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
def test_kernel_grid_matches_twin(cuda):
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
            for a in _inputs(99, k=300, f=8, n=50, grid=5)]
    _check(edge_substep(*args, **KW), edge_substep_ref(*args, **KW))


@pytest.mark.gpu
def test_placement_kernels_match_twins(cuda):
    """Both placement scans against their twins at every interval of a
    small grid on a tenth-RAM fleet (the repair walks live slots there)."""
    from repro_torch.env.cluster import make_cluster
    from repro_torch.env.torchsim import driver, engines, kernels
    from repro_torch.env.torchsim.arrays import (ClusterArrays,
                                                 compile_trace,
                                                 default_capacity,
                                                 stack_traces, to_device)
    from repro_torch.env.torchsim.policies import make_static_decider
    from repro_torch.kernels import placement
    cluster = make_cluster(ram_scale=0.1)
    traces = [compile_trace(make_static_decider("bestfit-rr"), lam=8.0,
                            seed=s, n_intervals=6, substeps=4,
                            cluster=cluster) for s in range(3)]
    trace = to_device(stack_traces(traces), cuda)
    cl = to_device(ClusterArrays.from_cluster(cluster).as_dict(), cuda)
    G, F, n = len(traces), trace["instr"].shape[-1], cl["ram"].shape[0]
    state = kernels.init_state(G, default_capacity(traces), F, n, cuda)
    acc = driver._init_acc(G, n, cuda)
    walked = 0
    for t in range(6):
        arr, _ = engines.StaticEngine().decide({}, trace, t)
        state = kernels.admit(state, arr)
        ops = kernels.bestfit_operands(state, cl)
        req = placement.bestfit_scan(*ops)
        assert torch.equal(req, placement.bestfit_scan_ref(*ops)), t
        ops = kernels.repair_operands(state, cl, req)
        got = placement.repair_scan(*ops)
        want = placement.repair_scan_ref(*ops)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), t
        walked += int(ops[1].sum())
        state = kernels.apply_requests(state, cl, req)
        state, acc, _ = driver._interval_physics(
            state, acc, trace["bw_mult"][:, t], cl, 4, 75.0, 300.0, 0.5)
        state["alive"] = state["alive"] & ~state["task_done"]
    assert walked > 0


def _substep_case(cuda, seed, substeps, **shape):
    """The kernel and the twin on one fuzzed grid: float64 at rtol=1e-12,
    bools and ints exact, and two launches bitwise identical."""
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
            for a in _inputs(seed, **shape)]
    kw = dict(KW, substeps=substeps)
    got = edge_substep(*args, **kw)
    again = edge_substep(*args, **kw)
    torch.cuda.synchronize()
    _check(got, edge_substep_ref(*args, **kw))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    return args


#: edge_substep shapes beside the fuzz: (k, f, n, grid, substeps); K not a
#: multiple of the cluster, K below it, more clusters than one wave of the
#: card, one and 128 workers, no substep
SUBSTEP_SHAPES = [(301, 8, 50, 3, 7), (5, 4, 6, 2, 7), (40, 8, 50, 33, 5),
                  (60, 4, 1, 2, 7), (300, 8, 128, 2, 7), (64, 8, 50, 2, 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SUBSTEP_SHAPES)
def test_substep_shapes_match_twin(cuda, shape):
    from repro_torch.kernels.edge_substep import edge_substep_plan
    k, f, n, grid, substeps = shape
    plan = edge_substep_plan(grid, k, f)
    assert plan["on_chip"] and plan["max_active_clusters"] > 0
    _substep_case(cuda, 7, substeps, k=k, f=f, n=n, grid=grid)


@pytest.mark.gpu
def test_substep_past_shared_memory_matches_twin(cuda):
    """G=1, K=20000: one CTA's share of the tasks does not fit shared
    memory, so the carries stay in global memory; same kernel, same
    results."""
    from repro_torch.kernels.edge_substep import edge_substep_plan
    plan = edge_substep_plan(1, 20000, 8)
    assert not plan["on_chip"] and plan["cluster"] >= 1
    _substep_case(cuda, 11, 5, k=20000, f=8, n=50, grid=1)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", range(4))
def test_substep_out_of_range_stage_matches_twin(cuda, seed):
    """stage == F on placed, unfinished chains with undone columns (the
    fill semantics of ``tests/test_torch_edge_substep.py``), on a grid."""
    names = CARRY_NAMES + STATIC_NAMES
    args = [np.array(a) for a in _inputs(40 + seed, k=48, f=4, n=6, grid=3)]
    named = dict(zip(names, args))
    rows = np.arange(0, 48, 3)
    named["chain"][:, rows] = True
    named["placed"][:, rows] = True
    named["task_done"][:, rows] = False
    named["stage"][:, rows] = 4
    named["done"][:, rows, 0] = False
    named["worker"][:, rows, 0] = 1
    named["instr"][:, rows, 0] = 5.0
    named["transfer"][:, rows, :] = 3.0
    args = [torch.from_numpy(np.ascontiguousarray(named[k])).to(cuda)
            for k in names]
    got = edge_substep(*args, **KW)
    again = edge_substep(*args, **KW)
    _check(got, edge_substep_ref(*args, **KW))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _repair_case(cuda, ops):
    """The repair kernel against its twin: exactly equal, and two launches
    identical; returns the kernel's (worker, placed)."""
    from repro_torch.kernels import placement
    ops = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in ops]
    got = placement.repair_scan(*ops)
    again = placement.repair_scan(*ops)
    want = placement.repair_scan_ref(*ops)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    return got


@pytest.mark.gpu
def test_repair_mixes_trip_zero_and_long_walks(cuda):
    trip = [0, 900, 0, 1000, 5, 0]
    _repair_case(cuda, repair_fuzz(np.random.RandomState(0), 6, 1000, 8, 50,
                                   trip=trip, cap_lo=40.0, cap_hi=120.0))


@pytest.mark.gpu
def test_repair_every_fragment_infeasible(cuda):
    ops = repair_fuzz(np.random.RandomState(1), 2, 300, 8, 50, trip=[300,
                      300], cap_lo=0.01, cap_hi=0.05)
    worker, placed = _repair_case(cuda, ops)
    walked = ops[2] & (~ops[3]).any(axis=2)      # alive, some fragment acts
    holds = (~ops[4])[..., None] | (np.arange(8) == ops[5][..., None])
    fails = walked & ((~ops[3]) & holds).any(axis=2)
    assert fails.any() and not placed.cpu().numpy()[fails].any()


@pytest.mark.gpu
def test_repair_fails_mid_row_and_keeps_ram(cuda):
    """Slot 0's third fragment fits nowhere: the task fails (workers -1),
    but the RAM its first two fragments took stays taken, so slot 1, which
    would fit an empty worker, fails too."""
    order = np.array([[0, 1]], dtype=np.int64)
    trip = np.array([2], dtype=np.int64)
    alive = np.ones((1, 2), dtype=bool)
    done = np.array([[[False, False, False], [False, True, True]]])
    chain = np.zeros((1, 2), dtype=bool)
    stage = np.zeros((1, 2), dtype=np.int32)
    req = np.zeros((1, 2, 3), dtype=np.int32)
    ram = np.array([[[6.0, 6.0, 20.0], [4.5, 1.0, 1.0]]])
    cap = np.array([10.0, 10.0])
    worker2 = req.copy()
    placed = np.zeros((1, 2), dtype=bool)
    worker, placed = _repair_case(cuda, (order, trip, alive, done, chain,
                                         stage, req, ram, cap, worker2,
                                         placed))
    assert worker.cpu().tolist() == [[[-1, -1, -1], [-1, -1, -1]]]
    assert placed.cpu().tolist() == [[False, False]]


@pytest.mark.gpu
@pytest.mark.parametrize("delta", (-1, 0, 1))
def test_repair_chunk_boundary_trips(cuda, delta):
    from repro_torch.kernels import placement
    chunk = placement.repair_scan_plan(8)["chunk"]
    trips = [2 * chunk + delta, chunk + delta, 3 * chunk + delta]
    _repair_case(cuda, repair_fuzz(np.random.RandomState(2 + delta), 3,
                                   4 * chunk, 8, 50, trip=trips,
                                   cap_lo=30.0, cap_hi=80.0))


def _bestfit_case(cuda, ops):
    """The BestFit kernel equals its twin exactly and repeats bitwise."""
    from repro_torch.kernels import placement
    ops = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in ops]
    got = placement.bestfit_scan(*ops)
    again = placement.bestfit_scan(*ops)
    assert torch.equal(got, placement.bestfit_scan_ref(*ops))
    assert torch.equal(got, again)
    return got


BESTFIT_CASES = chip_smoke().bestfit_cases()


@pytest.mark.gpu
@pytest.mark.parametrize("n", (1, 31, 32, 33, 50, 128))
@pytest.mark.parametrize("ties", (False, True))
def test_bestfit_worker_counts_match_twin(cuda, n, ties):
    """One to four registers of workers per lane, with and without ties
    and unplaceable fragments."""
    _bestfit_case(cuda, BESTFIT_CASES[f"n={n} ties={ties}"])


@pytest.mark.gpu
def test_bestfit_signed_zeros_and_no_fit(cuda):
    """-0.0 before +0.0 takes the first; a step no worker fits takes 0."""
    ops = BESTFIT_CASES["-0.0 before +0.0"]
    got = _bestfit_case(cuda, ops)
    assert int(got.view(-1)[int(ops[0][0, 0])]) == 3
    ops = BESTFIT_CASES["no worker fits"]
    got = _bestfit_case(cuda, ops).view(2, -1).cpu()
    assert (got[0, ops[0][0, :18]] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("trips", (0, 31, 32, 33, 63, 64, 65))
def test_bestfit_staging_chunk_boundaries(cuda, trips):
    _bestfit_case(cuda, BESTFIT_CASES[f"trips {trips}"])


FLASH_CASES = [  # (b, sq, sk, h, kvh, hd, causal, window)
    (2, 64, 64, 4, 2, 32, True, 0),
    (1, 128, 128, 8, 8, 64, True, 0),
    (2, 96, 96, 4, 1, 32, True, 0),
    (1, 33, 77, 2, 2, 16, True, 0),
    (2, 80, 80, 4, 2, 32, True, 8),
    (2, 80, 80, 4, 2, 32, True, 32),
    (1, 40, 56, 2, 2, 64, False, 0),
    (1, 24, 8, 2, 1, 16, True, 4),          # late rows see no key
    (1, 300, 300, 12, 4, 128, True, 0),
    (1, 257, 257, 32, 4, 64, True, 0),      # TinyLlama's heads, ragged
    (1, 257, 257, 16, 2, 64, True, 0),      # one of its two branches
    (1, 257, 257, 16, 1, 256, True, 2048),  # recurrentgemma's heads, ragged
    (2, 80, 80, 4, 2, 256, True, 8),        # hd=256 with a window that bites
    (1, 33, 77, 2, 2, 256, False, 0),       # hd=256, non-causal, ragged
    # tile edges of the bfloat16 tensor-core kernel (tiles of 64 or 128
    # (position, head) rows, of 64 or 128 keys)
    (1, 200, 200, 16, 16, 128, True, 0),    # hd=128 16/16, ragged s
    (2, 70, 70, 8, 1, 16, True, 0),         # hd=16, one k-step, g=8
    (1, 130, 130, 4, 4, 32, True, 0),       # hd=32, two k-steps, ragged
    (1, 90, 40, 8, 1, 256, False, 0),       # hd=256, sq > sk, non-causal
    (1, 200, 200, 8, 2, 64, True, 5),       # a window inside one key tile
    (1, 20, 20, 128, 1, 64, True, 0),       # g=128: a position spans 2 tiles
    # kimi-k2's hd=112 (mma.sync, 7 k-steps) at its 64/8 heads and
    # nemotron-4's hd=192 (wgmma, three 64-column swizzle blocks) at one
    # semantic branch's 48/4
    (1, 257, 257, 64, 8, 112, True, 0),
    (1, 200, 200, 48, 4, 192, True, 0),
    (1, 90, 40, 8, 1, 112, False, 0),       # sq > sk, non-causal
    (2, 80, 80, 12, 2, 192, True, 8),       # a window that bites
    (1, 33, 77, 4, 4, 112, True, 0),        # ragged, g=1
    (1, 130, 130, 12, 1, 192, True, 0),     # g=12 over one kv head
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_twin(cuda, case, dtype):
    """atol 2e-5 in float32, 2e-2 in bfloat16 (tests/test_kernels.py)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_ref
    b, sq, sk, h, kvh, hd, causal, window = case
    rng = np.random.RandomState(sq + hd)
    q, k, v = [torch.from_numpy(rng.randn(*shape).astype(np.float32))
               .to(cuda, dtype) for shape in ((b, sq, h, hd),
                                               (b, sk, kvh, hd),
                                               (b, sk, kvh, hd))]
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    again = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2
    assert got.dtype == dtype and got.shape == q.shape
    want = attention_ref(q, k, v, causal=causal, window=window)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=0.0, atol=tol)
    assert torch.equal(got, again)


@pytest.mark.gpu
def test_serving_path_reduced(cuda):
    """The serving slice at the reference's CPU size (float32): the card's
    logits match the CPU's (rtol 1e-4 / atol 1e-5; float32 products on
    both, TF32 off), and the engine serves through the flash kernel with
    layer-plan fidelity 1.0."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import serve_requests
    from repro_torch.models.model import forward, init_params
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = get_config("tinyllama-1.1b").reduced(max_d_model=256, max_layers=4)
    params = init_params(cfg, torch.Generator().manual_seed(0), device=cuda)
    cpu_params = init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    tok = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (2, 64)).astype(np.int32))
    got = forward(params, {"tokens": tok.to(cuda)}, cfg)
    want = forward(cpu_params, {"tokens": tok}, cfg)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)
    flash_attention.launches = 0
    out = serve_requests(params, cfg, requests=6, batch=2, seq=64,
                         device=cuda, log=lambda *a: None)
    assert flash_attention.launches > 0
    for r in out["results"]:
        assert np.isfinite(r.latency_s) and 0.0 <= r.fidelity <= 1.0
        if r.plan == 0:
            assert r.fidelity == 1.0


MOE_ROUTE_CASES = [  # (G, gs, E, k)
    (1, 64, 8, 2), (1, 100, 16, 4), (1, 33, 4, 1),   # tests/test_kernels.py
    (1, 4096, 60, 4),                                # qwen2-moe's serving
    (8, 512, 60, 4),                                 # several groups
    (2, 150, 60, 4),                 # tokens not a multiple of the tile
    (3, 77, 1024, 7),                                # the widest E
    (128, 512, 60, 4),       # more tiles than one wave: taken by ticket
    (1, 20000, 4, 2),        # a look-back longer than a CTA's threads
    (1, 4, 60, 4),           # a decode step: 4 tokens, a partial tile
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", MOE_ROUTE_CASES)
def test_moe_route_matches_twin(cuda, case):
    """Expert ids and slots exactly, gates within atol 1e-5; logits on a
    2^-10 grid, so exact ties break by index on both sides and every other
    gap is far above an ulp."""
    from repro_torch.kernels.moe_route import moe_route
    from repro_torch.kernels.ref import moe_route_ref
    G, gs, E, k = case
    rng = np.random.RandomState(gs + E)
    logits = torch.from_numpy(np.round(rng.randn(G, gs, E) * 1024) / 1024) \
        .float().to(cuda)
    before = moe_route.launches
    got = moe_route(logits, k)
    again = moe_route(logits, k)
    torch.cuda.synchronize()
    assert moe_route.launches == before + 2
    eid, gate, slot = moe_route_ref(logits, k)
    assert torch.equal(got[0], eid) and torch.equal(got[2], slot)
    torch.testing.assert_close(got[1], gate, rtol=0.0, atol=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("case", MOE_ROUTE_CASES)
def test_moe_route_plan_matches_emulation(cuda, case):
    """The launch shape the CPU emulation of test_torch_moe_route.py
    assumes is the library's."""
    from repro_torch.kernels.moe_route import moe_route_plan
    _, gs, E, k = case
    plan = moe_route_plan(gs, E, k)
    L, tt, threads, rank_warps, _ = route_plan(gs, E, k)
    assert (plan["lanes_per_token"], plan["tokens_per_cta"],
            plan["threads"], plan["rank_warps"]) == (L, tt, threads,
                                                      rank_warps)


@pytest.mark.gpu
def test_moe_route_underflow(cuda):
    from repro_torch.kernels.moe_route import moe_route
    logits = torch.tensor([[0.0, -200.0, -200.0, -200.0]], device=cuda)
    eid, gate, slot = moe_route(logits, 2)
    assert eid.tolist() == [[0, 1]] and slot.tolist() == [[0, 0]]
    assert gate.tolist() == [[1.0, 0.0]]


SCAN_CASES = [  # (b, s, d_in, n)
    (2, 37, 16, 4), (1, 128, 64, 16), (3, 15, 8, 2),  # tests/test_kernels.py
    (2, 200, 300, 16),                                # ragged d_in and s
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", SCAN_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_matches_twin(cuda, case, dtype):
    """rtol/atol 1e-5 (the twin's einsum sums the n products in its own
    order); two runs bitwise equal."""
    from repro_torch.kernels.ref import selective_scan_ref
    from repro_torch.kernels.selective_scan import selective_scan
    b, s, d, n = case
    rng = np.random.RandomState(s + d)
    dA = torch.from_numpy(rng.uniform(0.5, 1.0, (b, s, d, n))).to(cuda, dtype)
    dBx = torch.from_numpy(rng.randn(b, s, d, n) * 0.1).to(cuda, dtype)
    C = torch.from_numpy(rng.randn(b, s, n)).to(cuda, dtype)
    before = selective_scan.launches
    got = selective_scan(dA, dBx, C)
    again = selective_scan(dA, dBx, C)
    torch.cuda.synchronize()
    assert selective_scan.launches == before + 2
    assert got.dtype == torch.float32 and got.shape == (b, s, d)
    torch.testing.assert_close(got, selective_scan_ref(dA, dBx, C),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "falcon-mamba-7b"])
def test_moe_and_mamba_reduced(cuda, arch):
    """The reduced model (float32) on the card matches the CPU, through
    its kernels."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.moe_route import moe_route
    from repro_torch.kernels.selective_scan import selective_scan
    from repro_torch.models.model import forward, init_params
    cfg = get_config(arch).reduced(max_d_model=256, max_layers=4)
    tok = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (2, 64)).astype(np.int32))
    kernel = moe_route if cfg.moe else selective_scan
    before = kernel.launches
    got = forward(init_params(cfg, torch.Generator().manual_seed(0),
                              device=cuda), {"tokens": tok.to(cuda)}, cfg)
    assert kernel.launches == before + cfg.num_layers
    want = forward(init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu"), {"tokens": tok}, cfg)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)


RGLRU_CASES = [  # (b, s, w)
    (2, 37, 24), (1, 64, 128),                        # tests/test_kernels.py
    (3, 100, 300),                                    # ragged s and w
    (4, 1024, 4096),                                  # recurrentgemma, served
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", RGLRU_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_scan_matches_twin(cuda, case, dtype):
    """atol 1e-5 in float32, 3e-2 with bfloat16 inputs
    (tests/test_kernels.py); the kernel rounds each step as the twin, a
    product then a sum, so it equals it bitwise; two runs bitwise equal."""
    from repro_torch.kernels.ref import rglru_scan_ref
    from repro_torch.kernels.rglru_scan import rglru_scan
    rng = np.random.RandomState(sum(case))
    a = torch.from_numpy(rng.uniform(0.8, 1.0, case)).to(cuda, dtype)
    bx = torch.from_numpy(rng.randn(*case) * 0.1).to(cuda, dtype)
    before = rglru_scan.launches
    got = rglru_scan(a, bx)
    again = rglru_scan(a, bx)
    torch.cuda.synchronize()
    assert rglru_scan.launches == before + 2
    assert got.dtype == torch.float32 and got.shape == case
    want = rglru_scan_ref(a, bx)
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got, want, rtol=0.0, atol=tol)
    assert torch.equal(got, want)
    assert torch.equal(got, again)


@pytest.mark.gpu
def test_recurrentgemma_reduced(cuda):
    """The reduced recurrentgemma-9b (float32, window 8 at 64 tokens) and
    both plans on the card match the CPU, through the RG-LRU scan and the
    flash kernel: one launch per rglru and local_attn layer and forward."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.models.model import forward, init_params
    from repro_torch.serving.plans import branch_forward, pipeline_forward
    cfg = get_config("recurrentgemma-9b").reduced(max_d_model=256,
                                                  max_layers=4)
    tok = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (2, 64)).astype(np.int32))
    params = init_params(cfg, torch.Generator().manual_seed(0), device=cuda)
    cpu_params = init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    kinds = cfg.layer_kinds
    scans, flashes = rglru_scan.launches, flash_attention.launches
    got = forward(params, {"tokens": tok.to(cuda)}, cfg)
    assert rglru_scan.launches == scans + kinds.count("rglru")
    assert flash_attention.launches == flashes + kinds.count("local_attn")
    want = forward(cpu_params, {"tokens": tok}, cfg)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)
    assert torch.equal(pipeline_forward(params, {"tokens": tok.to(cuda)},
                                        cfg, 2), got)
    torch.testing.assert_close(
        branch_forward(params, {"tokens": tok.to(cuda)}, cfg, 2).cpu(),
        branch_forward(cpu_params, {"tokens": tok}, cfg, 2),
        rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_daso_ascent_matches_cpu(cuda):
    """The grid-batched float64 ascent at SurrogatePlacer's widths (C=64,
    hidden 128, depth 3, 50 steps) on the card equals the CPU's: steps
    and argmax exactly, logits at rtol 1e-9; at lr_place 5 rows move."""
    from repro_torch.core.daso import (DASOConfig, init_surrogate,
                                       optimize_placement_grid,
                                       warm_start_logits)
    cfg = DASOConfig(num_workers=50, max_containers=64, state_features=4,
                     lr_place=5.0)
    theta = init_surrogate(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    rng = np.random.RandomState(0)
    G = 4
    feat = torch.from_numpy(rng.rand(G, 50, 4))
    valid = torch.arange(64) < torch.tensor([64, 40, 3, 0])[:, None]
    warm = torch.from_numpy(rng.randint(0, 50, (G, 64)))
    dec = torch.from_numpy(rng.randint(0, 2, (G, 64)).astype(np.int32))
    args = (feat, warm_start_logits(cfg, warm, valid), dec, valid)
    p, _, steps = optimize_placement_grid(cfg, theta, *args)
    gp, _, gsteps = optimize_placement_grid(
        cfg, [{k: v.to(cuda) for k, v in layer.items()} for layer in theta],
        *[a.to(cuda) for a in args])
    assert torch.equal(gsteps.cpu(), steps)
    assert torch.equal(gp.argmax(-1).cpu(), p.argmax(-1))
    torch.testing.assert_close(gp.cpu(), p, rtol=1e-9, atol=1e-12)
    assert ((p.argmax(-1) != warm) & valid).any()


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["splitplace", "mab+gobi", "layer+gobi",
                                    "semantic+gobi"])
def test_daso_policies_match_cpu(cuda, policy):
    """The four DASO policies on a small grid at lr_place 20 (the ascent
    moves rows there): the card's records equal the CPU's at rtol 1e-9."""
    from repro_torch.core.daso import DASOConfig, init_surrogate
    from repro_torch.launch.experiments import run_grid_batched
    cfg = DASOConfig(num_workers=50, max_containers=16, state_features=4,
                     hidden=32, depth=2, place_iters=12, lr_place=20.0)
    theta = init_surrogate(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    kw = dict(seeds=(0, 1), lams=(5.0, 24.0), n_intervals=6, substeps=4,
              mab_state=chip_smoke().MAB_LITERAL, daso_theta=theta,
              daso_cfg=cfg)
    on_gpu = run_grid_batched(policy, device="cuda", **kw)
    on_cpu = run_grid_batched(policy, device="cpu", **kw)
    for g, c in zip(on_gpu, on_cpu):
        assert set(g) == set(c)
        for k, v in c.items():
            if k != "policy":
                assert np.isclose(g[k], v, rtol=1e-9, atol=1e-12), k


#: chip_smoke's threefry_rows fuzz: every site, keys near 2**32, t up to
#: 10**4, p in {0, 1, a float32 ε, a float64 ε}
THREEFRY_CASES = chip_smoke().threefry_cases()


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(THREEFRY_CASES))
def test_threefry_rows_matches_twin(cuda, name):
    from repro_torch.kernels.ref import threefry_rows_ref
    from repro_torch.kernels.threefry import threefry_rows
    key, t, A, p, width = THREEFRY_CASES[name]
    key = torch.from_numpy(key).to(cuda)
    p = None if p is None else torch.from_numpy(p).to(cuda)
    before = threefry_rows.launches
    got = threefry_rows(key, t, A, p, width)
    assert threefry_rows.launches == before + 1
    want = threefry_rows_ref(key.cpu(), t, A, None if p is None else p.cpu(),
                             width)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.dtype == torch.bool and torch.equal(g.cpu(), w)


@pytest.mark.gpu
@pytest.mark.parametrize("label", ["mab train", "splitplace train",
                                   "mab+gobi train", "gillis",
                                   "random+daso"])
def test_train_paths_match_cpu(cuda, label):
    """This slice's policies on chip_smoke's G=4 cross-check grid (gates
    lowered, lr_place 20): the card equals the CPU path (decisions
    exactly, summaries at rtol 1e-9, finetuned θ at rtol 1e-5, near-tie
    placement flips reported)."""
    chip_smoke().train_cross_check(labels=(label,))


@pytest.mark.gpu
def test_table4_routing(cuda):
    """The Table-4 policies at a small size: with the products of a short
    ``pretrain`` on the card, ``run_grid(backend="torch")`` launches each
    simulator kernel once per interval in every policy and
    ``threefry_rows`` in ``gillis`` and ``random+daso`` only; the host
    backend launches none of them."""
    from repro_torch.launch import experiments as ex
    cs = chip_smoke()
    counters = cs._counters()
    pols = list(cs.TABLE4_POLICIES)
    pre = ex.pretrain(3, substeps=2, device="cuda", policies=pols)
    products = dict(mab_state=pre.mab_state, daso_theta=pre.daso_theta,
                    daso_cfg=pre.daso_cfg, daso_opt_state=pre.daso_opt_state)
    T = 4
    for pol in pols:
        before = {n: fn.launches for n, fn in counters.items()}
        recs = ex.run_grid([pol], seeds=(0, 1), n_intervals=T, substeps=2,
                           backend="torch", device="cuda", **products)
        got = {n: fn.launches - before[n] for n, fn in counters.items()}
        for name in cs.SIM_KERNELS + cs.DRAW_KERNELS:
            want = T if name in cs.SIM_KERNELS or pol in cs.TABLE4_DRAWS \
                else 0
            assert got[name] == want, (pol, name)
        assert [r["seed"] for r in recs] == [0, 1]
        assert all(r["dropped_tasks"] == 0 and 0 <= r["reward"] <= 1
                   for r in recs)
    before = {n: fn.launches for n, fn in counters.items()}
    recs = ex.run_grid(pols, n_intervals=3, substeps=2, device="cuda",
                       mab_state=pre.mab_state,
                       gillis_policy=pre.gillis_policy)
    assert {n: fn.launches for n, fn in counters.items()} == before
    assert [r["policy"] for r in recs] == pols


@pytest.mark.gpu
def test_pretrain_matches_cpu(cuda):
    """chip_smoke's Table-4 cross-check: ``pretrain(36)`` from one θ0 on
    the card and on the CPU (N, t, ε, ρ equal; Q, R, θ and the AdamW
    moments within their tolerances; a differing decision or placement
    reported with its margin), then each Table-4 policy's
    ``run_grid(backend="torch")`` on both devices with the card's
    products, summaries at rtol 1e-9."""
    chip_smoke().table4_cross()


#: telemetry families on the card: (policy, run_grid_batched keywords)
TELEMETRY_GRID = dict(seeds=(0, 1), lams=(5.0, 24.0), n_intervals=8,
                      substeps=4)
TELEMETRY_POLICIES = ("bestfit-rr", "mab", "splitplace", "splitplace train",
                      "gillis", "random+daso")


def _telemetry_outs(policy, device):
    """The full per-cell summaries of ``policy``'s small grid with
    ``telemetry="interval"`` on ``device`` (chip_smoke's ``SeriesTap``)."""
    from repro_torch.core.daso import DASOConfig, init_surrogate
    from repro_torch.launch.experiments import run_grid_batched
    cs = chip_smoke()
    cfg = DASOConfig(**cs.DASO_SMALL)
    theta = init_surrogate(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    kw = dict(mab_state=cs.MAB_LITERAL)
    if policy in ("splitplace", "splitplace train", "random+daso"):
        kw.update(daso_theta=theta, daso_cfg=cfg)
    if policy.endswith(" train"):
        kw.update(mode="train", train_hp=cs.TRAIN_HP_LOW)
    with cs.SeriesTap() as tap:
        run_grid_batched(policy.split()[0], device=device,
                         telemetry="interval", **TELEMETRY_GRID, **kw)
    return tap.outs


@pytest.mark.gpu
@pytest.mark.parametrize("policy", TELEMETRY_POLICIES)
def test_telemetry_series_matches_cpu(cuda, policy):
    """The interval program's series on the card equals the CPU's (rtol
    1e-9; the train path's window loss, a forward of the finetuned
    float32 θ, at 1e-5), and so do the percentile fields."""
    on_gpu, on_cpu = _telemetry_outs(policy, "cuda"), \
        _telemetry_outs(policy, "cpu")
    for g, c in zip(on_gpu, on_cpu):
        assert g["telemetry"]["cols"] == c["telemetry"]["cols"]
        for i, col in enumerate(c["telemetry"]["cols"]):
            rtol = 1e-5 if col == "daso_last_loss" else 1e-9
            np.testing.assert_allclose(g["telemetry"]["series"][:, i],
                                       c["telemetry"]["series"][:, i],
                                       rtol=rtol, atol=1e-12, err_msg=col)
        for k in ("p50_response_s", "p99_wait_s", "percentile_err_s"):
            assert np.isclose(g[k], c[k], rtol=1e-9, atol=1e-12), k


@pytest.mark.gpu
@pytest.mark.parametrize("case_seed", range(6))
def test_differential_cases_on_cuda(cuda, case_seed):
    """chip_smoke's differential contract with the interval program on the
    card against the host oracles (rtol 1e-4 / atol 1e-9)."""
    cs = chip_smoke()
    cs.diff_check_case(cs.diff_draw_case(case_seed), "cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", chip_smoke().DIFF_REGRESSIONS)
def test_differential_regressions_on_cuda(cuda, name):
    chip_smoke().diff_regression(name, "cuda")


#: the streaming serve loop at a small size on both devices
STREAM_SMALL = dict(target_tasks=200, chunk_intervals=8, max_active=128,
                    substeps=4)


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["mc", "gillis"])
def test_stream_matches_cpu(cuda, policy):
    """``run_stream`` on the card equals the CPU: the serving report's
    counters exactly, the summary and the rolling snapshot at rtol
    1e-9."""
    chip_smoke().stream_cross(policy, **STREAM_SMALL)


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["bestfit-rr", "splitplace", "gillis"])
def test_stream_replay_matches_one_shot_on_cuda(cuda, policy):
    """Chunked replay on the card (20 intervals in chunks of 6) equals the
    card's one-shot run to every digit, summary and series."""
    cs = chip_smoke()
    cs.stream_replay(policy, "cuda", mab_state=cs.MAB_LITERAL,
                     n_intervals=20, chunk=6, substeps=4)


#: flash attention with explicit positions: decode shapes (sq=1 over a
#: ring, g = 8, 1, 16; (b, W, h, kvh, hd, written slots)) and prefills
#: with offset or packed rows (chip_smoke.FLASH_POS_CASES)
FLASH_DECODE_CASES = [(4, 1056, 32, 4, 64, 1025), (4, 1056, 16, 16, 128, 1),
                      (4, 1056, 16, 1, 256, 1056), (2, 40, 8, 2, 16, 23),
                      (4, 1056, 64, 8, 112, 1025), (4, 1056, 96, 8, 192, 1),
                      (2, 70, 96, 8, 192, 70)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", FLASH_DECODE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_decode_positions_match_twin(cuda, case, dtype):
    """The decode ring's position trick (query at 1, written slots at 0,
    the others at 2**30) against the twin, at the reference's tolerance;
    two runs bitwise equal."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_ref
    b, W, h, kvh, hd, valid = case
    rng = np.random.RandomState(W + h + hd)
    q, k, v = (torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
        cuda, dtype) for shape in ((b, 1, h, hd), (b, W, kvh, hd),
                                   (b, W, kvh, hd)))
    pq, pk = chip_smoke().ring_positions(b, W, valid)
    before = flash_attention.launches
    got = flash_attention(q, k, v, pos_q=pq, pos_k=pk)
    again = flash_attention(q, k, v, pos_q=pq, pos_k=pk)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2
    atol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), attention_ref(
        q, k, v, pos_q=pq, pos_k=pk).float(), rtol=0, atol=atol)
    assert torch.equal(got, again)


#: flash at the shapes qwen2-vl-7b's and musicgen-medium's paths first
#: launched, at full width: (b, sq, sk, h, kvh, hd, causal, ring slots
#: written or None for implicit positions)
FLASH_FAMILY_CASES = {
    # (a) musicgen's cross attention: 64 keys, a partial key tile
    "cross": (4, 1024, 64, 24, 24, 64, False, None),
    # (b) the same at a decode step
    "cross_decode": (4, 1, 64, 24, 24, 64, False, None),
    # (c) qwen2-vl's prefill: g = 7, odd, rows position * 7 + head
    "g7_prefill": (4, 1024, 1024, 28, 4, 128, True, None),
    # (d) qwen2-vl's decode over 1025 of 1056 ring slots at g = 7
    "g7_decode": (4, 1, 1056, 28, 4, 128, True, 1025),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(FLASH_FAMILY_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_family_shapes_match_twin(cuda, name, dtype):
    """Shapes (a)–(d) against the twin at the reference's tolerance
    (atol 2e-5 in float32, 2e-2 in bfloat16), two runs bitwise equal."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_ref
    b, sq, sk, h, kvh, hd, causal, valid = FLASH_FAMILY_CASES[name]
    rng = np.random.RandomState(sq + sk + h)
    q, k, v = (torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
        cuda, dtype) for shape in ((b, sq, h, hd), (b, sk, kvh, hd),
                                   (b, sk, kvh, hd)))
    kw = dict(causal=causal)
    if valid is not None:
        kw["pos_q"], kw["pos_k"] = chip_smoke().ring_positions(b, sk, valid)
    got = flash_attention(q, k, v, **kw)
    again = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    atol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), attention_ref(q, k, v, **kw)
                               .float(), rtol=0, atol=atol)
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("case", chip_smoke().FLASH_POS_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_prefill_positions_match_twin(cuda, case, dtype):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_ref
    b, s, h, kvh, hd, window, kind = case
    rng = np.random.RandomState(s + hd)
    q, k, v = (torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
        cuda, dtype) for shape in ((b, s, h, hd), (b, s, kvh, hd),
                                   (b, s, kvh, hd)))
    pos = chip_smoke().prefill_positions(b, s, kind)
    got = flash_attention(q, k, v, window=window, pos_q=pos, pos_k=pos)
    atol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), attention_ref(
        q, k, v, window=window, pos_q=pos, pos_k=pos).float(), rtol=0,
        atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("case", SCAN_CASES + [(4, 1024, 8192, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_final_state_matches_twin(cuda, case, dtype):
    """``h_final`` (the state ``mamba_prefill`` caches) against the twin's
    at rtol/atol 1e-5, and y with it the bits of y without it."""
    from repro_torch.kernels.ref import selective_scan_ref
    from repro_torch.kernels.selective_scan import selective_scan
    b, s, d, n = case
    gen = torch.Generator(device=cuda).manual_seed(s + d)
    dA, dBx, C = chip_smoke()._scan_inputs(gen, b, s, d, n, dtype)
    y, h = selective_scan(dA, dBx, C, final_state=True)
    want_y, want_h = selective_scan_ref(dA, dBx, C, final_state=True)
    assert h.dtype == torch.float32 and h.shape == (b, d, n)
    torch.testing.assert_close(h, want_h, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(y, want_y, rtol=1e-5, atol=1e-5)
    assert torch.equal(y, selective_scan(dA, dBx, C))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-moe-a2.7b",
                                  "falcon-mamba-7b", "recurrentgemma-9b",
                                  "qwen2-vl-7b", "musicgen-medium"])
def test_decode_matches_cpu(cuda, arch):
    """The reduced model's prefill step and decode steps (the ring wraps;
    TinyLlama also over a zero 8-slot ring to position 16) on the card
    against the CPU, logits and every cache leaf at rtol 1e-4 / atol
    1e-5 (``chip_smoke.decode_cross``)."""
    cs = chip_smoke()
    card, host = cs.decode_cross(arch, cuda), cs.decode_cross(arch, "cpu")
    assert len(card) == len(host) > cs.DECODE_CROSS["steps"]
    for g, w in zip(card, host):
        for a, b in zip(g, w):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)



# ------------------------------------------------------------- training

#: flash backward shapes (b, sq, sk, h, kvh, hd, causal, window): GQA,
#: every head dim, a window, rows that see no key, non-causal; then the
#: bfloat16 kernels' tile edges: s a multiple of neither the row nor the
#: key tiles, g = 16 with kvh = 1, hd=256 with a window, row tiles that
#: straddle the window's edge, rows past sk + window - 1 across tiles
FLASH_BWD_CASES = [(2, 64, 64, 4, 2, 32, True, 0),
                   (1, 130, 130, 8, 1, 64, True, 0),
                   (1, 90, 90, 4, 4, 128, True, 17),
                   (1, 70, 70, 4, 1, 256, True, 0),
                   (2, 50, 50, 2, 2, 16, True, 5),
                   (1, 24, 8, 2, 1, 16, True, 4),
                   (1, 40, 56, 2, 2, 64, False, 0),
                   (1, 150, 150, 4, 2, 64, True, 0),
                   (1, 77, 77, 16, 1, 128, True, 0),
                   (1, 200, 200, 16, 1, 256, True, 70),
                   (2, 190, 190, 4, 2, 32, True, 45),
                   (1, 150, 60, 8, 2, 64, True, 30),
                   # kimi-k2's and nemotron-4's head dims: ragged tiles, a
                   # window, non-causal, rows that see no key
                   (1, 130, 130, 8, 1, 112, True, 0),
                   (1, 150, 150, 12, 1, 192, True, 17),
                   (1, 70, 90, 4, 2, 112, False, 0),
                   (1, 150, 60, 12, 2, 192, True, 30),
                   (2, 64, 64, 8, 8, 192, True, 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_BWD_CASES)
def test_flash_attention_backward_matches_twin(cuda, case, dtype):
    """The backward kernels against ``attention_bwd_ref`` and autograd of
    ``attention_ref`` (atol 1e-4 / 2e-2 of each output's scale), the
    forward with its logsumexp giving the serving forward's bits, two
    backward runs bitwise equal (``chip_smoke._flash_train_check``)."""
    cs = chip_smoke()
    b, sq, sk, h, kvh, hd, causal, window = case
    q, k, v = cs._flash_inputs(np.random.RandomState(sq + hd), b, sq, sk, h,
                               kvh, hd, dtype)
    cs._flash_train_check(q, k, v, causal, window, dtype, f"{case} {dtype}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("key", ["cross", "hd128_g7"])
def test_flash_attention_backward_family_shapes(cuda, key, dtype):
    """The backward at the two shapes only the multimodal families train
    (``chip_smoke.TRAIN_FLASH``): musicgen's cross attention (1024 queries
    over 64 keys, non-causal, 24/24 heads) and qwen2-vl's group of 7,
    float32 at the forward's atol 2e-5 of each output's scale."""
    cs = chip_smoke()
    b, sq, sk, h, kvh, hd, causal, window, _ = next(
        c for c in cs.TRAIN_FLASH if c[-1] == key)
    q, k, v = cs._flash_inputs(np.random.RandomState(hd), b, sq, sk, h, kvh,
                               hd, dtype)
    cs._flash_train_check(q, k, v, causal, window, dtype, f"{key} {dtype}",
                          atol=cs.FLASH_ATOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["offset", "packed"])
def test_flash_attention_backward_explicit_positions(cuda, kind):
    cs = chip_smoke()
    q, k, v = cs._flash_inputs(np.random.RandomState(9), 2, 77, 77, 8, 2,
                               64, "bfloat16")
    pos = cs.prefill_positions(2, 77, kind)
    cs._flash_train_check(q, k, v, True, 5, "bfloat16", kind, pos_q=pos,
                          pos_k=pos)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [(2, 37, 16, 4), (1, 128, 200, 16),
                                  (3, 15, 8, 2), (1, 1001, 96, 16),
                                  (1, 45, 40, 5), (1, 5, 33, 1)])
def test_selective_scan_backward_matches_twin(cuda, case, dtype):
    """The backward kernels against their twin (atol 1e-4 / 2e-2 of each
    output's scale), two runs bitwise equal: the reference's shapes, then
    b=1 with s a multiple of no checkpoint chunk, n < 16 (lanes idle in
    each channel's group), s shorter than one chunk."""
    from repro_torch.kernels.ref import selective_scan_bwd_ref
    from repro_torch.kernels.selective_scan import selective_scan_bwd_cuda
    cs = chip_smoke()
    gen = torch.Generator(device=cuda).manual_seed(sum(case))
    dA, dBx, C = cs._scan_inputs(gen, *case, dtype)
    gy = torch.randn(case[:3], generator=gen, device=cuda)
    got = selective_scan_bwd_cuda(dA, dBx, C, gy)
    want = selective_scan_bwd_ref(dA, dBx, C, gy)
    atol = cs.TRAIN_ATOL[str(dtype).split(".")[-1]]
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        cs._scaled_err(a, b, f"{case}", atol)
    assert all(torch.equal(a, b) for a, b in
               zip(got, selective_scan_bwd_cuda(dA, dBx, C, gy)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 37, 24), (1, 64, 128), (3, 9, 70),
                                   (4, 1024, 4096), (1, 1001, 96),
                                   (2, 5, 33)])
def test_rglru_scan_backward_matches_twin(cuda, shape, dtype):
    """Bitwise equal to the twin: the reference's shapes, recurrentgemma's
    (4, 1024, 4096), s that the kernel's register buffers do not divide,
    s shorter than one buffer; two runs bitwise equal."""
    from repro_torch.kernels.ref import rglru_scan_bwd_ref, rglru_scan_ref
    from repro_torch.kernels.rglru_scan import rglru_scan_bwd_cuda
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    a = (0.8 + 0.2 * torch.rand(shape, generator=gen, device=cuda)).to(dtype)
    bx = (0.1 * torch.randn(shape, generator=gen, device=cuda)).to(dtype)
    h = rglru_scan_ref(a, bx)
    gh = torch.randn(shape, generator=gen, device=cuda)
    got = rglru_scan_bwd_cuda(a, h, gh)
    want = rglru_scan_bwd_ref(a, h, gh)
    for x, y in zip(got, want):
        assert x.dtype == dtype
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert all(torch.equal(x, y) for x, y in
               zip(got, rglru_scan_bwd_cuda(a, h, gh)))


@pytest.mark.gpu
@pytest.mark.parametrize("case", [(1, 64, 8, 2), (2, 150, 60, 4),
                                  (3, 77, 1024, 7), (1, 33, 4, 1),
                                  (1, 512, 384, 8), (1, 256, 1024, 8),
                                  (2, 45, 40, 40), (1, 7, 2, 2)])
def test_moe_route_backward_matches_twin(cuda, case):
    """Against the twin within 1e-4 of the scale, two runs bitwise
    equal: the routing test shapes, kimi-k2's routing (384 experts, top-8),
    the widest E, more picks than lanes per token (40 of 40 over 16
    lanes), fewer experts than one lane holds."""
    from repro_torch.kernels.moe_route import (moe_route_bwd_cuda,
                                               moe_route_cuda)
    from repro_torch.kernels.ref import moe_route_bwd_ref
    cs = chip_smoke()
    rng = np.random.RandomState(sum(case))
    G, gs, E, k = case
    logits = cs._route_logits(rng, G, gs, E)
    eid = moe_route_cuda(logits, k)[0]
    g_gate = torch.from_numpy(rng.randn(G, gs, k)).float().to(cuda)
    got = moe_route_bwd_cuda(logits, eid, g_gate)
    cs._scaled_err(got, moe_route_bwd_ref(logits, eid, g_gate), f"{case}",
                   cs.TRAIN_ATOL["float32"])
    assert torch.equal(got, moe_route_bwd_cuda(logits, eid, g_gate))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-moe-a2.7b",
                                  "falcon-mamba-7b", "recurrentgemma-9b",
                                  "qwen2-vl-7b", "musicgen-medium"])
def test_train_steps_match_cpu(cuda, arch):
    """Three train steps of the reduced float32 model on the card against
    the CPU: parameters, optimizer state, loss and grad norm within rtol
    1e-4 / atol 1e-5 of each leaf's scale (``chip_smoke.train_step_cross``)."""
    worst, leaves = chip_smoke().train_step_cross(arch)
    assert worst <= 1e-4 and leaves > 0


# ----------------------------------------------- the kernel operators

def _to_card(args, cuda):
    return tuple(a.detach().to(cuda).requires_grad_(a.requires_grad)
                 if isinstance(a, torch.Tensor) else a for a in args)


@pytest.mark.gpu
@pytest.mark.parametrize("name", [c[0] for c in __import__(
    "test_torch_ops").CASES])
def test_opcheck_on_cuda(cuda, name):
    """``torch.library.opcheck`` of every ``repro_torch::`` operator on
    CUDA tensors (the kernels), at the CPU tests' cases."""
    from test_torch_ops import CASES
    _, op, make = next(c for c in CASES if c[0] == name)
    torch.library.opcheck(op, _to_card(make(np.random.default_rng(0)),
                                       cuda))


def _filled(tree, device, seed):
    """``tree``'s tensors as seeded values on ``device`` (ints in [0, 8),
    bools alternating, floats small normals), its other values kept."""
    from repro_torch.tree import tree_flatten, tree_unflatten
    g = torch.Generator().manual_seed(seed)
    out = []
    for _, t in tree_flatten(tree):
        if not isinstance(t, torch.Tensor):
            out.append(t)
        elif t.dtype in (torch.int32, torch.int64):
            out.append(torch.randint(0, 8, t.shape, generator=g,
                                     dtype=t.dtype).to(device))
        elif t.dtype == torch.bool:
            out.append((torch.arange(t.numel()).reshape(t.shape) % 2 == 0)
                       .to(device))
        else:
            out.append((0.1 * torch.randn(t.shape, generator=g))
                       .to(device=device, dtype=t.dtype))
    return tree_unflatten(tree, out)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-moe-a2.7b",
                                  "falcon-mamba-7b", "recurrentgemma-9b",
                                  "musicgen-medium", "qwen2-vl-7b"])
def test_count_on_cuda_equals_meta(cuda, arch, monkeypatch):
    """A 2-layer model's train step, prefill and decode count the same on
    the card (through the kernels) as on the meta device."""
    from repro_torch import configs
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.flopcount import count_fn
    cfg = configs.get_config(arch).reduced()
    shapes = {"train": dict(seq_len=8, global_batch=2, kind="train"),
              "prefill": dict(seq_len=8, global_batch=2, kind="prefill"),
              "decode": dict(seq_len=12, global_batch=2, kind="decode")}
    monkeypatch.setattr(configs, "INPUT_SHAPES", shapes)
    monkeypatch.setattr(specs, "INPUT_SHAPES", shapes)
    for name in shapes:
        step, args = dryrun.step_and_inputs(cfg, name, "meta")
        meta = count_fn(step, *args)
        step, args = dryrun.step_and_inputs(cfg, name, "cuda")
        card = count_fn(step, *_filled(args, cuda, seed=len(name)))
        assert (card.dot_flops, card.other_flops, card.hbm_bytes) == (
            meta.dot_flops, meta.other_flops, meta.hbm_bytes), (arch, name)
        if name == "train":                 # every family's kernels run
            assert any(op.startswith("repro_torch.") for op in card.ops)


# --------------------------------------------- pipeline and grid dispatch

@pytest.mark.gpu
def test_pipeline_on_streams_matches_forward(cuda, monkeypatch):
    """``pipeline_shard_map`` over two streams of the card at a reduced
    bf16 TinyLlama against ``forward`` (``chip_smoke.pipeline_phase``):
    within 2e-2 of the logits' scale, flash once per layer per
    microbatch."""
    import dataclasses
    from repro_torch.configs import get_config
    cs = chip_smoke()
    monkeypatch.setitem(cs.PIPELINE, "seq", 64)
    monkeypatch.setitem(cs.PIPELINE, "reps", 1)
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(
        max_layers=4), compute_dtype="bfloat16", param_dtype="bfloat16")
    out = cs.pipeline_phase("cuda", cfg=cfg)
    assert out["M4"]["flash_launches"] == 16


@pytest.mark.gpu
def test_part_streams_are_kept_per_card_and_part(cuda):
    """The pipeline's stages and the grid's parts share one stream cache:
    part i of a card gets the same stream on every call."""
    from repro_torch.device import part_stream
    s0 = part_stream(cuda, 0)
    assert part_stream(cuda, 0) is s0
    assert part_stream(torch.device("cuda", cuda.index or 0), 0) is s0
    assert part_stream(cuda, 1) is not s0


@pytest.mark.gpu
def test_grid_dispatch_matches_the_one_call(cuda):
    """``run_grid_batched`` with ``threads=2`` and ``devices=1`` against
    the one call on the card (``chip_smoke.grid_phase`` at a small grid;
    ``devices=2`` raises on one card)."""
    from repro_torch.core.mab import mab_state_from_numpy
    cs = chip_smoke()
    out = cs.grid_phase(mab_state_from_numpy(cs.MAB_LITERAL, device=cuda),
                        grid=dict(seeds=(0, 1, 2), lams=(6.0,),
                                  n_intervals=36, substeps=4))
    assert all(out["bestfit-rr"]["bitwise"].values())
