"""The port's serving engine and its DASO, AdamW, MAB and partitioner
parts against the JAX reference (run in process, default float32).

θ is carried across from the reference (``daso.make_trainer(PRNGKey)``)
and the inputs are made with numpy.  Tolerances: DASO and AdamW rtol
1e-5 (float32 gradients summed in other orders, carried through 25
ascent steps or several AdamW steps); MAB state rtol 1e-6 (the port
rounds ``Q + γ(O − Q)`` once, as a fused multiply-add, where the
reference's eager ops round twice).  The engine's plan choices,
fidelities and rewards must be equal.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import daso as jdaso
from repro.core import mab as jmab
from repro.models import model as jmodel
from repro.optim import optimizers as jopt
from repro.serving import engine as jengine
from repro.serving import plans as jplans
from repro_torch.configs import get_config
from repro_torch.core import daso as tdaso
from repro_torch.core import mab as tmab
from repro_torch.models import model as tmodel
from repro_torch.optim import optimizers as topt
from repro_torch.serving import engine as tengine
from repro_torch.serving import plans as tplans

RTOL = 1e-5


def _cfg(w=4, c=3):
    kw = dict(num_workers=w, max_containers=c, state_features=2, hidden=32,
              depth=2, place_iters=60, lr_place=0.3)
    return jdaso.DASOConfig(**kw), tdaso.DASOConfig(**kw)


def _theta(jcfg, seed):
    jtheta, jopt_state = jdaso.make_trainer(jcfg, jax.random.PRNGKey(seed))
    ttheta, topt_state = tdaso.trainer_from_numpy(
        jax.tree.map(np.asarray, jtheta), device="cpu")
    return jtheta, jopt_state, ttheta, topt_state


def _close(got, want, rtol=RTOL, atol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _placement_inputs(cfg, seed):
    rng = np.random.RandomState(seed)
    state = rng.rand(cfg.num_workers, cfg.state_features).astype(np.float32)
    p0 = rng.randn(cfg.max_containers, cfg.num_workers).astype(np.float32)
    dec = rng.randint(0, 2, cfg.max_containers).astype(np.int32)
    mask = np.array([1.0] * (cfg.max_containers - 1) + [0.0], np.float32)
    return state, p0, dec, mask


@pytest.mark.parametrize("aware", [True, False])
def test_pack_input_and_surrogate(aware):
    jcfg, tcfg = _cfg()
    jcfg, tcfg = jcfg._replace(decision_aware=aware), \
        tcfg._replace(decision_aware=aware)
    jtheta, _, ttheta, _ = _theta(jcfg, 0)
    arrs = _placement_inputs(jcfg, 1)
    jx = jdaso.pack_input(jcfg, *[jnp.asarray(a) for a in arrs])
    tx = tdaso.pack_input(tcfg, *[torch.from_numpy(a) for a in arrs])
    assert tx.shape == (tdaso.feature_size(tcfg),)
    _close(tx, jx, atol=1e-7)
    _close(tdaso.surrogate_apply(ttheta, tx),
           jdaso.surrogate_apply(jtheta, jx), atol=1e-6)


@pytest.mark.parametrize("seed", range(3))
def test_optimize_placement(seed):
    jcfg, tcfg = _cfg()
    jtheta, _, ttheta, _ = _theta(jcfg, seed + 3)
    arrs = _placement_inputs(jcfg, seed + 4)
    jp, js, ji = jdaso.optimize_placement(jcfg, jtheta,
                                          *[jnp.asarray(a) for a in arrs])
    tp, ts, ti = tdaso.optimize_placement(tcfg, ttheta,
                                          *[torch.from_numpy(a) for a in arrs])
    assert ti == int(ji) and ti > 0
    _close(tp, jp, atol=1e-6)
    _close(ts, js, atol=1e-6)
    mask = torch.from_numpy(arrs[3])
    np.testing.assert_array_equal(
        tdaso.placement_to_assignment(tp, mask).numpy(),
        np.asarray(jdaso.placement_to_assignment(jp, jnp.asarray(arrs[3]))))


def test_optimize_placement_stops_at_tol():
    """A flat surrogate (zero last layer) gives zero gradients: the first
    step is below tol and the ascent stops after one iteration."""
    jcfg, tcfg = _cfg()
    jtheta, _, ttheta, _ = _theta(jcfg, 7)
    jtheta[-1]["w"] = jnp.zeros_like(jtheta[-1]["w"])
    ttheta[-1]["w"] = torch.zeros_like(ttheta[-1]["w"])
    arrs = _placement_inputs(jcfg, 8)
    _, _, ji = jdaso.optimize_placement(jcfg, jtheta,
                                        *[jnp.asarray(a) for a in arrs])
    _, _, ti = tdaso.optimize_placement(tcfg, ttheta,
                                        *[torch.from_numpy(a) for a in arrs])
    assert ti == int(ji) == 1


def test_train_epoch_with_adamw():
    jcfg, tcfg = _cfg()
    jtheta, jst, ttheta, tst = _theta(jcfg, 9)
    rng = np.random.RandomState(10)
    xs = rng.randn(40, jdaso.feature_size(jcfg)).astype(np.float32)
    ys = np.tanh(xs @ rng.randn(xs.shape[1]).astype(np.float32) * 0.3)
    for step in range(5):
        jtheta, jst, jl = jdaso.train_epoch(jcfg, jtheta, jst,
                                            jnp.asarray(xs), jnp.asarray(ys))
        ttheta, tst, tl = tdaso.train_epoch(tcfg, ttheta, tst,
                                            torch.from_numpy(xs),
                                            torch.from_numpy(ys))
        _close(tl, jl)
        for tl_, jl_ in zip(ttheta, jtheta):
            for k in ("w", "b"):
                _close(tl_[k], jl_[k], atol=1e-7)
    assert int(tst.step) == int(jst.step) == 5


def test_adamw_update_with_weight_decay():
    rng = np.random.RandomState(11)
    params = [rng.randn(3, 4).astype(np.float32),
              rng.randn(5).astype(np.float32)]
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.from_numpy(p) for p in params]
    js, ts = jopt.adamw_init(jp), topt.adamw_init(tp)
    for step in range(4):
        grads = [rng.randn(*p.shape).astype(np.float32) for p in params]
        jp, js = jopt.adamw_update([jnp.asarray(g) for g in grads], js, jp,
                                   1e-2)
        tp, ts = topt.adamw_update([torch.from_numpy(g) for g in grads], ts,
                                   tp, 1e-2)
        for a, b in zip(tp, jp):
            _close(a, b, atol=1e-7)


def test_end_of_interval_one_cell():
    """The engine's unbatched Algorithm-1 update: one leaving task per
    call, 12 calls from a fresh state."""
    rng = np.random.RandomState(12)
    js = jmab.init_state(num_apps=1)
    ts = tmab.init_state(num_apps=1, device="cpu")
    for _ in range(12):
        row = [np.array([0], np.int32),
               np.array([rng.uniform(0.01, 0.05)], np.float32),
               np.array([rng.uniform(0.005, 0.06)], np.float32),
               np.array([rng.choice([1.0, 0.75, 0.5])], np.float32),
               np.array([rng.randint(0, 2)], np.int32)]
        js = jmab.end_of_interval(js, *[jnp.asarray(a) for a in row],
                                  0.9, 0.3)
        ts = tmab.end_of_interval(ts, *[torch.from_numpy(a) for a in row],
                                  0.9, 0.3)
    for k in ("Q", "N", "R", "eps", "rho"):
        _close(getattr(ts, k)[0], getattr(js, k), rtol=1e-6)
    assert int(ts.t[0]) == int(js.t)


def test_optimal_stage_bounds_match_reference():
    for stages in (2, 3, 4):
        for arch in ("tinyllama-1.1b", "llama3-405b"):
            assert tplans.optimal_stage_bounds(
                get_config(arch), 256, 1, stages) == \
                jplans.optimal_stage_bounds(jget_config(arch), 256, 1,
                                            stages)


# ---------------------------------------------------------------- engine

def _scripted(engine, plan_s, calls):
    """Replace ``engine._run``'s wall clock by a scripted latency: the
    plan still runs, and call i of plan p reports ``plan_s[p][i % 4]``."""
    run = engine._run

    def _run(plan_kind, batch):
        logits, _ = run(plan_kind, batch)
        i = calls[plan_kind]
        calls[plan_kind] += 1
        return logits, plan_s[plan_kind][i % len(plan_s[plan_kind])]

    engine._run = _run


def test_engine_matches_reference_over_20_requests():
    """20 requests of tight or loose deadlines, the reference's rule: both
    engines pick the same plans and see the same fidelities and rewards;
    past 16 requests DASO's ascent and training run on both sides."""
    jcfg = jget_config("tinyllama-1.1b").reduced()
    cfg = get_config("tinyllama-1.1b").reduced()
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    params = tmodel.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    jeng = jengine.SplitPlaceEngine(jparams, jcfg)
    teng = tengine.SplitPlaceEngine(params, cfg, device="cpu")
    teng._theta, teng._daso_opt = tdaso.trainer_from_numpy(
        jax.tree.map(np.asarray, jeng._theta), device="cpu")
    plan_s = {0: [0.010, 0.012, 0.011, 0.013],
              1: [0.004, 0.005, 0.0045, 0.006]}
    _scripted(jeng, plan_s, {0: 0, 1: 0})
    _scripted(teng, plan_s, {0: 0, 1: 0})
    rng = np.random.RandomState(0)
    tok = rng.randint(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    jeng.warmup(tok)
    teng.warmup(tok)
    plans, fids = [], []
    for i in range(20):
        tight = rng.rand() < 0.5
        ddl = float(0.005 * 2.5 if tight else 0.011 * 4.0)
        jr = jeng.serve(jengine.Request(tokens=tok, deadline_s=ddl))
        tr = teng.serve(tengine.Request(tokens=tok, deadline_s=ddl))
        assert (tr.plan, tr.met_deadline) == (jr.plan, jr.met_deadline), i
        assert tr.fidelity == jr.fidelity and tr.reward == jr.reward, i
        _close(tr.latency_s, jr.latency_s, rtol=1e-12)
        plans.append(tr.plan)
        fids.append(tr.fidelity)
    assert set(plans) == {0, 1}
    assert all(f == 1.0 for p, f in zip(plans, fids) if p == 0)
    assert len(teng._replay) == 20
    for k in ("Q", "N", "R"):
        _close(getattr(teng.state, k)[0], getattr(jeng.state, k), rtol=1e-6)
    assert int(teng.state.t[0]) == int(jeng.state.t)
    _close(teng.slice_load, jeng.slice_load, rtol=1e-6)
    for tl_, jl_ in zip(teng._theta, jeng._theta):
        _close(tl_["w"], jl_["w"], atol=1e-6)


# ------------------------------------------------- the engine's spans

#: ``engine.serve``'s children in order; ``engine.daso_train`` ends the
#: requests that train DASO
SERVE_CHILDREN = ["engine.upload", "engine.decide", "engine.place",
                  "engine.plan", "engine.mono", "engine.fidelity",
                  "engine.update"]
PLAN_S = {0: [0.010, 0.012, 0.011, 0.013], 1: [0.004, 0.005, 0.0045, 0.006]}


def _traced_engine():
    """A tiny engine on the CPU with scripted plan walls (so that its
    decisions do not follow the host's clock), its warm-up done, and 20
    requests of tight or loose deadlines."""
    cfg = get_config("tinyllama-1.1b").reduced()
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    eng = tengine.SplitPlaceEngine(params, cfg, device="cpu", seed=3)
    _scripted(eng, PLAN_S, {0: 0, 1: 0})
    rng = np.random.RandomState(0)
    tok = rng.randint(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    eng.warmup(tok)
    reqs = [tengine.Request(tokens=tok, deadline_s=float(
        0.005 * 2.5 if rng.rand() < 0.5 else 0.011 * 4.0))
        for _ in range(20)]
    return eng, reqs


def _serve_counted(eng, reqs, led):
    """Serve ``reqs`` under ``led``: the results and each request's
    counter deltas."""
    from repro_torch.obs import use_ledger
    results, deltas = [], []
    with use_ledger(led):
        for r in reqs:
            before = dict(led.counters)
            results.append(eng.serve(r))
            deltas.append({k: v - before.get(k, 0)
                           for k, v in led.counters.items()})
    return results, deltas


def test_engine_spans_per_request():
    """One ``engine.serve`` span per request; its children in the
    engine's order, ``engine.daso_train`` on the requests that train;
    one ``engine.plan.stage`` per stage or ``engine.plan.branch`` per
    branch under ``engine.plan``, whose ``kind`` names the plan."""
    from repro_torch.obs import RunLedger
    eng, reqs = _traced_engine()
    led = RunLedger("engine")
    results, _ = _serve_counted(eng, reqs, led)
    spans = [e for e in led.events if e["kind"] == "span"]
    kids = {}
    for e in spans:
        kids.setdefault(e["parent"], []).append(e)
    serves = sorted(kids[None], key=lambda e: e["start_s"])
    assert [e["name"] for e in serves] == ["engine.serve"] * 20
    for k, (sp, res) in enumerate(zip(serves, results)):
        children = sorted(kids[sp["id"]], key=lambda e: e["start_s"])
        trains = k + 1 >= 16 and (k + 1) % 4 == 0
        assert [c["name"] for c in children] == SERVE_CHILDREN + (
            ["engine.daso_train"] if trains else []), k
        for c in children:
            assert sp["start_s"] <= c["start_s"]
            assert c["start_s"] + c["dur_s"] <= sp["start_s"] + sp["dur_s"]
        plan = children[3]
        layer = res.plan == tplans.LAYER_PLAN
        assert plan["attrs"] == {"kind": "layer" if layer else "semantic"}
        parts = sorted(kids[plan["id"]], key=lambda e: e["start_s"])
        name, n, key = (("engine.plan.stage", eng.layer_plan.num_stages,
                         "stage") if layer else
                        ("engine.plan.branch", eng.sem_plan.num_branches,
                         "branch"))
        assert [(c["name"], c["attrs"][key]) for c in parts] == \
            [(name, i) for i in range(n)], k
        assert all(c["id"] not in kids for c in parts)
    assert {r.plan for r in results} == {0, 1}


def test_engine_waits_by_hand():
    """``host.waits`` of each request, counted where each wait happens, is
    the sum of its sites: the tokens' upload, the decision's two uploads
    and read, the placement's four uploads and two reads (and the
    ascent's step reads once 16 replays exist), ``_run``'s two
    synchronizes, the fidelity's read, the update's five uploads, the
    MAB's five float32 constants and two reads, and DASO training's two
    uploads; ``engine.h2d_bytes`` the bytes of the engine's uploads."""
    from repro_torch.obs import HOST_WAITS, RunLedger
    eng, reqs = _traced_engine()
    led = RunLedger("engine")
    reads = tmab.host_reads()
    _, deltas = _serve_counted(eng, reqs, led)
    assert tmab.host_reads() - reads == 2 * len(reqs)
    cfg = eng._daso_cfg
    W, C = cfg.num_workers, cfg.max_containers
    feats = tdaso.feature_size(cfg)
    tok_bytes = reqs[0].tokens.size * 4
    for k, d in enumerate(deltas):
        steps = d.get("daso.ascent_steps", 0)
        assert (steps > 0) == (k >= 16), k
        trains = d.get("daso.train_epochs", 0) // 2
        assert trains == (k + 1 >= 16 and (k + 1) % 4 == 0), k
        want = (1 + 3 + 6 + min(steps, cfg.place_iters - 1) + 2 + 1
                + 5 + 5 + 2 + 2 * trains)
        assert d[HOST_WAITS] == want, (k, d)
        rows = min(k + 1, 64)
        assert d["engine.h2d_bytes"] == (
            tok_bytes + 8 + 4 * (W + 2 * C + C * W) + 5 * 4
            + trains * rows * (feats + 1) * 4), (k, d)
    total = led.counters
    assert total["daso.train_epochs"] == 4
    assert total[HOST_WAITS] == sum(d[HOST_WAITS] for d in deltas)


def test_engine_tracing_changes_nothing():
    """Served with the ledger off and on from the same seed, the results,
    the MAB state, θ, the slice loads and the replay are bitwise equal,
    and the off run adds no event or counter to the default ledger."""
    from repro_torch.obs import RunLedger, get_ledger
    off_eng, reqs = _traced_engine()
    default = get_ledger()
    off = [off_eng.serve(r) for r in reqs]
    assert get_ledger() is default
    assert default.events == [] and default.counters == {}
    on_eng, _ = _traced_engine()
    on, _ = _serve_counted(on_eng, reqs, RunLedger("engine"))
    assert on == off
    for k in tmab.MABState._fields:
        assert torch.equal(getattr(on_eng.state, k),
                           getattr(off_eng.state, k)), k
    for a, b in zip(on_eng._theta, off_eng._theta):
        assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])
    np.testing.assert_array_equal(on_eng.slice_load, off_eng.slice_load)
    for (xa, ya), (xb, yb) in zip(on_eng._replay, off_eng._replay):
        np.testing.assert_array_equal(xa, xb)
        assert ya == yb


def test_memory_feasible_partition_respects_budget():
    """The reference test's six 3-byte layers under a 7-byte budget, and a
    budget no layer fits; the cuts equal the reference's."""
    from repro.core import partitioner as jpart
    from repro_torch.core import partitioner as tpart
    costs = [tpart.LayerCost(1.0, 1.0, float(p)) for p in [3] * 6]
    cuts = tpart.memory_feasible_partition(costs, ram_budget_bytes=7.0)
    for a, b in zip(cuts[:-1], cuts[1:]):
        assert sum(c.param_bytes for c in costs[a:b]) <= 7.0
    with pytest.raises(ValueError):
        tpart.memory_feasible_partition(costs, ram_budget_bytes=2.0)
    assert cuts == jpart.memory_feasible_partition(
        [jpart.LayerCost(1.0, 1.0, 3.0)] * 6, ram_budget_bytes=7.0)
    real = tpart.model_layer_costs(get_config("tinyllama-1.1b"), seq=128,
                                   batch=1)
    jreal = [jpart.LayerCost(c.flops, c.out_bytes, c.param_bytes)
             for c in real]
    for layers in (1.5, 4.0, 9.0):
        budget = layers * real[0].param_bytes
        assert tpart.memory_feasible_partition(real, budget) == \
            jpart.memory_feasible_partition(jreal, budget)


def test_plan_cost_model_orders_latency():
    """The semantic plan is quicker than the layer pipeline (the reference
    test's ordering; the port prices one H100, not a TPU slice), and more
    branches or stages move each plan the reference's way."""
    from repro_torch.serving.plans import (LAYER_PLAN, SEMANTIC_PLAN,
                                           PlanSpec, plan_cost_model)
    cfg = get_config("tinyllama-1.1b")
    lat = {(kind, n): plan_cost_model(
        cfg, PlanSpec(kind, num_stages=n, num_branches=n), seq=128, batch=4)
        for kind in (LAYER_PLAN, SEMANTIC_PLAN) for n in (2, 4)}
    assert lat[(SEMANTIC_PLAN, 4)] < lat[(LAYER_PLAN, 4)]
    assert lat[(SEMANTIC_PLAN, 4)] < lat[(SEMANTIC_PLAN, 2)]
    assert lat[(LAYER_PLAN, 2)] < lat[(LAYER_PLAN, 4)]
    jlat = {(kind, n): jplans.plan_cost_model(
        jget_config("tinyllama-1.1b"), jplans.PlanSpec(
            kind, num_stages=n, num_branches=n), seq=128, batch=4)
        for kind, n in lat}
    assert sorted(lat, key=lat.get) == sorted(jlat, key=jlat.get)
