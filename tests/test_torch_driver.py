"""The port's interval program end to end, on the CPU.

  * ``run_trace_arrays`` reproduces ``tests/data/golden_static_bestfit_rr
    .json`` at the fixture's own tolerance (rtol=1e-6, atol=1e-12);
  * static (``bestfit-rr``, ``mc``) and ``"mab"``-deploy grids (G=3, λ=5,
    T=8, substeps=4) match the live JAX driver's summaries at rtol=1e-9,
    with the MAB interval counter exact, on the Table-3 fleet and on a
    fleet with a tenth of its RAM (where the feasibility repair walks the
    live slots every interval); the reference runs in a child interpreter
    (``_torch_ref``);
  * single traces match the EdgeSim oracle (the reference's host
    simulator replayed through the same compiled trace,
    ``repro.env.jaxsim.reference.replay_trace_edgesim``) at the North
    star's rtol=1e-4 on the three cases of ``tests/test_jaxsim_parity.py``:
    BestFit at two λ, RAM pressure, layer chains;
  * a grid equals its cells run one by one;
  * ``run_grid_batched`` returns one record per (λ, seed) cell, for the
    DASO policies too; ``random+daso``, ``gillis`` and ``mode="train"``
    run (no policy is left unported), and ``mode="train"`` of a static
    policy raises the reference's ValueError.

The DASO placement stage itself is held in ``test_torch_daso_sim.py``.
"""
from __future__ import annotations

import itertools
import json
import os

import numpy as np
import pytest

import torch

from _torch_ref import MAB_LITERAL, MAB_LITERAL_JAX, ROOT, run_reference
from repro_torch.core import daso
from repro_torch.env.cluster import make_cluster
from repro_torch.env.torchsim import (compile_trace, compile_trace_dual,
                                      engines,
                                      make_static_decider, run_grid_arrays,
                                      run_grid_arrays_learned,
                                      run_grid_arrays_static_daso,
                                      run_trace_arrays,
                                      run_trace_arrays_learned)
from repro_torch.launch.experiments import NOT_PORTED, run_grid_batched

GOLDEN = os.path.join(ROOT, "tests", "data", "golden_static_bestfit_rr.json")
GRID = dict(lam=5.0, seeds=(0, 1, 2), n_intervals=8, substeps=4)
POLICIES = ("bestfit-rr", "mc", "mab")
RAM_SCALES = (1.0, 0.1)


def _traces(policy, ram_scale=1.0):
    kw = dict(lam=GRID["lam"], n_intervals=GRID["n_intervals"],
              substeps=GRID["substeps"],
              cluster=make_cluster(ram_scale=ram_scale))
    if policy == "mab":
        return [compile_trace_dual(seed=s, **kw) for s in GRID["seeds"]]
    dec = make_static_decider(policy)
    return [compile_trace(dec, seed=s, **kw) for s in GRID["seeds"]]


def _run(policy, traces, ram_scale=1.0):
    cluster = make_cluster(ram_scale=ram_scale)
    if policy == "mab":
        return run_grid_arrays_learned(traces, MAB_LITERAL, cluster=cluster,
                                       device="cpu")
    return run_grid_arrays(traces, cluster=cluster, device="cpu")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref_driver") / "summaries.json"
    run_reference(MAB_LITERAL_JAX + f"""
import json
from repro.env import jaxsim
from repro.env.cluster import make_cluster
seeds = {GRID['seeds']!r}
res = {{}}
for scale in {RAM_SCALES!r}:
    cl = make_cluster(ram_scale=scale)
    kw = dict(lam={GRID['lam']}, n_intervals={GRID['n_intervals']},
              substeps={GRID['substeps']}, cluster=cl)
    for pol in ("bestfit-rr", "mc"):
        dec = jaxsim.make_static_decider(pol)
        res[f"{{pol}}/{{scale}}"] = jaxsim.run_grid_arrays(
            [jaxsim.compile_trace(dec, seed=s, **kw) for s in seeds],
            cluster=cl)
    res[f"mab/{{scale}}"] = jaxsim.run_grid_arrays_learned(
        [jaxsim.compile_trace_dual(seed=s, **kw) for s in seeds], MAB_STATE,
        cluster=cl)
with open(OUT, "w") as f:
    json.dump(res, f)
""", out)
    with open(out) as f:
        return json.load(f)


#: the cases of tests/test_jaxsim_parity.py, at its own sizes: name ->
#: (policy, λ, seed, ram_scale, n_intervals, substeps)
EDGESIM_CASES = {"bestfit-lam4": ("bestfit-rr", 4.0, 0, 1.0, 20, 10),
                 "bestfit-lam9": ("bestfit-rr", 9.0, 0, 1.0, 20, 10),
                 "ram-pressure": ("mc", 14.0, 2, 0.35, 12, 8),
                 "layer-chains": ("bestfit-layer", 8.0, 3, 1.0, 15, 10)}
EDGESIM_RTOL, EDGESIM_ATOL = 1e-4, 1e-9


@pytest.fixture(scope="module")
def edgesim(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref_edgesim") / "summaries.json"
    run_reference(f"""
import json
from repro.env.cluster import make_cluster
from repro.env.jaxsim import (compile_trace, make_static_decider,
                              replay_trace_edgesim)
res = {{}}
for name, (pol, lam, seed, scale, T, S) in {EDGESIM_CASES!r}.items():
    cl = make_cluster(ram_scale=scale)
    tr = compile_trace(make_static_decider(pol), lam=lam, seed=seed,
                       n_intervals=T, substeps=S, cluster=cl)
    res[name] = replay_trace_edgesim(tr, cluster=cl)
with open(OUT, "w") as f:
    json.dump(res, f)
""", out)
    with open(out) as f:
        return json.load(f)


@pytest.mark.parametrize("case", sorted(EDGESIM_CASES))
def test_trace_matches_edgesim_oracle(edgesim, case):
    policy, lam, seed, scale, T, S = EDGESIM_CASES[case]
    cluster = make_cluster(ram_scale=scale)
    tr = compile_trace(make_static_decider(policy), lam=lam, seed=seed,
                       n_intervals=T, substeps=S, cluster=cluster)
    got = run_trace_arrays(tr, cluster=cluster, device="cpu")
    want = edgesim[case]
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.isclose(got[k], v, rtol=EDGESIM_RTOL, atol=EDGESIM_ATOL), \
            f"{case} {k}: edgesim={v!r} port={got[k]!r}"
    assert got["tasks_completed"] > 0 and got["dropped_tasks"] == 0
    if case == "ram-pressure":
        assert want["wait_intervals"] > 0     # the repair failed tasks
    if case == "layer-chains":
        assert want["layer_fraction"] == 1.0


def test_golden_static_bestfit_rr():
    with open(GOLDEN) as f:
        golden = json.load(f)
    tr = compile_trace(make_static_decider("bestfit-rr"), lam=5.0, seed=0,
                       n_intervals=8, substeps=4)
    got = run_trace_arrays(tr, device="cpu")
    assert golden["case"] == "static bestfit-rr lam=5 seed=0 T=8 substeps=4"
    assert set(golden["summary"]) == set(got)
    for k, v in golden["summary"].items():
        assert np.isclose(got[k], v, rtol=1e-6, atol=1e-12), \
            f"{k}: fixture={v!r} port={got[k]!r}"


@pytest.mark.parametrize("ram_scale", RAM_SCALES)
@pytest.mark.parametrize("policy", POLICIES)
def test_grid_matches_jax_driver(ref, policy, ram_scale):
    got = _run(policy, _traces(policy, ram_scale), ram_scale)
    want = ref[f"{policy}/{ram_scale}"]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), f"cell {i}: {sorted(set(g) ^ set(w))}"
        for k, v in w.items():
            assert np.isclose(g[k], v, rtol=1e-9, atol=1e-12), \
                f"{policy} cell {i} {k}: jax={v!r} port={g[k]!r}"
        if policy == "mab":
            assert g["mab_t"] == w["mab_t"] == 40 + GRID["n_intervals"]
        assert g["dropped_tasks"] == 0 and g["tasks_completed"] > 0


def test_small_ram_fleet_runs_the_repair_scan(monkeypatch):
    """On the tenth-RAM fleet the sequential repair runs in every
    interval, so the comparison above covers it."""
    from repro_torch.kernels import placement
    trips = []
    scan = placement.repair_scan

    def counting(*args):
        trips.append(int(args[1].max()))
        return scan(*args)

    monkeypatch.setattr(placement, "repair_scan", counting)
    _run("bestfit-rr", _traces("bestfit-rr", 0.1), 0.1)
    assert len(trips) == GRID["n_intervals"] and min(trips) > 0


@pytest.mark.parametrize("policy", ("bestfit-rr", "mab"))
def test_grid_equals_single_trace_runs(policy):
    traces = _traces(policy)
    grid = _run(policy, traces)
    for tr, g in zip(traces, grid):
        one = run_trace_arrays_learned(tr, MAB_LITERAL, device="cpu") \
            if policy == "mab" else run_trace_arrays(tr, device="cpu")
        assert one == g


#: a small random surrogate for the DASO policies (C=8, hidden 16)
DASO_CFG = daso.DASOConfig(num_workers=50, max_containers=8,
                           state_features=4, hidden=16, depth=2,
                           place_iters=5, lr_place=20.0)


def _daso_theta():
    return daso.init_surrogate(DASO_CFG, torch.Generator().manual_seed(0),
                               device="cpu")


@pytest.mark.parametrize("policy", ("mc", "mab", "splitplace", "mab+gobi",
                                    "layer+gobi", "semantic+gobi"))
def test_run_grid_batched_one_record_per_cell(policy):
    lams, seeds = (4.0, 6.0), (3, 5)
    phase_s = {}
    recs = run_grid_batched(policy, seeds=seeds, lams=lams, n_intervals=5,
                            substeps=3, mab_state=MAB_LITERAL, device="cpu",
                            daso_theta=_daso_theta(), daso_cfg=DASO_CFG,
                            phase_s=phase_s)
    cells = list(itertools.product(lams, seeds))
    assert [(r["lam"], r["seed"]) for r in recs] == cells
    assert all(r["policy"] == policy for r in recs)
    assert all(isinstance(v, float) for r in recs for k, v in r.items()
               if k not in ("policy", "seed", "lam"))
    assert set(phase_s) == {"decide", "place", "physics", "feedback",
                            "mab_host_read"}
    # the MAB feedback's host reads are a part of phase "feedback"
    assert 0.0 <= phase_s["mab_host_read"] <= phase_s["feedback"]
    if policy in ("mab", "splitplace", "mab+gobi"):
        assert phase_s["mab_host_read"] > 0.0
    # the same cells run as single-variant static traces one by one
    if policy == "mc":
        for (lam, seed), r in zip(cells, recs):
            one = run_trace_arrays(compile_trace(
                make_static_decider("mc"), lam=lam, seed=seed,
                n_intervals=5, substeps=3), device="cpu")
            assert r["tasks_completed"] == one["tasks_completed"]


@pytest.mark.parametrize("policy", ("random+daso", "gillis"))
def test_unported_policies_raise(policy):
    """Nothing is left unported: both policies run a grid through
    ``run_grid_batched`` (held against the reference in
    ``test_torch_train_sim.py``)."""
    assert NOT_PORTED == {}
    recs = run_grid_batched(policy, n_intervals=2, substeps=2, device="cpu",
                            mab_state=MAB_LITERAL, daso_theta=_daso_theta(),
                            daso_cfg=DASO_CFG)
    assert len(recs) == 1 and recs[0]["policy"] == policy
    assert recs[0]["dropped_tasks"] == 0


def test_train_mode_and_daso_raise():
    """``mode="train"`` runs the MAB policies and raises the reference's
    ValueError for a static one; the ``random+daso`` engine (arm −1)
    builds; the MAB deploy engine takes a DASO cfg."""
    recs = run_grid_batched("mab", mode="train", mab_state=MAB_LITERAL,
                            n_intervals=2, substeps=2, device="cpu")
    assert recs[0]["mab_t"] == MAB_LITERAL["t"] + 2
    with pytest.raises(ValueError, match="is static — mode='train'"):
        run_grid_batched("mc", mode="train", n_intervals=2, substeps=2,
                         device="cpu")
    assert engines.StaticDeciderDASOEngine(arm=-1, daso_cfg=DASO_CFG).arm \
        == -1
    eng = engines.MABDeployEngine(mab_hp=(0.5, 0.3, 0.3, 0.1),
                                  daso_cfg=DASO_CFG)
    assert eng.daso_cfg is DASO_CFG


def test_random_daso_raises_in_the_driver():
    """The driver runs the random arm: its rows mix both splits, unlike
    either fixed arm."""
    traces = [compile_trace_dual(lam=8.0, seed=0, n_intervals=8,
                                 substeps=4)]
    kw = dict(daso_theta=_daso_theta(), daso_cfg=DASO_CFG, device="cpu")
    got = run_grid_arrays_static_daso(traces, "random+daso", **kw)[0]
    assert 0.0 < got["layer_fraction"] < 1.0
    assert got["dropped_tasks"] == 0 and got["tasks_completed"] > 0


@pytest.mark.parametrize("policy", ("splitplace", "layer+gobi"))
def test_daso_policies_need_theta(policy):
    with pytest.raises(ValueError, match="daso_theta"):
        run_grid_batched(policy, n_intervals=2, substeps=2, device="cpu",
                         mab_state=MAB_LITERAL)
