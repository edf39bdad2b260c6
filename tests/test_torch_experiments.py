"""The port's experiment protocol against the reference's, on the CPU.

``repro_torch.launch.experiments`` held against
``repro.launch.experiments`` run in process (draws inside
``jax.threefry_partitionable(False)``, float32 as the reference's host
loop runs):

  * ``run_trace(backend="soa")`` for the 7 Table-4 policies at T=12,
    4 substeps: summaries equal for the policies without a surrogate, and
    at rtol ``SUMMARY_RTOL`` for the DASO ones (their θ0 carried across);
    the MAB state N and t equal, Q, R, ε, ρ at rtol 1e-6; the
    ``telemetry="interval"`` series and percentiles equal;
  * the §6.3 pretraining body — a 36-interval ``splitplace`` training
    trace, θ0 carried across — through ``pretrain``: the ascent runs (from
    interval 33); N and t equal, Q, R, ε, ρ at rtol 1e-6, θ and the AdamW
    moments within ``THETA_TOL`` of each leaf's largest entry, the Gillis
    Q-table of the same budget equal;
  * ``run_grid(backend="soa")`` (the Gillis object continued across its
    cells) equal to the reference's, and ``aggregate`` equal to the
    reference's on the same records;
  * ``run_grid(backend="torch")`` equal to per-policy ``run_grid_batched``
    in (λ, policy, seed) order, in both modes, and its pretraining pass
    run once and fed through ``run_grid_batched(pretrain_state=...)``;
  * every entry point defaults to CUDA and raises without a card.
"""
from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

import jax
from _torch_ref import MAB_LITERAL, ref_mab_state
from repro.core import daso as ref_daso
from repro.core import splitplace as ref_sp
from repro.launch import experiments as ref_ex
from repro_torch.core import daso as port_daso
from repro_torch.core import splitplace as port_sp
from repro_torch.launch import experiments as ex

POLICIES = ["mc", "gillis", "semantic+gobi", "layer+gobi", "random+daso",
            "mab+gobi", "splitplace"]
SURROGATE = {"semantic+gobi", "layer+gobi", "random+daso", "mab+gobi",
             "splitplace"}
#: summaries of the DASO policies (float32 surrogate beside float64
#: physics); θ (and the AdamW moments) relative to each leaf's largest
#: entry; the MAB's float32 state
SUMMARY_RTOL = 1e-9
THETA_TOL = 5e-4
MAB_RTOL = 1e-6


def _mode():
    return jax.threefry_partitionable(False)


def _np_layers(layers):
    return [{k: np.asarray(v) for k, v in layer.items()} for layer in layers]


def _close_layers(got, want, tol, what):
    for i, (g, w) in enumerate(zip(got, want)):
        for k in ("w", "b"):
            w_k = np.asarray(w[k])
            np.testing.assert_allclose(
                np.asarray(torch.as_tensor(g[k]).cpu()), w_k, rtol=0,
                atol=tol * np.abs(w_k).max(), err_msg=f"{what}[{i}].{k}")


def _assert_mab(port, ref):
    for f in ("N", "t"):
        np.testing.assert_array_equal(getattr(port, f).cpu().numpy()[0],
                                      np.asarray(getattr(ref, f)), f)
    for f in ("Q", "R", "eps", "rho"):
        np.testing.assert_allclose(getattr(port, f).cpu().numpy()[0],
                                   np.asarray(getattr(ref, f)),
                                   rtol=MAB_RTOL, atol=0, err_msg=f)


def _scalars(summary):
    return {k: v for k, v in summary.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)}


# ------------------------------------------------------ host-loop traces

@pytest.mark.parametrize("policy", POLICIES)
def test_run_trace_soa_equals_reference(policy):
    kw = dict(n_intervals=12, lam=6.0, seed=1, substeps=4)
    with _mode(), jax.enable_x64(False):
        rpol = ref_sp.make_policy(policy, 50, seed=1,
                                  mab_state=ref_mab_state(MAB_LITERAL))
        want = ref_ex.run_trace(policy, policy=rpol, **kw)
    theta0 = _np_layers(rpol.placer.theta) if policy in SURROGATE else None
    got = ex.run_trace(policy, mab_state=MAB_LITERAL, device="cpu",
                       daso_theta0=theta0, **kw)
    assert got["policy"] == want["policy"]
    g, w = _scalars(got), _scalars(want)
    assert g.keys() == w.keys() and w["tasks_completed"] > 0
    if policy in SURROGATE:
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=SUMMARY_RTOL,
                                       atol=0, err_msg=k)
    else:
        assert g == w
    assert ("mab_state" in got) == ("mab_state" in want)
    if "mab_state" in want:
        _assert_mab(got["mab_state"], want["mab_state"])


def test_run_trace_soa_interval_telemetry_equals_reference():
    kw = dict(n_intervals=10, lam=12.0, seed=2, substeps=4,
              telemetry="interval")
    want = ref_ex.run_trace("gillis", **kw)
    got = ex.run_trace("gillis", device="cpu", **kw)
    assert got["telemetry"]["cols"] == want["telemetry"]["cols"]
    np.testing.assert_array_equal(got["telemetry"]["series"],
                                  want["telemetry"]["series"])
    assert _scalars(got) == _scalars(want)
    assert got["percentile_err_s"] == 0.0 and got["p99_response_s"] > 0


# ------------------------------------------------ the §6.3 pretraining

PRE = dict(lam=6.0, seed=7, substeps=4)
PRE_T = 36


@pytest.fixture(scope="module")
def pretrained():
    """The reference's pretraining body (its splitplace training trace,
    and the Gillis trace of the same budget) and the port's ``pretrain``
    from the same θ0, with the port's ascents counted."""
    with _mode(), jax.enable_x64(False):
        rpol = ref_sp.make_policy("splitplace", 50, seed=PRE["seed"],
                                  train=True)
        theta0 = _np_layers(rpol.placer.theta)
        ref = ref_ex.run_trace("splitplace", n_intervals=PRE_T, train=True,
                               policy=rpol, **PRE)
        gillis = ref_ex.run_trace("gillis", n_intervals=PRE_T, **PRE)
    steps = []
    ascend = port_daso.optimize_placement

    def counted(*a):
        out = ascend(*a)
        steps.append(int(out[2]))
        return out

    port_daso.optimize_placement = counted
    phase_s = {}
    try:
        pre = ex.pretrain(PRE_T, policies=("splitplace", "gillis"),
                          device="cpu", daso_theta0=theta0,
                          phase_s=phase_s, **PRE)
    finally:
        port_daso.optimize_placement = ascend
    return ref, gillis, pre, steps, phase_s


def test_pretrain_mab_state_equals_reference(pretrained):
    ref, _, pre, _, _ = pretrained
    _assert_mab(pre.mab_state, ref["mab_state"])
    assert int(pre.mab_state.t[0]) == PRE_T + 1


def test_pretrain_theta_within_tolerance(pretrained):
    ref, _, pre, _, _ = pretrained
    placer = ref["policy_obj"].placer
    assert tuple(pre.daso_cfg) == tuple(placer.cfg)
    _close_layers(pre.daso_theta, placer.theta, THETA_TOL, "theta")
    step, m, v = pre.daso_opt_state
    assert int(step) == int(placer.opt_state.step) > 0
    _close_layers(m, placer.opt_state.m, THETA_TOL, "m")
    _close_layers(v, placer.opt_state.v, THETA_TOL, "v")


def test_pretrain_ran_the_ascent(pretrained):
    _, _, _, steps, phase_s = pretrained
    # the replay window reaches 32 records after interval 32
    assert len(steps) == PRE_T - ref_daso.PLACE_MIN and all(steps)
    for p in ("decide", "place", "physics", "feedback", "ascent",
              "daso_train", "mab_host_read"):
        assert phase_s[p] >= 0.0, p
    assert phase_s["ascent"] <= phase_s["place"]


def test_pretrain_gillis_equals_reference(pretrained):
    _, gillis, pre, _, _ = pretrained
    got, want = pre.gillis_policy.decider, gillis["policy_obj"].decider
    np.testing.assert_array_equal(got.Q, want.Q)
    assert got.eps == want.eps and got.Q.any()


# --------------------------------------------------------------- grids

GRID = dict(seeds=(0, 1), n_intervals=6, substeps=2)


def test_run_grid_soa_and_aggregate_equal_reference():
    pols = ["mc", "gillis", "splitplace"]
    with _mode(), jax.enable_x64(False):
        rg = ref_sp.make_policy("gillis", 50, seed=0)
        want = ref_ex.run_grid(pols, mab_state=ref_mab_state(MAB_LITERAL),
                               gillis_policy=rg, lams=(6.0, 9.0), **GRID)
    pg = port_sp.make_policy("gillis", 50, seed=0, device="cpu")
    got = ex.run_grid(pols, mab_state=MAB_LITERAL, gillis_policy=pg,
                      lams=(6.0, 9.0), device="cpu", **GRID)
    assert got == want
    np.testing.assert_array_equal(pg.decider.Q, rg.decider.Q)
    for by in (("policy",), ("policy", "lam")):
        agg = ex.aggregate(got, by=by)
        assert agg == ref_ex.aggregate(want, by=by)
        assert list(agg) == list(ref_ex.aggregate(want, by=by))


def _small_daso():
    cfg = port_daso.DASOConfig(num_workers=50, max_containers=16,
                               state_features=4, hidden=32, depth=2,
                               place_iters=12)
    gen = torch.Generator().manual_seed(0)
    return cfg, port_daso.init_surrogate(cfg, gen, "cpu")


@pytest.mark.parametrize("mode", ["deploy", "train"])
def test_run_grid_torch_equals_run_grid_batched(mode):
    cfg, theta = _small_daso()
    pols = ["mc", "gillis", "splitplace", "layer+gobi", "random+daso"]
    kw = dict(mab_state=MAB_LITERAL, daso_theta=theta, daso_cfg=cfg,
              lams=(5.0, 6.0), device="cpu", **GRID)
    recs = ex.run_grid(pols, backend="torch", mode=mode, **kw)
    assert [(r["lam"], r["policy"], r["seed"]) for r in recs] == \
        list(itertools.product(kw["lams"], pols, GRID["seeds"]))
    for pol in pols:
        learned = pol in ("gillis", "splitplace")
        want = ex.run_grid_batched(
            pol, mode=mode if learned else "deploy", **kw)
        assert [r for r in recs if r["policy"] == pol] == want


def test_run_grid_torch_pretrains_once(monkeypatch):
    calls = []
    pretrain = ex.pretrain

    def spy(*a, **k):
        calls.append(a)
        return pretrain(*a, **k)

    monkeypatch.setattr(ex, "pretrain", spy)
    kw = dict(n_intervals=3, substeps=2, device="cpu")
    recs = ex.run_grid(["mc", "splitplace", "mab+gobi"], backend="torch",
                       pretrain_intervals=3, **kw)
    assert len(calls) == 1
    ex.run_grid(["mc", "gillis"], backend="torch", pretrain_intervals=3,
                **kw)
    assert len(calls) == 1                  # nothing there consumes it
    pre = pretrain(3, lam=6.0, seed=7, substeps=2, device="cpu")
    for pol in ("splitplace", "mab+gobi"):
        assert [r for r in recs if r["policy"] == pol] == \
            ex.run_grid_batched(pol, pretrain_state=pre, **kw)
    # the products feed run_grid_batched as they are, in both modes
    fields = dict(mab_state=pre.mab_state, daso_theta=pre.daso_theta,
                  daso_cfg=pre.daso_cfg, daso_opt_state=pre.daso_opt_state)
    assert ex.run_grid_batched("splitplace", mode="train",
                               pretrain_state=pre, **kw) == \
        ex.run_grid_batched("splitplace", mode="train", **fields, **kw)


def test_run_trace_torch_equals_a_grid_of_one():
    cfg, theta = _small_daso()
    kw = dict(n_intervals=5, substeps=2, lam=7.0, seed=3, device="cpu",
              daso_theta=theta, daso_cfg=cfg, mab_state=MAB_LITERAL)
    for pol in ("mc", "gillis", "random+daso", "mab"):
        out = ex.run_trace(pol, backend="torch", **kw)
        rec = ex.run_grid_batched(pol, seeds=(3,), lams=(7.0,),
                                  n_intervals=5, substeps=2, device="cpu",
                                  daso_theta=theta, daso_cfg=cfg,
                                  mab_state=MAB_LITERAL)[0]
        assert out["policy"] == pol
        assert {k: float(v) for k, v in _scalars(out).items()} == \
            {k: v for k, v in rec.items() if k not in ("policy", "seed",
                                                       "lam")}


def test_host_policy_runs_the_static_deciders_on_the_host_loop():
    """``host_policy`` pairs a compiled-trace decider with the host
    BestFit placer: ``mc`` that way equals the host ``mc`` policy, and
    every static decider completes tasks on the host loop."""
    from repro_torch.env.torchsim import STATIC_POLICIES, host_policy
    kw = dict(n_intervals=6, lam=8.0, seed=4, substeps=3, device="cpu")
    want = ex.run_trace("mc", **kw)
    got = ex.run_trace(policy=host_policy("mc", seed=9), **kw)
    assert got["policy"] == "mc"
    assert _scalars(got) == _scalars(want)
    for pol in STATIC_POLICIES:
        out = ex.run_trace(policy=host_policy(pol, mab_state=MAB_LITERAL),
                           **kw)
        assert out["tasks_completed"] > 0, pol


def test_unported_paths_name_their_roadmap_items():
    # item 8 (telemetry on backend="torch") is ported: both calls return
    # the interval mode's products
    out = ex.run_trace("mc", backend="torch", telemetry="interval",
                       n_intervals=2, substeps=2, device="cpu")
    assert out["telemetry"]["series"].shape == (2, 18)
    rec, = ex.run_grid_batched("mc", telemetry="interval", n_intervals=2,
                               substeps=2, device="cpu")
    assert "p99_response_s" in rec and "telemetry" not in rec
    # item 9 (streaming) is ported: run_stream serves on the CPU
    rep = ex.run_stream("mc", target_tasks=20, chunk_intervals=2,
                        max_active=64, substeps=2, device="cpu")
    assert rep["offered"] == rep["fed"] + rep["feeder_overflow"]
    assert rep["admitted"] == rep["finished"] + rep["live"]


def test_scaled_fleet_equals_reference():
    for f in (1, 2, 3):
        assert ex.scaled_fleet(f) == ref_ex.scaled_fleet(f)
        assert ex.make_scaled_cluster(f, ram_scale=0.5).ram().tolist() == \
            ref_ex.make_scaled_cluster(f, ram_scale=0.5).ram().tolist()


ENTRY_POINTS = {
    "run_trace_soa": lambda: ex.run_trace("mc", n_intervals=1, substeps=1),
    "run_trace_torch": lambda: ex.run_trace("mc", n_intervals=1,
                                            substeps=1, backend="torch"),
    "pretrain": lambda: ex.pretrain(1, substeps=1),
    "run_grid_soa": lambda: ex.run_grid(["mc"], n_intervals=1, substeps=1),
    "run_grid_torch": lambda: ex.run_grid(["mc"], n_intervals=1, substeps=1,
                                          backend="torch"),
    "make_policy": lambda: port_sp.make_policy("splitplace", 50),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        ENTRY_POINTS[name]()
