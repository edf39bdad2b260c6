"""The port's host deciders and placers against the reference's, on the
CPU.

Two simulators, the reference's ``EdgeSim`` and the port's (equal state
for state, ``test_torch_host_sim.py``), run side by side; the reference's
policy components drive both, and at every interval the port's component
sees the port simulator's copy of the same state:

  * ``BestFitPlacer`` assignments, ``FixedDecider``, ``RandomDecider`` and
    ``GillisDecider`` decisions, and the Gillis Q-table: equal;
  * ``MABDecider`` in train mode (ε-greedy, every draw inside
    ``jax.threefry_partitionable(False)``) and in deploy mode (UCB):
    decisions equal; N and t equal and Q, R, ε, ρ at float32 rtol 1e-6
    after every feedback;
  * ``SurrogatePlacer`` (decision-aware and -blind) with the reference's
    θ0 carried across: assignments equal at every interval (the ascent
    runs from interval 33), the packed surrogate input within atol
    ``X_ATOL``, and the finetuned θ within ``THETA_TOL`` of each leaf's
    largest entry.  A placement that differs is reported with its
    softmax margin on both sides.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
from _torch_ref import MAB_LITERAL, ref_mab_state
from repro.core import splitplace as ref_sp
from repro.env import simulator as ref_sim
from repro_torch.core import splitplace as port_sp
from repro_torch.env import simulator as port_sim

#: float32 tolerances of the DASO placer: the packed input (softmax
#: probabilities after the float32 ascent) and θ after online finetuning
#: (relative to each leaf's largest entry); XLA:CPU and PyTorch sum the
#: float32 products in different orders
X_ATOL = 1e-5
THETA_TOL = 5e-4
MAB_RTOL = 1e-6


def _sims(lam, seed, substeps):
    return (ref_sim.EdgeSim(lam=lam, seed=seed, substeps=substeps),
            port_sim.EdgeSim(lam=lam, seed=seed, substeps=substeps))


def _step(rs, ps, decide, place=None):
    """One interval of both simulators: the reference's decisions and
    placement requests applied to both; returns (tasks, stats) of each."""
    rt, pt = rs.new_interval_tasks(), ps.new_interval_tasks()
    d = decide(rt, pt)
    rs.admit(rt, d)
    ps.admit(pt, d)
    req = place(rs, ps) if place else ref_sp.BestFitPlacer().place(rs)
    rs.apply_placement(req)
    ps.apply_placement(req)
    return (rt, pt), (rs.advance(), ps.advance())


def _mode():
    return jax.threefry_partitionable(False)


@pytest.mark.parametrize("lam,seed", [(6.0, 0), (24.0, 4)])
def test_static_components_equal_reference(lam, seed):
    rs, ps = _sims(lam, seed, 10)
    pairs = {"random": (ref_sp.RandomDecider(seed),
                        port_sp.RandomDecider(seed)),
             "gillis": (ref_sp.GillisDecider(seed),
                        port_sp.GillisDecider(seed)),
             "fixed": (ref_sp.FixedDecider(2), port_sp.FixedDecider(2))}
    ref_bf, port_bf = ref_sp.BestFitPlacer(), port_sp.BestFitPlacer()
    n_assigned = 0

    def decide(rt, pt):
        out = {}
        for name, (r, p) in pairs.items():
            out[name] = r.decide(rt)
            assert [int(x) for x in p.decide(pt)] == \
                [int(x) for x in out[name]], name
        return out["gillis"]

    def place(rs, ps):
        nonlocal n_assigned
        req = ref_bf.place(rs)
        assert port_bf.place(ps) == req
        n_assigned += len(req)
        return req

    for _ in range(25):
        _, (rst, pst) = _step(rs, ps, decide, place)
        for name, (r, p) in pairs.items():
            r.feedback(rst.finished)
            p.feedback(pst.finished)
        np.testing.assert_array_equal(pairs["gillis"][1].Q,
                                      pairs["gillis"][0].Q)
        assert pairs["gillis"][1].eps == pairs["gillis"][0].eps
    assert n_assigned > 0 and pairs["gillis"][0].Q.any()


def _assert_mab_close(port, ref, where):
    for f in ("N", "t"):
        np.testing.assert_array_equal(
            getattr(port, f).cpu().numpy()[0], np.asarray(getattr(ref, f)),
            err_msg=f"{f} {where}")
    for f in ("Q", "R", "eps", "rho"):
        np.testing.assert_allclose(
            getattr(port, f).cpu().numpy()[0], np.asarray(getattr(ref, f)),
            rtol=MAB_RTOL, atol=0, err_msg=f"{f} {where}")


@pytest.mark.parametrize("train", [True, False], ids=["train", "deploy"])
def test_mab_decider_equals_reference(train):
    rs, ps = _sims(6.0, 2, 10)
    with _mode(), jax.enable_x64(False):
        ref = ref_sp.MABDecider(seed=3, train=train,
                                state=ref_mab_state(MAB_LITERAL))
    port = port_sp.MABDecider(seed=3, train=train, state=MAB_LITERAL,
                              device="cpu")
    counts = np.zeros(2, int)

    def decide(rt, pt):
        with _mode(), jax.enable_x64(False):
            d = ref.decide(rt)
        assert port.decide(pt) == d
        counts[:] += np.bincount(np.asarray(d, int), minlength=2)
        return d

    for t in range(18):
        _, (rst, pst) = _step(rs, ps, decide)
        with _mode(), jax.enable_x64(False):
            ref.feedback(rst.finished)
            want = ref.interval_reward(rst.finished)
        port.feedback(pst.finished)
        assert port.interval_reward(pst.finished) == want
        _assert_mab_close(port.state, ref.state, f"after interval {t}")
    assert counts.all()               # both arms were taken


def _row_margin(x, cfg, i):
    """Softmax margin (top-1 − top-2) of container row ``i`` in a packed
    surrogate input."""
    lo = cfg.num_workers * cfg.state_features + i * cfg.num_workers
    row = np.sort(np.asarray(x[lo:lo + cfg.num_workers]))
    return float(row[-1] - row[-2])


@pytest.mark.parametrize("aware", [True, False], ids=["daso", "gobi"])
def test_surrogate_placer_equals_reference(aware):
    rs, ps = _sims(6.0, 5, 4)
    C = 16
    with jax.enable_x64(False):
        ref = ref_sp.SurrogatePlacer(rs.cluster.n, aware, seed=1,
                                     max_containers=C)
    theta0 = [{k: np.asarray(v) for k, v in layer.items()}
              for layer in ref.theta]
    port = port_sp.SurrogatePlacer(ps.cluster.n, aware, seed=1,
                                   max_containers=C, device="cpu",
                                   daso_theta0=theta0)
    rng = np.random.RandomState(9)
    ascents = 0

    def decide(rt, pt):
        return list(rng.randint(0, 3, len(rt)))

    def place(rs, ps):
        nonlocal ascents
        ascents += len(ref.replay_x) >= 32
        with jax.enable_x64(False):
            req = ref.place(rs)
        got = port.place(ps)
        rx, px = np.asarray(ref._last_x), port._last_x.numpy()
        diff = [(k, req[k], got[k]) for k in req if got.get(k) != req[k]]
        if diff:
            rows = {k: i for i, (task, f) in enumerate(rs.containers()[:C])
                    for k in [(task.id, f.idx)]}
            raise AssertionError(
                "placements differ: " + ", ".join(
                    f"{k}: ref {r} port {p}, margins ref "
                    f"{_row_margin(rx, ref.cfg, rows[k]):.3g} port "
                    f"{_row_margin(px, port.cfg, rows[k]):.3g}"
                    for k, r, p in diff))
        assert got == req
        np.testing.assert_allclose(px, rx, rtol=0, atol=X_ATOL)
        return req

    for _ in range(36):
        _, (rst, pst) = _step(rs, ps, decide, place)
        with jax.enable_x64(False):
            ref.feedback(ref_sp.MABDecider.interval_reward(None,
                                                           rst.finished),
                         rst, rs)
        port.feedback(port_sp.interval_reward(pst.finished), pst, ps)
    assert ascents >= 1
    assert int(port.opt_state.step) == int(ref.opt_state.step) > 0
    for lr, lp in zip(ref.theta, port.theta):
        for k in ("w", "b"):
            want = np.asarray(lr[k])
            np.testing.assert_allclose(
                lp[k].numpy(), want, rtol=0,
                atol=THETA_TOL * np.abs(want).max())


def test_host_decider_takes_pretrain_state_forms():
    """A port state with a grid axis of 1, or the reference's fields as
    NumPy, seed a host MAB decider; a wider grid is refused."""
    from repro_torch.core import mab as port_mab
    one = port_mab.mab_state_from_numpy(MAB_LITERAL, device="cpu")
    a = port_sp.MABDecider(state=one, train=False, device="cpu").state
    b = port_sp.MABDecider(state=MAB_LITERAL, train=False,
                           device="cpu").state
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    wide = port_mab.mab_state_from_numpy(MAB_LITERAL, grid=2, device="cpu")
    with pytest.raises(ValueError, match="one-cell"):
        port_sp.MABDecider(state=wide, device="cpu")
