"""The port's per-object simulator (``repro_torch.env.legacy_sim``).

  * ``tests/test_soa_equivalence.py``'s contract on the port: the
    structure-of-arrays ``EdgeSim`` reproduces ``LegacyEdgeSim`` trace for
    trace, bit for bit (finished-task tuples, responses, accuracies,
    per-interval energy, utilization, completion census, state features),
    both placed by the port's ``BestFitPlacer``, whose per-object census
    serves the legacy simulator;
  * the port's ``LegacyEdgeSim`` and ``LegacyBestFitPlacer`` against the
    reference's (``repro.env.legacy_sim``, which imports no JAX), imported
    in process: the same traces to every digit.
"""
from __future__ import annotations

import numpy as np
import pytest

from repro_torch.core.splitplace import BestFitPlacer
from repro_torch.env.legacy_sim import LegacyBestFitPlacer, LegacyEdgeSim
from repro_torch.env.simulator import EdgeSim
from repro_torch.env.workload import COMPRESSED, LAYER, SEMANTIC, Task


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These cases are many small CPU ops: one intra-op thread runs them
    about as fast and leaves the other cores to parallel test workers."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_trace(cls, decisions_of, n_intervals, lam, seed, substeps,
              ram_squeeze=1.0, placer=None):
    """Drive one simulator class through a BestFit trace; returns the
    trace record."""
    sim = cls(lam=lam, seed=seed, substeps=substeps)
    if ram_squeeze != 1.0:
        sim._ram = sim._ram * ram_squeeze
    placer = placer or BestFitPlacer()
    rec = dict(finished=[], energy=[], util=[], pwt=[], active=[],
               waiting=[])
    for _ in range(n_intervals):
        tasks = sim.new_interval_tasks()
        sim.admit(tasks, decisions_of(tasks))
        sim.apply_placement(placer.place(sim))
        stats = sim.advance()
        rec["finished"] += [(tk.id, tk.app, tk.decision, tk.response_s,
                             tk.accuracy, tk.wait_s) for tk in stats.finished]
        rec["energy"].append(stats.energy_j)
        rec["util"].append(stats.cpu_util.copy())
        rec["pwt"].append(stats.per_worker_tasks.copy())
        rec["active"].append(stats.num_active)
        rec["waiting"].append(stats.num_waiting)
    return rec


def assert_traces_equal(a, b):
    assert a["finished"] == b["finished"]
    assert a["energy"] == b["energy"]
    assert a["active"] == b["active"]
    assert a["waiting"] == b["waiting"]
    np.testing.assert_array_equal(np.stack(a["util"]), np.stack(b["util"]))
    np.testing.assert_array_equal(np.stack(a["pwt"]), np.stack(b["pwt"]))


def _mixed(tasks):
    return [i % 3 for i in range(len(tasks))]


@pytest.mark.parametrize("seed", [0, 3])
def test_mixed_decisions_trace_matches(seed):
    """All three split decisions interleaved, moderate load."""
    kw = dict(n_intervals=12, lam=6.0, seed=seed, substeps=10)
    a = run_trace(LegacyEdgeSim, _mixed, **kw)
    b = run_trace(EdgeSim, _mixed, **kw)
    assert len(a["finished"]) > 0
    assert_traces_equal(a, b)


def test_overload_waiting_and_swap_paths_match():
    """High λ and squeezed RAM: failed placements (waiting tasks) and RAM
    over-subscription (the swap slowdown)."""
    dec = lambda tasks: [COMPRESSED] * len(tasks)       # noqa: E731
    kw = dict(n_intervals=10, lam=12.0, seed=1, substeps=8, ram_squeeze=0.5)
    a = run_trace(LegacyEdgeSim, dec, **kw)
    b = run_trace(EdgeSim, dec, **kw)
    assert max(a["waiting"] + a["active"]) > 0
    assert_traces_equal(a, b)


@pytest.mark.parametrize("decision", [LAYER, SEMANTIC, COMPRESSED])
def test_single_decision_traces_match(decision):
    dec = lambda tasks: [decision] * len(tasks)         # noqa: E731
    kw = dict(n_intervals=8, lam=4.0, seed=2, substeps=6)
    assert_traces_equal(run_trace(LegacyEdgeSim, dec, **kw),
                        run_trace(EdgeSim, dec, **kw))


def test_manual_chain_progression_matches():
    """A hand-placed layer chain: stage advance and transfer timing."""
    def one(cls):
        sim = cls(lam=0, seed=0, substeps=10)
        t = Task(id=0, app=1, batch=40000, sla_s=1e9, arrival_s=0.0)
        sim.gen.realize(t, LAYER)
        sim.active.append(t)
        t.placed = True
        for i, f in enumerate(t.fragments):
            f.worker = (i * 7) % sim.cluster.n
        stages = []
        for _ in range(60):
            sim.advance()
            stages.append(t.stage)
            if t.done:
                return stages, t.response_s
        raise AssertionError("chain did not finish")

    assert one(LegacyEdgeSim) == one(EdgeSim)


def test_state_features_match():
    """The placers' observation after a few mixed intervals."""
    def one(cls):
        sim = cls(lam=5.0, seed=4, substeps=6)
        placer = BestFitPlacer()
        for _ in range(5):
            tasks = sim.new_interval_tasks()
            sim.admit(tasks, _mixed(tasks))
            sim.apply_placement(placer.place(sim))
            sim.advance()
        return sim.state_features()

    np.testing.assert_array_equal(one(LegacyEdgeSim), one(EdgeSim))


@pytest.mark.parametrize("lam,squeeze", [(6.0, 1.0), (12.0, 0.5)])
def test_bestfit_census_branches_agree(lam, squeeze):
    """BestFit's per-object census (the legacy simulator) and its
    structure-of-arrays census give the same assignment at every interval
    of one trace, and so does the per-object ``LegacyBestFitPlacer``."""
    sims = [EdgeSim(lam=lam, seed=6, substeps=6),
            LegacyEdgeSim(lam=lam, seed=6, substeps=6)]
    for sim in sims:
        sim._ram = sim._ram * squeeze
    placer, legacy = BestFitPlacer(), LegacyBestFitPlacer()
    n_new = 0
    for _ in range(10):
        outs = []
        for sim in sims:
            tasks = sim.new_interval_tasks()
            sim.admit(tasks, _mixed(tasks))
            outs.append(placer.place(sim))
        assert outs[0] == outs[1]
        # the legacy placer also names the placed fragments' workers
        full = legacy.place(sims[1])
        assert {k: v for k, v in full.items() if k in outs[1]} == outs[1]
        n_new += len(outs[1])
        for sim, out in zip(sims, outs):
            sim.apply_placement(out)
            sim.advance()
    assert n_new > 0


@pytest.mark.parametrize("seed", [0, 5])
def test_legacy_matches_reference_legacy(seed):
    """The port's LegacyEdgeSim + LegacyBestFitPlacer against the
    reference's, at a moderate and an overloaded λ."""
    from repro.env import legacy_sim as ref
    for lam, squeeze in ((6.0, 1.0), (12.0, 0.5)):
        kw = dict(n_intervals=10, lam=lam, seed=seed, substeps=8,
                  ram_squeeze=squeeze)
        a = run_trace(ref.LegacyEdgeSim, _mixed,
                      placer=ref.LegacyBestFitPlacer(), **kw)
        b = run_trace(LegacyEdgeSim, _mixed, placer=LegacyBestFitPlacer(),
                      **kw)
        assert len(a["finished"]) > 0
        assert_traces_equal(a, b)


def test_reference_legacy_state_features_match():
    from repro.env import legacy_sim as ref

    def one(cls, placer):
        sim = cls(lam=7.0, seed=9, substeps=6)
        for _ in range(6):
            tasks = sim.new_interval_tasks()
            sim.admit(tasks, _mixed(tasks))
            sim.apply_placement(placer.place(sim))
            sim.advance()
        return sim.state_features()

    np.testing.assert_array_equal(
        one(ref.LegacyEdgeSim, ref.LegacyBestFitPlacer()),
        one(LegacyEdgeSim, LegacyBestFitPlacer()))
