"""The port's host simulator against the reference's, on the CPU.

``repro_torch.env.simulator.EdgeSim`` (over ``env/soa.py``) and the
reference's ``repro.env.simulator.EdgeSim`` are NumPy programs that must
compute the same floats in the same order, so everything here is held
**equal**, not close: both simulators are driven side by side for 40
intervals (arrivals, the same split decisions, the same placement
requests, the advance), and at every interval the finished-task tuples,
the state features before and after the advance, the container
placements, energy, cost, utilization and per-worker counts must match
bit for bit.  Then the ``MetricsAccumulator`` summaries, the exact
percentiles and the ``telemetry=True`` series.

The cases cover BestFit requests at λ=24 (the fleet overloads and the
active set grows), random requests that oversubscribe worker RAM (the
sequential repair), fewer substeps, and λ=6 on a 100-worker scaled fleet
(tasks retire and the store compacts).
"""
from __future__ import annotations

import numpy as np
import pytest

from repro.core import splitplace as ref_sp
from repro.env import cluster as ref_cluster
from repro.env import metrics as ref_metrics
from repro.env import simulator as ref_sim
from repro.env import soa as ref_soa
from repro.env import workload as ref_wl
from repro_torch.env import cluster as port_cluster
from repro_torch.env import metrics as port_metrics
from repro_torch.env import simulator as port_sim
from repro_torch.env import soa as port_soa
from repro_torch.env import workload as port_wl

N_INTERVALS = 40

#: (λ, seed, substeps, placement, fleet factor)
CASES = [(24.0, 0, 30, "bestfit", 1), (24.0, 1, 10, "random", 1),
         (6.0, 3, 30, "bestfit", 2)]


def _fleet(module, factor):
    return module.make_cluster(fleet=[(name, q * factor)
                                      for name, q in module.FLEET_SPEC])


def _finished(stats):
    return [(t.id, t.app, t.batch, t.decision, t.sla_s, t.response_s,
             t.accuracy, t.wait_s) for t in stats.finished]


def _placements(sim):
    return [(task.id, f.idx, f.worker, f.instr_left, f.transfer_left)
            for task, f in sim.containers()]


def _random_requests(rng, sim, n):
    """A random worker for every unplaced live fragment: oversubscribes
    RAM on some workers, so the simulator's sequential repair runs."""
    return {(task.id, f.idx): int(rng.randint(n))
            for task, f in sim.containers() if f.worker < 0}


def _drive(lam, seed, substeps, placement, factor):
    """Both simulators side by side; yields per-interval observations of
    each (reference, port)."""
    rs = ref_sim.EdgeSim(cluster=_fleet(ref_cluster, factor), lam=lam,
                         seed=seed, substeps=substeps)
    ps = port_sim.EdgeSim(cluster=_fleet(port_cluster, factor), lam=lam,
                          seed=seed, substeps=substeps)
    placer = ref_sp.BestFitPlacer()
    rng = np.random.RandomState(seed + 100)
    accs = (ref_metrics.MetricsAccumulator(telemetry=True),
            port_metrics.MetricsAccumulator(telemetry=True))
    for t in range(N_INTERVALS):
        rt, pt = rs.new_interval_tasks(), ps.new_interval_tasks()
        assert [(x.id, x.app, x.batch, x.sla_s) for x in rt] == \
            [(x.id, x.app, x.batch, x.sla_s) for x in pt]
        decisions = [(t + i) % 3 for i in range(len(rt))]
        rs.admit(rt, decisions)
        ps.admit(pt, decisions)
        req = placer.place(rs) if placement == "bestfit" \
            else _random_requests(rng, rs, rs.cluster.n)
        rs.apply_placement(req)
        ps.apply_placement(req)
        obs = []
        for sim, acc in zip((rs, ps), accs):
            feats = sim.state_features()
            places = _placements(sim)
            stats = sim.advance()
            acc.update(stats)
            obs.append({"feats": feats, "after": sim.state_features(),
                        "places": places, "finished": _finished(stats),
                        "energy": stats.energy_j, "cost": stats.cost_usd,
                        "util": stats.cpu_util, "pwt": stats.per_worker_tasks,
                        "active": stats.num_active, "now": sim.now,
                        "store": sim.fragment_store().n_tasks})
        yield t, obs
    yield None, accs


@pytest.mark.parametrize("case", CASES, ids=[
    f"lam{c[0]:g}-seed{c[1]}-sub{c[2]}-{c[3]}-x{c[4]}" for c in CASES])
def test_edgesim_equals_reference(case, monkeypatch):
    calls = []
    seq = port_sim.EdgeSim._apply_placement_sequential

    def counted(self, assignment):
        calls.append(len(assignment))
        return seq(self, assignment)

    monkeypatch.setattr(port_sim.EdgeSim, "_apply_placement_sequential",
                        counted)
    compacted = False
    n_fin, last_store = 0, 0
    for t, obs in _drive(*case):
        if t is None:
            racc, pacc = obs
            break
        r, p = obs
        for key in ("feats", "after", "util", "pwt"):
            np.testing.assert_array_equal(p[key], r[key],
                                          err_msg=f"{key} at interval {t}")
        for key in ("places", "finished", "energy", "cost", "active", "now",
                    "store"):
            assert p[key] == r[key], f"{key} at interval {t}"
        compacted |= r["store"] < last_store
        last_store = r["store"]
        n_fin += len(r["finished"])
    assert n_fin > 0
    # λ=6 on the scaled fleet retires enough rows to compact the store;
    # random requests oversubscribe RAM, so the sequential repair runs
    assert compacted == (case[4] == 2)
    assert calls or case[3] != "random"
    assert pacc.summary() == racc.summary()
    assert pacc.percentiles() == racc.percentiles()
    np.testing.assert_array_equal(pacc.telemetry_series(),
                                  racc.telemetry_series())
    cols = list(port_metrics.TELEMETRY_COLS)
    assert cols == list(ref_metrics.TELEMETRY_COLS)
    assert port_metrics.series_percentiles(pacc.telemetry_series(), cols) \
        == ref_metrics.series_percentiles(racc.telemetry_series(), cols)


def test_task_views_follow_the_store():
    """A realized task's objects become views into the store on adoption,
    keep object writes coherent with the arrays, and keep their final
    values when unbound or compacted away, as the reference's do."""
    out = []
    for wl, soa in ((ref_wl, ref_soa), (port_wl, port_soa)):
        gen = wl.WorkloadGenerator(lam=8.0, seed=5)
        tasks = gen.arrivals(0.0)
        for i, task in enumerate(tasks):
            gen.realize(task, i % 3)
        st = soa.SoAStore(frag_cap=2, task_cap=1)      # forces growth
        for task in tasks:
            st.adopt_task(task)
        f = tasks[0].fragments[-1]
        f.worker = 7
        f.instr_left = 12.5
        tasks[1].placed = True
        obs = [int(st.worker[f._row]), float(st.instr_left[f._row]),
               bool(st.placed[tasks[1]._trow]), st.is_bound(tasks[0])]
        st.unbind_task(tasks[0])
        obs += [f.worker, f.instr_left, f._store is None, tasks[0].done]
        st.task_done[tasks[2]._trow] = True
        st.compact()
        obs += [st.n_tasks, st.n_fragments, tasks[2].done,
                [t._trow for t in tasks[3:]],
                [(t.id, t.chain, t.stage, t.placed) for t in tasks]]
        out.append(obs)
    assert out[1] == out[0]
    assert out[0][:4] == [7, 12.5, True, True]


def test_series_percentiles_equal_reference():
    rng = np.random.RandomState(0)
    cols = list(port_metrics.TELEMETRY_COLS)
    series = np.abs(rng.normal(size=(30, len(cols)))) * 100
    series[:, cols.index("n_fin")] = rng.randint(0, 5, 30)
    series[::4, cols.index("n_fin")] = 0
    assert port_metrics.series_percentiles(series, cols) == \
        ref_metrics.series_percentiles(series, cols)
    empty = np.zeros((3, len(cols)))
    assert port_metrics.series_percentiles(empty, cols) == \
        ref_metrics.series_percentiles(empty, cols)
