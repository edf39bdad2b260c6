"""Replay a compiled trace through the host ``EdgeSim``: the parity
oracles of the interval program (the port of
``repro.env.jaxsim.reference``).

The compiled trace carries pre-realized fragments and pre-sampled
accuracies, so a replay swaps the simulator's workload generator for a
scripted source that deals the identical tasks interval by interval.
Mobility needs no scripting: ``EdgeSim`` seeds its own ``MobilityModel``
with ``seed + 1`` exactly as the trace compiler did, so the bandwidth
multipliers line up by construction.

The learned oracles take each interval's decisions and placements with
the port's own learner functions (``core/mab``, ``core/daso``, the
threefry draws), called once per interval on CPU tensors of one cell, in
the dtypes the interval program's engines use.  The simulator, the
BestFit heuristic and the metrics are the NumPy host ones, so an error
the interval program shares between the card and the CPU shows here.

They are host programs and references, not entry points: they take no
device and run on the CPU.  Each returns the summary schema of the
matching ``driver.run_trace_arrays*``, and with ``telemetry="interval"``
the per-interval series (``TELEMETRY_COLS`` plus the engine's columns)
and exact response/wait percentiles (``percentile_err_s`` 0).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import daso as daso_mod
from repro_torch.core import mab as mab_mod
from repro_torch.core.splitplace import BestFitPlacer, mab_state_on
from repro_torch.env.cluster import Cluster
from repro_torch.env.metrics import TELEMETRY_COLS, MetricsAccumulator
from repro_torch.env.simulator import EdgeSim
from repro_torch.env.torchsim.arrays import TraceArrays
from repro_torch.env.torchsim.driver import (GILLIS_HP, MAB_HP,
                                             STATIC_DASO_ARMS, TRAIN_HP,
                                             _theta_on, gillis_layer_ref,
                                             trace_train_key)
from repro_torch.env.torchsim.engines import (GILLIS_TELEMETRY_COLS,
                                              MAB_TELEMETRY_COLS,
                                              TRAIN_DASO_TELEMETRY_COLS)
from repro_torch.env.workload import LAYER, Fragment, Task
from repro_torch.kernels.threefry import threefry_rows

CPU = torch.device("cpu")
f8 = torch.float64


def _attach_telemetry(out, acc, eng_cols=(), eng_rows=None):
    """The host side of the interval mode's summary extras: EXACT
    percentiles (the host keeps every sample, so the binning error bound
    is 0), plus the per-interval series: base ``TELEMETRY_COLS`` rows
    from the accumulator with the engine's columns appended."""
    out.update(acc.percentiles())
    out["percentile_err_s"] = 0.0
    series = acc.telemetry_series()
    if eng_cols:
        series = np.concatenate(
            [series, np.asarray(eng_rows, np.float64).reshape(
                series.shape[0], len(eng_cols))], axis=1)
    out["telemetry"] = {"cols": list(TELEMETRY_COLS) + list(eng_cols),
                        "series": series}
    return out


class _ScriptedSource:
    """Stands in for ``WorkloadGenerator``: deals the compiled trace's
    tasks per interval and replays its pre-sampled accuracies."""

    def __init__(self, trace: TraceArrays):
        self._acc = {}
        self._queues = []
        for t in range(trace.n_intervals):
            tasks = []
            for a in range(trace.max_arrivals):
                if not trace.arr_valid[t, a]:
                    continue
                tid = int(trace.arr_id[t, a])
                task = Task(id=tid, app=int(trace.arr_app[t, a]),
                            batch=int(trace.arr_batch[t, a]),
                            sla_s=float(trace.arr_sla[t, a]),
                            arrival_s=float(trace.arr_arrival_s[t, a]),
                            decision=int(trace.arr_decision[t, a]),
                            chain=bool(trace.arr_chain[t, a]))
                for i in range(int(trace.arr_nfrag[t, a])):
                    task.fragments.append(Fragment(
                        tid, i, float(trace.frag_instr[t, a, i]),
                        float(trace.frag_ram[t, a, i]),
                        float(trace.frag_out[t, a, i])))
                self._acc[tid] = float(trace.arr_acc[t, a])
                tasks.append(task)
            self._queues.append(tasks)
        self._t = 0

    def arrivals(self, now_s: float):
        if self._t >= len(self._queues):
            return []
        tasks = self._queues[self._t]
        self._t += 1
        return tasks

    def accuracy_of(self, task) -> float:
        return self._acc[task.id]


def _sim(trace, cluster, gen):
    sim = EdgeSim(cluster=cluster, lam=trace.lam, seed=trace.seed,
                  interval_s=trace.interval_s, substeps=trace.substeps)
    sim.gen = gen
    return sim


def replay_trace_edgesim(trace: TraceArrays,
                         cluster: Optional[Cluster] = None,
                         placer=None, telemetry: str = "summary") -> dict:
    """Drive ``EdgeSim`` + BestFit through the compiled trace; returns the
    summary schema of ``driver.run_trace_arrays``."""
    tel = telemetry == "interval"
    sim = _sim(trace, cluster, _ScriptedSource(trace))
    placer = placer or BestFitPlacer()
    acc = MetricsAccumulator(interval_s=trace.interval_s, telemetry=tel)
    for _ in range(trace.n_intervals):
        tasks = sim.new_interval_tasks()
        sim.admit(tasks, [0] * len(tasks))   # decisions pre-realized
        sim.apply_placement(placer.place(sim))
        acc.update(sim.advance())
    out = acc.summary()
    out["dropped_tasks"] = 0
    if tel:
        _attach_telemetry(out, acc)
    return out


# ---------------------------------------------- learned-policy oracles
#
# The learned policies of the interval program are pinned against the
# same host simulator: a replay drives ``EdgeSim`` through a *dual*
# compiled trace, taking each interval's split decisions and placements
# with the port's learner functions in the interval program's order, so
# both see the same decision and placement trajectory.


class _AccuracyMap:
    """Minimal ``WorkloadGenerator`` stand-in for a learned replay: only
    ``accuracy_of`` is consulted (tasks are built pre-realized)."""

    def __init__(self):
        self._acc = {}

    def accuracy_of(self, task) -> float:
        return self._acc[task.id]


def _tasks_of_interval(trace, t, decisions, acc_map):
    """Materialize interval ``t``'s arrivals under the given per-row
    split *arm* indices (the V axis of the dual trace arrays); each task's
    recorded decision code comes from ``trace.variants``: (LAYER,
    SEMANTIC) for MAB traces, (LAYER, COMPRESSED) for Gillis."""
    variants = getattr(trace, "variants", (0, 1))
    tasks = []
    rows = np.nonzero(trace.arr_valid[t])[0]
    for a, d in zip(rows, decisions):
        tid = int(trace.arr_id[t, a])
        task = Task(id=tid, app=int(trace.arr_app[t, a]),
                    batch=int(trace.arr_batch[t, a]),
                    sla_s=float(trace.arr_sla[t, a]),
                    arrival_s=float(trace.arr_arrival_s[t, a]),
                    decision=int(variants[d]),
                    chain=bool(trace.var_chain[t, a, d]))
        for i in range(int(trace.var_nfrag[t, a, d])):
            task.fragments.append(Fragment(
                tid, i, float(trace.var_instr[t, a, d, i]),
                float(trace.var_ram[t, a, d, i]),
                float(trace.var_out[t, a, d, i])))
        acc_map._acc[tid] = float(trace.var_acc[t, a, d])
        tasks.append(task)
    return tasks


def _row(x, dtype=None):
    """A NumPy vector as one cell's (1, M) CPU tensor."""
    t = torch.from_numpy(np.ascontiguousarray(x))[None]
    return t if dtype is None else t.to(dtype)


def _sla_norm(trace, t, rows):
    """Arrival SLAs batch-normalized as the MAB decides on them (float64
    math, float32 cast)."""
    return (trace.arr_sla[t, rows] * 40000.0
            / np.maximum(trace.arr_batch[t, rows].astype(np.float64),
                         1.0)).astype(np.float32)


def _daso_rows_host(sim, cfg, warm):
    """Host mirror of ``kernels._daso_rows``: the first ``max_containers``
    live fragments in ``EdgeSim.containers`` (admission) order with their
    warm-start workers and clipped decisions."""
    conts = sim.containers()
    C = cfg.max_containers
    head = conts[:C]
    warm_w = np.zeros(C, np.int64)
    rowvalid = np.zeros(C, bool)
    dec = np.zeros(C, np.int32)
    for i, (task, f) in enumerate(head):
        rowvalid[i] = True
        dec[i] = min(task.decision, 1)
        w = f.worker if f.worker >= 0 else warm[(task.id, f.idx)]
        warm_w[i] = w
    return head, warm_w, rowvalid, dec


def _daso_logits(sim, cfg, warm):
    """The DASO stage's rows, warm-start logits (float64) and worker
    features, as one cell's tensors."""
    head, warm_w, rowvalid, dec = _daso_rows_host(sim, cfg, warm)
    valid = _row(rowvalid)
    logits = daso_mod.warm_start_logits(cfg, _row(warm_w), valid, f8)
    feat = _row(sim.state_features(), f8)
    return head, logits, feat, _row(dec), valid


def _with_rows(warm, head, logits):
    """``warm`` with each container row's fragment moved to the argmax
    worker of its logits."""
    assign = torch.argmax(logits[0], dim=-1).numpy()
    out = dict(warm)
    for i, (task, f) in enumerate(head):
        out[(task.id, f.idx)] = int(assign[i])
    return out


def _daso_assignment(sim, cfg, theta, warm):
    """Host mirror of ``kernels.daso_requests``: the same container
    enumeration (admission order, ``max_containers`` head), the same
    warm-start logits and the same float64 ascent, so both sides feed the
    feasibility repair identical requests."""
    head, logits, feat, dec, valid = _daso_logits(sim, cfg, warm)
    p_opt, _, _ = daso_mod.optimize_placement_grid(cfg, theta, feat, logits,
                                                   dec, valid)
    return _with_rows(warm, head, p_opt)


def _mab_feedback(mab, fin, phi, gamma, k_rbed):
    """Algorithm-1 bookkeeping over the interval's finished tasks (sorted
    by id), with the Q step rounded twice, as the reference computes it
    op by op."""
    batch = np.maximum(np.array([task.batch for task in fin], np.float64),
                       1.0)
    return mab_mod.end_of_interval_masked(
        mab,
        _row(np.array([task.app for task in fin], np.int32)),
        _row((np.array([task.sla_s for task in fin], np.float64)
              * 40000.0 / batch).astype(np.float32)),
        _row((np.array([task.response_s for task in fin], np.float64)
              * 40000.0 / batch).astype(np.float32)),
        _row(np.array([task.accuracy for task in fin], np.float32)),
        _row(np.array([min(task.decision, 1) for task in fin], np.int32)),
        torch.ones((1, len(fin)), dtype=torch.bool), phi, gamma, k_rbed,
        fused_q=False)


def _mab_row(mab):
    """The MAB engines' telemetry columns (``MAB_TELEMETRY_COLS``)."""
    return [float(mab.eps[0]), float(mab.rho[0]),
            float(mab.N[0, :, 0].sum()), float(mab.N[0, :, 1].sum())]


def _mab_out(out, mab):
    out["dropped_tasks"] = 0
    out["mab_eps"] = float(mab.eps[0])
    out["mab_rho"] = float(mab.rho[0])
    out["mab_t"] = int(mab.t[0])
    return out


def _finished(stats):
    return sorted(stats.finished, key=lambda task: task.id)


def replay_trace_edgesim_trained(trace, mab_state, daso_theta=None,
                                 daso_cfg=None, daso_opt_state=None,
                                 cluster: Optional[Cluster] = None,
                                 mab_hp=None, train_hp=None,
                                 telemetry: str = "summary") -> dict:
    """Drive ``EdgeSim`` through a dual compiled trace under the full
    training loop: ε-greedy MAB decisions (eq. 6) from the trace key's
    per-row threefry draws, Algorithm-1 feedback with RBED ε-decay, and,
    with ``daso_cfg``, online DASO finetuning: one (packed placement
    input, O^P) replay-window record per interval and
    ``train_epoch_weighted`` steps.  The parity oracle of
    ``driver.run_*_arrays_trained``; returns its summary schema including
    the final MAB scalars and (DASO runs) the finetuned θ under
    ``"daso_theta"``."""
    _, phi, gamma, k_rbed = mab_hp or MAB_HP
    alpha, beta, train_steps, place_min, train_min = train_hp or TRAIN_HP
    tel = telemetry == "interval"
    eng_rows = []
    acc_map = _AccuracyMap()
    sim = _sim(trace, cluster, acc_map)
    bestfit = BestFitPlacer()
    acc = MetricsAccumulator(interval_s=trace.interval_s, telemetry=tel)
    mab = mab_state_on(mab_state, CPU)
    key = trace_train_key(trace.seed)[None]
    if daso_cfg is not None:
        theta = daso_mod.theta_cells(daso_theta, 1, CPU)
        opt = daso_mod.opt_state_cells(daso_opt_state, theta, 1, CPU)
        win = daso_mod.window_init(daso_cfg, 1, CPU)
    for t in range(trace.n_intervals):
        rows = np.nonzero(trace.arr_valid[t])[0]
        decisions = np.zeros(0, np.int32)
        if len(rows):
            d, _ = mab_mod.decide_train_rows(
                mab, key, t, _row(_sla_norm(trace, t, rows)),
                _row(trace.arr_app[t, rows]))
            decisions = d[0].numpy()
        tasks = _tasks_of_interval(trace, t, decisions, acc_map)
        sim.admit(tasks, decisions)
        warm = bestfit.place(sim)
        if daso_cfg is not None:
            head, p_used, feat, dec, valid = _daso_logits(sim, daso_cfg,
                                                          warm)
            # cold-start gate: warm logits as they are until place_min
            # records exist; one record lands per interval, so the
            # pre-append count is t, the interval program's gate
            if t >= place_min:
                p_used, _, _ = daso_mod.optimize_placement_grid(
                    daso_cfg, theta, feat, p_used, dec, valid)
            x = daso_mod.pack_input_grid(daso_cfg, feat, p_used, dec, valid)
            warm = _with_rows(warm, head, p_used)
        sim.apply_placement(warm)
        stats = sim.advance()
        fin = _finished(stats)
        mab = _mab_feedback(mab, fin, phi, gamma, k_rbed)
        if daso_cfg is not None:
            mask = torch.ones((1, len(fin)), dtype=torch.bool)
            y = daso_mod.op_objective(
                _row(np.array([task.response_s for task in fin],
                              np.float64)),
                _row(np.array([task.sla_s for task in fin], np.float64)),
                _row(np.array([task.accuracy for task in fin], np.float64)),
                mask, _row(np.asarray(stats.cpu_util, np.float64)),
                trace.interval_s, alpha, beta)
            win = daso_mod.window_append(win, x, y)
            theta, opt = daso_mod.finetune_window(daso_cfg, theta, opt, win,
                                                  train_steps, train_min)
        if tel:
            # sampled where the engine's telemetry_row is: end of
            # feedback, after the finetune
            row = _mab_row(mab)
            if daso_cfg is not None:
                row += [float(win["count"]),
                        float(daso_mod.window_loss(daso_cfg, theta,
                                                   win)[0])]
            eng_rows.append(row)
        acc.update(stats)
    out = _mab_out(acc.summary(), mab)
    if daso_cfg is not None:
        out["daso_theta"] = [{k: v[0].numpy() for k, v in layer.items()}
                             for layer in theta]
    if tel:
        cols = MAB_TELEMETRY_COLS if daso_cfg is None \
            else TRAIN_DASO_TELEMETRY_COLS
        _attach_telemetry(out, acc, cols, eng_rows)
    return out


def replay_trace_edgesim_learned(trace, mab_state, daso_theta=None,
                                 daso_cfg=None,
                                 cluster: Optional[Cluster] = None,
                                 mab_hp=None,
                                 telemetry: str = "summary") -> dict:
    """Drive ``EdgeSim`` through a dual compiled trace under the learned
    deploy policy (online UCB MAB decider; the DASO placer when
    ``daso_cfg`` is given, BestFit otherwise): the parity oracle of
    ``driver.run_trace_arrays_learned``.  Returns its summary schema,
    including the final MAB scalars."""
    ucb_c, phi, gamma, k_rbed = mab_hp or MAB_HP
    tel = telemetry == "interval"
    eng_rows = []
    acc_map = _AccuracyMap()
    sim = _sim(trace, cluster, acc_map)
    bestfit = BestFitPlacer()
    acc = MetricsAccumulator(interval_s=trace.interval_s, telemetry=tel)
    mab = mab_state_on(mab_state, CPU)
    theta = _theta_on(daso_theta, CPU) if daso_cfg is not None else None
    for t in range(trace.n_intervals):
        rows = np.nonzero(trace.arr_valid[t])[0]
        d, _ = mab_mod.decide_ucb_batch(
            mab, _row(_sla_norm(trace, t, rows)),
            _row(trace.arr_app[t, rows]), ucb_c)
        decisions = d[0].numpy()
        tasks = _tasks_of_interval(trace, t, decisions, acc_map)
        sim.admit(tasks, decisions)
        warm = bestfit.place(sim)
        if daso_cfg is not None:
            warm = _daso_assignment(sim, daso_cfg, theta, warm)
        sim.apply_placement(warm)
        stats = sim.advance()
        mab = _mab_feedback(mab, _finished(stats), phi, gamma, k_rbed)
        if tel:
            eng_rows.append(_mab_row(mab))
        acc.update(stats)
    out = _mab_out(acc.summary(), mab)
    if tel:
        _attach_telemetry(out, acc, MAB_TELEMETRY_COLS, eng_rows)
    return out


def replay_trace_edgesim_static_daso(trace, policy: str, daso_theta=None,
                                     daso_cfg=None,
                                     cluster: Optional[Cluster] = None,
                                     telemetry: str = "summary") -> dict:
    """Drive ``EdgeSim`` through a dual compiled trace under one of the
    static-decider Table-4 arms: the fixed ``layer+gobi`` /
    ``semantic+gobi`` splits with decision-blind surrogate placement, or
    ``random+daso``'s fair coin per row (the interval program's per-row
    threefry draws, so both realize identical decisions) with
    decision-aware placement.  The parity oracle of
    ``driver.run_*_arrays_static_daso``; returns the plain §6.4 summary
    schema."""
    arm = STATIC_DASO_ARMS[policy]
    if arm >= 0:
        daso_cfg = daso_cfg._replace(decision_aware=False)
    tel = telemetry == "interval"
    acc_map = _AccuracyMap()
    sim = _sim(trace, cluster, acc_map)
    bestfit = BestFitPlacer()
    acc = MetricsAccumulator(interval_s=trace.interval_s, telemetry=tel)
    theta = _theta_on(daso_theta, CPU)
    key = trace_train_key(trace.seed)[None]
    for t in range(trace.n_intervals):
        rows = np.nonzero(trace.arr_valid[t])[0]
        if arm >= 0:
            decisions = np.full(len(rows), arm, np.int32)
        elif len(rows):
            decisions = threefry_rows(key, t, len(rows))[0].numpy() \
                .astype(np.int32)
        else:
            decisions = np.zeros(0, np.int32)
        tasks = _tasks_of_interval(trace, t, decisions, acc_map)
        sim.admit(tasks, decisions)
        warm = _daso_assignment(sim, daso_cfg, theta, bestfit.place(sim))
        sim.apply_placement(warm)
        acc.update(sim.advance())
    out = acc.summary()
    out["dropped_tasks"] = 0
    if tel:
        _attach_telemetry(out, acc)
    return out


def replay_trace_edgesim_gillis(trace, gillis_state=None,
                                cluster: Optional[Cluster] = None,
                                gillis_hp=None, num_apps: int = 3,
                                telemetry: str = "summary") -> dict:
    """Drive ``EdgeSim`` through a (LAYER, COMPRESSED) dual compiled trace
    under the interval program's Gillis baseline: contextual ε-greedy
    Q-learning decisions from the trace key's per-row draws, per-interval
    ε decay, and sequential per-leaving-task TD(0) updates.  The parity
    oracle of ``driver.run_*_arrays_gillis``; returns its summary schema
    including the final ``gillis_eps`` and ``gillis_q``."""
    eps0, lr, decay = gillis_hp or GILLIS_HP
    tel = telemetry == "interval"
    eng_rows = []
    acc_map = _AccuracyMap()
    sim = _sim(trace, cluster, acc_map)
    bestfit = BestFitPlacer()
    acc = MetricsAccumulator(interval_s=trace.interval_s, telemetry=tel)
    layer_ref = torch.from_numpy(gillis_layer_ref(num_apps))
    if gillis_state is None:
        Q = mab_mod.gillis_init(num_apps, device=CPU)
        eps = torch.full((1,), eps0, dtype=f8)
    else:
        Q = _row(np.asarray(gillis_state["Q"], np.float64))
        eps = torch.tensor([np.float64(gillis_state["eps"])], dtype=f8)
    key = trace_train_key(trace.seed)[None]
    for t in range(trace.n_intervals):
        rows = np.nonzero(trace.arr_valid[t])[0]
        arms = np.zeros(0, np.int32)
        if len(rows):
            a, _ = mab_mod.gillis_decide_rows(
                Q, eps, key, t, _row(trace.arr_sla[t, rows]),
                _row(trace.arr_batch[t, rows].astype(np.float64)),
                _row(trace.arr_app[t, rows]), layer_ref)
            arms = a[0].numpy()
        # ε decays once per interval, after its decisions
        eps = eps * decay
        tasks = _tasks_of_interval(trace, t, arms, acc_map)
        sim.admit(tasks, arms)
        sim.apply_placement(bestfit.place(sim))
        stats = sim.advance()
        fin = _finished(stats)
        sla = _row(np.array([task.sla_s for task in fin], np.float64))
        batch = _row(np.array([task.batch for task in fin], np.float64))
        apps = _row(np.array([task.app for task in fin], np.int32))
        buckets = mab_mod.gillis_bucket(sla, batch, apps, layer_ref)
        fin_arms = _row(np.array(
            [0 if task.decision == LAYER else 1 for task in fin], np.int32))
        rewards = _row(np.array(
            [((task.response_s <= task.sla_s) + task.accuracy) / 2.0
             for task in fin], np.float64))
        Q = mab_mod.gillis_update_masked(
            Q, apps, buckets, fin_arms, rewards,
            torch.ones((1, len(fin)), dtype=torch.bool), lr)
        if tel:
            # ε already carries this interval's decay (it decays in
            # decide, before feedback: where the engine samples it)
            eng_rows.append([float(eps[0]), float(Q.min()), float(Q.max())])
        acc.update(stats)
    out = acc.summary()
    out["dropped_tasks"] = 0
    out["gillis_eps"] = float(eps[0])
    out["gillis_q"] = Q[0].numpy().astype(np.float64)
    if tel:
        _attach_telemetry(out, acc, GILLIS_TELEMETRY_COLS, eng_rows)
    return out
