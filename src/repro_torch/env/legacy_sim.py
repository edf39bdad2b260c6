"""Per-object edge simulator: the slow-but-obvious spec of the host
``EdgeSim`` (the port of ``repro.env.legacy_sim``).

``LegacyEdgeSim`` keeps every task and fragment as a plain object and
loops over them; the port's structure-of-arrays ``EdgeSim``
(``repro_torch.env.simulator``) must reproduce its traces exactly
(``tests/test_torch_legacy_sim.py``).  ``LegacyBestFitPlacer`` is the
BestFit placer as a per-object loop with a full score recomputation per
fragment.  Do not optimise this file: its value is being the spec.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.env.cluster import Cluster, make_cluster
from repro_torch.env.mobility import MobilityModel
from repro_torch.env.simulator import NIC_CAP_MB, IntervalStats
from repro_torch.env.workload import Task, WorkloadGenerator


class LegacyEdgeSim:
    def __init__(self, cluster: Cluster = None, lam: float = 6.0,
                 seed: int = 0, interval_s: float = 300.0, substeps: int = 30,
                 apps=None, swap_slowdown: float = 0.5):
        self.cluster = cluster or make_cluster()
        self.gen = WorkloadGenerator(lam=lam, seed=seed, apps=apps)
        self.mob = MobilityModel(self.cluster.n, self.cluster.mobile_mask(),
                                 seed=seed + 1)
        self.interval_s = interval_s
        self.substeps = substeps
        self.swap_slowdown = swap_slowdown
        self.t = 0
        self.now = 0.0
        self.active: List[Task] = []
        self.waiting: List[Task] = []
        self.rng = np.random.RandomState(seed + 2)
        self._mips = self.cluster.mips()
        self._ram = self.cluster.ram()
        self._lat_mult = np.ones(self.cluster.n)
        self._bw_mult = np.ones(self.cluster.n)

    # ------------------------------------------------------------ state

    def containers(self):
        """All fragments of active tasks, in stable order."""
        out = []
        for task in self.active:
            for f in task.fragments:
                if not f.done:
                    out.append((task, f))
        return out

    @staticmethod
    def holds_ram(task, f) -> bool:
        """Layer chains spin containers up stage-by-stage (§3.2 precedence:
        a later container is scheduled only after the previous completes),
        so only the active fragment holds RAM; semantic branches and
        compressed containers are all live at once."""
        return (not task.chain) or f.idx == task.stage

    def state_features(self):
        """(n_workers, 4): cpu load, ram load, net quality, placed count."""
        n = self.cluster.n
        cpu = np.zeros(n)
        ram = np.zeros(n)
        cnt = np.zeros(n)
        for task, f in self.containers():
            if f.worker >= 0:
                cpu[f.worker] += f.instr_left / max(self._mips[f.worker], 1) / self.interval_s
                if self.holds_ram(task, f):
                    ram[f.worker] += f.ram_mb / self._ram[f.worker]
                cnt[f.worker] += 1
        return np.stack([np.clip(cpu, 0, 4) / 4.0, np.clip(ram, 0, 2) / 2.0,
                         1.0 / self._lat_mult, np.clip(cnt, 0, 8) / 8.0], -1)

    # -------------------------------------------------------- placement

    def apply_placement(self, assignment: Dict[int, int]):
        """assignment: fragment key (task_id, idx) -> worker.  Feasibility
        repair: greedy admit in order; RAM-infeasible fragments fall back
        to the least-loaded feasible worker, else the whole task waits."""
        ram_used = np.zeros(self.cluster.n)
        for task in self.active:
            ok = True
            for f in task.fragments:
                if f.done:
                    continue
                holds = self.holds_ram(task, f)
                w = assignment.get((task.id, f.idx), f.worker)
                if w < 0 or w >= self.cluster.n:
                    w = int(np.argmin(ram_used / self._ram))
                if holds and ram_used[w] + f.ram_mb > self._ram[w]:
                    # try least-loaded feasible worker
                    headroom = self._ram - ram_used
                    cand = int(np.argmax(headroom))
                    if headroom[cand] >= f.ram_mb:
                        w = cand
                    else:
                        ok = False
                        break
                f.worker = w
                if holds:
                    ram_used[w] += f.ram_mb
            if not ok:
                for f in task.fragments:
                    f.worker = -1
                task.placed = False
            else:
                task.placed = True

    # --------------------------------------------------------- dynamics

    def _runnable(self, task: Task, f) -> bool:
        if f.done or f.worker < 0 or not task.placed:
            return False
        if not task.chain:
            return True
        return f.idx == task.stage and f.transfer_left <= 0.0

    def advance(self) -> IntervalStats:
        self._lat_mult, self._bw_mult = self.mob.step()
        dt = self.interval_s / self.substeps
        n = self.cluster.n
        busy_time = np.zeros(n)
        finished: List[Task] = []
        per_worker_tasks = np.zeros(n)

        for task in self.waiting:
            task.wait_s += self.interval_s
        for task in self.active:
            if not task.placed:
                task.wait_s += self.interval_s

        for _ in range(self.substeps):
            # per-worker runnable census
            runnable = [(task, f) for task in self.active
                        for f in task.fragments if self._runnable(task, f)]
            load = np.zeros(n, int)
            ram_load = np.zeros(n)
            for task, f in runnable:
                load[f.worker] += 1
            for task in self.active:
                for f in task.fragments:
                    if not f.done and f.worker >= 0 and self.holds_ram(task, f):
                        ram_load[f.worker] += f.ram_mb
            swap = ram_load > self._ram
            busy_time += (load > 0) * dt
            # execution
            for task, f in runnable:
                rate = self._mips[f.worker] / max(load[f.worker], 1)
                if swap[f.worker]:
                    rate *= self.swap_slowdown
                f.instr_left -= rate * dt
                if f.instr_left <= 0:
                    f.done = True
                    per_worker_tasks[f.worker] += 1
                    if task.chain and f.idx < len(task.fragments) - 1:
                        nxt = task.fragments[f.idx + 1]
                        nxt.transfer_left = f.out_bytes
                    self._maybe_finish(task, finished)
            # transfers (layer chains)
            for task in self.active:
                if not (task.chain and task.placed):
                    continue
                f = task.fragments[task.stage]
                if task.stage > 0 and f.transfer_left > 0:
                    src = task.fragments[task.stage - 1].worker
                    dst = f.worker
                    bw = min(NIC_CAP_MB, self.cluster.net_bw()[src] / 100.0,
                             self.cluster.net_bw()[dst] / 100.0)
                    bw *= min(self._bw_mult[src], self._bw_mult[dst])
                    f.transfer_left -= bw * 1e6 * dt
                if task.fragments[task.stage].done and task.stage < len(task.fragments) - 1:
                    task.stage += 1
            self.now += dt

        # energy, cost
        util = busy_time / self.interval_s
        power = self.cluster.power(util)
        energy_j = float(np.sum(power * self.interval_s))
        cost = float(np.sum(self.cluster.cost_hr()) * self.interval_s / 3600.0)

        self.active = [t for t in self.active if not t.done]
        stats = IntervalStats(self.t, finished, energy_j, cost, util,
                              np.zeros(n), len(self.active),
                              len(self.waiting), per_worker_tasks)
        self.t += 1
        return stats

    def _maybe_finish(self, task: Task, finished):
        if all(f.done for f in task.fragments) and not task.done:
            task.done = True
            task.response_s = self.now - task.arrival_s
            task.accuracy = self.gen.accuracy_of(task)
            finished.append(task)

    # ---------------------------------------------------------- arrivals

    def new_interval_tasks(self) -> List[Task]:
        tasks = self.gen.arrivals(self.now) + self.waiting
        self.waiting = []
        return tasks

    def admit(self, tasks: List[Task], decisions):
        """Realize decisions; tasks join the active set (placement next)."""
        for task, d in zip(tasks, decisions):
            if task.decision < 0:
                self.gen.realize(task, int(d))
            self.active.append(task)


class LegacyBestFitPlacer:
    """The BestFit placer as a per-object loop with a full score
    recomputation per fragment (the pipeline the vectorized placer and
    simulator are measured and checked against)."""

    def place(self, sim) -> Dict:
        ram_free = sim.cluster.ram().copy()
        load = np.zeros(sim.cluster.n)
        for task, f in sim.containers():
            if f.worker >= 0:
                ram_free[f.worker] -= f.ram_mb
                load[f.worker] += 1
        ram_cap = sim.cluster.ram()
        mips = sim.cluster.mips()
        out = {}
        for task, f in sim.containers():
            if f.worker >= 0:
                out[(task.id, f.idx)] = f.worker
                continue
            feasible = ram_free >= f.ram_mb
            score = (-load + 0.3 * mips / mips.max()
                     + 0.1 * ram_free / ram_cap)
            score = np.where(feasible, score, -1e9)
            w = int(np.argmax(score))
            out[(task.id, f.idx)] = w
            ram_free[w] -= f.ram_mb
            load[w] += 1
        return out

    def feedback(self, *a, **k):
        pass
