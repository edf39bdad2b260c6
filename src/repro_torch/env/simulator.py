"""Discrete-interval mobile-edge simulator (the paper's §6 testbed).

Interval loop (Algorithm 1 environment side):
  1. Poisson arrivals; the policy takes split decisions for new tasks.
  2. The policy produces a placement for all active containers; placements
     are feasibility-repaired against worker RAM; unplaceable tasks wait.
  3. The interval advances in sub-steps: runnable containers share their
     worker's MIPS; layer chains forward activations over the (mobility-
     modulated) network when a stage completes; RAM over-subscription
     triggers swap slowdown.
  4. Leaving tasks yield (response time, accuracy); per-interval AEC/ART,
     energy, cost, fairness are accumulated (eqs. 13–16).

State lives in a structure-of-arrays store
(``repro_torch.env.soa.SoAStore``): tasks are adopted into flat NumPy
arrays on first contact and their ``Task``/``Fragment`` objects become
thin views, so the object API (tests and placers mutate
``Fragment.worker``, ``Task.placed`` freely between intervals) stays
coherent while ``advance`` runs as vectorized array kernels.

A NumPy copy of the reference ``repro.env.simulator``, over the port's
``cluster``, ``mobility`` and ``workload``: the same draws in the same
order and the same float operations, so its finished tasks and state
features equal the reference's.  It runs on the host, like the
reference.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from repro_torch.env import soa
from repro_torch.env.cluster import Cluster, make_cluster
from repro_torch.env.mobility import MobilityModel
from repro_torch.env.workload import Task, WorkloadGenerator

NIC_CAP_MB = soa.NIC_CAP_MB  # the paper's 10 MBps NIC ceiling


@dataclasses.dataclass
class IntervalStats:
    t: int
    finished: List[Task]
    energy_j: float
    cost_usd: float
    cpu_util: np.ndarray
    ram_util: np.ndarray
    num_active: int
    num_waiting: int
    per_worker_tasks: np.ndarray


class EdgeSim:
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
        self._net_bw = self.cluster.net_bw()
        self._lat_mult = np.ones(self.cluster.n)
        self._bw_mult = np.ones(self.cluster.n)
        self._store = soa.SoAStore()
        self._bound_upto = 0   # active-list prefix already adopted

    # ------------------------------------------------------------ state

    def fragment_store(self) -> soa.SoAStore:
        """Adopt any not-yet-bound active tasks and return the SoA store
        (placers use this for vectorized reads).  Tasks enter the active
        list only by appending (``admit`` or direct ``active.append``), so
        only the unscanned suffix needs the adoption check."""
        st = self._store
        if len(self.active) != self._bound_upto:
            pending = False
            for t in self.active[self._bound_upto:]:
                if (t._store is st and t.fragments
                        and t.fragments[0]._store is st):
                    continue
                if not t.fragments:
                    # not realized yet (active.append before realize):
                    # leave unbound and rescan on the next call
                    pending = True
                    continue
                if t._store is st:
                    # re-realized (fragments swapped out): retire old rows
                    st.unbind_task(t)
                st.adopt_task(t)
            if not pending:
                self._bound_upto = len(self.active)
        return st

    def containers(self):
        """All fragments of active tasks, in stable order."""
        out = []
        for task in self.active:
            for f in task.fragments:
                if not f.done:
                    out.append((task, f))
        return out

    def state_features(self):
        """(n_workers, 4): cpu load, ram load, net quality, placed count."""
        return soa.state_features(self.fragment_store(), self._mips,
                                  self._ram, self._lat_mult, self.interval_s)

    # -------------------------------------------------------- placement

    def apply_placement(self, assignment: Dict[int, int]):
        """assignment: fragment key (task_id, idx) -> worker.  Feasibility
        repair: greedy admit in order; RAM-infeasible fragments fall back
        to the least-loaded feasible worker, else the whole task waits.
        (As in the reference, RAM already admitted for a task that
        later fails repair is not rolled back within this pass.)

        Fast path: when every requested placement fits its worker
        outright (the common case — BestFit is RAM-feasibility-aware),
        the sequential repair is provably the identity on the requests
        (each worker's RAM prefix sums are bounded by its final total),
        so the whole pass is applied vectorized.  The per-fragment Python
        loop — the 500-worker hot spot — only runs under RAM pressure,
        and is bit-exact either way."""
        st = self.fragment_store()
        n = self.cluster.n
        F, T = st.n_fragments, st.n_tasks
        if self._bound_upto == len(self.active):
            # every active task is array-bound: try the vectorized path
            req = st.worker[:F].copy()
            task_done = st.task_done[:T]
            if assignment:
                start = st.frag_start[:T]
                count = st.frag_count[:T]
                row_of = {int(tid): ti
                          for ti, tid in enumerate(st.task_id[:T])
                          if not task_done[ti]}
                for (tid, idx), w in assignment.items():
                    ti = row_of.get(tid)
                    if ti is not None and 0 <= idx < count[ti]:
                        req[start[ti] + idx] = w
            live_und = ~st.done[:F]
            valid = req[live_und]
            if valid.size == 0 or ((valid >= 0).all() and (valid < n).all()):
                task_of = st.task_of[:F]
                holds = (~st.chain[:T][task_of]) \
                    | (st.frag_idx[:F] == st.stage[:T][task_of])
                mask = live_und & holds
                demand = np.bincount(req[mask].clip(0),
                                     weights=st.ram_mb[:F][mask],
                                     minlength=n)
                if (demand <= self._ram).all():
                    st.worker[:F] = np.where(st.done[:F], st.worker[:F], req)
                    st.placed[:T] = np.where(task_done, st.placed[:T], True)
                    return
        self._apply_placement_sequential(assignment)

    def _apply_placement_sequential(self, assignment: Dict[int, int]):
        """The per-fragment greedy repair (bit-exact with the
        reference's); used when a request is
        invalid, a task is unbound, or some worker's RAM oversubscribes."""
        st = self.fragment_store()
        n = self.cluster.n
        F, T = st.n_fragments, st.n_tasks
        ram_arr = self._ram
        # hot columns as Python lists: scalar list ops are ~5x faster than
        # NumPy scalar indexing in this sequential repair loop
        worker_l = st.worker[:F].tolist()
        ram_l = st.ram_mb[:F].tolist()
        done_l = st.done[:F].tolist()
        idx_l = st.frag_idx[:F].tolist()
        start_l = st.frag_start[:T].tolist()
        count_l = st.frag_count[:T].tolist()
        chain_l = st.chain[:T].tolist()
        stage_l = st.stage[:T].tolist()
        placed_l = st.placed[:T].tolist()
        ram_cap_l = ram_arr.tolist()
        ram_used = [0.0] * n
        ram_used_np = np.zeros(n)      # mirror for the repair fallbacks
        scratch = np.empty(n)
        get = assignment.get
        for task in self.active:
            if task._store is not st:
                # unrealized (no fragments): trivially placeable, like the
                # per-object loop over an empty fragment list
                task.placed = True
                continue
            ti = task._trow
            row0 = start_l[ti]
            chain = chain_l[ti]
            stg = stage_l[ti]
            tid = task.id
            ok = True
            for k in range(count_l[ti]):
                r = row0 + k
                if done_l[r]:
                    continue
                idx = idx_l[r]
                holds = (not chain) or idx == stg
                w = get((tid, idx), worker_l[r])
                if w < 0 or w >= n:
                    np.divide(ram_used_np, ram_arr, out=scratch)
                    w = int(scratch.argmin())
                if holds and ram_used[w] + ram_l[r] > ram_cap_l[w]:
                    # try least-loaded feasible worker
                    np.subtract(ram_arr, ram_used_np, out=scratch)
                    cand = int(scratch.argmax())
                    if scratch[cand] >= ram_l[r]:
                        w = cand
                    else:
                        ok = False
                        break
                worker_l[r] = w
                if holds:
                    u = ram_used[w] + ram_l[r]
                    ram_used[w] = u
                    ram_used_np[w] = u
            if not ok:
                for k in range(count_l[ti]):
                    worker_l[row0 + k] = -1
            placed_l[ti] = ok
        st.worker[:F] = worker_l
        st.placed[:T] = placed_l

    # --------------------------------------------------------- dynamics
    # (the per-object runnable / holds-RAM predicates live as masks in
    # repro_torch.env.soa)

    def advance(self) -> IntervalStats:
        self._lat_mult, self._bw_mult = self.mob.step()
        n = self.cluster.n
        st = self.fragment_store()

        for task in self.waiting:
            task.wait_s += self.interval_s
        for task in self.active:
            # `placed` resolves through the store for adopted tasks
            if not task.placed:
                task.wait_s += self.interval_s

        res = soa.run_interval(st, self._mips, self._ram, self._net_bw,
                               self._bw_mult, self.now, self.interval_s,
                               self.substeps, self.swap_slowdown)
        finished: List[Task] = []
        for ti, fin_now in zip(res.finished_rows, res.finish_now):
            task = st.tasks[ti]
            task.response_s = fin_now - task.arrival_s
            task.accuracy = self.gen.accuracy_of(task)
            finished.append(task)
        self.now = res.now

        # energy, cost
        util = res.busy_time / self.interval_s
        power = self.cluster.power(util)
        energy_j = float(np.sum(power * self.interval_s))
        cost = float(np.sum(self.cluster.cost_hr()) * self.interval_s / 3600.0)

        self.active = [t for t in self.active if not t.done]
        bound = 0
        for t in self.active:
            if t._store is not st:
                break
            bound += 1
        self._bound_upto = bound
        # reclaim retired rows once they dominate the store
        if st.n_tasks > 64 and st.n_tasks - len(self.active) > len(self.active):
            st.compact()
        stats = IntervalStats(self.t, finished, energy_j, cost, util,
                              np.zeros(n), len(self.active),
                              len(self.waiting), res.per_worker_tasks)
        self.t += 1
        return stats

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
