"""Structure-of-arrays fragment store + vectorized interval kernels of
the host simulator.

A NumPy copy of the reference ``repro.env.soa``:

  * ``SoAStore`` owns all per-fragment and per-task simulation state in
    growable NumPy arrays.  ``Task``/``Fragment`` objects are adopted on
    first contact (``adopt_task``) and become thin views — their
    attribute reads/writes resolve into the arrays (see
    ``repro_torch.env.workload``), so tests and placers that poke objects
    stay coherent with the vectorized kernels.
  * ``run_interval`` advances one scheduling interval — runnable census,
    MIPS sharing, swap slowdown, chain transfers, task completion — as a
    sequence of array kernels (``np.bincount`` census, masked
    gathers/scatters).
  * ``state_features`` is the per-worker (cpu, ram, net, count) state the
    surrogate placers read.

Every kernel performs the same elementwise float operations in the same
accumulation order as the reference, so a trace matches it exactly, not
approximately: fragment rows are laid out task-major in admission order
(compaction preserves it), ``np.bincount(..., weights=...)`` accumulates
sequentially in input order, and ``now`` advances by repeated ``+= dt``.
``tests/test_torch_host_sim.py`` holds this contract.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from repro_torch.env.cluster import NIC_CAP_MB


_F_FIELDS = (("task_of", np.int32), ("frag_idx", np.int32),
             ("instr_left", np.float64), ("ram_mb", np.float64),
             ("out_bytes", np.float64), ("worker", np.int32),
             ("done", bool), ("transfer_left", np.float64))
_T_FIELDS = (("task_id", np.int64), ("chain", bool), ("placed", bool),
             ("stage", np.int32), ("frag_start", np.int32),
             ("frag_count", np.int32), ("task_done", bool))


class SoAStore:
    """Flat per-fragment (F,) and per-task (T,) state arrays.

    Fragment rows are contiguous per task, task-major in admission order;
    ``frag_start[t] + i`` is fragment ``i`` of task ``t``.  Arrays are
    over-allocated (capacity doubling); only ``[:n_fragments]`` /
    ``[:n_tasks]`` are live.  Rows of finished tasks linger (masked out by
    ``task_done``/``done``) until ``compact``.
    """

    def __init__(self, frag_cap: int = 256, task_cap: int = 64):
        self.n_fragments = 0
        self.n_tasks = 0
        self.tasks: List = []          # task row -> Task object
        for name, dt in _F_FIELDS:
            setattr(self, name, np.zeros(frag_cap, dt))
        for name, dt in _T_FIELDS:
            setattr(self, name, np.zeros(task_cap, dt))

    # ------------------------------------------------------------ growth

    def _grow_frag(self, need: int):
        cap = len(self.instr_left)
        if self.n_fragments + need <= cap:
            return
        new_cap = max(cap * 2, self.n_fragments + need)
        for name, dt in _F_FIELDS:
            a = np.zeros(new_cap, dt)
            a[:self.n_fragments] = getattr(self, name)[:self.n_fragments]
            setattr(self, name, a)

    def _grow_task(self, need: int):
        cap = len(self.frag_start)
        if self.n_tasks + need <= cap:
            return
        new_cap = max(cap * 2, self.n_tasks + need)
        for name, dt in _T_FIELDS:
            a = np.zeros(new_cap, dt)
            a[:self.n_tasks] = getattr(self, name)[:self.n_tasks]
            setattr(self, name, a)

    # ---------------------------------------------------------- adoption

    def adopt_task(self, task) -> int:
        """Ingest a task + its fragments; objects become views."""
        frs = task.fragments
        self._grow_task(1)
        self._grow_frag(len(frs))
        ti = self.n_tasks
        self.task_id[ti] = task.id
        self.chain[ti] = task.chain
        self.placed[ti] = task.placed
        self.stage[ti] = task.stage
        self.task_done[ti] = task.done
        self.frag_start[ti] = self.n_fragments
        self.frag_count[ti] = len(frs)
        self.n_tasks += 1
        row = self.n_fragments
        for f in frs:
            self.task_of[row] = ti
            self.frag_idx[row] = f.idx
            self.instr_left[row] = f.instr_left
            self.ram_mb[row] = f.ram_mb
            self.out_bytes[row] = f.out_bytes
            self.worker[row] = f.worker
            self.done[row] = f.done
            self.transfer_left[row] = f.transfer_left
            f._store = self
            f._row = row
            row += 1
        self.n_fragments = row
        task._store = self
        task._trow = ti
        self.tasks.append(task)
        return ti

    def is_bound(self, task) -> bool:
        """Task and its fragment objects are views into *this* store (a
        re-``realize`` swaps in fresh unbound fragments)."""
        if task._store is not self:
            return False
        frs = task.fragments
        return (self.frag_count[task._trow] == len(frs)
                and all(f._store is self for f in frs))

    def _detach(self, task, ti):
        """Copy a task's final array state onto its objects, making them
        plain (unbound) again so they never alias reused rows."""
        fs, cnt = self.frag_start[ti], self.frag_count[ti]
        for f, row in zip(task.fragments, range(fs, fs + cnt)):
            if f._store is self and f._row == row:
                f._instr_left = float(self.instr_left[row])
                f._ram_mb = float(self.ram_mb[row])
                f._out_bytes = float(self.out_bytes[row])
                f._worker = int(self.worker[row])
                f._done = bool(self.done[row])
                f._transfer_left = float(self.transfer_left[row])
                f._store = None
        task._done = bool(self.task_done[ti])
        task._chain = bool(self.chain[ti])
        task._stage = int(self.stage[ti])
        task._placed = bool(self.placed[ti])
        task._store = None

    def unbind_task(self, task):
        """Detach a task (its rows are retired, masked by task_done)."""
        ti = task._trow
        self._detach(task, ti)
        fs, cnt = self.frag_start[ti], self.frag_count[ti]
        self.task_done[ti] = True
        self.done[fs:fs + cnt] = True
        self.tasks[ti] = None

    def compact(self):
        """Drop retired rows (finished / unbound tasks), preserving the
        relative admission order of the remainder.  Dropped tasks are
        detached first so caller-held references stay readable."""
        snap = []
        for ti, t in enumerate(self.tasks):
            if t is None or self.task_done[ti]:
                if (t is not None and t._store is self
                        and t._trow == ti):
                    self._detach(t, ti)
                continue
            fs, cnt = self.frag_start[ti], self.frag_count[ti]
            snap.append((t, {name: getattr(self, name)[fs:fs + cnt].copy()
                             for name, _ in _F_FIELDS},
                         {name: getattr(self, name)[ti]
                          for name, _ in _T_FIELDS}))
        self.n_fragments = 0
        self.n_tasks = 0
        self.tasks = []
        for t, fcols, tcols in snap:
            self._grow_task(1)
            cnt = len(fcols["frag_idx"])
            self._grow_frag(cnt)
            ti = self.n_tasks
            for name, _ in _T_FIELDS:
                getattr(self, name)[ti] = tcols[name]
            self.frag_start[ti] = self.n_fragments
            fs = self.n_fragments
            for name, _ in _F_FIELDS:
                getattr(self, name)[fs:fs + cnt] = fcols[name]
            self.task_of[fs:fs + cnt] = ti
            self.n_tasks += 1
            self.n_fragments += cnt
            t._trow = ti
            for f, row in zip(t.fragments, range(fs, fs + cnt)):
                f._row = row
            self.tasks.append(t)

    # ------------------------------------------------------------- views

    def live_slices(self):
        F, T = self.n_fragments, self.n_tasks
        return (self.task_of[:F], self.frag_idx[:F], self.instr_left[:F],
                self.ram_mb[:F], self.out_bytes[:F], self.worker[:F],
                self.done[:F], self.transfer_left[:F])


@dataclasses.dataclass
class IntervalResult:
    finished_rows: List[int]       # task rows in completion order
    finish_now: List[float]        # accumulated `now` at each completion
    busy_time: np.ndarray          # (n_workers,) seconds with >=1 runnable
    per_worker_tasks: np.ndarray   # (n_workers,) fragments completed
    now: float                     # accumulated clock after the interval


def run_interval(s: SoAStore, mips: np.ndarray, ram: np.ndarray,
                 net_bw: np.ndarray, bw_mult: np.ndarray, now: float,
                 interval_s: float, substeps: int,
                 swap_slowdown: float) -> IntervalResult:
    """Advance one scheduling interval over the store, in place."""
    n = len(mips)
    dt = interval_s / substeps
    busy_time = np.zeros(n)
    per_worker_tasks = np.zeros(n)
    finished_rows: List[int] = []
    finish_now: List[float] = []

    F, T = s.n_fragments, s.n_tasks
    (task_of, frag_idx, instr_left, ram_mb, out_bytes, worker, done,
     transfer_left) = s.live_slices()
    stage = s.stage[:T]
    frag_count_t = s.frag_count[:T]
    task_done = s.task_done[:T]
    # static per-interval masks (worker/placed/chain can't change
    # mid-interval; done can, and is re-masked each substep)
    chain_f = s.chain[:T][task_of]
    not_chain_f = ~chain_f
    placeable = (worker >= 0) & s.placed[:T][task_of]
    holdable = worker >= 0
    count_f = frag_count_t[task_of]
    undone = np.bincount(task_of[~done], minlength=T).astype(np.int64)
    chain_rows = np.nonzero(s.chain[:T] & s.placed[:T] & ~task_done)[0] \
        .astype(np.int32)
    any_chain = bool(chain_f.any())
    # scratch buffers reused across substeps
    notdone = np.empty(F, bool)
    is_stage = np.empty(F, bool)
    tle = np.empty(F, bool)
    runnable = np.empty(F, bool)
    holds = np.empty(F, bool)
    stage_f = np.empty(F, np.int32) if any_chain else None

    for _ in range(substeps):
        np.logical_not(done, out=notdone)
        if any_chain:
            np.take(stage, task_of, out=stage_f)
            np.equal(frag_idx, stage_f, out=is_stage)     # is-active-stage
            np.less_equal(transfer_left, 0.0, out=tle)
            tle &= is_stage
            # runnable: placed, not done, and — for layer chains — the
            # active stage with no inbound transfer
            np.logical_or(not_chain_f, tle, out=runnable)
            runnable &= placeable
            runnable &= notdone
            # RAM resident (§3.2 precedence: only a chain's active stage
            # is spun up; semantic/compressed fragments are all live)
            np.logical_or(not_chain_f, is_stage, out=holds)
            holds &= holdable
            holds &= notdone
        else:
            np.logical_and(placeable, notdone, out=runnable)
            np.logical_and(holdable, notdone, out=holds)
        run_w = worker[runnable]
        load = np.bincount(run_w, minlength=n)
        ram_load = np.bincount(worker[holds], weights=ram_mb[holds],
                               minlength=n)
        swap = ram_load > ram
        busy_time += (load > 0) * dt
        # -- execution: runnable containers share their worker's MIPS
        rate = mips[run_w] / np.maximum(load[run_w], 1)
        rate = np.where(swap[run_w], rate * swap_slowdown, rate)
        rows = np.nonzero(runnable)[0]
        instr_left[rows] -= rate * dt
        done_rows = rows[instr_left[rows] <= 0]
        if done_rows.size:
            done[done_rows] = True
            per_worker_tasks += np.bincount(worker[done_rows], minlength=n)
            # chain handoff: completed stage queues its activation transfer
            # onto the next fragment (rows are contiguous per task)
            t_of = task_of[done_rows]
            hand = chain_f[done_rows] & (frag_idx[done_rows]
                                         < count_f[done_rows] - 1)
            hrows = done_rows[hand]
            transfer_left[hrows + 1] = out_bytes[hrows]
            # task completion (in task-major order)
            np.subtract.at(undone, t_of, 1)
            fin = np.unique(t_of[undone[t_of] == 0])
            for ti in fin:
                if not task_done[ti]:
                    task_done[ti] = True
                    finished_rows.append(int(ti))
                    finish_now.append(now)
        # -- transfers: layer chains forward activations stage-to-stage
        if chain_rows.size:
            srow = s.frag_start[chain_rows] + stage[chain_rows]
            tmask = (stage[chain_rows] > 0) & (transfer_left[srow] > 0)
            if tmask.any():
                mrow = srow[tmask]
                src = worker[mrow - 1]
                dst = worker[mrow]
                bw = np.minimum(NIC_CAP_MB,
                                np.minimum(net_bw[src] / 100.0,
                                           net_bw[dst] / 100.0))
                bw = bw * np.minimum(bw_mult[src], bw_mult[dst])
                transfer_left[mrow] -= bw * 1e6 * dt
            adv = done[srow] & (stage[chain_rows]
                                < frag_count_t[chain_rows] - 1)
            stage[chain_rows[adv]] += 1
        now += dt

    return IntervalResult(finished_rows, finish_now, busy_time,
                          per_worker_tasks, now)


def state_features(s: SoAStore, mips: np.ndarray, ram: np.ndarray,
                   lat_mult: np.ndarray, interval_s: float) -> np.ndarray:
    """(n_workers, 4): cpu load, ram load, net quality, placed count —
    array form of a per-container accumulation."""
    n = len(mips)
    F, T = s.n_fragments, s.n_tasks
    task_of = s.task_of[:F]
    worker = s.worker[:F]
    done = s.done[:F]
    live = (~done) & (worker >= 0)
    w = worker[live]
    cpu = np.bincount(
        w, weights=s.instr_left[:F][live] / np.maximum(mips[w], 1)
        / interval_s, minlength=n)
    chain_f = s.chain[:T][task_of]
    is_stage = s.frag_idx[:F] == s.stage[:T][task_of]
    holds = live & ((~chain_f) | is_stage)
    hw = worker[holds]
    ram_load = np.bincount(hw, weights=s.ram_mb[:F][holds] / ram[hw],
                           minlength=n)
    cnt = np.bincount(w, minlength=n).astype(np.float64)
    return np.stack([np.clip(cpu, 0, 4) / 4.0, np.clip(ram_load, 0, 2) / 2.0,
                     1.0 / lat_mult, np.clip(cnt, 0, 8) / 8.0], -1)
