"""Streaming serve driver: continuous arrivals through chunked,
carry-re-entrant interval programs (the port of
``repro.env.jaxsim.stream``).

Every other entry point of ``repro_torch.env.torchsim`` runs a fixed
episode compiled up front; this module is the always-on serving mode the
paper's setting implies, tasks arriving without end while the policy
engine keeps deciding and placing:

  * a host **feeder** (``StreamFeeder``) generates Poisson arrivals
    incrementally, with the ``WorkloadGenerator`` / ``MobilityModel``
    choreography of ``arrays.compile_trace(_dual)`` but stateful, so the
    clock, the mobility walk and the task ids continue across chunks, and
    emits fixed-shape *chunk tapes* of ``chunk_intervals`` intervals;
  * the **ring** is the fixed-capacity slot store itself
    (``kernels.init_state``): ``max_active`` device slots that arrivals
    enter and finished tasks vacate.  Admission is counted twice:
    arrivals beyond a tape interval's ``max_arrivals`` rows are dropped on
    the host and counted (``feeder_overflow``), arrivals beyond the free
    slots are dropped on the device and counted (``state["dropped"]``);
  * the chunk program (``driver.run_chunk``) takes the carry ``(state,
    acc, es)`` as an argument and returns it, so consecutive chunks
    continue ONE episode.  It runs ``driver.run_intervals``, the body of
    the whole-trace program, with every hook seeing the absolute interval
    index (``driver._ShiftedLeaf``).  PyTorch compiles nothing per shape,
    so there is no runner cache, and no buffer donation: ``StreamRunner``
    instead asserts that the carry stays on its device and keeps its
    shapes from chunk to chunk (the previous carry is freed when the new
    one replaces it);
  * ``serve`` overlaps the two: a feeder thread fills the next chunks'
    tapes into a small queue while the main thread runs the current
    chunk, with ledger spans for both sides.  The chunk is a Python loop
    of eager launches that holds the GIL between them, so the overlap is
    partial; the ``feed`` and ``stream_chunk`` spans measure it;
  * rolling metrics (``RollingMetrics``) over a sliding window of the
    per-interval telemetry rows the chunk program always records: QPS,
    p50/p99 response, the deadline-violation rate and ring occupancy.

``replay_stream`` drives the same machinery over a frozen compiled trace
(``arrays.chunk_tapes``); it runs the launches of the one-shot
``driver.run_trace_engine`` in the same order, so on one device it equals
it to every digit.

``StreamRunner``, ``replay_stream`` and ``serve`` run on ``device="cuda"``
unless the caller asks for the CPU, and raise when CUDA is asked for and
absent.
"""
from __future__ import annotations

import queue
import threading
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.core import mab as mab_mod
from repro_torch.device import resolve
from repro_torch.env.cluster import Cluster, make_cluster
from repro_torch.env.metrics import TELEMETRY_COLS, series_percentiles
from repro_torch.env.mobility import MobilityModel
from repro_torch.env.torchsim import driver, engines
from repro_torch.env.torchsim import policies as pol
from repro_torch.env.torchsim.arrays import (ClusterArrays, chunk_tapes,
                                             default_capacity, to_device,
                                             to_device_packed)
from repro_torch.env.workload import (APP_PROFILES, WorkloadGenerator,
                                      accuracy_from_noise)
from repro_torch.obs import get_ledger


def _default_max_arrivals(lam: float) -> int:
    """Arrival rows of one tape interval: the Poisson mean plus an
    8-sigma margin, so overflow is astronomically rare at steady state
    yet still counted when a burst exceeds it."""
    return int(np.ceil(lam + 8.0 * np.sqrt(max(lam, 1.0)) + 4.0))


def _max_frags(apps) -> int:
    """Fragment columns covering any split decision of the apps (layer
    chains and semantic branches both)."""
    return max(max(APP_PROFILES[a].n_frag, APP_PROFILES[a].n_branch, 1)
               for a in apps)


class StreamFeeder:
    """Incremental host-side tape compiler of the serving loop.

    Carries the ``WorkloadGenerator``, the ``MobilityModel``, the clock
    and the placer's ``lat_prev`` row across calls, so consecutive
    ``next_chunk`` tapes continue one endless workload: the streaming
    counterpart of ``arrays.compile_trace`` (pass ``decider``) or
    ``compile_trace_dual`` (pass ``variants``), with their per-task draw
    sequence.

    Shapes are fixed for the stream's lifetime (``max_arrivals`` rows per
    interval, ``max_frags`` fragment columns).  Arrivals beyond
    ``max_arrivals`` in a burst are dropped on the host and counted in
    ``overflow``; the running totals satisfy ``offered == fed +
    overflow``.
    """

    def __init__(self, lam: float = 6.0, seed: int = 0,
                 interval_s: float = 300.0, substeps: int = 30,
                 cluster: Optional[Cluster] = None, apps=None,
                 max_arrivals: Optional[int] = None,
                 decider=None, variants=None):
        if (decider is None) == (variants is None):
            raise ValueError("pass exactly one of decider= (static "
                             "single-variant tapes) or variants= (dual "
                             "tapes for in-loop deciders)")
        self.lam = lam
        self.seed = seed
        self.interval_s = interval_s
        self.substeps = substeps
        self.cluster = cluster or make_cluster()
        self.apps = list(apps) if apps is not None else [0, 1, 2]
        self.decider = decider
        self.variants = tuple(variants) if variants is not None else None
        self.max_arrivals = max_arrivals if max_arrivals is not None \
            else _default_max_arrivals(lam)
        self.max_frags = _max_frags(self.apps)
        self.gen = WorkloadGenerator(lam=lam, seed=seed, apps=self.apps)
        self.mob = MobilityModel(self.cluster.n,
                                 self.cluster.mobile_mask(), seed=seed + 1)
        self.now = 0.0
        self.n_intervals = 0
        # the counted admission (host half)
        self.offered = 0       # tasks the Poisson process generated
        self.fed = 0           # tasks written into tapes
        self.overflow = 0      # tasks dropped for exceeding max_arrivals
        # the placer sees the PREVIOUS interval's mobility latency draw
        # (compile_trace_dual's row-0-ones convention, continued across
        # chunks)
        self._lat_prev = np.ones(self.cluster.n, np.float64)

    # ------------------------------------------------------------ tapes

    def _arrivals(self):
        """One interval's admitted tasks, with overflow counted."""
        tasks = self.gen.arrivals(self.now)
        self.offered += len(tasks)
        if len(tasks) > self.max_arrivals:
            self.overflow += len(tasks) - self.max_arrivals
            tasks = tasks[:self.max_arrivals]
        self.fed += len(tasks)
        return tasks

    def next_chunk(self, n_intervals: int) -> dict:
        """The next ``n_intervals`` intervals as a chunk tape (the
        ``kernel_dict`` layout of ``TraceArrays`` / ``DualTraceArrays``,
        chunk-local T axis)."""
        T, A, F = n_intervals, self.max_arrivals, self.max_frags
        dt = self.interval_s / self.substeps
        if self.variants is None:
            tape = self._next_chunk_static(T, A, F, dt)
        else:
            tape = self._next_chunk_dual(T, A, F, dt)
        self.n_intervals += T
        return tape

    def _next_chunk_static(self, T, A, F, dt):
        tape = {
            "bw_mult": np.ones((T, self.cluster.n), np.float64),
            "valid": np.zeros((T, A), bool),
            "sla": np.zeros((T, A), np.float64),
            "arrival_s": np.zeros((T, A), np.float64),
            "app": np.zeros((T, A), np.int32),
            "batch": np.zeros((T, A), np.int64),
            "acc": np.zeros((T, A), np.float64),
            "decision": np.full((T, A), -1, np.int32),
            "chain": np.zeros((T, A), bool),
            "nfrag": np.zeros((T, A), np.int32),
            "instr": np.zeros((T, A, F), np.float64),
            "ram": np.zeros((T, A, F), np.float64),
            "out_bytes": np.zeros((T, A, F), np.float64),
        }
        for t in range(T):
            tasks = self._arrivals()
            decisions = self.decider.decide(tasks)
            for a, (task, d) in enumerate(zip(tasks, decisions)):
                self.gen.realize(task, int(d))
                acc = self.gen.accuracy_of(task)
                tape["valid"][t, a] = True
                tape["sla"][t, a] = task.sla_s
                tape["arrival_s"][t, a] = task.arrival_s
                tape["app"][t, a] = task.app
                tape["batch"][t, a] = task.batch
                tape["acc"][t, a] = acc
                tape["decision"][t, a] = task.decision
                tape["chain"][t, a] = task.chain
                tape["nfrag"][t, a] = len(task.fragments)
                for i, f in enumerate(task.fragments):
                    tape["instr"][t, a, i] = f.instr_left
                    tape["ram"][t, a, i] = f.ram_mb
                    tape["out_bytes"][t, a, i] = f.out_bytes
            _, bw = self.mob.step()
            tape["bw_mult"][t] = bw
            for _ in range(self.substeps):
                self.now += dt
        return tape

    def _next_chunk_dual(self, T, A, F, dt):
        n = self.cluster.n
        tape = {
            "bw_mult": np.ones((T, n), np.float64),
            "lat_prev": np.ones((T, n), np.float64),
            "valid": np.zeros((T, A), bool),
            "sla": np.zeros((T, A), np.float64),
            "arrival_s": np.zeros((T, A), np.float64),
            "app": np.zeros((T, A), np.int32),
            "batch": np.zeros((T, A), np.int64),
            "vacc": np.zeros((T, A, 2), np.float64),
            "vchain": np.zeros((T, A, 2), bool),
            "vnfrag": np.zeros((T, A, 2), np.int32),
            "vinstr": np.zeros((T, A, 2, F), np.float64),
            "vram": np.zeros((T, A, 2, F), np.float64),
            "vout": np.zeros((T, A, 2, F), np.float64),
        }
        for t in range(T):
            tasks = self._arrivals()
            for a, task in enumerate(tasks):
                img_mb = self.gen.rng.uniform(
                    *APP_PROFILES[task.app].model_mb)
                tape["valid"][t, a] = True
                tape["sla"][t, a] = task.sla_s
                tape["arrival_s"][t, a] = task.arrival_s
                tape["app"][t, a] = task.app
                tape["batch"][t, a] = task.batch
                for v, d in enumerate(self.variants):
                    self.gen.realize(task, d, img_mb=img_mb)
                    tape["vchain"][t, a, v] = task.chain
                    tape["vnfrag"][t, a, v] = len(task.fragments)
                    for i, f in enumerate(task.fragments):
                        tape["vinstr"][t, a, v, i] = f.instr_left
                        tape["vram"][t, a, v, i] = f.ram_mb
                        tape["vout"][t, a, v, i] = f.out_bytes
                noise = self.gen.rng.normal(0, 0.003)
                for v, d in enumerate(self.variants):
                    tape["vacc"][t, a, v] = accuracy_from_noise(
                        task.app, d, noise)
            tape["lat_prev"][t] = self._lat_prev
            lat, bw = self.mob.step()
            tape["bw_mult"][t] = bw
            self._lat_prev = lat
            for _ in range(self.substeps):
                self.now += dt
        return tape


def _carry_leaves(tree):
    """The tensors of a carry (nested dicts, lists, tuples and
    ``NamedTuple``s), in a fixed order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _carry_leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _carry_leaves(v)


class StreamRunner:
    """Chunked executor of the carry-re-entrant interval program.

    Holds the carry ``(slot state, accumulators, engine state)`` of one
    cell (a grid axis of 1) on ``device`` between ``run_chunk`` calls;
    each call uploads one chunk tape, advances the stream by it and
    returns that chunk's per-interval telemetry rows, the one
    device→host copy per chunk besides the MAB's and Gillis's
    per-interval host reads.  ``es0(cells, device)`` builds the engine's
    starting state (``driver.run_grid_engine``'s ``es_builder``); it is
    called once, for one cell that has no trace (``[None]``: its seed
    keys are the builder's own), when the first chunk fixes F."""

    def __init__(self, engine, es0, *, interval_s: float, substeps: int,
                 max_active: int, cluster: Optional[Cluster] = None,
                 swap_slowdown: float = 0.5, device="cuda"):
        self.device = resolve(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.engine = engine
        self.cluster = cluster or make_cluster()
        self.cl = ClusterArrays.from_cluster(self.cluster)
        self.interval_s = float(interval_s)
        self.substeps = int(substeps)
        self.K = int(max_active)
        self.swap_slowdown = swap_slowdown
        self.tcols = tuple(TELEMETRY_COLS) + tuple(engine.telemetry_cols())
        self.t0 = 0
        self.n_chunks = 0
        self._es0 = es0
        self.carry = None          # built on the first chunk (needs F)
        self._layout = None
        self._cld = to_device(self.cl.as_dict(), self.device)

    @staticmethod
    def _layout_of(carry):
        return [(tuple(v.shape), v.dtype) for v in _carry_leaves(carry)]

    def _ensure_carry(self, F: int):
        if self.carry is not None:
            return
        state, acc = driver.init_carry(1, self.K, F, self.cl.n, self.device)
        self.carry = (state, acc, self._es0([None], self.device))
        self._layout = self._layout_of(self.carry)

    def run_chunk(self, tape: dict) -> np.ndarray:
        """Advance the stream by one chunk tape (NumPy leaves, T-leading);
        returns the chunk's ``(T, C)`` float64 telemetry series as
        NumPy."""
        leaves = to_device_packed({k: v[None] for k, v in tape.items()},
                                  self.device)
        frag = leaves["vinstr"] if "vinstr" in leaves else leaves["instr"]
        self._ensure_carry(int(frag.shape[-1]))
        carry, series = driver.run_chunk(
            self.engine, leaves, self._cld, self.carry, self.t0,
            self.substeps, self.interval_s, self.swap_slowdown, self.tcols)
        # no donation in PyTorch: the proof that the carry is updated
        # without a host round trip is that every tensor of it stays on
        # the runner's device, shaped as the first chunk built it
        off = [v.device for v in _carry_leaves(carry)
               if v.device != self.device]
        assert not off, f"streaming carry left {self.device}: {off[:3]}"
        assert self._layout_of(carry) == self._layout, \
            "streaming carry changed its shapes between chunks"
        self.carry = carry
        self.t0 += int(tape["valid"].shape[0])
        self.n_chunks += 1
        return series[0].cpu().numpy()

    # --------------------------------------------------------- summary

    def raw_outputs(self) -> dict:
        """The accumulators and the engine's outputs on the host (the
        stream's one read of the carry: call it after the last chunk)."""
        state, acc, es = self.carry
        out = {"metrics": acc["metrics"], "energy": acc["energy"],
               "pwt": acc["pwt"], "dropped": state["dropped"],
               "live": state["alive"].sum(dim=1)}
        out.update(self.engine.outputs(es))
        return driver._tree(out, lambda v: v[0].cpu().numpy())

    def summary(self, n_intervals: Optional[int] = None) -> dict:
        """The §6.4 summary over everything streamed so far."""
        out = self.raw_outputs()
        s = driver._summarize(out, self.interval_s, n_intervals or self.t0,
                              float(self.cl.cost_hr.sum()))
        return self.engine.summarize(out, s)


class RollingMetrics:
    """Sliding-window serving metrics over interval-telemetry rows: QPS
    (completions per simulated second), binned p50/p95/p99 response and
    wait (``metrics.series_percentiles`` with its ``percentile_err_s``
    bound), the deadline-violation rate and mean ring occupancy, all over
    the trailing ``window_intervals`` intervals."""

    def __init__(self, cols, window_intervals: int, interval_s: float):
        self.cols = list(cols)
        self.interval_s = float(interval_s)
        self.window = deque(maxlen=int(window_intervals))
        self._i = {c: i for i, c in enumerate(self.cols)}

    def update(self, series) -> None:
        for row in np.asarray(series, np.float64):
            self.window.append(row)

    def snapshot(self) -> dict:
        if not self.window:
            return {"window_intervals": 0, "qps": 0.0,
                    "violation_rate": 0.0, "occupancy_mean": 0.0}
        w = np.stack(self.window)
        n_fin = float(w[:, self._i["n_fin"]].sum())
        snap = {
            "window_intervals": len(self.window),
            "qps": n_fin / (len(self.window) * self.interval_s),
            "violation_rate":
                float(w[:, self._i["n_viol"]].sum()) / max(n_fin, 1.0),
            "occupancy_mean": float(w[:, self._i["n_active"]].mean()),
            "dropped": float(w[:, self._i["n_dropped"]].sum()),
        }
        snap.update(series_percentiles(w, self.cols))
        return snap


def replay_stream(engine, trace, es0, *, chunk_intervals: int,
                  cluster: Optional[Cluster] = None,
                  max_active: Optional[int] = None,
                  swap_slowdown: float = 0.5,
                  collect_series: bool = False, device="cuda") -> dict:
    """Chunked streaming replay of a frozen compiled trace.

    Splits ``trace`` into ``chunk_intervals``-sized tapes and threads the
    carry through consecutive chunks; the summary equals the one-shot
    ``driver.run_trace_engine(engine, trace, es0)`` episode (the same
    launches in the same order: only the chunk boundaries move).  With
    ``collect_series`` the summary also carries the concatenated telemetry
    series and its percentile estimates, as ``telemetry="interval"``
    episodes do."""
    cluster = cluster or make_cluster()
    K = max_active or default_capacity([trace])
    r = StreamRunner(engine, es0, interval_s=trace.interval_s,
                     substeps=trace.substeps, max_active=K,
                     cluster=cluster, swap_slowdown=swap_slowdown,
                     device=device)
    led = get_ledger()
    chunks = []
    for t0, tape in chunk_tapes(trace, chunk_intervals):
        with led.span("stream_chunk", engine=engine.name, idx=r.n_chunks,
                      t0=t0, n_intervals=int(tape["valid"].shape[0])):
            chunks.append(r.run_chunk(tape))
    s = r.summary(trace.n_intervals)
    if collect_series:
        series = np.concatenate(chunks, axis=0)
        s.update(series_percentiles(series, r.tcols))
        s["telemetry"] = {"cols": list(r.tcols), "series": series}
    return s


def serve(engine, es0, feeder: StreamFeeder, *, chunk_intervals: int = 64,
          max_active: int = 512, target_tasks: int = 10_000,
          window_intervals: int = 256, prefetch: int = 2,
          swap_slowdown: float = 0.5, on_chunk=None,
          device="cuda") -> dict:
    """The always-on serving loop: stream Poisson arrivals through the
    chunked interval program until the feeder has offered at least
    ``target_tasks`` tasks, generating tapes on the host while the device
    runs.

    A daemon feeder thread fills a ``prefetch``-deep queue with chunk
    tapes (``prefetch=2``: chunk N+1's tape is generated while chunk N
    runs); the main thread drains it through a ``StreamRunner``.  The
    feeder alone decides when to stop, so the report does not depend on
    thread timing.  ``on_chunk(i, runner, rolling)`` fires after every
    chunk (progress, memory samples).  A feeder exception is re-raised
    here.

    Returns the serving report: the admission ledger (``offered == fed +
    feeder_overflow``, ``admitted == fed - dropped``, ``admitted ==
    finished + live``), ring occupancy (first-half and second-half means:
    the flat-occupancy soak criterion), the rolling-window snapshot, and
    the cumulative §6.4 summary."""
    runner = StreamRunner(engine, es0, interval_s=feeder.interval_s,
                          substeps=feeder.substeps, max_active=max_active,
                          cluster=feeder.cluster,
                          swap_slowdown=swap_slowdown, device=device)
    rolling = RollingMetrics(runner.tcols, window_intervals,
                             feeder.interval_s)
    led = get_ledger()
    q: "queue.Queue" = queue.Queue(maxsize=max(1, int(prefetch)))
    stop = threading.Event()
    feed_err = []

    def _feed(parent):
        try:
            while not stop.is_set() and feeder.offered < target_tasks:
                t0 = feeder.n_intervals
                with led.span("feed", parent=parent, t0=t0,
                              n_intervals=chunk_intervals):
                    tape = feeder.next_chunk(chunk_intervals)
                q.put(tape)
        except BaseException as e:  # re-raised in the caller below
            feed_err.append(e)
        finally:
            q.put(None)

    occupancy = []
    i_active = runner.tcols.index("n_active")
    with led.span("serve", engine=engine.name, capacity=max_active,
                  chunk_intervals=chunk_intervals,
                  target_tasks=target_tasks) as serving:
        th = threading.Thread(target=_feed, args=(serving,),
                              name="stream-feeder", daemon=True)
        th.start()
        try:
            while True:
                tape = q.get()
                if tape is None:
                    break
                with led.span("stream_chunk", engine=engine.name,
                              idx=runner.n_chunks, t0=runner.t0,
                              n_intervals=int(tape["valid"].shape[0]),
                              n_tasks=int(tape["valid"].sum())):
                    series = runner.run_chunk(tape)
                rolling.update(series)
                occupancy.append(series[:, i_active])
                if on_chunk is not None:
                    on_chunk(runner.n_chunks, runner, rolling)
        finally:
            stop.set()
            # unblock a feeder waiting on a full queue, then join it
            while th.is_alive():
                try:
                    q.get(timeout=0.05)
                except queue.Empty:
                    pass
            th.join()
    if feed_err:
        raise feed_err[0]
    summary = runner.summary()
    out = runner.raw_outputs()
    occ = np.concatenate(occupancy) if occupancy else np.zeros(1)
    h = len(occ) // 2
    dropped = int(out["dropped"])
    return {
        "engine": engine.name,
        "chunk_intervals": chunk_intervals,
        "window_intervals": window_intervals,
        "capacity": max_active,
        "n_chunks": runner.n_chunks,
        "n_intervals": runner.t0,
        "offered": feeder.offered,
        "fed": feeder.fed,
        "feeder_overflow": feeder.overflow,
        "dropped": dropped,
        "admitted": feeder.fed - dropped,
        "finished": int(summary["tasks_completed"]),
        "live": int(out["live"]),
        "max_occupancy": float(occ.max()),
        "occupancy_mean_first_half": float(occ[:h].mean()) if h else 0.0,
        "occupancy_mean_second_half": float(occ[h:].mean()),
        "rolling": rolling.snapshot(),
        "summary": summary,
    }


def make_stream_policy(policy: str, *, cluster: Optional[Cluster] = None,
                       seed: int = 0, mab_state=None, daso_theta=None,
                       daso_cfg=None, gillis_state=None, num_apps: int = 3):
    """Resolve a policy name into ``(engine, es0, feeder_kwargs)`` for the
    serving loop; ``es0(cells, device)`` builds the engine state.

    Static BestFit policies (``policies.STATIC_POLICIES``) get a host
    decider feeder; the learned policies get dual-variant feeders with
    their engine state: ``"mab"`` / ``"splitplace"`` / ``"mab+gobi"``
    continue ``mab_state`` (a fresh ``mab.init_state`` when None: a cold
    start), ``"splitplace"`` / ``"mab+gobi"`` add the frozen DASO
    surrogate when ``daso_cfg`` and ``daso_theta`` are given, and
    ``"gillis"`` carries its Q-table and ε (zeros and ε₀ when
    ``gillis_state`` is None) and draws from ``trace_train_key(seed)``.
    The training loop is not streamed."""
    cluster = cluster or make_cluster()
    if policy in pol.STATIC_POLICIES:
        dec = pol.make_static_decider(policy, mab_state=mab_state)
        return engines.StaticEngine(), (lambda cells, dev: {}), \
            {"decider": dec}
    if policy in pol.MAB_LEARNED_POLICIES:
        if mab_state is None:
            mab_state = mab_mod.init_state(num_apps, device="cpu")
        cfg = daso_cfg
        if policy == "mab+gobi" and cfg is not None:
            cfg = cfg._replace(decision_aware=False)
        if policy == "mab":
            cfg = None
        theta = driver._check_learned_args(cfg, daso_theta, cluster.n)
        engine = engines.MABDeployEngine(mab_hp=tuple(driver.MAB_HP),
                                         daso_cfg=cfg)
        return engine, driver._deploy_es(mab_state, theta), \
            {"variants": engines.MAB_VARIANTS}
    if policy == "gillis":
        engine = engines.GillisEngine(gillis_hp=tuple(driver.GILLIS_HP))
        es0 = driver._gillis_es([seed], gillis_state, num_apps,
                                driver.GILLIS_HP[0])
        return engine, es0, {"variants": engines.GILLIS_VARIANTS}
    raise ValueError(f"unknown streaming policy {policy!r} (want one of "
                     f"{pol.STATIC_POLICIES + pol.LEARNED_POLICIES})")
