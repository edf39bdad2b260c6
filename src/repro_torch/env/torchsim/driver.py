"""Trace/grid drivers: the interval program over a device-resident grid.

The port of ``repro.env.jaxsim.driver`` for every engine: static,
MAB-deploy (BestFit or DASO placement), static-decider DASO (fixed or
random split), MAB-train (ε-greedy decisions and online DASO finetuning)
and Gillis.
``run_program`` is THE interval program: a Python loop over intervals
whose every step works on the whole grid at once (leading axis
G), calling the engine's ``decide / place / feedback`` hooks around the
shared physics.  ``run_grid_engine`` compiles nothing: it stacks the
traces, uploads them once (``arrays.to_device``) and runs the loop on
``device``, as one call by default, or cut into thread chunks
(``threads``) or device shards (``devices``, ``launch.mesh.
make_grid_mesh``).  ``run_trace_*`` is the same with G=1.

The loop's body is ``run_intervals``: intervals ``[t0, t0 + T)`` over a
given carry ``(state, acc, es)`` (``init_carry`` builds the first).  The
whole-trace program runs it once from t0 = 0; the streaming driver
(``stream.py``) runs it chunk after chunk through ``run_chunk``, whose
tape leaves read the absolute interval index (``_ShiftedLeaf``).  PyTorch
compiles nothing per shape, so unlike the reference there is no runner
cache and no compile per chunk shape.

``telemetry="interval"`` records a per-interval series on the device: one
(G, T, C) float64 tensor whose row t is written in place at the end of
interval t (``metrics.TELEMETRY_COLS`` plus the engine's
``telemetry_cols()``), copied to the host once after the loop; the
summaries gain it and binned response/wait percentiles.  The default
``"summary"`` runs exactly the launches it always has.  The host side of
every grid is recorded in the active ``repro_torch.obs`` ledger: a
``grid`` span per ``run_grid_engine`` call around its ``upload``,
``dispatch`` and ``summarize`` spans.

Every entry point runs on ``device="cuda"`` unless the caller asks for
the CPU, and raises when CUDA is asked for and absent.
"""
from __future__ import annotations

import contextlib
import math
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import daso as daso_mod
from repro_torch.core import mab as mab_mod
from repro_torch.core.mab import (MABState, mab_state_from_numpy,
                                  timed_host_reads)
from repro_torch.core.prng import prng_key
from repro_torch.device import part_stream, resolve
from repro_torch.env.cluster import Cluster, make_cluster
from repro_torch.env.torchsim import engines, kernels
from repro_torch.env.metrics import TELEMETRY_COLS, series_percentiles
from repro_torch.env.torchsim.arrays import (ClusterArrays, DualTraceArrays,
                                             TraceArrays,
                                             check_grid_homogeneous,
                                             default_capacity, stack_traces,
                                             to_device)
from repro_torch.env.workload import layer_ref_response_s
from repro_torch.obs import get_ledger

#: MAB hyperparameters of the in-loop learned policies, matching the host
#: ``MABDecider`` defaults: (ucb_c, phi, gamma, k)
MAB_HP = (0.5, 0.3, 0.3, 0.1)

#: DASO finetuning hyperparameters, matching the host ``SurrogatePlacer``
#: defaults: (alpha, beta, train_steps, place_min, train_min); the last
#: two are the cold-start gates (ascend the surrogate only from interval
#: ``place_min``, train only once ``train_min`` records exist)
TRAIN_HP = (0.5, 0.5, 4, daso_mod.PLACE_MIN, daso_mod.TRAIN_MIN)

#: Gillis baseline hyperparameters, matching the host ``GillisDecider``
#: defaults: (eps0, lr, decay)
GILLIS_HP = (0.5, 0.3, 0.995)

#: layout of the packed per-substep metric accumulator:
#: [n_fin, Σresp, n_viol, Σacc, Σreward, Σwait, fin_dec·3]
METRIC_COLS = ("n_fin", "sum_resp", "n_viol", "sum_acc", "sum_reward",
               "sum_wait", "fin_layer", "fin_semantic", "fin_compressed")

#: phases of ``run_program`` timed when the caller passes ``phase_s``; the
#: dict also gets "mab_host_read", the part of "feedback" the MAB's and
#: Gillis's per-interval host reads take (``mab.timed_host_reads``), and,
#: where the engine runs them, "draw" (the threefry draws' part of
#: "decide") and "daso_train" (the DASO finetune's part of "feedback")
PHASES = ("decide", "place", "physics", "feedback")

f8 = torch.float64


def _init_acc(G: int, n: int, device) -> dict:
    def z(*shape):
        return torch.zeros((G,) + shape, dtype=f8, device=device)
    return {"now": z(), "energy": z(), "pwt": z(n),
            "metrics": z(len(METRIC_COLS))}


def _interval_physics(state, acc, bw_row, cl, substeps, dt, interval_s,
                      swap_slowdown):
    """Shared interval tail for every engine: waiting-time accounting, the
    substep physics, and the utilization → power → energy accumulation.
    Also returns the per-worker interval utilization."""
    state = dict(state)
    state["wait_s"] = state["wait_s"] + \
        (state["alive"] & ~state["placed"]).to(f8) * interval_s
    state, acc, busy = kernels.run_substeps(
        state, acc, bw_row, cl, substeps=substeps, dt=dt,
        swap_slowdown=swap_slowdown)
    util = busy / interval_s
    power = cl["power_idle"] + (cl["power_peak"] - cl["power_idle"]) \
        * torch.clamp(util, 0.0, 1.0)
    acc = dict(acc)
    acc["energy"] = acc["energy"] + power.sum(dim=1) * interval_s
    return state, acc, util


class PhaseClock:
    """Adds each phase's wall seconds (after a device synchronize) into a
    caller-owned dict; does nothing when the dict is None."""

    def __init__(self, phase_s: Optional[dict], device):
        self.phase_s = phase_s
        self.device = device
        if phase_s is not None:
            for p in PHASES:
                phase_s.setdefault(p, 0.0)
            self._sync()
            self._t = time.perf_counter()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def lap(self, phase: str):
        if self.phase_s is None:
            return
        self._sync()
        now = time.perf_counter()
        self.phase_s[phase] += now - self._t
        self._t = now


def _telemetry_base_row(state, acc, m0, e0, d0, util, fin):
    """One float64 row per cell of the per-interval telemetry series (the
    ``metrics.TELEMETRY_COLS`` layout), (G, 18): interval deltas of the
    packed metrics, the drop counter and the energy; the finishers'
    response and wait extremes (0.0 in a cell where none finished); the
    per-worker utilization's mean and max; end-of-interval slot
    occupancy.  ``m0``/``e0``/``d0`` are the interval-entry snapshots the
    deltas subtract.  Built on the device: nothing is read back."""
    md = acc["metrics"] - m0
    have = md[:, 0] > 0
    resp, wait = state["resp"], state["wait_s"]
    # the four extremes as one masked min: (min r, -max r, min w, -max w)
    x = torch.stack([resp, resp.neg(), wait, wait.neg()], dim=1)
    ext = torch.where(fin[:, None], x, math.inf).amin(dim=2)
    ext[:, 1::2].neg_()
    ext = torch.where(have[:, None], ext, 0.0)
    return torch.cat([md, (state["dropped"] - d0).to(f8)[:, None],
                      (acc["energy"] - e0)[:, None], ext,
                      util.mean(dim=1)[:, None], util.amax(dim=1)[:, None],
                      state["alive"].sum(dim=1, dtype=f8)[:, None]], dim=1)


def _check_telemetry(engine, telemetry):
    """Validate the knob and resolve the full column tuple (base + the
    engine's learning-signal columns); None in summary mode."""
    if telemetry not in ("summary", "interval"):
        raise ValueError(f"telemetry={telemetry!r} "
                         "(want 'summary' or 'interval')")
    if telemetry == "summary":
        return None
    return tuple(TELEMETRY_COLS) + tuple(engine.telemetry_cols())


def run_program(engine, trace: dict, cl: dict, es, K: int, substeps: int,
                interval_s: float, swap_slowdown: float,
                phase_s: Optional[dict] = None,
                telemetry: str = "summary") -> dict:
    """THE interval program over a stacked device grid ``trace`` (leaves
    (G, T, ...)) and cluster rows ``cl``; returns the per-cell
    accumulators and the engine's outputs as device tensors.  With
    ``phase_s`` the wall time of each of ``PHASES`` is added into it
    (synchronizing the device at every phase boundary).  With
    ``telemetry="interval"`` the outputs gain ``"telemetry"``, the (G, T,
    C) series (its rows written at the end of each interval's feedback,
    inside phase ``feedback``)."""
    tcols = _check_telemetry(engine, telemetry)
    with timed_host_reads(phase_s):
        return _run_program(engine, trace, cl, es, K, substeps, interval_s,
                            swap_slowdown, phase_s, tcols)


def init_carry(G: int, K: int, F: int, n: int, device):
    """The interval program's starting carry for G cells: the empty slot
    store (K slots of F fragment columns over n workers) and zeroed
    accumulators; the engine state joins it as the carry's third part."""
    return kernels.init_state(G, K, F, n, device), _init_acc(G, n, device)


def run_intervals(engine, trace, cl, carry, t0: int, T: int, substeps: int,
                  interval_s: float, swap_slowdown: float,
                  clock: PhaseClock, series=None):
    """THE interval body: intervals ``[t0, t0 + T)`` over the carry
    ``(state, acc, es)``; returns the carry they leave.  ``trace[k][:, t]``
    must read interval ``t`` for the absolute ``t`` every hook sees (a
    whole trace with ``t0 = 0``, or a chunk tape behind
    ``_ShiftedLeaf``).  ``series`` (G, T, C), when given, gets interval
    ``t``'s telemetry row at ``t - t0``."""
    state, acc, es = carry
    dt = interval_s / substeps
    for t in range(t0, t0 + T):
        if series is not None:
            m0, e0, d0 = acc["metrics"], acc["energy"], state["dropped"]
        arr, es = engine.decide(es, trace, t)
        state = kernels.admit(state, arr)
        clock.lap("decide")
        req, es, aux = engine.place(es, state, cl, trace, t, interval_s)
        state = kernels.apply_requests(state, cl, req)
        clock.lap("place")
        prev_done = state["task_done"]
        state, acc, util = _interval_physics(
            state, acc, trace["bw_mult"][:, t], cl, substeps, dt,
            interval_s, swap_slowdown)
        clock.lap("physics")
        fin = state["task_done"] & ~prev_done
        es = engine.feedback(es, state, fin, util, aux, t, interval_s)
        state["alive"] = state["alive"] & ~state["task_done"]
        if series is not None:
            row = _telemetry_base_row(state, acc, m0, e0, d0, util, fin)
            erow = engine.telemetry_row(es)
            series[:, t - t0] = row if erow is None else \
                torch.cat([row, erow.to(f8)], dim=1)
        clock.lap("feedback")
    return state, acc, es


def _run_program(engine, trace, cl, es, K, substeps, interval_s,
                 swap_slowdown, phase_s, tcols):
    G, T = trace["valid"].shape[:2]
    frag = trace["vinstr"] if "vinstr" in trace else trace["instr"]
    F = frag.shape[-1]
    n = cl["ram"].shape[0]
    device = trace["valid"].device
    state, acc = init_carry(G, K, F, n, device)
    clock = PhaseClock(phase_s, device)
    series = None if tcols is None else \
        torch.zeros((G, T, len(tcols)), dtype=f8, device=device)
    state, acc, es = run_intervals(engine, trace, cl, (state, acc, es), 0,
                                   T, substeps, interval_s, swap_slowdown,
                                   clock, series)
    out = {"metrics": acc["metrics"], "energy": acc["energy"],
           "pwt": acc["pwt"], "dropped": state["dropped"]}
    if series is not None:
        out["telemetry"] = series
    out.update(engine.outputs(es))
    return out


# ------------------------------------------------ streaming chunk program


class _ShiftedLeaf:
    """A chunk tape's (G, T_chunk, ...) leaf read at the ABSOLUTE interval
    index: ``leaf[:, t]`` is the tape's column ``t - t0``.  The hooks fold
    ``t`` into their draws (``threefry_rows(key, t, ...)``), so a chunk
    must show them the episode's ``t``, not the chunk-local one."""

    __slots__ = ("arr", "t0")

    def __init__(self, arr, t0: int):
        self.arr = arr
        self.t0 = t0

    def __getitem__(self, idx):
        g, t = idx
        return self.arr[g, t - self.t0]


def run_chunk(engine, tape: dict, cl: dict, carry, t0: int, substeps: int,
              interval_s: float, swap_slowdown: float, tcols):
    """The carry-re-entrant chunk program of the streaming driver: the
    device tape ``tape`` (leaves (G, T_chunk, ...)) holds intervals
    ``[t0, t0 + T_chunk)`` of one endless episode, the carry enters as an
    argument and leaves as a result, and the chunk's (G, T_chunk, C)
    telemetry series (always on: the rolling metrics read it) comes back
    beside it.  The body is ``run_intervals``, the one the whole-trace
    program runs."""
    G, T = tape["valid"].shape[:2]
    device = tape["valid"].device
    series = torch.zeros((G, T, len(tcols)), dtype=f8, device=device)
    shifted = {k: _ShiftedLeaf(v, t0) for k, v in tape.items()}
    carry = run_intervals(engine, shifted, cl, carry, t0, T, substeps,
                          interval_s, swap_slowdown,
                          PhaseClock(None, device), series)
    return carry, series


def _summarize(out, interval_s: float, n_intervals: int,
               cost_hr_total: float, telemetry_cols=None) -> dict:
    """Assemble the §6.4 summary dict from one cell's accumulators
    (NumPy).  With ``telemetry_cols`` (interval mode) it also carries the
    per-interval series under ``"telemetry"`` and the percentile estimates
    binned from it (``metrics.series_percentiles``, whose error bound is
    ``percentile_err_s``)."""
    m = dict(zip(METRIC_COLS, np.asarray(out["metrics"], np.float64)))
    n_fin = m["n_fin"]
    d = max(n_fin, 1.0)
    mean_resp = m["sum_resp"] / d
    mean_wait = m["sum_wait"] / d
    pwt = np.asarray(out["pwt"], np.float64)
    tot = pwt.sum()
    fair = float(tot ** 2 / (len(pwt) * np.sum(pwt ** 2) + 1e-12)) \
        if tot > 0 else 1.0
    cost = cost_hr_total * interval_s / 3600.0 * n_intervals
    s = {
        "accuracy": float(m["sum_acc"] / d),
        "sla_violations": float(m["n_viol"] / d),
        "reward": float(m["sum_reward"] / d),
        "response_intervals": float(mean_resp / interval_s),
        "wait_intervals": float(mean_wait / interval_s),
        "exec_intervals": float((mean_resp - mean_wait) / interval_s),
        "energy_mwhr": float(out["energy"]) / 3.6e9,
        "fairness": fair,
        "cost_per_container": float(cost / max(1, int(tot))),
        "layer_fraction": float(m["fin_layer"] / d),
        "tasks_completed": int(n_fin),
        "dropped_tasks": int(out["dropped"]),
    }
    if telemetry_cols is not None:
        series = np.asarray(out["telemetry"], np.float64)[:n_intervals]
        s.update(series_percentiles(series, telemetry_cols))
        s["telemetry"] = {"cols": list(telemetry_cols), "series": series}
    return s


def _grid_parts(traces, devs):
    """The grid padded to a multiple of ``len(devs)`` by repeating the last
    trace (its arrivals masked off in ``run_grid_engine``: dead cells that
    admit nothing), cut into one contiguous slice per entry of ``devs``;
    returns [(chunk, device)]."""
    check_grid_homogeneous(traces)
    padded = list(traces) + [traces[-1]] * ((-len(traces)) % len(devs))
    per = len(padded) // len(devs)
    return [(padded[i * per:(i + 1) * per], d) for i, d in enumerate(devs)]


@contextlib.contextmanager
def _on_device(dev, stream):
    """``dev`` as the current CUDA device (the kernels launch on the
    current stream), with ``stream`` (a part's own, or None) as the
    current stream, so that one part's host reads wait for its own
    launches only, not for another part's on the same card; nothing on
    the CPU."""
    if dev.type != "cuda":
        yield
        return
    with torch.cuda.device(dev):
        if stream is None:
            yield
            return
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            yield


def _run_parts(run, parts):
    """``run`` over every part, from a thread each when there are several
    (each part's interval program enqueues and syncs on its own stream;
    the host work between launches is what the threads overlap)."""
    if len(parts) == 1:
        return [run(parts[0])]
    with ThreadPoolExecutor(max_workers=len(parts)) as ex:
        return list(ex.map(run, parts))


def run_grid_engine(engine, traces: Sequence, es_builder: Callable,
                    cluster: Optional[Cluster] = None,
                    max_active: Optional[int] = None,
                    swap_slowdown: float = 0.5, device="cuda",
                    phase_s: Optional[dict] = None,
                    telemetry: str = "summary",
                    threads: Optional[int] = None, devices=None) -> list:
    """Run a grid of compiled traces through the interval program under
    ``engine``; returns one summary dict per trace (same order).
    ``es_builder(chunk, device)`` builds the engine state of a chunk of
    traces on ``device``, one row per cell (per-cell leaves, the seed
    keys, follow their traces).  ``telemetry="interval"`` adds each
    cell's per-interval series and percentile estimates to its summary.

    Dispatch: by default (``threads=None``, ``devices=None``) the whole
    grid is one call of the interval program on ``device``.  ``devices``
    (``"auto"``, an int or a list of devices: ``launch.mesh.
    make_grid_mesh``; its devices must be of ``device``'s type) shards it
    into one contiguous slice per device; ``threads=n`` (without
    ``devices``) into n slices on ``device``, as ``devices=[device] * n``
    does.  Each slice runs from a thread of its own, on a CUDA stream of
    its own; the grid is padded to a multiple of the slice count with
    dead cells whose rows are dropped.  Every part is stacked at the
    grid's common arrival and fragment pads and slot capacity; cells are
    independent, so per cell the results do not depend on the
    dispatch.  ``phase_s`` times one call and raises with more than one
    part; the kernels' launch counters are plain attributes, exact only
    around a run of one part."""
    tcols = _check_telemetry(engine, telemetry)
    if devices is not None:
        from repro_torch.launch.mesh import make_grid_mesh
        devs = make_grid_mesh(devices)
        kind = torch.device(device).type
        if any(d.type != kind for d in devs):
            raise ValueError(f"devices={devices!r} gives {devs}, not all of "
                             f"device={device!r}'s type {kind!r}")
    else:
        devs = [resolve(device)] * max(1, min(int(threads or 1),
                                              len(traces)))
    parts = _grid_parts(traces, devs)
    if phase_s is not None and len(parts) > 1:
        raise ValueError(f"phase_s times one call of the interval program; "
                         f"this grid runs as {len(parts)} parts (threads="
                         f"{threads!r}, devices={devices!r})")
    led = get_ledger()
    cluster = cluster or make_cluster()
    cl = ClusterArrays.from_cluster(cluster)
    K = max_active or default_capacity(traces)
    t0 = traces[0]
    G = len(traces)
    with led.span("grid", engine=engine.name, n_traces=G,
                  device=parts[0][1].type, telemetry=telemetry,
                  n_parts=len(parts)):
        with led.span("upload", engine=engine.name, n_traces=G):
            stacked = stack_traces([t for chunk, _ in parts for t in chunk])
            stacked["valid"][G:] = False          # the dead padded cells
            jobs, lo = [], 0
            for i, (chunk, dev) in enumerate(parts):
                hi = lo + len(chunk)
                own = len(parts) > 1 and dev.type == "cuda"
                jobs.append((to_device({k: v[lo:hi]
                                        for k, v in stacked.items()}, dev),
                             to_device(cl.as_dict(), dev),
                             es_builder(chunk, dev), dev,
                             part_stream(dev, i) if own else None))
                lo = hi

        def run(job):
            leaves, cld, es, dev, stream = job
            with _on_device(dev, stream):
                out = run_program(engine, leaves, cld, es, K, t0.substeps,
                                  t0.interval_s, swap_slowdown, phase_s,
                                  telemetry)
                return _tree(out, lambda v: v.cpu().numpy())

        with led.span("dispatch", engine=engine.name, n_traces=G,
                      telemetry=telemetry, n_parts=len(parts)):
            outs = _run_parts(run, jobs)
        rows = [_tree(out, lambda v: v[i]) for out in outs
                for i in range(len(out["dropped"]))][:G]
        cost_total = float(cl.cost_hr.sum())
        with led.span("summarize", engine=engine.name, n_traces=G):
            return [engine.summarize(row, _summarize(
                row, t0.interval_s, t0.n_intervals, cost_total,
                telemetry_cols=tcols)) for row in rows]


def _tree(x, fn):
    """``fn`` applied to every leaf of nested dicts and lists."""
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    if isinstance(x, list):
        return [_tree(v, fn) for v in x]
    return fn(x)


def run_trace_engine(engine, trace, es_builder: Callable, **kw) -> dict:
    """One compiled trace through the interval program (a grid of one)."""
    return run_grid_engine(engine, [trace], es_builder, **kw)[0]


# ------------------------------------------------ engine-state assembly


def _check_variants(traces, expected):
    """A dual trace's V axis must realize the decision codes the engine
    decides between."""
    for t in traces:
        got = tuple(getattr(t, "variants", (0, 1)))
        if got != tuple(expected):
            raise ValueError(
                f"trace realizes variants {got}, engine needs "
                f"{tuple(expected)} (compile_trace_dual(variants=...))")


def _mab_es(mab_state):
    """Engine-state builder for the MAB engines: every cell starts from
    its own copy of ``mab_state`` — a port ``MABState`` with a grid axis
    of 1 (or of G, one row per cell: then the grid runs as one part), or
    the reference's fields as a dict of NumPy arrays (see
    ``mab_state_from_numpy``)."""
    def build(chunk, dev):
        G = len(chunk)
        if isinstance(mab_state, MABState):
            g0 = mab_state.Q.shape[0]
            if g0 not in (1, G):
                raise ValueError(f"mab_state has a grid axis of {g0}, the "
                                 f"part of the grid has {G} cells (a "
                                 f"per-cell state runs the grid as one "
                                 f"part: threads=None, devices=None)")
            return {"mab": MABState(*[
                v.to(dev).expand(G, *v.shape[1:]).clone()
                for v in mab_state])}
        return {"mab": mab_state_from_numpy(mab_state, grid=G, device=dev)}
    return build


def _deploy_es(mab_state, theta):
    """The ``es_builder`` of the MAB deploy engine: each cell's copy of
    ``mab_state`` and θ on the device (``()`` under BestFit placement)."""
    mab_es = _mab_es(mab_state)

    def build(chunk, dev):
        es = mab_es(chunk, dev)
        es["theta"] = _theta_on(theta, dev)
        return es
    return build


def _check_learned_args(daso_cfg, daso_theta, n):
    if daso_cfg is None:
        return ()                         # BestFit placement: no surrogate
    if daso_theta is None:
        raise ValueError("the DASO placer needs pretrained theta")
    if daso_cfg.num_workers != n:
        raise ValueError(f"daso_cfg.num_workers={daso_cfg.num_workers} "
                         f"!= cluster size {n}")
    return daso_theta


def _theta_on(theta, dev):
    """θ (the port's tensors, or the reference's NumPy ``{"w", "b"}``
    list) on ``dev`` as float64, exactly: the DASO stage ascends in
    float64."""
    if not theta:
        return ()
    return [{k: torch.as_tensor(v).to(device=dev, dtype=f8)
             for k, v in layer.items()} for layer in theta]


# ------------------------------------------------- engine-selecting API


def run_grid_arrays(traces: Sequence[TraceArrays],
                    cluster: Optional[Cluster] = None,
                    max_active: Optional[int] = None,
                    swap_slowdown: float = 0.5, device="cuda",
                    phase_s: Optional[dict] = None,
                    telemetry: str = "summary",
                    threads: Optional[int] = None, devices=None) -> list:
    """Run a grid of statically-decided compiled traces (BestFit
    placement); returns one §6.4 summary dict per trace.  ``threads`` /
    ``devices``: ``run_grid_engine``'s dispatch."""
    return run_grid_engine(engines.StaticEngine(), traces,
                           lambda chunk, dev: {}, cluster=cluster,
                           max_active=max_active,
                           swap_slowdown=swap_slowdown, device=device,
                           phase_s=phase_s, telemetry=telemetry,
                           threads=threads, devices=devices)


def run_trace_arrays(trace: TraceArrays, cluster: Optional[Cluster] = None,
                     max_active: Optional[int] = None,
                     swap_slowdown: float = 0.5, device="cuda",
                     telemetry: str = "summary") -> dict:
    """Run one compiled trace through the static program."""
    return run_grid_arrays([trace], cluster=cluster, max_active=max_active,
                           swap_slowdown=swap_slowdown, device=device,
                           telemetry=telemetry)[0]


def run_grid_arrays_learned(traces: Sequence[DualTraceArrays], mab_state,
                            daso_theta=None, daso_cfg=None,
                            cluster: Optional[Cluster] = None,
                            max_active: Optional[int] = None,
                            swap_slowdown: float = 0.5, device="cuda",
                            mab_hp=MAB_HP,
                            phase_s: Optional[dict] = None,
                            telemetry: str = "summary",
                            threads: Optional[int] = None,
                            devices=None) -> list:
    """Run a grid of dual traces under the deploy-mode MAB policy: online
    UCB split decisions + Algorithm-1 feedback, placed by BestFit, or by
    the DASO stage when ``daso_cfg``/``daso_theta`` are given
    (``daso_cfg.decision_aware=False`` is the GOBI ablation).  Every cell
    carries its own copy of ``mab_state``.  Summaries gain the final MAB
    scalars (``mab_eps``/``mab_rho``/``mab_t``)."""
    _check_variants(traces, engines.MAB_VARIANTS)
    cluster = cluster or make_cluster()
    theta = _check_learned_args(daso_cfg, daso_theta, cluster.n)
    engine = engines.MABDeployEngine(mab_hp=tuple(mab_hp), daso_cfg=daso_cfg)
    return run_grid_engine(engine, traces, _deploy_es(mab_state, theta),
                           cluster=cluster,
                           max_active=max_active,
                           swap_slowdown=swap_slowdown, device=device,
                           phase_s=phase_s, telemetry=telemetry,
                           threads=threads, devices=devices)


def run_trace_arrays_learned(trace: DualTraceArrays, mab_state,
                             daso_theta=None, daso_cfg=None,
                             cluster: Optional[Cluster] = None,
                             max_active: Optional[int] = None,
                             swap_slowdown: float = 0.5, device="cuda",
                             mab_hp=MAB_HP,
                             telemetry: str = "summary") -> dict:
    """Run one dual trace through the deploy-mode MAB program."""
    return run_grid_arrays_learned(
        [trace], mab_state, daso_theta=daso_theta, daso_cfg=daso_cfg,
        cluster=cluster, max_active=max_active, swap_slowdown=swap_slowdown,
        device=device, mab_hp=mab_hp, telemetry=telemetry)[0]


#: the static-decider baseline arms and the ``engines.MAB_VARIANTS`` index
#: each realizes on every row (−1: uniform random per row, ``random+daso``)
STATIC_DASO_ARMS = {"layer+gobi": 0, "semantic+gobi": 1, "random+daso": -1}


def _static_daso_engine(policy, daso_cfg, daso_theta, cluster):
    """One of ``STATIC_DASO_ARMS`` as its engine and frozen θ.  The GOBI
    arms flip ``decision_aware=False`` (the surrogate input's decision
    one-hot slice is zeroed); ``random+daso`` keeps the caller's cfg."""
    if policy not in STATIC_DASO_ARMS:
        raise ValueError(f"policy {policy!r} is not one of "
                         f"{sorted(STATIC_DASO_ARMS)}")
    if daso_cfg is None:
        raise ValueError(f"{policy!r} needs a pretrained DASO surrogate "
                         "(daso_cfg/daso_theta)")
    arm = STATIC_DASO_ARMS[policy]
    if arm >= 0:
        daso_cfg = daso_cfg._replace(decision_aware=False)
    theta = _check_learned_args(daso_cfg, daso_theta, cluster.n)
    engine = engines.StaticDeciderDASOEngine(arm=arm, daso_cfg=daso_cfg,
                                             name=policy)
    return engine, theta


def run_grid_arrays_static_daso(traces: Sequence[DualTraceArrays],
                                policy: str, daso_theta=None, daso_cfg=None,
                                cluster: Optional[Cluster] = None,
                                max_active: Optional[int] = None,
                                swap_slowdown: float = 0.5, device="cuda",
                                phase_s: Optional[dict] = None,
                                telemetry: str = "summary",
                                threads: Optional[int] = None,
                                devices=None) -> list:
    """Run a grid of dual traces under a static-decider baseline arm
    (``layer+gobi`` / ``semantic+gobi``: a fixed split, placed by the
    decision-blind DASO stage; ``random+daso``: a fair coin per row from
    ``trace_train_key(trace.seed)``, placed by the decision-aware stage);
    one §6.4 summary dict per trace."""
    _check_variants(traces, engines.MAB_VARIANTS)
    cluster = cluster or make_cluster()
    engine, theta = _static_daso_engine(policy, daso_cfg, daso_theta,
                                        cluster)

    def build(chunk, dev):
        es = {"theta": _theta_on(theta, dev)}
        if engine.arm < 0:
            es["key"] = _trace_keys(chunk, dev)
        return es

    return run_grid_engine(engine, traces, build, cluster=cluster,
                           max_active=max_active,
                           swap_slowdown=swap_slowdown, device=device,
                           phase_s=phase_s, telemetry=telemetry,
                           threads=threads, devices=devices)


def run_trace_arrays_static_daso(trace: DualTraceArrays, policy: str,
                                 daso_theta=None, daso_cfg=None,
                                 cluster: Optional[Cluster] = None,
                                 max_active: Optional[int] = None,
                                 swap_slowdown: float = 0.5,
                                 device="cuda",
                                 telemetry: str = "summary") -> dict:
    """Run one dual trace under a static-decider baseline arm."""
    return run_grid_arrays_static_daso(
        [trace], policy, daso_theta=daso_theta, daso_cfg=daso_cfg,
        cluster=cluster, max_active=max_active, swap_slowdown=swap_slowdown,
        device=device, telemetry=telemetry)[0]


def trace_train_key(seed: int, device="cpu"):
    """The per-trace PRNG key of the train, Gillis and random-arm loops:
    ``jax.random.PRNGKey(seed)``, (2,) int64 words."""
    return prng_key(seed, device=device)


def _seed_keys(seeds, dev):
    return torch.stack([trace_train_key(s, dev) for s in seeds])


def _trace_keys(traces, dev):
    return _seed_keys([t.seed for t in traces], dev)


def run_grid_arrays_trained(traces: Sequence[DualTraceArrays], mab_state,
                            daso_theta=None, daso_cfg=None,
                            daso_opt_state=None,
                            cluster: Optional[Cluster] = None,
                            max_active: Optional[int] = None,
                            swap_slowdown: float = 0.5, device="cuda",
                            mab_hp=MAB_HP, train_hp=TRAIN_HP,
                            phase_s: Optional[dict] = None,
                            telemetry: str = "summary",
                            threads: Optional[int] = None,
                            devices=None) -> list:
    """Run a grid of dual traces with the §6.3 training loop: ε-greedy MAB
    decisions + Algorithm-1 feedback, and with ``daso_cfg``/``daso_theta``
    online DASO finetuning (replay-window appends and weighted AdamW
    epochs in the loop).  Every cell carries its own copies of
    ``mab_state``, θ (float32), the AdamW state (``daso_opt_state`` or
    fresh) and the replay window; its draws come from
    ``trace_train_key(trace.seed)``.  Summaries gain the final MAB scalars
    and, with DASO, the finetuned θ under ``"daso_theta"`` (the
    reference's NumPy ``{"w", "b"}`` list)."""
    _check_variants(traces, engines.MAB_VARIANTS)
    cluster = cluster or make_cluster()
    theta = _check_learned_args(daso_cfg, daso_theta, cluster.n)
    engine = engines.MABTrainEngine(mab_hp=tuple(mab_hp),
                                    train_hp=tuple(train_hp),
                                    daso_cfg=daso_cfg)
    mab_es = _mab_es(mab_state)

    def build(chunk, dev):
        G = len(chunk)
        es = mab_es(chunk, dev)
        es["key"] = _trace_keys(chunk, dev)
        es["theta"], es["opt"], es["win"] = (), (), {}
        if daso_cfg is not None:
            es["theta"] = daso_mod.theta_cells(theta, G, dev)
            es["opt"] = daso_mod.opt_state_cells(daso_opt_state,
                                                 es["theta"], G, dev)
            es["win"] = daso_mod.window_init(daso_cfg, G, dev)
        return es

    return run_grid_engine(engine, traces, build, cluster=cluster,
                           max_active=max_active,
                           swap_slowdown=swap_slowdown, device=device,
                           phase_s=phase_s, telemetry=telemetry,
                           threads=threads, devices=devices)


def run_trace_arrays_trained(trace: DualTraceArrays, mab_state,
                             daso_theta=None, daso_cfg=None,
                             daso_opt_state=None,
                             cluster: Optional[Cluster] = None,
                             max_active: Optional[int] = None,
                             swap_slowdown: float = 0.5, device="cuda",
                             mab_hp=MAB_HP, train_hp=TRAIN_HP,
                             telemetry: str = "summary") -> dict:
    """Run one dual trace through the training loop."""
    return run_grid_arrays_trained(
        [trace], mab_state, daso_theta=daso_theta, daso_cfg=daso_cfg,
        daso_opt_state=daso_opt_state, cluster=cluster,
        max_active=max_active, swap_slowdown=swap_slowdown, device=device,
        mab_hp=mab_hp, train_hp=train_hp, telemetry=telemetry)[0]


def gillis_layer_ref(num_apps: int = 3):
    """The (num_apps,) unloaded layer-chain reference times the Gillis
    context bucket compares deadlines with."""
    return np.array([layer_ref_response_s(a) for a in range(num_apps)],
                    np.float64)


def gillis_init_state(num_apps: int = 3, eps0: float = GILLIS_HP[0]):
    """Fresh Gillis carry pieces: a zero (apps, 2, 2) Q-table and ε₀,
    float64 NumPy.  Pass a previous run's ``{"Q": gillis_q, "eps":
    gillis_eps}`` instead to continue one."""
    return {"Q": np.zeros((num_apps, 2, 2), np.float64),
            "eps": np.float64(eps0)}


def _gillis_es(seeds, gillis_state, num_apps: int, eps0: float):
    """The ``es_builder`` of the Gillis engine: every cell starts from its
    own copy of ``gillis_state``, or from zeros and ε₀, and draws from
    ``trace_train_key`` of its seed: its trace's (``seeds`` None), or the
    one of ``seeds`` (one per cell: a stream's, which has no trace)."""
    def build(chunk, dev):
        G = len(chunk)
        if seeds is not None and len(seeds) != G:
            raise ValueError(f"{len(seeds)} seeds for {G} cells")
        if gillis_state is None:
            Q = mab_mod.gillis_init(num_apps, grid=G, device=dev)
            eps = torch.full((G,), eps0, dtype=f8, device=dev)
        else:
            Q = torch.as_tensor(np.asarray(gillis_state["Q"], np.float64),
                                device=dev).expand(G, num_apps, 2, 2)
            eps = torch.as_tensor(np.float64(gillis_state["eps"]),
                                  device=dev).expand(G)
        return {"Q": Q.clone(), "eps": eps.clone(),
                "key": _seed_keys([t.seed for t in chunk] if seeds is None
                                  else seeds, dev),
                "layer_ref": torch.as_tensor(gillis_layer_ref(num_apps),
                                             device=dev)}
    return build


def run_grid_arrays_gillis(traces: Sequence[DualTraceArrays],
                           gillis_state=None,
                           cluster: Optional[Cluster] = None,
                           max_active: Optional[int] = None,
                           swap_slowdown: float = 0.5, device="cuda",
                           gillis_hp=GILLIS_HP, num_apps: int = 3,
                           phase_s: Optional[dict] = None,
                           telemetry: str = "summary",
                           threads: Optional[int] = None,
                           devices=None) -> list:
    """Run a grid of (LAYER, COMPRESSED) dual traces under the Gillis
    baseline: contextual ε-greedy Q-learning with per-interval ε decay and
    per-leaving-task TD(0) updates, BestFit placement.  Every cell starts
    from its own copy of ``gillis_state`` (zeros and ε₀ when None) and
    draws from ``trace_train_key(trace.seed)``.  Summaries gain
    ``gillis_eps`` and the final Q-table ``gillis_q``."""
    _check_variants(traces, engines.GILLIS_VARIANTS)
    engine = engines.GillisEngine(gillis_hp=tuple(gillis_hp))
    return run_grid_engine(engine, traces,
                           _gillis_es(None, gillis_state, num_apps,
                                      gillis_hp[0]),
                           cluster=cluster, max_active=max_active,
                           swap_slowdown=swap_slowdown, device=device,
                           phase_s=phase_s, telemetry=telemetry,
                           threads=threads, devices=devices)


def run_trace_arrays_gillis(trace: DualTraceArrays, gillis_state=None,
                            cluster: Optional[Cluster] = None,
                            max_active: Optional[int] = None,
                            swap_slowdown: float = 0.5, device="cuda",
                            gillis_hp=GILLIS_HP, num_apps: int = 3,
                            telemetry: str = "summary") -> dict:
    """Run one (LAYER, COMPRESSED) dual trace under the Gillis baseline."""
    return run_grid_arrays_gillis(
        [trace], gillis_state, cluster=cluster, max_active=max_active,
        swap_slowdown=swap_slowdown, device=device, gillis_hp=gillis_hp,
        num_apps=num_apps, telemetry=telemetry)[0]
