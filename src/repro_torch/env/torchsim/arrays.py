"""Host-side trace compilation into fixed-capacity padded arrays.

The port of ``repro.env.jaxsim.arrays``.  The workload generator is NumPy
``RandomState`` driven and allocates per-task objects, so the trace
(arrivals, realized fragments, mobility multipliers, pre-sampled
accuracies) is compiled on the host into dense padded NumPy arrays once;
``to_device`` then uploads a stacked grid in one go and the device only
runs placement and physics over it.  The draw sequence is the
reference's, so the arrays come out byte-equal.

Padding conventions:

  * per-interval arrival rows are padded to ``max_arrivals`` with
    ``arr_valid`` masks;
  * per-task fragment columns are padded to ``max_frags``; padding
    fragments are born ``done=True`` with ``worker=-1`` so every physics
    mask excludes them for free.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.env.cluster import Cluster, make_cluster
from repro_torch.env.mobility import MobilityModel
from repro_torch.env.workload import (APP_PROFILES, LAYER, SEMANTIC,
                                      WorkloadGenerator, accuracy_from_noise)


@dataclasses.dataclass
class ClusterArrays:
    """Per-worker constants the kernels consume (all float64/(n,))."""
    mips: np.ndarray
    ram: np.ndarray
    net_bw: np.ndarray
    power_idle: np.ndarray
    power_peak: np.ndarray
    cost_hr: np.ndarray

    @property
    def n(self) -> int:
        return len(self.mips)

    @classmethod
    def from_cluster(cls, cluster: Cluster) -> "ClusterArrays":
        return cls(mips=cluster.mips(), ram=cluster.ram(),
                   net_bw=cluster.net_bw(),
                   power_idle=np.array([t.power_idle for t in cluster.types],
                                       np.float64),
                   power_peak=np.array([t.power_peak for t in cluster.types],
                                       np.float64),
                   cost_hr=cluster.cost_hr())

    def as_dict(self):
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}


@dataclasses.dataclass
class TraceArrays:
    """One compiled (seed, λ) trace.

    Shapes: T = n_intervals, A = max arrivals per interval, F = max
    fragments per task, n = workers.
    """
    lam: float
    seed: int
    interval_s: float
    substeps: int

    bw_mult: np.ndarray        # (T, n) mobility bandwidth multipliers
    arr_valid: np.ndarray      # (T, A) bool
    arr_id: np.ndarray         # (T, A) int64  globally unique task id
    arr_app: np.ndarray        # (T, A) int32
    arr_batch: np.ndarray      # (T, A) int64
    arr_sla: np.ndarray        # (T, A) float64
    arr_arrival_s: np.ndarray  # (T, A) float64 (== sim clock at admission)
    arr_acc: np.ndarray        # (T, A) float64 pre-sampled accuracy
    arr_decision: np.ndarray   # (T, A) int32
    arr_chain: np.ndarray      # (T, A) bool
    arr_nfrag: np.ndarray      # (T, A) int32
    frag_instr: np.ndarray     # (T, A, F) float64
    frag_ram: np.ndarray       # (T, A, F) float64
    frag_out: np.ndarray       # (T, A, F) float64

    @property
    def n_intervals(self) -> int:
        return self.arr_valid.shape[0]

    @property
    def max_arrivals(self) -> int:
        return self.arr_valid.shape[1]

    @property
    def max_frags(self) -> int:
        return self.frag_instr.shape[2]

    @property
    def n_tasks(self) -> int:
        return int(self.arr_valid.sum())

    def kernel_dict(self):
        """The leaves the interval program consumes."""
        return {"bw_mult": self.bw_mult, "valid": self.arr_valid,
                "sla": self.arr_sla, "arrival_s": self.arr_arrival_s,
                "app": self.arr_app, "batch": self.arr_batch,
                "acc": self.arr_acc, "decision": self.arr_decision,
                "chain": self.arr_chain, "nfrag": self.arr_nfrag,
                "instr": self.frag_instr, "ram": self.frag_ram,
                "out_bytes": self.frag_out}


def _check_uniform_ram(task):
    # the physics' per-task RAM census (ram_task @ cnt) relies on every
    # fragment of a task sharing one footprint
    rams = {f.ram_mb for f in task.fragments}
    if len(rams) > 1:
        raise ValueError(
            "the interval program requires a uniform per-task fragment RAM "
            f"footprint; task {task.id} has {sorted(rams)}")


def compile_trace(decider, lam: float = 6.0, seed: int = 0,
                  n_intervals: int = 100, interval_s: float = 300.0,
                  substeps: int = 30, apps: Optional[Sequence[int]] = None,
                  cluster: Optional[Cluster] = None,
                  max_arrivals: Optional[int] = None) -> TraceArrays:
    """Compile one trace: Poisson arrivals + split decisions + realized
    fragments + mobility, as dense padded arrays.

    ``decider`` is a host-side static decider: ``decide(tasks) ->
    List[int]`` (``repro_torch.env.torchsim.policies``).  The clock
    accumulates ``dt`` per substep exactly as the physics does, so
    ``arr_arrival_s`` carries bit-identical timestamps.
    """
    cluster = cluster or make_cluster()
    gen = WorkloadGenerator(lam=lam, seed=seed, apps=apps)
    mob = MobilityModel(cluster.n, cluster.mobile_mask(), seed=seed + 1)
    dt = interval_s / substeps

    per_interval: List[list] = []
    bw_rows = []
    now = 0.0
    for _ in range(n_intervals):
        tasks = gen.arrivals(now)
        decisions = decider.decide(tasks)
        rows = []
        for task, d in zip(tasks, decisions):
            gen.realize(task, int(d))
            _check_uniform_ram(task)
            acc = gen.accuracy_of(task)
            rows.append((task, acc))
        per_interval.append(rows)
        _, bw = mob.step()
        bw_rows.append(bw)
        for _ in range(substeps):
            now += dt

    T = n_intervals
    A = max_arrivals if max_arrivals is not None \
        else max(1, max(len(r) for r in per_interval))
    F = max([1] + [len(t.fragments) for r in per_interval for t, _ in r])
    if max(len(r) for r in per_interval) > A:
        raise ValueError(
            f"max_arrivals={A} < observed {max(len(r) for r in per_interval)}")

    tr = TraceArrays(
        lam=lam, seed=seed, interval_s=interval_s, substeps=substeps,
        bw_mult=np.stack(bw_rows),
        arr_valid=np.zeros((T, A), bool),
        arr_id=np.zeros((T, A), np.int64),
        arr_app=np.zeros((T, A), np.int32),
        arr_batch=np.zeros((T, A), np.int64),
        arr_sla=np.zeros((T, A), np.float64),
        arr_arrival_s=np.zeros((T, A), np.float64),
        arr_acc=np.zeros((T, A), np.float64),
        arr_decision=np.full((T, A), -1, np.int32),
        arr_chain=np.zeros((T, A), bool),
        arr_nfrag=np.zeros((T, A), np.int32),
        frag_instr=np.zeros((T, A, F), np.float64),
        frag_ram=np.zeros((T, A, F), np.float64),
        frag_out=np.zeros((T, A, F), np.float64))

    for t, rows in enumerate(per_interval):
        for a, (task, acc) in enumerate(rows):
            tr.arr_valid[t, a] = True
            tr.arr_id[t, a] = task.id
            tr.arr_app[t, a] = task.app
            tr.arr_batch[t, a] = task.batch
            tr.arr_sla[t, a] = task.sla_s
            tr.arr_arrival_s[t, a] = task.arrival_s
            tr.arr_acc[t, a] = acc
            tr.arr_decision[t, a] = task.decision
            tr.arr_chain[t, a] = task.chain
            tr.arr_nfrag[t, a] = len(task.fragments)
            for i, f in enumerate(task.fragments):
                tr.frag_instr[t, a, i] = f.instr_left
                tr.frag_ram[t, a, i] = f.ram_mb
                tr.frag_out[t, a, i] = f.out_bytes
    return tr


@dataclasses.dataclass
class DualTraceArrays:
    """One compiled (seed, λ) trace with BOTH split variants realized.

    The in-loop deciders pick their split arm on the device, so every
    task carries both realizations side by side (variant axis V=2,
    ordered by ``variants``) and ``kernels.select_variant`` picks
    per-arrival rows by the decision.  ``lat_prev[t]`` is the mobility
    latency multiplier visible to the placer at interval ``t`` (row 0 is
    all-ones).
    """
    lam: float
    seed: int
    interval_s: float
    substeps: int

    bw_mult: np.ndarray        # (T, n)
    lat_prev: np.ndarray       # (T, n) placement-time latency multipliers
    arr_valid: np.ndarray      # (T, A) bool
    arr_id: np.ndarray         # (T, A) int64
    arr_app: np.ndarray        # (T, A) int32
    arr_batch: np.ndarray      # (T, A) int64
    arr_sla: np.ndarray        # (T, A) float64
    arr_arrival_s: np.ndarray  # (T, A) float64
    var_acc: np.ndarray        # (T, A, V) float64
    var_chain: np.ndarray      # (T, A, V) bool
    var_nfrag: np.ndarray      # (T, A, V) int32
    var_instr: np.ndarray      # (T, A, V, F) float64
    var_ram: np.ndarray        # (T, A, V, F) float64
    var_out: np.ndarray        # (T, A, V, F) float64
    variants: tuple = (0, 1)   # decision codes realized on the V axis

    @property
    def n_intervals(self) -> int:
        return self.arr_valid.shape[0]

    @property
    def max_arrivals(self) -> int:
        return self.arr_valid.shape[1]

    @property
    def max_frags(self) -> int:
        return self.var_instr.shape[3]

    @property
    def n_tasks(self) -> int:
        return int(self.arr_valid.sum())

    def kernel_dict(self):
        return {"bw_mult": self.bw_mult, "lat_prev": self.lat_prev,
                "valid": self.arr_valid, "sla": self.arr_sla,
                "arrival_s": self.arr_arrival_s, "app": self.arr_app,
                "batch": self.arr_batch, "vacc": self.var_acc,
                "vchain": self.var_chain, "vnfrag": self.var_nfrag,
                "vinstr": self.var_instr, "vram": self.var_ram,
                "vout": self.var_out}


def compile_trace_dual(lam: float = 6.0, seed: int = 0,
                       n_intervals: int = 100, interval_s: float = 300.0,
                       substeps: int = 30, apps: Optional[Sequence[int]] = None,
                       cluster: Optional[Cluster] = None,
                       max_arrivals: Optional[int] = None,
                       variants: Sequence[int] = None) -> DualTraceArrays:
    """Compile one trace with both split variants realized per task.

    The draw sequence matches ``compile_trace`` draw for draw (one
    image-size uniform + one accuracy-noise normal per task), so arrivals
    and SLAs equal the single-variant compile of the same seed.
    """
    variant_codes = tuple(variants) if variants is not None \
        else (LAYER, SEMANTIC)
    if len(variant_codes) != 2:
        raise ValueError(f"exactly two variants required, got "
                         f"{variant_codes}")
    cluster = cluster or make_cluster()
    gen = WorkloadGenerator(lam=lam, seed=seed, apps=apps)
    mob = MobilityModel(cluster.n, cluster.mobile_mask(), seed=seed + 1)
    dt = interval_s / substeps

    per_interval: List[list] = []
    bw_rows, lat_rows = [], []
    now = 0.0
    for _ in range(n_intervals):
        tasks = gen.arrivals(now)
        rows = []
        for task in tasks:
            img_mb = gen.rng.uniform(*APP_PROFILES[task.app].model_mb)
            variants_r = []
            for d in variant_codes:
                gen.realize(task, d, img_mb=img_mb)
                _check_uniform_ram(task)
                variants_r.append((task.chain,
                                   [(f.instr_left, f.ram_mb, f.out_bytes)
                                    for f in task.fragments]))
            noise = gen.rng.normal(0, 0.003)
            accs = [accuracy_from_noise(task.app, d, noise)
                    for d in variant_codes]
            rows.append((task, variants_r, accs))
        per_interval.append(rows)
        lat, bw = mob.step()
        bw_rows.append(bw)
        lat_rows.append(lat)
        for _ in range(substeps):
            now += dt

    T = n_intervals
    A = max_arrivals if max_arrivals is not None \
        else max(1, max(len(r) for r in per_interval))
    if max(len(r) for r in per_interval) > A:
        raise ValueError(
            f"max_arrivals={A} < observed {max(len(r) for r in per_interval)}")
    F = max([1] + [len(frags) for r in per_interval
                   for _, vr, _ in r for _, frags in vr])

    tr = DualTraceArrays(
        lam=lam, seed=seed, interval_s=interval_s, substeps=substeps,
        variants=variant_codes,
        bw_mult=np.stack(bw_rows),
        lat_prev=np.vstack([np.ones((1, cluster.n)),
                            np.stack(lat_rows)[:-1]]) if T else
        np.ones((0, cluster.n)),
        arr_valid=np.zeros((T, A), bool),
        arr_id=np.zeros((T, A), np.int64),
        arr_app=np.zeros((T, A), np.int32),
        arr_batch=np.zeros((T, A), np.int64),
        arr_sla=np.zeros((T, A), np.float64),
        arr_arrival_s=np.zeros((T, A), np.float64),
        var_acc=np.zeros((T, A, 2), np.float64),
        var_chain=np.zeros((T, A, 2), bool),
        var_nfrag=np.zeros((T, A, 2), np.int32),
        var_instr=np.zeros((T, A, 2, F), np.float64),
        var_ram=np.zeros((T, A, 2, F), np.float64),
        var_out=np.zeros((T, A, 2, F), np.float64))

    for t, rows in enumerate(per_interval):
        for a, (task, variants_r, accs) in enumerate(rows):
            tr.arr_valid[t, a] = True
            tr.arr_id[t, a] = task.id
            tr.arr_app[t, a] = task.app
            tr.arr_batch[t, a] = task.batch
            tr.arr_sla[t, a] = task.sla_s
            tr.arr_arrival_s[t, a] = task.arrival_s
            for v, (chain, frags) in enumerate(variants_r):
                tr.var_acc[t, a, v] = accs[v]
                tr.var_chain[t, a, v] = chain
                tr.var_nfrag[t, a, v] = len(frags)
                for i, (instr, ram, out) in enumerate(frags):
                    tr.var_instr[t, a, v, i] = instr
                    tr.var_ram[t, a, v, i] = ram
                    tr.var_out[t, a, v, i] = out
    return tr


#: per-worker leaves are never padded; fragment leaves pad their trailing
#: fragment axis to F as well as their arrival axis to A
_NO_PAD_KEYS = ("bw_mult", "lat_prev")
_FRAG_PAD_KEYS = ("instr", "ram", "out_bytes", "vinstr", "vram", "vout")


def _trace_sig(t):
    return (t.n_intervals, t.interval_s, t.substeps,
            getattr(t, "variants", None))


def check_grid_homogeneous(traces):
    """Every grid cell must share n_intervals/interval_s/substeps/variants;
    the error names each offending cell."""
    if not traces:
        raise ValueError("empty grid")
    s0 = _trace_sig(traces[0])
    bad = [(i, _trace_sig(t)) for i, t in enumerate(traces)
           if _trace_sig(t) != s0]
    if bad:
        lines = "; ".join(
            f"trace[{i}] has (n_intervals, interval_s, substeps, "
            f"variants)={s}" for i, s in bad)
        raise ValueError(
            "grid cells must share n_intervals/interval_s/substeps/"
            f"variants: trace[0] has {s0}, but {lines}")


def stack_traces(traces: Sequence[TraceArrays], max_arrivals: int = 0,
                 max_frags: int = 0) -> dict:
    """Stack per-cell traces into one batched dict of NumPy leaves.

    Works for both ``TraceArrays`` and ``DualTraceArrays`` grids (never
    mixed).  Harmonizes the A (arrivals) and F (fragments) pads to the
    grid-wide maxima (or the explicit overrides); every leaf gains a
    leading grid axis G.
    """
    check_grid_homogeneous(traces)
    A = max([max_arrivals] + [t.max_arrivals for t in traces])
    F = max([max_frags] + [t.max_frags for t in traces])

    def pad(x, axis, to):
        w = [(0, 0)] * x.ndim
        w[axis] = (0, to - x.shape[axis])
        return np.pad(x, w)

    leaves = []
    for t in traces:
        out = {}
        for k, v in t.kernel_dict().items():
            if k in _NO_PAD_KEYS:
                out[k] = v
                continue
            v = pad(v, 1, A)
            if k in _FRAG_PAD_KEYS:
                v = pad(v, v.ndim - 1, F)
            out[k] = v
        leaves.append(out)
    return {k: np.stack([lv[k] for lv in leaves]) for k in leaves[0]}


def to_device(leaves: dict, device) -> dict:
    """Upload a stacked grid (``stack_traces`` output, or any dict of
    NumPy leaves) to ``device`` in one pass, keeping every dtype."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in leaves.items()}


def to_device_packed(leaves: dict, device) -> dict:
    """Upload a dict of NumPy leaves as ONE host→device copy: the leaves
    are packed into one byte buffer (each at an 8-byte-aligned offset),
    copied once, and come back as typed views of the device buffer, each
    leaf's dtype and shape kept.  The streaming driver uploads a chunk
    tape this way (one copy per chunk, not one per leaf)."""
    arrs = {k: np.ascontiguousarray(v) for k, v in leaves.items()}
    offs, off = {}, 0
    for k, v in arrs.items():
        offs[k] = off
        off += -(-v.nbytes // 8) * 8
    buf = np.zeros(off, np.uint8)
    for k, v in arrs.items():
        buf[offs[k]:offs[k] + v.nbytes] = v.reshape(-1).view(np.uint8)
    dev_buf = torch.from_numpy(buf).to(device)
    return {k: dev_buf[offs[k]:offs[k] + v.nbytes].view(
                torch.from_numpy(np.empty(0, v.dtype)).dtype).view(v.shape)
            for k, v in arrs.items()}


def chunk_tapes(trace, chunk_intervals: int):
    """Slice one compiled trace's kernel leaves into chunk tapes for the
    streaming replay (``repro_torch.env.torchsim.stream.replay_stream``).

    Yields ``(t0, leaves)``: ``t0`` is the chunk's absolute start interval
    and every leaf holds rows ``[t0, t0 + chunk_intervals)`` of its
    ``kernel_dict`` array (every leaf is T-leading, for single-variant and
    dual traces alike).  The last chunk is shorter when ``n_intervals`` is
    not a multiple of ``chunk_intervals``."""
    if chunk_intervals < 1:
        raise ValueError(f"chunk_intervals must be >= 1, "
                         f"got {chunk_intervals}")
    d = trace.kernel_dict()
    for t0 in range(0, trace.n_intervals, chunk_intervals):
        yield t0, {k: v[t0:t0 + chunk_intervals] for k, v in d.items()}


def default_capacity(traces: Sequence[TraceArrays]) -> int:
    """Default slot capacity K for a grid: enough for every task of the
    densest trace to be live at once (never drops), rounded up to a
    multiple of 32."""
    need = max(max(t.n_tasks for t in traces), 16)
    return int(-(-need // 32) * 32)
