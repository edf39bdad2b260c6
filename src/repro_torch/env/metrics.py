"""Experiment-level metrics (paper §6.4, eqs. 13–16) and the
per-interval telemetry-row layout of the host simulator.

A NumPy copy of the reference ``repro.env.metrics``."""
from __future__ import annotations

import numpy as np

#: layout of one per-interval telemetry row — the base columns of the
#: reference's jitted ``telemetry="interval"`` series and of
#: ``MetricsAccumulator(telemetry=True)``.  The first nine columns are
#: exactly the kernel's packed ``METRIC_COLS`` accumulator (as interval
#: deltas); the rest are per-interval extremes/occupancy the end-of-run
#: summary collapses away.  Engine-specific learning-signal columns
#: (``engine.telemetry_cols()``) append after these.
TELEMETRY_COLS = (
    "n_fin", "sum_resp", "n_viol", "sum_acc", "sum_reward", "sum_wait",
    "fin_layer", "fin_semantic", "fin_compressed",
    "n_dropped", "energy_j", "resp_min", "resp_max", "wait_min",
    "wait_max", "util_mean", "util_max", "n_active",
)

#: the percentile points both backends report (satellite of §6.4's
#: means; the streaming-service north star's rolling p50/p99 substrate)
PERCENTILE_QS = (50, 95, 99)


def series_percentiles(series, cols, qs=PERCENTILE_QS) -> dict:
    """Percentile estimates from a per-interval telemetry series.

    The series only keeps per-interval sums and extremes, so every
    finisher in interval ``t`` is represented by the interval's *mean*
    response/wait (weighted by ``n_fin``).  Binning error bound: a
    quantile (with linear interpolation) is a convex combination of
    order statistics and order statistics move at most as far as the
    largest pointwise perturbation, so replacing each sample by its
    interval mean shifts any percentile by at most the largest
    within-interval spread ``max_t(resp_max[t] − resp_min[t])`` (resp.
    wait).  That bound is returned as ``percentile_err_s`` and the
    parity tests assert |kernel − exact-host| ≤ it."""
    idx = {c: i for i, c in enumerate(cols)}
    series = np.asarray(series, np.float64)
    nfin = np.rint(series[:, idx["n_fin"]]).astype(np.int64)
    have = nfin > 0
    out = {}
    err = 0.0
    for name, s_col, mn_col, mx_col in (
            ("response", "sum_resp", "resp_min", "resp_max"),
            ("wait", "sum_wait", "wait_min", "wait_max")):
        if have.any():
            means = series[have, idx[s_col]] / nfin[have]
            vals = np.percentile(np.repeat(means, nfin[have]), qs)
            err = max(err, float(np.max(series[have, idx[mx_col]]
                                        - series[have, idx[mn_col]])))
        else:
            vals = np.zeros(len(qs))
        for q, v in zip(qs, vals):
            out[f"p{q}_{name}_s"] = float(v)
    out["percentile_err_s"] = err
    return out


class MetricsAccumulator:
    def __init__(self, interval_s: float = 300.0, telemetry: bool = False):
        self.interval_s = interval_s
        self.responses = []
        self.slas = []
        self.accs = []
        self.waits = []
        self.decisions = []
        self.apps = []
        self.energy_j = 0.0
        self.cost_usd = 0.0
        self.per_worker_tasks = None
        self.intervals = 0
        self.num_containers = 0
        self._telemetry = [] if telemetry else None

    def update(self, stats):
        self.intervals += 1
        self.energy_j += stats.energy_j
        self.cost_usd += stats.cost_usd
        if self.per_worker_tasks is None:
            self.per_worker_tasks = np.zeros_like(stats.per_worker_tasks)
        self.per_worker_tasks += stats.per_worker_tasks
        self.num_containers += int(stats.per_worker_tasks.sum())
        for t in stats.finished:
            self.responses.append(t.response_s)
            self.slas.append(t.sla_s)
            self.accs.append(t.accuracy)
            self.waits.append(t.wait_s)
            self.decisions.append(t.decision)
            self.apps.append(t.app)
        if self._telemetry is not None:
            self._telemetry.append(self._telemetry_row(stats))

    # ---- per-interval telemetry (TELEMETRY_COLS layout) ----
    def _telemetry_row(self, stats):
        fin = stats.finished
        r = np.array([t.response_s for t in fin], np.float64)
        s = np.array([t.sla_s for t in fin], np.float64)
        a = np.array([t.accuracy for t in fin], np.float64)
        w = np.array([t.wait_s for t in fin], np.float64)
        d = np.array([t.decision for t in fin], np.int64)
        util = np.asarray(stats.cpu_util, np.float64)
        return [
            float(len(fin)), float(r.sum()), float((r > s).sum()),
            float(a.sum()),
            float((((r <= s).astype(np.float64) + a) / 2.0).sum()),
            float(w.sum()),
            float((d == 0).sum()), float((d == 1).sum()),
            float((d == 2).sum()),
            0.0,                       # n_dropped: the host never drops
            float(stats.energy_j),
            float(r.min()) if len(fin) else 0.0,
            float(r.max()) if len(fin) else 0.0,
            float(w.min()) if len(fin) else 0.0,
            float(w.max()) if len(fin) else 0.0,
            float(util.mean()), float(util.max()),
            float(stats.num_active + stats.num_waiting),
        ]

    def telemetry_series(self) -> np.ndarray:
        """The accumulated (intervals, len(TELEMETRY_COLS)) series;
        needs ``MetricsAccumulator(telemetry=True)``."""
        if self._telemetry is None:
            raise ValueError("construct MetricsAccumulator(telemetry=True) "
                             "to record per-interval telemetry rows")
        return np.asarray(self._telemetry, np.float64).reshape(
            len(self._telemetry), len(TELEMETRY_COLS))

    def percentiles(self, qs=PERCENTILE_QS) -> dict:
        """EXACT response/wait percentiles over every finished task (the
        host keeps the full sample lists, so no binning error)."""
        out = {}
        for name, vals in (("response", self.responses),
                           ("wait", self.waits)):
            arr = np.percentile(np.asarray(vals, np.float64), qs) \
                if vals else np.zeros(len(qs))
            for q, v in zip(qs, arr):
                out[f"p{q}_{name}_s"] = float(v)
        return out

    # ---- paper metrics ----
    def accuracy(self):                       # eq. 13
        return float(np.mean(self.accs)) if self.accs else 0.0

    def sla_violation_rate(self):             # eq. 14
        if not self.responses:
            return 0.0
        r, s = np.array(self.responses), np.array(self.slas)
        return float(np.mean(r > s))

    def average_reward(self):                  # eq. 15
        if not self.responses:
            return 0.0
        r, s = np.array(self.responses), np.array(self.slas)
        p = np.array(self.accs)
        return float(np.mean(((r <= s).astype(float) + p) / 2.0))

    def avg_response_intervals(self):          # ART in intervals
        return float(np.mean(self.responses) / self.interval_s) if self.responses else 0.0

    def avg_wait_intervals(self):
        return float(np.mean(self.waits) / self.interval_s) if self.waits else 0.0

    def avg_exec_intervals(self):
        if not self.responses:
            return 0.0
        return float((np.mean(self.responses) - np.mean(self.waits)) / self.interval_s)

    def energy_mwhr(self):
        return self.energy_j / 3.6e9           # J -> MW-hr

    def fairness(self):
        """Jain's index over per-worker completed-container counts."""
        x = self.per_worker_tasks
        if x is None or x.sum() == 0:
            return 1.0
        return float(x.sum() ** 2 / (len(x) * np.sum(x ** 2) + 1e-12))

    def cost_per_container(self):
        return self.cost_usd / max(1, self.num_containers)

    def layer_fraction(self):
        d = np.array(self.decisions)
        return float(np.mean(d == 0)) if len(d) else 0.0

    def summary(self):
        return {
            "accuracy": self.accuracy(),
            "sla_violations": self.sla_violation_rate(),
            "reward": self.average_reward(),
            "response_intervals": self.avg_response_intervals(),
            "wait_intervals": self.avg_wait_intervals(),
            "exec_intervals": self.avg_exec_intervals(),
            "energy_mwhr": self.energy_mwhr(),
            "fairness": self.fairness(),
            "cost_per_container": self.cost_per_container(),
            "layer_fraction": self.layer_fraction(),
            "tasks_completed": len(self.responses),
        }
