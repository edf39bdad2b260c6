"""Policy engines of the interval program (the port of
``repro.env.jaxsim.engines``: the static, static-decider DASO, MAB-deploy,
MAB-train and Gillis engines).

``driver.run_program`` runs ONE interval pipeline for every policy:

    arr, es  = engine.decide(es, trace, t)          # split decisions
    state    = kernels.admit(state, arr)
    req, es, aux = engine.place(es, state, cl, trace, t, interval_s)
    state    = kernels.apply_requests(state, cl, req)
    ... physics (kernels.run_substeps) ...
    es       = engine.feedback(es, state, fin, util, aux, t, interval_s)

An engine is a frozen dataclass of static configuration; its state ``es``
is a dict of tensors with one row per grid cell.  ``trace`` is the
device-resident stacked grid: every leaf is (G, T, ...), so interval ``t``
is ``trace[k][:, t]``.

Protocol: ``decide``, ``place``, ``feedback`` as above; ``outputs(es)`` —
extra per-cell results; ``summarize(out, summary)`` — lift those into the
host summary dict; ``telemetry_cols()`` / ``telemetry_row(es)`` — the
engine's learning-signal columns of the ``telemetry="interval"`` series
(appended after ``metrics.TELEMETRY_COLS``) and their (G, C) float64
values at the end of an interval's feedback, computed on the device
(None when the engine has no columns).

The learners' randomness is JAX's threefry, one key per cell
(``es["key"]``, (G, 2) int64 words): row a of interval t draws from
``fold_in(fold_in(key, t), a)`` (``repro_torch.kernels.threefry``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import daso as daso_mod
from repro_torch.core.daso import DASOConfig
from repro_torch.core.mab import timed_share
from repro_torch.env.torchsim import kernels
from repro_torch.env.workload import COMPRESSED, LAYER, SEMANTIC
from repro_torch.kernels.threefry import threefry_rows

#: arrival keys of a single-variant (static) compiled trace
STATIC_ARR_KEYS = ("valid", "sla", "arrival_s", "app", "batch", "acc",
                   "decision", "chain", "nfrag", "instr", "ram",
                   "out_bytes")
#: variant-independent / per-variant keys of a dual compiled trace
SHARED_KEYS = ("valid", "sla", "arrival_s", "app", "batch")
VAR_KEYS = ("vacc", "vchain", "vnfrag", "vinstr", "vram", "vout")

#: the dual-trace variant codes each engine family decides between
MAB_VARIANTS = (LAYER, SEMANTIC)
GILLIS_VARIANTS = (LAYER, COMPRESSED)

#: per-interval learning-signal columns of both MAB engines: exploration
#: and threshold scalars plus cumulative per-arm decision counts (summed
#: over the two SLA contexts); train mode with DASO adds the replay
#: window's fill and its loss; Gillis logs ε and the Q-table's extremes
MAB_TELEMETRY_COLS = ("mab_eps", "mab_rho", "mab_n_layer",
                      "mab_n_semantic")
TRAIN_DASO_TELEMETRY_COLS = MAB_TELEMETRY_COLS + ("daso_win_fill",
                                                  "daso_last_loss")
GILLIS_TELEMETRY_COLS = ("gillis_eps", "gillis_q_min", "gillis_q_max")

f8 = torch.float64


def _mab_telemetry_row(mab):
    """(G, 4) ``MAB_TELEMETRY_COLS`` of each cell's state."""
    return torch.stack([mab.eps.to(f8), mab.rho.to(f8),
                        mab.N[:, :, 0].sum(dim=1).to(f8),
                        mab.N[:, :, 1].sum(dim=1).to(f8)], dim=1)


def _daso_place(daso_cfg, es, state, cl, trace, t, interval_s):
    """BestFit requests, then the DASO stage ascending the frozen
    surrogate ``es["theta"]`` from them."""
    req = kernels.bestfit_requests(state, cl)
    feat = kernels.state_features_k(state, cl, trace["lat_prev"][:, t],
                                    interval_s)
    return kernels.daso_requests(daso_cfg, es["theta"], state, feat, req)


def _interval_rows(trace, t):
    shared = {k: trace[k][:, t] for k in SHARED_KEYS}
    var = {k: trace[k][:, t] for k in VAR_KEYS}
    return shared, var


@dataclasses.dataclass(frozen=True)
class StaticEngine:
    """Pre-realized split decisions + BestFit placement; ``es`` is empty.
    The trace carries one realized variant per task, so decide is a pure
    slice of the compiled arrays."""

    name: str = "static"

    def decide(self, es, trace, t):
        return {k: trace[k][:, t] for k in STATIC_ARR_KEYS}, es

    def place(self, es, state, cl, trace, t, interval_s):
        return kernels.bestfit_requests(state, cl), es, None

    def feedback(self, es, state, fin, util, aux, t, interval_s):
        return es

    def outputs(self, es):
        return {}

    def summarize(self, out, s):
        return s

    def telemetry_cols(self):
        return ()

    def telemetry_row(self, es):
        return None


@dataclasses.dataclass(frozen=True)
class StaticDeciderDASOEngine:
    """The static-decider baseline arms: every row of a dual (LAYER,
    SEMANTIC) trace takes variant ``arm`` (0 for ``layer+gobi``, 1 for
    ``semantic+gobi``), or with ``arm = -1`` (``random+daso``) a fair coin
    per row from the cell's key, placed by the DASO stage ascending a
    frozen surrogate.  The GOBI arms pass a ``decision_aware=False`` cfg.
    ``es = {"theta": θ}`` (+ ``"key"`` (G, 2) for the random arm)."""

    arm: int
    daso_cfg: DASOConfig
    name: str = "static-daso"

    def decide(self, es, trace, t):
        shared, var = _interval_rows(trace, t)
        if self.arm < 0:
            with timed_share("draw", shared["app"].device):
                d = threefry_rows(es["key"], t, shared["app"].shape[1])
            d = d.to(torch.int32)
        else:
            d = torch.full_like(shared["app"], self.arm)
        return kernels.select_variant(shared, var, d), es

    def place(self, es, state, cl, trace, t, interval_s):
        return _daso_place(self.daso_cfg, es, state, cl, trace, t,
                           interval_s), es, None

    def feedback(self, es, state, fin, util, aux, t, interval_s):
        return es

    def outputs(self, es):
        return {}

    def summarize(self, out, s):
        return s

    def telemetry_cols(self):
        return ()

    def telemetry_row(self, es):
        return None


@dataclasses.dataclass(frozen=True)
class MABDeployEngine:
    """Online UCB MAB decisions (eq. 9) + Algorithm-1 feedback against the
    carried per-cell ``MABState``; BestFit placement, or with a
    ``daso_cfg`` the DASO stage ascending a frozen surrogate
    (``decision_aware=False`` is the GOBI ablation).
    ``es = {"mab": MABState, "theta": θ or ()}``."""

    mab_hp: Tuple[float, float, float, float]
    daso_cfg: Optional[DASOConfig] = None
    name: str = "mab-deploy"

    def decide(self, es, trace, t):
        shared, var = _interval_rows(trace, t)
        d = kernels.mab_decide_arrivals(es["mab"], shared, self.mab_hp[0])
        return kernels.select_variant(shared, var, d), es

    def place(self, es, state, cl, trace, t, interval_s):
        if self.daso_cfg is None:
            return kernels.bestfit_requests(state, cl), es, None
        return _daso_place(self.daso_cfg, es, state, cl, trace, t,
                           interval_s), es, None

    def feedback(self, es, state, fin, util, aux, t, interval_s):
        _, phi, gamma, k_rbed = self.mab_hp
        es = dict(es)
        es["mab"] = kernels.mab_feedback(es["mab"], state, fin, phi, gamma,
                                         k_rbed)
        return es

    def outputs(self, es):
        return _mab_outputs(es["mab"])

    def summarize(self, out, s):
        return _mab_scalars(out, s)

    def telemetry_cols(self):
        return MAB_TELEMETRY_COLS

    def telemetry_row(self, es):
        return _mab_telemetry_row(es["mab"])


def _mab_outputs(mab):
    return {"mab_eps": mab.eps, "mab_rho": mab.rho, "mab_t": mab.t}


def _mab_scalars(out, s):
    s["mab_eps"] = float(out["mab_eps"])
    s["mab_rho"] = float(out["mab_rho"])
    s["mab_t"] = int(out["mab_t"])
    return s


@dataclasses.dataclass(frozen=True)
class MABTrainEngine:
    """The §6.3 training loop in the carry: ε-greedy MAB decisions (eq. 6)
    and Algorithm-1 feedback, and with a ``daso_cfg`` online DASO
    finetuning — the ascent of the CARRIED θ once the interval index
    reaches ``place_min``, one replay-window record per interval, and
    ``train_steps`` weighted epochs once ``train_min`` records exist.
    ``train_hp = (alpha, beta, train_steps, place_min, train_min)``.
    ``es = {"mab", "theta", "opt", "win", "key"}``, every leaf per cell
    (the window's record count is one host-side int)."""

    mab_hp: Tuple[float, float, float, float]
    train_hp: Tuple[float, float, int, int, int]
    daso_cfg: Optional[DASOConfig] = None
    name: str = "mab-train"

    def decide(self, es, trace, t):
        shared, var = _interval_rows(trace, t)
        d = kernels.mab_decide_arrivals_train(es["mab"], shared, es["key"],
                                              t)
        return kernels.select_variant(shared, var, d), es

    def place(self, es, state, cl, trace, t, interval_s):
        req = kernels.bestfit_requests(state, cl)
        if self.daso_cfg is None:
            return req, es, None
        feat = kernels.state_features_k(state, cl, trace["lat_prev"][:, t],
                                        interval_s)
        # one record lands per interval, so the pre-interval record count
        # is t: the gate is a host-side branch on the interval index
        req, x = kernels.daso_requests_train(
            self.daso_cfg, es["theta"], state, feat, req,
            t >= self.train_hp[3])
        return req, es, x

    def feedback(self, es, state, fin, util, aux, t, interval_s):
        _, phi, gamma, k_rbed = self.mab_hp
        alpha, beta, train_steps, _, train_min = self.train_hp
        es = dict(es)
        es["mab"] = kernels.mab_feedback(es["mab"], state, fin, phi, gamma,
                                         k_rbed)
        if self.daso_cfg is not None:
            with timed_share("daso_train", fin.device):
                y = daso_mod.op_objective(
                    state["resp"], state["sla"], state["acc"], fin, util,
                    interval_s, alpha, beta)
                es["win"] = daso_mod.window_append(es["win"], aux, y)
                es["theta"], es["opt"] = daso_mod.finetune_window(
                    self.daso_cfg, es["theta"], es["opt"], es["win"],
                    train_steps, train_min)
        return es

    def outputs(self, es):
        out = _mab_outputs(es["mab"])
        if self.daso_cfg is not None:
            out["daso_theta"] = es["theta"]
        return out

    def summarize(self, out, s):
        s = _mab_scalars(out, s)
        if "daso_theta" in out:
            s["daso_theta"] = out["daso_theta"]
        return s

    def telemetry_cols(self):
        if self.daso_cfg is None:
            return MAB_TELEMETRY_COLS
        return TRAIN_DASO_TELEMETRY_COLS

    def telemetry_row(self, es):
        row = _mab_telemetry_row(es["mab"])
        if self.daso_cfg is None:
            return row
        # the window's fill is the host-side record count; its loss is one
        # surrogate forward per cell, left on the device
        loss = daso_mod.window_loss(self.daso_cfg, es["theta"], es["win"])
        fill = torch.full_like(loss, float(es["win"]["count"]), dtype=f8)
        return torch.cat([row, fill[:, None], loss.to(f8)[:, None]], dim=1)


@dataclasses.dataclass(frozen=True)
class GillisEngine:
    """The Gillis baseline in the carry: contextual ε-greedy Q-learning
    between the layer split (arm 0) and model compression (arm 1) over
    (LAYER, COMPRESSED) dual traces, ε decaying once per interval after
    its decisions, and sequential per-leaving-task TD(0) updates.
    ``gillis_hp = (eps0, lr, decay)``.  Placement is plain BestFit.
    ``es = {"Q" (G, apps, 2, 2), "eps" (G,), "key" (G, 2), "layer_ref"
    (apps,)}``, float64."""

    gillis_hp: Tuple[float, float, float]
    name: str = "gillis"

    def decide(self, es, trace, t):
        shared, var = _interval_rows(trace, t)
        arms = kernels.gillis_decide_arrivals(es["Q"], es["eps"], shared,
                                              es["key"], t, es["layer_ref"])
        arr = kernels.select_variant(shared, var, arms,
                                     arm_decisions=GILLIS_VARIANTS)
        es = dict(es)
        es["eps"] = es["eps"] * self.gillis_hp[2]
        return arr, es

    def place(self, es, state, cl, trace, t, interval_s):
        return kernels.bestfit_requests(state, cl), es, None

    def feedback(self, es, state, fin, util, aux, t, interval_s):
        es = dict(es)
        es["Q"] = kernels.gillis_feedback(es["Q"], state, fin,
                                          es["layer_ref"], self.gillis_hp[1])
        return es

    def outputs(self, es):
        return {"gillis_eps": es["eps"], "gillis_q": es["Q"]}

    def summarize(self, out, s):
        s["gillis_eps"] = float(out["gillis_eps"])
        s["gillis_q"] = np.asarray(out["gillis_q"], np.float64)
        return s

    def telemetry_cols(self):
        return GILLIS_TELEMETRY_COLS

    def telemetry_row(self, es):
        q = es["Q"].reshape(es["Q"].shape[0], -1)
        return torch.stack([es["eps"].to(f8), q.amin(dim=1).to(f8),
                            q.amax(dim=1).to(f8)], dim=1)
