"""Policy engines of the interval program (the port of
``repro.env.jaxsim.engines``: the static, static-decider DASO and
MAB-deploy engines).

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
host summary dict.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.daso import DASOConfig
from repro_torch.env.torchsim import kernels
from repro_torch.env.workload import LAYER, SEMANTIC

#: arrival keys of a single-variant (static) compiled trace
STATIC_ARR_KEYS = ("valid", "sla", "arrival_s", "app", "batch", "acc",
                   "decision", "chain", "nfrag", "instr", "ram",
                   "out_bytes")
#: variant-independent / per-variant keys of a dual compiled trace
SHARED_KEYS = ("valid", "sla", "arrival_s", "app", "batch")
VAR_KEYS = ("vacc", "vchain", "vnfrag", "vinstr", "vram", "vout")

#: the dual-trace variant codes the MAB decides between
MAB_VARIANTS = (LAYER, SEMANTIC)


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


@dataclasses.dataclass(frozen=True)
class StaticDeciderDASOEngine:
    """The static-decider baseline arms: every row of a dual (LAYER,
    SEMANTIC) trace takes variant ``arm`` (0 for ``layer+gobi``, 1 for
    ``semantic+gobi``), placed by the DASO stage ascending a frozen
    surrogate.  The GOBI arms pass a ``decision_aware=False`` cfg.
    ``es = {"theta": θ}``.  ``arm = -1`` (``random+daso``, uniform-random
    rows) needs JAX's fold-in bits and is ROADMAP queue 1 item 7."""

    arm: int
    daso_cfg: DASOConfig
    name: str = "static-daso"

    def __post_init__(self):
        if self.arm < 0:
            raise NotImplementedError(
                "random+daso is not ported yet (ROADMAP queue 1 item 7: "
                "in-loop randomness, the random arm's fold-in bits)")

    def decide(self, es, trace, t):
        shared, var = _interval_rows(trace, t)
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
        mab = es["mab"]
        return {"mab_eps": mab.eps, "mab_rho": mab.rho, "mab_t": mab.t}

    def summarize(self, out, s):
        s["mab_eps"] = float(out["mab_eps"])
        s["mab_rho"] = float(out["mab_rho"])
        s["mab_t"] = int(out["mab_t"])
        return s
